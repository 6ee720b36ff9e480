"""Full Gibbs sweeps (counterpart of ``dynetlsm_tpu/mcmc/sweeps.py``) on a
dense undirected or directed (social-radii) network, fixed or with missing
dyads resampled, and the latent update of ``cfg.latent_update``
(``mcmc/latent.py``: the exact scan, stale-field parallel site updates or
a joint MALA step):

* LSM (:func:`make_lsm_sweep`, reference lsm.py:474-572): random-walk
  prior on the positions, Procrustes alignment after burn-in, MAP
  tracking;
* LPCM (:func:`make_lpcm_sweep`, reference lpcm.py:514-701): a finite
  Gaussian-mixture HMM over cluster labels;
* sticky HDP-LPCM (:func:`make_hdp_sweep`, reference
  hdp_lpcm.py:823-1069).

Each sweep is a plain function ``sweep(state, gen) -> state`` over a
chain-batched :class:`~dynetlsm_tpu_torch.mcmc.states.LSMState` or
:class:`~dynetlsm_tpu_torch.mcmc.states.MixtureState`; every block draws
from the explicit ``torch.Generator``.  On a CUDA device the latent update
runs the node-scan kernel, and the coefficient steps the pair kernel
(undirected intercept) or the directed kernel (b_in, b_out and radii:
three launches per sweep), so no sweep builds a (C, T, n, n) distance
tensor; the log joint reuses the last coefficient step's log-likelihood at
the accepted state.  The factories store Y on ``device``, the card unless
the caller asks for the CPU (``config.resolve_device``), and expose it as
``sweep.Y`` beside ``sweep.cfg`` (and the case-control structures as
``sweep.cc_static``).

With ``cfg.sample_missing`` the network is part of the state: ``state.Y``
(C, T, n, n) holds each chain's network, and the sweep's last block before
the log joint Gibbs-resamples its missing dyads (``miss_mask``) from their
Bernoulli conditionals (:func:`resample_missing`, step 7 of the JAX
sweeps), adds them to ``state.missing_sum`` after burn-in and scores the
new network with one more kernel launch for the log joint.  The resample
works on the list of missing dyads (:func:`missing_dyads`, made once by
the factory), not on dense (C, T, n, n) tensors.  The kernels read each
chain's network through their chain stride, in the form the sweep derives
from ``state.Y`` at its start (packed when directed, with padded rows for
the node scan), so the form always belongs to the slot's own network,
also after a replica swap; ``sweep.Y`` is then ``None`` and
``sweep.miss_mask`` the mask.

With ``cfg.n_control`` the network likelihood is the case-control
estimator (``ops/case_control.py``) and no block reads a dense network:
the factories take ``cc_static`` (``models/base.py::build_case_control``:
the edge lists, the colour classes and the control seed) and store no
(T, n, n) tensor unless missing dyads are resampled.  Each sweep first
refreshes the control draw every ``cfg.n_resample_control`` sweeps (one
draw for all chains, from a generator seeded by the control seed and the
sweep count, so it is reproducible and never touches ``gen``;
:func:`_refresh_controls`) and builds the structures of
:func:`build_cc_dict` (with missing dyads, each chain's edge lists from
``state.Y``); the latent update is the chromatic scan
(``mcmc/latent.py::cc_colored_scan``).  A ``cc_static`` without colour
classes (edge lists alone, JAX's legacy dicts) gives the sequential scan
instead (one node a class) and a control draw a chain from ``gen``,
``ctrl_in`` / ``ctrl_out`` (C, n, m).  The coefficient steps score their
candidates with the case-control estimator, and the log joint reuses the
last one's value.  The missing-dyad step resamples as on a dense network
and scores the new network with the case-control estimator on edge lists
rebuilt from it.  The state carries the draw in ``ctrl_in`` and
``ctrl_out`` (n, m), shared by the chains.  No launch of the node-scan,
pair or directed kernel happens in such a sweep.

With ``node_devices`` (a list of devices, the first the sweep's own) the
factories shard the network by rows over them (``mcmc/nodes.py``): what
grows as n^2 (the network, the missing-dyad mask, ``state.Y`` and
``state.missing_sum``, the case-control edge lists) is split, the rest of
the state stays whole on ``device``, and only the blocks that read the
network change (the 'parallel' or 'mala' latent update, the coefficient
steps and the missing dyads, whose draws come from one generator a shard,
``sweep.node_gens``, seeded by ``node_seed``).  The exact scan is not
sharded.

A state with ``temper`` (C,) runs the tempered sweep of parallel tempering
(``mcmc/tempering.py``): the latent update, the intercept step(s) and the
radii step scale their log-likelihood differences by each chain's inverse
temperature; the prior-side blocks (labels, CRF, Dirichlet, conjugate,
concentrations) do not see Y and are unchanged, and ``logp`` stays the
untempered log joint.
"""
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import DTYPE, SMALL_EPS, resolve_device
from ..math.distributions import (
    dirichlet_logpdf, sample_dirichlet, truncated_normal_logpdf)
from ..math.procrustes import longitudinal_procrustes_rotation
from ..models.base import validate_network
from ..ops.case_control import (
    cc_network_loglik, control_masks, edge_lists_device,
    sample_control_nodes, sample_controls_colored)
from ..ops.likelihoods import (
    dense_network_loglik, directed_loglik_full, undirected_loglik_full)
from ..ops.dir_loglik import dir_loglik_cuda, dir_loglik_rows_cuda
from ..ops.node_scan import (
    node_scan_cuda, pack_directed, pad_partners, site_cluster_params)
from ..ops.pair_loglik import pair_loglik_cuda, pair_loglik_rows_cuda
from ..ops.shards import RowShards
from ..ops.site_loglik import site_loglik_cuda, site_loglik_rows_cuda
from .. import tracing
from .coefficients import (
    network_loglik, sample_intercept_undirected, sample_intercepts_directed,
    sample_radii)
from .conjugate import (
    sample_cluster_means, sample_cluster_variances, sample_lambda,
    sample_mean_variance_hyper, sample_sigma_scale_hyper)
from .hdp import (
    sample_alpha_kappa_rho, sample_concentration_param, sample_mbar,
    sample_tables)
from .labels import (
    _label_statistics, sample_labels_block, sample_labels_block_lpcm)
from .latent import sample_latent_positions
from .metropolis import maybe_tune
from .nodes import (
    ShardedMissing, build_cc_shards, kernel_rows, missing_draws,
    node_generators, shard_cc_static, shard_network, sharded_missing)
from .nodes import missing_dyad_step as sharded_missing_dyad_step
from .states import LSMState, MixtureState


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Static sweep configuration (the LSM, LPCM and HDP-LPCM fields of
    the JAX package's ``SweepConfig``)."""
    is_directed: bool = False
    sample_missing: bool = False
    tune: int = 0                 # sweeps of step-size adaptation
    tune_interval: int = 100
    n_burn: int = 0               # tune + burn
    # LSM random-walk prior variances
    tau_sq: float = 2.0
    sigma_sq: float = 0.1
    tune_radii: bool = False      # adapt the directed radii's step size
    intercept_variance_prior: float = 2.0
    n_components: int = 10
    a: float = 2.0
    lambda_prior: float = 0.9
    lambda_variance_prior: float = 0.01
    # hyper-prior shapes (None disables resampling)
    a0: Optional[float] = None
    b0: Optional[float] = None
    c0: Optional[float] = None
    d0: Optional[float] = None
    gamma_prior_shape: float = 1.0
    gamma_prior_rate: float = 0.1
    alpha_init_shape: float = 1.0
    alpha_init_rate: float = 1.0
    alpha_kappa_shape: float = 5.0
    alpha_kappa_rate: float = 0.1
    dirichlet_prior: float = 1.0  # LPCM Dirichlet concentration
    # case-control: control nodes per node and the redraw cadence
    n_control: Optional[int] = None
    n_resample_control: int = 100
    # 'exact' (the single-site scan), 'parallel' (stale-field site
    # updates) or 'mala' (a joint Langevin step; tuned with the 'mala'
    # schedule)
    latent_update: str = 'exact'
    table_cap: int = 64
    sample_concentrations: bool = True
    center: bool = True


def _fixed_network(Y_fixed, intercept_prior, cfg, device, miss_mask=None,
                   cc_static=None, node_devices=None):
    """Check the configuration and store the network on ``device``.
    Returns (Y, Y with its rows padded for the node scan, the
    :class:`MissingDyads`, the prior means as a (1, P) tensor, the same as
    a list of floats).

    Without ``cfg.sample_missing``: Y the fixed 0/1 network (T, n, n) as
    uint8 (packed as ``Y + 2 Y^T`` for the directed model) and its padded
    rows (``pad_partners``), both made once here; no missing dyads.  With
    it: no stored network (the sweep reads ``state.Y``) and the
    :func:`missing_dyads` of ``miss_mask`` (T, n, n) bool, or, when it is
    ``None``, of the -1 or NaN dyads of ``Y_fixed``
    (``models.base.validate_network``).  Under the case-control likelihood
    (``cc_static``) no network is stored: ``Y_fixed`` may be ``None``.
    With more than one ``node_devices`` the network and the missing dyads
    are split by rows over them (``nodes.shard_network``,
    ``nodes.sharded_missing``) and the latent update reads the same rows
    (no padded rows: the exact scan is not sharded)."""
    if (cfg.n_control is None) != (cc_static is None):
        raise ValueError('cfg.n_control and cc_static '
                         '(models.base.build_case_control) go together')
    device = resolve_device(device)
    sharded = node_devices is not None and len(node_devices) > 1
    if sharded and cfg.latent_update not in ('parallel', 'mala'):
        raise ValueError(
            "node_devices > 1 shards the node axis across devices; the "
            "sequential exact node scan cannot be partitioned - construct "
            "the model with latent_update='parallel' or 'mala'")
    prior = torch.as_tensor(np.asarray(intercept_prior, np.float32),
                            device=device).reshape(1, -1)
    prior_means = [float(m) for m in prior[0]]
    if cfg.sample_missing:
        if miss_mask is None:
            if Y_fixed is None:
                raise ValueError('sample_missing needs miss_mask or a '
                                 '-1-coded Y_fixed')
            miss_mask = validate_network(Y_fixed, cfg.is_directed)[2]
        if sharded:
            return (None, None, sharded_missing(miss_mask, cfg.is_directed,
                                                node_devices),
                    prior, prior_means)
        miss = torch.as_tensor(np.asarray(miss_mask, dtype=bool),
                               device=device)
        return (None, None, missing_dyads(miss, cfg.is_directed), prior,
                prior_means)
    if cc_static is not None:
        return None, None, None, prior, prior_means
    Y_np = np.asarray(Y_fixed)
    # an unsigned network is 0/1 when its largest dyad is: one pass, not
    # isin's (2.7 GB of booleans at T = 10, n = 16,384)
    if not (Y_np.max(initial=0) <= 1 if Y_np.dtype.kind in 'ub'
            else np.isin(Y_np, (0, 1)).all()):
        raise ValueError('Y_fixed must be a 0/1 adjacency; a network with '
                         'missing (-1 or NaN) dyads needs '
                         'cfg.sample_missing')
    if sharded:
        Y = shard_network(cfg, Y_np, node_devices)
        return Y, Y, None, prior, prior_means
    Y = torch.as_tensor(np.asarray(Y_np, np.uint8), device=device)
    if cfg.is_directed:
        Y = pack_directed(Y)
    return Y, pad_partners(Y), None, prior, prior_means


def _sweep_inputs(Y_fixed, intercept_prior, cfg, device, miss_mask,
                  cc_static, node_devices, node_seed):
    """What a sweep factory closes over: :func:`_fixed_network`'s five
    values, the case-control structures on ``device`` (split by rows over
    more than one ``node_devices``, ``nodes.shard_cc_static``) and the
    node shards' generators of the missing-dyad draws (None unless node
    sharding resamples missing dyads)."""
    out = _fixed_network(Y_fixed, intercept_prior, cfg, device, miss_mask,
                         cc_static, node_devices)
    device = resolve_device(device)
    sharded = node_devices is not None and len(node_devices) > 1
    if cc_static is not None:
        cc_static = (shard_cc_static(cc_static, device, node_devices)
                     if sharded else
                     {k: v.to(device) if torch.is_tensor(v) else v
                      for k, v in cc_static.items()})
    node_gens = (node_generators(node_devices, node_seed)
                 if sharded and cfg.sample_missing else None)
    return out + (cc_static, node_gens)


def launch_counts():
    """The running launch counts of the port's kernels (``ops/*_cuda``)."""
    return {'node_scan_launches': node_scan_cuda.launches,
            'node_scan_split_launches': node_scan_cuda.split_launches,
            'pair_loglik_launches': pair_loglik_cuda.launches,
            'pair_loglik_rows_launches': pair_loglik_rows_cuda.launches,
            'dir_loglik_launches': dir_loglik_cuda.launches,
            'dir_loglik_rows_launches': dir_loglik_rows_cuda.launches,
            'site_loglik_launches': site_loglik_cuda.launches,
            'site_loglik_rows_launches': site_loglik_rows_cuda.launches}


def _attach(sweep, cfg, Y, miss, cc_static, node_gens, node_devices):
    """The sweep, recorded as a ``sweep`` span with its kernel launches
    (``tracing.traced``), with its configuration ``sweep.cfg``, its stored
    network ``sweep.Y``, the missing-dyad mask ``sweep.miss_mask``, the
    case-control structures ``sweep.cc_static``, the node shards'
    generators ``sweep.node_gens`` and their count ``sweep.node_shards``."""
    sweep = tracing.traced(sweep, name='sweep', counters=launch_counts)
    sweep.cfg = cfg
    sweep.Y = Y
    sweep.miss_mask = None if miss is None else miss.mask
    sweep.cc_static = cc_static
    sweep.node_gens = node_gens
    sweep.node_shards = 1 if node_devices is None else len(node_devices)
    return sweep


def kernel_network(cfg, Y):
    """The form of a 0/1 network Y (..., T, n, n) uint8 that the kernels
    read: packed as ``Y + 2 Y^T`` when directed, Y itself otherwise; of a
    row-split network (RowShards) its row-split form
    (``nodes.kernel_rows``)."""
    if isinstance(Y, RowShards):
        return kernel_rows(cfg, Y)
    return pack_directed(Y) if cfg.is_directed else Y


def _sweep_network(cfg, Y, Y_scan, state):
    """(the network the coefficient kernels read, the node scan's padded
    rows): the stored ones, or with missing dyads each chain's own, derived
    from ``state.Y`` (C, T, n, n) once here; neither under the case-control
    likelihood, whose blocks read the edge lists."""
    if not cfg.sample_missing or cfg.n_control is not None:
        return Y, Y_scan
    if state.Y is None:
        raise ValueError('a sweep with sample_missing needs the per-chain '
                         'network state.Y')
    Yk = kernel_network(cfg, state.Y)
    if isinstance(Yk, RowShards):
        return Yk, Yk
    return Yk, pad_partners(Yk)


class MissingDyads(NamedTuple):
    """The missing dyads of a network: ``mask`` (T, n, n) bool, symmetric
    when undirected, and the dyads a resample draws, (t, i, j) int64
    index tensors (M,): every masked dyad when directed, the masked upper
    triangle (i < j) when undirected, whose draws are mirrored to (j, i)."""
    mask: torch.Tensor
    t: torch.Tensor
    i: torch.Tensor
    j: torch.Tensor


def missing_dyads(miss_mask, is_directed):
    """:class:`MissingDyads` of a (T, n, n) bool mask (its diagonal is
    never drawn)."""
    mask = miss_mask.clone()
    n = mask.shape[-1]
    mask[:, torch.arange(n), torch.arange(n)] = False
    drawn = mask if is_directed else torch.triu(mask, diagonal=1)
    t, i, j = torch.nonzero(drawn, as_tuple=True)
    return MissingDyads(mask, t, i, j)


def resample_missing(cfg, gen, Y, X, intercept, radii, dyads, temper=None,
                     u=None):
    """Gibbs-resample each chain's missing dyads from their Bernoulli
    conditionals (JAX ``_resample_missing``, reference lsm.py:526-545,
    hdp_lpcm.py:1026-1049).

    Y (C, T, n, n) uint8 0/1; X (C, T, n, d); intercept (C, 1), or (C, 2)
    and radii (C, n) when directed; ``dyads`` the :func:`missing_dyads`.
    A dyad (t, i, j) is drawn as ``u < p``, p = expit(eta) with JAX's eta
    (undirected b - d_ij; directed b_in (1 - d_ij / r_j) + b_out (1 - d_ij
    / r_i)), from the uniforms ``u`` (C, T, n, n) of every dyad, or (C, M)
    of the drawn ones from ``gen`` when not given; undirected, the draw of
    the upper-triangle dyad is mirrored.  Under parallel tempering
    (``temper`` (C,)) the conditional of the tempered likelihood
    p^beta / (p^beta + (1 - p)^beta) is expit(beta * eta).  Only the
    missing dyads change; the cost is that of the M drawn dyads, with no
    dense (C, T, n, n) intermediate.  Returns the new Y."""
    t, i, j = dyads.t, dyads.i, dyads.j
    draw = missing_draws(cfg, gen, X, intercept, radii, t, i, j, temper,
                         None if u is None else u[:, t, i, j]).to(Y.dtype)
    Y = Y.clone()
    Y[:, t, i, j] = draw
    if not cfg.is_directed:
        Y[:, t, j, i] = draw
    return Y


def control_generator(ctrl_seed, it, device):
    """The generator of the control draw of sweep ``it``: seeded by the
    fit's control seed and ``it``, so every chain gets the same draw and a
    rerun the same sequence."""
    return torch.Generator(device=device).manual_seed(
        int(ctrl_seed) * 2**32 + int(it))


def draw_controls(cfg, cc_static, it):
    """(ctrl_in or None, ctrl_out) (n, m) of sweep ``it``
    (``ops.case_control.sample_controls_colored``); the fit's initial draw
    is that of ``it`` = 0, which the first sweep redraws identically."""
    colors = cc_static['colors']
    return sample_controls_colored(
        control_generator(cc_static['ctrl_seed'], it, colors.device),
        colors, colors.shape[0], cfg.n_control, directed=cfg.is_directed)


def _refresh_controls(cfg, gen, state, cc_static):
    """The controls of this sweep: redrawn when the sweep count ``it`` is a
    multiple of ``cfg.n_resample_control`` (reference
    CaseControlSampler.resample, case_control_likelihood.py:27-33), else
    the state's.  The cadence is read from chain 0's count on the host
    (one synchronisation a sweep, a ``tracing.host_sync``).  With colour
    classes the draw is one for all chains (:func:`draw_controls`);
    without them (a ``cc_static`` of edge lists alone, the sequential
    scan's) each chain draws its own
    from the sweep's generator ``gen``, (C, n, m), as the JAX sweep draws
    them from each chain's key
    (``ops.case_control.sample_control_nodes``)."""
    with tracing.host_sync():
        it = int(state.it[0])
    if it % cfg.n_resample_control:
        return state.ctrl_in, state.ctrl_out
    if 'colors' not in cc_static:
        return sample_control_nodes(gen, state.X[..., 0], cfg.n_control,
                                    directed=cfg.is_directed,
                                    n_chains=state.X.shape[0])
    return draw_controls(cfg, cc_static, it)


def build_cc_dict(cfg, Y, cc_static, ctrl_in, ctrl_out):
    """The case-control structures every block reads: the edge lists
    (``cc_static``'s, or with ``cfg.sample_missing`` rebuilt from the
    network Y ((C,) T, n, n), each chain's own), the controls with their
    validity masks, and the colour classes when ``cc_static`` has them.
    The sweeps' and the initial
    logp's single source (JAX ``build_cc_dict``).  Node-sharded
    structures (``nodes.shard_cc_static``) give one such dict a shard
    (``nodes.build_cc_shards``)."""
    if 'bounds' in cc_static:
        return build_cc_shards(cfg, Y, cc_static, ctrl_in, ctrl_out)
    if cfg.sample_missing:
        lists = edge_lists_device(Y, cc_static['max_deg'])
    else:
        lists = {k: cc_static[k]
                 for k in ('in_edges', 'out_edges', 'degrees')}
    civ, cov = control_masks(ctrl_in, ctrl_out, lists, cfg.is_directed)
    cc = dict(lists, ctrl_in=ctrl_in, ctrl_out=ctrl_out,
              ctrl_in_valid=civ, ctrl_out_valid=cov)
    cc.update({k: cc_static[k] for k in ('color_groups', 'group_sizes')
               if k in cc_static})
    return cc


@tracing.traced
def _cc_structures(cfg, gen, state, cc_static):
    """(the structures of :func:`build_cc_dict` for this sweep, ctrl_in,
    ctrl_out)."""
    ctrl_in, ctrl_out = _refresh_controls(cfg, gen, state, cc_static)
    return (build_cc_dict(cfg, state.Y, cc_static, ctrl_in, ctrl_out),
            ctrl_in, ctrl_out)


@tracing.traced
def _missing_dyad_step(cfg, gen, state, dyads, X, intercept, radii,
                       it_next, cc_static=None, ctrl=None, node_gens=None):
    """Step 7 of the JAX sweeps: resample the missing ``dyads``
    (:func:`resample_missing`), add them to ``missing_sum`` once a chain's
    sweep count passes ``cfg.n_burn``, and score the new network (one pair
    launch at one intercept, or one directed candidate; under case-control,
    ``cc_static`` and the sweep's controls ``ctrl``, the estimator on the
    new network's edge lists): the coefficient steps' log-likelihood
    belongs to the old network.  Node-sharded ``dyads``
    (``nodes.ShardedMissing``) are drawn by their shards from
    ``node_gens`` (``nodes.missing_dyad_step``).  Returns (Y, missing_sum,
    the network log-likelihood)."""
    if isinstance(dyads, ShardedMissing):
        Y, missing_sum = sharded_missing_dyad_step(
            cfg, dyads, node_gens, state.Y, state.missing_sum, X, intercept,
            radii, it_next, state.temper)
    else:
        Y = resample_missing(cfg, gen, state.Y, X, intercept, radii, dyads,
                             temper=state.temper)
        t, i, j = dyads.t, dyads.i, dyads.j
        add = (Y[:, t, i, j].to(DTYPE)
               * (it_next > cfg.n_burn).to(DTYPE)[:, None])
        missing_sum = state.missing_sum.clone()
        missing_sum[:, t, i, j] += add
        if not cfg.is_directed:
            missing_sum[:, t, j, i] += add
    if cc_static is not None:
        cc = build_cc_dict(cfg, Y, cc_static, *ctrl)
        return Y, missing_sum, cc_network_loglik(X, intercept, radii, cc,
                                                 cfg.is_directed)
    return Y, missing_sum, network_loglik(cfg, kernel_network(cfg, Y), X,
                                          intercept, radii)


def _sample_coefficients(cfg, gen, Y, X, state, prior_means, cc=None):
    """The intercept step, then the radii step when directed (under the
    case-control structures ``cc`` when given).  Returns (intercept,
    acc_int, radii, acc_radii, the network log-likelihood at the accepted
    state)."""
    radii, acc_radii = state.radii, state.acc_radii
    if cfg.is_directed:
        intercept, acc_i, net_ll = sample_intercepts_directed(
            gen, Y, X, state.intercept, state.radii, state.step_int,
            prior_means, cfg.intercept_variance_prior, temper=state.temper,
            cc=cc)
        radii, acc_r, net_ll = sample_radii(
            gen, Y, X, intercept, state.radii, state.step_radii,
            loglik_cur=net_ll, temper=state.temper, cc=cc)
        acc_radii = state.acc_radii + acc_r
    else:
        intercept, acc_i, net_ll = sample_intercept_undirected(
            gen, Y, X, state.intercept, state.step_int, prior_means[0],
            cfg.intercept_variance_prior, temper=state.temper, cc=cc)
    return intercept, state.acc_int + acc_i, radii, acc_radii, net_ll


def _intercept_logprior(cfg, intercept, intercept_prior):
    diff = intercept - intercept_prior
    return -torch.sum(0.5 * diff * diff / cfg.intercept_variance_prior,
                      dim=1)


@tracing.traced
def _lsm_logp(cfg, Y, X, intercept, radii, dist, intercept_prior,
              net_ll=None, cc=None):
    """LSM log joint per chain (reference lsm.py:576-625): the network
    log-likelihood (``net_ll`` if given, else from the dense distances
    ``dist``, or when None from X in blocks, and the 0/1 Y, or the
    case-control estimator of ``cc``), the
    random-walk prior of the positions and the intercepts' Gaussian prior.
    intercept_prior (1, P) or (P,)."""
    ll = (net_ll if net_ll is not None
          else _network_loglik(cfg, Y, dist, intercept, radii, X, cc))
    ll = ll - 0.5 * torch.sum(X[:, 0] * X[:, 0], dim=(1, 2)) / cfg.tau_sq
    if X.shape[1] > 1:
        diff = X[:, 1:] - X[:, :-1]
        ll = ll - 0.5 * torch.sum(diff * diff, dim=(1, 2, 3)) / cfg.sigma_sq
    return ll + _intercept_logprior(cfg, intercept, intercept_prior)


def _latent_mixture_loglik(X, z, mu, sigma, lmbda):
    """Latent-position log density under the mixture dynamics (reference
    hdp_lpcm.py:1247-1253), per chain."""
    mu_z, sig_z = site_cluster_params(mu, sigma, z)
    diff0 = X[:, 0] - mu_z[:, 0]
    ll = torch.sum(-0.5 * torch.log(sig_z[:, 0])
                   - 0.5 * torch.sum(diff0 * diff0, dim=-1) / sig_z[:, 0],
                   dim=1)
    if X.shape[1] > 1:
        lam = lmbda[:, None, None, None]
        difft = X[:, 1:] - (1.0 - lam) * X[:, :-1] - lam * mu_z[:, 1:]
        ll = ll + torch.sum(
            -0.5 * torch.log(sig_z[:, 1:])
            - 0.5 * torch.sum(difft * difft, dim=-1) / sig_z[:, 1:],
            dim=(1, 2))
    return ll


@tracing.traced
def _count_chain_loglik(n_trans, nk, w0, w_trans):
    """sum_k nk[0,k] log w0[k] + sum_{t>0} n_trans[t] . log w[t], per
    chain."""
    ll = torch.sum(nk[:, 0] * torch.log(torch.clamp_min(w0, SMALL_EPS)),
                   dim=1)
    if n_trans.shape[1] > 1:
        ll = ll + torch.sum(
            n_trans[:, 1:] * torch.log(torch.clamp_min(w_trans[:, 1:],
                                                       SMALL_EPS)),
            dim=(1, 2, 3))
    return ll


def _network_loglik(cfg, Y, dist, intercept, radii, X=None, cc=None):
    """Dense network log-likelihood; Y (T, n, n) or (C, T, n, n) 0/1, from
    the distances ``dist`` or, when None, from X in blocks
    (``ops.likelihoods.dense_network_loglik``: no (C, T, n, n) tensor).
    With ``cc``, the case-control estimator at the positions X."""
    if cc is not None:
        return cc_network_loglik(X, intercept, radii, cc, cfg.is_directed)
    if dist is None:
        return dense_network_loglik(Y, X, intercept,
                                    radii if cfg.is_directed else None)
    if cfg.is_directed:
        return directed_loglik_full(Y, dist, radii, intercept[:, 0],
                                    intercept[:, 1])
    return undirected_loglik_full(Y, dist, intercept[:, 0])


@tracing.traced
def _mixture_common_logp(cfg, Y, X, intercept, dist, z, mu, sigma, lmbda,
                         mean_var, b_scale, intercept_prior, net_ll=None,
                         radii=None, cc=None):
    """Network + latent + cluster-parameter + hyper-prior terms of the log
    joint (reference hdp_lpcm.py:1213-1278), with the radii's Dirichlet(1)
    prior when directed.  ``net_ll`` reuses an already-computed network
    log-likelihood at the current state; ``cc`` switches the network term
    to the case-control estimator."""
    ll = (net_ll if net_ll is not None
          else _network_loglik(cfg, Y, dist, intercept, radii, X, cc))
    ll = ll + _intercept_logprior(cfg, intercept, intercept_prior)
    ll = ll + _latent_mixture_loglik(X, z, mu, sigma, lmbda)
    ll = ll - 0.5 * torch.sum(mu * mu, dim=(1, 2)) / mean_var
    _, sig_z = site_cluster_params(mu, sigma, z)
    ll = ll + torch.sum(-(0.5 * cfg.a + 1.0) * torch.log(sig_z)
                        - 0.5 * b_scale[:, None, None] / sig_z, dim=(1, 2))
    ll = ll + truncated_normal_logpdf(lmbda, cfg.lambda_prior,
                                      cfg.lambda_variance_prior)
    if cfg.is_directed:
        ll = ll + dirichlet_logpdf(radii, torch.ones_like(radii))
    if cfg.a0 is not None:
        ll = ll + (-(0.5 * cfg.a0 + 1.0) * torch.log(mean_var)
                   - 0.5 * cfg.b0 / mean_var)
    if cfg.c0 is not None:
        ll = ll + (cfg.c0 - 1.0) * torch.log(b_scale) - cfg.d0 * b_scale
    return ll


@tracing.traced
def _hdp_weights_logp(beta, w0, weights, gamma, alpha_init, alpha, kappa):
    """Dirichlet prior terms of beta, the initial and the transition
    distributions, per chain."""
    C, K = beta.shape
    T = weights.shape[1]
    eye = torch.eye(K, dtype=beta.dtype, device=beta.device)
    logp = dirichlet_logpdf(beta, (gamma / K)[:, None].expand(C, K))
    logp = logp + dirichlet_logpdf(w0, alpha_init[:, None] * beta)
    conc_w = (alpha[:, None, None, None] * beta[:, None, None, :]
              + kappa[:, None, None, None] * eye)
    logp = logp + torch.sum(dirichlet_logpdf(
        weights[:, 1:], conc_w.expand(C, T - 1, K, K)), dim=(1, 2))
    return logp


def hdp_logp_at_state(cfg, Y, intercept_prior, X, intercept, z, mu, sigma,
                      lmbda, weights, beta, gamma, alpha_init, alpha, kappa,
                      mean_var, b_scale, radii=None, cc=None):
    """Full HDP-LPCM log joint at an arbitrary chain-batched state, with
    the network term from the dense network (reference hdp_lpcm.py:798-809;
    in blocks of times, no (C, T, n, n) tensor), or from the case-control
    structures ``cc`` (Y unread).
    Y (T, n, n) 0/1, or each chain's (C, T, n, n); intercept_prior (1,),
    or (2,) and radii (C, n) for the directed model."""
    K = cfg.n_components
    n_trans, nk, _ = _label_statistics(z, K)
    prior = torch.as_tensor(intercept_prior, dtype=X.dtype, device=X.device)
    w0 = weights[:, 0, 0]
    logp = _hdp_weights_logp(beta, w0, weights, gamma, alpha_init, alpha,
                             kappa)
    logp = logp + _count_chain_loglik(n_trans, nk, w0, weights)
    return logp + _mixture_common_logp(
        cfg, Y, X, intercept, None, z, mu, sigma, lmbda, mean_var, b_scale,
        prior, radii=radii, cc=cc)


@tracing.traced
def _finish_tuning(cfg, state, acc_X, acc_int, acc_radii):
    step_X, acc_X = maybe_tune(state.it, cfg.tune, cfg.tune_interval,
                               state.step_X, acc_X,
                               kind=('mala' if cfg.latent_update == 'mala'
                                     else 'random_walk'))
    step_int, acc_int = maybe_tune(state.it, cfg.tune, cfg.tune_interval,
                                   state.step_int, acc_int)
    step_radii = state.step_radii
    if cfg.is_directed and cfg.tune_radii:
        step_radii, acc_radii = maybe_tune(
            state.it, cfg.tune, cfg.tune_interval, state.step_radii,
            acc_radii, kind='dirichlet')
    return step_X, acc_X, step_int, acc_int, step_radii, acc_radii


def _chain_mask(mask, like):
    """A (C,) mask shaped to broadcast against ``like`` (C, ...)."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def make_lsm_sweep(Y_fixed, intercept_prior, cfg: SweepConfig,
                   device='cuda', miss_mask=None, cc_static=None,
                   node_devices=None, node_seed=0):
    """Build the dynamic LSM sweep (reference lsm.py:474-572) over the
    fixed 0/1 network ``Y_fixed`` (T, n, n), or with
    ``cfg.sample_missing`` over each chain's ``state.Y`` with the dyads of
    ``miss_mask`` resampled (see :func:`_fixed_network`), on ``device``.
    ``intercept_prior`` holds one prior mean, or (b_in, b_out)'s two when
    directed.  In order: the latent positions under the random-walk prior
    (``cfg.tau_sq``, ``cfg.sigma_sq``); the Procrustes rotation toward
    ``X_ref`` once a chain's sweep count passes ``cfg.n_burn``; centering;
    the intercept(s) and, directed, the radii; the missing dyads; the log
    joint; MAP tracking
    (reset at the end of tuning) and ``X_ref`` tracking up to
    ``cfg.n_burn``; step-size tuning.  With ``cfg.n_control`` and
    ``cc_static`` the case-control likelihood (see the module's text).  The returned ``sweep(state, gen)``
    carries its configuration as ``sweep.cfg`` and the stored network as
    ``sweep.Y``."""
    (Y, Y_scan, miss, prior, prior_means, cc_static,
     node_gens) = _sweep_inputs(Y_fixed, intercept_prior, cfg, device,
                                miss_mask, cc_static, node_devices, node_seed)

    def sweep(state: LSMState, gen: torch.Generator) -> LSMState:
        it_next = state.it + 1
        cc, ctrl_in, ctrl_out = (
            _cc_structures(cfg, gen, state, cc_static) if cc_static is not None
            else (None, None, None))
        Yk, Yk_scan = _sweep_network(cfg, Y, Y_scan, state)

        # latent positions (random-walk prior)
        X, acc_new = sample_latent_positions(
            gen, Yk_scan, state.X, state.intercept, state.step_X,
            tau_sq=cfg.tau_sq, sigma_sq=cfg.sigma_sq, radii=state.radii,
            is_directed=cfg.is_directed, mixture=False, temper=state.temper,
            cc=cc, scheme=cfg.latent_update)
        acc_X = state.acc_X + acc_new

        # Procrustes toward the burn-phase reference (lsm.py:495-498),
        # then centering across time (lsm.py:501)
        X_rot, _ = longitudinal_procrustes_rotation(state.X_ref, X)
        X = torch.where(_chain_mask(it_next > cfg.n_burn, X), X_rot, X)
        if cfg.center:
            X = X - torch.mean(X, dim=(1, 2), keepdim=True)

        intercept, acc_int, radii, acc_radii, net_ll = _sample_coefficients(
            cfg, gen, Yk, X, state, prior_means, cc)
        Y_new, missing_sum = state.Y, state.missing_sum
        if miss is not None:
            Y_new, missing_sum, net_ll = _missing_dyad_step(
                cfg, gen, state, miss, X, intercept, radii, it_next,
                cc_static, (ctrl_in, ctrl_out), node_gens)

        # log joint and MAP tracking (lsm.py:547-566)
        logp = _lsm_logp(cfg, None, X, intercept, radii, None, prior,
                         net_ll=net_ll)
        better = logp > state.logp_map
        if cfg.tune > 0:
            better = better | (it_next == cfg.n_burn)
        logp_map = torch.where(better, logp, state.logp_map)
        X_map = torch.where(_chain_mask(better, X), X, state.X_map)
        intercept_map = torch.where(better[:, None], intercept,
                                    state.intercept_map)
        radii_map = state.radii_map
        if cfg.is_directed:
            radii_map = torch.where(better[:, None], radii, state.radii_map)

        # Procrustes reference: the best sample up to the end of burn-in
        ref_better = (it_next <= cfg.n_burn) & (logp > state.logp_ref)
        logp_ref = torch.where(ref_better, logp, state.logp_ref)
        X_ref = torch.where(_chain_mask(ref_better, X), X, state.X_ref)

        step_X, acc_X, step_int, acc_int, step_radii, acc_radii = (
            _finish_tuning(cfg, state, acc_X, acc_int, acc_radii))
        return state.replace(
            it=it_next, X=X, intercept=intercept, radii=radii,
            step_X=step_X, acc_X=acc_X, step_int=step_int, acc_int=acc_int,
            step_radii=step_radii, acc_radii=acc_radii, logp=logp,
            logp_map=logp_map, X_map=X_map, intercept_map=intercept_map,
            radii_map=radii_map, logp_ref=logp_ref, X_ref=X_ref, Y=Y_new,
            missing_sum=missing_sum, ctrl_in=ctrl_in, ctrl_out=ctrl_out)

    return _attach(sweep, cfg, Y, miss, cc_static, node_gens, node_devices)


@tracing.traced
def _lpcm_weights_logp(cfg, init_weights, trans_weights):
    """Dirichlet(dirichlet_prior) prior terms of the LPCM's initial
    distribution (C, K) and transition rows (C, K, K), per chain."""
    dp = cfg.dirichlet_prior
    logp = dirichlet_logpdf(init_weights, torch.full_like(init_weights, dp))
    return logp + torch.sum(dirichlet_logpdf(
        trans_weights, torch.full_like(trans_weights, dp)), dim=1)


def _lpcm_count_loglik(n_trans, nk, init_weights, trans_weights):
    C, T, K, _ = n_trans.shape
    return _count_chain_loglik(n_trans, nk, init_weights,
                               trans_weights[:, None].expand(C, T, K, K))


def lpcm_logp_at_state(cfg, Y, intercept_prior, X, intercept, z, mu, sigma,
                       lmbda, init_weights, trans_weights, mean_var, b_scale,
                       radii=None, cc=None):
    """Full LPCM log joint at an arbitrary chain-batched state, with the
    network term from the dense network (reference lpcm.py:770-856; in
    blocks of times), or from the case-control structures ``cc`` (Y
    unread).
    Y (T, n, n) 0/1, or each chain's (C, T, n, n); intercept_prior (1,),
    or (2,) and radii (C, n) for the directed model."""
    n_trans, nk, _ = _label_statistics(z, cfg.n_components)
    prior = torch.as_tensor(intercept_prior, dtype=X.dtype, device=X.device)
    logp = _lpcm_weights_logp(cfg, init_weights, trans_weights)
    logp = logp + _lpcm_count_loglik(n_trans, nk, init_weights,
                                     trans_weights)
    return logp + _mixture_common_logp(
        cfg, Y, X, intercept, None, z, mu, sigma, lmbda, mean_var, b_scale,
        prior, radii=radii, cc=cc)


def _conjugate_blocks(cfg, gen, X, state, z, resp, nk):
    """The cluster means, variances and lambda given the new labels, then
    the hyper-priors (hdp_lpcm.py:901-972).  Returns (mu, sigma, lmbda,
    mean_var, b_scale)."""
    mu = sample_cluster_means(gen, X, resp, nk, state.sigma, state.lmbda,
                              state.mean_var)
    sigma = sample_cluster_variances(gen, X, resp, nk, mu, state.lmbda,
                                     cfg.a, state.b_scale)
    lmbda = sample_lambda(gen, X, z, mu, sigma, cfg.lambda_prior,
                          cfg.lambda_variance_prior)
    mean_var = state.mean_var
    if cfg.a0 is not None:
        mean_var = sample_mean_variance_hyper(gen, mu, cfg.a0, cfg.b0)
    b_scale = state.b_scale
    if cfg.c0 is not None:
        b_scale = sample_sigma_scale_hyper(gen, sigma, cfg.a, cfg.c0,
                                           cfg.d0)
    return mu, sigma, lmbda, mean_var, b_scale


def _mixture_latent_and_coefficients(cfg, gen, Y, Y_scan, state,
                                     prior_means, cc=None):
    """The latent positions under the mixture prior (on the padded
    ``Y_scan``, or the case-control structures ``cc``), centering, then the
    intercept(s) and radii.  Returns (X, acc_X, intercept, acc_int, radii,
    acc_radii, net_ll)."""
    X, acc_new = sample_latent_positions(
        gen, Y_scan, state.X, state.intercept, state.step_X, mu=state.mu,
        sigma=state.sigma, lmbda=state.lmbda, z=state.z, radii=state.radii,
        is_directed=cfg.is_directed, temper=state.temper, cc=cc,
        scheme=cfg.latent_update)
    if cfg.center:
        X = X - torch.mean(X, dim=(1, 2), keepdim=True)
    return (X, state.acc_X + acc_new) + _sample_coefficients(
        cfg, gen, Y, X, state, prior_means, cc)


def make_lpcm_sweep(Y_fixed, intercept_prior, cfg: SweepConfig,
                    device='cuda', miss_mask=None, cc_static=None,
                    node_devices=None, node_seed=0):
    """Build the finite-K LPCM sweep (reference lpcm.py:514-701) over the
    fixed 0/1 network ``Y_fixed`` (T, n, n), or with ``cfg.sample_missing``
    over each chain's ``state.Y`` (see :func:`make_lsm_sweep`), on
    ``device``: latent
    positions (mixture prior) and centering, intercept(s) and radii,
    blocked FFBS labels with one transition matrix, Dirichlet draws of the
    initial and transition distributions, the conjugate cluster blocks and
    hyper-priors, the missing dyads, the log joint and tuning.
    ``sweep.cfg`` is its configuration and ``sweep.Y`` the stored
    network.  ``cc_static``: the case-control likelihood, as in
    :func:`make_lsm_sweep`."""
    (Y, Y_scan, miss, prior, prior_means, cc_static,
     node_gens) = _sweep_inputs(Y_fixed, intercept_prior, cfg, device,
                                miss_mask, cc_static, node_devices, node_seed)

    def sweep(state: MixtureState, gen: torch.Generator) -> MixtureState:
        cc, ctrl_in, ctrl_out = (
            _cc_structures(cfg, gen, state, cc_static) if cc_static is not None
            else (None, None, None))
        Yk, Yk_scan = _sweep_network(cfg, Y, Y_scan, state)
        (X, acc_X, intercept, acc_int, radii, acc_radii,
         net_ll) = _mixture_latent_and_coefficients(
             cfg, gen, Yk, Yk_scan, state, prior_means, cc)

        # labels via blocked FFBS (lpcm.py:567-570)
        z, n_trans, nk, resp = sample_labels_block_lpcm(
            gen, X, state.mu, state.sigma, state.lmbda, state.init_weights,
            state.trans_weights)

        # initial and transition distributions (lpcm.py:572-579)
        init_weights = sample_dirichlet(gen, cfg.dirichlet_prior + nk[:, 0])
        trans_weights = sample_dirichlet(
            gen, cfg.dirichlet_prior + torch.sum(n_trans[:, 1:], dim=1))

        mu, sigma, lmbda, mean_var, b_scale = _conjugate_blocks(
            cfg, gen, X, state, z, resp, nk)
        Y_new, missing_sum = state.Y, state.missing_sum
        if miss is not None:
            Y_new, missing_sum, net_ll = _missing_dyad_step(
                cfg, gen, state, miss, X, intercept, radii, state.it + 1,
                cc_static, (ctrl_in, ctrl_out), node_gens)

        # log joint (lpcm.py:770-856)
        logp = _lpcm_weights_logp(cfg, init_weights, trans_weights)
        logp = logp + _lpcm_count_loglik(n_trans, nk, init_weights,
                                         trans_weights)
        logp = logp + _mixture_common_logp(
            cfg, None, X, intercept, None, z, mu, sigma, lmbda, mean_var,
            b_scale, prior, net_ll=net_ll, radii=radii)

        step_X, acc_X, step_int, acc_int, step_radii, acc_radii = (
            _finish_tuning(cfg, state, acc_X, acc_int, acc_radii))
        return state.replace(
            it=state.it + 1, X=X, intercept=intercept, z=z, mu=mu,
            sigma=sigma, lmbda=lmbda, init_weights=init_weights,
            trans_weights=trans_weights, mean_var=mean_var, b_scale=b_scale,
            step_X=step_X, acc_X=acc_X, step_int=step_int, acc_int=acc_int,
            radii=radii, step_radii=step_radii, acc_radii=acc_radii,
            logp=logp, Y=Y_new, missing_sum=missing_sum, ctrl_in=ctrl_in,
            ctrl_out=ctrl_out)

    return _attach(sweep, cfg, Y, miss, cc_static, node_gens, node_devices)


def make_hdp_sweep(Y_fixed, intercept_prior, cfg: SweepConfig,
                   device='cuda', miss_mask=None, cc_static=None,
                   node_devices=None, node_seed=0):
    """Build the sticky HDP-LPCM sweep over the fixed 0/1 network
    ``Y_fixed`` (T, n, n), stored as uint8 on ``device`` (packed as
    ``Y + 2 Y^T`` for the directed model, once here), or with
    ``cfg.sample_missing`` over each chain's ``state.Y`` (see
    :func:`make_lsm_sweep`).  ``intercept_prior`` holds one prior mean, or
    (b_in, b_out)'s two when directed.  The returned ``sweep(state, gen)``
    carries its configuration as ``sweep.cfg`` and the stored network as
    ``sweep.Y``.  ``cc_static``: the case-control likelihood, as in
    :func:`make_lsm_sweep`."""
    (Y, Y_scan, miss, prior, prior_means, cc_static,
     node_gens) = _sweep_inputs(Y_fixed, intercept_prior, cfg, device,
                                miss_mask, cc_static, node_devices, node_seed)
    K = cfg.n_components

    def sweep(state: MixtureState, gen: torch.Generator) -> MixtureState:
        C, T, n, _ = state.X.shape
        eye = torch.eye(K, dtype=state.X.dtype, device=state.X.device)
        cc, ctrl_in, ctrl_out = (
            _cc_structures(cfg, gen, state, cc_static) if cc_static is not None
            else (None, None, None))
        Yk, Yk_scan = _sweep_network(cfg, Y, Y_scan, state)
        (X, acc_X, intercept, acc_int, radii, acc_radii,
         net_ll) = _mixture_latent_and_coefficients(
             cfg, gen, Yk, Yk_scan, state, prior_means, cc)

        # blocked label sampling (hdp_lpcm.py:877)
        z, n_trans, nk, resp = sample_labels_block(
            gen, X, state.mu, state.sigma, state.lmbda, state.weights)

        # CRF auxiliary variables (hdp_lpcm.py:881-884)
        m = sample_tables(gen, n_trans, state.beta, state.alpha_init,
                          state.alpha, state.kappa, n_max=n,
                          cap=cfg.table_cap)
        m_bar, w_override = sample_mbar(gen, m, state.beta, state.kappa,
                                        state.alpha, n_max=n,
                                        cap=cfg.table_cap)

        # global stick weights, initial and transition distributions
        beta = sample_dirichlet(gen, state.gamma[:, None] / K + m_bar)
        w0 = sample_dirichlet(gen, state.alpha_init[:, None] * beta
                              + nk[:, 0])
        conc_t = (state.alpha[:, None, None, None] * beta[:, None, None, :]
                  + state.kappa[:, None, None, None] * eye + n_trans[:, 1:])
        w_rest = sample_dirichlet(gen, conc_t)
        w_first = torch.zeros((C, 1, K, K), dtype=X.dtype, device=X.device)
        w_first[:, 0, 0] = w0
        weights = torch.cat([w_first, w_rest], dim=1)

        mu, sigma, lmbda, mean_var, b_scale = _conjugate_blocks(
            cfg, gen, X, state, z, resp, nk)

        # concentration parameters (hdp_lpcm.py:977-1023)
        if cfg.sample_concentrations:
            gamma = sample_concentration_param(
                gen, state.gamma,
                n_clusters=torch.sum(m_bar > 0, dim=1).to(X.dtype),
                n_samples=torch.clamp_min(torch.sum(m_bar, dim=1), 1.0),
                prior_shape=cfg.gamma_prior_shape,
                prior_rate=cfg.gamma_prior_rate)
            alpha_init = sample_concentration_param(
                gen, state.alpha_init,
                n_clusters=torch.sum(m[:, 0, 0], dim=1),
                n_samples=torch.full_like(state.alpha_init, float(n)),
                prior_shape=cfg.alpha_init_shape,
                prior_rate=cfg.alpha_init_rate)
            alpha, kappa = sample_alpha_kappa_rho(
                gen, n_trans, m, w_override, state.alpha, state.kappa,
                cfg.alpha_kappa_shape, cfg.alpha_kappa_rate)
        else:
            gamma, alpha_init = state.gamma, state.alpha_init
            alpha, kappa = state.alpha, state.kappa
        Y_new, missing_sum = state.Y, state.missing_sum
        if miss is not None:
            Y_new, missing_sum, net_ll = _missing_dyad_step(
                cfg, gen, state, miss, X, intercept, radii, state.it + 1,
                cc_static, (ctrl_in, ctrl_out), node_gens)

        # log joint (hdp_lpcm.py:1188-1280)
        logp = _hdp_weights_logp(beta, w0, weights, gamma, alpha_init,
                                 alpha, kappa)
        logp = logp + _count_chain_loglik(n_trans, nk, w0, weights)
        logp = logp + _mixture_common_logp(
            cfg, None, X, intercept, None, z, mu, sigma, lmbda, mean_var,
            b_scale, prior, net_ll=net_ll, radii=radii)

        step_X, acc_X, step_int, acc_int, step_radii, acc_radii = (
            _finish_tuning(cfg, state, acc_X, acc_int, acc_radii))
        return state.replace(
            it=state.it + 1, X=X, intercept=intercept, z=z, mu=mu,
            sigma=sigma, lmbda=lmbda, weights=weights, beta=beta,
            gamma=gamma, alpha_init=alpha_init, alpha=alpha, kappa=kappa,
            mean_var=mean_var, b_scale=b_scale, step_X=step_X, acc_X=acc_X,
            step_int=step_int, acc_int=acc_int, radii=radii,
            step_radii=step_radii, acc_radii=acc_radii, logp=logp, Y=Y_new,
            missing_sum=missing_sum, ctrl_in=ctrl_in, ctrl_out=ctrl_out)

    return _attach(sweep, cfg, Y, miss, cc_static, node_gens, node_devices)
