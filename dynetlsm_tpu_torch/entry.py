"""Entry points of the port (counterparts of ``__graft_entry__.entry`` and
``bench.build_state_and_sweep``).

* :func:`entry` — one HDP-LPCM Gibbs sweep on a tiny random problem, with
  its arguments.
* :func:`dryrun_multichip` — that sweep on a ``chains`` mesh of n devices,
  then on a 2-D ``('chains', 'nodes')`` mesh (``__graft_entry__``'s
  multi-chip check).
* :func:`build_state_and_sweep` — a replicated chain state and the sweep
  of the sticky HDP-LPCM, the finite LPCM or the dynamic LSM for a dense
  undirected or directed network, from random positions, means and
  labels or, with ``quality_init=True``, from GMDS positions and
  longitudinal k-means (the two paths of ``bench.py``); with
  ``n_temps``, the parallel-tempering step over ladders of that many
  rungs (``bench.py``'s ``tempered`` row).  A network with missing dyads
  (coded -1 or NaN) is filled once by the imputer and its missing dyads
  are resampled every sweep, as the JAX estimators do.  With
  ``n_control``, the case-control likelihood (``bench.py``'s ``cc_*``
  rows), from Y or, with no dense network at all, from padded edge lists
  and the network's shape.

They run on the card unless the caller passes ``device='cpu'``; without a
CUDA device they raise (``config.resolve_device``).  ``build_state_and_sweep``
takes ``node_devices`` to split the network's rows over devices
(``mcmc/nodes.py``).
"""
import numpy as np
import torch

from .config import resolve_device
from .math.init import (
    generalized_mds, initialize_radii, longitudinal_kmeans)
from .mcmc.driver import (
    all_devices, chain_mesh, replicate_state, shard_state, spatial_mesh)
from .mcmc.nodes import derive_seed
from .mcmc.sweeps import (
    SweepConfig, _lsm_logp, make_hdp_sweep, make_lpcm_sweep, make_lsm_sweep)
from .mcmc.tempering import make_pt_step, temper_ladder
from .models.base import (
    case_control_static, controls_of, impute_missing, init_cc_dict,
    validate_network)
from .ops.case_control import build_edge_lists, max_degree_bound
from .ops.shards import RowShards

# the estimators' hyper-prior shapes at std 4 (mixture_base.py:77-88)
_HYPER = dict(a0=36.0, b0=40.0, c0=5.0, d0=2.0)


def _single_state(T, n, X0, n_int=1):
    """The fields every model's initial state shares: positions X0,
    intercept(s) 1.0, step sizes 0.1."""
    return {
        'it': 0, 'X': X0, 'intercept': np.ones(n_int),
        'step_X': np.full((T, n), 0.1), 'acc_X': np.zeros((T, n)),
        'step_int': np.full((n_int,), 0.1), 'acc_int': np.zeros(n_int),
        'logp': 0.0}


def _mixture_fields(mu0, sigma0, z0):
    return {'z': z0, 'mu': mu0, 'sigma': sigma0, 'lmbda': 0.9,
            'mean_var': 1.0, 'b_scale': 2.4}


def _hdp_fields(weights0, beta0):
    return {'weights': weights0, 'beta': beta0, 'gamma': 1.0,
            'alpha_init': 1.0, 'alpha': 1.0, 'kappa': 4.0}


def _tiny_problem(device, n_chains=1, T=3, n=18, K=5, d=2, seed=0,
                  node_devices=None):
    """(sweep, state, gen) of the HDP-LPCM on a random network; with
    ``node_devices`` the sweep ('parallel') splits the network's rows over
    them and resamples a few missing dyads, so the state's network is
    row-split too (the state stays on ``device``, the chains whole)."""
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.3, size=(T, n, n)).astype(np.float32)
    Y = np.triu(Y, 1)
    Y = Y + Y.transpose(0, 2, 1)
    z0 = rng.randint(0, K, size=(T, n))
    weights0 = np.full((T, K, K), 1.0 / K)
    miss = None
    if node_devices is not None:
        miss = np.triu(rng.rand(T, n, n) < 0.05, 1)
        miss |= np.swapaxes(miss, 1, 2)
    cfg = SweepConfig(tune=100, tune_interval=100, n_components=K,
                      latent_update='exact' if miss is None else 'parallel',
                      sample_missing=miss is not None, **_HYPER)
    sweep = make_hdp_sweep(None if miss is not None else Y,
                           np.zeros(1, np.float32), cfg, device=device,
                           miss_mask=miss, node_devices=node_devices,
                           node_seed=seed)
    s0 = _single_state(T, n, rng.randn(T, n, d))
    s0.update(_mixture_fields(rng.randn(K, d), np.ones(K), z0),
              **_hdp_fields(weights0, np.full(K, 1.0 / K)))
    if miss is not None:
        s0['Y'] = Y
    state = replicate_state(s0, n_chains, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return sweep, state, gen


def entry(device='cuda'):
    """(fn, example_args): one HDP-LPCM Gibbs sweep, ``fn(state, gen)``,
    on ``device`` (the card by default)."""
    sweep, state, gen = _tiny_problem(resolve_device(device))
    return sweep, (state, gen)


def dryrun_multichip(n_devices, device='cuda'):
    """The multi-device check of ``__graft_entry__.dryrun_multichip``: one
    HDP-LPCM sweep of 2 n_devices chains on a ``chains`` mesh of
    ``n_devices`` shards, each on its device with its own sweep and
    generator; then, with n_devices >= 2, one 'parallel' sweep of 4 chains
    on a 2 x n_devices/2 ``('chains', 'nodes')`` mesh (8 nodes a node
    shard, a few missing dyads resampled).  Asserts what JAX's asserts:
    every chain's sweep count is 1, its logp finite, and the layout kept
    (each row's chains on its device, the row-split network on its
    row's devices).  The mesh takes the devices of ``device``'s type in
    turn, repeating them when there are fewer than ``n_devices`` (one card,
    or the CPU)."""
    dev = resolve_device(device)
    avail = all_devices(dev.type)
    devices = [avail[k % len(avail)] for k in range(n_devices)]

    def step(mesh, **problem):
        rows = mesh.rows
        sweeps = [_tiny_problem(devs[0], node_devices=(
            devs if len(devs) > 1 else None), **problem)[0]
            for devs in rows]
        state = shard_state(_tiny_problem(
            'cpu', node_devices=['cpu'] * len(rows[0])
            if len(rows[0]) > 1 else None, **problem)[1], mesh)
        gens = [torch.Generator(device=devs[0]).manual_seed(
            derive_seed(0, r)) for r, devs in enumerate(rows)]
        out = [sw(s, g) for sw, s, g in zip(sweeps, state, gens)]
        for devs, s in zip(rows, out):
            assert s.X.device == devs[0], (s.X.device, devs)
            assert s.X.shape[0] == problem['n_chains'] // len(rows)
            it = s.it.cpu().numpy()
            assert (it == 1).all(), it
            assert np.isfinite(s.logp.cpu().numpy()).all()
            if len(devs) > 1:
                assert isinstance(s.Y, RowShards) and s.Y.devices == devs
        return out

    step(chain_mesh(devices), n_chains=2 * n_devices)
    if n_devices >= 2:
        cols = n_devices // 2
        step(spatial_mesh(2, cols, devices[:2 * cols]), n_chains=4,
             n=8 * cols)


def _initial_lsm_logp(cfg, Y, s0, prior, device, cc=None):
    """The LSM log joint of the single-chain start, from the dense network
    Y (T, n, n) 0/1 (the initial sample's logp, lsm.py:252-257; in blocks
    of times, ``ops.likelihoods.dense_network_loglik``), or with the
    case-control structures ``cc`` from their estimator (Y unread)."""
    X = torch.as_tensor(s0['X'], dtype=torch.float32, device=device)[None]
    b = torch.as_tensor(s0['intercept'], dtype=torch.float32,
                        device=device)[None]
    radii = s0.get('radii')
    if radii is not None:
        radii = torch.as_tensor(radii, dtype=torch.float32,
                                device=device)[None]
    prior = torch.as_tensor(prior, device=device)
    if cc is not None:
        return float(_lsm_logp(cfg, None, X, b, radii, None, prior,
                               cc=cc)[0])
    Yd = torch.as_tensor(np.asarray(Y), device=device)
    return float(_lsm_logp(cfg, Yd, X, b, radii, None, prior)[0])


def _fill_missing(Y, is_directed):
    """(the network Y (T, n, n) with its missing dyads filled, the
    missing-dyad mask), or (Y, None) when no dyad is missing: Y validated
    and its -1 or NaN dyads filled (``models.base.impute_missing``: the
    imputer's ``'random'`` draws, the observed dyads kept, the diagonal
    0)."""
    Y = np.asarray(Y)
    coded = Y.dtype.kind in 'if' and (bool((Y == -1).any()) or (
        Y.dtype.kind == 'f' and bool(np.isnan(Y).any())))
    if not coded:
        # no missing dyad: validate_network's float64 copy and dyad
        # indices (48 bytes a dyad) are skipped
        return Y, None
    Y_valid, _, miss, sample_missing = validate_network(Y, is_directed)
    if not sample_missing:
        return Y, None
    return impute_missing(Y_valid, miss), miss


def _radii_of_degrees(degrees):
    """Degree-normalised start radii from the edge lists' degrees (T, n, 2)
    (reference latent_space.py:140-153, ``math.init.initialize_radii``'s
    formula without a dense adjacency; bench.py's n = 20,000 row)."""
    degrees = np.asarray(degrees, np.float64)
    r = 0.5 * (degrees[..., 0].sum(0) + degrees[..., 1].sum(0))
    r /= degrees[..., 1].sum()
    if np.any(r == 0.0):
        r += 1e-5
        r /= r.sum()
    return r


def build_state_and_sweep(Y, n_chains, K=10, seed=0, table_cap=64,
                          device='cuda', is_directed=False, model='hdp',
                          n_temps=None, beta_min=0.2, quality_init=False,
                          n_control=None, edge_lists=None, shape=None,
                          latent_update='exact', node_devices=None):
    """A replicated chain state, the sweep and its generator for the dense
    network Y (T, n, n), undirected or directed, on ``device`` (the card
    by default).  Returns (state, sweep, gen).

    Dyads coded -1 or NaN are missing: they are filled once (the JAX
    estimators' random imputation, observed dyads kept), every chain
    starts from that network in ``state.Y`` with a zero
    ``state.missing_sum``, and the sweep (``cfg.sample_missing``)
    resamples them every sweep.

    With ``n_temps``, the ``n_chains`` slots form ``n_chains // n_temps``
    ladders of ``n_temps`` rungs from 1 down to ``beta_min``
    (``temper_ladder``; ``acc_swap`` zeros), and the returned step is
    ``make_pt_step(sweep, cfg, sweep.Y, n_temps)``: the tempered sweep then
    a replica exchange, as ``bench.py``'s ``tempered`` row builds it.

    * ``model='hdp'``: the sticky HDP-LPCM with K components, in the
      configuration of ``bench.py``'s headline and directed rows; the
      initial state draws the same NumPy random numbers as
      ``bench.build_state_and_sweep(..., quality_init=False)``.
    * ``model='lpcm'``: the finite LPCM with K components, the same
      hyper-priors, ``dirichlet_prior=1.0``, uniform transitions and the
      initial distribution of the random labels (lpcm.py:157-162).
    * ``model='lsm'``: the dynamic LSM with ``tau_sq=2.0``,
      ``sigma_sq=0.1``, no tuning and no burn-in (``n_burn=0``: the
      Procrustes rotation toward the start runs from the first sweep);
      its logp, MAP and Procrustes reference start at the log joint of the
      initial positions.

    Every model starts from intercept(s) 1.0 and from N(0, 1) positions,
    N(0, 1) means, unit variances and uniform labels, or, with
    ``quality_init``, from the GMDS positions of Y centred and the
    longitudinal k-means' means, variances and labels, drawn from the
    seed's RandomState in ``bench.build_state_and_sweep``'s order (what
    the benchmark's Sampson cells start from); directed, from radii of the
    degrees (``initialize_radii``) with step 175000, tuned in the mixture
    models (``tune_radii``) and not in the LSM (lsm.py:222).

    ``latent_update`` ('exact', 'parallel' or 'mala') is every model's
    latent-position scheme (``cfg.latent_update``).  ``node_devices`` (a
    list of devices, the first ``device``; 'parallel' or 'mala') splits
    the network's rows over them, and with missing dyads the state's
    ``Y`` and ``missing_sum`` (``mcmc/nodes.py``); the rest of the state
    stays on ``device``.

    ``n_control`` switches every model to the case-control likelihood with
    that many controls a node (``cfg.n_control``, redrawn every 100
    sweeps), as ``bench.build_state_and_sweep`` builds it: the edge lists
    of Y (``ops.case_control.build_edge_lists``) or the given
    ``edge_lists`` (that layout) of a network of ``shape`` (T, n), with Y
    ``None``: then no (T, n, n) array exists on the host or the card, and
    the start needs ``quality_init=False`` and no missing dyads.  The
    colour classes come from ``color_conflict_graph(..., seed=seed)``
    (missing dyads are conflicts), the controls from the seed ``seed + 7``;
    directed, the start radii are the degrees' (``_radii_of_degrees``,
    ``initialize_radii``'s formula).  The state carries the initial
    controls; the sweep launches none of the dense kernels."""
    if model not in ('hdp', 'lpcm', 'lsm'):
        raise ValueError("model must be 'hdp', 'lpcm' or 'lsm', got %r"
                         % (model,))
    if n_temps is not None and n_chains % n_temps:
        raise ValueError('n_chains=%d is not a whole number of %d-rung '
                         'ladders' % (n_chains, n_temps))
    device = resolve_device(device)
    if Y is None:
        if n_control is None or edge_lists is None or shape is None:
            raise ValueError('without Y, pass n_control, edge_lists and '
                             'shape')
        if quality_init:
            raise ValueError('quality_init needs the dense network Y')
        miss = None
        T, n = shape
    else:
        Y, miss = _fill_missing(Y, is_directed)
        T, n, _ = Y.shape
    missing = dict(sample_missing=miss is not None)
    common = dict(n_control=n_control, latent_update=latent_update)
    rng = np.random.RandomState(seed)
    d = 2
    n_int = 2 if is_directed else 1
    prior = np.zeros(n_int, np.float32)
    if quality_init:
        X0 = generalized_mds(Y, n_features=d, is_directed=is_directed,
                             random_state=rng)
        X0 -= X0.mean(axis=(0, 1))
    else:
        X0 = rng.randn(T, n, d)
    s0 = _single_state(T, n, X0, n_int)
    if miss is not None:
        s0['Y'] = Y
    lists = None
    if n_control is not None:
        lists = edge_lists if edge_lists is not None else \
            build_edge_lists(Y)
    if is_directed:
        s0.update(radii=(initialize_radii(Y) if lists is None
                         else _radii_of_degrees(lists['degrees'])),
                  step_radii=175000.0, acc_radii=0.0)

    def case_control(cfg):
        """(cc_static, the initial logp's structures) of ``cfg``, and the
        initial controls into s0; (None, None) without case-control."""
        if n_control is None:
            return None, None
        cc_static, ctrl0 = case_control_static(
            cfg, lists, n, device, color_seed=seed, ctrl_seed=seed + 7,
            miss_mask=miss,
            max_deg=None if miss is None else max_degree_bound(Y, miss))
        s0.update(controls_of(ctrl0))
        Yd = (torch.as_tensor(Y, dtype=torch.uint8, device=device)
              if miss is not None else None)
        return cc_static, init_cc_dict(cfg, Yd, cc_static, ctrl0)

    stored = None if n_control is not None and miss is None else Y
    if model == 'lsm':
        cfg = SweepConfig(is_directed=is_directed, tune=0, n_burn=0,
                          tau_sq=2.0, sigma_sq=0.1, **missing, **common)
        cc_static, cc0 = case_control(cfg)
        sweep = make_lsm_sweep(stored, prior, cfg, device=device,
                               miss_mask=miss, cc_static=cc_static,
                               node_devices=node_devices)
        logp0 = _initial_lsm_logp(cfg, Y, s0, prior, device, cc=cc0)
        s0.update(logp=logp0, logp_map=logp0, X_map=s0['X'],
                  intercept_map=s0['intercept'], logp_ref=logp0,
                  X_ref=s0['X'], radii_map=s0.get('radii'))
    else:
        if quality_init:
            mu0, sigma0, z0 = longitudinal_kmeans(X0, n_clusters=K,
                                                  random_state=rng)
        else:
            mu0, sigma0 = rng.randn(K, d), np.ones(K)
            z0 = rng.randint(0, K, size=(T, n))
        s0.update(_mixture_fields(mu0, sigma0, z0))
        cfg = SweepConfig(is_directed=is_directed, tune=0, tune_interval=100,
                          n_components=K, table_cap=table_cap,
                          tune_radii=is_directed, **_HYPER, **missing,
                          **common)
        cc_static, _ = case_control(cfg)
        if model == 'hdp':
            weights0 = np.zeros((T, K, K))
            weights0[0, 0] = np.bincount(z0[0], minlength=K) / n
            beta0 = rng.dirichlet(np.full(K, 1.0 / K))
            for t in range(1, T):
                for k in range(K):
                    weights0[t, k] = rng.dirichlet(beta0 + 4.0 * np.eye(K)[k])
            s0.update(_hdp_fields(weights0, beta0))
            sweep = make_hdp_sweep(stored, prior, cfg, device=device,
                                   miss_mask=miss, cc_static=cc_static,
                                   node_devices=node_devices)
        else:
            s0.update(init_weights=np.bincount(z0[0], minlength=K) / n,
                      trans_weights=np.full((K, K), 1.0 / K))
            sweep = make_lpcm_sweep(stored, prior, cfg, device=device,
                                    miss_mask=miss, cc_static=cc_static,
                                    node_devices=node_devices)
    state = replicate_state(s0, n_chains, device)
    if node_devices is not None and len(node_devices) > 1 and miss is not None:
        state = state.replace(
            Y=RowShards.split(state.Y, node_devices),
            missing_sum=RowShards.split(state.missing_sum, node_devices))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if n_temps is not None:
        betas = temper_ladder(n_temps, beta_min, n_chains // n_temps,
                              device=device)
        state = state.replace(temper=betas, acc_swap=torch.zeros_like(betas))
        return state, make_pt_step(sweep, sweep.cfg, sweep.Y, n_temps), gen
    return state, sweep, gen
