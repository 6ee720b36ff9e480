"""Shared estimator machinery of the three model classes (counterpart of
``dynetlsm_tpu/models/base.py``), in NumPy and torch: network validation
and the missing dyads' initial fill, the keyword checks, the fit's mesh
(``devices``, ``node_devices``), the case-control structures, tempering
set-up, the sampling stage on one device or a mesh, trace layout,
iteration counts, progress reports and per-stage wall times.
"""
import contextlib
import sys
import time
import types

import numpy as np
import torch

from ..array_utils import nondiag_indices_from_3d, triu_indices_from_3d
from ..imputer import SimpleNetworkImputer
from ..mcmc.latent import SCHEMES


def validate_network(Y, is_directed, copy=True):
    """Validate the dynamic adjacency tensor and locate missing dyads.

    Returns (Y float64 array, nan_mask over the dyad vector, miss_mask
    (T, n, n) boolean array, sample_missing flag).  Missing dyads are coded
    -1 (NaNs are converted), as in reference lsm.py:341-360; the dyad
    vector is the upper triangle (undirected) or every off-diagonal entry
    (directed), and ``miss_mask`` is symmetrised when undirected, with a
    false diagonal.
    """
    # NumPy 2 made copy=False mean "never copy"; copy=None copies only if
    # needed
    Y = np.array(Y, dtype=np.float64, copy=True if copy else None)
    if Y.ndim != 3 or Y.shape[1] != Y.shape[2]:
        raise ValueError('Y must have shape (n_time_steps, n_nodes, n_nodes), '
                         'got %r' % (Y.shape,))
    Y[np.isnan(Y)] = -1.0

    if is_directed:
        indices = nondiag_indices_from_3d(Y)
    else:
        indices = triu_indices_from_3d(Y, k=1)
    nan_mask = Y[indices] == -1

    miss_mask = Y == -1
    if not is_directed:
        miss_mask |= np.swapaxes(miss_mask, 1, 2)
    for t in range(Y.shape[0]):
        np.fill_diagonal(miss_mask[t], False)

    return Y, nan_mask, miss_mask, bool(nan_mask.any())


def impute_missing(Y, miss_mask):
    """The validated network Y (T, n, n) with the dyads of ``miss_mask``
    filled by the imputer's ``'random'`` draws (models/lsm.py:182-183, the
    same draws), the observed dyads kept and the diagonal 0.  The JAX
    estimators take the imputer's whole output, whose mirrored upper
    triangle overwrites a directed network's observed lower triangle; on
    an undirected network the two agree."""
    fill = SimpleNetworkImputer(strategy='random',
                                missing_value=-1).fit_transform(Y)
    Y = np.where(miss_mask, fill, Y)
    Y[:, np.arange(Y.shape[1]), np.arange(Y.shape[1])] = 0.0
    if not np.isin(Y, (0.0, 1.0)).all():
        raise ValueError('Y must hold 0/1 dyads, with missing ones coded '
                         '-1 or NaN')
    return Y


# the JAX keywords that mean something the port lacks: (name, accepted
# value, the ROADMAP item that ports it); none since multi-device fits
_UNSUPPORTED = ()


def check_supported(estimator):
    """Raise ``NotImplementedError`` for a keyword of the JAX estimators
    that the port accepts only at its default (``_UNSUPPORTED``), and the
    JAX sweep's ``ValueError`` for an unknown ``latent_update`` (here,
    before any initialisation work)."""
    if estimator.latent_update not in SCHEMES:
        raise ValueError(
            "latent_update must be 'exact', 'parallel', or 'mala', got %r"
            % (estimator.latent_update,))
    for name, default, item in _UNSUPPORTED:
        value = getattr(estimator, name)
        if value != default:
            raise NotImplementedError(
                '%s=%r is not ported yet (ROADMAP.md %s); the port takes '
                'only %s=%r' % (name, value, item, name, default))


def resolve_fit_mesh(n_chains, n_nodes, node_devices, devices,
                     latent_update, n_temps=1, device_type='cuda'):
    """Pick the fit's mesh (JAX ``resolve_fit_mesh``), validated before
    any initialisation work.  Returns the mesh, or None on one device.

    Default: a 1-D ``chains`` mesh over the largest subset of ``devices``
    (by default every device of ``device_type``: each card, or the one
    CPU) that divides ``n_chains`` (``mcmc.driver.auto_mesh``), or None on
    one device.  ``n_chains`` counts tempering ladders, not slots: a
    ladder stays whole on one device, so no replica swap crosses devices.
    With ``node_devices > 1``: a 2-D ``('chains', 'nodes')`` mesh
    splitting the network's rows over ``node_devices`` devices within each
    chain row (``spatial_auto_mesh``), with JAX's ``ValueError``s for
    parallel tempering, for the exact node scan and for a
    ``node_devices`` that does not divide n.  ``devices`` may repeat a
    device; they must be of ``device_type``."""
    from ..mcmc.driver import auto_mesh, device_list, spatial_auto_mesh
    devices = device_list(devices, device_type)
    if any(d.type != device_type for d in devices):
        raise ValueError('devices=%s: the fit runs on %r devices (device=)'
                         % ([str(d) for d in devices], device_type))
    if node_devices and node_devices > 1:
        if n_temps and int(n_temps) > 1:
            raise ValueError(
                'n_temps > 1 (parallel tempering) is not supported '
                'together with node_devices > 1: the replica-exchange '
                'gather permutes the chain axis, which conflicts with '
                'the 2-D spatial mesh')
        if latent_update not in ('parallel', 'mala'):
            raise ValueError(
                "node_devices > 1 shards the node axis across devices; the "
                "sequential exact node scan cannot be partitioned - "
                "construct the model with latent_update='parallel' or "
                "'mala'")
        return spatial_auto_mesh(n_chains, n_nodes, node_devices, devices)
    return auto_mesh(n_chains, devices)


def resolve_n_control(n_control, n_nodes):
    """Integer control-set size from an int or a node fraction (reference
    case_control_likelihood.py:40-43); None stays None."""
    if n_control is None:
        return None
    if isinstance(n_control, (int, np.integer)):
        return int(n_control)
    return int(n_control * n_nodes)


def case_control_static(cfg, lists, n, device, color_seed, ctrl_seed,
                        miss_mask=None, max_deg=None):
    """The fixed case-control structures of a sweep (``cc_static`` of
    ``mcmc/sweeps.py``) and the initial control draw, from the host edge
    lists ``lists`` (``ops.case_control.build_edge_lists``'s layout) of an
    n-node network:

    * the lists on ``device`` (int64), or with ``cfg.sample_missing`` only
      the degree bound ``max_deg`` (the sweep rebuilds each chain's lists);
    * the colour classes of the conflict graph, missing dyads counted as
      conflicts (``color_conflict_graph(..., seed=color_seed)``):
      ``colors``, ``color_groups`` and the classes' sizes ``group_sizes``;
    * ``ctrl_seed``, the seed of every control draw.

    Returns (cc_static, (ctrl_in or None, ctrl_out)), the draw of sweep 0
    (``mcmc.sweeps.draw_controls``), which the first sweep redraws
    identically."""
    from ..mcmc.sweeps import draw_controls
    from ..ops.case_control import color_conflict_graph
    if cfg.sample_missing:
        cc_static = {'max_deg': int(max_deg)}
    else:
        cc_static = {k: torch.as_tensor(np.asarray(lists[k]),
                                        device=device).long()
                     for k in ('in_edges', 'out_edges', 'degrees')}
    colors, groups = color_conflict_graph(lists, n, miss_mask=miss_mask,
                                          seed=color_seed)
    cc_static.update(
        colors=torch.as_tensor(colors, device=device).long(),
        color_groups=torch.as_tensor(groups, device=device).long(),
        group_sizes=tuple(int(v) for v in (groups >= 0).sum(axis=1)),
        ctrl_seed=int(ctrl_seed))
    return cc_static, draw_controls(cfg, cc_static, 0)


def build_case_control(cfg, Y_host, rng, device, miss_mask=None):
    """The case-control structures of an estimator's fit when
    ``cfg.n_control`` is set (JAX ``build_case_control``, with the same two
    draws from the fit's RandomState: the colouring's seed, then the
    control seed, so the colour classes equal the JAX fit's).  Y_host (T,
    n, n) the filled 0/1 network; ``miss_mask`` its missing dyads.
    Returns (cc_static, initial controls), or (None, None)."""
    if cfg.n_control is None:
        return None, None
    from ..ops.case_control import build_edge_lists, max_degree_bound
    lists = build_edge_lists(Y_host)
    max_deg = (max_degree_bound(Y_host, miss_mask) if cfg.sample_missing
               else None)
    color_seed = rng.randint(0, 2 ** 31 - 1)
    ctrl_seed = rng.randint(0, 2 ** 31 - 1)
    return case_control_static(cfg, lists, Y_host.shape[1], device,
                               color_seed, ctrl_seed, miss_mask=miss_mask,
                               max_deg=max_deg)


def init_cc_dict(cfg, Y_dev, cc_static, ctrl0):
    """The case-control structures of the initial sample's logp, built as
    the sweeps build theirs (``mcmc.sweeps.build_cc_dict``), so the stored
    ``logps_`` use one estimator throughout (the reference's logp switches
    to the approximation too, lsm.py:581-591).  Y_dev the filled network
    on the device (read only with missing dyads); None without
    case-control."""
    if cc_static is None:
        return None
    from ..mcmc.sweeps import build_cc_dict
    return build_cc_dict(cfg, Y_dev, cc_static, *ctrl0)


def controls_of(ctrl0):
    """The initial controls as the fields of a single-chain start
    (NumPy, ``ctrl_in`` None when undirected), or {} without them."""
    if ctrl0 is None:
        return {}
    return {name: None if v is None else v.cpu().numpy()
            for name, v in zip(('ctrl_in', 'ctrl_out'), ctrl0)}


def fit_rng(random_state):
    """The fit's ``np.random.RandomState``: seeded by an int, else fresh."""
    return np.random.RandomState(
        random_state if isinstance(random_state, (int, np.integer))
        else None)


def _seed_draws(rng):
    """The two draws with which the JAX estimators seed their state key
    and the chain keys (models/hdp_lpcm.py:278, :311)."""
    return rng.randint(0, 2**31 - 1), rng.randint(0, 2**31 - 1)


def chain_generator(rng, device):
    """The sweeps' ``torch.Generator`` on ``device``, seeded from
    :func:`_seed_draws`."""
    key_seed, chain_seed = _seed_draws(rng)
    return torch.Generator(device=device).manual_seed(
        int(key_seed) * 2**31 + int(chain_seed))


def row_generators(rng, mesh):
    """(one generator a chain row of ``mesh``, on the row's first device,
    row r seeded by ``derive_seed(key, chain, r)``; the rows' node seeds,
    ``derive_seed(key, chain, r, 1)``), from :func:`_seed_draws`."""
    from ..mcmc.nodes import derive_seed
    key_seed, chain_seed = _seed_draws(rng)
    gens = [torch.Generator(device=devs[0]).manual_seed(
                derive_seed(key_seed, chain_seed, r))
            for r, devs in enumerate(mesh.rows)]
    return gens, [derive_seed(key_seed, chain_seed, r, 1)
                  for r in range(len(gens))]


def setup_tempering(sweep, cfg, n_chains, n_temps, beta_min, swap_every,
                    state):
    """Attach per-slot inverse-temperature ladders and wrap the sweep for
    replica exchange (``n_temps > 1``).

    ``state`` must already be replicated to ``n_chains * n_temps`` slots;
    each consecutive block of ``n_temps`` slots becomes one ladder (cold
    chain first), adapted every ``cfg.tune_interval`` sweeps during
    tuning.  Returns ``(step_fn, state)`` for
    :func:`dynetlsm_tpu_torch.mcmc.driver.make_scan_runner`."""
    if n_temps is None or int(n_temps) <= 1:
        return sweep, state
    # imported here: mcmc.sweeps imports this module's validate_network
    from ..mcmc.tempering import make_pt_step, temper_ladder
    betas = temper_ladder(int(n_temps), float(beta_min), n_ladders=n_chains,
                          device=state.X.device)
    state = state.replace(temper=betas, acc_swap=torch.zeros_like(betas))
    step = make_pt_step(sweep, cfg, sweep.Y, int(n_temps),
                        swap_every=int(swap_every),
                        adapt_until=int(cfg.tune or 0),
                        adapt_interval=int(cfg.tune_interval))
    return step, state


def fit_mesh(est, n_nodes, device):
    """Resolve and set ``est.mesh_`` (:func:`resolve_fit_mesh` with the
    estimator's keywords, the mesh's device type that of ``device``)."""
    est.mesh_ = resolve_fit_mesh(
        est.n_chains, n_nodes, est.node_devices, est.devices,
        est.latent_update, n_temps=est.n_temps, device_type=device.type)
    return est.mesh_


def sample_chains(est, make_sweep, cfg, s0, trace_fn, rng, device, timer,
                  thin=1):
    """The sampling stage of a fit: replicate the start ``s0`` over the
    estimator's chain slots on ``device``, attach the tempering ladders,
    record ``(n_total - 1) // thin`` samples of the cold slots
    (``trace_fn``), timed as ``'sampling'``, checkpointed to
    ``est.checkpoint_dir`` when set (only this stage resumes: the stages
    before it replay from the fit's ``random_state``).
    ``make_sweep(node_devices, node_seed)`` builds the sweep on
    ``node_devices[0]``, its network split over them when there are
    several.  On the estimator's mesh ``est.mesh_`` each chain row gets
    its sweep, its share of the slots (whole ladders) and its generator
    (``mcmc.driver``), and ``est.state_sharding_`` its layout.  Sets
    ``est.temper_ladder_`` and ``est._final_state`` (the cold slots'
    fields as NumPy arrays).  Returns (the traces in the reference layout,
    n_total)."""
    from ..mcmc.driver import (
        collect_traces, make_scan_runner, replicate_state, shard_state,
        state_sharding)
    from ..mcmc.states import state_to_numpy
    from ..mcmc.tempering import cold_slot_trace_fn, strip_hot_slots
    n_slots = est.n_chains * max(1, int(est.n_temps or 1))
    mesh = est.mesh_
    trace = cold_slot_trace_fn(trace_fn, est.n_temps)
    if mesh is None:
        gen = chain_generator(rng, device)
        state = replicate_state(s0, n_slots, device)
        step_fn, state = setup_tempering(
            make_sweep([device], 0), cfg, est.n_chains, est.n_temps,
            est.beta_min, est.swap_every, state)
    else:
        gen, node_seeds = row_generators(rng, mesh)
        rows = shard_state(replicate_state(s0, n_slots, 'cpu'), mesh)
        step_fn, state = [], []
        for devs, row, seed in zip(mesh.rows, rows, node_seeds):
            step, row = setup_tempering(
                make_sweep(devs, seed), cfg, est.n_chains // len(rows),
                est.n_temps, est.beta_min, est.swap_every, row)
            step_fn.append(step)
            state.append(row)
    runner = make_scan_runner(step_fn, trace, chunk=est.trace_chunk,
                              thin=thin)
    n_total = total_iterations(est.n_iter, est.tune, est.burn)
    with timer('sampling'):
        state, traces = collect_traces(
            runner, state, gen, (n_total - 1) // thin,
            chunk=est.trace_chunk, progress=progress_reporter(est.verbose),
            checkpoint_dir=est.checkpoint_dir)
    est.state_sharding_ = state_sharding(mesh, state)
    if mesh is not None:
        ladders = [strip_hot_slots(row, est.n_temps) for row in state]
        state = [row for row, _ in ladders]
        est.temper_ladder_ = (None if ladders[0][1] is None else
                              np.concatenate([lad for _, lad in ladders]))
    else:
        state, est.temper_ladder_ = strip_hot_slots(state, est.n_temps)
    est._final_state = types.SimpleNamespace(**state_to_numpy(state))
    return chain_traces_to_numpy(traces, est.n_chains), n_total


def chain_traces_to_numpy(traces, n_chains):
    """Reorder traces from (samples, chains, ...) to reference layout.

    Single chain -> (samples, ...) exactly like the reference's trace
    attributes; multiple chains -> (chains, samples, ...).
    """
    out = {}
    for name, arr in traces.items():
        arr = np.asarray(arr)
        if n_chains == 1:
            out[name] = arr[:, 0]
        else:
            out[name] = np.swapaxes(arr, 0, 1)
    return out


def with_init(tr, name, init_val, n_chains, dtype=np.float64):
    """The trace ``tr[name]`` (reference layout) with the initial value as
    sample 0."""
    arr = tr[name].astype(dtype, copy=False)
    init_val = np.asarray(init_val, dtype)
    if n_chains == 1:
        return np.concatenate([init_val[None], arr])
    return np.concatenate(
        [np.broadcast_to(init_val, (n_chains, 1) + init_val.shape), arr],
        axis=1)


def total_iterations(n_iter, tune, burn):
    """Total stored samples = n_iter + tune + burn (reference semantics:
    lsm.py:362-368 folds tune/burn into n_iter)."""
    total = n_iter
    if tune:
        total += tune
    if burn:
        total += burn
    return total


def progress_reporter(verbose):
    """Chunk-level progress reporter (replaces the reference's tqdm bars,
    lsm.py:474 / hdp_lpcm.py:823), or None."""
    if not verbose:
        return None
    start = time.time()

    def report(done, total):
        rate = done / max(time.time() - start, 1e-9)
        sys.stderr.write('\r[dynetlsm_tpu_torch] %d/%d samples (%.1f/s)'
                         % (done, total, rate))
        sys.stderr.flush()
        if done >= total:
            sys.stderr.write('\n')
    return report


class StageTimer:
    """Wall seconds of a fit's stages, in order, in ``seconds``; ``with
    timer('name'):`` times one, waiting for the device at its end so its
    queued work counts where it was issued."""

    def __init__(self, device):
        self.device = device
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        yield
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - t0)
