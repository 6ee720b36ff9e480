"""Node sharding (``node_devices=``, a ``('chains', 'nodes')`` mesh) of the
port on the CPU, its node shards on ``['cpu'] * k``.

* the row-range plain versions of the two log-likelihood kernels cover
  every dyad once: their shares add to the whole network (rtol 1e-6),
  undirected and directed, one network or one a chain, 1 to 3 candidates;
* a node-sharded 'parallel' and 'mala' latent step (and the 'parallel'
  case-control step) equals the unsharded one on the same state and
  generator state (X rtol 1e-5, the same accepts), and so do two whole
  HDP-LPCM sweeps; the row-split missing-dyad resample keeps the network
  symmetric, and the packed rows equal the whole network's;
* the counterparts of ``tests/test_spatial_sharding.py``: the mesh shapes
  and errors, the LSM, HDP, case-control, directed and missing-dyad fits
  with its assertions, the required-'parallel' and tempering errors, the
  evaluations, and a checkpoint resumed bit for bit.
"""
import numpy as np
import pytest
import torch

from dynetlsm_tpu.mcmc.driver import spatial_auto_mesh as jax_spatial_auto

from dynetlsm_tpu_torch import (
    DynamicNetworkHDPLPCM, DynamicNetworkLSM, checkpoint as ckpt)
from dynetlsm_tpu_torch.datasets import simple_splitting_dynamic_network
from dynetlsm_tpu_torch.entry import build_state_and_sweep
from dynetlsm_tpu_torch.mcmc import driver as drv
from dynetlsm_tpu_torch.mcmc.driver import spatial_auto_mesh, spatial_mesh
from dynetlsm_tpu_torch.mcmc.latent import sample_latent_positions
from dynetlsm_tpu_torch.mcmc.nodes import (
    build_cc_shards, missing_dyad_step, shard_cc_static, sharded_missing)
from dynetlsm_tpu_torch.mcmc.sweeps import SweepConfig, build_cc_dict
from dynetlsm_tpu_torch.models.base import case_control_static
from dynetlsm_tpu_torch.ops.case_control import build_edge_lists
from dynetlsm_tpu_torch.ops.dir_loglik import (
    dir_loglik, dir_loglik_plain, dir_loglik_rows_plain)
from dynetlsm_tpu_torch.ops.node_scan import pack_directed
from dynetlsm_tpu_torch.ops.pair_loglik import (
    pair_loglik, pair_loglik_plain, pair_loglik_rows_plain)
from dynetlsm_tpu_torch.ops.shards import RowShards, pack_rows

CPU8 = ['cpu'] * 8
COLLECT = drv.collect_traces


@pytest.fixture(scope='module')
def network():
    Y, _ = simple_splitting_dynamic_network(n_nodes=24, n_time_steps=2,
                                            random_state=7)
    return Y


def _random_network(rng, C, T, n, directed, per_chain):
    shape = (C, T, n, n) if per_chain else (T, n, n)
    Y = rng.binomial(1, 0.25, shape)
    if directed:
        Y[..., np.arange(n), np.arange(n)] = 0
    else:
        Y = np.triu(Y, 1)
        Y = Y + np.swapaxes(Y, -1, -2)
    Y = torch.as_tensor(Y.astype(np.uint8))
    return pack_directed(Y) if directed else Y


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# (directed, candidates)
ROW_CASES = [(False, 1), (False, 2), (True, 1), (True, 2), (True, 3)]


@pytest.mark.parametrize('per_chain', [False, True])
@pytest.mark.parametrize('directed, n_cand', ROW_CASES)
def test_row_range_plain_sums_to_the_whole(directed, n_cand, per_chain):
    """The shares of the rows [a, b) of 2, 3 and 5 shards (offsets off the
    tile and off 4) add to the whole network's log-likelihood (rtol
    1e-6); a share is float64, the whole-network plain version float32;
    the dispatcher scores a RowShards network as that sum."""
    rng = np.random.RandomState(11 + 3 * n_cand + directed + 7 * per_chain)
    C, T, n, d = 3, 2, 45, 2
    Y = _random_network(rng, C, T, n, directed, per_chain)
    X = _f32(rng.randn(C, T, n, d))
    if directed:
        b = 0.3 + 0.5 * rng.randn(C, n_cand, 2)
        args = (_f32(0.5 + rng.rand(C, n_cand, n)), _f32(b))
        whole, rows, dispatch = (dir_loglik_plain, dir_loglik_rows_plain,
                                 dir_loglik)
    else:
        args = tuple(_f32(rng.randn(C)) for _ in range(n_cand))
        whole, rows, dispatch = (pair_loglik_plain, pair_loglik_rows_plain,
                                 pair_loglik)
    want = whole(Y, X, *args)
    for cuts in ([0, 22, 45], [0, 13, 31, 45], [0, 9, 18, 27, 36, 45]):
        total = sum(rows(Y[..., a:b, :], X, *args, row0=a)
                    for a, b in zip(cuts[:-1], cuts[1:]))
        assert total.dtype == torch.float64
        torch.testing.assert_close(total.float(), want, rtol=1e-6, atol=0.0)
        shards = RowShards.split(Y, ['cpu'] * (len(cuts) - 1), cuts)
        assert torch.equal(dispatch(shards, X, *args), total.float())


def _latent_problem(seed, directed, C=3, T=3, n=24, d=2, K=3):
    rng = np.random.RandomState(seed)
    Y = _random_network(rng, C, T, n, directed, False)
    kw = dict(
        X=_f32(rng.randn(C, T, n, d)),
        intercept=_f32(rng.randn(C, 2 if directed else 1) * 0.5 + 1.0),
        # chains of small to large steps: accepts and rejects
        step_size=_f32((0.05 + 0.1 * rng.rand(C, T, n))
                       * np.geomspace(0.2, 5.0, C)[:, None, None]),
        mu=_f32(rng.randn(C, K, d)), sigma=_f32(0.5 + rng.rand(C, K)),
        lmbda=_f32(0.8 + 0.1 * rng.rand(C)),
        z=torch.as_tensor(rng.randint(0, K, (C, T, n))),
        radii=_f32(0.5 + rng.rand(C, n)) if directed else None,
        is_directed=directed)
    return Y, kw


@pytest.mark.parametrize('directed', [False, True])
@pytest.mark.parametrize('scheme', ['parallel', 'mala'])
def test_node_sharded_latent_step_equals_unsharded(scheme, directed):
    """One 'parallel' / 'mala' step on 2 and 3 node shards against the
    unsharded step from the same state and generator state: X within
    rtol 1e-5 and the same accepts (the shards' sums differ in order
    only)."""
    Y, kw = _latent_problem(5 + directed, directed)
    if scheme == 'mala':
        # one accept a chain: steps 3x larger, so that a chain rejects
        kw['step_size'] = 3.0 * kw['step_size']
    ref = sample_latent_positions(torch.Generator().manual_seed(3), Y,
                                  scheme=scheme, **kw)
    for k in (2, 3):
        got = sample_latent_positions(
            torch.Generator().manual_seed(3), RowShards.split(Y, ['cpu'] * k),
            scheme=scheme, **kw)
        torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
        assert torch.equal(got[1], ref[1])
        assert 0 < float(ref[1].mean()) < 1


def _cc_pair(Y, directed, devices, seed=3, m=6):
    """(the unsharded cc structures, the node-sharded ones) of a 0/1
    network Y (T, n, n), the same control draw."""
    cfg = SweepConfig(is_directed=directed, n_control=m)
    lists = build_edge_lists(Y.numpy())
    cc_static, ctrl = case_control_static(cfg, lists, Y.shape[-1], 'cpu',
                                          seed, seed + 1)
    whole = build_cc_dict(cfg, None, cc_static, *ctrl)
    sharded = build_cc_shards(cfg, None, shard_cc_static(
        cc_static, torch.device('cpu'), devices), *ctrl)
    return whole, sharded


@pytest.mark.parametrize('directed', [False, True])
def test_node_sharded_case_control_step_equals_unsharded(directed):
    """The 'parallel' update under case-control with row-split edge lists
    and shared controls equals the unsharded one; so does the
    case-control network log-likelihood (the shards' float64 shares)."""
    from dynetlsm_tpu_torch.ops.case_control import cc_network_loglik
    Y, kw = _latent_problem(9 + directed, directed)
    Y01 = (Y & 1) if directed else Y
    whole, sharded = _cc_pair(Y01, directed, ['cpu'] * 3)
    ref = sample_latent_positions(torch.Generator().manual_seed(4), None,
                                  scheme='parallel', cc=whole, **kw)
    got = sample_latent_positions(torch.Generator().manual_seed(4), None,
                                  scheme='parallel', cc=sharded, **kw)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], ref[1])
    args = (kw['X'], kw['intercept'], kw['radii'])
    torch.testing.assert_close(
        cc_network_loglik(*args, sharded, directed),
        cc_network_loglik(*args, whole, directed), rtol=1e-6, atol=0.0)


@pytest.mark.parametrize('scheme', ['parallel', 'mala'])
def test_node_sharded_sweeps_equal_unsharded(network, scheme):
    """Two HDP-LPCM sweeps on 4 node shards against the unsharded sweeps
    from the same state and generator: the positions within rtol 1e-5, the
    same accepts and labels, the log joint within rtol 1e-5."""
    def run(node_devices):
        state, sweep, gen = build_state_and_sweep(
            network, 4, K=4, device='cpu', latent_update=scheme,
            node_devices=node_devices)
        for _ in range(2):
            state = sweep(state, gen)
        return state, sweep
    ref, _ = run(None)
    got, sweep = run(['cpu'] * 4)
    assert isinstance(sweep.Y, RowShards) and len(sweep.Y.parts) == 4
    torch.testing.assert_close(got.X, ref.X, rtol=1e-5, atol=1e-6)
    assert torch.equal(got.acc_X, ref.acc_X)
    assert torch.equal(got.acc_int, ref.acc_int)
    assert torch.equal(got.z, ref.z)
    torch.testing.assert_close(got.logp, ref.logp, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize('directed', [False, True])
def test_row_split_missing_resample(directed):
    """The row-split resample draws only the missing dyads, each once: the
    gathered network keeps its observed dyads and zero diagonal, stays
    symmetric when undirected (mirrors sent to the other row's shard),
    and ``missing_sum`` holds the draws after burn-in; the packed rows
    equal the whole network's packing."""
    rng = np.random.RandomState(21 + directed)
    C, T, n = 2, 2, 21
    Y = _random_network(rng, C, T, n, False, True) if not directed else \
        torch.as_tensor(rng.binomial(1, 0.3, (C, T, n, n)).astype(np.uint8))
    Y[..., np.arange(n), np.arange(n)] = 0
    miss = rng.rand(T, n, n) < 0.2
    if not directed:
        miss = np.triu(miss, 1)
        miss |= np.swapaxes(miss, 1, 2)
    cfg = SweepConfig(is_directed=directed, sample_missing=True, n_burn=0)
    devices = ['cpu'] * 3
    sm = sharded_missing(miss, directed, devices)
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    X = _f32(rng.randn(C, T, n, 2))
    b = _f32(rng.randn(C, 2 if directed else 1))
    radii = _f32(0.5 + rng.rand(C, n)) if directed else None
    Ys = RowShards.split(Y, devices)
    ms = RowShards.split(torch.zeros((C, T, n, n)), devices)
    Y2, ms2 = missing_dyad_step(cfg, sm, gens, Ys, ms, X, b, radii,
                                torch.ones(C, dtype=torch.int64))
    new, total = Y2.gather('cpu'), ms2.gather('cpu')
    mask = torch.as_tensor(miss)
    mask[:, np.arange(n), np.arange(n)] = False
    assert torch.equal(new[:, ~mask], Y[:, ~mask])
    assert torch.equal(total, new.float() * mask)
    assert not torch.equal(new, Y)
    if not directed:
        assert torch.equal(new, new.transpose(-1, -2))
    assert torch.equal(pack_rows(Y2).gather('cpu'), pack_directed(new))


# ---------------------------------------------------------------------------
# the counterparts of tests/test_spatial_sharding.py
# ---------------------------------------------------------------------------


def test_spatial_mesh_shapes():
    """JAX test_spatial_mesh_shapes, and spatial_auto_mesh's shapes equal
    JAX's on the conftest's 8 devices."""
    mesh = spatial_mesh(2, 4, CPU8)
    assert mesh.axis_names == ('chains', 'nodes')
    assert mesh.devices.shape == (2, 4)
    mesh = spatial_auto_mesh(3, 24, 4, CPU8)
    assert mesh.devices.shape == (1, 4)
    for args in ((3, 24, 4), (2, 24, 4), (4, 24, 2), (8, 24, 1), (6, 24, 8)):
        assert (spatial_auto_mesh(*args, CPU8).devices.shape
                == jax_spatial_auto(*args).devices.shape), args
    with pytest.raises(ValueError, match='divide'):
        spatial_auto_mesh(2, 25, 4, CPU8)
    with pytest.raises(ValueError, match='needs 8 devices, have 4'):
        spatial_mesh(2, 4, ['cpu'] * 4)


def _fit(cls, Y, **kw):
    base = dict(n_chains=2, node_devices=4, latent_update='parallel',
                random_state=5, device='cpu', devices=CPU8)
    base.update(kw)
    return cls(**base).fit(Y)


@pytest.mark.parametrize('kind', ['lsm', 'case-control', 'directed',
                                  'missing dyads', 'hdp'])
def test_spatial_fits(network, kind):
    """JAX's test_lsm_spatial_fit, test_case_control_spatial_fit,
    test_directed_spatial_fit, test_missing_dyads_spatial_fit and
    test_hdp_spatial_fit: a (2, 4) mesh, finite log joints (after the
    initial sample for the HDP) and JAX's AUC floors; the network's rows
    are split over 'nodes'."""
    budget = dict(n_iter=30, tune=30, burn=30)
    if kind == 'lsm':
        m = _fit(DynamicNetworkLSM, network, n_iter=40, tune=40, burn=40)
    elif kind == 'case-control':
        m = _fit(DynamicNetworkLSM, network, n_control=8, **budget)
    elif kind == 'directed':
        rng = np.random.RandomState(0)
        Y = (rng.rand(2, 24, 24) < 0.2).astype(float)
        for t in range(2):
            np.fill_diagonal(Y[t], 0)
        m = _fit(DynamicNetworkLSM, Y, is_directed=True, **budget)
    elif kind == 'missing dyads':
        Y = np.array(network, dtype=float)
        rng = np.random.RandomState(1)
        miss = rng.rand(*Y.shape) < 0.05
        miss = np.triu(miss, 1) | np.swapaxes(np.triu(miss, 1), 1, 2)
        Y[miss] = np.nan
        m = _fit(DynamicNetworkLSM, Y, **budget)
        assert m.state_sharding_.specs['Y'] == ('chains', None, 'nodes',
                                                None)
        assert m.missings_.shape == Y.shape
    else:
        m = _fit(DynamicNetworkHDPLPCM, network, n_iter=40, tune=40,
                 burn=40, n_components=5)
    assert m.mesh_.devices.shape == (2, 4)
    assert m.mesh_.axis_names == ('chains', 'nodes')
    assert m.state_sharding_.spec == ('chains', None, None, None)
    assert m.state_sharding_.specs['network'] == (None, 'nodes', None)
    logps = np.asarray(m.logps_)
    assert np.isfinite(logps[:, 1:] if kind == 'hdp' else logps).all()
    assert m.auc_ > (0.55 if kind == 'directed' else 0.6)


def test_spatial_requires_parallel_update(network):
    with pytest.raises(ValueError, match='parallel'):
        DynamicNetworkLSM(n_iter=10, tune=0, burn=0, node_devices=4,
                          random_state=5, device='cpu',
                          devices=CPU8).fit(network)


def test_spatial_refuses_tempering_and_uneven_shards(network):
    """JAX's ValueErrors: tempering with node sharding, and node_devices
    not dividing n (24 nodes over 5)."""
    with pytest.raises(ValueError, match='n_temps > 1'):
        _fit(DynamicNetworkLSM, network, n_temps=2, n_iter=2, tune=0,
             burn=0)
    with pytest.raises(ValueError, match='must divide n_nodes=24'):
        _fit(DynamicNetworkLSM, network, node_devices=5, n_iter=2, tune=0,
             burn=0)


class Stop(Exception):
    pass


@pytest.mark.parametrize('missing', [False, True])
def test_spatial_checkpoint_resume(monkeypatch, tmp_path, network, missing):
    """JAX test_spatial_checkpoint_resume, held bit for bit: a node-sharded
    fit killed after chunk 2 resumes to its uninterrupted twin, its state
    laid out node-sharded again; with missing dyads the node shards'
    generators are saved and restored too."""
    Y = np.array(network, dtype=float)
    if missing:
        rng = np.random.RandomState(1)
        miss = np.triu(rng.rand(*Y.shape) < 0.05, 1)
        Y[miss | np.swapaxes(miss, 1, 2)] = np.nan
    kw = dict(n_iter=40, tune=30, burn=30, trace_chunk=25)
    full = _fit(DynamicNetworkLSM, Y, **kw)
    path = str(tmp_path / 'sp_ckpt')

    def arm(chunks):
        def failing(*args, progress=None, checkpoint_dir=None, **k):
            def count(done, total):
                if chunks and done >= chunks * k['chunk']:
                    raise Stop()
            return COLLECT(*args, progress=count,
                           checkpoint_dir=checkpoint_dir, **k)
        monkeypatch.setattr(drv, 'collect_traces', failing)
    arm(2)
    with pytest.raises(Stop):
        _fit(DynamicNetworkLSM, Y, checkpoint_dir=path, **kw)
    meta = ckpt.read_meta(path)
    assert meta['n_done'] == 50 and 'mesh:2x4' in meta['fingerprint']
    arm(0)
    resumed = _fit(DynamicNetworkLSM, Y, checkpoint_dir=path, **kw)
    assert resumed.state_sharding_.specs['X'] == ('chains', None, None, None)
    for name in ('Xs_', 'intercepts_', 'logps_', 'X_'):
        assert np.array_equal(getattr(resumed, name), getattr(full, name))
    if missing:
        assert np.array_equal(resumed.missings_, full.missings_)


def test_spatial_evaluations_match_replicated(network):
    """JAX test_spatial_evaluations_match_replicated: the network
    log-likelihood of row-split shards equals the whole network's (rtol
    1e-5), and one 'parallel' update draws the same proposals and
    accepts."""
    rng = np.random.RandomState(3)
    Y = torch.as_tensor(np.asarray(network, np.uint8))
    T, n, _ = Y.shape
    X = _f32(rng.randn(2, T, n, 2))
    b = _f32(np.ones(2))
    shards = RowShards.split(Y, ['cpu'] * 4)
    torch.testing.assert_close(pair_loglik(shards, X, b),
                               pair_loglik(Y, X, b), rtol=1e-5, atol=0.0)
    step = _f32(np.full((2, T, n), 0.1))
    kw = dict(mu=_f32(rng.randn(2, 5, 2)), sigma=torch.ones(2, 5),
              lmbda=_f32([0.9, 0.9]),
              z=torch.as_tensor(rng.randint(0, 5, (2, T, n))),
              scheme='parallel')
    ref = sample_latent_positions(torch.Generator().manual_seed(42), Y, X,
                                  b[:, None], step, **kw)
    got = sample_latent_positions(torch.Generator().manual_seed(42),
                                  shards, X, b[:, None], step, **kw)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], ref[1])
