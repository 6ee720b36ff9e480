"""The port's ``chains`` mesh (``devices=``) on the CPU: the shards go on
``['cpu'] * k``, a repeated device that checks the machinery.

* ``auto_mesh`` picks JAX's subset on the conftest's 8 virtual devices;
* every chain shard of a fit, HDP-LPCM and tempered LSM, equals the
  unsharded runner on that shard's chains with that shard's generator, bit
  for bit;
* the counterparts of ``tests/test_mesh_sharding.py``'s fits, a chains
  mesh checkpoint resumed bit for bit (and started fresh on another
  mesh), and ``entry.dryrun_multichip``.
"""
import numpy as np
import pytest
import torch

import jax
from dynetlsm_tpu.mcmc.driver import auto_mesh as jax_auto_mesh

from dynetlsm_tpu_torch import (
    DynamicNetworkHDPLPCM, DynamicNetworkLSM, checkpoint as ckpt)
from dynetlsm_tpu_torch.datasets import simple_splitting_dynamic_network
from dynetlsm_tpu_torch.entry import dryrun_multichip
from dynetlsm_tpu_torch.mcmc import driver as drv
from dynetlsm_tpu_torch.mcmc.driver import (
    Mesh, all_devices, auto_mesh, chain_mesh, shard_state)
from dynetlsm_tpu_torch.mcmc.states import gather_state
from dynetlsm_tpu_torch.models import mixture_base

CPU8 = ['cpu'] * 8
COLLECT = drv.collect_traces


@pytest.fixture(scope='module')
def network():
    Y, _ = simple_splitting_dynamic_network(n_nodes=16, n_time_steps=2,
                                            random_state=7)
    return Y


@pytest.fixture
def short_nested_lsm(monkeypatch):
    """The mixture models' nested LSM cut to 20 + 10 + 10 sweeps."""
    init = mixture_base.init_from_lsm

    def short(*args, **kw):
        kw['lsm_kwargs'] = dict(n_iter=20, tune=10, burn=10)
        return init(*args, **kw)
    monkeypatch.setattr(mixture_base, 'init_from_lsm', short)


@pytest.mark.parametrize('n_chains', [8, 16, 4, 6, 12, 1, 7, 5])
def test_auto_mesh_picks_jax_subsets(n_chains):
    """The largest subset of 8 devices that divides the chains, or None
    (JAX test_auto_mesh_subsets on the conftest's 8 virtual devices)."""
    assert len(jax.devices()) == 8
    want = jax_auto_mesh(n_chains)
    got = auto_mesh(n_chains, CPU8)
    if want is None:
        assert got is None
        return
    assert got.devices.shape == want.devices.shape
    assert got.axis_names == want.axis_names == ('chains',)
    assert dict(got.shape) == dict(want.shape)


def test_meshes_take_names_and_default_devices():
    """Devices by name or torch.device, repeats kept; None: every device
    of the type (the one CPU); a mesh is a NumPy object array of
    torch.device."""
    mesh = chain_mesh(['cpu', torch.device('cpu')])
    assert isinstance(mesh, Mesh) and mesh.devices.dtype == object
    assert list(mesh.devices) == [torch.device('cpu')] * 2
    assert mesh.rows == [[torch.device('cpu')], [torch.device('cpu')]]
    assert all_devices('cpu') == [torch.device('cpu')]
    assert auto_mesh(4, device_type='cpu') is None
    assert chain_mesh(device_type='cpu').devices.size == 1


def _capture_rows(monkeypatch):
    """Wrap the driver's runner factory and ``collect_traces``: record the
    mesh's sweeps and trace function, the rows' states and generator
    states before sampling, and the traces (a nested LSM's single-device
    sampling passes through)."""
    make, collect = drv.make_scan_runner, drv.collect_traces
    seen = {'make': make, 'collect': collect}

    def make_spy(sweep_fn, trace_fn, **kw):
        if isinstance(sweep_fn, list):      # not a nested LSM's runner
            seen.update(sweeps=sweep_fn, trace=trace_fn, kw=kw)
        return make(sweep_fn, trace_fn, **kw)

    def collect_spy(runner, state, gen, n, **kw):
        if not isinstance(state, list):
            return collect(runner, state, gen, n, **kw)
        seen['states'] = [s.replace() for s in state]
        seen['gens'] = [g.get_state() for g in gen]
        seen['n'] = n
        out = collect(runner, state, gen, n, **kw)
        seen['traces'] = out[1]
        return out
    monkeypatch.setattr(drv, 'make_scan_runner', make_spy)
    monkeypatch.setattr(drv, 'collect_traces', collect_spy)
    return seen


def _replay_rows(seen):
    """Each row alone: the unsharded runner over the row's chains with the
    row's sweep and a generator in the row's generator's state, held
    equal to the row's share of the mesh's traces bit for bit."""
    c0 = 0
    for sweep, state, g_state in zip(seen['sweeps'], seen['states'],
                                     seen['gens']):
        gen = torch.Generator(device=state.X.device)
        gen.set_state(g_state)
        runner = seen['make'](sweep, seen['trace'], **seen['kw'])
        _, alone = seen['collect'](runner, state, gen, seen['n'],
                                   chunk=seen['kw']['chunk'])
        C = next(iter(alone.values())).shape[1]
        for k, v in alone.items():
            assert np.array_equal(seen['traces'][k][:, c0:c0 + C], v), k
        c0 += C
    assert c0 == next(iter(seen['traces'].values())).shape[1]


@pytest.mark.parametrize('model', ['hdp', 'lsm tempered'])
def test_chain_shards_equal_the_unsharded_runner(monkeypatch, network,
                                                 short_nested_lsm, model):
    """A fit on ``devices=['cpu'] * 2``: every shard's chains are, bit for
    bit, the chains the unsharded runner gives with that shard's
    generator; tempered, each shard holds whole ladders (4 ladders of 2
    rungs, 2 a shard)."""
    seen = _capture_rows(monkeypatch)
    if model == 'hdp':
        m = DynamicNetworkHDPLPCM(n_iter=8, tune=4, burn=4, n_components=3,
                                  n_chains=4, random_state=3,
                                  trace_chunk=7, device='cpu',
                                  devices=['cpu', 'cpu']).fit(network)
    else:
        m = DynamicNetworkLSM(n_iter=8, tune=4, burn=4, n_chains=4,
                              n_temps=2, random_state=3, trace_chunk=7,
                              device='cpu', devices=['cpu', 'cpu']).fit(
                                  network)
        assert all(s.temper.shape == (4,) for s in seen['states'])
        assert m.temper_ladder_.shape == (8,)
    assert dict(m.mesh_.shape) == {'chains': 2}
    assert len(seen['sweeps']) == 2
    assert np.isfinite(m.logps_).all()
    _replay_rows(seen)


def test_shard_state_round_trip(network):
    """shard_state cuts the chains in order onto the rows' devices;
    gather_state joins them back."""
    from dynetlsm_tpu_torch.entry import build_state_and_sweep
    state, _, _ = build_state_and_sweep(network, 6, K=3, device='cpu')
    rows = shard_state(state, chain_mesh(['cpu'] * 3))
    assert [r.X.shape[0] for r in rows] == [2, 2, 2]
    back = gather_state(rows)
    for f in ('X', 'z', 'mu', 'logp', 'weights'):
        assert torch.equal(getattr(back, f), getattr(state, f)), f
    with pytest.raises(ValueError, match='do not split'):
        shard_state(state, chain_mesh(['cpu'] * 4))


def test_lsm_fit_is_mesh_sharded(network):
    """JAX test_lsm_fit_is_mesh_sharded: 8 chains on 8 devices (a third of
    its budget)."""
    m = DynamicNetworkLSM(n_iter=10, tune=10, burn=10, n_chains=8,
                          random_state=5, device='cpu', devices=CPU8).fit(
                              network)
    assert m.mesh_ is not None and m.mesh_.devices.size == 8
    assert m.state_sharding_.spec == ('chains', None, None, None)
    assert m.state_sharding_.mesh is m.mesh_
    assert m.Xs_.shape == (8, 30, 2, 16, 2)
    assert np.isfinite(m.logps_).all()


def test_lsm_fit_device_subset_mesh(network):
    """JAX test_lsm_fit_device_subset_mesh: 4 chains on 8 devices use 4
    (half its budget)."""
    m = DynamicNetworkLSM(n_iter=10, tune=10, burn=10, n_chains=4,
                          random_state=5, device='cpu', devices=CPU8).fit(
                              network)
    assert m.mesh_.devices.size == 4
    assert np.isfinite(m.logps_).all()


def test_multichain_hdp_diagnostics(network, short_nested_lsm):
    """JAX test_multichain_hdp_diagnostics on a 4-device chains mesh (a
    third of its budget)."""
    m = DynamicNetworkHDPLPCM(n_iter=20, tune=10, burn=10, n_chains=4,
                              n_components=4, random_state=5, device='cpu',
                              devices=CPU8).fit(network)
    assert m.mesh_.devices.size == 4
    z, p = m.logp_geweke_
    assert np.isfinite(z) and 0.0 <= p <= 1.0
    assert np.isfinite(m.logp_rhat_) and m.logp_rhat_ >= 1.0
    assert m.logp_effective_n_ > 0.0


class Stop(Exception):
    pass


def _stop_after(monkeypatch, chunks):
    """The fits' sampling raises Stop once ``chunks`` chunks are
    checkpointed (0: never)."""
    def failing(*args, progress=None, checkpoint_dir=None, **kw):
        def count(done, total):
            if done >= chunks * kw['chunk']:
                raise Stop()
        return COLLECT(*args, checkpoint_dir=checkpoint_dir,
                       progress=count if chunks else progress, **kw)
    monkeypatch.setattr(drv, 'collect_traces', failing)


def test_chain_mesh_checkpoint_resume(monkeypatch, tmp_path, network):
    """A chains-mesh fit killed after chunk 2 resumes to the uninterrupted
    fit bit for bit; resuming on another mesh starts fresh (the
    fingerprint names the layout)."""
    kw = dict(n_iter=20, tune=10, burn=10, n_chains=4, random_state=5,
              trace_chunk=6, device='cpu')
    full = DynamicNetworkLSM(devices=['cpu'] * 2, **kw).fit(network)
    path = str(tmp_path / 'ck')
    _stop_after(monkeypatch, 2)
    with pytest.raises(Stop):
        DynamicNetworkLSM(devices=['cpu'] * 2, checkpoint_dir=path,
                          **kw).fit(network)
    meta = ckpt.read_meta(path)
    assert meta['n_done'] == 12 and 'mesh:2x1' in meta['fingerprint']
    _stop_after(monkeypatch, 0)
    resumed = DynamicNetworkLSM(devices=['cpu'] * 2, checkpoint_dir=path,
                                **kw).fit(network)
    for name in ('Xs_', 'intercepts_', 'logps_', 'X_'):
        assert np.array_equal(getattr(resumed, name), getattr(full, name))
    other = DynamicNetworkLSM(devices=['cpu'] * 4, checkpoint_dir=path,
                              **kw).fit(network)
    assert 'mesh:4x1' in ckpt.read_meta(path)['fingerprint']
    assert np.isfinite(other.logps_).all()


@pytest.mark.parametrize('n_devices', [1, 2, 8])
def test_dryrun_multichip_on_cpu(n_devices):
    """entry.dryrun_multichip's assertions hold with the CPU repeated."""
    dryrun_multichip(n_devices, device='cpu')


def test_devices_of_another_type_raise(network):
    with pytest.raises(ValueError, match="runs on 'cpu' devices"):
        DynamicNetworkLSM(n_chains=2, device='cpu',
                          devices=['cpu', 'cuda:0']).fit(network)
