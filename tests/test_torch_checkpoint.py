"""Checkpoint/resume of the port's sampling stage
(``dynetlsm_tpu_torch/checkpoint.py``, ``mcmc/driver.py::collect_traces``),
the counterparts of the JAX package's ``tests/test_checkpoint.py`` on the
same data and budgets.  On the CPU an interrupted-and-resumed fit equals
the uninterrupted one bit for bit: the state, the ``torch.Generator``'s
state and the trace chunks are all that the sampling stage carries, and
every stage before it replays from ``random_state``.

Beyond the JAX tests: the same toy runner through JAX's and the port's
``collect_traces`` (same traces, same meta values), a generator of
another device type not resumed, case-control and missing-dyad fits, the
state round trip field by field, and the nested LSM of a mixture fit left
out of the checkpoint.
"""
import json
import os

import numpy as np
import pytest
import torch

from dynetlsm_tpu_torch import (
    DynamicNetworkHDPLPCM, DynamicNetworkLPCM, DynamicNetworkLSM)
from dynetlsm_tpu_torch import checkpoint as ckpt
from dynetlsm_tpu_torch.datasets import (
    simple_splitting_dynamic_network, with_missing_dyads)
from dynetlsm_tpu_torch.mcmc import driver as drv
from dynetlsm_tpu_torch.mcmc.states import LSMState, state_from_numpy

LSM_KW = dict(n_iter=40, tune=30, burn=30, random_state=5, trace_chunk=25,
              device='cpu')


class Stop(Exception):
    pass


@pytest.fixture(scope='module')
def network():
    Y, _ = simple_splitting_dynamic_network(n_nodes=16, n_time_steps=2,
                                            random_state=7)
    return Y


@pytest.fixture
def interrupt(monkeypatch):
    """``interrupt(after)``: the next checkpointed ``collect_traces`` raises
    ``Stop`` from its progress report after ``after`` chunks; a
    ``collect_traces`` without a checkpoint runs as it is."""
    orig = drv.collect_traces

    def arm(after):
        calls = {'chunks': 0}

        def failing(*args, checkpoint_dir=None, progress=None, **kw):
            def counting(done, total):
                calls['chunks'] += 1
                if calls['chunks'] == after:
                    raise Stop()
            return orig(*args, checkpoint_dir=checkpoint_dir,
                        progress=counting if checkpoint_dir else progress,
                        **kw)
        monkeypatch.setattr(drv, 'collect_traces', failing)
    yield arm
    monkeypatch.setattr(drv, 'collect_traces', orig)


@pytest.fixture
def short_nested_lsm(monkeypatch):
    """The mixture models' nested LSM cut to 20 + 10 + 10 sweeps (it is
    not checkpointed; only the sampling stage after it is)."""
    from dynetlsm_tpu_torch.models import mixture_base
    init = mixture_base.init_from_lsm

    def short(*args, **kw):
        kw['lsm_kwargs'] = dict(n_iter=20, tune=10, burn=10)
        return init(*args, **kw)
    monkeypatch.setattr(mixture_base, 'init_from_lsm', short)


@pytest.fixture
def first_progress(monkeypatch):
    """Records the samples done at each checkpointed chunk's report: a
    resumed run's first report is past its first chunk."""
    orig = drv.collect_traces
    seen = []

    def spy(*args, checkpoint_dir=None, progress=None, **kw):
        return orig(*args, checkpoint_dir=checkpoint_dir,
                    progress=(lambda done, total: seen.append(done))
                    if checkpoint_dir else progress, **kw)
    monkeypatch.setattr(drv, 'collect_traces', spy)
    return seen


def _assert_same_fit(a, b, names):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name


def _interrupted_then_resumed(cls, Y, kw, path, interrupt, after=2):
    interrupt(after)
    with pytest.raises(Stop):
        cls(checkpoint_dir=path, **kw).fit(Y)
    meta = ckpt.read_meta(path)
    assert meta['n_done'] == after * kw['trace_chunk']
    interrupt(0)                 # never fires: the resume runs to its end
    return cls(checkpoint_dir=path, **kw).fit(Y)


def test_lsm_checkpoint_resume(tmp_path, network, interrupt):
    full = DynamicNetworkLSM(**LSM_KW).fit(network)
    resumed = _interrupted_then_resumed(DynamicNetworkLSM, network, LSM_KW,
                                        str(tmp_path / 'ckpt'), interrupt)
    _assert_same_fit(resumed, full, ('Xs_', 'intercepts_', 'logps_', 'X_',
                                     'probas_'))


def test_hdp_checkpoint_resume_runs(tmp_path, short_nested_lsm,
                                    first_progress):
    """A second fit over a completed checkpoint loads every chunk from
    disk and equals the first; the nested LSM's sampling is not
    checkpointed (the meta holds the mixture state's fingerprint)."""
    Y, _ = simple_splitting_dynamic_network(n_nodes=14, n_time_steps=2,
                                            random_state=3)
    path = str(tmp_path / 'hdp_ckpt')
    kw = dict(n_iter=30, tune=20, burn=20, n_components=4, random_state=9,
              trace_chunk=25, device='cpu', checkpoint_dir=path)
    m1 = DynamicNetworkHDPLPCM(**kw).fit(Y)
    assert first_progress == [25, 50, 69]
    meta = ckpt.read_meta(path)
    assert meta['n_done'] == meta['n_samples'] == 69
    assert '|z:' in meta['fingerprint'] and 'weights:' in meta['fingerprint']
    m2 = DynamicNetworkHDPLPCM(**kw).fit(Y)
    assert first_progress == [25, 50, 69]     # no chunk ran again
    assert m2.Xs_.shape == m1.Xs_.shape
    _assert_same_fit(m2, m1, ('Xs_', 'zs_', 'intercepts_', 'logps_',
                              'X_', 'z_'))


def _toy_state(value, n=2):
    """A one-chain LSM state whose ``it`` carries the toy runner's
    counter and whose ``X`` has ``n`` nodes (the fingerprint's shape)."""
    z = np.zeros((1, 1, n, 2), np.float32)
    s = np.zeros(1, np.float32)
    one = np.zeros((1, 1), np.float32)
    return state_from_numpy(dict(
        it=np.full(1, value), X=z, intercept=one, step_X=z[..., 0],
        acc_X=z[..., 0], step_int=one, acc_int=one, logp=s, logp_map=s,
        X_map=z, intercept_map=one, logp_ref=s, X_ref=z), 'cpu')


def _toy_runner(chunk):
    """JAX ``test_checkpoint.py``'s toy runner on a port state: chunk rows
    ``it + 1 + arange(chunk)``, zero past the ``n`` recorded, and ``it``
    advanced by ``n``."""
    def run(state, gen, n):
        vals = state.it[0] + 1 + torch.arange(chunk)
        vals = torch.where(torch.arange(chunk) < n, vals, 0)[:n]
        return state.replace(it=state.it + n), {'v': vals}
    run.chunk = chunk
    return run


def _stop_after(k):
    calls = {'n': 0}

    def progress(done, total):
        calls['n'] += 1
        if calls['n'] == k:
            raise RuntimeError('interrupt')
    return progress


def _gen():
    return torch.Generator().manual_seed(0)


def test_checkpoint_stale_chunks_not_spliced(tmp_path):
    """Reusing a checkpoint directory after a budget change must not
    splice the old run's chunk files into the new run's traces."""
    runner = _toy_runner(4)
    ck = str(tmp_path)
    _, tr = drv.collect_traces(runner, _toy_state(0), _gen(), 12, chunk=4,
                               checkpoint_dir=ck)
    assert list(tr['v']) == list(range(1, 13))
    with pytest.raises(RuntimeError):
        drv.collect_traces(runner, _toy_state(0), _gen(), 16, chunk=4,
                           checkpoint_dir=ck, progress=_stop_after(1))
    _, tr = drv.collect_traces(runner, _toy_state(0), _gen(), 16, chunk=4,
                               checkpoint_dir=ck)
    assert list(tr['v']) == list(range(1, 17))


def test_checkpoint_fingerprint_mismatch_restarts(tmp_path):
    """A resume against a different state structure starts fresh instead
    of loading incompatible fields."""
    runner = _toy_runner(4)
    ck = str(tmp_path)
    with pytest.raises(RuntimeError):
        drv.collect_traces(runner, _toy_state(0, n=2), _gen(), 8, chunk=4,
                           checkpoint_dir=ck, progress=_stop_after(1))
    seen = []
    state, tr = drv.collect_traces(
        runner, _toy_state(0, n=3), _gen(), 8, chunk=4, checkpoint_dir=ck,
        progress=lambda done, total: seen.append(done))
    assert seen == [4, 8]
    assert list(tr['v']) == list(range(1, 9))
    assert state.X.shape[2] == 3


def test_tempered_checkpoint_resume(tmp_path, network, interrupt):
    """Tempered fits keep the whole ladder state (``temper``,
    ``acc_swap``) in the checkpoint and resume bit for bit.  The run is
    stopped after its first chunk, 25 sweeps into a tuning stage of 30
    whose ladder adapts every 10 sweeps, so the resume adapts it once
    more."""
    kw = dict(LSM_KW, tune_interval=10, n_temps=3, beta_min=0.25)
    full = DynamicNetworkLSM(**kw).fit(network)
    resumed = _interrupted_then_resumed(DynamicNetworkLSM, network, kw,
                                        str(tmp_path / 'pt_ckpt'),
                                        interrupt, after=1)
    _assert_same_fit(resumed, full, ('Xs_', 'intercepts_', 'logps_',
                                     'temper_ladder_'))
    # the ladder did adapt: its inner rung moved off the geometric start
    assert not np.allclose(full.temper_ladder_[1],
                           np.geomspace(1.0, 0.25, 3)[1])


def test_collect_traces_matches_jax(tmp_path):
    """The toy runner through JAX's ``collect_traces`` and the port's, each
    interrupted after its second of four chunks and resumed: the same
    traces and the same meta values."""
    import jax.numpy as jnp
    from dynetlsm_tpu import checkpoint as jax_ckpt
    from dynetlsm_tpu.mcmc.driver import collect_traces as jax_collect

    def jax_runner(state, n):
        vals = state + 1 + jnp.arange(4)
        return state + n, {'v': jnp.where(jnp.arange(4) < n, vals, 0)}
    jax_runner.chunk = 4

    out = {}
    for name, run in (
            ('jax', lambda path, **kw: jax_collect(
                jax_runner, jnp.asarray(0), 14, chunk=4,
                checkpoint_dir=path, **kw)),
            ('port', lambda path, **kw: drv.collect_traces(
                _toy_runner(4), _toy_state(0), _gen(), 14, chunk=4,
                checkpoint_dir=path, **kw))):
        path = str(tmp_path / name)
        with pytest.raises(RuntimeError):
            run(path, progress=_stop_after(2))
        mid = (jax_ckpt if name == 'jax' else ckpt).read_meta(path)
        _, tr = run(path)
        end = ckpt.read_meta(path)
        out[name] = (np.asarray(tr['v']), mid, end)
    (v_j, mid_j, end_j), (v_p, mid_p, end_p) = out['jax'], out['port']
    np.testing.assert_array_equal(v_p, v_j)
    assert list(v_p) == list(range(1, 15))
    for key in ('n_done', 'n_samples', 'chunk'):
        assert mid_p[key] == mid_j[key] and end_p[key] == end_j[key], key
    assert (mid_p['n_done'], end_p['n_done']) == (8, 14)


def test_no_resume_from_another_device_type(tmp_path, network, interrupt):
    """A checkpoint written with a generator of another device type (its
    stream differs) is not resumed: with the saved fingerprint's
    generator field set to a CUDA generator's, the CPU fit starts fresh
    and still equals the uninterrupted fit."""
    path = str(tmp_path / 'ckpt')
    orig = drv.collect_traces
    interrupt(2)
    with pytest.raises(Stop):
        DynamicNetworkLSM(checkpoint_dir=path, **LSM_KW).fit(network)
    meta = ckpt.read_meta(path)
    assert meta['fingerprint'].endswith('generator:cpu:%d' % (
        torch.Generator().get_state().numel()))
    meta['fingerprint'] = meta['fingerprint'].rsplit('generator:', 1)[0] \
        + 'generator:cuda:16'
    ckpt.write_meta(path, meta)

    seen = []

    def spy(*args, checkpoint_dir=None, progress=None, **kw):
        return orig(*args, checkpoint_dir=checkpoint_dir,
                    progress=lambda done, total: seen.append(done), **kw)
    drv.collect_traces = spy
    try:
        fresh = DynamicNetworkLSM(checkpoint_dir=path, **LSM_KW).fit(network)
    finally:
        drv.collect_traces = orig
    assert seen == [25, 50, 75, 99]
    full = DynamicNetworkLSM(**LSM_KW).fit(network)
    _assert_same_fit(fresh, full, ('Xs_', 'logps_'))


@pytest.mark.parametrize('case', ['case-control', 'missing dyads'])
def test_case_control_and_missing_resume(tmp_path, network, interrupt,
                                         case):
    """The case-control state (the shared controls ``ctrl_out`` and the
    sweep count ``it``, from which the redraw cadence follows; redrawn
    every 10 sweeps here, across the interruption) and the missing-dyad
    state (each chain's ``Y`` and ``missing_sum``) resume bit for bit."""
    if case == 'case-control':
        Y, kw = network, dict(LSM_KW, n_control=8, n_resample_control=10,
                              n_chains=2)
        names = ('Xs_', 'intercepts_', 'logps_')
    else:
        Y = with_missing_dyads(network, 0.1, seed=3)
        kw = dict(LSM_KW, n_chains=2)
        names = ('Xs_', 'intercepts_', 'logps_', 'missings_')
    full = DynamicNetworkLSM(**kw).fit(Y)
    resumed = _interrupted_then_resumed(DynamicNetworkLSM, Y, kw,
                                        str(tmp_path / 'ckpt'), interrupt)
    _assert_same_fit(resumed, full, names)


def test_state_round_trip_is_bit_exact(tmp_path, network):
    """Every field of a tempered missing-dyad LSM state and of an LPCM
    state comes back with its dtype and bits; the generator too."""
    from dynetlsm_tpu_torch.entry import build_state_and_sweep
    Y = with_missing_dyads(network, 0.2, seed=1)
    states = [build_state_and_sweep(Y, 8, model='lsm', n_temps=2,
                                    device='cpu')[0],
              build_state_and_sweep(network, 4, K=3, model='lpcm',
                                    device='cpu')[0]]
    for i, state in enumerate(states):
        gen = torch.Generator().manual_seed(i)
        torch.rand(7, generator=gen)
        path = str(tmp_path / ('state%d.npz' % i))
        ckpt.save_state(path, state, gen)
        back, gen_state = ckpt.load_state(path, 'cpu')
        assert type(back) is type(state)
        for f in state.__dataclass_fields__:
            a, b = getattr(state, f), getattr(back, f)
            if a is None:
                assert b is None, f
                continue
            assert a.dtype == b.dtype and torch.equal(a, b), f
        assert torch.equal(gen_state, gen.get_state())
        assert ckpt.state_fingerprint(back, gen) == \
            ckpt.state_fingerprint(state, gen)
    with np.load(path, allow_pickle=False) as data:
        assert set(data.files) >= {'X', 'z', ckpt.GENERATOR}


def test_torn_meta_is_no_checkpoint(tmp_path):
    with open(os.path.join(tmp_path, 'meta.json'), 'w') as f:
        f.write('{"n_done": 4, "n_sa')
    assert ckpt.read_meta(str(tmp_path)) is None
    ckpt.write_meta(str(tmp_path), {'n_done': 1})
    with open(os.path.join(tmp_path, 'meta.json')) as f:
        assert json.load(f) == {'n_done': 1}


@pytest.mark.parametrize('cls', [DynamicNetworkLSM, DynamicNetworkLPCM,
                                 DynamicNetworkHDPLPCM])
def test_estimators_take_checkpoint_dir(tmp_path, network, cls,
                                        short_nested_lsm):
    """Each estimator fits with ``checkpoint_dir`` (it raised before) and
    leaves a complete checkpoint of its sampling stage."""
    kw = {} if cls is DynamicNetworkLSM else dict(n_components=3)
    path = str(tmp_path / 'ckpt')
    m = cls(n_iter=10, tune=5, burn=5, trace_chunk=8, random_state=2,
            device='cpu', checkpoint_dir=path, **kw).fit(network)
    assert np.isfinite(m.logps_).all()
    meta = ckpt.read_meta(path)
    assert meta['n_done'] == meta['n_samples'] == 19 and meta['chunk'] == 8
    assert sorted(f for f in os.listdir(path) if f.startswith('chunk_')) \
        == ['chunk_%05d.npz' % i for i in range(3)]
    assert isinstance(ckpt.load_state(os.path.join(path, 'state.npz'),
                                      'cpu')[0], LSMState) \
        == (cls is DynamicNetworkLSM)
