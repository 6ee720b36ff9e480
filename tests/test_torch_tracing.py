"""The program's spans and counters (``dynetlsm_tpu_torch/tracing.py``), on
the CPU at a tiny size: nothing is recorded without a profiler; under one,
a ``sweep`` span a sweep with every block span inside it, one
``host_sync`` a case-control sweep, and states bit for bit those of the
untraced sweeps.  On the card, the spans' clock against the device's."""
import dataclasses
import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynetlsm_tpu_torch import tracing
from dynetlsm_tpu_torch.entry import build_state_and_sweep


def _tiny_network(T=3, n=12, seed=0):
    rng = np.random.RandomState(seed)
    Y = np.triu(rng.binomial(1, 0.3, (T, n, n)), 1).astype(np.float64)
    return Y + Y.transpose(0, 2, 1)


def _build(model='hdp', n_control=None):
    return build_state_and_sweep(
        _tiny_network(), 3, K=3 if model != 'lsm' else None, device='cpu',
        model=model, n_control=n_control)


def _traced_sweeps(sweep, state, gen, n=2):
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(n):
            state = sweep(state, gen)
    return state, tracing.spans()


def test_nothing_is_recorded_without_a_profiler():
    state, sweep, gen = _build(n_control=4)
    with profile(activities=[ProfilerActivity.CPU]):
        pass                                   # clears the recorder
    assert not torch.autograd.profiler._is_profiler_enabled
    for _ in range(2):
        state = sweep(state, gen)           # a host_sync a sweep
    assert tracing.spans() == [] and tracing.dropped() == 0


@pytest.mark.parametrize('n_control', [None, 4])
def test_spans_nest_in_one_sweep_span_a_sweep(n_control):
    state, sweep, gen = _build(n_control=n_control)
    state = sweep(state, gen)
    _, spans = _traced_sweeps(sweep, state, gen)
    roots = [s for s in spans if s.name == 'sweep']
    assert [r.sweep for r in roots] == [0, 1]
    assert all(r.parent is None for r in roots)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == 'sweep':
            continue
        parent = by_id[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert parent.sweep == s.sweep
    names = {s.name for s in spans}
    assert {'sample_latent_positions', 'sample_labels_block',
            'sample_dirichlet', '_finish_tuning'} <= names
    assert names - {'sweep', 'host_sync', 'cc_class'} <= set(tracing.BLOCKS)
    # the self times of a sweep's spans add up to the sweep's duration
    child = {}
    for s in spans:
        if s.parent is not None:
            child[s.parent] = child.get(s.parent, 0) + s.end_ns - s.start_ns
    for r in roots:
        own = sum(s.end_ns - s.start_ns - child.get(s.id, 0)
                  for s in spans if s.sweep == r.sweep)
        assert own == r.end_ns - r.start_ns
    syncs = [s for s in spans if s.name == 'host_sync']
    if n_control is None:
        assert not syncs and all(r.counts == {} for r in roots)
        assert 'cc_class' not in names
    else:
        assert [s.sweep for s in syncs] == [0, 1]
        assert all(r.counts == {'host_syncs': 1} for r in roots)
        latent = {s.id for s in spans
                  if s.name == 'sample_latent_positions'}
        assert all(s.parent in latent for s in spans
                   if s.name == 'cc_class')


def _fields(state):
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if torch.is_tensor(getattr(state, f.name))}


@pytest.mark.parametrize('model, n_control', [
    ('hdp', None), ('lpcm', None), ('lsm', None), ('hdp', 4)])
def test_a_traced_sweep_is_the_untraced_one_bit_for_bit(model, n_control):
    state, sweep, gen = _build(model, n_control)
    start = gen.get_state()
    plain = state
    for _ in range(2):
        plain = sweep(plain, gen)
    gen.set_state(start)
    traced, spans = _traced_sweeps(sweep, state, gen)
    assert sum(s.name == 'sweep' for s in spans) == 2
    a, b = _fields(plain), _fields(traced)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.cuda
def test_span_edges_meet_the_device_idle_gap():
    """After a synchronise, marker kernel A, a span around 2 ms of host
    work, marker B: the device's idle gap between A and B starts within
    30 us of the span's start and closes after the span's end.  A clock
    offset e moves the start residual (span start - A's end) by -e and
    the end one (B's start - span end) by +e; the host's own delays (A's
    launch to the stamp, the stamp to B's start: B's launch latency) only
    add to them.  So the least residuals bound the clock (no start before
    -30 us, no end before 0), and the start's median is the host's short
    delay.  The host spins rather than sleeps: a thread woken from
    ``time.sleep`` reaches the next stamp and launch 10-70 us late."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from torch.autograd import DeviceType
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            torch.cuda.synchronize()
            torch.cuda._sleep(1)
            with tracing.span('probe'):
                until = time.perf_counter() + 0.002
                while time.perf_counter() < until:
                    pass
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    marks = [(e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA and 'spin' in e.name()]
    probes = [s for s in tracing.spans() if s.name == 'probe']
    assert len(probes) == 50 and len(marks) >= 99
    # each span's A and B: the marks nearest its edges, 2 ms apart
    start = [min(((p.start_ns - e) / 1e3 for _, e in marks), key=abs)
             for p in probes]
    end = [min(((s - p.end_ns) / 1e3 for s, _ in marks), key=abs)
           for p in probes]
    print('start residual us (min, median, max)', min(start),
          statistics.median(start), max(start))
    print('end residual us (min, median, max)', min(end),
          statistics.median(end), max(end))
    assert min(start) >= -30 and abs(statistics.median(start)) <= 30
    assert min(end) >= 0


def _tiny_directed_network(T=3, n=12, seed=1):
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.3, (T, n, n)).astype(np.float64)
    for t in range(T):
        np.fill_diagonal(Y[t], 0.0)
    return Y


@pytest.mark.parametrize('is_directed', [False, True])
def test_sweep_spans_count_the_directed_candidate_dyads(is_directed):
    """A directed sweep scores its dense network at four candidates (b_in's
    current and proposed, b_out's proposed, the radii's proposed), each
    over every unordered dyad of every time and chain: the ``sweep``
    span's ``dir_loglik_dyads``; an undirected sweep scores none."""
    C, T, n = 3, 3, 12
    Y = _tiny_directed_network(T, n) if is_directed else _tiny_network(T, n)
    state, sweep, gen = build_state_and_sweep(
        Y, C, K=3, device='cpu', is_directed=is_directed)
    _, spans = _traced_sweeps(sweep, state, gen)
    counted = [r.counts.get('dir_loglik_dyads', 0) for r in spans
               if r.name == 'sweep']
    want = 4 * C * T * n * (n - 1) // 2 if is_directed else 0
    assert counted == [want, want]
