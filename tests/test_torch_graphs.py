"""The CUDA-graph replay of the sweeps (``dynetlsm_tpu_torch/mcmc/graphs.py``)
on the CPU: which sweeps it engages for, the counters a replay advances,
and the benchmark's reader of the replayed share.  A capture needs a card:
``chip_smoke.py``'s graph phase holds replayed sweeps to the eager ones
bit for bit there."""
import dataclasses
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynetlsm_tpu_torch import tracing
from dynetlsm_tpu_torch.entry import build_state_and_sweep
from dynetlsm_tpu_torch.mcmc import graphs, sweeps
from dynetlsm_tpu_torch.mcmc.sweeps import SweepConfig
from dynetlsm_tpu_torch.tracing import Span
from port_bench.metrics import graph_replay_share

CUDA = torch.device('cuda', 0)
CARDS = [torch.device('cuda', 0), torch.device('cuda', 1)]


def _eager(state, gen):
    return state


@pytest.mark.parametrize('device, node_devices, cc_static, host_reads, '
                         'engages', [
                             (CUDA, None, None, False, True),
                             ('cuda', [CUDA], None, False, True),
                             (CUDA, None, {'colors': None}, False, False),
                             (CUDA, CARDS, None, False, False),
                             (CUDA, None, None, True, False),
                             ('cpu', None, None, False, False)],
                         ids=['dense on a card (HDP-LPCM, LPCM)',
                              'one node device', 'case-control',
                              'node shards', 'a host read', 'cpu'])
def test_which_sweeps_replay_from_a_graph(device, node_devices, cc_static,
                                          host_reads, engages):
    node_shards = 1 if node_devices is None else len(node_devices)
    assert graphs.engages(device, node_shards,
                          host_reads or cc_static is not None) == engages
    sweep = sweeps._attach(_eager, SweepConfig(), None, None, cc_static,
                           None, node_devices, device, host_reads)
    assert (sweep.graphs is not None) == engages
    assert sweep.eager is _eager and sweep.node_shards == node_shards


def test_cpu_sweeps_run_eager():
    Y = np.triu(np.random.RandomState(0).binomial(1, 0.3, (3, 10, 10)), 1)
    state, sweep, gen = build_state_and_sweep(Y + Y.transpose(0, 2, 1), 2,
                                              K=3, device='cpu')
    assert sweep.graphs is None
    gen2 = torch.Generator().manual_seed(0)
    gen2.set_state(gen.get_state())
    a, b = sweep(state, gen), sweep.eager(state, gen2)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert (va is None and vb is None) or torch.equal(va, vb), f.name


class _Graph:
    replays = 0

    def replay(self):
        self.replays += 1


def _cache_with_a_graph(deltas):
    """A cache holding one 'captured' sweep of a small state on the CPU,
    its graph a stand-in, its output the input's X plus 1."""
    state = sweeps.LSMState(torch.arange(2), *[torch.full((2, 3), float(k))
                                               for k in range(1, 13)])
    gen = torch.Generator()
    cache = graphs.GraphCache(_eager, sweeps.launch_counts,
                              sweeps.add_launch_counts)
    names = [f.name for f in dataclasses.fields(state)
             if getattr(state, f.name) is not None]
    inputs = [torch.zeros_like(getattr(state, n)) for n in names]
    out = state.replace(X=state.X + 1.0)
    entry = graphs.Captured(_Graph(), names, inputs, out, deltas)
    cache.graphs[graphs.layout(state, gen)] = entry
    return cache, state, gen, entry


def test_a_replay_counts_what_its_capture_counted():
    keys = sweeps.launch_counts()
    deltas = {k: i + 1 for i, k in enumerate(keys)}
    cache, state, gen, entry = _cache_with_a_graph(deltas)
    before, graph0 = sweeps.launch_counts(), graphs.counts()
    sweep = tracing.traced(cache.__call__, name='sweep',
                           counters=sweeps.sweep_counts)
    with profile(activities=[ProfilerActivity.CPU]):
        # the profile's start dropped the graph: put it back
        cache.graphs[graphs.layout(state, gen)] = entry
        for _ in range(2):
            sweep(state, gen)
        root = [s for s in tracing.spans() if s.name == 'sweep']
        assert len(cache.graphs) == 1
    after, graph1 = sweeps.launch_counts(), graphs.counts()
    assert {k: after[k] - before[k] for k in keys} == {
        k: 2 * v for k, v in deltas.items()}
    assert graph1['graph_replays'] - graph0['graph_replays'] == 2
    assert graph1['graph_captures'] == graph0['graph_captures']
    assert entry.graph.replays == 2
    # the sweep span reads the replayed sweep's launches and the replay
    assert [r.counts for r in root] == [dict(deltas, graph_replays=1)] * 2
    # the state went into the graph's inputs, and copies came out
    for k, v in zip(entry.names, entry.inputs):
        assert torch.equal(v, getattr(state, k))
    sweeps.add_launch_counts({k: -2 * v for k, v in deltas.items()})
    assert sweeps.launch_counts() == before


def test_a_returned_state_is_a_copy_and_a_profile_drops_the_graphs():
    cache, state, gen, entry = _cache_with_a_graph({})
    new = cache(state, gen)
    assert torch.equal(new.X, state.X + 1.0)
    assert new.X is not entry.out.X and new.it is not entry.out.it
    entry.out.X.add_(5.0)                # a later replay's output
    assert torch.equal(new.X, state.X + 1.0)
    with profile(activities=[ProfilerActivity.CPU]):
        assert not cache.graphs          # dropped when the profile began
    # a key seen before captures at its next call; a new one runs eager
    assert graphs.layout(state, gen) not in cache.warm
    assert cache(state, gen) is state
    assert graphs.layout(state, gen) in cache.warm


def _spans(counts):
    return [Span(k, 'sweep', 100 * k, 100 * k + 50, None, k, c)
            for k, c in enumerate(counts)]


@pytest.mark.parametrize('counts, sweeps_, share', [
    ([{'graph_replays': 1}, {'graph_replays': 1}, {'graph_captures': 1},
      {}], 4, 50.0),
    ([{'graph_replays': 1}] * 3, 3, 100.0),
    ([{'host_syncs': 1}] * 2, 2, 0.0),
    ([{'graph_replays': 1}] * 3, 4, None)],
    ids=['a capture in the window', 'all replayed', 'case-control',
         'a span missing'])
def test_graph_replay_share_reader(monkeypatch, counts, sweeps_, share):
    monkeypatch.setattr(tracing, 'spans', lambda: _spans(counts))
    got = graph_replay_share.read({'sweeps': sweeps_})
    assert got == (None if share is None else pytest.approx(share))


def test_graph_replay_share_reads_nothing_without_graphs(monkeypatch):
    monkeypatch.setattr(tracing, 'spans',
                        lambda: _spans([{'graph_replays': 1}]))
    from dynetlsm_tpu_torch import mcmc
    monkeypatch.delattr(mcmc, 'graphs')
    monkeypatch.setitem(sys.modules, 'dynetlsm_tpu_torch.mcmc.graphs', None)
    assert graph_replay_share.read({'sweeps': 1}) is None
