"""The readers of the program's own spans (``metrics/mixture_blocks_self_ms``,
``mixture_idle_ms``, ``latent_idle_ms``, ``host_syncs_per_sweep``) on a
synthetic window: two sweeps of spans and the device's kernels."""
import sys

import pytest

from dynetlsm_tpu_torch import tracing
from dynetlsm_tpu_torch.tracing import Span
from port_bench.metrics import (
    host_syncs_per_sweep, latent_idle_ms, mixture_blocks_self_ms,
    mixture_idle_ms)

READERS = (mixture_blocks_self_ms, mixture_idle_ms, latent_idle_ms,
           host_syncs_per_sweep)
MS = 1_000_000


def _sweep(k, t0, blocks=True):
    """A sweep at t0 (ms): sample_tables [10, 30) with a host_sync child
    [15, 20), sample_latent_positions [40, 70) with a cc_class child
    [45, 50), _finish_tuning [80, 90); the sweep [0, 100)."""
    root = 100 * k

    def span(i, name, a, b, parent=root, counts=None):
        return Span(root + i, name, (t0 + a) * MS, (t0 + b) * MS, parent, k,
                    counts or {})
    if not blocks:
        return [span(0, 'sweep', 0, 100, None)]
    return [span(2, 'host_sync', 15, 20, root + 1, {'host_syncs': 1}),
            span(1, 'sample_tables', 10, 30, counts={'host_syncs': 1}),
            span(4, 'cc_class', 45, 50, root + 3),
            span(3, 'sample_latent_positions', 40, 70),
            span(5, '_finish_tuning', 80, 90),
            span(0, 'sweep', 0, 100, None, {'host_syncs': 1})]


def _ctx(sweeps=2):
    # busy [0, 12), [25, 28), [60, 65), [190, 200) ms: idle [12, 25),
    # [28, 60), [65, 190)
    kernels = [('k', a * MS, b * MS)
               for a, b in ((0, 12), (25, 28), (60, 65), (190, 200))]
    return {'sweeps': sweeps, 'kernels': kernels}


@pytest.fixture
def window(monkeypatch):
    spans = _sweep(0, 0) + _sweep(1, 100)
    monkeypatch.setattr(tracing, 'spans', lambda: list(spans))
    return spans


def test_the_readers_on_two_sweeps(window):
    ctx = _ctx()
    # 20 - 5 ms of sample_tables' own time a sweep
    assert mixture_blocks_self_ms.read(ctx) == pytest.approx(15.0)
    # sample_tables' own time [10, 15) and [20, 30) meets idle [12, 15),
    # [20, 25) and [28, 30) in the first sweep, [110, 115) and [120, 130)
    # in the second
    assert mixture_idle_ms.read(ctx) == pytest.approx((10 + 15) / 2)
    # sample_latent_positions [40, 70) meets idle [40, 60), [65, 70); then
    # [140, 170) all idle
    assert latent_idle_ms.read(ctx) == pytest.approx((25 + 30) / 2)
    assert host_syncs_per_sweep.read(ctx) == 1.0


def test_no_reading_unless_a_sweep_span_a_window_sweep(window):
    for reader in READERS:
        assert reader.read(_ctx(sweeps=3)) is None


def test_no_reading_from_a_program_without_spans(window, monkeypatch):
    import dynetlsm_tpu_torch
    monkeypatch.delattr(dynetlsm_tpu_torch, 'tracing')
    monkeypatch.setitem(sys.modules, 'dynetlsm_tpu_torch.tracing', None)
    for reader in READERS:
        assert reader.read(_ctx()) is None


def test_sweeps_without_block_spans_read_zero(monkeypatch):
    """A sweep replayed from a CUDA graph records its root span alone."""
    spans = _sweep(0, 0, blocks=False) + _sweep(1, 100, blocks=False)
    monkeypatch.setattr(tracing, 'spans', lambda: spans)
    for reader in READERS:
        assert reader.read(_ctx()) == 0.0
