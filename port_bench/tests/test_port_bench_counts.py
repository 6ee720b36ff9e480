"""The operation and byte counts at small shapes, and the readers that
turn them and a trace into per-layer metrics."""
import pytest

from port_bench import counts
from port_bench.metrics import (
    device_idle_share, dispatch_ms_per_sweep, latent_device_ms,
    mixture_blocks_host_ms, node_scan_roofline, sweep_mfu)
from port_bench.sweep_counts import hdp_case_control, hdp_dense


def test_counts_small_shapes():
    # 3 sites, 2 partners each, 30 operations a partner, 50 a site
    assert counts.latent_flops(1, 1, 3) == 3 * (2 * 30 + 50)
    assert counts.latent_flops(2, 3, 3) == 6 * counts.latent_flops(1, 1, 3)
    # 6 unordered dyads at n = 4, 24 operations each
    assert counts.intercept_flops(1, 1, 4) == 6 * 24
    assert counts.mixture_site_flops(2) == 2 * 4 + 21 * 2 + 14
    assert counts.mixture_flops(2, 3, 4, 2) == 24 * (8 + 42 + 14)
    # T n^2 network bytes; 4 bytes of 12 words in and 3 out a site and 2
    # a chain
    assert counts.node_scan_bytes(1, 1, 4, 2) == 16 + 4 * (4 * 15 + 2)


def test_case_control_counts_edges_and_controls():
    # 10 edge entries (5 edges) and 3 controls a row over 2 x 4 rows: 28
    # a partner of a site, 22 an evaluation of the intercept step
    assert counts.cc_latent_flops(1, 2, 4, 10, 3) == (
        (10 + 24) * 28 + 8 * 50)
    assert counts.cc_intercept_flops(2, 2, 4, 10, 3) == 2 * (5 + 24) * 22


def _spec(chains, T, n, K, n_control=None):
    return {'config': {'T': T, 'n': n, 'd': 2, 'K': K},
            'traffic': {'chains': chains,
                        'program': {'n_control': n_control}}}


def test_sweep_count_modules():
    dense = hdp_dense.count(_spec(2, 3, 4, 2), {'edges': 6})
    assert dense['sweep_flops'] == (
        counts.latent_flops(2, 3, 4) + counts.intercept_flops(2, 3, 4)
        + counts.mixture_flops(2, 3, 4, 2))
    assert dense['node_scan_flops'] == counts.latent_flops(2, 3, 4)
    cc = hdp_case_control.count(_spec(2, 3, 4, 2, n_control=3),
                                {'edges': 6})
    assert cc['sweep_flops'] == (
        counts.cc_latent_flops(2, 3, 4, 6, 3)
        + counts.cc_intercept_flops(2, 3, 4, 6, 3)
        + counts.mixture_flops(2, 3, 4, 2))
    assert 'node_scan_flops' not in cc


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_seconds(67e12, 2 * 3.35e12) == pytest.approx(2.0)


def _ctx(**kw):
    ctx = {'sweeps': 2, 'chains': 1, 'window_s': 1.0, 'spans': {},
           'latent_update': 'exact', 'sweep_flops': 67e9,
           'node_scan_flops': 67e9, 'node_scan_bytes': 0}
    ctx.update(kw)
    return ctx


def test_readers_on_a_synthetic_trace():
    ms = 1_000_000
    ctx = _ctx(spans={'sweep': [(0, 4 * ms), (5 * ms, 7 * ms)],
                      'sample_tables': [(1 * ms, 2 * ms)],
                      'sample_dirichlet': [(5 * ms, 6 * ms)],
                      'sample_latent_positions': [(0, ms)]},
               kernels=[('node_scan_kernel', 0, 2 * ms),
                        ('elementwise', 3 * ms, 4 * ms),
                        ('node_scan_kernel', 5 * ms, 7 * ms)],
               latent=[(0, 2 * ms), (5 * ms, 7 * ms)],
               busy_s=0.25, device_window_s=1.0)
    assert dispatch_ms_per_sweep.read(ctx) == pytest.approx(3.0)
    assert mixture_blocks_host_ms.read(ctx) == pytest.approx(1.0)
    assert latent_device_ms.read(ctx) == pytest.approx(2.0)
    # least time 1 ms a scan, 2 ms spent a scan
    assert node_scan_roofline.read(ctx) == pytest.approx(50.0)
    assert sweep_mfu.read(ctx) == pytest.approx(0.2)
    assert device_idle_share.read(ctx) == pytest.approx(75.0)


def test_readers_find_nothing_without_a_trace():
    ctx = _ctx()
    for reader in (dispatch_ms_per_sweep, mixture_blocks_host_ms,
                   latent_device_ms, node_scan_roofline,
                   device_idle_share):
        assert reader.read(ctx) is None
    assert node_scan_roofline.read(_ctx(latent_update='parallel', kernels=[
        ('node_scan_kernel', 0, 1)])) is None
    # a case-control sweep counts no node scan
    assert node_scan_roofline.read(_ctx(node_scan_flops=None, kernels=[
        ('node_scan_kernel', 0, 1)])) is None
