"""The directed cell ``hdp_ns_directed``: its files, its network, its
configuration against the program's, its counts and readers, and its
judge on the CPU at a small size, on a sound program and on broken ones."""
import pytest
import torch

from dynetlsm_tpu_torch.mcmc import metropolis
from dynetlsm_tpu_torch.ops import node_scan
from port_bench import core
from port_bench.metrics import dir_loglik_roofline, directed_coef_self_ms
from port_bench.networks.community_directed import (
    community_directed_network)
from port_bench.sweep_counts import hdp_directed

from .helpers import tiny_run, tiny_spec


def _spec(**kw):
    return tiny_spec('hdp_ns_directed', **kw)


def test_the_cell_files_load():
    spec = core.load_spec('hdp_ns_directed')
    assert spec['config']['name'] == 'hdp_lpcm_directed_northstar'
    assert spec['config']['is_directed'] and spec['config']['program'][
        'is_directed']
    assert (spec['config']['T'], spec['config']['n'], spec['config']['K'],
            spec['traffic']['chains']) == (10, 500, 25, 128)
    assert spec['traffic']['program'] == {
        'latent_update': 'exact', 'quality_init': False, 'n_control': None}
    assert spec['params']['reference'] == 'hdp_directed'
    assert spec['params']['counts'] == 'hdp_directed'
    assert spec['config']['reduced'] == []
    names = {m['name'] for m in spec['per_layer']}
    assert {'dir_loglik_roofline', 'directed_coef_self_ms',
            'node_scan_roofline', 'latent_device_ms'} <= names


def test_check_config_passes_on_the_directed_program():
    spec = _spec(T=3, n=18, K=3, chains=2)
    _, _, state, sweep, _ = core.build(spec, 11, torch.device('cpu'))
    assert sweep.cfg.is_directed and sweep.cfg.tune_radii
    assert torch.all(state.step_radii
                     == spec['config']['sweep']['radii_step'])
    wrong = dict(spec['config'], sweep=dict(spec['config']['sweep'],
                                            tune_radii=False))
    with pytest.raises(RuntimeError, match='tune_radii'):
        core.check_config(sweep.cfg, wrong, spec['traffic'])


def test_the_directed_network():
    a = community_directed_network(3, 200, 2 ** 33 + 5, 'cpu')
    assert torch.equal(a, community_directed_network(3, 200, 2 ** 33 + 5,
                                                     'cpu'))
    assert not torch.equal(a, community_directed_network(3, 200, 7, 'cpu'))
    assert a.dtype == torch.uint8 and int(a.max()) == 1
    assert int(torch.diagonal(a, dim1=1, dim2=2).sum()) == 0
    assert not torch.equal(a, a.transpose(1, 2))
    # each ordered dyad drawn alone: about p^2 of the dyads both ways
    Y = community_directed_network(4, 400, 3, 'cpu').double()
    p = 0.1 / 8 + 0.01 * 7 / 8
    assert abs(float(Y.sum()) / (4 * 400 * 399) - p) < 0.003
    both = float((Y * Y.transpose(1, 2)).sum()) / float(Y.sum())
    assert both < 0.2


def test_the_directed_counts():
    spec = {'config': {'T': 3, 'n': 4, 'd': 2, 'K': 2},
            'traffic': {'chains': 2, 'program': {}}}
    out = hdp_directed.count(spec, {'edges': 10})
    # 56 a partner of a site, 50 a site, 2 (n - 1) + 2 n a node's scales
    assert out['node_scan_flops'] == 2 * (12 * (3 * 56 + 50) + 24 + 8)
    k = out['dir_loglik']
    assert k['cand_dyads'] == 18
    # one launch at two candidates: 36 dyads' distances, 72 candidate-dyads
    # at 22, 4 candidates of a chain at 2 n reciprocals
    flops, nbytes = hdp_directed.dir_loglik_work(k, 1, 72)
    assert flops == 36 * 6 + 72 * 22 + 4 * 8
    assert nbytes == 3 * 16 + 4 * 2 * 3 * 4 * 2 + 4 * 4 * 7


def test_the_readers_read_nothing_without_a_trace():
    spec = _spec(T=3, n=18, K=3, chains=2)
    ctx = {'sweeps': 4, 'chains': 2, 'window_s': 1.0, 'spans': {},
           'latent_update': 'exact'}
    ctx.update(hdp_directed.count(spec, {'edges': 10}))
    assert dir_loglik_roofline.read(ctx) is None
    assert directed_coef_self_ms.read(ctx) is None
    ctx['kernels'] = [('dir_loglik_kernel', 0, 1000)]
    assert dir_loglik_roofline.read(ctx) is None


def test_a_directed_run_is_correct():
    result, lines = tiny_run(_spec(T=4, n=40, K=5, chains=4), trace=True)
    assert result['correct'], lines
    assert result['check']['stale']['value'] == 0


def test_a_radii_step_that_always_accepts_is_not_correct(monkeypatch):
    """The radii's proposal taken whatever its ratio.  (A Hastings term
    left out is not seen here: the term is ~0.01-0.4 nats, and a window's
    last sweep rarely holds a radii decision that close to its
    log-uniform.)"""
    def accept(x0, x, logp_cur, logp_prop, step_size, temper=None):
        return torch.full_like(logp_cur, float('inf'), dtype=torch.float64)
    monkeypatch.setattr(metropolis, 'dirichlet_mh_ratio', accept)
    result, lines = tiny_run(_spec(T=4, n=40, K=5, chains=16))
    assert not result['correct'], lines


def test_a_scan_reading_the_edges_reversed_is_not_correct(monkeypatch):
    terms = node_scan._directed_partial_loglik_terms

    def reversed_edges(P_row, X, x, both, p_out, p_in):
        return terms((P_row >> 1) | ((P_row & 1) << 1), X, x, both, p_out,
                     p_in)
    monkeypatch.setattr(node_scan, '_directed_partial_loglik_terms',
                        reversed_edges)
    result, lines = tiny_run(_spec(T=4, n=40, K=5, chains=16))
    assert not result['correct'], lines


def test_stale_counts_a_repeated_draw_but_not_a_clipped_one():
    """A chain's beta left as it was counts one, unless every weight is
    float32's tiny or 1 (a draw whose other weights underflowed)."""
    from port_bench.reference.hdp_directed import SMALL_EPS, stale_fields
    C, K = 3, 4
    before = {'X': torch.zeros(C, 1, 2, 2), 'beta': torch.full((C, K), 0.25)}
    before['beta'][1] = torch.tensor([SMALL_EPS, 1.0, SMALL_EPS, SMALL_EPS])
    after = {'X': torch.ones(C, 1, 2, 2), 'beta': before['beta'].clone()}
    after['beta'][2] = torch.tensor([0.1, 0.2, 0.3, 0.4])
    gens = (torch.tensor([0]), torch.tensor([1]), torch.tensor([2]))
    assert stale_fields(before, after, gens).tolist() == [1.0, 0.0, 0.0]
    gens = (torch.tensor([0]), torch.tensor([1]), torch.tensor([1]))
    assert stale_fields(before, after, gens).tolist() == [2.0, 1.0, 1.0]
