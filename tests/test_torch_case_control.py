"""The port's case-control likelihood (``dynetlsm_tpu_torch/ops/
case_control.py`` and its use in the sweeps) against the JAX package's on
identical numpy-seeded inputs: the host edge lists, degree bound and
colouring identical; the device edge lists equal to the host lists;
the control masks identical for injected controls; the partial, class and
full evaluators within rtol 1e-5, directed and undirected, shared and
per-chain lists, in one node block and in several.  Then, as
``tests/test_case_control.py`` checks the JAX package: the full-control
limit equals the exact likelihood, the control draw excludes self and own
class, the control estimator is unbiased, the redraw cadence holds and is
one draw for every chain, the initial logp uses the estimator, a sweep's
logp is the case-control log joint of its state, tempering refuses
case-control with the JAX package's error, and the fast
``datasets.northstar_edge_lists`` draws bench.py's model.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynetlsm_tpu.mcmc import tempering as jax_tempering
from dynetlsm_tpu.mcmc.sweeps import SweepConfig as JaxSweepConfig
from dynetlsm_tpu.ops import case_control as jcc
from dynetlsm_tpu_torch.datasets import (
    northstar_edge_lists, northstar_network, with_missing_dyads)
from dynetlsm_tpu_torch.entry import build_state_and_sweep
from dynetlsm_tpu_torch.mcmc import sweeps
from dynetlsm_tpu_torch.mcmc.tempering import make_pt_step
from dynetlsm_tpu_torch.ops import case_control as pcc
from dynetlsm_tpu_torch.ops.distances import pairwise_distances
from dynetlsm_tpu_torch.ops.likelihoods import (
    directed_loglik_full, undirected_loglik_full)

T, N, M, C = 3, 20, 6, 2


def _net(rng, directed, n=N, p=0.2):
    Y = rng.binomial(1, p, size=(T, n, n)).astype(np.float64)
    if not directed:
        Y = np.triu(Y, 1)
        Y = Y + np.swapaxes(Y, 1, 2)
    for t in range(T):
        np.fill_diagonal(Y[t], 0)
    return Y


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a)).to(dtype)


def _long(lists):
    return {k: _t(v, torch.int64) for k, v in lists.items()}


def _jax_controls(directed, n=N, m=M, seed=2):
    """JAX's colored control draw against a random colouring, as numpy."""
    colors = np.random.RandomState(seed).randint(0, 4, n)
    ci, co = jcc.sample_controls_colored(jax.random.PRNGKey(seed),
                                         jnp.asarray(colors), n, m,
                                         directed=directed)
    return (None if ci is None else np.asarray(ci)), np.asarray(co)


def _all_others(n):
    base = np.arange(n)[None, :].repeat(n, axis=0)
    return base[base != np.arange(n)[:, None]].reshape(n, n - 1)


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('with_missing', [False, True])
@pytest.mark.parametrize('directed', [True, False])
def test_host_structures_match_jax(directed, with_missing):
    rng = np.random.RandomState(1 + directed + 2 * with_missing)
    Y = _net(rng, directed, n=37, p=0.1)
    miss = (rng.uniform(size=Y.shape) < 0.05) if with_missing else None
    want, got = jcc.build_edge_lists(Y), pcc.build_edge_lists(Y)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert pcc.max_degree_bound(Y, miss) == jcc.max_degree_bound(Y, miss)
    for seed in (0, 5):
        cw, gw = jcc.color_conflict_graph(want, 37, miss_mask=miss,
                                          seed=seed)
        cg, gg = pcc.color_conflict_graph(got, 37, miss_mask=miss,
                                          seed=seed)
        np.testing.assert_array_equal(cg, cw)
        np.testing.assert_array_equal(gg, gw)
        assert gg.dtype == gw.dtype and cg.dtype == cw.dtype


@pytest.mark.parametrize('directed', [True, False])
def test_edge_lists_device_matches_host(directed):
    """The stable-sort rebuild equals the host lists slot for slot, for
    one network and for one network a chain (tests/test_case_control.py:
    210 checks the JAX top-k rebuild as sets)."""
    rng = np.random.RandomState(7 + directed)
    Ys = np.stack([_net(rng, directed, n=17) for _ in range(3)])
    D = max(pcc.max_degree_bound(Y) for Y in Ys)
    per_chain = pcc.edge_lists_device(_t(Ys, torch.uint8), D)
    for c, Y in enumerate(Ys):
        host = jcc.build_edge_lists(Y)
        one = pcc.edge_lists_device(_t(Y), D)
        np.testing.assert_array_equal(one['degrees'].numpy(),
                                      host['degrees'])
        for k in ('in_edges', 'out_edges'):
            want = np.full((T, 17, D), -1)
            w = host[k][..., :D]
            want[..., :w.shape[-1]] = w
            np.testing.assert_array_equal(one[k].numpy(), want)
            np.testing.assert_array_equal(per_chain[k][c].numpy(), want)


@pytest.mark.parametrize('directed', [True, False])
def test_masks_match_jax(directed):
    """Injected controls: the port's masks equal JAX's, for shared lists
    and for per-chain lists."""
    rng = np.random.RandomState(3 + directed)
    Y = _net(rng, directed)
    lists = jcc.build_edge_lists(Y)
    ci, co = _jax_controls(directed)
    jlists = {k: jnp.asarray(v) for k, v in lists.items()}
    civ, cov = jcc.control_masks(
        None if ci is None else jnp.asarray(ci), jnp.asarray(co), jlists,
        directed)
    pci = None if ci is None else _t(ci, torch.int64)
    got = pcc.control_masks(pci, _t(co, torch.int64), _long(lists),
                            directed)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(cov))
    if directed:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(civ))
    chains = {k: v.expand((C,) + v.shape) for k, v in _long(lists).items()}
    got_c = pcc.control_masks(pci, _t(co, torch.int64), chains, directed)
    for c in range(C):
        np.testing.assert_array_equal(got_c[1][c].numpy(), np.asarray(cov))


def test_controls_exclude_self_and_own_class():
    """Every draw is -1 or another node of another class; the draw of one
    (seed, sweep) is reproducible and the next sweep's differs."""
    rng = np.random.RandomState(9)
    Y = _net(rng, True, n=40, p=0.1)
    lists = pcc.build_edge_lists(Y)
    colors, _ = pcc.color_conflict_graph(lists, 40, seed=1)
    col = _t(colors, torch.int64)

    def draw(it):
        return pcc.sample_controls_colored(
            sweeps.control_generator(5, it, 'cpu'), col, 40, 8)

    ci, co = draw(0)
    for ctrl in (ci.numpy(), co.numpy()):
        i, k = np.nonzero(ctrl >= 0)
        c = ctrl[i, k]
        assert (c != i).all() and (colors[c] != colors[i]).all()
        assert (ctrl >= -1).all() and (ctrl < 40).all()
        # every rejected draw was self or own class: the with-replacement
        # draw keeps most candidates
        assert (ctrl >= 0).mean() > 0.4
    assert torch.equal(draw(0)[1], co) and not torch.equal(draw(1)[1], co)
    _, cov = pcc.control_masks(ci, co, _long(lists), True)
    t_, i_, k_ = np.nonzero(cov.numpy())
    assert (Y[t_, i_, co.numpy()[i_, k_]] == 0).all()


# ---------------------------------------------------------------------------
# evaluators against JAX
# ---------------------------------------------------------------------------

def _eval_inputs(rng, directed, n=N):
    Y = _net(rng, directed, n=n)
    X = rng.randn(C, T, n, 2).astype(np.float32)
    radii = rng.dirichlet(np.ones(n), size=C).astype(np.float32)
    b = np.array([[0.3, 0.7], [-0.4, 1.1]], np.float32)
    lists = jcc.build_edge_lists(Y)
    ci, co = _jax_controls(directed, n=n)
    jl = {k: jnp.asarray(v) for k, v in lists.items()}
    civ, cov = jcc.control_masks(None if ci is None else jnp.asarray(ci),
                                 jnp.asarray(co), jl, directed)
    return Y, X, radii, b, lists, ci, co, civ, cov


@pytest.mark.parametrize('directed', [True, False])
def test_partial_evaluators_match_jax(directed):
    rng = np.random.RandomState(12 + directed)
    Y, X, radii, b, lists, ci, co, civ, cov = _eval_inputs(rng, directed)
    j = 5
    x_new = X[:, :, j] + 0.3 * rng.randn(C, T, 2).astype(np.float32)
    li = _long(lists)
    for c in range(C):
        if directed:
            want = jcc.approx_directed_partial_loglik(
                jnp.asarray(X[c]), jnp.asarray(radii[c]), j,
                jnp.asarray(x_new[c]), lists['in_edges'][:, j],
                lists['out_edges'][:, j], lists['degrees'][:, j],
                jnp.asarray(ci[j]), jnp.asarray(co[j]), civ[:, j],
                cov[:, j], b[c, 0], b[c, 1])
        else:
            want = jcc.approx_undirected_partial_loglik(
                jnp.asarray(X[c]), jnp.asarray(x_new[c]),
                lists['out_edges'][:, j], lists['degrees'][:, j, 1],
                jnp.asarray(co[j]), cov[:, j], b[c, 0])
        if directed:
            got = pcc.approx_directed_partial_loglik(
                _t(X), _t(radii), j, _t(x_new), li['in_edges'][:, j],
                li['out_edges'][:, j], li['degrees'][:, j],
                _t(ci[j], torch.int64), _t(co[j], torch.int64),
                _t(civ[:, j], torch.bool), _t(cov[:, j], torch.bool),
                _t(b[:, 0]), _t(b[:, 1]))
        else:
            got = pcc.approx_undirected_partial_loglik(
                _t(X), _t(x_new), li['out_edges'][:, j],
                li['degrees'][:, j, 1], _t(co[j], torch.int64),
                _t(cov[:, j], torch.bool), _t(b[:, 0]))
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('directed', [True, False])
def test_class_segments_match_jax(directed):
    """class_partial_loglik_segments on one colour class's gathered
    segments [in | out | ctrl_in | ctrl_out]."""
    rng = np.random.RandomState(15 + directed)
    Y, X, radii, b, lists, ci, co, civ, cov = _eval_inputs(rng, directed)
    nodes = np.array([1, 4, 9, 13])
    if directed:
        idx = [lists['in_edges'][:, nodes], lists['out_edges'][:, nodes],
               np.broadcast_to(ci[nodes], (T,) + ci[nodes].shape),
               np.broadcast_to(co[nodes], (T,) + co[nodes].shape)]
        valid = [idx[0] >= 0, idx[1] >= 0, np.asarray(civ)[:, nodes],
                 np.asarray(cov)[:, nodes]]
        deg = lists['degrees'][:, nodes]
    else:
        idx = [lists['out_edges'][:, nodes],
               np.broadcast_to(co[nodes], (T,) + co[nodes].shape)]
        valid = [idx[0] >= 0, np.asarray(cov)[:, nodes]]
        deg = lists['degrees'][:, nodes, 1]
    widths = [a.shape[-1] for a in idx]
    offsets = (0,) + tuple(int(v) for v in np.cumsum(widths))
    idx = np.concatenate(idx, -1)
    valid = np.concatenate(valid, -1)
    safe = np.maximum(idx, 0)
    sender = np.zeros(offsets[-1], bool)
    if directed:
        sender[offsets[1]:offsets[2]] = True
        sender[offsets[3]:offsets[4]] = True
    x_new = X[:, :, nodes] + 0.2 * rng.randn(C, T, len(nodes), 2).astype(
        np.float32)
    t_i = np.arange(T)[:, None, None]
    pos = X[:, t_i, safe]                               # (C, T, S, Mtot, 2)
    dist = np.sqrt(((pos - x_new[..., None, :]) ** 2).sum(-1))
    r_all = radii[:, safe]
    got = pcc.class_partial_loglik_segments(
        _t(dist), _t(valid, torch.bool), _t(r_all), _t(radii[:, nodes]),
        _t(sender, torch.bool), offsets, _t(deg, torch.int64), _t(b[:, 0]),
        _t(b[:, 1]), N, directed)
    for c in range(C):
        want = jcc.class_partial_loglik_segments(
            None, jnp.asarray(dist[c]), jnp.asarray(valid),
            jnp.asarray(r_all[c]), jnp.asarray(radii[c, nodes]),
            jnp.asarray(sender[None, None]), offsets, jnp.asarray(deg),
            b[c, 0], b[c, 1] if directed else None, N, directed)
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('blocks', [1, 3])
@pytest.mark.parametrize('per_chain', [False, True])
@pytest.mark.parametrize('directed', [True, False])
def test_full_evaluators_match_jax(monkeypatch, directed, per_chain,
                                   blocks):
    """The network estimator per chain, with lists shared or per chain,
    in one node block or in several (``_BLOCK_ELEMS`` cut down)."""
    rng = np.random.RandomState(20 + directed + 2 * per_chain)
    Y, X, radii, b, lists, ci, co, civ, cov = _eval_inputs(rng, directed,
                                                           n=31)
    if blocks > 1:
        Mo = lists['out_edges'].shape[-1]
        monkeypatch.setattr(pcc, '_BLOCK_ELEMS',
                            C * T * (Mo + M) * 3 * 31 // blocks)
    li = _long(lists)
    mask = _t(cov, torch.bool)
    if per_chain:
        li = {k: v.expand((C,) + v.shape) for k, v in li.items()}
        mask = mask.expand((C,) + mask.shape)
    if directed:
        got = pcc.approx_directed_loglik_full(
            _t(X), _t(radii), li['out_edges'], li['degrees'],
            _t(co, torch.int64), mask, _t(b[:, 0]), _t(b[:, 1]))
    else:
        got = pcc.approx_undirected_loglik_full(
            _t(X), li['out_edges'], li['degrees'][..., 1],
            _t(co, torch.int64), mask, _t(b[:, 0]))
    for c in range(C):
        if directed:
            want = jcc.approx_directed_loglik_full(
                jnp.asarray(X[c]), jnp.asarray(radii[c]),
                lists['out_edges'], lists['degrees'], jnp.asarray(co), cov,
                b[c, 0], b[c, 1])
        else:
            want = jcc.approx_undirected_loglik_full(
                jnp.asarray(X[c]), lists['out_edges'],
                lists['degrees'][..., 1], jnp.asarray(co), cov, b[c, 0])
        np.testing.assert_allclose(float(got[c]), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# exactness and unbiasedness (tests/test_case_control.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('directed', [True, False])
def test_full_control_limit_matches_exact_loglik(directed):
    """Every other node a control: the estimator is the exact network
    log-likelihood, and a node's partial delta the exact delta
    (tests/test_case_control.py:41, :167)."""
    rng = np.random.RandomState(30 + directed)
    Y, X, radii, b, lists, *_ = _eval_inputs(rng, directed, n=15)
    ctrl = _t(_all_others(15), torch.int64)
    li = _long(lists)
    civ, cov = pcc.control_masks(ctrl if directed else None, ctrl, li,
                                 directed)
    Xt, rt, bt = _t(X), _t(radii), _t(b)
    dist = pairwise_distances(Xt)
    if directed:
        got = pcc.approx_directed_loglik_full(
            Xt, rt, li['out_edges'], li['degrees'], ctrl, cov, bt[:, 0],
            bt[:, 1])
        want = directed_loglik_full(_t(Y), dist, rt, bt[:, 0], bt[:, 1])
    else:
        got = pcc.approx_undirected_loglik_full(
            Xt, li['out_edges'], li['degrees'][..., 1], ctrl, cov, bt[:, 0])
        want = undirected_loglik_full(_t(Y), dist, bt[:, 0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4)

    j = 4
    X2 = Xt.clone()
    X2[:, :, j] += 0.2

    def partial(Xa, x):
        if directed:
            return pcc.approx_directed_partial_loglik(
                Xa, rt, j, x, li['in_edges'][:, j], li['out_edges'][:, j],
                li['degrees'][:, j], ctrl[j], ctrl[j], civ[:, j], cov[:, j],
                bt[:, 0], bt[:, 1])
        return pcc.approx_undirected_partial_loglik(
            Xa, x, li['out_edges'][:, j], li['degrees'][:, j, 1], ctrl[j],
            cov[:, j], bt[:, 0])

    delta = (partial(Xt, X2[:, :, j]) - partial(Xt, Xt[:, :, j])).sum(1)
    if directed:
        full = [directed_loglik_full(_t(Y), pairwise_distances(a), rt,
                                     bt[:, 0], bt[:, 1]) for a in (X2, Xt)]
    else:
        full = [undirected_loglik_full(_t(Y), pairwise_distances(a),
                                       bt[:, 0]) for a in (X2, Xt)]
    np.testing.assert_allclose(delta.numpy(), (full[0] - full[1]).numpy(),
                               atol=5e-3)


def test_control_estimate_unbiased():
    """The mean of the estimator over 200 control draws is within 4
    standard errors of the exact log-likelihood
    (tests/test_case_control.py:127)."""
    rng = np.random.RandomState(40)
    Y, X, radii, b, lists, *_ = _eval_inputs(rng, True)
    li = _long(lists)
    Xt, rt, bt = _t(X[:1]), _t(radii[:1]), _t(b[:1])
    want = float(directed_loglik_full(_t(Y), pairwise_distances(Xt), rt,
                                      bt[:, 0], bt[:, 1])[0])
    solo = torch.arange(N)      # each node its own class: self excluded
    draws = []
    for k in range(200):
        _, co = pcc.sample_controls_colored(
            torch.Generator().manual_seed(k), solo, N, 8)
        _, cov = pcc.control_masks(None, co, li, False)
        draws.append(float(pcc.approx_directed_loglik_full(
            Xt, rt, li['out_edges'], li['degrees'], co, cov, bt[:, 0],
            bt[:, 1])[0]))
    draws = np.asarray(draws)
    se = draws.std() / np.sqrt(draws.size)
    assert abs(draws.mean() - want) < 4 * se + 0.05 * abs(want) / 100


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------

def test_control_redraw_cadence():
    """The controls change exactly when the sweep count before the sweep
    is a multiple of n_resample_control, and every chain holds the same
    draw (tests/test_case_control.py:327)."""
    Y = northstar_network(T=2, n=16, seed=4)
    state, sweep, gen = build_state_and_sweep(Y, 2, model='lsm',
                                              device='cpu', n_control=5)
    sweep = sweeps.make_lsm_sweep(
        None, np.zeros(1, np.float32),
        sweeps.SweepConfig(tau_sq=2.0, sigma_sq=0.1, n_control=5,
                           n_resample_control=3),
        device='cpu', cc_static=sweep_cc(Y, 5))
    seen = [state.ctrl_out]
    for _ in range(8):
        state = sweep(state, gen)
        assert state.ctrl_out.shape == (16, 5)
        seen.append(state.ctrl_out)
    for s in range(1, 9):
        # sweep s ran with the pre-increment count s - 1
        changed = not torch.equal(seen[s], seen[s - 1])
        assert changed == ((s - 1) % 3 == 0 and s > 1), s
    assert not torch.equal(seen[4], seen[7])


def sweep_cc(Y, m):
    """The fixed structures build_state_and_sweep makes (seed 0)."""
    from dynetlsm_tpu_torch.models.base import case_control_static
    cfg = sweeps.SweepConfig(n_control=m)
    cc_static, _ = case_control_static(cfg, pcc.build_edge_lists(Y),
                                       Y.shape[1], 'cpu', 0, 7)
    return cc_static


def test_init_logp_uses_cc_estimator():
    """The initial logp's network term is the case-control estimator, not
    the dense likelihood (tests/test_case_control.py:264)."""
    Y = northstar_network(T=2, n=20, seed=5)
    cc_state, _, _ = build_state_and_sweep(Y, 1, model='lsm', device='cpu',
                                           n_control=6)
    dense_state, sweep, _ = build_state_and_sweep(Y, 1, model='lsm',
                                                  device='cpu')
    cfg = sweep.cfg
    cc = sweeps.build_cc_dict(
        sweeps.SweepConfig(n_control=6), None, sweep_cc(Y, 6),
        cc_state.ctrl_in, cc_state.ctrl_out)
    X, b = cc_state.X, cc_state.intercept
    net_cc = sweeps._network_loglik(cfg, None, None, b, None, X, cc)
    net_dense = sweeps._network_loglik(cfg, _t(Y), pairwise_distances(X),
                                       b, None)
    assert float(cc_state.logp[0]) != float(dense_state.logp[0])
    np.testing.assert_allclose(
        float(cc_state.logp[0] - net_cc[0]),
        float(dense_state.logp[0] - net_dense[0]), atol=1e-4)


def _cc_log_joint(model, cfg, state, cc):
    prior = np.zeros(state.intercept.shape[1], np.float32)
    if model == 'lsm':
        return sweeps._lsm_logp(cfg, None, state.X, state.intercept,
                                state.radii, None, torch.as_tensor(prior),
                                cc=cc)
    if model == 'lpcm':
        return sweeps.lpcm_logp_at_state(
            cfg, None, prior, state.X, state.intercept, state.z, state.mu,
            state.sigma, state.lmbda, state.init_weights,
            state.trans_weights, state.mean_var, state.b_scale,
            radii=state.radii, cc=cc)
    return sweeps.hdp_logp_at_state(
        cfg, None, prior, state.X, state.intercept, state.z, state.mu,
        state.sigma, state.lmbda, state.weights, state.beta, state.gamma,
        state.alpha_init, state.alpha, state.kappa, state.mean_var,
        state.b_scale, radii=state.radii, cc=cc)


@pytest.mark.parametrize('missing', [False, True])
@pytest.mark.parametrize('model', ['hdp', 'lpcm', 'lsm'])
@pytest.mark.parametrize('directed', [False, True])
def test_sweep_logp_is_the_cc_log_joint(directed, model, missing):
    """After 4 sweeps every chain's logp is the case-control log joint of
    its state recomputed from scratch (with missing dyads, on the edge
    lists of its own network), as chip_smoke.py checks on the card."""
    Y = northstar_network(T=3, n=40, seed=6, directed=directed)
    if missing:
        Y = with_missing_dyads(Y, 0.1, seed=3, directed=directed)
    state, sweep, gen = build_state_and_sweep(
        Y, 3, K=4, model=model, device='cpu', is_directed=directed,
        n_control=8)
    for _ in range(4):
        state = sweep(state, gen)
    cfg = sweep.cfg
    from dynetlsm_tpu_torch.models.base import case_control_static
    lists = pcc.build_edge_lists(np.where(Y < 0, 0, Y))
    miss = (Y < 0) if missing else None
    cc_static, _ = case_control_static(
        cfg, lists, 40, 'cpu', 0, 7, miss_mask=miss,
        max_deg=39 if missing else None)
    cc = sweeps.build_cc_dict(cfg, state.Y, cc_static, state.ctrl_in,
                              state.ctrl_out)
    want = _cc_log_joint(model, cfg, state, cc)
    assert torch.isfinite(state.logp).all()
    np.testing.assert_allclose(state.logp.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-3)


def test_tempering_with_n_control_raises_the_jax_error():
    """Parallel tempering refuses the case-control likelihood with the
    JAX package's ValueError (tempering.py:145-148)."""
    with pytest.raises(ValueError) as jax_err:
        jax_tempering.make_pt_step(lambda s, k: s,
                                   JaxSweepConfig(n_control=5), None, 4)
    with pytest.raises(ValueError) as err:
        make_pt_step(lambda s, g: s, sweeps.SweepConfig(n_control=5), None,
                     4)
    assert str(err.value) == str(jax_err.value)
    Y = northstar_network(T=2, n=16, seed=4)
    with pytest.raises(ValueError, match='case-control'):
        build_state_and_sweep(Y, 4, model='lsm', device='cpu', n_control=5,
                              n_temps=2)


# ---------------------------------------------------------------------------
# the large-n generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('directed', [True, False])
def test_northstar_edge_lists_draws_the_bench_model(directed):
    """At n = 2,000 the port's generator and bench.py's give the same
    communities and block-pair edge counts within 4 binomial standard
    deviations of each other; no duplicate edge or self-loop; undirected
    lists symmetric; degrees equal the lists' lengths."""
    import bench
    n, T_ = 2000, 3
    got, shape = northstar_edge_lists(T=T_, n=n, directed=directed)
    want, _ = bench.northstar_edge_lists(T=T_, n=n, directed=directed)
    assert shape == (T_, n)
    z = np.random.RandomState(3).randint(0, 8, size=n)
    size = np.bincount(z, minlength=8)
    scale = 500.0 / n

    def edges(lists):
        t, i, k = np.nonzero(lists['out_edges'] >= 0)
        return t, i, lists['out_edges'][t, i, k]

    counts = []
    for lists in (got, want):
        t, i, j = edges(lists)
        assert (i != j).all()
        key = (t * n + i) * n + j
        assert np.unique(key).size == key.size
        np.testing.assert_array_equal(
            (lists['out_edges'] >= 0).sum(-1), lists['degrees'][..., 1])
        np.testing.assert_array_equal(
            (lists['in_edges'] >= 0).sum(-1), lists['degrees'][..., 0])
        if not directed:
            assert np.isin((t * n + j) * n + i, key).all()
        c = np.zeros((T_, 8, 8))
        np.add.at(c, (t, z[i], z[j]), 1)
        counts.append(c)
    p = np.where(np.eye(8, dtype=bool), 0.1, 0.01) * scale
    pairs = size[:, None] * size[None, :]
    sd = np.sqrt(pairs * p * (1 - p))
    assert (np.abs(counts[0] - counts[1]) < 4 * np.sqrt(2) * sd + 1).all()
    if directed:
        assert (np.abs(counts[0] - pairs * p) < 4 * sd + 1).all()


@pytest.mark.parametrize('directed', [True, False])
def test_full_evaluator_candidates_equal_single_calls(directed):
    """K intercept candidates scored on one set of distances (the
    coefficient steps' form) equal K single-candidate calls."""
    rng = np.random.RandomState(50 + directed)
    Y, X, radii, b, lists, ci, co, civ, cov = _eval_inputs(rng, directed)
    li = _long(lists)
    cands = _t(b[:, :1] + rng.randn(C, 3).astype(np.float32))
    args = (li['out_edges'], li['degrees'] if directed
            else li['degrees'][..., 1], _t(co, torch.int64),
            _t(cov, torch.bool))
    if directed:
        out_b = _t(np.tile(b[:, 1:], (1, 3)))
        got = pcc.approx_directed_loglik_full(_t(X), _t(radii), *args,
                                              cands, out_b)
        want = [pcc.approx_directed_loglik_full(_t(X), _t(radii), *args,
                                                cands[:, k], out_b[:, k])
                for k in range(3)]
    else:
        got = pcc.approx_undirected_loglik_full(_t(X), *args, cands)
        want = [pcc.approx_undirected_loglik_full(_t(X), *args, cands[:, k])
                for k in range(3)]
    assert got.shape == (C, 3)
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                               rtol=1e-6)
