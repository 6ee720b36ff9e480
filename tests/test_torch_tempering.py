"""The port's parallel tempering (dynetlsm_tpu_torch/mcmc/tempering.py)
against the JAX package's (dynetlsm_tpu/mcmc/tempering.py), on the HDP-LPCM
(undirected) and the LSM (directed), T=3, n=12.

* The ladder and the swap partners are compared exactly, the ladder
  adaptation at rtol 1e-6 (float32 logs and exps in another order).
* The replica swap is deterministic given its uniforms: both packages'
  ``make_pt_step`` wrap an identity sweep, so one step is one swap, and
  JAX's uniforms ``jax.random.uniform(fold_in(key[0], 0x7e3a), (C,))`` are
  replayed into the port as ``log_u``.  The swap's log-likelihoods and
  deltas agree to rtol 1e-5 (plus atol 1e-5 times the largest |ll| for the
  delta, a difference of two float32 sums); decisions are compared where
  |delta - log_u| > 1e-3, and the permuted fields, ``acc_swap`` and the
  ladder exactly there (gathers of the same numbers).
* One PT step (sweep and swap) from one replicated state is compared by
  distribution: over 512 slots = 128 ladders x 4 rungs, the per-rung
  marginals of the log joint, the intercept(s) and the mean latent
  acceptance pass a two-sample Kolmogorov-Smirnov test at level 1e-3 each
  (fixed seeds, so the outcome is deterministic), and the hot rung
  (beta = 0.2) of 1024 port ladders differs from an untempered port sweep
  at that level.
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from dynetlsm_tpu.mcmc import tempering as jtemp
from dynetlsm_tpu.mcmc.sweeps import (
    SweepConfig as JaxSweepConfig, _network_loglik as jax_network_loglik,
    make_hdp_sweep as jax_make_hdp_sweep, make_lsm_sweep as jax_make_lsm_sweep)
from dynetlsm_tpu.ops.distances import (
    pairwise_distances as jax_pairwise_distances)

from dynetlsm_tpu_torch.mcmc import tempering as ttemp
from dynetlsm_tpu_torch.mcmc.states import state_from_numpy, state_to_numpy
from dynetlsm_tpu_torch.mcmc.sweeps import (
    SweepConfig, _lsm_logp, _network_loglik, hdp_logp_at_state,
    make_hdp_sweep, make_lsm_sweep)
from dynetlsm_tpu_torch.ops.distances import pairwise_distances
from dynetlsm_tpu_torch.ops.pair_loglik import pair_loglik

from tests.test_torch_lsm_sweep import _cfg as lsm_cfg
from tests.test_torch_lsm_sweep import _problem as lsm_problem
from tests.test_torch_sweep import CFG as HDP_CFG
from tests.test_torch_sweep import _problem as hdp_problem

N_TEMPS, BETA_MIN = 4, 0.2
N_LADDERS = 128
LEVEL = 1e-3
MARGIN = 1e-3
MODELS = ('hdp', 'lsm directed')


def _to_numpy(jax_state):
    return {k: np.asarray(v) for k, v in jax_state._asdict().items()
            if v is not None and k != 'key'}


def _model(name):
    """(Y, prior, single-chain JAX state, JAX config, port config, JAX
    sweep factory, port sweep factory) of the HDP-LPCM (undirected) or the
    LSM (directed)."""
    if name == 'hdp':
        Y, s0 = hdp_problem()
        return (Y, np.zeros(1, np.float32), s0, JaxSweepConfig(**HDP_CFG),
                SweepConfig(**HDP_CFG), jax_make_hdp_sweep, make_hdp_sweep)
    Y, prior, s0 = lsm_problem(True)
    return (Y, prior, s0, JaxSweepConfig(**lsm_cfg(True)),
            SweepConfig(**lsm_cfg(True)), jax_make_lsm_sweep, make_lsm_sweep)


def _jax_sweep(name, make, Y, prior, cfg):
    return make(jnp.asarray(Y), None, prior, cfg)


def _port_sweep(make, Y, prior, cfg):
    return make(Y, prior, cfg, device='cpu')


def _jax_ll(cfg, Y, d):
    """JAX's untempered network log-likelihood of every slot of the NumPy
    state ``d`` (the swap's ``net_ll``)."""
    Yj = jnp.asarray(Y)
    if cfg.is_directed:
        return np.asarray(jax.vmap(
            lambda X, b, r: jax_network_loglik(
                cfg, Yj, jax_pairwise_distances(X), b, r))(
            jnp.asarray(d['X']), jnp.asarray(d['intercept']),
            jnp.asarray(d['radii'])))
    return np.asarray(jax.vmap(
        lambda X, b: jax_network_loglik(cfg, Yj, jax_pairwise_distances(X),
                                        b, None))(
        jnp.asarray(d['X']), jnp.asarray(d['intercept'])))


# ---------------------------------------------------------------------------
# (a) ladder, partners, adaptation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n_temps, beta_min, n_ladders', [
    (4, 0.2, 8), (5, 0.1, 3), (2, 0.5, 1), (10, 0.01, 2)])
def test_temper_ladder_matches_jax(n_temps, beta_min, n_ladders):
    want = np.asarray(jtemp.temper_ladder(n_temps, beta_min, n_ladders))
    got = ttemp.temper_ladder(n_temps, beta_min, n_ladders)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('n_chains, n_temps', [
    (8, 4), (15, 5), (6, 3), (4, 2), (32, 4), (14, 7)])
def test_swap_partners_match_jax(n_chains, n_temps):
    want = jtemp._swap_partners(n_chains, n_temps)
    got = ttemp._swap_partners(n_chains, n_temps)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy()[g.numpy()],
                                      np.arange(n_chains))


def test_ladder_and_partner_errors():
    with pytest.raises(ValueError, match='n_temps >= 2'):
        ttemp.temper_ladder(1)
    with pytest.raises(ValueError, match='whole number'):
        ttemp._swap_partners(10, 4)


@pytest.mark.parametrize('n_temps, n_ladders, n_attempts', [
    (4, 2, 10.0), (5, 3, 25.0), (3, 1, 0.5)])
def test_adapt_ladder_matches_jax(n_temps, n_ladders, n_attempts):
    rng = np.random.RandomState(n_temps)
    betas = np.array(jtemp.temper_ladder(n_temps, 0.1, n_ladders))
    acc = rng.randint(0, int(max(n_attempts, 1.0)) + 1,
                      n_temps * n_ladders).astype(np.float32)
    want = np.asarray(jtemp._adapt_ladder(jnp.asarray(betas),
                                          jnp.asarray(acc), n_temps,
                                          n_attempts))
    got = ttemp._adapt_ladder(torch.as_tensor(betas), torch.as_tensor(acc),
                              n_temps, n_attempts)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got.numpy()[::n_temps], 1.0, rtol=1e-6)


def test_replicate_tempered():
    _, _, s0, *_ = _model('hdp')
    single = {k: v for k, v in _to_numpy(s0).items()}
    betas = ttemp.temper_ladder(N_TEMPS, BETA_MIN, 2)
    s = ttemp.replicate_tempered(single, betas, 'cpu')
    assert tuple(s.X.shape[:1]) == (8,)
    assert torch.equal(s.temper, betas)
    assert torch.equal(s.acc_swap, torch.zeros(8))


# ---------------------------------------------------------------------------
# (b), (c), (d): the swap on slots with differing configurations
# ---------------------------------------------------------------------------

_SWAPS = {}


def swap_problem(name):
    """A 2-ladder x 4-rung state whose slots hold differing configurations
    (positions +0.1 N(0, 1), every other float field scaled by
    1 + 0.05 N(0, 1), random labels), as NumPy arrays with the ladder."""
    if name not in _SWAPS:
        Y, prior, s0, cfg_j, cfg_t, _, make_t = _model(name)
        C = 2 * N_TEMPS
        rng = np.random.RandomState(7)
        state = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (C,) + jnp.shape(x)), s0)
        d = _to_numpy(state)
        for k, v in d.items():
            if k == 'X':
                d[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
            elif k == 'z':
                d[k] = rng.randint(0, HDP_CFG['n_components'],
                                   v.shape).astype(np.int32)
            elif v.dtype == np.float32:
                d[k] = (v * (1.0 + 0.05 * rng.randn(*v.shape))).astype(
                    np.float32)
        d['logp'] = (-300.0 + rng.randn(C)).astype(np.float32)
        d['temper'] = np.asarray(jtemp.temper_ladder(N_TEMPS, BETA_MIN, 2))
        d['acc_swap'] = rng.randint(0, 5, C).astype(np.float32)
        key = jax.random.PRNGKey(5)
        jstate = state._replace(key=jax.random.split(key, C), **{
            k: jnp.asarray(v) for k, v in d.items()})
        _SWAPS[name] = (Y, cfg_j, cfg_t, make_t, prior, jstate, d)
    return _SWAPS[name]


def _identity_pt_pair(name, it0, **kw):
    """JAX's and the port's make_pt_step around an identity sweep, one step
    each from the same state at sweep index it0, JAX's uniforms replayed.
    Returns (start dict, JAX result dict, port result dict, log_u, the
    port's swap log-likelihoods, cfg_j, Y)."""
    Y, cfg_j, cfg_t, make_t, prior, jstate, d = swap_problem(name)
    C = d['X'].shape[0]
    jstate = jstate._replace(it=jnp.full((C,), it0, jnp.int32))
    start = dict(d, it=np.full(C, it0, np.int32))
    jpt = jtemp.make_pt_step(lambda s, it: s, cfg_j, jnp.asarray(Y), N_TEMPS,
                             **kw)
    jax_out = _to_numpy(jax.jit(jpt)(jstate))
    u = jax.random.uniform(jax.random.fold_in(jstate.key[0], 0x7e3a), (C,))
    log_u = np.log(np.asarray(u))
    Yt = _port_sweep(make_t, Y, prior, cfg_t).Y
    tpt = ttemp.make_pt_step(lambda s, gen: s, cfg_t, Yt, N_TEMPS, **kw)
    port_state = state_from_numpy(start, 'cpu')
    ll_t = ttemp.swap_loglik(cfg_t, Yt, port_state).numpy()
    port_out = state_to_numpy(tpt(port_state, None,
                                  log_u=torch.as_tensor(log_u)))
    return start, jax_out, port_out, log_u, ll_t, cfg_j, Y


def _trusted(start, log_u, ll, partner):
    """Slots whose pair's decision is not a near-tie under JAX's delta."""
    temper = start['temper']
    idx = np.arange(len(partner))
    delta = (temper - temper[partner]) * (ll[partner] - ll)
    margin = np.abs(delta - log_u[np.minimum(idx, partner)])
    return (partner == idx) | (margin > MARGIN), delta


@pytest.mark.parametrize('name', MODELS)
@pytest.mark.parametrize('it0', [0, 1])
def test_swap_matches_jax(name, it0):
    """(b) One swap of each package on the same slots and uniforms: the
    same log-likelihoods and deltas, permutation, permuted fields and
    acc_swap; the slot's other fields stay."""
    start, jax_out, port_out, log_u, ll_t, cfg_j, Y = _identity_pt_pair(
        name, it0)
    ll_j = _jax_ll(cfg_j, Y, start)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-5)
    partner = np.asarray(jtemp._swap_partners(len(ll_j), N_TEMPS)[it0 % 2])
    ok, delta_j = _trusted(start, log_u, ll_j, partner)
    _, delta_t = _trusted(start, log_u, ll_t, partner)
    np.testing.assert_allclose(delta_t, delta_j, rtol=1e-5,
                               atol=1e-5 * np.abs(ll_j).max())
    assert ok.sum() >= len(ok) - 2
    moved = ~np.all(jax_out['X'] == start['X'], axis=(1, 2, 3))
    assert moved[ok].any() and (~moved[ok]).any()
    assert set(port_out) == set(jax_out)
    for k, want in jax_out.items():
        if k in ttemp._SWAP_FIELDS:
            np.testing.assert_array_equal(port_out[k][ok], want[ok],
                                          err_msg=k)
        elif k != 'acc_swap':
            np.testing.assert_array_equal(port_out[k], start[k], err_msg=k)
            np.testing.assert_array_equal(want, start[k], err_msg=k)
    np.testing.assert_array_equal(port_out['acc_swap'][ok],
                                  jax_out['acc_swap'][ok])


@pytest.mark.parametrize('swap_every, adapt_until, adapt_interval, it0', [
    (2, 0, 100, 0), (2, 0, 100, 1), (2, 0, 100, 3), (1, 10, 2, 1),
    (1, 10, 2, 2), (1, 10, 2, 11)])
def test_swap_masks_match_jax(swap_every, adapt_until, adapt_interval, it0):
    """(b) ``swap_every`` and the adaptation window, as device-side masks:
    the same rounds swap (phase ``(it0 // swap_every) % 2``) and the same
    sweeps adapt the ladder (rtol 1e-6) as in JAX."""
    start, jax_out, port_out, log_u, _, cfg_j, Y = _identity_pt_pair(
        'hdp', it0, swap_every=swap_every, adapt_until=adapt_until,
        adapt_interval=adapt_interval)
    ll_j = _jax_ll(cfg_j, Y, start)
    phase = (it0 // swap_every) % 2
    partner = np.asarray(jtemp._swap_partners(len(ll_j), N_TEMPS)[phase])
    ok, _ = _trusted(start, log_u, ll_j, partner)
    swapped = ((it0 + 1) % swap_every) == 0
    adapted = it0 < adapt_until and (it0 + 1) % adapt_interval == 0
    assert swapped == (not np.array_equal(jax_out['X'], start['X']))
    for k in ('X', 'intercept', 'z', 'mu', 'logp'):
        np.testing.assert_array_equal(port_out[k][ok], jax_out[k][ok],
                                      err_msg=k)
    np.testing.assert_allclose(port_out['temper'], jax_out['temper'],
                               rtol=1e-6)
    assert adapted == (not np.array_equal(jax_out['temper'],
                                          start['temper']))
    if adapted:
        assert not jax_out['acc_swap'].any()
    np.testing.assert_array_equal(port_out['acc_swap'][ok],
                                  jax_out['acc_swap'][ok])


@pytest.mark.parametrize('name', MODELS)
def test_equal_temperatures_swap_every_pair(name):
    """(c) At equal temperatures delta is 0 > log_u, so every pair swaps:
    the configuration moves to the partner slot, the slot's fields stay,
    and each pair head counts one swap."""
    Y, _, cfg_t, make_t, prior, _, d = swap_problem(name)
    d = dict(d, temper=np.ones_like(d['temper']))
    Yt = _port_sweep(make_t, Y, prior, cfg_t).Y
    pt = ttemp.make_pt_step(lambda s, gen: s, cfg_t, Yt, N_TEMPS)
    start = state_from_numpy(d, 'cpu')
    out = state_to_numpy(pt(start, torch.Generator().manual_seed(0)))
    partner = ttemp._swap_partners(len(d['temper']), N_TEMPS)[0].numpy()
    assert (partner != np.arange(len(partner))).all()
    for k, v in d.items():
        want = v[partner] if k in ttemp._SWAP_FIELDS else v
        if k == 'acc_swap':
            want = v + (partner > np.arange(len(partner)))
        np.testing.assert_array_equal(out[k], want, err_msg=k)


@pytest.mark.parametrize('name', MODELS)
def test_swap_loglik_is_the_dense_network_loglik(name):
    """(d) The swap's log-likelihood from the kernels' plain versions (pair
    kernel at one intercept, one dir_loglik candidate) equals the dense
    network log-likelihood, rtol 1e-5; undirected it is, bit for bit, what
    the two-candidate pair call gave at b_cur = b_prop."""
    Y, _, cfg_t, make_t, prior, _, d = swap_problem(name)
    Yt = _port_sweep(make_t, Y, prior, cfg_t).Y
    s = state_from_numpy(d, 'cpu')
    got = ttemp.swap_loglik(cfg_t, Yt, s)
    want = _network_loglik(cfg_t, torch.as_tensor(Y), pairwise_distances(s.X),
                           s.intercept, s.radii)
    assert got.dtype == torch.float32 and got.shape == (len(d['logp']),)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    if not cfg_t.is_directed:
        b = s.intercept[:, 0].contiguous()
        assert torch.equal(got, pair_loglik(Yt, s.X, b, b)[:, 0])


# ---------------------------------------------------------------------------
# (e), (f), (g): one PT step with the real sweeps, 128 ladders x 4 rungs
# ---------------------------------------------------------------------------

_PT = {}


def one_pt_step_each(name):
    """One JAX PT step (one CPU compile per model) and one port PT step from
    the same replicated tempered start."""
    if name not in _PT:
        Y, prior, s0, cfg_j, cfg_t, make_j, make_t = _model(name)
        betas = jtemp.temper_ladder(N_TEMPS, BETA_MIN, N_LADDERS)
        state = jtemp.replicate_tempered(s0, betas, jax.random.PRNGKey(11))
        jpt = jtemp.make_pt_step(_jax_sweep(name, make_j, Y, prior, cfg_j),
                                 cfg_j, jnp.asarray(Y), N_TEMPS)
        jax_out = _to_numpy(jax.jit(jpt)(state))
        sweep = _port_sweep(make_t, Y, prior, cfg_t)
        tpt = ttemp.make_pt_step(sweep, cfg_t, sweep.Y, N_TEMPS)
        port_out = state_to_numpy(tpt(state_from_numpy(_to_numpy(state),
                                                        'cpu'),
                                      torch.Generator().manual_seed(12)))
        _PT[name] = (Y, prior, cfg_t, jax_out, port_out)
    return _PT[name]


def _summaries(d):
    out = {'logp': d['logp'], 'intercept_0': d['intercept'][:, 0],
           'acc_X': d['acc_X'].mean(axis=(1, 2))}
    if d['intercept'].shape[1] > 1:
        out['intercept_1'] = d['intercept'][:, 1]
    return out


_MARGINALS = [(m, r, s) for m in MODELS for r in range(N_TEMPS)
              for s in ('logp', 'intercept_0', 'acc_X')] + [
    ('lsm directed', r, 'intercept_1') for r in range(N_TEMPS)]


@pytest.mark.parametrize('name, rung, stat', _MARGINALS)
def test_one_pt_step_matches_jax_in_distribution(name, rung, stat):
    """(e) Per rung, the one-step marginals of JAX's and the port's PT
    step agree (two-sample KS, level 1e-3)."""
    _, _, _, jax_out, port_out = one_pt_step_each(name)
    assert (port_out['it'] == 1).all() and (jax_out['it'] == 1).all()
    np.testing.assert_array_equal(port_out['temper'], jax_out['temper'])
    a = _summaries(jax_out)[stat][rung::N_TEMPS]
    b = _summaries(port_out)[stat][rung::N_TEMPS]
    assert len(a) == len(b) == N_LADDERS
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.std(a) > 0 and np.std(b) > 0
    p = stats.ks_2samp(a, b).pvalue
    assert p > LEVEL, '%s rung %d %s: KS p = %g (jax mean %g, port mean %g)' \
        % (name, rung, stat, p, a.mean(), b.mean())


_HOT = {}


def hot_and_plain(name, n_ladders=1024):
    """The hot rung (beta = 0.2) of one port PT step over ``n_ladders``
    ladders, and one untempered port sweep of as many chains as the PT step
    has slots, from the same start (port only, so many ladders are cheap)."""
    if name not in _HOT:
        Y, prior, s0, _, cfg_t, _, make_t = _model(name)
        sweep = _port_sweep(make_t, Y, prior, cfg_t)
        start = ttemp.replicate_tempered(
            _to_numpy(s0), ttemp.temper_ladder(N_TEMPS, BETA_MIN, n_ladders),
            'cpu')
        pt = ttemp.make_pt_step(sweep, cfg_t, sweep.Y, N_TEMPS)
        out = state_to_numpy(pt(start, torch.Generator().manual_seed(12)))
        plain = state_to_numpy(sweep(start.replace(temper=None,
                                                   acc_swap=None),
                                     torch.Generator().manual_seed(13)))
        hot = {k: v[N_TEMPS - 1::N_TEMPS] for k, v in out.items()}
        _HOT[name] = (hot, plain)
    return _HOT[name]


@pytest.mark.parametrize('name', MODELS)
@pytest.mark.parametrize('stat', ['acc_X', 'intercept'])
def test_hot_rung_is_tempered(name, stat):
    """(f) The hot rung (beta = 0.2) moves more than an untempered sweep
    from the same start: its latent acceptance and its intercept(s) (from
    the start at 1.0, which the network pulls down) differ, KS p < 1e-3.
    The temperature reaches the sweep."""
    hot, plain = hot_and_plain(name)
    h = hot[stat].reshape(len(hot[stat]), -1).mean(axis=1)
    p = plain[stat].reshape(len(plain[stat]), -1).mean(axis=1)
    assert h.mean() > p.mean()
    assert stats.ks_2samp(h, p).pvalue < LEVEL


@pytest.mark.parametrize('name', MODELS)
def test_pt_step_logp_is_each_slots_dense_log_joint(name):
    """(g) After the swap every slot's logp is the untempered log joint of
    the configuration it holds (rtol 1e-5)."""
    Y, prior, cfg_t, _, port_out = one_pt_step_each(name)
    s = state_from_numpy(port_out, 'cpu')
    Yt = torch.as_tensor(Y)
    if name == 'hdp':
        dense = hdp_logp_at_state(
            cfg_t, Yt, prior, s.X, s.intercept, s.z, s.mu, s.sigma, s.lmbda,
            s.weights, s.beta, s.gamma, s.alpha_init, s.alpha, s.kappa,
            s.mean_var, s.b_scale)
    else:
        dense = _lsm_logp(cfg_t, Yt, s.X, s.intercept, s.radii,
                          pairwise_distances(s.X), torch.as_tensor(prior))
    np.testing.assert_allclose(port_out['logp'], dense.numpy(), rtol=1e-5)
    assert port_out['acc_swap'].sum() > 0


def test_cold_slot_helpers():
    """cold_slot_trace_fn and strip_hot_slots keep slot 0 of each ladder
    block, as models/base.py's do."""
    _, _, _, _, port_out = one_pt_step_each('hdp')
    s = state_from_numpy(port_out, 'cpu')
    trace = ttemp.cold_slot_trace_fn(lambda q: {'logp': q.logp}, N_TEMPS)
    np.testing.assert_array_equal(trace(s)['logp'].numpy(),
                                  port_out['logp'][::N_TEMPS])
    cold, ladder = ttemp.strip_hot_slots(s, N_TEMPS)
    np.testing.assert_array_equal(ladder, port_out['temper'])
    for f in dataclasses.fields(cold):
        v = getattr(cold, f.name)
        if v is not None:
            np.testing.assert_array_equal(v.numpy(),
                                          port_out[f.name][::N_TEMPS])
    same, no_ladder = ttemp.strip_hot_slots(s, None)
    assert same is s and no_ladder is None
    assert ttemp.cold_slot_trace_fn(trace, 1) is trace
