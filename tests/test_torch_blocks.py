"""The port's Gibbs blocks against the JAX package's, on one shared
chain-batched state made with numpy.

Deterministic blocks are compared directly.  A sampling block is split in
the port into a draw and a deterministic core (``*_from_draws``); the core
is fed the numbers the JAX block drew, replayed here from the JAX key by
splitting it as the block does.  Tolerance rtol 1e-5 (float32 arithmetic
in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynetlsm_tpu.math import distributions as jdist
from dynetlsm_tpu.mcmc import conjugate as jconj
from dynetlsm_tpu.mcmc import hdp as jhdp
from dynetlsm_tpu.mcmc import labels as jlabels
from dynetlsm_tpu.mcmc import metropolis as jmetro
from dynetlsm_tpu.mcmc import sweeps as jsweeps
from dynetlsm_tpu.ops import emissions as jemit

from dynetlsm_tpu_torch.math import distributions as tdist
from dynetlsm_tpu_torch.mcmc import conjugate as tconj
from dynetlsm_tpu_torch.mcmc import hdp as thdp
from dynetlsm_tpu_torch.mcmc import labels as tlabels
from dynetlsm_tpu_torch.mcmc import metropolis as tmetro
from dynetlsm_tpu_torch.mcmc import sweeps as tsweeps
from dynetlsm_tpu_torch.ops import emissions as temit

C, T, N, K, D = 3, 3, 12, 4, 2
RTOL = 1e-5
A, A0, B0, C0, D0 = 2.0, 36.0, 40.0, 5.0, 2.0


def _shared_state(seed=0):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    w = np.zeros((C, T, K, K))
    w[:, 0, 0] = rng.dirichlet(np.ones(K), size=C)
    w[:, 1:] = rng.dirichlet(np.ones(K), size=(C, T - 1, K))
    Y = rng.binomial(1, 0.3, (T, N, N)).astype(f32)
    Y = np.triu(Y, 1)
    return dict(
        Y=Y + Y.transpose(0, 2, 1),
        X=rng.randn(C, T, N, D).astype(f32),
        z=rng.randint(0, K, (C, T, N)),
        mu=rng.randn(C, K, D).astype(f32),
        sigma=(rng.rand(C, K) + 0.5).astype(f32),
        lmbda=(0.7 + 0.2 * rng.rand(C)).astype(f32),
        weights=w.astype(f32),
        beta=rng.dirichlet(np.ones(K), size=C).astype(f32),
        gamma=(1.0 + rng.rand(C)).astype(f32),
        alpha_init=(1.0 + rng.rand(C)).astype(f32),
        alpha=(1.0 + rng.rand(C)).astype(f32),
        kappa=(2.0 + rng.rand(C)).astype(f32),
        mean_var=(0.5 + rng.rand(C)).astype(f32),
        b_scale=(1.0 + rng.rand(C)).astype(f32),
        intercept=(1.0 + 0.3 * rng.randn(C, 1)).astype(f32))


S = _shared_state()


def j(name, dtype=None):
    return jnp.asarray(S[name], dtype)


def t(name):
    return torch.as_tensor(S[name])


def keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), C)


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def jax_stats():
    return jax.vmap(lambda z: jlabels._label_statistics(z, K))(
        j('z', jnp.int32))


def gamma_draws_like_jax(ks, shape, n_rounds=2):
    """Replay sample_gamma_fixed's draws (math/distributions.py:35-59) for
    per-chain keys; returns the port's (normals, uniforms, boost) with the
    chain axis after the round axis."""
    def one(key):
        k_mt, k_b = jax.random.split(key)
        k_x, k_u = jax.random.split(k_mt)
        xs = jax.random.normal(k_x, (n_rounds,) + shape)
        us = jax.random.uniform(k_u, (n_rounds,) + shape, minval=1e-20)
        ub = jax.random.uniform(k_b, shape, minval=1e-20)
        return xs, us, ub
    xs, us, ub = jax.vmap(one)(ks)
    return (torch.tensor(np.asarray(xs)).transpose(0, 1).contiguous(),
            torch.tensor(np.asarray(us)).transpose(0, 1).contiguous(),
            torch.tensor(np.asarray(ub)))


# ---------------------------------------------------------------------------
# deterministic blocks
# ---------------------------------------------------------------------------

def test_emissions():
    want = jax.vmap(jemit.emission_logliks_kn)(j('X'), j('mu'), j('sigma'),
                                               j('lmbda'))
    got = temit.emission_logliks_kn(t('X'), t('mu'), t('sigma'), t('lmbda'))
    close(got, want, atol=1e-5)
    want = jax.vmap(jemit.emission_likelihoods_kn)(
        j('X'), j('mu'), j('sigma'), j('lmbda'))
    got = temit.emission_likelihoods_kn(t('X'), t('mu'), t('sigma'),
                                        t('lmbda'))
    close(got, want, atol=1e-6)


def test_backward_messages():
    lik = jax.vmap(jemit.emission_likelihoods_kn)(
        j('X'), j('mu'), j('sigma'), j('lmbda'))
    want = jax.vmap(jlabels._backward_messages)(lik, j('weights'))
    got = tlabels._backward_messages(torch.tensor(np.asarray(lik)),
                                     t('weights'))
    close(got, want, atol=1e-7)


def test_forward_sample_replayed():
    lik = jax.vmap(jemit.emission_likelihoods_kn)(
        j('X'), j('mu'), j('sigma'), j('lmbda'))
    pm = jax.vmap(jlabels._backward_messages)(lik, j('weights'))
    ks = keys(1)
    w = j('weights')
    want = jax.vmap(jlabels._forward_sample)(ks, pm, w[:, 0, 0], w)
    g = jax.vmap(lambda k: jax.vmap(
        lambda kt: jax.random.gumbel(kt, (K, N)))(jax.random.split(k, T)))(ks)
    got = tlabels._forward_sample_from_gumbel(
        torch.tensor(np.asarray(pm)), t('weights')[:, 0, 0], t('weights'),
        torch.tensor(np.asarray(g)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_label_statistics():
    want = jax_stats()
    got = tlabels._label_statistics(t('z'), K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dirichlet_logpdf():
    alphas = S['beta'] * 3.0 + 0.2
    want = jdist.dirichlet_logpdf(j('weights')[:, 1:], jnp.asarray(alphas)
                                  [:, None, None, :])
    got = tdist.dirichlet_logpdf(
        t('weights')[:, 1:], torch.as_tensor(alphas)[:, None, None, :])
    close(got, want)


def test_tune_step_size():
    rate = np.array([0.0, 0.01, 0.1, 0.3, 0.5, 0.8, 0.99], np.float32)
    step = np.full_like(rate, 0.2)
    close(tmetro.tune_step_size_random_walk(torch.as_tensor(step),
                                            torch.as_tensor(rate)),
          jmetro.tune_step_size_random_walk(jnp.asarray(step),
                                            jnp.asarray(rate)))


def test_maybe_tune():
    """Tuning fires per chain only where its window closes inside the
    tuning phase (it = 49 and 99 here, not 50 or 149)."""
    it = np.array([49, 50, 99, 149], np.int32)
    step = np.full((4, T, N), 0.2, np.float32)
    acc = np.random.RandomState(1).randint(0, 51, (4, T, N)).astype(
        np.float32)
    want = jax.vmap(lambda i, s, a: jmetro.maybe_tune(i, 120, 50, s, a))(
        jnp.asarray(it), jnp.asarray(step), jnp.asarray(acc))
    got = tmetro.maybe_tune(torch.as_tensor(it).long(),
                            120, 50, torch.as_tensor(step),
                            torch.as_tensor(acc))
    for g, w in zip(got, want):
        close(g, w)
    assert not torch.equal(got[0][0], got[0][1])


def test_tune_step_size_dirichlet():
    rate = np.array([0.0, 0.01, 0.1, 0.3, 0.5, 0.8, 0.99], np.float32)
    step = np.full_like(rate, 175000.0)
    close(tmetro.tune_step_size_dirichlet(torch.as_tensor(step),
                                          torch.as_tensor(rate)),
          jmetro.tune_step_size_dirichlet(jnp.asarray(step),
                                          jnp.asarray(rate)))


def test_maybe_tune_dirichlet():
    """The radii's scalar step per chain under the inverted schedule."""
    it = np.array([49, 50, 99, 149], np.int32)
    step = np.full(4, 175000.0, np.float32)
    acc = np.array([0.0, 3.0, 49.0, 10.0], np.float32)
    want = jax.vmap(lambda i, s, a: jmetro.maybe_tune(
        i, 120, 50, s, a, kind='dirichlet'))(
        jnp.asarray(it), jnp.asarray(step), jnp.asarray(acc))
    got = tmetro.maybe_tune(torch.as_tensor(it).long(), 120, 50,
                            torch.as_tensor(step), torch.as_tensor(acc),
                            kind='dirichlet')
    for g, w in zip(got, want):
        close(g, w)
    assert float(got[0][0]) == 1750000.0 and float(got[0][2]) == 17500.0


def _dirichlet_move(step=175000.0, seed=5, n=N):
    """A radii-like x0 (C, n) on the simplex, a Dirichlet(step * x0)
    proposal x, log densities at both and the per-chain step."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    x0 = rng.dirichlet(np.full(n, 5.0), size=C).astype(f32)
    x = np.stack([rng.dirichlet(step * x0[c].astype(np.float64))
                  for c in range(C)]).astype(f32)
    lc = (-500.0 + 10.0 * rng.randn(C)).astype(f32)
    lp = (lc + rng.randn(C)).astype(f32)
    return x0, x, lc, lp, np.full(C, step, f32)


def _jax_dirichlet_ratio(x0, x, lc, lp, s, temper=None):
    """The ratio of dynetlsm_tpu/mcmc/metropolis.py::
    dirichlet_metropolis_step in its op order, per chain: untempered, or
    with the target difference times ``temper`` (C,)."""
    def one(x0, x, lc, lp, s, t):
        ratio = lp - lc
        if temper is not None:
            ratio = t * ratio
        ratio += (jdist.dirichlet_logpdf(x0, s * x)
                  - jdist.dirichlet_logpdf(x, s * x0))
        return ratio
    t = np.ones_like(lc) if temper is None else temper
    return np.asarray(jax.vmap(one)(x0, x, lc, lp, s, t))


@pytest.mark.parametrize('step', [175000.0, 1750.0])
def test_dirichlet_mh_ratio_matches_jax_formula(step):
    """Target difference plus proposal-asymmetry correction at the radii's
    step 175000 (and a wider proposal), against the JAX formula evaluated
    in float64 (the port evaluates it in float64; see the next test)."""
    move = _dirichlet_move(step=step)
    with jax.enable_x64(True):
        want = _jax_dirichlet_ratio(*(np.asarray(a, np.float64)
                                      for a in move))
    got = tmetro.dirichlet_mh_ratio(*map(torch.as_tensor, move))
    assert got.dtype == torch.float64
    close(got, want)


@pytest.mark.parametrize('n', [N, 500])
def test_dirichlet_mh_ratio_float32_rounding(n):
    """The fault the port repairs: at step 175000 the correction's lgamma
    terms are ~2e6 and cancel to O(1), so the JAX package's float32
    evaluation is off by more than a tenth of a nat (0.1-0.7 nat over
    seeds at n = 12 to 500); the port's is not."""
    move = _dirichlet_move(n=n)
    with jax.enable_x64(True):
        exact = _jax_dirichlet_ratio(*(np.asarray(a, np.float64)
                                       for a in move))
    f32 = _jax_dirichlet_ratio(*move)
    assert np.abs(f32 - exact).max() > 0.1
    got = tmetro.dirichlet_mh_ratio(*map(torch.as_tensor, move)).numpy()
    assert np.abs(got - exact).max() < 1e-6


@pytest.mark.parametrize('step', [175000.0, 1750.0])
def test_tempered_dirichlet_mh_ratio_matches_jax_formula(step):
    """Under tempering the target difference is scaled before the
    asymmetry correction is added (metropolis.py:95-100), both in float64
    here; rtol 1e-5."""
    move = _dirichlet_move(step=step, seed=6)
    temper = np.asarray([1.0, 0.5, 0.2], np.float32)
    with jax.enable_x64(True):
        want = _jax_dirichlet_ratio(*(np.asarray(a, np.float64)
                                      for a in move),
                                    temper=temper.astype(np.float64))
    got = tmetro.dirichlet_mh_ratio(*map(torch.as_tensor, move),
                                    temper=torch.as_tensor(temper))
    assert got.dtype == torch.float64
    close(got, want)
    untempered = tmetro.dirichlet_mh_ratio(*map(torch.as_tensor, move))
    assert float(got[0]) == float(untempered[0])
    assert not np.allclose(got[1:].numpy(), untempered[1:].numpy())


def _directed_coefficient_args(seed=9):
    """A directed problem for the coefficient steps: packed Y, positions,
    intercepts (C, 2), radii on the simplex, step sizes."""
    from dynetlsm_tpu_torch.ops.node_scan import pack_directed
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.3, (T, N, N)).astype(np.uint8)
    Y[:, np.arange(N), np.arange(N)] = 0
    f = np.float32
    return dict(
        Yp=pack_directed(torch.as_tensor(Y)),
        X=torch.as_tensor(0.3 * rng.randn(C, T, N, D).astype(f)),
        intercept=torch.as_tensor((1.0 + 0.2 * rng.randn(C, 2)).astype(f)),
        radii=torch.as_tensor(rng.dirichlet(np.ones(N), size=C).astype(f)),
        step_int=torch.full((C, 2), 0.3), step_radii=torch.full((C,), 500.0))


def _coefficient_steps(temper, seed):
    """The three coefficient samplers from one generator seed."""
    from dynetlsm_tpu_torch.mcmc import coefficients as tcoef
    a = _directed_coefficient_args()
    gen = torch.Generator().manual_seed(seed)
    und = tcoef.sample_intercept_undirected(
        gen, torch.as_tensor(S['Y']).to(torch.uint8), t('X'), t('intercept'),
        torch.full((C, 1), 0.3), 0.0, 2.0, temper=temper)
    new, acc, ll = tcoef.sample_intercepts_directed(
        gen, a['Yp'], a['X'], a['intercept'], a['radii'], a['step_int'],
        [0.0, 0.0], 2.0, temper=temper)
    radii = tcoef.sample_radii(gen, a['Yp'], a['X'], new, a['radii'],
                               a['step_radii'], loglik_cur=ll, temper=temper)
    return und + (new, acc, ll) + radii


def test_temper_one_is_untempered():
    """``temper`` = 1 in every coefficient step (the undirected intercept,
    b_in and b_out, the radii's Dirichlet step) gives exactly the untempered
    results from one generator seed; ``temper`` = 0.2 does not."""
    ones = torch.ones(C)
    for seed in (1, 2, 3):
        for got, want in zip(_coefficient_steps(ones, seed),
                             _coefficient_steps(None, seed)):
            assert torch.equal(got, want)
    hot = [_coefficient_steps(torch.full((C,), 0.2), s) for s in range(4)]
    cold = [_coefficient_steps(None, s) for s in range(4)]
    assert any(not torch.equal(h[i], c[i]) for h, c in zip(hot, cold)
               for i in (1, 4, 7))


def test_hdp_logp_at_state():
    cfg_j = jsweeps.SweepConfig(n_components=K, a0=A0, b0=B0, c0=C0, d0=D0)
    cfg_t = tsweeps.SweepConfig(n_components=K, a0=A0, b0=B0, c0=C0, d0=D0)
    prior = np.zeros(1, np.float32)
    names = ('X', 'intercept', 'z', 'mu', 'sigma', 'lmbda', 'weights',
             'beta', 'gamma', 'alpha_init', 'alpha', 'kappa', 'mean_var',
             'b_scale')
    args_j = [j(nm, jnp.int32 if nm == 'z' else None) for nm in names]
    Y = jnp.asarray(S['Y'])

    def one(X, b, z, mu, sig, lam, w, beta, gam, ai, al, ka, mv, bs):
        return jsweeps.hdp_logp_at_state(
            cfg_j, Y, jnp.asarray(prior), X, b, None, z, mu, sig, lam, w,
            beta, gam, ai, al, ka, mv, bs)

    want = jax.vmap(one)(*args_j)
    got = tsweeps.hdp_logp_at_state(cfg_t, torch.as_tensor(S['Y']), prior,
                                    *[t(nm) for nm in names])
    close(got, want)


# ---------------------------------------------------------------------------
# sampling blocks: JAX draws replayed into the port's cores
# ---------------------------------------------------------------------------

def test_sample_dirichlet_replayed():
    alphas = S['beta'] * 2.0 + 0.1      # exercises the alpha < 1 boost
    ks = keys(2)
    want = jax.vmap(jdist.sample_dirichlet)(ks, jnp.asarray(alphas))
    got = tdist.dirichlet_from_draws(torch.as_tensor(alphas),
                                     gamma_draws_like_jax(ks, (K,)))
    close(got, want)


def test_cluster_means_replayed():
    n_trans, nk, resp = jax_stats()
    ks = keys(3)
    want = jax.vmap(jconj.sample_cluster_means)(
        ks, j('X'), resp, nk, j('sigma'), j('lmbda'), j('mean_var'))
    noise = jax.vmap(lambda k: jax.random.normal(k, (K, D)))(ks)
    _, nk_t, resp_t = tlabels._label_statistics(t('z'), K)
    got = tconj.cluster_means_from_draws(
        t('X'), resp_t, nk_t, t('sigma'), t('lmbda'), t('mean_var'),
        torch.tensor(np.asarray(noise)))
    close(got, want, atol=1e-6)


def test_cluster_variances_replayed():
    _, nk, resp = jax_stats()
    ks = keys(4)
    want = jax.vmap(jconj.sample_cluster_variances,
                    in_axes=(0, 0, 0, 0, 0, 0, None, 0))(
        ks, j('X'), resp, nk, j('mu'), j('lmbda'), A, j('b_scale'))
    _, nk_t, resp_t = tlabels._label_statistics(t('z'), K)
    got = tconj.cluster_variances_from_draws(
        t('X'), resp_t, nk_t, t('mu'), t('lmbda'), A, t('b_scale'),
        gamma_draws_like_jax(ks, (K,)))
    close(got, want)


def test_lambda_replayed():
    _, _, resp = jax_stats()
    ks = keys(5)
    want = jax.vmap(lambda k, X, z, mu, sig, r: jconj.sample_lambda(
        k, X, z, mu, sig, 0.9, 0.01, resp=r))(
        ks, j('X'), j('z', jnp.int32), j('mu'), j('sigma'), resp)
    u = jax.vmap(lambda k: jax.random.uniform(
        k, (), minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))(ks)
    got = tconj.lambda_from_draws(t('X'), t('z'), t('mu'), t('sigma'), 0.9,
                                  0.01, torch.tensor(np.asarray(u)))
    close(got, want)


def test_hyper_priors_replayed():
    ks = keys(6)
    want = jax.vmap(lambda k, mu: jconj.sample_mean_variance_hyper(
        k, mu, A0, B0))(ks, j('mu'))
    got = tconj.mean_variance_from_draws(t('mu'), A0, B0,
                                         gamma_draws_like_jax(ks, ()))
    close(got, want)
    ks = keys(7)
    want = jax.vmap(lambda k, s: jconj.sample_sigma_scale_hyper(
        k, s, A, C0, D0))(ks, j('sigma'))
    got = tconj.sigma_scale_from_draws(t('sigma'), A, C0, D0,
                                       gamma_draws_like_jax(ks, ()))
    close(got, want)


@pytest.mark.parametrize('cap', [4, 64])
def test_tables_and_mbar_replayed(cap):
    """cap=4 < n exercises the Poisson / rounded-Normal tails; cap=64 the
    exact path."""
    n_trans, _, _ = jax_stats()
    ks = keys(8 + cap)
    m_want = jax.vmap(lambda k, nt, b, ai, al, ka: jhdp.sample_tables(
        k, nt, b, ai, al, ka, n_max=N, cap=cap))(
        ks, n_trans, j('beta'), j('alpha_init'), j('alpha'), j('kappa'))
    L = min(cap, N)

    def table_draws(k):
        k_head, k_tail = jax.random.split(k)
        k_u, k_z = jax.random.split(k_tail)
        return (jax.random.uniform(k_head, (L, T * K * K)),
                jax.random.uniform(k_u, (T, K, K)),
                jax.random.normal(k_z, (T, K, K)))

    draws = [torch.tensor(np.asarray(a))
             for a in jax.vmap(table_draws)(ks)]
    n_trans_t, _, _ = tlabels._label_statistics(t('z'), K)
    m_got = thdp.tables_from_draws(n_trans_t, t('beta'), t('alpha_init'),
                                   t('alpha'), t('kappa'), N, cap, draws)
    close(m_got, m_want)
    assert (m_got <= n_trans_t).all() and (m_got.sum() > 0)

    ks = keys(20 + cap)
    mbar_want, w_want = jax.vmap(lambda k, m, b, ka, al: jhdp.sample_mbar(
        k, m, b, ka, al, n_max=N, cap=cap))(
        ks, m_want, j('beta'), j('kappa'), j('alpha'))

    def mbar_draws(k):
        k_head, k_tail = jax.random.split(k)
        return (jax.random.uniform(k_head, (T - 1, K, L)),
                jax.random.normal(k_tail, (T - 1, K)))

    draws = [torch.tensor(np.asarray(a)) for a in jax.vmap(mbar_draws)(ks)]
    mbar_got, w_got = thdp.mbar_from_draws(
        torch.tensor(np.asarray(m_want)), t('beta'), t('kappa'),
        t('alpha'), N, cap, draws)
    close(w_got, w_want)
    close(mbar_got, mbar_want)


def test_fast_poisson_replayed():
    lam = np.array([0.0, 0.3, 1.5, 2.4, 3.0, 7.5, 40.0], np.float32)
    key = jax.random.PRNGKey(9)
    want = jhdp._fast_poisson(key, jnp.asarray(lam))
    k_u, k_z = jax.random.split(key)
    got = thdp._fast_poisson_from_draws(
        torch.as_tensor(lam),
        torch.tensor(np.asarray(jax.random.uniform(k_u, lam.shape))),
        torch.tensor(np.asarray(jax.random.normal(k_z, lam.shape))))
    close(got, want)
