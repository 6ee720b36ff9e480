"""The port's forecasts (``dynetlsm_tpu_torch/ops/forecast.py``) against
the JAX package's, on seeded numpy inputs.

The marginal forecast and its node mixture weights are deterministic:
compared with JAX at rtol 1e-5 (atol 1e-6), with and without the
active-cluster renormalisation, and with the samples cut into many blocks.
The posterior-predictive forecast draws: its step is compared with JAX's
and with the reference-shaped oracle of ``tests/test_forecast.py`` on the
same uniforms and normals (atol 2e-5), and the whole forecast on JAX's own
draws, rebuilt from the key as its scan body splits it and passed as
``u``/``eps`` (atol 2e-5); the degenerate limit (one active cluster, sigma
-> 0) against the plug-in probability on the port's own draws (atol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.distance import pdist, squareform
from scipy.special import expit

from dynetlsm_tpu.ops import forecast as jf
from dynetlsm_tpu_torch.ops import forecast as pf

from .test_forecast import _oracle_pp_step
from .torch_fit_parity import jax_pp_draws


def _samples(rng, S, n, K, d=2, T=3):
    z_full = rng.randint(0, K, size=(S, T, n))
    # a few components unused by every sample: renormalisation matters
    z_full[z_full == K - 1] = 0
    return dict(x=rng.randn(n, d).astype(np.float32),
                x_prev=rng.randn(S, n, d).astype(np.float32),
                z_full=z_full,
                trans=rng.dirichlet(np.ones(K), size=(S, K)).astype(
                    np.float32),
                mu=rng.randn(S, K, d).astype(np.float32),
                sigma=rng.uniform(0.3, 1.5, (S, K)).astype(np.float32),
                b=(rng.randn(S) + 1.0).astype(np.float32),
                lam=rng.uniform(0.5, 0.95, S).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(a, dtype=dtype)


@pytest.mark.parametrize('renormalize', [False, True])
@pytest.mark.parametrize('seed', [0, 1])
def test_node_mixture_weights_match_jax(seed, renormalize):
    a = _samples(np.random.RandomState(seed), 5, 9, 5)
    z = a['z_full'][:, -1]
    got = pf._node_mixture_weights(
        _t(a['x']), _t(a['x_prev']), _t(z, torch.int64), _t(a['trans']),
        _t(a['mu']), _t(a['sigma']), _t(a['lam']), renormalize).numpy()
    for s in range(5):
        want = jf._node_mixture_weights(
            jnp.asarray(a['x']), jnp.asarray(a['x_prev'][s]),
            jnp.asarray(z[s]), jnp.asarray(a['trans'][s]),
            jnp.asarray(a['mu'][s]), jnp.asarray(a['sigma'][s]),
            a['lam'][s], renormalize)
        np.testing.assert_allclose(got[s], np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def _marginal(module, a, renormalize):
    args = (a['x'], a['x_prev'], a['z_full'][:, -1], a['trans'], a['mu'],
            a['sigma'], a['b'], a['lam'])
    return np.asarray(module.marginal_forecast(*args,
                                               renormalize=renormalize))


@pytest.mark.parametrize('blocks', ['one', 'many'])
@pytest.mark.parametrize('renormalize', [False, True])
@pytest.mark.parametrize('seed', [2, 3])
def test_marginal_forecast_matches_jax(monkeypatch, seed, renormalize,
                                       blocks):
    """One block, or a block of 3 samples (the last one short), in float64
    sums: the values of JAX's float32 scan."""
    S, n = 11, 8
    a = _samples(np.random.RandomState(seed), S, n, 6)
    if blocks == 'many':
        monkeypatch.setattr(pf, '_BLOCK_ELEMS', 3 * n * n)
        assert len(pf._sample_blocks(S, n)) == 4
    got = _marginal(pf, a, renormalize)
    want = _marginal(jf, a, renormalize)
    assert got.dtype == np.float64 and got.shape == (n, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not np.diag(got).any()


def test_sample_blocks_hold_at_least_one_sample(monkeypatch):
    monkeypatch.setattr(pf, '_BLOCK_ELEMS', 10)
    assert pf._sample_blocks(3, 5) == [slice(0, 1), slice(1, 2),
                                       slice(2, 3)]


def _pp_case(rng, n=12, d=2, K=6, T=4):
    """One sample of JAX test_forecast.py's oracle test."""
    active = rng.choice(K, size=rng.randint(2, K + 1), replace=False)
    z_full = rng.choice(active, size=(T, n))
    z_full[0, :active.shape[0]] = active
    mask = np.zeros(K, np.float32)
    mask[active] = 1.0
    return dict(z_full=z_full, mask=mask, x_last=rng.randn(n, d),
                trans=rng.dirichlet(np.ones(K), size=K), mu=rng.randn(K, d),
                sigma=rng.uniform(0.1, 0.8, K), b=rng.randn() + 1.0,
                lam=rng.uniform(0.3, 0.95), u=rng.uniform(size=n),
                eps=rng.randn(n, d))


def test_pp_forecast_step_matches_jax_and_the_oracle():
    """JAX test_forecast.py:39's cases, five samples in one batched call:
    each equal to JAX's step and to the reference-shaped oracle."""
    rng = np.random.RandomState(42)
    cases = [_pp_case(rng) for _ in range(5)]

    def stack(key, dtype=torch.float32):
        return torch.as_tensor(np.stack([c[key] for c in cases]),
                               dtype=dtype)
    got = pf._pp_forecast_step(
        stack('u'), stack('eps'), stack('x_last'), stack('mask'),
        torch.as_tensor(np.stack([c['z_full'][-1] for c in cases])),
        stack('trans'), stack('mu'), stack('sigma'), stack('b'),
        stack('lam')).numpy()
    for s, c in enumerate(cases):
        f32 = {k: jnp.asarray(v, jnp.float32) for k, v in c.items()
               if k != 'z_full'}
        want = jf._pp_forecast_step(
            f32['u'], f32['eps'], f32['x_last'], f32['mask'],
            jnp.asarray(c['z_full'][-1], jnp.int32), f32['trans'],
            f32['mu'], f32['sigma'], f32['b'], f32['lam'])
        np.testing.assert_allclose(got[s], np.asarray(want), atol=2e-5)
        oracle = _oracle_pp_step(c['u'], c['eps'], c['x_last'],
                                 c['z_full'], c['trans'], c['mu'],
                                 c['sigma'], c['b'], c['lam'])
        np.testing.assert_allclose(got[s], oracle, atol=2e-5)


def test_pp_forecast_step_clamps_u():
    """u = 0 stays off a zero-mass first component, and u above the row
    total stays on the last active one, never on an inactive K - 1."""
    trans = torch.tensor([[[0.0, 0.5, 0.5, 0.0]] * 4])
    active = torch.tensor([[0.0, 1.0, 1.0, 0.0]])
    mu = torch.tensor([[[0.0, 0.0], [10.0, 0.0], [0.0, 10.0], [-9., -9.]]])
    xt = []
    for u in (0.0, 2.0):
        p = pf._pp_forecast_step(
            torch.tensor([[u, u]]), torch.zeros((1, 2, 2)),
            torch.zeros((1, 2, 2)), active, torch.tensor([[1, 2]]), trans,
            mu, torch.ones((1, 4)), torch.tensor([0.0]),
            torch.tensor([1.0]))
        xt.append(float(p[0, 0, 1]))
    # both nodes drawn into one component: distance 0, expit(0)
    assert xt == [0.5, 0.5]


@pytest.mark.parametrize('blocks', ['one', 'many'])
def test_posterior_predictive_forecast_on_jax_draws(monkeypatch, blocks):
    """The whole forecast on the uniforms and normals JAX's scan body draws
    from the key, each sample in its turn."""
    S, T, n, d, K = 9, 3, 10, 2, 5
    rng = np.random.RandomState(7)
    args = (rng.randn(S, n, d).astype(np.float32),
            rng.randint(0, K - 1, size=(S, T, n)),
            rng.dirichlet(np.ones(K), size=(S, K)).astype(np.float32),
            rng.randn(S, K, d).astype(np.float32),
            rng.uniform(0.1, 0.5, (S, K)).astype(np.float32),
            (rng.randn(S) + 1.0).astype(np.float32),
            rng.uniform(0.5, 0.95, S).astype(np.float32))
    key = jax.random.PRNGKey(5)
    u, eps = jax_pp_draws(key, S, n, d)
    if blocks == 'many':
        monkeypatch.setattr(pf, '_BLOCK_ELEMS', 2 * n * n)
    got = pf.posterior_predictive_forecast(None, *args, u=u, eps=eps)
    want = np.asarray(jf.posterior_predictive_forecast(key, *args))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_posterior_predictive_forecast_draws_its_own():
    """Without u/eps the draws come from the generator: seeded, repeatable,
    in (0, 1), and equal to passing the same draws in."""
    S, T, n, d, K = 6, 2, 7, 2, 4
    rng = np.random.RandomState(8)
    args = (rng.randn(S, n, d), rng.randint(0, K, size=(S, T, n)),
            rng.dirichlet(np.ones(K), size=(S, K)), rng.randn(S, K, d),
            rng.uniform(0.1, 0.5, (S, K)), rng.randn(S) + 1.0,
            rng.uniform(0.5, 0.95, S))
    p1 = pf.posterior_predictive_forecast(
        torch.Generator().manual_seed(3), *args)
    p2 = pf.posterior_predictive_forecast(
        torch.Generator().manual_seed(3), *args)
    assert torch.equal(p1, p2)
    assert p1.shape == (n, n) and bool(((p1 > 0) & (p1 < 1)).all())
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((S, n), generator=gen)
    eps = torch.randn((S, n, d), generator=gen)
    torch.testing.assert_close(
        pf.posterior_predictive_forecast(None, *args, u=u, eps=eps), p1)


def test_posterior_predictive_forecast_degenerate_limit():
    """JAX test_forecast.py:82: one active cluster, sigma -> 0 and a
    point-mass transition give the deterministic plug-in probability."""
    rng = np.random.RandomState(42)
    S, T, n, d, K = 8, 2, 6, 2, 4
    x_last = np.tile(rng.randn(1, n, d), (S, 1, 1))
    z_full = np.full((S, T, n), 2)
    trans = np.zeros((S, K, K))
    trans[:, :, 2] = 1.0
    mu = np.tile(rng.randn(1, K, d), (S, 1, 1))
    sigma = np.full((S, K), 1e-7)
    b = np.full(S, 0.7)
    lam = np.full(S, 0.4)
    probas = pf.posterior_predictive_forecast(
        torch.Generator().manual_seed(1), x_last, z_full, trans, mu, sigma,
        b, lam).numpy()
    xt = lam[0] * mu[0, 2] + (1 - lam[0]) * x_last[0]
    np.testing.assert_allclose(probas, expit(b[0] - squareform(pdist(xt))),
                               atol=1e-4)
