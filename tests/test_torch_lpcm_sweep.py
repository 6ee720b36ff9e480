"""The port's finite LPCM sweep (dynetlsm_tpu_torch/mcmc/sweeps.py::
make_lpcm_sweep), its log joint and its label block against the JAX
package's, undirected and directed.

The label block (``sample_labels_block_lpcm``) is fed the Gumbel noise the
JAX block drew, replayed from its key: identical labels and statistics,
backward messages at rtol 1e-5.  The log joint at a given state is
compared directly (rtol 1e-5: float32 sums in another order).

The two random streams differ, so one sweep from one shared state is
compared by distribution: over 512 chains, the one-sweep marginals of the
log joint, the intercept(s), the mean position, lambda and two weights
(the initial weight of component 0 and the 0 -> 0 transition) must pass a
two-sample Kolmogorov-Smirnov test at level 1e-3 each (fixed seeds, so the
outcome is deterministic).  Both sides run with ``n_burn=0`` and without
centering (so the mean position is not zero by construction).
"""
import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from dynetlsm_tpu.mcmc import labels as jlabels
from dynetlsm_tpu.mcmc.driver import replicate_state as jax_replicate
from dynetlsm_tpu.mcmc.states import MixtureState as JaxMixtureState
from dynetlsm_tpu.mcmc.sweeps import (
    SweepConfig as JaxSweepConfig, lpcm_logp_at_state as jax_logp_at_state,
    make_lpcm_sweep as jax_make_lpcm_sweep)
from dynetlsm_tpu.ops import emissions as jemit

from dynetlsm_tpu_torch.math.init import initialize_radii
from dynetlsm_tpu_torch.mcmc import labels as tlabels
from dynetlsm_tpu_torch.mcmc.states import (
    MixtureState, state_from_numpy, state_to_numpy)
from dynetlsm_tpu_torch.mcmc.sweeps import (
    SweepConfig, lpcm_logp_at_state, make_lpcm_sweep)

T, N, K, D = 3, 12, 4, 2
N_CHAINS = 512
LEVEL = 1e-3
LOGP_FIELDS = ('X', 'intercept', 'z', 'mu', 'sigma', 'lmbda',
               'init_weights', 'trans_weights', 'mean_var', 'b_scale')


def _cfg(directed):
    return dict(is_directed=directed, n_components=K, a0=36.0, b0=40.0,
                c0=5.0, d0=2.0, dirichlet_prior=1.0, n_burn=0, center=False)


def _problem(directed, seed=0):
    """A network and one chain's LPCM state; directed, positions at the
    scale of the radii (so eta is of order 1)."""
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.3, (T, N, N)).astype(np.float32)
    if directed:
        for t in range(T):
            np.fill_diagonal(Y[t], 0.0)
    else:
        Y = np.triu(Y, 1)
        Y = Y + Y.transpose(0, 2, 1)
    f = np.float32
    n_int = 2 if directed else 1
    scale = 0.1 if directed else 1.0
    s0 = JaxMixtureState(
        key=jax.random.PRNGKey(seed), it=jnp.zeros((), jnp.int32),
        X=jnp.asarray(scale * rng.randn(T, N, D), f),
        intercept=jnp.asarray([1.0, 0.8] if directed else [1.0], f),
        radii=jnp.asarray(initialize_radii(Y), f) if directed else None,
        Y=None, z=jnp.asarray(rng.randint(0, K, (T, N)), jnp.int32),
        mu=jnp.asarray(scale * rng.randn(K, D), f),
        sigma=jnp.full(K, 0.1 if directed else 1.0, f),
        lmbda=jnp.asarray(0.9, f), weights=None, beta=None, gamma=None,
        alpha_init=None, alpha=None, kappa=None,
        init_weights=jnp.asarray(rng.dirichlet(np.ones(K)), f),
        trans_weights=jnp.asarray(
            rng.dirichlet(np.ones(K) + 3.0 * np.eye(K)[0], size=K), f),
        mean_var=jnp.asarray(1.0, f), b_scale=jnp.asarray(2.4, f),
        step_X=jnp.full((T, N), 0.05 if directed else 0.3, f),
        acc_X=jnp.zeros((T, N), f), step_int=jnp.full((n_int,), 0.1, f),
        acc_int=jnp.zeros((n_int,), f),
        step_radii=jnp.asarray(2000.0, f) if directed else None,
        acc_radii=jnp.zeros((), f) if directed else None,
        logp=jnp.zeros((), f), missing_sum=None)
    return Y, np.zeros(n_int, f), s0


def _to_numpy(jax_state):
    return {k: np.asarray(v) for k, v in jax_state._asdict().items()
            if v is not None and k != 'key'}


def _summaries(d):
    out = {'logp': d['logp'], 'intercept_0': d['intercept'][:, 0],
           'mean_X': d['X'].mean(axis=(1, 2, 3)), 'lmbda': d['lmbda'],
           'init_w0': d['init_weights'][:, 0],
           'trans_w00': d['trans_weights'][:, 0, 0]}
    if 'radii' in d:
        out['intercept_1'] = d['intercept'][:, 1]
    return out


_RUNS = {}


def one_sweep_each(directed):
    """One JAX sweep (one CPU compile per direction) and one port sweep
    from the same replicated state, cached for the module."""
    if directed not in _RUNS:
        Y, prior, s0 = _problem(directed)
        state = jax_replicate(s0, N_CHAINS, jax.random.PRNGKey(11))
        sweep = jax_make_lpcm_sweep(jnp.asarray(Y), None, prior,
                                    JaxSweepConfig(**_cfg(directed)))
        jax_out = _to_numpy(jax.jit(jax.vmap(sweep))(state))
        start = _to_numpy(state)
        port_sweep = make_lpcm_sweep(Y, prior,
                                     SweepConfig(**_cfg(directed)),
                                     device='cpu')
        gen = torch.Generator().manual_seed(12)
        port_out = state_to_numpy(port_sweep(state_from_numpy(start, 'cpu'),
                                             gen))
        _RUNS[directed] = (Y, prior, start, jax_out, port_out)
    return _RUNS[directed]


def _port_logp(directed, Y, prior, d):
    s = state_from_numpy(d, 'cpu')
    return lpcm_logp_at_state(
        SweepConfig(**_cfg(directed)), torch.as_tensor(Y), prior,
        *[getattr(s, nm) for nm in LOGP_FIELDS], radii=s.radii).numpy()


def test_sample_labels_block_lpcm_replayed(monkeypatch):
    """The label block on the Gumbel noise of the JAX block's key."""
    rng = np.random.RandomState(5)
    C = 3
    f = np.float32
    X = rng.randn(C, T, N, D).astype(f)
    mu = rng.randn(C, K, D).astype(f)
    sigma = (rng.rand(C, K) + 0.5).astype(f)
    lmbda = (0.7 + 0.2 * rng.rand(C)).astype(f)
    w0 = rng.dirichlet(np.ones(K), size=C).astype(f)
    w = rng.dirichlet(np.ones(K), size=(C, K)).astype(f)
    ks = jax.random.split(jax.random.PRNGKey(7), C)
    want = jax.vmap(jlabels.sample_labels_block_lpcm)(
        ks, *map(jnp.asarray, (X, mu, sigma, lmbda, w0, w)))
    g = jax.vmap(lambda k: jax.vmap(
        lambda kt: jax.random.gumbel(kt, (K, N)))(jax.random.split(k, T)))(ks)
    monkeypatch.setattr(tlabels, 'gumbel',
                        lambda gen, shape, device: torch.tensor(
                            np.asarray(g)))
    got = tlabels.sample_labels_block_lpcm(
        None, *map(torch.as_tensor, (X, mu, sigma, lmbda, w0, w)))
    for gt, wt in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    assert len(np.unique(got[0].numpy())) > 1

    lik = jax.vmap(jemit.emission_likelihoods_kn)(
        *map(jnp.asarray, (X, mu, sigma, lmbda)))
    w_t = np.broadcast_to(w[:, None], (C, T, K, K))
    pm_want = jax.vmap(jlabels._backward_messages)(lik, jnp.asarray(w_t))
    pm_got = tlabels._backward_messages(
        torch.tensor(np.asarray(lik)),
        torch.as_tensor(w)[:, None].expand(C, T, K, K))
    np.testing.assert_allclose(pm_got.numpy(), np.asarray(pm_want),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('directed', [False, True])
def test_lpcm_logp_at_state_matches_jax(directed):
    Y, prior, start, jax_out, _ = one_sweep_each(directed)
    cfg = JaxSweepConfig(**_cfg(directed))

    def one(X, b, r, z, mu, sig, lam, iw, tw, mv, bs):
        return jax_logp_at_state(cfg, jnp.asarray(Y), jnp.asarray(prior), X,
                                 b, r if directed else None, z, mu, sig, lam,
                                 iw, tw, mv, bs)

    for d in (start, jax_out):
        r = d['radii'] if directed else np.zeros((N_CHAINS, 1), np.float32)
        args = [jnp.asarray(d[nm]) for nm in LOGP_FIELDS]
        want = np.asarray(jax.vmap(one)(*args[:2], jnp.asarray(r),
                                        *args[2:]))
        np.testing.assert_allclose(_port_logp(directed, Y, prior, d), want,
                                   rtol=1e-5)


@pytest.mark.parametrize('directed', [False, True])
def test_lpcm_state_round_trip(directed):
    _, _, start, jax_out, port_out = one_sweep_each(directed)
    for d in (start, jax_out, port_out):
        s = state_from_numpy(d, 'cpu')
        assert isinstance(s, MixtureState)
        assert s.weights is None and s.beta is None and s.gamma is None
        assert tuple(s.trans_weights.shape) == (N_CHAINS, K, K)
        back = state_to_numpy(s)
        assert set(back) == set(d)
        for k, v in back.items():
            assert v.dtype == d[k].dtype, k
            np.testing.assert_array_equal(v, d[k], err_msg=k)


@pytest.mark.parametrize('directed', [False, True])
def test_port_lpcm_sweep_logp_is_its_dense_log_joint(directed):
    """The sweep's logp reuses the coefficient step's log-likelihood; it
    must equal the log joint recomputed densely at the state it
    returns."""
    Y, prior, _, _, port_out = one_sweep_each(directed)
    assert (port_out['it'] == 1).all()
    np.testing.assert_allclose(port_out['logp'],
                               _port_logp(directed, Y, prior, port_out),
                               rtol=1e-5)


@pytest.mark.parametrize('directed, name', [
    (False, 'logp'), (False, 'intercept_0'), (False, 'mean_X'),
    (False, 'lmbda'), (False, 'init_w0'), (False, 'trans_w00'),
    (True, 'logp'), (True, 'intercept_0'), (True, 'intercept_1'),
    (True, 'mean_X'), (True, 'lmbda'), (True, 'init_w0'),
    (True, 'trans_w00')])
def test_one_lpcm_sweep_matches_jax_in_distribution(directed, name):
    _, _, _, jax_out, port_out = one_sweep_each(directed)
    assert (port_out['it'] == 1).all() and (jax_out['it'] == 1).all()
    a = _summaries(jax_out)[name]
    b = _summaries(port_out)[name]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.std(a) > 0 and np.std(b) > 0
    p = stats.ks_2samp(a, b).pvalue
    assert p > LEVEL, '%s: KS p = %g (jax mean %g, port mean %g)' % (
        name, p, a.mean(), b.mean())
