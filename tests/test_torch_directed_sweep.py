"""The port's directed social-radii HDP-LPCM sweep
(dynetlsm_tpu_torch/mcmc/sweeps.py with ``is_directed=True``) against the
JAX package's.

The log joint at a given state is compared directly: within 1e-5 of the
largest |logp| of the batch, since float32 sums of terms of order 1e2
round to ~1e-4 and a chain's log joint can cancel to near zero.

The two random streams differ, so one sweep from one shared state is
compared by distribution: over 512 chains, the one-sweep marginals of both
intercepts, the log joint, the mean latent acceptance and the largest
radius must pass a two-sample Kolmogorov-Smirnov test at level 1e-3 each
(fixed seeds, so the outcome is deterministic).  The radii step size is
2000 here, not the benchmark's 175000, so that the radii move enough in
one sweep for the test to see them.
"""
import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from dynetlsm_tpu.mcmc.driver import replicate_state as jax_replicate
from dynetlsm_tpu.mcmc.states import MixtureState as JaxMixtureState
from dynetlsm_tpu.mcmc.sweeps import (
    SweepConfig as JaxSweepConfig, hdp_logp_at_state as jax_logp_at_state,
    make_hdp_sweep as jax_make_hdp_sweep)

from dynetlsm_tpu_torch.math.init import initialize_radii
from dynetlsm_tpu_torch.mcmc.states import state_from_numpy, state_to_numpy
from dynetlsm_tpu_torch.mcmc.sweeps import (
    SweepConfig, hdp_logp_at_state, make_hdp_sweep)

T, N, K, D = 3, 12, 4, 2
N_CHAINS = 512
LEVEL = 1e-3
CFG = dict(is_directed=True, n_components=K, a0=36.0, b0=40.0, c0=5.0,
           d0=2.0)
PRIOR = np.zeros(2, np.float32)
LOGP_FIELDS = ('X', 'intercept', 'z', 'mu', 'sigma', 'lmbda', 'weights',
               'beta', 'gamma', 'alpha_init', 'alpha', 'kappa', 'mean_var',
               'b_scale')


def _problem(seed=0):
    """A zero-diagonal directed network and one chain's state, positions
    at the scale of the radii (so eta is of order 1)."""
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.3, (T, N, N)).astype(np.float32)
    for t in range(T):
        np.fill_diagonal(Y[t], 0.0)
    f = np.float32
    w = np.zeros((T, K, K), f)
    w[0, 0] = rng.dirichlet(np.ones(K))
    w[1:] = rng.dirichlet(np.ones(K) + 3.0 * np.eye(K)[0], size=(T - 1, K))
    s0 = JaxMixtureState(
        key=jax.random.PRNGKey(seed), it=jnp.zeros((), jnp.int32),
        X=jnp.asarray(0.1 * rng.randn(T, N, D), f),
        intercept=jnp.asarray([1.0, 0.8], f),
        radii=jnp.asarray(initialize_radii(Y), f), Y=None,
        z=jnp.asarray(rng.randint(0, K, (T, N)), jnp.int32),
        mu=jnp.asarray(0.1 * rng.randn(K, D), f), sigma=jnp.full(K, 0.1, f),
        lmbda=jnp.asarray(0.9, f), weights=jnp.asarray(w),
        beta=jnp.asarray(rng.dirichlet(np.ones(K)), f),
        gamma=jnp.asarray(1.0, f), alpha_init=jnp.asarray(1.0, f),
        alpha=jnp.asarray(1.0, f), kappa=jnp.asarray(4.0, f),
        init_weights=None, trans_weights=None,
        mean_var=jnp.asarray(1.0, f), b_scale=jnp.asarray(2.4, f),
        step_X=jnp.full((T, N), 0.05, f), acc_X=jnp.zeros((T, N), f),
        step_int=jnp.full((2,), 0.1, f), acc_int=jnp.zeros((2,), f),
        step_radii=jnp.asarray(2000.0, f), acc_radii=jnp.zeros((), f),
        logp=jnp.zeros((), f), missing_sum=None)
    return Y, s0


def _to_numpy(jax_state):
    return {k: np.asarray(v) for k, v in jax_state._asdict().items()
            if v is not None and k != 'key'}


def _summaries(d):
    return {'intercept_in': d['intercept'][:, 0],
            'intercept_out': d['intercept'][:, 1], 'logp': d['logp'],
            'acc_X': d['acc_X'].mean(axis=(1, 2)),
            'max_radius': d['radii'].max(axis=1)}


@pytest.fixture(scope='module')
def one_sweep_each():
    """One JAX sweep (one CPU compile for the module) and one port sweep
    from the same replicated state."""
    Y, s0 = _problem()
    state = jax_replicate(s0, N_CHAINS, jax.random.PRNGKey(11))
    sweep = jax_make_hdp_sweep(jnp.asarray(Y), None, PRIOR,
                               JaxSweepConfig(**CFG))
    jax_out = _to_numpy(jax.jit(jax.vmap(sweep))(state))
    start = _to_numpy(state)
    port_sweep = make_hdp_sweep(Y, PRIOR, SweepConfig(**CFG), device='cpu')
    gen = torch.Generator().manual_seed(12)
    port_out = state_to_numpy(port_sweep(state_from_numpy(start, 'cpu'),
                                         gen))
    return Y, start, jax_out, port_out


def _port_logp(Y, d):
    s = state_from_numpy(d, 'cpu')
    return hdp_logp_at_state(
        SweepConfig(**CFG), torch.as_tensor(Y), PRIOR,
        *[getattr(s, nm) for nm in LOGP_FIELDS], radii=s.radii).numpy()


def test_state_round_trip_with_radii(one_sweep_each):
    _, start, jax_out, port_out = one_sweep_each
    for d in (start, jax_out, port_out):
        back = state_to_numpy(state_from_numpy(d, 'cpu'))
        assert set(back) == set(d)
        for k, v in back.items():
            assert v.dtype == d[k].dtype, k
            np.testing.assert_array_equal(v, d[k], err_msg=k)
    assert port_out['radii'].shape == (N_CHAINS, N)
    assert port_out['intercept'].shape == (N_CHAINS, 2)
    undirected = {k: v for k, v in start.items()
                  if k not in ('radii', 'step_radii', 'acc_radii')}
    s = state_from_numpy(undirected, 'cpu')
    assert s.radii is None and s.step_radii is None and s.acc_radii is None
    assert 'radii' not in state_to_numpy(s)


def test_logp_at_state_matches_jax(one_sweep_each):
    Y, start, jax_out, _ = one_sweep_each
    cfg = JaxSweepConfig(**CFG)

    def one(X, b, r, z, mu, sig, lam, w, beta, gam, ai, al, ka, mv, bs):
        return jax_logp_at_state(cfg, jnp.asarray(Y), jnp.asarray(PRIOR), X,
                                 b, r, z, mu, sig, lam, w, beta, gam, ai, al,
                                 ka, mv, bs)

    for d in (start, jax_out):
        names = LOGP_FIELDS[:2] + ('radii',) + LOGP_FIELDS[2:]
        want = np.asarray(jax.vmap(one)(*[jnp.asarray(d[nm])
                                          for nm in names]))
        np.testing.assert_allclose(_port_logp(Y, d), want, rtol=0.0,
                                   atol=1e-5 * np.abs(want).max())


def test_port_sweep_logp_is_its_dense_log_joint(one_sweep_each):
    """The sweep's logp reuses the radii step's log-likelihood; it must
    equal the log joint recomputed densely at the state it returns."""
    Y, _, _, port_out = one_sweep_each
    assert (port_out['it'] == 1).all()
    np.testing.assert_allclose(port_out['logp'], _port_logp(Y, port_out),
                               rtol=1e-5)


@pytest.mark.parametrize('name', ['intercept_in', 'intercept_out', 'logp',
                                  'acc_X', 'max_radius'])
def test_one_directed_sweep_matches_jax_in_distribution(one_sweep_each,
                                                        name):
    _, _, jax_out, port_out = one_sweep_each
    assert (port_out['it'] == 1).all() and (jax_out['it'] == 1).all()
    a = _summaries(jax_out)[name]
    b = _summaries(port_out)[name]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.std(a) > 0 and np.std(b) > 0
    p = stats.ks_2samp(a, b).pvalue
    assert p > LEVEL, '%s: KS p = %g (jax mean %g, port mean %g)' % (
        name, p, a.mean(), b.mean())
