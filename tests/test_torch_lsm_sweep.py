"""The port's dynamic LSM sweep (dynetlsm_tpu_torch/mcmc/sweeps.py::
make_lsm_sweep), its log joint and its Procrustes rotation against the JAX
package's, undirected and directed.

The log joint and the rotation are deterministic and are compared
directly (rtol 1e-5: float32 sums in another order; atol 1e-5 for the
rotation, whose SVDs are taken by two libraries).

The two random streams differ, so one sweep from one shared state is
compared by distribution: over 512 chains, the one-sweep marginals of the
log joint, the intercept(s), the mean position, the mean latent
acceptance and, directed, the largest radius must pass a two-sample
Kolmogorov-Smirnov test at level 1e-3 each (fixed seeds, so the outcome is
deterministic).  Both sides run with ``n_burn=0`` (the Procrustes rotation
toward the start runs in the sweep) and without centering (so the mean
position is not zero by construction).
"""
import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from dynetlsm_tpu.math.procrustes import (
    longitudinal_procrustes_rotation as jax_procrustes)
from dynetlsm_tpu.mcmc.driver import replicate_state as jax_replicate
from dynetlsm_tpu.mcmc.states import LSMState as JaxLSMState
from dynetlsm_tpu.mcmc.sweeps import (
    SweepConfig as JaxSweepConfig, _lsm_logp as jax_lsm_logp,
    make_lsm_sweep as jax_make_lsm_sweep)
from dynetlsm_tpu.ops.distances import (
    pairwise_distances as jax_pairwise_distances)

from dynetlsm_tpu_torch.math.init import initialize_radii
from dynetlsm_tpu_torch.math.procrustes import (
    longitudinal_procrustes_rotation)
from dynetlsm_tpu_torch.mcmc.states import (
    LSMState, state_from_numpy, state_to_numpy)
from dynetlsm_tpu_torch.mcmc.sweeps import (
    SweepConfig, _lsm_logp, make_lsm_sweep)
from dynetlsm_tpu_torch.ops.distances import pairwise_distances

T, N, D = 3, 12, 2
N_CHAINS = 512
LEVEL = 1e-3


def _cfg(directed):
    return dict(is_directed=directed, n_burn=0, center=False, tau_sq=2.0,
                sigma_sq=0.1)


def _network(rng, directed):
    Y = rng.binomial(1, 0.3, (T, N, N)).astype(np.float32)
    if directed:
        for t in range(T):
            np.fill_diagonal(Y[t], 0.0)
        return Y
    Y = np.triu(Y, 1)
    return Y + Y.transpose(0, 2, 1)


def _problem(directed, seed=0):
    """A network and one chain's LSM state whose logp, MAP and Procrustes
    reference are those of its start, as the estimator builds it
    (models/lsm.py:252-275)."""
    rng = np.random.RandomState(seed)
    Y = _network(rng, directed)
    f = np.float32
    n_int = 2 if directed else 1
    X = jnp.asarray((0.1 if directed else 1.0) * rng.randn(T, N, D), f)
    b = jnp.asarray([1.0, 0.8] if directed else [1.0], f)
    radii = jnp.asarray(initialize_radii(Y), f) if directed else None
    prior = np.zeros(n_int, f)
    logp0 = jax_lsm_logp(JaxSweepConfig(**_cfg(directed)), jnp.asarray(Y),
                         X, b, radii, jax_pairwise_distances(X),
                         jnp.asarray(prior))
    s0 = JaxLSMState(
        key=jax.random.PRNGKey(seed), it=jnp.zeros((), jnp.int32), X=X,
        intercept=b, radii=radii, Y=None,
        step_X=jnp.full((T, N), 0.05 if directed else 0.3, f),
        acc_X=jnp.zeros((T, N), f), step_int=jnp.full((n_int,), 0.1, f),
        acc_int=jnp.zeros((n_int,), f),
        step_radii=jnp.asarray(2000.0, f) if directed else None,
        acc_radii=jnp.zeros((), f) if directed else None,
        logp=logp0, logp_map=logp0, X_map=X, intercept_map=b,
        radii_map=radii, logp_ref=logp0, X_ref=X, missing_sum=None)
    return Y, prior, s0


def _to_numpy(jax_state):
    return {k: np.asarray(v) for k, v in jax_state._asdict().items()
            if v is not None and k != 'key'}


def _summaries(d):
    out = {'logp': d['logp'], 'intercept_0': d['intercept'][:, 0],
           'mean_X': d['X'].mean(axis=(1, 2, 3)),
           'acc_X': d['acc_X'].mean(axis=(1, 2))}
    if 'radii' in d:
        out.update(intercept_1=d['intercept'][:, 1],
                   max_radius=d['radii'].max(axis=1))
    return out


_RUNS = {}


def one_sweep_each(directed):
    """One JAX sweep (one CPU compile per direction) and one port sweep
    from the same replicated state, cached for the module."""
    if directed not in _RUNS:
        Y, prior, s0 = _problem(directed)
        state = jax_replicate(s0, N_CHAINS, jax.random.PRNGKey(11))
        sweep = jax_make_lsm_sweep(jnp.asarray(Y), None, prior,
                                   JaxSweepConfig(**_cfg(directed)))
        jax_out = _to_numpy(jax.jit(jax.vmap(sweep))(state))
        start = _to_numpy(state)
        port_sweep = make_lsm_sweep(Y, prior, SweepConfig(**_cfg(directed)),
                                    device='cpu')
        gen = torch.Generator().manual_seed(12)
        port_out = state_to_numpy(port_sweep(state_from_numpy(start, 'cpu'),
                                             gen))
        _RUNS[directed] = (Y, prior, start, jax_out, port_out)
    return _RUNS[directed]


@pytest.mark.parametrize('reflect', [False, True])
def test_longitudinal_procrustes_matches_jax(reflect):
    """Chains of positions that are a rotation (or a reflection) of the
    reference plus noise, and one of pure noise."""
    rng = np.random.RandomState(4)
    C = 5
    X_ref = rng.randn(C, T, N, D).astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi, C)
    R = np.stack([[np.cos(angle), -np.sin(angle)],
                  [np.sin(angle), np.cos(angle)]]).transpose(2, 0, 1)
    if reflect:
        R[:, :, 1] *= -1.0
    X = (np.einsum('ctnd,cde->ctne', X_ref, R)
         + 0.1 * rng.randn(C, T, N, D)).astype(np.float32)
    X[-1] = rng.randn(T, N, D)
    want_X, want_R = jax.vmap(jax_procrustes)(jnp.asarray(X_ref),
                                              jnp.asarray(X))
    got_X, got_R = longitudinal_procrustes_rotation(torch.as_tensor(X_ref),
                                                    torch.as_tensor(X))
    np.testing.assert_allclose(got_R.numpy(), np.asarray(want_R), atol=1e-5)
    np.testing.assert_allclose(got_X.numpy(), np.asarray(want_X), atol=1e-5)
    dets = np.linalg.det(got_R.numpy()[:-1])
    np.testing.assert_allclose(dets, -1.0 if reflect else 1.0, atol=1e-5)


@pytest.mark.parametrize('directed', [False, True])
def test_lsm_logp_matches_jax(directed):
    """The log joint from dense distances, at the start and after the
    JAX sweep."""
    Y, prior, start, jax_out, _ = one_sweep_each(directed)
    cfg_j = JaxSweepConfig(**_cfg(directed))

    def one(X, b, r):
        return jax_lsm_logp(cfg_j, jnp.asarray(Y), X, b,
                            r if directed else None,
                            jax_pairwise_distances(X), jnp.asarray(prior))

    for d in (start, jax_out):
        r = d['radii'] if directed else np.zeros((N_CHAINS, 1), np.float32)
        want = np.asarray(jax.vmap(one)(jnp.asarray(d['X']),
                                        jnp.asarray(d['intercept']),
                                        jnp.asarray(r)))
        s = state_from_numpy(d, 'cpu')
        got = _lsm_logp(SweepConfig(**_cfg(directed)), torch.as_tensor(Y),
                        s.X, s.intercept, s.radii, pairwise_distances(s.X),
                        torch.as_tensor(prior))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize('directed', [False, True])
def test_lsm_state_round_trip(directed):
    _, _, start, jax_out, port_out = one_sweep_each(directed)
    for d in (start, jax_out, port_out):
        s = state_from_numpy(d, 'cpu')
        assert isinstance(s, LSMState)
        back = state_to_numpy(s)
        assert set(back) == set(d)
        for k, v in back.items():
            assert v.dtype == d[k].dtype, k
            np.testing.assert_array_equal(v, d[k], err_msg=k)
    assert (s.radii is not None) == directed
    assert (s.radii_map is not None) == directed


@pytest.mark.parametrize('directed', [False, True])
def test_port_lsm_sweep_logp_is_its_dense_log_joint(directed):
    """The sweep's logp reuses the coefficient step's log-likelihood; it
    must equal the log joint recomputed densely at the state it returns,
    and the MAP must track the better of the start and the sweep."""
    Y, prior, start, _, port_out = one_sweep_each(directed)
    s = state_from_numpy(port_out, 'cpu')
    dense = _lsm_logp(SweepConfig(**_cfg(directed)), torch.as_tensor(Y),
                      s.X, s.intercept, s.radii, pairwise_distances(s.X),
                      torch.as_tensor(prior))
    np.testing.assert_allclose(port_out['logp'], dense.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(
        port_out['logp_map'], np.maximum(start['logp'], port_out['logp']))
    np.testing.assert_array_equal(port_out['X_ref'], start['X'])


@pytest.mark.parametrize('directed, name', [
    (False, 'logp'), (False, 'intercept_0'), (False, 'mean_X'),
    (False, 'acc_X'), (True, 'logp'), (True, 'intercept_0'),
    (True, 'intercept_1'), (True, 'mean_X'), (True, 'acc_X'),
    (True, 'max_radius')])
def test_one_lsm_sweep_matches_jax_in_distribution(directed, name):
    _, _, _, jax_out, port_out = one_sweep_each(directed)
    assert (port_out['it'] == 1).all() and (jax_out['it'] == 1).all()
    a = _summaries(jax_out)[name]
    b = _summaries(port_out)[name]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.std(a) > 0 and np.std(b) > 0
    p = stats.ks_2samp(a, b).pvalue
    assert p > LEVEL, '%s: KS p = %g (jax mean %g, port mean %g)' % (
        name, p, a.mean(), b.mean())


def test_lsm_map_reset_and_reference_tracking():
    """With tune=1 and n_burn=2: sweep 1 (it + 1 = 1 <= n_burn) records
    X_ref wherever logp beats logp_ref and applies no rotation; sweep 2
    ends tuning (it + 1 == n_burn), so the MAP is reset to it even where
    it is worse; sweep 3 rotates toward X_ref and leaves it unchanged."""
    Y, prior, start, _, _ = one_sweep_each(False)
    cfg = SweepConfig(**dict(_cfg(False), tune=1, n_burn=2))
    sweep = make_lsm_sweep(Y, prior, cfg, device='cpu')
    s = state_from_numpy({k: v[:8] for k, v in start.items()}, 'cpu')
    s = s.replace(logp_ref=torch.full_like(s.logp_ref, -np.inf),
                  logp_map=torch.full_like(s.logp_map, np.inf))
    gen = torch.Generator().manual_seed(3)
    s1 = sweep(s, gen)
    np.testing.assert_array_equal(s1.X_ref.numpy(), s1.X.numpy())
    np.testing.assert_array_equal(s1.logp_ref.numpy(), s1.logp.numpy())
    assert torch.isinf(s1.logp_map).all()
    s2 = sweep(s1, gen)
    np.testing.assert_array_equal(s2.logp_map.numpy(), s2.logp.numpy())
    np.testing.assert_array_equal(s2.X_map.numpy(), s2.X.numpy())
    s3 = sweep(s2, gen)
    np.testing.assert_array_equal(s3.X_ref.numpy(), s2.X_ref.numpy())
    rotated, _ = longitudinal_procrustes_rotation(s2.X_ref, s3.X)
    np.testing.assert_allclose(rotated.numpy(), s3.X.numpy(), atol=1e-5)
