"""Helpers of the whole-fit parity tests
(``tests/test_torch_estimators_parity*.py``): fit the JAX estimator and
the port's on one network, the port's sampler output replaced by the JAX
fit's, and compare every fitted attribute and the forecasts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynetlsm_tpu.datasets import load_monks
from dynetlsm_tpu.models import lsm as jlsm, mixture_base as jmb

from dynetlsm_tpu_torch.mcmc import driver as pdriver
from dynetlsm_tpu_torch.mcmc.states import state_from_numpy
from dynetlsm_tpu_torch.models import mixture_base as pmb
from dynetlsm_tpu_torch.ops.forecast import posterior_predictive_forecast

BUDGET = dict(n_iter=20, tune=10, burn=10, random_state=42)
# JAX-only attributes: the device mesh of a multi-device fit
JAX_ONLY = {'mesh_', 'state_sharding_'}
# the LSM's attributes that follow from the BFGS start
LSM_START = {'intercept_prior_', 'tau_sq_'}


def fit_pair(monkeypatch, jax_mod, port_cls, Y, kwargs):
    """(the JAX estimator, the port's) fitted on Y with ``kwargs``, the
    port's sampler output replaced by the JAX fit's."""
    captured = {}
    if jax_mod is not jlsm:
        def init_capture(*args, **kw):
            kw['lsm_kwargs'] = dict(n_iter=10, tune=5, burn=5)
            captured['init'] = jmb.init_from_lsm(*args, **kw)
            return captured['init']
        monkeypatch.setattr(jax_mod, 'init_from_lsm', init_capture)
    jax_collect = jax_mod.collect_traces

    def collect_capture(*args, **kw):
        state, traces = jax_collect(*args, **kw)
        captured['collect'] = (
            {k: np.asarray(v) for k, v in state._asdict().items()
             if v is not None},
            {k: np.asarray(v) for k, v in traces.items()})
        return state, traces

    monkeypatch.setattr(jax_mod, 'collect_traces', collect_capture)
    jax_cls = getattr(jax_mod, port_cls.__name__)
    jm = jax_cls(**kwargs).fit(Y)

    def collect_inject(runner, state, gen, n_samples, chunk=512,
                       progress=None, checkpoint_dir=None):
        final, traces = captured['collect']
        assert next(iter(traces.values())).shape[0] == n_samples
        return state_from_numpy(final, state.X.device), dict(traces)

    monkeypatch.setattr(pdriver, 'collect_traces', collect_inject)
    if jax_mod is not jlsm:
        monkeypatch.setattr(pmb, 'init_from_lsm',
                            lambda *args, **kw: captured['init'])
    pm = port_cls(device='cpu', **kwargs).fit(Y)
    return jm, pm


def assert_same(name, p, j, rtol):
    if isinstance(j, (list, tuple)):
        assert len(p) == len(j), name
        for k, (a, b) in enumerate(zip(p, j)):
            assert_same('%s[%d]' % (name, k), a, b, rtol)
    elif hasattr(j, '__dict__') and not isinstance(j, np.ndarray):
        for k, v in vars(j).items():
            assert_same('%s.%s' % (name, k), getattr(p, k), v, rtol)
    elif j is None:
        assert p is None, name
    elif isinstance(j, (str, bool)):
        assert p == j, name
    else:
        j = np.asarray(j)
        p = np.asarray(p)
        assert p.shape == j.shape, (name, p.shape, j.shape)
        if j.dtype.kind in 'iub':
            np.testing.assert_array_equal(p, j, err_msg=name)
        else:
            scale = float(np.abs(j).max()) if j.size else 0.0
            np.testing.assert_allclose(p, j, rtol=rtol, atol=rtol * scale,
                                       err_msg=name)


def jax_pp_draws(key, S, n, d):
    """The uniforms (S, n) and normals (S, n, d) that JAX's
    ``posterior_predictive_forecast`` draws from ``key``: its scan body
    splits the carried key into (key, k_u, k_e) for each sample in
    turn."""
    u, eps = [], []
    for _ in range(S):
        key, k_u, k_e = jax.random.split(key, 3)
        u.append(np.asarray(jax.random.uniform(k_u, (n,), jnp.float32)))
        eps.append(np.asarray(jax.random.normal(k_e, (n, d), jnp.float32)))
    return np.stack(u), np.stack(eps)


def compare_forecasts(jm, pm):
    """The marginal forecast at rtol 1e-5; for an undirected HDP-LPCM the
    posterior-predictive one on JAX's draws from ``PRNGKey(random_state)``
    (atol 2e-5), the port's traces passed to its own function with those
    draws, and JAX's refusal of a directed one."""
    assert_same('forecast_probas_marginalized_',
                pm.forecast_probas_marginalized_,
                jm.forecast_probas_marginalized_, 1e-5)
    if not hasattr(type(jm), 'forecast_probas_pp_'):
        return
    if jm.is_directed:
        for m in (jm, pm):
            with pytest.raises(ValueError, match='undirected models only'):
                m.forecast_probas_pp_
        return
    args = pm._pp_forecast_inputs()
    S, n, d = args[0].shape
    u, eps = jax_pp_draws(jax.random.PRNGKey(pm.random_state), S, n, d)
    got = posterior_predictive_forecast(None, *args, u=u, eps=eps)
    np.testing.assert_allclose(got.numpy(), jm.forecast_probas_pp_,
                               atol=2e-5, err_msg='forecast_probas_pp_')


def compare(jm, pm, lsm=False):
    names = sorted(k for k in vars(jm) if k.endswith('_')
                   and not k.startswith('_') and k not in JAX_ONLY)
    assert names
    for name in names + ['probas_', 'auc_']:
        assert hasattr(pm, name), name
        p, j = getattr(pm, name), getattr(jm, name)
        if lsm and name in ('Xs_', 'intercepts_', 'logps_', 'radiis_'):
            # sample 0 is the BFGS start; the rest come from the sampler
            axis = 1 if pm.n_chains > 1 else 0
            n = p.shape[axis]
            assert_same(name, np.take(p, range(1, n), axis),
                         np.take(j, range(1, n), axis), 1e-5)
            np.testing.assert_allclose(np.take(p, 0, axis),
                                       np.take(j, 0, axis), rtol=1e-3,
                                       atol=1e-3, err_msg=name)
        elif lsm and name in LSM_START:
            np.testing.assert_allclose(p, j, rtol=1e-3, atol=1e-3,
                                       err_msg=name)
        else:
            assert_same(name, p, j, 1e-5)
    if not lsm:
        compare_forecasts(jm, pm)


def monks(directed=False):
    Y, _, _ = load_monks(is_directed=directed)
    return Y


