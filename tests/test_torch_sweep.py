"""The port's HDP-LPCM sweep (dynetlsm_tpu_torch/mcmc/sweeps.py) against
the JAX package's.

The two random streams differ, so one sweep from one shared state is
compared by distribution: over 512 chains, the one-sweep marginals of the
intercept, the log joint, lambda and the mean latent acceptance must pass
a two-sample Kolmogorov-Smirnov test at level 1e-3 each (fixed seeds, so
the outcome is deterministic).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from dynetlsm_tpu.mcmc.driver import replicate_state as jax_replicate
from dynetlsm_tpu.mcmc.states import MixtureState as JaxMixtureState
from dynetlsm_tpu.mcmc.sweeps import (
    SweepConfig as JaxSweepConfig, make_hdp_sweep as jax_make_hdp_sweep)

from dynetlsm_tpu_torch.mcmc.driver import (
    collect_traces, make_scan_runner)
from dynetlsm_tpu_torch.mcmc.states import state_from_numpy, state_to_numpy
from dynetlsm_tpu_torch.mcmc.sweeps import SweepConfig, make_hdp_sweep

T, N, K, D = 3, 12, 4, 2
N_CHAINS = 512
LEVEL = 1e-3
CFG = dict(n_components=K, a0=36.0, b0=40.0, c0=5.0, d0=2.0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.3, (T, N, N)).astype(np.float32)
    Y = np.triu(Y, 1)
    Y = Y + Y.transpose(0, 2, 1)
    f = np.float32
    w = np.zeros((T, K, K), f)
    w[0, 0] = rng.dirichlet(np.ones(K))
    w[1:] = rng.dirichlet(np.ones(K) + 3.0 * np.eye(K)[0], size=(T - 1, K))
    s0 = JaxMixtureState(
        key=jax.random.PRNGKey(seed), it=jnp.zeros((), jnp.int32),
        X=jnp.asarray(rng.randn(T, N, D), f),
        intercept=jnp.ones(1, f), radii=None, Y=None,
        z=jnp.asarray(rng.randint(0, K, (T, N)), jnp.int32),
        mu=jnp.asarray(rng.randn(K, D), f), sigma=jnp.ones(K, f),
        lmbda=jnp.asarray(0.9, f), weights=jnp.asarray(w),
        beta=jnp.asarray(rng.dirichlet(np.ones(K)), f),
        gamma=jnp.asarray(1.0, f), alpha_init=jnp.asarray(1.0, f),
        alpha=jnp.asarray(1.0, f), kappa=jnp.asarray(4.0, f),
        init_weights=None, trans_weights=None,
        mean_var=jnp.asarray(1.0, f), b_scale=jnp.asarray(2.4, f),
        step_X=jnp.full((T, N), 0.3, f), acc_X=jnp.zeros((T, N), f),
        step_int=jnp.full((1,), 0.1, f), acc_int=jnp.zeros((1,), f),
        step_radii=None, acc_radii=None, logp=jnp.zeros((), f),
        missing_sum=None)
    return Y, s0


def _to_numpy(jax_state):
    return {k: np.asarray(v) for k, v in jax_state._asdict().items()
            if v is not None and k != 'key'}


def _summaries(d):
    return {'intercept': d['intercept'][:, 0], 'logp': d['logp'],
            'lmbda': d['lmbda'], 'acc_X': d['acc_X'].mean(axis=(1, 2))}


@pytest.fixture(scope='module')
def one_sweep_each():
    """One JAX sweep (one CPU compile for the module) and one port sweep
    from the same replicated state."""
    Y, s0 = _problem()
    state = jax_replicate(s0, N_CHAINS, jax.random.PRNGKey(11))
    sweep = jax_make_hdp_sweep(jnp.asarray(Y), None,
                               np.zeros(1, np.float32),
                               JaxSweepConfig(**CFG))
    jax_out = _to_numpy(jax.jit(jax.vmap(sweep))(state))
    start = _to_numpy(state)
    port_sweep = make_hdp_sweep(Y, np.zeros(1, np.float32),
                                SweepConfig(**CFG), device='cpu')
    gen = torch.Generator().manual_seed(12)
    port_out = state_to_numpy(port_sweep(state_from_numpy(start, 'cpu'),
                                         gen))
    return start, jax_out, port_out


def test_state_round_trip(one_sweep_each):
    start, jax_out, _ = one_sweep_each
    for d in (start, jax_out):
        back = state_to_numpy(state_from_numpy(d, 'cpu'))
        for k, v in back.items():
            assert v.dtype == d[k].dtype, k
            np.testing.assert_array_equal(v, d[k], err_msg=k)
    assert state_from_numpy(start, 'cpu').z.dtype == torch.int64


@pytest.mark.parametrize('name', ['intercept', 'logp', 'lmbda', 'acc_X'])
def test_one_sweep_matches_jax_in_distribution(one_sweep_each, name):
    _, jax_out, port_out = one_sweep_each
    assert (port_out['it'] == 1).all() and (jax_out['it'] == 1).all()
    a = _summaries(jax_out)[name]
    b = _summaries(port_out)[name]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.std(a) > 0 and np.std(b) > 0
    p = stats.ks_2samp(a, b).pvalue
    assert p > LEVEL, '%s: KS p = %g (jax mean %g, port mean %g)' % (
        name, p, a.mean(), b.mean())


def test_runner_and_collect_traces():
    from dynetlsm_tpu_torch.entry import entry
    sweep, (state, gen) = entry(device='cpu')
    runner = make_scan_runner(sweep, lambda s: {'logp': s.logp,
                                                'X': s.X}, chunk=3)
    state, traces = collect_traces(runner, state, gen, 5, chunk=3)
    assert traces['logp'].shape == (5, 1)
    assert traces['X'].shape == (5, 1, 3, 18, 2)
    assert np.isfinite(traces['logp']).all()
    assert int(state.it[0]) == 5


def test_port_runs_without_jax():
    """The port imports no jax: with jax blocked, it imports and runs two
    CPU sweeps of the tiny problem, and two CPU sweeps of each of the
    HDP-LPCM, the LPCM and the LSM on Sampson's monastery, undirected and
    directed."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dynetlsm_tpu'] = None\n"
        "import dynetlsm_tpu_torch\n"
        "from dynetlsm_tpu_torch.entry import entry, build_state_and_sweep\n"
        "from dynetlsm_tpu_torch.datasets import load_dynamic_monks\n"
        "sweep, (state, gen) = entry(device='cpu')\n"
        "state = sweep(sweep(state, gen), gen)\n"
        "assert int(state.it[0]) == 2 and bool(state.logp.isfinite().all())\n"
        "for model in ('hdp', 'lpcm', 'lsm'):\n"
        "    for directed in (False, True):\n"
        "        state, sweep, gen = build_state_and_sweep(\n"
        "            load_dynamic_monks(is_directed=directed), 4, K=4,\n"
        "            device='cpu', is_directed=directed, model=model)\n"
        "        state = sweep(sweep(state, gen), gen)\n"
        "        assert int(state.it[0]) == 2, model\n"
        "        assert bool(state.logp.isfinite().all()), model\n"
        "        assert (state.radii is not None) == directed, model\n"
        "assert tuple(state.radii.shape) == (4, 18)\n"
        "assert not any(m == 'jax' or m.startswith('jax.')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith('ok')
