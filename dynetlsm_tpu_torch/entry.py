"""Entry points of the port (counterparts of ``__graft_entry__.entry`` and
``bench.build_state_and_sweep``).

* :func:`entry` — one HDP-LPCM Gibbs sweep on a tiny random problem, with
  its arguments.
* :func:`build_state_and_sweep` — a replicated chain state and the sweep
  for a dense undirected or directed network, with random initialisation
  (the ``quality_init=False`` path of ``bench.py``; GMDS and k-means
  initialisation belong to the estimator, not ported yet).
"""
import numpy as np
import torch

from .math.init import initialize_radii
from .mcmc.driver import replicate_state
from .mcmc.sweeps import SweepConfig, make_hdp_sweep


def _single_state(T, n, X0, mu0, sigma0, z0, weights0, beta0, n_int=1):
    return {
        'it': 0, 'X': X0, 'intercept': np.ones(n_int), 'z': z0, 'mu': mu0,
        'sigma': sigma0, 'lmbda': 0.9, 'weights': weights0, 'beta': beta0,
        'gamma': 1.0, 'alpha_init': 1.0, 'alpha': 1.0, 'kappa': 4.0,
        'mean_var': 1.0, 'b_scale': 2.4, 'step_X': np.full((T, n), 0.1),
        'acc_X': np.zeros((T, n)), 'step_int': np.full((n_int,), 0.1),
        'acc_int': np.zeros(n_int), 'logp': 0.0}


def _tiny_problem(n_chains=1, T=3, n=18, K=5, d=2, seed=0, device=None):
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.3, size=(T, n, n)).astype(np.float32)
    Y = np.triu(Y, 1)
    Y = Y + Y.transpose(0, 2, 1)
    z0 = rng.randint(0, K, size=(T, n))
    weights0 = np.full((T, K, K), 1.0 / K)
    cfg = SweepConfig(tune=100, tune_interval=100, n_components=K,
                      a0=36.0, b0=40.0, c0=5.0, d0=2.0)
    sweep = make_hdp_sweep(Y, np.zeros(1, np.float32), cfg, device=device)
    s0 = _single_state(T, n, rng.randn(T, n, d), rng.randn(K, d),
                       np.ones(K), z0, weights0, np.full(K, 1.0 / K))
    state = replicate_state(s0, n_chains, device)
    gen = torch.Generator(device=device or 'cpu').manual_seed(seed + 1)
    return sweep, state, gen


def entry(device=None):
    """(fn, example_args): one HDP-LPCM Gibbs sweep, ``fn(state, gen)``."""
    sweep, state, gen = _tiny_problem(n_chains=1, device=device)
    return sweep, (state, gen)


def build_state_and_sweep(Y, n_chains, K=10, seed=0, table_cap=64,
                          device=None, is_directed=False):
    """A replicated chain state, the HDP sweep and its generator for the
    dense network Y (T, n, n), undirected or directed (social radii
    initialised from the degrees, step 175000, tuned), with the
    configuration of ``bench.py``'s headline and directed rows.  The
    initial state draws the same NumPy random numbers as
    ``bench.build_state_and_sweep(..., quality_init=False)``.
    Returns (state, sweep, gen)."""
    rng = np.random.RandomState(seed)
    T, n, _ = Y.shape
    d = 2
    X0 = rng.randn(T, n, d)
    mu0 = rng.randn(K, d)
    sigma0 = np.ones(K)
    z0 = rng.randint(0, K, size=(T, n))
    weights0 = np.zeros((T, K, K))
    weights0[0, 0] = np.bincount(z0[0], minlength=K) / n
    beta0 = rng.dirichlet(np.full(K, 1.0 / K))
    for t in range(1, T):
        for k in range(K):
            weights0[t, k] = rng.dirichlet(beta0 + 4.0 * np.eye(K)[k])

    cfg = SweepConfig(is_directed=is_directed, tune=0, tune_interval=100,
                      n_components=K, a0=36.0, b0=40.0, c0=5.0, d0=2.0,
                      table_cap=table_cap, tune_radii=is_directed)
    n_int = 2 if is_directed else 1
    sweep = make_hdp_sweep(Y, np.zeros(n_int, np.float32), cfg,
                           device=device)
    s0 = _single_state(T, n, X0, mu0, sigma0, z0, weights0, beta0, n_int)
    if is_directed:
        s0.update(radii=initialize_radii(Y), step_radii=175000.0,
                  acc_radii=0.0)
    state = replicate_state(s0, n_chains, device)
    gen = torch.Generator(device=device or 'cpu').manual_seed(seed + 1)
    return state, sweep, gen
