"""The networks the sweep's headline shapes use, in NumPy alone.

* :func:`load_dynamic_monks` reads Sampson's monastery (T=3, n=18) from
  the raw files shipped with the JAX package
  (``dynetlsm_tpu/datasets/raw_data/``), as files: importing that package
  would load jax, and its loader needs scikit-learn.
* :func:`northstar_network` is the synthetic community network at the
  north-star scale (T=10, n=500), a copy of ``bench.py``'s generator;
  :func:`northstar_probas` its edge probabilities.
* :func:`with_missing_dyads` codes a seeded random share of a network's
  dyads as missing (-1).
* :func:`synthetic_static_community_dynamic_network` is the simulated
  community network of the JAX LPCM equivalence test, a copy of the JAX
  package's generator (its module needs scikit-learn).
"""
import os

import numpy as np
from scipy.special import expit

from .math.init import euclidean_distances

RAW = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'dynetlsm_tpu', 'datasets', 'raw_data')


def load_dynamic_monks(is_directed=False):
    """The three-wave Sampson liking networks (T=3, n=18) as float64: the
    raw directed waves, or made undirected by symmetrisation (reference
    load_monks.py:22-49)."""
    Y = np.stack([np.loadtxt(os.path.join(RAW, 'sampson_%d.npy' % t))
                  for t in range(3)]).astype(np.float64)
    if is_directed:
        return Y
    return ((Y + Y.transpose(0, 2, 1)) > 0).astype(np.float64)


def _community_probas(rng, n, n_groups):
    """The generator's edge probabilities (n, n): 0.1 within one of
    ``n_groups`` uniformly drawn communities, 0.01 across."""
    z = rng.randint(0, n_groups, size=n)
    return np.where(z[:, None] == z[None, :], 0.1, 0.01)


def northstar_probas(n=500, n_groups=8, seed=3):
    """The edge probabilities (n, n) that :func:`northstar_network` draws
    its dyads from."""
    return _community_probas(np.random.RandomState(seed), n, n_groups)


def northstar_network(T=10, n=500, n_groups=8, seed=3, directed=False):
    """Synthetic community network at the north-star scale: undirected,
    or directed with a zero diagonal."""
    rng = np.random.RandomState(seed)
    P = _community_probas(rng, n, n_groups)
    Y = np.zeros((T, n, n), np.float32)
    for t in range(T):
        draw = (rng.uniform(size=(n, n)) < P).astype(np.float32)
        if directed:
            np.fill_diagonal(draw, 0.0)
            Y[t] = draw
        else:
            upper = np.triu(draw, 1)
            Y[t] = upper + upper.T
    return Y


def with_missing_dyads(Y, fraction=0.1, seed=0, directed=False):
    """A float64 copy of the network Y (T, n, n) with a ``fraction`` of its
    off-diagonal dyads, chosen at random from ``seed``, coded -1: each
    ordered dyad on its own when directed, each unordered pair (both
    entries) when undirected."""
    Y = np.array(Y, dtype=np.float64)
    T, n, _ = Y.shape
    miss = np.random.RandomState(seed).uniform(size=Y.shape) < fraction
    if directed:
        miss &= ~np.eye(n, dtype=bool)
    else:
        miss = np.triu(miss, 1)
        miss |= np.swapaxes(miss, 1, 2)
    Y[miss] = -1.0
    return Y


def synthetic_static_community_dynamic_network(
        n_nodes=100, n_time_steps=5, n_groups=6, simulation_type=None,
        random_state=42):
    """Fixed community structure with Markov label switching (reference
    samples_generator.py:365-476), undirected: the JAX package's generator
    with the same draws from ``RandomState(random_state)``, distances in
    scikit-learn's form.  Returns (Y (T, n, n), X (T, n, 2), z (T, n))."""
    rng = np.random.RandomState(random_state)
    mus = np.array([[-4., 0.], [4., 0.], [-2., 0.], [2., 0.],
                    [0., 5.0], [0., -5.0]])
    sigma_shape, sigma_scale = {'easy': (6, 20), 'hard': (6, 0.5)}.get(
        simulation_type, (3, 0.5))
    intercept, lmbda = 1.0, 0.8
    if n_groups > 6:
        raise ValueError('Only a maximum of six groups allowed for now.')
    sigmas = np.sqrt(1.0 / rng.gamma(shape=sigma_shape, scale=sigma_scale,
                                     size=n_groups))

    def positions(zt, X_prev=None):
        Xt = np.zeros((n_nodes, 2))
        for g in range(n_groups):
            mask = zt == g
            if mask.any():
                base = (mus[g] if X_prev is None
                        else lmbda * mus[g] + (1 - lmbda) * X_prev[mask])
                Xt[mask] = sigmas[g] * rng.randn(mask.sum(), 2) + base
        return Xt

    w0 = rng.dirichlet(np.repeat(10, n_groups))
    z = [rng.choice(n_groups, p=w0, size=n_nodes)]
    X = [positions(z[0])]
    # sticky transitions: inverse mean distances, diagonal 20 x the row max
    with np.errstate(divide='ignore'):
        wt = 1.0 / euclidean_distances(mus[:n_groups])
    wt[np.diag_indices_from(wt)] = 0.0
    wt[np.diag_indices_from(wt)] = 20.0 * wt.max(axis=1)
    wt /= wt.sum(axis=1, keepdims=True)
    for t in range(1, n_time_steps):
        zt = np.zeros_like(z[-1])
        for g in range(n_groups):
            mask = z[-1] == g
            if mask.any():
                zt[mask] = rng.choice(n_groups, p=wt[g], size=mask.sum())
        X.append(positions(zt, X[-1]))
        z.append(zt)
    X, z = np.stack(X), np.vstack(z)

    Y = np.zeros((n_time_steps, n_nodes, n_nodes))
    for t in range(n_time_steps):
        draw = rng.binomial(1, expit(intercept - euclidean_distances(X[t])))
        draw = np.triu(draw.astype(float), 1)
        Y[t] = draw + draw.T
    return Y, X, z
