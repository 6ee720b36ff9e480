"""The networks the sweep's headline shapes use, in NumPy alone.

* :func:`load_dynamic_monks` reads Sampson's monastery (T=3, n=18) from
  the raw files shipped with the JAX package
  (``dynetlsm_tpu/datasets/raw_data/``), as files: importing that package
  would load jax, and its loader needs scikit-learn.
* :func:`northstar_network` is the synthetic community network at the
  north-star scale (T=10, n=500), a copy of ``bench.py``'s generator.
* :func:`with_missing_dyads` codes a seeded random share of a network's
  dyads as missing (-1).
"""
import os

import numpy as np

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


def northstar_network(T=10, n=500, n_groups=8, seed=3, directed=False):
    """Synthetic community network at the north-star scale: undirected,
    or directed with a zero diagonal."""
    rng = np.random.RandomState(seed)
    z = rng.randint(0, n_groups, size=n)
    p_in, p_out = 0.1, 0.01
    same = (z[:, None] == z[None, :])
    P = np.where(same, p_in, p_out)
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
