"""Detection-limit sensitivity study generator (counterpart of
``dynetlsm_tpu/datasets/detection_limit.py``, reference
datasets/detection_limit.py), in NumPy alone, with the JAX package's
draws.

Builds a Monte-Carlo lookup table from group separation to the
p_out / p_in edge-probability ratio, then simulates a two-group dynamic
network at a requested detectability ratio.
"""
from functools import lru_cache

import numpy as np
from scipy.special import expit

from ..math.init import check_random_state
from .samples_generator import network_from_dynamic_latent_space

__all__ = ['make_lookup_table', 'detection_limit_simulation']


@lru_cache()
def make_lookup_table(n_samples=10000, low=0.1, high=2.5, n_bins=100,
                      random_state=42):
    """Monte-Carlo map mu -> (p_out/p_in, mu, p_in, p_out).

    Vectorised over samples (the reference loops them,
    detection_limit.py:27-34).
    """
    rng = check_random_state(random_state)
    sigma, intercept = 0.5, 1.0

    ratio = np.zeros((n_bins, 4))
    for b, m in enumerate(np.linspace(low, high, n_bins)):
        mu0 = np.array([m, 0.0])
        mu1 = np.array([-m, 0.0])
        X = np.sqrt(sigma) * rng.randn(n_samples, 8)
        x, y = X[:, :2] + mu0, X[:, 2:4] + mu0
        x0, x1 = X[:, 4:6] + mu0, X[:, 6:] + mu1
        p_in = expit(intercept - np.linalg.norm(x - x0, axis=1)).sum()
        p_out = expit(intercept - np.linalg.norm(y - x1, axis=1)).sum()
        ratio[b] = [p_out / p_in, m, p_in / n_samples, p_out / n_samples]
    return ratio


def detection_limit_simulation(n_nodes=120, n_time_steps=4, trans_proba=0.2,
                               lmbda=0.8, r=0.5, random_state=42):
    """Two-group dynamic network whose between/within edge-probability ratio
    is calibrated to ``r`` via the lookup table
    (reference detection_limit.py:41-86)."""
    rng = check_random_state(random_state)

    ratio = make_lookup_table()
    idx = int(np.argmin(np.abs(r - ratio[:, 0])))
    mu = ratio[idx, 1]
    sigma, intercept = 0.5, 1.0
    mus = mu * np.array([[1.0, 0.0], [-1.0, 0.0]])

    wt = np.array([[1 - trans_proba, trans_proba],
                   [trans_proba, 1 - trans_proba]])

    z0 = rng.choice([0, 1], p=[0.5, 0.5], size=n_nodes)
    X = [sigma * rng.randn(n_nodes, 2) + mus[z0]]
    z = [z0]
    for t in range(1, n_time_steps):
        zt = np.zeros(n_nodes, dtype=int)
        for g in range(2):
            mask = z[-1] == g
            zt[mask] = rng.choice([0, 1], p=wt[g], size=mask.sum())
        Xt = np.zeros((n_nodes, 2))
        for g in range(2):
            mask = zt == g
            Xt[mask] = (sigma * rng.randn(mask.sum(), 2)
                        + lmbda * mus[g] + (1 - lmbda) * X[-1][mask])
        X.append(Xt)
        z.append(zt)

    X = np.stack(X)
    z = np.vstack(z)
    Y, probas = network_from_dynamic_latent_space(
        X, intercept=intercept, random_state=rng)
    return Y, X, z, probas, ratio[idx, 0], mus
