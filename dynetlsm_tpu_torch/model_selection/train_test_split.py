"""Dyad-level train/test masking for held-out AUC (counterpart of
``dynetlsm_tpu/model_selection/train_test_split.py``, reference
model_selection/train_test_split.py:15-50), with the JAX package's draws
from the same seed."""
from math import ceil

import numpy as np

from ..array_utils import triu_indices_from_3d
from ..math.init import check_random_state

__all__ = ['train_test_split']


def train_test_split(Y, test_size=0.1, random_state=None):
    """Mask a fraction of dyads per time step as missing (-1).

    Returns (Y_masked, test_indices) where test_indices flags the held-out
    entries of the flattened upper triangle.
    """
    Y = np.asarray(Y, dtype=np.float64)
    T, n, _ = Y.shape
    rng = check_random_state(random_state)

    n_dyads = n * (n - 1) // 2
    if np.asarray(test_size).dtype.kind == 'f':
        n_test = ceil(test_size * n_dyads)
    else:
        n_test = int(test_size)

    Y_new = np.zeros_like(Y)
    for t in range(T):
        il = np.tril_indices(n, k=-1)
        vec = Y[t][il].copy()
        held = rng.choice(np.arange(n_dyads), size=n_test, replace=False)
        vec[held] = -1.0
        Y_new[t][il] = vec
        Y_new[t] += Y_new[t].T

    iu = triu_indices_from_3d(Y_new, k=1)
    return Y_new, Y_new[iu] == -1
