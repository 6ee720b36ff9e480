"""3-D (T, n, n) index helpers (counterpart of
``dynetlsm_tpu/array_utils.py``, reference dynetlsm/array_utils.py)."""
import numpy as np


def triu_indices_from_3d(Y, k=0):
    T, n, m = Y.shape
    tri = ~np.tri(n, m, k=k - 1, dtype=bool)
    return np.nonzero(np.broadcast_to(tri, (T, n, m)))


def diag_indices_from_3d(Y):
    T, n, m = Y.shape
    eye = np.eye(n, m, dtype=bool)
    return np.nonzero(np.broadcast_to(eye, (T, n, m)))


def nondiag_indices_from_3d(Y):
    T, n, m = Y.shape
    eye = np.eye(n, m, dtype=bool)
    return np.nonzero(np.broadcast_to(~eye, (T, n, m)))


def nondiag_indices_from(Y):
    return np.nonzero(~np.eye(Y.shape[0], Y.shape[1], dtype=bool))


def triu_mask_3d(T, n, k=1):
    """Boolean (T, n, n) upper-triangle mask."""
    tri = ~np.tri(n, n, k=k - 1, dtype=bool)
    return np.broadcast_to(tri, (T, n, n)).copy()


def nondiag_mask_3d(T, n):
    eye = np.eye(n, dtype=bool)
    return np.broadcast_to(~eye, (T, n, n)).copy()
