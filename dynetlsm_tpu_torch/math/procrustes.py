"""Procrustes alignment of latent spaces (counterpart of
``dynetlsm_tpu/math/procrustes.py``), batched over chains.

The rotation is the orthogonal factor ``U V^T`` of the SVD of the small
(d, d) cross-covariance, in float32 (TF32 is off, ``config.py``).  As in
the JAX package it is plain orthogonal Procrustes, so it may be a
reflection.
"""
import torch

from ..tracing import traced


def procrustes_rotation(X_ref, X):
    """Orthogonal R (C, d, d) minimising ||X R - X_ref||_F per chain
    (reference procrustes.py:20-25); X_ref, X (C, m, d)."""
    cross = torch.matmul(X.transpose(-1, -2), X_ref)
    u, _, vt = torch.linalg.svd(cross, full_matrices=False)
    return torch.matmul(u, vt)


@traced
def longitudinal_procrustes_rotation(X_ref, X):
    """One rotation per chain shared by all time steps, fitted on the
    time-flattened positions (reference procrustes.py:28-35).  X_ref, X
    (C, T, n, d).  Returns (X rotated (C, T, n, d), R (C, d, d))."""
    C, T, n, d = X.shape
    R = procrustes_rotation(X_ref.reshape(C, T * n, d),
                            X.reshape(C, T * n, d))
    return torch.matmul(X, R[:, None]), R


def static_procrustes_rotation(X_ref, X):
    """(X R, R) with R the rotation of :func:`procrustes_rotation`; X_ref,
    X (m, d), or (C, m, d) per chain."""
    R = procrustes_rotation(X_ref, X)
    return torch.matmul(X, R), R


def longitudinal_procrustes_transform(Xs, means=None):
    """Every sample Xs[s] (S, T, n, d) rotated onto the first by one
    rotation a sample fitted on the time-flattened positions, and the
    cluster means (S, K, d) by the same rotations when given (reference
    procrustes.py:38-59).  Returns (rotated, rotated means or None)."""
    S, T, n, d = Xs.shape
    R = procrustes_rotation(Xs[0].reshape(1, T * n, d).expand(S, T * n, d),
                            Xs.reshape(S, T * n, d))
    rotated = torch.matmul(Xs, R[:, None])
    if means is None:
        return rotated, None
    return rotated, torch.einsum('skd,sde->ske', means, R)


def flatten_array(X):
    """(..., n, d) -> (prod(...) n, d) (reference procrustes.py:6-9)."""
    return X.reshape(-1, X.shape[-1])


# the reference's name (reference procrustes.py:12-27)
compute_procrustes_rotation = procrustes_rotation
