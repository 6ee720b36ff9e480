"""Procrustes alignment of latent spaces (counterpart of
``dynetlsm_tpu/math/procrustes.py``), batched over chains.

The rotation is the orthogonal factor ``U V^T`` of the SVD of the small
(d, d) cross-covariance, in float32 (TF32 is off, ``config.py``).  As in
the JAX package it is plain orthogonal Procrustes, so it may be a
reflection.
"""
import torch


def procrustes_rotation(X_ref, X):
    """Orthogonal R (C, d, d) minimising ||X R - X_ref||_F per chain
    (reference procrustes.py:20-25); X_ref, X (C, m, d)."""
    cross = torch.matmul(X.transpose(-1, -2), X_ref)
    u, _, vt = torch.linalg.svd(cross, full_matrices=False)
    return torch.matmul(u, vt)


def longitudinal_procrustes_rotation(X_ref, X):
    """One rotation per chain shared by all time steps, fitted on the
    time-flattened positions (reference procrustes.py:28-35).  X_ref, X
    (C, T, n, d).  Returns (X rotated (C, T, n, d), R (C, d, d))."""
    C, T, n, d = X.shape
    R = procrustes_rotation(X_ref.reshape(C, T * n, d),
                            X.reshape(C, T * n, d))
    return torch.matmul(X, R[:, None]), R
