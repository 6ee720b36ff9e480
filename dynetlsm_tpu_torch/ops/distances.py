"""Pairwise latent-space distances (counterpart of
``dynetlsm_tpu/ops/distances.py``).

Distances are computed from explicit differences, as the JAX package does,
and not through ``torch.cdist``, whose matmul form rounds differently.
"""
import torch


def _sum_sq_last(diff):
    """Sum of squares over the trailing (feature) axis in index order."""
    d2 = diff[..., 0] * diff[..., 0]
    for k in range(1, diff.shape[-1]):
        d2 = d2 + diff[..., k] * diff[..., k]
    return d2


def pairwise_distances(X, squared=False):
    """X (..., n, d) -> (..., n, n) Euclidean distances."""
    d2 = _sum_sq_last(X[..., :, None, :] - X[..., None, :, :])
    if squared:
        return d2
    return torch.sqrt(torch.clamp_min(d2, 0.0))
