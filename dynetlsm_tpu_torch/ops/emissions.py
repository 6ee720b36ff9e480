"""Spherical-Gaussian emission log-likelihoods of the HMM label sampler
(counterpart of ``dynetlsm_tpu/ops/emissions.py``), chain-batched.

    N(X_t ; mu_k, sigma_k I)                        for t = 0
    N(X_t ; lam*mu_k + (1-lam)*X_{t-1}, sigma_k I)  for t > 0

computed in the expanded-square form of the JAX package, in (C, T, K, n)
layout.
"""
import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def emission_logliks_kn(X, mu, sigma, lmbda):
    """X (C, T, n, d); mu (C, K, d); sigma (C, K); lmbda (C,).
    Returns (C, T, K, n)."""
    C, T, n, d = X.shape
    G = torch.einsum('ckd,ctnd->ctkn', mu, X)                  # (C,T,K,n)
    x_sq = torch.sum(X * X, dim=-1)[:, :, None, :]            # (C,T,1,n)
    mu_sq = torch.sum(mu * mu, dim=-1)[:, None, :, None]      # (C,1,K,1)
    X_prev = torch.cat([torch.zeros_like(X[:, :1]), X[:, :-1]], dim=1)
    G_prev = torch.cat([torch.zeros_like(G[:, :1]), G[:, :-1]], dim=1)
    x_dot = torch.sum(X * X_prev, dim=-1)[:, :, None, :]      # (C,T,1,n)
    xp_sq = torch.cat([torch.zeros_like(x_sq[:, :1]), x_sq[:, :-1]], dim=1)

    lam = lmbda.to(X.dtype)[:, None, None, None]
    one_m = 1.0 - lam
    sum_sq_t0 = x_sq - 2.0 * G + mu_sq
    sum_sq_tp = (x_sq - 2.0 * lam * G - 2.0 * one_m * x_dot
                 + lam * lam * mu_sq + 2.0 * lam * one_m * G_prev
                 + one_m * one_m * xp_sq)
    is_t0 = (torch.arange(T, device=X.device) == 0)[None, :, None, None]
    sum_sq = torch.where(is_t0, sum_sq_t0, sum_sq_tp)
    sig = sigma[:, None, :, None]
    return (-0.5 * d * (LOG_2PI + torch.log(sig)) - 0.5 * sum_sq / sig)


def emission_likelihoods_kn(X, mu, sigma, lmbda, normalize=True):
    """exp of :func:`emission_logliks_kn`, optionally max-normalised per
    (chain, t, node)."""
    ll = emission_logliks_kn(X, mu, sigma, lmbda)
    if normalize:
        ll = ll - torch.amax(ll, dim=2, keepdim=True)
    return torch.exp(ll)
