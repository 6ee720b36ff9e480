"""Conjugate Gibbs blocks for the mixture parameters and their
hyper-priors (counterpart of ``dynetlsm_tpu/mcmc/conjugate.py``),
chain-batched.

Sufficient statistics are einsums over the one-hot responsibilities
(float32, TF32 off).  Each sampler is ``*_from_draws`` (deterministic, the
random numbers given) plus a draw.
"""
import torch

from ..config import SMALL_EPS
from ..math.distributions import (
    _F32_TINY, gamma_draws, gamma_fixed_from_draws, inv_gamma_from_draws,
    normal, truncated_normal_from_uniform, uniform)
from ..ops.node_scan import site_cluster_params
from ..tracing import traced


def cluster_means_from_draws(X, resp, nk, sigma, lmbda, mean_var, noise):
    """Gaussian conjugate update of the component means (reference
    hdp_lpcm.py:901-920).  X (C, T, n, d); resp (C, T, n, K); nk (C, T, K);
    sigma (C, K); lmbda, mean_var (C,); noise (C, K, d)."""
    T = X.shape[1]
    lam = lmbda[:, None]
    X_prev = torch.cat([torch.zeros_like(X[:, :1]), X[:, :-1]], dim=1)
    nk_rest = (torch.sum(nk[:, 1:], dim=1) if T > 1
               else torch.zeros_like(nk[:, 0]))
    pk = (1.0 / mean_var[:, None] + nk[:, 0] / sigma
          + (lam ** 2 / sigma) * nk_rest)
    m0 = torch.einsum('cik,cid->ckd', resp[:, 0], X[:, 0]) / sigma[..., None]
    diff_rest = X[:, 1:] - (1.0 - lmbda)[:, None, None, None] * X_prev[:, 1:]
    m_rest = torch.einsum('ctik,ctid->ckd', resp[:, 1:], diff_rest)
    mk = m0 + (lam / sigma)[..., None] * m_rest
    var = 1.0 / pk
    return var[..., None] * mk + torch.sqrt(var)[..., None] * noise


@traced
def sample_cluster_means(gen, X, resp, nk, sigma, lmbda, mean_var):
    C, K = sigma.shape
    noise = normal(gen, (C, K, X.shape[-1]), X.device)
    return cluster_means_from_draws(X, resp, nk, sigma, lmbda, mean_var,
                                    noise)


def cluster_variances_from_draws(X, resp, nk, mu, lmbda, a, b, draws):
    """Inverse-gamma update of the spherical component variances
    (reference hdp_lpcm.py:923-937), residual sums of squares in
    expanded-square form.  b (C,) is the InvGamma prior scale."""
    T, d = X.shape[1], X.shape[-1]
    lam = lmbda[:, None]
    ak = 0.5 * (torch.sum(nk, dim=1) * d + a)                    # (C, K)
    mu_sq = torch.sum(mu * mu, dim=-1)                           # (C, K)
    x0_sq = torch.sum(X[:, 0] * X[:, 0], dim=-1)                 # (C, n)
    s0 = torch.einsum('cik,cid->ckd', resp[:, 0], X[:, 0])
    ss0 = (torch.einsum('cik,ci->ck', resp[:, 0], x0_sq)
           - 2.0 * torch.sum(s0 * mu, dim=-1) + nk[:, 0] * mu_sq)
    if T > 1:
        base = X[:, 1:] - (1.0 - lmbda)[:, None, None, None] * X[:, :-1]
        base_sq = torch.sum(base * base, dim=-1)                 # (C,T-1,n)
        sb = torch.einsum('ctik,ctid->ckd', resp[:, 1:], base)
        nk_rest = torch.sum(nk[:, 1:], dim=1)
        ss_rest = (torch.einsum('ctik,cti->ck', resp[:, 1:], base_sq)
                   - 2.0 * lam * torch.sum(sb * mu, dim=-1)
                   + (lam * lam) * nk_rest * mu_sq)
    else:
        ss_rest = torch.zeros_like(ss0)
    bk = 0.5 * b[:, None] + 0.5 * (ss0 + ss_rest)
    # float32 floor against sigma -> 0 (see the JAX block)
    return torch.clamp_min(inv_gamma_from_draws(ak, bk, draws), 1e-8)


@traced
def sample_cluster_variances(gen, X, resp, nk, mu, lmbda, a, b):
    draws = gamma_draws(gen, mu.shape[:2], X.device)
    return cluster_variances_from_draws(X, resp, nk, mu, lmbda, a, b, draws)


def lambda_from_draws(X, z, mu, sigma, lambda_prior, lambda_variance_prior,
                      u):
    """Truncated-normal conjugate update of the blending coefficient
    (reference hdp_lpcm.py:939-954) from a uniform u (C,)."""
    if X.shape[1] == 1:
        mean = torch.full_like(u, lambda_prior)
        var = torch.full_like(u, lambda_variance_prior)
        return truncated_normal_from_uniform(mean, var, u)
    mu_z, sig_z = site_cluster_params(mu, sigma, z[:, 1:])
    sig_z = sig_z[..., None]
    ml_diff = (mu_z - X[:, :-1]) / sig_z
    X_diff = X[:, 1:] - X[:, :-1]
    ml = torch.sum(ml_diff * X_diff, dim=(1, 2, 3))
    sl = 1.0 / lambda_variance_prior + torch.sum(
        (mu_z - X[:, :-1]) ** 2 / sig_z, dim=(1, 2, 3))
    sl = 1.0 / sl
    ml = sl * (ml + lambda_prior / lambda_variance_prior)
    return truncated_normal_from_uniform(ml, sl, u)


@traced
def sample_lambda(gen, X, z, mu, sigma, lambda_prior, lambda_variance_prior):
    u = uniform(gen, X.shape[:1], X.device, minval=_F32_TINY)
    return lambda_from_draws(X, z, mu, sigma, lambda_prior,
                             lambda_variance_prior, u)


def mean_variance_from_draws(mu, a0, b0, draws):
    """Inverse-gamma update of the prior variance of the cluster means
    (reference hdp_lpcm.py:957-964)."""
    C, K = mu.shape[:2]
    b = 0.5 * b0 + 0.5 * torch.sum(mu * mu, dim=(1, 2))
    a = torch.full((C,), 0.5 * (a0 + K), dtype=mu.dtype, device=mu.device)
    return torch.clamp_min(inv_gamma_from_draws(a, b, draws), 1e-8)


@traced
def sample_mean_variance_hyper(gen, mu, a0, b0):
    return mean_variance_from_draws(mu, a0, b0,
                                    gamma_draws(gen, mu.shape[:1], mu.device))


def sigma_scale_from_draws(sigma, a, c0, d0, draws):
    """Gamma update of the scale of the InvGamma prior on the cluster
    variances (reference hdp_lpcm.py:967-972)."""
    C, K = sigma.shape
    scale = 0.5 * d0 + 0.5 * torch.sum(
        1.0 / torch.clamp_min(sigma, SMALL_EPS), dim=1)
    shape = torch.full((C,), 0.5 * (c0 + K * a), dtype=sigma.dtype,
                       device=sigma.device)
    return torch.clamp_min(gamma_fixed_from_draws(shape, draws) / scale,
                           1e-8)


@traced
def sample_sigma_scale_hyper(gen, sigma, a, c0, d0):
    return sigma_scale_from_draws(
        sigma, a, c0, d0, gamma_draws(gen, sigma.shape[:1], sigma.device))
