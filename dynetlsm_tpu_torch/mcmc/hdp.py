"""Sticky HDP-HMM auxiliary-variable samplers (counterpart of
``dynetlsm_tpu/mcmc/hdp.py``), chain-batched.

The CRF table counts draw the first ``cap`` Bernoulli terms of each cell
exactly and the remaining tail as one Poisson with the exact tail mean
(Le Cam bound, see the JAX module); the Poisson is the JAX package's
truncated inverse-CDF / rounded-Normal sampler.  ``*_from_draws`` cores
take the random numbers explicitly.
"""
import torch

from ..config import SMALL_EPS
from ..math.distributions import (
    normal, sample_beta, sample_gamma, sample_gamma_fixed, uniform)
from ..tracing import traced


def _fast_poisson_from_draws(lam, u, z, n_terms=8):
    """Poisson(lam) from a uniform u (inverse CDF over ``n_terms`` terms,
    for lam <= 2.5) and a normal z (rounded Normal, for lam > 2.5)."""
    term = torch.exp(-lam)
    cdf = term
    small = torch.zeros_like(lam)
    for j in range(1, n_terms + 1):
        small = small + (u > cdf).to(lam.dtype)
        term = term * lam / j
        cdf = cdf + term
    large = torch.round(lam + torch.sqrt(torch.clamp_min(lam, 0.0)) * z)
    return torch.where(lam > 2.5, torch.clamp_min(large, 0.0), small)


def _table_probs(beta, alpha_init, alpha, kappa, T):
    """Success probabilities p (C, T, K, K) of the CRF Bernoulli terms."""
    C, K = beta.shape
    eye = torch.eye(K, dtype=beta.dtype, device=beta.device)
    p_t = (alpha[:, None, None] * beta[:, None, :]
           + kappa[:, None, None] * eye)                        # (C, K, K)
    p = p_t[:, None].expand(C, T, K, K).clone()
    p[:, 0] = 0.0
    p[:, 0, 0] = alpha_init[:, None] * beta
    # float32 guard: beta of inactive clusters can underflow to 0
    return torch.clamp_min(p, SMALL_EPS)


def table_draws(gen, n_trans, n_max, cap=64):
    """(u_head (C, L, T*K*K), u_tail, z_tail (C, T, K, K))."""
    C, T, K, _ = n_trans.shape
    L = min(cap, n_max)
    dev = n_trans.device
    return (uniform(gen, (C, L, T * K * K), dev),
            uniform(gen, (C, T, K, K), dev), normal(gen, (C, T, K, K), dev))


def tables_from_draws(n_trans, beta, alpha_init, alpha, kappa, n_max, cap,
                      draws):
    C, T, K, _ = n_trans.shape
    u_head, u_tail, z_tail = draws
    p = _table_probs(beta, alpha_init, alpha, kappa, T)
    L = min(cap, n_max)
    cells = T * K * K
    i_col = torch.arange(L, dtype=torch.float32,
                         device=p.device)[None, :, None]        # (1, L, 1)
    p_row = p.reshape(C, 1, cells)
    # u < p/(p+i)  <=>  u*i < p*(1-u); i = 0 always succeeds
    trial = ((u_head * i_col < p_row * (1.0 - u_head))
             | (i_col == 0.0)).to(torch.float32)
    mask = i_col < n_trans.reshape(C, 1, cells)
    m = torch.sum(torch.where(mask, trial, torch.zeros_like(trial)),
                  dim=1).reshape(C, T, K, K)
    if n_max > L:
        c = n_trans.to(torch.float32)
        tail_len = torch.clamp_min(c - L, 0.0)
        tail_mean = torch.where(
            tail_len > 0.0,
            p * (torch.special.digamma(p + torch.clamp_min(c, float(L)))
                 - torch.special.digamma(p + L)),
            torch.zeros_like(p))
        tail = _fast_poisson_from_draws(tail_mean, u_tail, z_tail)
        m = m + torch.minimum(torch.clamp_min(tail, 0.0), tail_len)
    return m


@traced
def sample_tables(gen, n_trans, beta, alpha_init, alpha, kappa, n_max,
                  cap=64):
    """CRF table counts m (C, T, K, K) (reference sample_auxillary.py:6-28).
    n_trans (C, T, K, K) transition counts, n_trans[:, 0, 0] the initial
    counts; beta (C, K); alpha_init, alpha, kappa (C,)."""
    return tables_from_draws(n_trans, beta, alpha_init, alpha, kappa, n_max,
                             cap, table_draws(gen, n_trans, n_max, cap))


def mbar_draws(gen, m, n_max, cap=64):
    """(u_head (C, T-1, K, L), z_tail (C, T-1, K))."""
    C, T, K, _ = m.shape
    L = min(cap, n_max)
    return (uniform(gen, (C, T - 1, K, L), m.device),
            normal(gen, (C, T - 1, K), m.device))


def mbar_from_draws(m, beta, kappa, alpha, n_max, cap, draws):
    u_head, z_tail = draws
    rho = (kappa / (alpha + kappa))[:, None]                    # (C, 1)
    p = rho / (rho + beta * (1.0 - rho))                        # (C, K)
    diag_m = torch.diagonal(m[:, 1:], dim1=-2, dim2=-1)         # (C,T-1,K)
    L = min(cap, n_max)
    i = torch.arange(L, dtype=torch.float32, device=m.device)
    trial = (u_head < p[:, None, :, None]).to(torch.float32)
    w = torch.sum(torch.where(i < diag_m[..., None], trial,
                              torch.zeros_like(trial)), dim=-1)
    if n_max > L:
        tail_len = torch.clamp_min(diag_m - L, 0.0)
        mean = tail_len * p[:, None, :]
        var = mean * (1.0 - p[:, None, :])
        tail = torch.round(mean + torch.sqrt(torch.clamp_min(var, 0.0))
                           * z_tail)
        w = w + torch.minimum(torch.clamp_min(tail, 0.0), tail_len)
    m_bar_sum = (torch.sum(m[:, 1:], dim=(1, 2)) - torch.sum(w, dim=1)
                 + m[:, 0, 0])
    return m_bar_sum, w


@traced
def sample_mbar(gen, m, beta, kappa, alpha, n_max, cap=64):
    """Sticky override counts w (C, T-1, K) and the corrected table counts
    summed to m_bar (C, K) (reference sample_auxillary.py:31-50).
    Returns (m_bar_sum, w)."""
    return mbar_from_draws(m, beta, kappa, alpha, n_max, cap,
                           mbar_draws(gen, m, n_max, cap))


@traced
def sample_concentration_param(gen, alpha, n_clusters, n_samples,
                               prior_shape=1.0, prior_rate=1.0):
    """Escobar & West (1995) auxiliary-variable update of a concentration
    (reference sample_concentration.py:6-21); every argument (C,)."""
    n_s = torch.clamp_min(n_samples, 1.0)
    eta = sample_beta(gen, alpha + 1.0, n_s)
    m_shape = prior_shape + n_clusters - 1.0
    m_scale = prior_rate - torch.log(torch.clamp_min(eta, SMALL_EPS))
    log_odds = (m_shape / m_scale) / n_s
    mix = uniform(gen, alpha.shape, alpha.device) < (log_odds
                                                    / (1.0 + log_odds))
    m_shape = torch.where(mix, m_shape + 1.0, m_shape)
    m_shape = torch.clamp_min(m_shape, 0.01)
    return sample_gamma(gen, m_shape, m_scale)


@traced
def sample_alpha_kappa_rho(gen, n_trans, m, w, alpha, kappa,
                           alpha_kappa_shape, alpha_kappa_rate,
                           rho_a=8.0, rho_b=2.0):
    """Joint (alpha + kappa) gamma-augmentation update and the stickiness
    fraction rho ~ Beta (reference hdp_lpcm.py:998-1023); rows with no
    transitions are masked out.  Returns (alpha_new, kappa_new)."""
    alpha_kappa = alpha + kappa                                  # (C,)
    n_dot = torch.sum(n_trans[:, 1:], dim=3)                     # (C,T-1,K)
    valid = n_dot > 0
    ak = alpha_kappa[:, None, None]
    s = uniform(gen, n_dot.shape, n_dot.device) < (n_dot / (n_dot + ak))
    ga = sample_gamma_fixed(gen, (ak + 1.0).expand(n_dot.shape).contiguous())
    gb = sample_gamma_fixed(gen, torch.clamp_min(n_dot, SMALL_EPS))
    r = ga / torch.clamp_min(ga + gb, SMALL_EPS)

    zero = torch.zeros_like(n_dot)
    m_dot = torch.sum(m[:, 1:], dim=3)
    shape = (alpha_kappa_shape
             + torch.sum(torch.where(valid, m_dot, zero), dim=(1, 2))
             - torch.sum(torch.where(valid, s.to(n_dot.dtype), zero),
                         dim=(1, 2)))
    rate = alpha_kappa_rate - torch.sum(
        torch.where(valid, torch.log(torch.clamp_min(r, SMALL_EPS)), zero),
        dim=(1, 2))
    alpha_kappa = sample_gamma(gen, shape, rate)

    n_success = torch.sum(w, dim=(1, 2))
    rho = sample_beta(gen, rho_a + n_success,
                      torch.clamp_min(torch.sum(m[:, 1:], dim=(1, 2, 3))
                                      - n_success + rho_b, SMALL_EPS))
    kappa_new = alpha_kappa * rho
    return alpha_kappa - kappa_new, kappa_new
