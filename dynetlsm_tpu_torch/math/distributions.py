"""Samplers and densities used by the Gibbs blocks (counterpart of
``dynetlsm_tpu/math/distributions.py``).

The samplers port the JAX package's algorithms, not torch's exact ones:
the fixed-round Marsaglia-Tsang gamma with the ``U^(1/alpha)`` boost for
alpha < 1, inverse-CDF truncated normals, and the same ``_TINY`` /
``SMALL_EPS`` clamps.  Each sampler is split into a draw
(``*_draws(gen, ...)``, the only place randomness enters) and a
deterministic core (``*_from_draws``), so tests can feed the core the
numbers the JAX block drew.
"""
import math

import torch

from ..config import DTYPE, SMALL_EPS

_TINY = 1e-20
_F32_TINY = SMALL_EPS


def uniform(gen, shape, device, minval=0.0):
    """U[minval, 1) float32 draws; ``minval`` > 0 keeps logs finite."""
    u = torch.rand(shape, generator=gen, device=device, dtype=DTYPE)
    return torch.clamp_min(u, minval) if minval > 0.0 else u


def normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device, dtype=DTYPE)


def gumbel(gen, shape, device):
    """Standard Gumbel draws, -log(-log(u)) with u in [tiny, 1)."""
    u = uniform(gen, shape, device, minval=_F32_TINY)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# Gamma (fixed-round) / Dirichlet
# ---------------------------------------------------------------------------

def gamma_draws(gen, shape, device, n_rounds=2):
    """The random numbers one :func:`sample_gamma_fixed` call consumes:
    (normals (R, *shape), uniforms (R, *shape), boost uniforms (*shape))."""
    shape = tuple(shape)
    return (normal(gen, (n_rounds,) + shape, device),
            uniform(gen, (n_rounds,) + shape, device, minval=_TINY),
            uniform(gen, shape, device, minval=_TINY))


def gamma_fixed_from_draws(alpha, draws):
    """Gamma(alpha, 1): fixed-round Marsaglia-Tsang on alpha (alpha >= 1)
    or alpha + 1 boosted by U^(1/alpha) (alpha < 1).  Unaccepted draws
    fall back to the last round's squeezed proposal."""
    xs, us, ub = draws
    small = alpha < 1.0
    a_core = torch.where(small, alpha + 1.0, alpha)
    d = a_core - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    w = 1.0 + c * xs
    v = w * w * w
    log_v = torch.log(torch.clamp_min(v, _TINY))
    ok = (v > 0.0) & (torch.log(us) < (0.5 * xs * xs + d - d * v
                                       + d * log_v))
    val = d * torch.clamp_min(v[-1], _TINY)
    for r in range(xs.shape[0] - 1, -1, -1):
        val = torch.where(ok[r], d * v[r], val)
    boost = torch.exp(torch.log(ub) / torch.clamp_min(alpha, _TINY))
    return torch.where(small, val * boost, val)


def sample_gamma_fixed(gen, alpha, n_rounds=2):
    return gamma_fixed_from_draws(
        alpha, gamma_draws(gen, alpha.shape, alpha.device, n_rounds))


def dirichlet_from_draws(alphas, draws):
    """Dirichlet(alphas) over the last axis from fixed-round gammas, with
    the JAX package's clipping and renormalisation."""
    alphas = torch.clamp_min(alphas, SMALL_EPS)
    g = torch.clamp_min(gamma_fixed_from_draws(alphas, draws), SMALL_EPS)
    out = g / torch.sum(g, dim=-1, keepdim=True)
    out = torch.clamp_min(out, SMALL_EPS)
    return out / torch.sum(out, dim=-1, keepdim=True)


def sample_dirichlet(gen, alphas):
    return dirichlet_from_draws(
        alphas, gamma_draws(gen, alphas.shape, alphas.device))


def dirichlet_logpdf(x, alphas):
    """Log density of Dirichlet(alphas) at x over the last axis, with the
    reference's clipping."""
    alphas = torch.clamp_min(alphas, SMALL_EPS)
    x = torch.clamp_min(x, SMALL_EPS)
    return (torch.sum((alphas - 1.0) * torch.log(x), dim=-1)
            + torch.lgamma(torch.sum(alphas, dim=-1))
            - torch.sum(torch.lgamma(alphas), dim=-1))


def sample_gamma(gen, shape, rate):
    """Gamma(shape, rate) (mean shape / rate)."""
    return sample_gamma_fixed(gen, shape) / rate


def inv_gamma_from_draws(shape, rate, draws):
    """1 / Gamma(shape, rate), i.e. InvGamma(shape, scale=rate)."""
    return rate / torch.clamp_min(gamma_fixed_from_draws(shape, draws),
                                  SMALL_EPS)


def beta_from_draws(a, b, draws_a, draws_b):
    ga = gamma_fixed_from_draws(a, draws_a)
    gb = gamma_fixed_from_draws(b, draws_b)
    return ga / torch.clamp_min(ga + gb, SMALL_EPS)


def sample_beta(gen, a, b):
    return beta_from_draws(a, b, gamma_draws(gen, a.shape, a.device),
                           gamma_draws(gen, b.shape, b.device))


# ---------------------------------------------------------------------------
# Truncated normal on (lower, upper)
# ---------------------------------------------------------------------------

def truncated_normal_from_uniform(mean, var, u, lower=0.0, upper=1.0):
    """Inverse-CDF draw of N(mean, var) truncated to (lower, upper) from a
    uniform u in (0, 1), clamped into the open interval."""
    std = torch.sqrt(var)
    a = (lower - mean) / std
    b = (upper - mean) / std
    ua, ub = torch.special.ndtr(a), torch.special.ndtr(b)
    p = torch.clamp(ua + u * (ub - ua), 1e-6, 1.0 - 1e-6)
    draw = mean + std * torch.special.ndtri(p)
    margin = 1e-6 * (upper - lower)
    return torch.clamp(draw, lower + margin, upper - margin)


def truncated_normal_logpdf(x, mean, var, lower=0.0, upper=1.0):
    """Log density of N(mean, var) truncated to (lower, upper); ``mean`` and
    ``var`` are Python floats (the prior's hyperparameters)."""
    std = math.sqrt(var)
    a = (lower - mean) / std
    b = (upper - mean) / std
    z = (x - mean) / std
    log_phi = -0.5 * (z * z) - 0.5 * math.log(2.0 * math.pi) - math.log(std)
    mass = 0.5 * (math.erfc(-b / math.sqrt(2.0))
                  - math.erfc(-a / math.sqrt(2.0)))
    log_mass = math.log(max(mass, SMALL_EPS))
    inside = (x > lower) & (x < upper)
    return torch.where(inside, log_phi - log_mass,
                       torch.full_like(x, -math.inf))


def _on(v, gen, like=None):
    """v as a float32 tensor on the device of the tensor ``like`` (or of
    v itself, if a tensor), else of the generator ``gen``."""
    if like is not None:
        dev = like.device
    elif torch.is_tensor(v):
        dev = v.device
    else:
        dev = gen.device
    return torch.as_tensor(v, dtype=DTYPE, device=dev)


def truncated_normal(gen, mean, var, lower=0.0, upper=1.0):
    """N(mean, var) truncated to (lower, upper), one draw per element of
    ``mean``, by the inverse CDF, strictly inside the interval (reference
    distributions.py:72-77)."""
    mean = _on(mean, gen)
    u = uniform(gen, mean.shape, mean.device,
                minval=torch.finfo(DTYPE).tiny)
    return truncated_normal_from_uniform(mean, _on(var, gen, mean), u,
                                         lower, upper)


def sample_categorical_logits(gen, logits, axis=-1):
    """Categorical draws by Gumbel-argmax over ``axis`` of the logits."""
    return torch.argmax(logits + gumbel(gen, logits.shape, logits.device),
                        dim=axis)


def sample_categorical(gen, probas, axis=-1):
    """Categorical(probas) draws along ``axis`` (reference
    distributions.py:13-19), by Gumbel-argmax of the clamped
    log-probabilities."""
    return sample_categorical_logits(
        gen, torch.log(torch.clamp_min(probas, _TINY)), axis=axis)


def sample_inv_gamma(gen, shape, rate):
    """1 / Gamma(shape, rate), i.e. InvGamma(shape, scale=rate), from the
    fixed-round gamma (the reference draws ``1 / rng.gamma(shape=a,
    scale=1/b)``, e.g. hdp_lpcm.py:937)."""
    shape = _on(shape, gen)
    return inv_gamma_from_draws(
        shape, rate, gamma_draws(gen, shape.shape, shape.device))


# ---------------------------------------------------------------------------
# densities (reference distributions.py:22-69)
# ---------------------------------------------------------------------------


def multivariate_t_logpdf(x, df, mu0, S):
    """Log density of a multivariate t with ``df`` degrees of freedom,
    location mu0 and a scalar (spherical) or (p, p) scale S."""
    x = torch.atleast_1d(torch.as_tensor(x))
    mu0 = torch.atleast_1d(torch.as_tensor(mu0, dtype=x.dtype,
                                           device=x.device))
    p = x.shape[-1]
    S = torch.as_tensor(S, dtype=x.dtype, device=x.device)
    df = torch.as_tensor(df, dtype=x.dtype, device=x.device)
    if S.dim() < 2:
        rss = torch.sum((x - mu0) ** 2, dim=-1) / S
        log_var = p * 0.5 * torch.log(S)
    else:
        L = torch.linalg.cholesky(S)
        r = x - mu0
        sol = torch.linalg.solve_triangular(
            L, r[:, None] if r.dim() == 1 else r, upper=False)
        rss = torch.sum(sol * sol, dim=0)
        if r.dim() == 1:
            rss = rss[0]
        log_var = torch.sum(torch.log(torch.diagonal(L)))
    return (torch.lgamma((p + df) / 2.0) - torch.lgamma(df / 2.0) - log_var
            - (p / 2.0) * torch.log(df * math.pi)
            - 0.5 * (df + p) * torch.log1p(rss / df))


def multivariate_t_pdf(x, df, mu0, S):
    return torch.exp(multivariate_t_logpdf(x, df, mu0, S))


# the reference's spelling (reference distributions.py:42)
multivariate_t_log_pdf = multivariate_t_logpdf


def spherical_normal_log_pdf(x, mean, var):
    """Log density of N(mean, var I) over the trailing axis, batched over
    the leading ones (reference distributions.py:22-28)."""
    x = torch.as_tensor(x)
    mean = torch.atleast_1d(torch.as_tensor(mean, dtype=x.dtype,
                                            device=x.device))
    var = torch.as_tensor(var, dtype=x.dtype, device=x.device)
    p = mean.shape[-1]
    sum_sq = torch.sum((x - mean) ** 2, dim=-1)
    return -0.5 * p * torch.log(2.0 * math.pi * var) - 0.5 * sum_sq / var


def spherical_normal_pdf(x, mean, var):
    """(reference distributions.py:31-39)"""
    return torch.exp(spherical_normal_log_pdf(x, mean, var))
