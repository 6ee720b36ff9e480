"""Posterior-marginalised and posterior-predictive one-step-ahead forecasts
(counterpart of ``dynetlsm_tpu/ops/forecast.py``), torch code on the fit's
device.

JAX's ``lax.scan`` over posterior samples becomes blocks of samples: each
block's (samples, n, n) terms are made at once and summed over the block
in float64, and the blocks' sums are added in float64.  A block holds at
most ``_BLOCK_ELEMS`` dyads, and always at least one sample, so no
(S, n, n) tensor of the whole trace is made.  The traces stay host numpy
arrays; each block is moved to the device on its turn.  The component
axis stays fixed at K, and the active-cluster renormalisation is a mask
over it, as in JAX.
"""
import numpy as np
import torch

from ..config import SMALL_EPS
from ..math.distributions import normal, uniform
from .distances import _sum_sq_last, pairwise_distances
from .likelihoods import _BLOCK_ELEMS

LOG_2PI = float(np.log(2.0 * np.pi))


def _sample_blocks(S, n):
    """Slices of at most ``_BLOCK_ELEMS`` dyads' worth of the S samples."""
    step = max(1, _BLOCK_ELEMS // (n * n))
    return [slice(s0, min(s0 + step, S)) for s0 in range(0, S, step)]


def _on(a, dev, dtype=torch.float32):
    return torch.as_tensor(a, dtype=dtype, device=dev)


def _active_mask(z, K):
    """(S, K) 0/1 float32 mask of the components that label some node of
    each sample's z (S, ...)."""
    active = torch.zeros((z.shape[0], K), dtype=torch.float32,
                         device=z.device)
    return active.scatter_(1, z.reshape(z.shape[0], -1), 1.0)


def _rows(w, z):
    """w[s, z[s, i]] : (S, K, K), (S, n) -> (S, n, K)."""
    return torch.gather(w, 1, z[..., None].expand(-1, -1, w.shape[-1]))


def _node_mixture_weights(x, x_prev, z, trans, mu, sigma, lmbda,
                          renormalize):
    """w_si = sum_k W_s[z_si, k] N(x_i ; lam_s mu_sk + (1 - lam_s)
    x_prev_si, sigma_sk I) of each sample s, with W_s the transition
    matrix, optionally renormalised over the sample's active components
    (JAX ``_node_mixture_weights``, one sample a row).

    x (n, d); x_prev (S, n, d); z (S, n) int64; trans (S, K, K); mu
    (S, K, d); sigma (S, K); lmbda (S,).  Returns (S, n)."""
    K = sigma.shape[1]
    if renormalize:
        active = _active_mask(z, K)[:, None, :]
        w = trans * active
        w = w / torch.clamp_min(torch.sum(w * active, dim=2, keepdim=True),
                                SMALL_EPS)
        w = w * active
    else:
        w = trans
    lam = lmbda[:, None, None, None]
    mean = lam * mu[:, None, :, :] + (1.0 - lam) * x_prev[:, :, None, :]
    ss = _sum_sq_last(x[None, :, None, :] - mean)            # (S, n, K)
    d = x.shape[-1]
    pdf = torch.exp(-0.5 * d * (LOG_2PI + torch.log(sigma))[:, None, :]
                    - 0.5 * ss / sigma[:, None, :])
    return torch.sum(_rows(w, z) * pdf, dim=-1)


def marginal_forecast(x, x_prev, z, trans_weights, mus, sigmas, intercepts,
                      lmbdas, renormalize=True, device='cpu'):
    """Importance-weighted posterior average of one-step-ahead edge
    probabilities (JAX ``marginal_forecast``, reference
    forecast.pyx:79-128), on ``device``.

    x (n, d) forecast-time plug-in positions; x_prev (S, n, d) last-time
    positions of each posterior sample; z (S, n) last-time labels;
    trans_weights (S, K, K) transition matrices of the last time; mus (S,
    K, d); sigmas (S, K); intercepts, lmbdas (S,).  Host arrays or
    tensors.  Returns (n, n) float64: the weighted sums divided by the
    summed weights (the diagonal's weights set to 1), the diagonal zero."""
    dev = torch.device(device)
    x = _on(x, dev)
    n = x.shape[0]
    dist = pairwise_distances(x)
    S = len(x_prev)
    probas = torch.zeros((n, n), dtype=torch.float64, device=dev)
    sum_w = torch.zeros((n, n), dtype=torch.float64, device=dev)
    for s in _sample_blocks(S, n):
        wi = _node_mixture_weights(
            x, _on(x_prev[s], dev), _on(z[s], dev, torch.int64),
            _on(trans_weights[s], dev), _on(mus[s], dev),
            _on(sigmas[s], dev), _on(lmbdas[s], dev), renormalize)
        wij = wi[:, :, None] * wi[:, None, :]                # (Sb, n, n)
        b = _on(intercepts[s], dev)[:, None, None]
        probas += torch.sum(wij * torch.sigmoid(b - dist), dim=0,
                            dtype=torch.float64)
        sum_w += torch.sum(wij, dim=0, dtype=torch.float64)
    sum_w = (sum_w / S).fill_diagonal_(1.0)
    probas = (probas / S) / torch.clamp_min(sum_w, SMALL_EPS)
    # the reference leaves the diagonal at zero (no self-loops)
    return probas.fill_diagonal_(0.0)


def _pp_forecast_step(u, eps, x_last, active, z_last, trans, mu, sigma,
                      intercept, lmbda):
    """Each posterior sample's predictive draw and its edge probabilities
    (JAX ``_pp_forecast_step``, one sample a row): next labels from the
    active-renormalised transition rows by a count-based inverse CDF (u
    clipped to [1e-12, the row total (1 - 1e-6)], so a roundoff tail stays
    on the last active component and u = 0 off a zero-mass prefix), then
    positions ``sigma[z] * eps + lam mu[z] + (1 - lam) x_last`` (the
    sampled variances as scale factors, as the reference uses them).

    u (S, n) uniforms; eps (S, n, d) normals; x_last (S, n, d); active
    (S, K) 0/1 over each sample's full label trace; z_last (S, n) int64;
    trans (S, K, K); mu (S, K, d); sigma (S, K); intercept, lmbda (S,).
    Returns (S, n, n) expit(intercept - dist) at the drawn positions."""
    w = trans * active[:, None, :]
    w = w / torch.clamp_min(torch.sum(w, dim=2, keepdim=True), SMALL_EPS)
    cdf = torch.cumsum(_rows(w, z_last), dim=2)              # (S, n, K)
    u = torch.minimum(torch.clamp_min(u, 1e-12),
                      cdf[..., -1] * (1.0 - 1e-6))
    zt = torch.sum((u[..., None] > cdf).to(torch.int64), dim=-1)
    lam = lmbda[:, None, None]
    mu_z = torch.gather(mu, 1, zt[..., None].expand(-1, -1, mu.shape[-1]))
    mean = lam * mu_z + (1.0 - lam) * x_last
    xt = torch.gather(sigma, 1, zt)[..., None] * eps + mean
    return torch.sigmoid(intercept[:, None, None] - pairwise_distances(xt))


def posterior_predictive_forecast(gen, x_last, z_full, trans_last, mus,
                                  sigmas, intercepts, lmbdas, u=None,
                                  eps=None, device='cpu'):
    """Posterior-predictive one-step-ahead edge probabilities (JAX
    ``posterior_predictive_forecast``, reference hdp_lpcm.py:590-630), on
    ``device``: for every posterior sample, labels drawn from the
    active-renormalised last transition row, positions from the mixture
    dynamics, and the average of ``expit(intercept - dist)``.

    x_last (S, n, d) last-time positions; z_full (S, T, n) full label
    traces (the active set is taken over every time, as the reference's
    label_utils.renormalize_weights takes it); trans_last (S, K, K); mus
    (S, K, d); sigmas (S, K); intercepts, lmbdas (S,).  The uniforms u (S,
    n) and normals eps (S, n, d) are drawn from the ``torch.Generator``
    ``gen`` on ``device``, a block of samples at a time (u, then eps),
    unless given.  Returns (n, n) float64, the diagonal at the average of
    expit(intercept), as in the reference."""
    dev = torch.device(device)
    S, n, d = np.shape(x_last)
    K = np.shape(trans_last)[-1]
    probas = torch.zeros((n, n), dtype=torch.float64, device=dev)
    for s in _sample_blocks(S, n):
        Sb = s.stop - s.start
        zf = _on(z_full[s], dev, torch.int64)
        ub = uniform(gen, (Sb, n), dev) if u is None else _on(u[s], dev)
        eb = (normal(gen, (Sb, n, d), dev) if eps is None
              else _on(eps[s], dev))
        p = _pp_forecast_step(
            ub, eb, _on(x_last[s], dev), _active_mask(zf, K), zf[:, -1],
            _on(trans_last[s], dev), _on(mus[s], dev), _on(sigmas[s], dev),
            _on(intercepts[s], dev), _on(lmbdas[s], dev))
        probas += torch.sum(p, dim=0, dtype=torch.float64)
    return probas / S
