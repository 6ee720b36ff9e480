"""Undirected Bernoulli network log-likelihoods (counterpart of the
undirected part of ``dynetlsm_tpu/ops/likelihoods.py``).

``softplus`` is ``logaddexp(eta, 0)``, the formula ``jax.nn.softplus``
computes; ``torch.nn.functional.softplus`` switches to the identity above
``threshold=20`` and would change the sum.  The dyad sums accumulate in
float64 and return float32: the kernel in ``ops/pair_loglik.py`` does the
same, so the two agree to float32 rounding of the total.
"""
import torch


def softplus(eta):
    return torch.logaddexp(eta, torch.zeros((), dtype=eta.dtype,
                                            device=eta.device))


def _offdiag_mask(n, dtype, device=None):
    return 1.0 - torch.eye(n, dtype=dtype, device=device)


def _dyad_sum(ll, n):
    mask = _offdiag_mask(n, ll.dtype, ll.device)
    s = torch.sum(ll * mask, dim=(-3, -2, -1), dtype=torch.float64)
    return (0.5 * s).to(ll.dtype)


def undirected_loglik_full(Y, dist, intercept):
    """sum_{t, i<j} Y_tij * eta - softplus(eta), eta = intercept - dist.

    Y (T, n, n); dist (..., T, n, n); intercept (...,).  Returns (...,)."""
    n = Y.shape[-1]
    eta = torch.as_tensor(intercept, dtype=dist.dtype,
                          device=dist.device)[..., None, None, None] - dist
    ll = Y.to(dist.dtype) * eta - softplus(eta)
    return _dyad_sum(ll, n)


def undirected_loglik_pair(Y, dist, b_cur, b_prop):
    """The full undirected log-likelihood at two intercepts against the
    same distances (the intercept MH step's two candidates)."""
    return (undirected_loglik_full(Y, dist, b_cur),
            undirected_loglik_full(Y, dist, b_prop))
