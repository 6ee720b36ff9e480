"""Bernoulli network log-likelihoods, undirected and directed social-radii
(counterpart of ``dynetlsm_tpu/ops/likelihoods.py``), on dense distances.

``softplus`` is ``logaddexp(eta, 0)``, the formula ``jax.nn.softplus``
computes; ``torch.nn.functional.softplus`` switches to the identity above
``threshold=20`` and would change the sum.  The dyad sums accumulate in
float64 and return float32: the kernels in ``ops/pair_loglik.py`` and
``ops/dir_loglik.py`` do the same, so each agrees with its dense
counterpart to float32 rounding of the total.
"""
import torch


def softplus(eta):
    return torch.logaddexp(eta, torch.zeros((), dtype=eta.dtype,
                                            device=eta.device))


def _offdiag_mask(n, dtype, device=None):
    return 1.0 - torch.eye(n, dtype=dtype, device=device)


def _dyad_sum(ll, n, scale=0.5):
    mask = _offdiag_mask(n, ll.dtype, ll.device)
    s = torch.sum(ll * mask, dim=(-3, -2, -1), dtype=torch.float64)
    return (scale * s).to(ll.dtype)


def undirected_loglik_full(Y, dist, intercept):
    """sum_{t, i<j} Y_tij * eta - softplus(eta), eta = intercept - dist.

    Y (T, n, n), or one network a chain (..., T, n, n); dist
    (..., T, n, n); intercept (...,).  Returns (...,)."""
    n = Y.shape[-1]
    eta = torch.as_tensor(intercept, dtype=dist.dtype,
                          device=dist.device)[..., None, None, None] - dist
    ll = Y.to(dist.dtype) * eta - softplus(eta)
    return _dyad_sum(ll, n)


def directed_eta(dist, radii, intercept_in, intercept_out):
    """eta_tij = b_in (1 - d_tij / r_j) + b_out (1 - d_tij / r_i)
    (reference directed_likelihoods_fast.pyx:199-202).

    dist (..., T, n, n); radii (..., n); intercepts (...,)."""
    d_in = 1.0 - dist / radii[..., None, None, :]    # divide by r_j (receiver)
    d_out = 1.0 - dist / radii[..., None, :, None]   # divide by r_i (sender)
    b_in = torch.as_tensor(intercept_in, dtype=dist.dtype,
                           device=dist.device)[..., None, None, None]
    b_out = torch.as_tensor(intercept_out, dtype=dist.dtype,
                            device=dist.device)[..., None, None, None]
    return b_in * d_in + b_out * d_out


def directed_network_probas(dist, radii, intercept_in, intercept_out):
    """Directed connection probabilities expit(directed_eta) with a zeroed
    diagonal (reference directed_likelihoods_fast.pyx:273-294).

    dist (..., T, n, n); radii (..., n).  Returns (..., T, n, n)."""
    n = dist.shape[-1]
    probas = torch.sigmoid(directed_eta(dist, radii, intercept_in,
                                        intercept_out))
    return probas * _offdiag_mask(n, probas.dtype, probas.device)


def directed_loglik_full(Y, dist, radii, intercept_in, intercept_out):
    """sum_{t, i != j} Y_tij * eta - softplus(eta), eta = directed_eta.

    Y (T, n, n) 0/1 (edge i -> j at Y[t, i, j]), or one network a chain
    (..., T, n, n); dist (..., T, n, n); radii (..., n).  Returns
    (...,)."""
    n = Y.shape[-1]
    eta = directed_eta(dist, radii, intercept_in, intercept_out)
    ll = Y.to(dist.dtype) * eta - softplus(eta)
    return _dyad_sum(ll, n, scale=1.0)


def undirected_network_probas(dist, intercept):
    """expit(intercept - dist) with a zeroed diagonal (reference
    lsm.py:290-308).  dist (..., T, n, n); intercept (...,)."""
    n = dist.shape[-1]
    b = torch.as_tensor(intercept, dtype=dist.dtype,
                        device=dist.device)[..., None, None, None]
    probas = torch.sigmoid(b - dist)
    return probas * _offdiag_mask(n, probas.dtype, probas.device)
