"""Latent-position Metropolis update, exact scheme (counterpart of
``dynetlsm_tpu/mcmc/latent.py::sample_latent_positions``).

One call runs the exact sequential single-site scan over every (t, node)
site of C chains: the CUDA node-scan kernel for CUDA tensors at every n,
its plain PyTorch version for CPU tensors (``ops/node_scan.py``, which
also holds the per-partner likelihood terms and the prior terms of each
site's conditional).
"""
import torch

from ..math.distributions import normal, uniform
from ..ops.node_scan import (  # noqa: F401  (re-exported counterparts)
    _directed_partial_loglik_terms, _mixture_prior_per_t,
    _partial_loglik_terms, _rw_prior_per_t, node_scan, site_cluster_params)


def latent_noise(gen, C, T, n, d, device):
    """The proposal stream of one scan: eps (C, 2, n, T, d) standard
    normals and log_u (C, 2, n, T) log-uniforms, in the JAX scan's
    layout."""
    eps = normal(gen, (C, 2, n, T, d), device)
    log_u = torch.log(uniform(gen, (C, 2, n, T), device))
    return eps, log_u


def sample_latent_positions(gen, Y, X, intercept, step_size, *, mu=None,
                            sigma=None, lmbda=None, z=None, tau_sq=None,
                            sigma_sq=None, radii=None, is_directed=False,
                            mixture=True, scheme='exact', noise=None,
                            cc=None, temper=None):
    """One full sweep of single-site MH updates of the positions under the
    mixture prior (mu, sigma, lmbda, z) or, with ``mixture=False``, the
    Gaussian random-walk prior of the LSM (tau_sq, sigma_sq).

    Undirected: Y (T, n, n) uint8 0/1, intercept (C, 1).  Directed
    (``is_directed``): Y the packed ``Y + 2 Y^T`` uint8, intercept (C, 2)
    = (b_in, b_out), radii (C, n).  Y may have its rows padded
    (``ops.node_scan.pad_partners``), as the sweeps store it.
    X (C, T, n, d); step_size (C, T, n); mu (C, K, d); sigma (C, K);
    lmbda (C,); z (C, T, n); tau_sq, sigma_sq floats.  ``noise`` =
    (eps, log_u) injects the proposal stream.  ``temper`` (C,) scales
    each chain's log-likelihood delta (parallel tempering; ``None``:
    untempered).  Returns (X_new (C, T, n, d), accepted (C, T, n))."""
    if scheme != 'exact':
        raise NotImplementedError(
            "latent_update=%r is not ported yet; only 'exact'" % (scheme,))
    if is_directed and radii is None:
        raise ValueError('the directed latent update needs radii')
    if cc is not None:
        raise NotImplementedError('the case-control likelihood is not '
                                  'ported yet')
    C, T, n, d = X.shape
    eps, log_u = (noise if noise is not None
                  else latent_noise(gen, C, T, n, d, X.device))
    if mixture:
        mu_z, sig_z = site_cluster_params(mu, sigma, z)
        prior = dict(mu_z=mu_z, sig_z=sig_z, lmbda=lmbda.contiguous())
    else:
        prior = dict(tau_sq=tau_sq, sigma_sq=sigma_sq, mixture=False)
    b = intercept if is_directed else intercept.reshape(C)
    return node_scan(Y, X.contiguous(), b.contiguous(),
                     step_size.contiguous(), eps, log_u,
                     radii=radii.contiguous() if is_directed else None,
                     temper=None if temper is None else temper.contiguous(),
                     **prior)
