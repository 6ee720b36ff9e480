"""Intercept Metropolis update of the undirected model (counterpart of
``dynetlsm_tpu/mcmc/coefficients.py::sample_intercept_undirected``,
reference sample_coefficients.py:77-86).

Both candidates are scored by ``ops/pair_loglik.py``: the CUDA pair kernel
for CUDA tensors at every n (no (C, T, n, n) distance tensor is built),
its plain version for CPU tensors.
"""
import torch

from ..math.distributions import normal
from ..ops.pair_loglik import pair_loglik
from .metropolis import random_walk_accept


def sample_intercept_undirected(gen, Y, X, intercept, step_size,
                                prior_mean, prior_var, temper=None):
    """intercept (C, 1); step_size (C, 1); prior_mean / prior_var floats.
    Returns (new_intercept (C, 1), accepted (C, 1) float,
    loglik at the accepted intercept (C,))."""
    C = X.shape[0]
    prop = intercept + step_size * normal(gen, (C, 1), X.device)
    ll = pair_loglik(Y, X.contiguous(), intercept[:, 0].contiguous(),
                     prop[:, 0].contiguous())
    ll_cur, ll_prop = ll[:, 0], ll[:, 1]

    def logprior(b):
        return -(b[:, 0] - prior_mean) ** 2 / (2.0 * prior_var)

    delta_ll = ll_prop - ll_cur
    if temper is not None:
        delta_ll = temper * delta_ll
    accept = random_walk_accept(
        gen, delta_ll + logprior(prop) - logprior(intercept))
    new = torch.where(accept[:, None], prop, intercept)
    ll_new = torch.where(accept, ll_prop, ll_cur)
    return new, accept.to(intercept.dtype)[:, None], ll_new
