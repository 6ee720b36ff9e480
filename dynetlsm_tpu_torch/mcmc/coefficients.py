"""Intercept and social-radii Metropolis updates (counterpart of
``dynetlsm_tpu/mcmc/coefficients.py``, reference sample_coefficients.py).

Every candidate is scored from the positions without a distance tensor:
the undirected intercept's two candidates by ``ops/pair_loglik.py``, the
directed model's (b_in, b_out, radii) candidates by ``ops/dir_loglik.py``
(CUDA kernels for CUDA tensors, their plain versions for CPU tensors).
Under the case-control likelihood (``cc``, the structures of
``mcmc/sweeps.py::build_cc_dict``) every candidate is scored by the
case-control network estimator instead (``ops/case_control.py``, torch
code on any device; JAX coefficients.py:23-36, :55-60, :145-167), the
candidates of one step on one set of gathered distances.  Each sampler returns the
network log-likelihood at the accepted state, so the next step and the
sweep's log joint reuse it.  Under parallel tempering
each takes ``temper`` (C,), which scales the log-likelihood difference in
its ratio and nothing else (the returned log-likelihoods stay untempered).
The network is one for every chain, or each chain's own (C, T, n, n) when
missing dyads are resampled; the kernels read either.  A node-sharded
network (``ops.shards.RowShards``, ``mcmc/nodes.py``) is scored by the sum
of its shards' row-range shares, and node-sharded case-control structures
by the sum of theirs (``ops/case_control.py::cc_loglik``): the samplers
read them unchanged.
"""
import torch

from ..math.distributions import normal
from ..ops.case_control import cc_loglik, cc_network_loglik
from ..ops.dir_loglik import dir_loglik
from ..ops.pair_loglik import pair_loglik
from .metropolis import dirichlet_metropolis_step, random_walk_accept


def network_loglik(cfg, Y, X, intercept, radii=None, cc=None):
    """The untempered network log-likelihood (C,) of every chain at its
    current state, with one kernel launch: the pair kernel at one
    intercept undirected (Y 0/1 uint8), one ``dir_loglik`` candidate
    directed (Y packed ``Y + 2 Y^T``; radii (C, n)); their plain versions
    for CPU tensors.  Y (T, n, n) or (C, T, n, n).  With ``cc`` the
    case-control estimator, and Y is not read."""
    if cc is not None:
        return cc_network_loglik(X, intercept, radii, cc, cfg.is_directed)
    X = X.contiguous()
    if cfg.is_directed:
        return dir_loglik(Y, X, radii[:, None].contiguous(),
                          intercept[:, None].contiguous())[:, 0]
    return pair_loglik(Y, X, intercept[:, 0].contiguous())[:, 0]


def sample_intercept_undirected(gen, Y, X, intercept, step_size,
                                prior_mean, prior_var, temper=None, cc=None):
    """intercept (C, 1); step_size (C, 1); prior_mean / prior_var floats.
    Returns (new_intercept (C, 1), accepted (C, 1) float,
    loglik at the accepted intercept (C,))."""
    C = X.shape[0]
    prop = intercept + step_size * normal(gen, (C, 1), X.device)
    if cc is not None:
        ll = cc_loglik(X, cc, False, torch.cat([intercept, prop], dim=1))
    else:
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


def _cc_directed(X, radii, b_in, b_out, cc):
    return cc_loglik(X, cc, True, b_in, b_out, radii)


def sample_intercepts_directed(gen, Yp, X, intercept, radii, step_size,
                               prior_mean, prior_var, temper=None, cc=None):
    """Sequential MH for (b_in, b_out) (reference
    sample_coefficients.py:18-75): b_in's current and proposed values in
    one two-candidate kernel call, then b_out against the accepted b_in,
    whose log-likelihood is its current value.

    Yp (T, n, n) or (C, T, n, n) packed Y + 2 Y^T; X (C, T, n, d);
    intercept, step_size
    (C, 2); radii (C, n); prior_mean a pair of floats.  With ``cc``, two
    case-control evaluations (current and proposed b_in together, then the
    proposed b_out).
    Returns (new (C, 2), accepted (C, 2) float, loglik at the accepted
    state (C,))."""
    C = X.shape[0]
    X = X.contiguous()

    def logprior(b, idx):
        return -(b - prior_mean[idx]) ** 2 / (2.0 * prior_var)

    def tempered(delta_ll):
        return delta_ll if temper is None else temper * delta_ll

    b_in0, b_out0 = intercept[:, 0], intercept[:, 1]
    prop_in = b_in0 + step_size[:, 0] * normal(gen, (C,), X.device)
    if cc is not None:
        ll = _cc_directed(X, radii, torch.stack([b_in0, prop_in], -1),
                          torch.stack([b_out0, b_out0], -1), cc)
    else:
        b_cands = torch.stack([torch.stack([b_in0, b_out0], dim=-1),
                               torch.stack([prop_in, b_out0], dim=-1)],
                              dim=1)
        radii_cands = torch.stack([radii, radii], dim=1)
        ll = dir_loglik(Yp, X, radii_cands, b_cands)
    ll_cur, ll_prop = ll[:, 0], ll[:, 1]
    acc_in = random_walk_accept(
        gen, tempered(ll_prop - ll_cur) + logprior(prop_in, 0)
        - logprior(b_in0, 0))
    b_in = torch.where(acc_in, prop_in, b_in0)
    ll_in = torch.where(acc_in, ll_prop, ll_cur)

    prop_out = b_out0 + step_size[:, 1] * normal(gen, (C,), X.device)
    if cc is not None:
        ll_prop_out = _cc_directed(X, radii, b_in, prop_out, cc)
    else:
        ll_prop_out = dir_loglik(
            Yp, X, radii[:, None].contiguous(),
            torch.stack([b_in, prop_out], dim=-1)[:, None].contiguous())[:, 0]
    acc_out = random_walk_accept(
        gen, tempered(ll_prop_out - ll_in) + logprior(prop_out, 1)
        - logprior(b_out0, 1))
    b_out = torch.where(acc_out, prop_out, b_out0)
    ll_new = torch.where(acc_out, ll_prop_out, ll_in)
    acc = torch.stack([acc_in, acc_out], dim=-1).to(intercept.dtype)
    return torch.stack([b_in, b_out], dim=-1), acc, ll_new


def sample_radii(gen, Yp, X, intercept, radii, step_size, loglik_cur=None,
                 temper=None, cc=None):
    """Dirichlet-proposal MH on the radii simplex (reference
    sample_coefficients.py:91-121); the Dirichlet(1) prior is constant, so
    only the likelihood enters.  ``loglik_cur`` (C,) is the likelihood at
    the current radii, from the intercept step.  intercept (C, 2); radii
    (C, n); step_size (C,).  With ``cc`` the proposal is scored by the
    case-control estimator.  Returns (new_radii, accepted (C,) float,
    loglik at the accepted radii (C,))."""
    X = X.contiguous()
    b = intercept[:, None].contiguous()

    def logp(r):
        if cc is not None:
            return _cc_directed(X, r, intercept[:, 0], intercept[:, 1], cc)
        return dir_loglik(Yp, X, r[:, None].contiguous(), b)[:, 0]

    return dirichlet_metropolis_step(gen, radii, logp, step_size,
                                     logp_cur=loglik_cur, temper=temper)
