"""Adaptive Metropolis machinery (counterpart of
``dynetlsm_tpu/mcmc/metropolis.py``): step sizes and acceptance counters
are chain-batched tensors adapted with the reference's piecewise schedules
(reference metropolis.py:5-37, 122-136); the random-walk accept and the
Dirichlet-proposal step of the social radii (metropolis.py:57-82)."""
import torch

from ..math.distributions import (
    _TINY, dirichlet_logpdf, sample_dirichlet, uniform)

_CONDS = (lambda r: r < 0.001, lambda r: r < 0.05, lambda r: r < 0.25,
          lambda r: r > 0.95, lambda r: r > 0.75, lambda r: r > 0.4)
_RW_FACTORS = (0.1, 0.5, 0.9, 10.0, 2.0, 1.1)
# the Dirichlet proposal's concentration is inverse to its move size
_DIRICHLET_FACTORS = (10.0, 2.0, 1.1, 0.1, 0.5, 0.9)


def _piecewise(step_size, acc_rate, factors):
    """step_size times the factor of the first matching condition, as in
    the reference's if/elif chain."""
    factor = torch.ones_like(acc_rate)
    for cond, f in reversed(tuple(zip(_CONDS, factors))):
        factor = torch.where(cond(acc_rate), torch.full_like(acc_rate, f),
                             factor)
    return step_size * factor


def tune_step_size_random_walk(step_size, acc_rate):
    """Piecewise step-size adaptation targeting 25-40% acceptance
    (reference metropolis.py:5-20)."""
    return _piecewise(step_size, acc_rate, _RW_FACTORS)


def tune_step_size_dirichlet(step_size, acc_rate):
    """The inverted schedule: a larger Dirichlet ``step_size`` means
    smaller moves (reference metropolis.py:23-37)."""
    return _piecewise(step_size, acc_rate, _DIRICHLET_FACTORS)


_TUNE_FNS = {'random_walk': tune_step_size_random_walk,
             'dirichlet': tune_step_size_dirichlet}


def maybe_tune(it, tune, tune_interval, step_size, n_accepted,
               kind='random_walk'):
    """Adapt ``step_size`` from the accumulated acceptances when a chain's
    tuning window closes, with the schedule of ``kind`` ('random_walk' or
    'dirichlet').  ``it`` (C,) is each chain's sweep index before this
    sweep; ``step_size`` / ``n_accepted`` carry the chain axis first.
    Returns (new_step_size, new_n_accepted)."""
    if not tune:
        return step_size, n_accepted
    do_tune = (it < tune) & ((it + 1) % tune_interval == 0)
    do_tune = do_tune.reshape((-1,) + (1,) * (step_size.dim() - 1))
    rate = n_accepted / tune_interval
    new_step = torch.where(do_tune, _TUNE_FNS[kind](step_size, rate),
                           step_size)
    new_acc = torch.where(do_tune, torch.zeros_like(n_accepted), n_accepted)
    return new_step, new_acc


def random_walk_accept(gen, logp_diff):
    """MH accept for symmetric proposals, batched over ``logp_diff``.
    The uniform is clamped away from 0 before the log."""
    u = uniform(gen, logp_diff.shape, logp_diff.device, minval=_TINY)
    return torch.log(u) < logp_diff


def dirichlet_mh_ratio(x0, x, logp_cur, logp_prop, step_size, temper=None):
    """Log MH ratio (C,) float64 of a move x0 -> x (C, n) under a
    Dirichlet(step_size * x0) proposal: the target difference, times
    ``temper`` (C,) when given (parallel tempering), plus the proposal
    asymmetry correction, in the JAX package's op order (reference
    metropolis.py:57-82; dynetlsm_tpu/mcmc/metropolis.py:95-100).
    step_size (C,).

    The correction is evaluated in float64: its lgamma terms are ~2e6 at
    step_size 175000 and cancel to O(1), so in float32 (as the JAX package
    evaluates it) the ratio is off by 0.1-0.7 nat at n = 12 to 500."""
    f64 = torch.float64
    s = step_size[:, None].to(f64)
    x0, x = x0.to(f64), x.to(f64)
    ratio = logp_prop.to(f64) - logp_cur.to(f64)
    if temper is not None:
        ratio = temper.to(f64) * ratio
    return ratio + (dirichlet_logpdf(x0, s * x) - dirichlet_logpdf(x, s * x0))


def dirichlet_metropolis_step(gen, x0, logp_fn, step_size, logp_cur=None,
                              temper=None):
    """One MH step per chain with a Dirichlet(step_size * x0) proposal
    (reference metropolis.py:57-82).  x0 (C, n); step_size (C,);
    ``logp_fn(x)`` returns the (C,) target log density, and ``logp_cur``
    reuses an already computed ``logp_fn(x0)``.  ``temper`` (C,) scales the
    target difference in the ratio; the returned log densities stay
    untempered.  Returns (x_new, accepted (C,) float, logp_new)."""
    x = sample_dirichlet(gen, step_size[:, None] * x0)
    logp_prop = logp_fn(x)
    if logp_cur is None:
        logp_cur = logp_fn(x0)
    accept = random_walk_accept(
        gen, dirichlet_mh_ratio(x0, x, logp_cur, logp_prop, step_size,
                                temper))
    x_new = torch.where(accept[:, None], x, x0)
    logp_new = torch.where(accept, logp_prop, logp_cur)
    return x_new, accept.to(x0.dtype), logp_new
