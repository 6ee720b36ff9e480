"""Adaptive Metropolis machinery (counterpart of
``dynetlsm_tpu/mcmc/metropolis.py``): step sizes and acceptance counters
are chain-batched tensors adapted with the reference's piecewise schedule
(reference metropolis.py:5-20, 122-136)."""
import torch

from ..math.distributions import _TINY, uniform

_RW_CONDS = ((lambda r: r < 0.001, 0.1), (lambda r: r < 0.05, 0.5),
             (lambda r: r < 0.25, 0.9), (lambda r: r > 0.95, 10.0),
             (lambda r: r > 0.75, 2.0), (lambda r: r > 0.4, 1.1))


def tune_step_size_random_walk(step_size, acc_rate):
    """Piecewise step-size adaptation targeting 25-40% acceptance; the
    first matching branch wins, as in the reference's if/elif chain."""
    factor = torch.ones_like(acc_rate)
    for cond, f in reversed(_RW_CONDS):
        factor = torch.where(cond(acc_rate), torch.full_like(acc_rate, f),
                             factor)
    return step_size * factor


def maybe_tune(it, tune, tune_interval, step_size, n_accepted):
    """Adapt ``step_size`` from the accumulated acceptances when a chain's
    tuning window closes.  ``it`` (C,) is each chain's sweep index before
    this sweep; ``step_size`` / ``n_accepted`` carry the chain axis first.
    Returns (new_step_size, new_n_accepted)."""
    if not tune:
        return step_size, n_accepted
    do_tune = (it < tune) & ((it + 1) % tune_interval == 0)
    do_tune = do_tune.reshape((-1,) + (1,) * (step_size.dim() - 1))
    rate = n_accepted / tune_interval
    new_step = torch.where(do_tune,
                           tune_step_size_random_walk(step_size, rate),
                           step_size)
    new_acc = torch.where(do_tune, torch.zeros_like(n_accepted), n_accepted)
    return new_step, new_acc


def random_walk_accept(gen, logp_diff):
    """MH accept for symmetric proposals, batched over ``logp_diff``.
    The uniform is clamped away from 0 before the log."""
    u = uniform(gen, logp_diff.shape, logp_diff.device, minval=_TINY)
    return torch.log(u) < logp_diff
