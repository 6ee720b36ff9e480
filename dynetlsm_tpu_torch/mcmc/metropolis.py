"""Adaptive Metropolis machinery (counterpart of
``dynetlsm_tpu/mcmc/metropolis.py``): step sizes and acceptance counters
are chain-batched tensors adapted with the reference's piecewise schedules
(reference metropolis.py:5-37, 122-136) and the JAX package's MALA
schedule; the random-walk accept and the
Dirichlet-proposal step of the social radii (metropolis.py:57-82); and
the reference's functional steps and self-tuning :class:`Metropolis` for
a user's log density (metropolis.py:40-136)."""
import torch

from ..config import DTYPE, resolve_device
from ..math.distributions import (
    _TINY, dirichlet_logpdf, normal, sample_dirichlet, uniform)

# (below, above): the schedule's rate bounds in the reference's if/elif
# order, the "below" ones first
_RW_BOUNDS = ((0.001, 0.05, 0.25), (0.95, 0.75, 0.4))
_RW_FACTORS = (0.1, 0.5, 0.9, 10.0, 2.0, 1.1)
# the Dirichlet proposal's concentration is inverse to its move size
_DIRICHLET_FACTORS = (10.0, 2.0, 1.1, 0.1, 0.5, 0.9)
# the joint MALA move's band around the 0.574 Langevin optimum
_MALA_BOUNDS = ((0.001, 0.20, 0.45), (0.95, 0.70))
_MALA_FACTORS = (0.1, 0.5, 0.9, 2.0, 1.1)


def _piecewise(step_size, acc_rate, bounds, factors):
    """step_size times the factor of the first matching condition (rate
    below each of ``bounds[0]``, then above each of ``bounds[1]``), as in
    the reference's if/elif chain."""
    conds = ([acc_rate < b for b in bounds[0]]
             + [acc_rate > b for b in bounds[1]])
    factor = torch.ones_like(acc_rate)
    for cond, f in reversed(tuple(zip(conds, factors))):
        factor = torch.where(cond, torch.full_like(acc_rate, f), factor)
    return step_size * factor


def tune_step_size_random_walk(step_size, acc_rate):
    """Piecewise step-size adaptation targeting 25-40% acceptance
    (reference metropolis.py:5-20)."""
    return _piecewise(step_size, acc_rate, _RW_BOUNDS, _RW_FACTORS)


def tune_step_size_dirichlet(step_size, acc_rate):
    """The inverted schedule: a larger Dirichlet ``step_size`` means
    smaller moves (reference metropolis.py:23-37)."""
    return _piecewise(step_size, acc_rate, _RW_BOUNDS, _DIRICHLET_FACTORS)


def tune_step_size_mala(step_size, acc_rate):
    """The joint MALA move's schedule, toward the 0.45-0.70 band around
    the 0.574 Langevin optimum (JAX ``tune_step_size_mala``; Roberts &
    Rosenthal 1998)."""
    return _piecewise(step_size, acc_rate, _MALA_BOUNDS, _MALA_FACTORS)


_TUNE_FNS = {'random_walk': tune_step_size_random_walk,
             'dirichlet': tune_step_size_dirichlet,
             'mala': tune_step_size_mala}


def maybe_tune(it, tune, tune_interval, step_size, n_accepted,
               kind='random_walk'):
    """Adapt ``step_size`` from the accumulated acceptances when a chain's
    tuning window closes, with the schedule of ``kind`` ('random_walk',
    'dirichlet' or 'mala').  ``it`` (C,) is each chain's sweep index
    before this sweep; ``step_size`` / ``n_accepted`` carry the chain axis
    first.
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


def _where(accept, x, x0):
    """x where ``accept`` (broadcast over x's trailing axes), else x0."""
    accept = accept.reshape(accept.shape + (1,) * (x.dim() - accept.dim()))
    return torch.where(accept, x, x0)


def random_walk_metropolis(gen, x0, logp_fn, step_size):
    """One Gaussian random-walk MH step of x0 against ``logp_fn``
    (reference metropolis.py:40-55).  Returns (x_new, accepted as a float
    tensor, the log ratio)."""
    x = x0 + step_size * normal(gen, x0.shape, x0.device)
    ratio = logp_fn(x) - logp_fn(x0)
    accept = random_walk_accept(gen, torch.as_tensor(ratio))
    return _where(accept, x, x0), accept.to(x0.dtype), ratio


def dirichlet_metropolis(gen, x0, logp_fn, step_size):
    """One MH step of x0 (n,) on the simplex with a Dirichlet(step_size *
    x0) proposal and its asymmetry correction (reference
    metropolis.py:57-82); the ratio in float64
    (:func:`dirichlet_mh_ratio`).  Returns (x_new, accepted as a float
    tensor, the log ratio)."""
    x = sample_dirichlet(gen, step_size * x0)
    s = torch.as_tensor(step_size, dtype=DTYPE, device=x0.device).reshape(1)
    ratio = dirichlet_mh_ratio(x0[None], x[None],
                               torch.as_tensor(logp_fn(x0)).reshape(1),
                               torch.as_tensor(logp_fn(x)).reshape(1), s)[0]
    accept = random_walk_accept(gen, ratio)
    return _where(accept, x, x0), accept.to(x0.dtype), ratio


class Metropolis:
    """Self-tuning MH sampler of a user's log density (reference
    metropolis.py:85-136): its step size, acceptance counters and the
    piecewise schedule of the in-sweep samplers, with a ``torch.Generator``
    seeded by ``seed`` on ``device`` (the card unless ``device='cpu'``;
    it raises without one, ``config.resolve_device``)."""

    def __init__(self, step_size=0.1, tune=500, tune_interval=100,
                 proposal_type='random_walk', seed=0, device='cuda'):
        if proposal_type not in ('random_walk', 'dirichlet'):
            raise ValueError("`proposal_type` must be in "
                             "{'random_walk', 'dirichlet'}, but got "
                             "%r" % (proposal_type,))
        self.step_size = step_size
        self.tune = tune
        self.tune_interval = tune_interval
        self.proposal_type = proposal_type
        self.n_accepted = 0
        self.n_steps = 0
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def step(self, x, logp):
        """One MH step from x; returns the new position (a tensor on the
        sampler's device)."""
        fn = (dirichlet_metropolis if self.proposal_type == 'dirichlet'
              else random_walk_metropolis)
        x_new, accepted, _ = fn(
            self.gen, torch.as_tensor(x, dtype=DTYPE, device=self.device),
            logp, self.step_size)
        self.n_accepted += float(accepted)
        self.n_steps += 1
        if self.tune:
            self.tune_step_size()
        return x_new

    def tune_step_size(self):
        """Adapt the step size from the window's acceptance rate every
        ``tune_interval`` steps during the first ``tune``."""
        if (self.n_steps < self.tune
                and self.n_steps % self.tune_interval == 0):
            rate = self.n_accepted / self.tune_interval
            tune_fn = (tune_step_size_dirichlet
                       if self.proposal_type == 'dirichlet'
                       else tune_step_size_random_walk)
            self.step_size = float(tune_fn(
                torch.tensor(self.step_size, dtype=DTYPE),
                torch.tensor(rate, dtype=DTYPE)))
            self.n_accepted = 0
