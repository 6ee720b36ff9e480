"""Parallel tempering (replica exchange) across the chain axis (counterpart
of ``dynetlsm_tpu/mcmc/tempering.py`` and of the estimator-side helpers in
``dynetlsm_tpu/models/base.py:104-134``).

Each chain slot carries a fixed inverse temperature ``state.temper``
(beta).  The sweeps temper only the network likelihood: the latent update
(the node-scan kernel's tempered lane), the intercept step(s) and the radii
step scale their log-likelihood differences by beta; the prior-side blocks
do not see Y.  After every ``swap_every`` sweeps, adjacent-temperature slots
of each ladder propose to exchange configurations (pairs (0, 1), (2, 3), ..
and (1, 2), .. on alternating rounds), accepted with probability
exp((beta_i - beta_j) (ll_j - ll_i)), ll the untempered network
log-likelihood.  Only the model configuration (``_SWAP_FIELDS``, with the
network ``Y`` when missing dyads are resampled) moves; the slot's step
sizes, counters, ``it``, ``temper``, ``acc_swap``, ``missing_sum`` and the
LSM's MAP and Procrustes reference stay.  Posterior samples are read from
the cold (beta = 1) slots, the first of each block of ``n_temps``.

On the card the swap's log-likelihood comes from the port's kernels (the
pair kernel undirected, one ``dir_loglik`` candidate directed), never from
a (C, T, n, n) distance tensor, and nothing in the step waits on the host.
"""
import dataclasses

import numpy as np
import torch

from ..config import DTYPE
from ..math.distributions import uniform
from ..tracing import traced
from .coefficients import network_loglik
from .driver import replicate_state
from .sweeps import kernel_network

# the state fields a replica swap exchanges: the model configuration
_SWAP_FIELDS = frozenset({
    'X', 'intercept', 'radii', 'Y', 'logp',
    'z', 'mu', 'sigma', 'lmbda', 'weights', 'beta', 'gamma', 'alpha_init',
    'alpha', 'kappa', 'init_weights', 'trans_weights', 'mean_var', 'b_scale',
})


def temper_ladder(n_temps, beta_min=0.1, n_ladders=1, device='cpu'):
    """Geometric inverse-temperature ladder(s), cold chain first: a
    (n_ladders * n_temps,) float32 tensor whose blocks of ``n_temps`` run
    from 1 to ``beta_min``."""
    if n_temps < 2:
        raise ValueError('a temperature ladder needs n_temps >= 2')
    one = np.geomspace(1.0, beta_min, n_temps)
    return torch.as_tensor(np.tile(one, n_ladders), dtype=DTYPE,
                           device=device)


def replicate_tempered(state0, betas, device):
    """Broadcast a single-chain state (a dict of arrays, as
    ``driver.replicate_state`` takes) across the ladder slots, attach the
    inverse temperatures ``betas`` and zero the swap counters."""
    betas = torch.as_tensor(betas, dtype=DTYPE, device=device)
    state = replicate_state(state0, betas.shape[0], device)
    return state.replace(temper=betas, acc_swap=torch.zeros_like(betas))


def _swap_partners(n_chains, n_temps, device='cpu'):
    """Adjacent-pair partner indices (int64) of the two alternating phases,
    confined to each ladder's block of ``n_temps`` slots; a slot without a
    partner in a phase is its own."""
    if n_chains % n_temps:
        raise ValueError('n_chains=%d is not a whole number of %d-slot '
                         'ladders' % (n_chains, n_temps))
    idx = np.arange(n_chains)
    j = idx % n_temps
    partners = []
    for phase in (0, 1):
        p = idx.copy()
        lo = (j % 2 == phase) & (j + 1 < n_temps)
        p[lo] = idx[lo] + 1
        hi = (j > 0) & ((j - 1) % 2 == phase)
        p[hi] = idx[hi] - 1
        partners.append(torch.as_tensor(p, dtype=torch.int64, device=device))
    return partners


def _adapt_ladder(temper, acc_swap, n_temps, n_attempts, eta=0.6):
    """One ladder-adaptation step: move each ladder's log-beta spacings
    toward equal swap acceptance of its pairs, keeping its endpoints
    (1, beta_min).  ``acc_swap[i]`` counts accepted swaps of the pair
    (i, i + 1) since the last adaptation, each pair attempted
    ``n_attempts`` times."""
    C = temper.shape[0]
    L = C // n_temps
    tb = temper.reshape(L, n_temps)
    rate = (acc_swap.reshape(L, n_temps)[:, :n_temps - 1]
            / max(n_attempts, 1.0))
    logb = torch.log(torch.clamp_min(tb, 1e-30))
    s = logb[:, :-1] - logb[:, 1:]
    s_new = s * torch.exp(eta * (rate - torch.mean(rate, dim=1,
                                                   keepdim=True)))
    s_new = s_new * (torch.sum(s, dim=1, keepdim=True)
                     / torch.clamp_min(torch.sum(s_new, dim=1, keepdim=True),
                                       1e-30))
    logb_new = torch.cat([torch.zeros((L, 1), dtype=temper.dtype,
                                      device=temper.device),
                          -torch.cumsum(s_new, dim=1)], dim=1)
    return torch.exp(logb_new).reshape(C)


def swap_loglik(cfg, Y, state):
    """The untempered network log-likelihood (C,) of every slot, one kernel
    launch (``coefficients.network_loglik``): on the stored network Y (0/1
    uint8 undirected, packed ``Y + 2 Y^T`` directed), or with
    ``cfg.sample_missing`` on each slot's own ``state.Y``."""
    if cfg.sample_missing:
        Y = kernel_network(cfg, state.Y)
    return network_loglik(cfg, Y, state.X, state.intercept, state.radii)


@traced
def replica_exchange(cfg, Y, state, partner, log_u, do=None):
    """One round of adjacent replica exchange.  ``partner`` (C,) pairs the
    slots (a slot paired with itself sits out); ``log_u`` (C,) holds
    log-uniforms, of which the pair (i, partner) uses the one at
    min(i, partner), so both ends decide alike; ``do`` (a 0-d bool tensor or
    ``None``) masks the whole round on the device.  Permutes the fields of
    ``_SWAP_FIELDS`` and counts accepted swaps at the pair heads in
    ``acc_swap``."""
    ll = swap_loglik(cfg, Y, state)
    idx = torch.arange(ll.shape[0], device=ll.device)
    delta = (state.temper - state.temper[partner]) * (ll[partner] - ll)
    accept = (partner != idx) & (log_u[torch.minimum(idx, partner)] < delta)
    if do is not None:
        accept = accept & do
    perm = torch.where(accept, partner, idx)
    changes = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is not None and f.name in _SWAP_FIELDS:
            changes[f.name] = v[perm]
    if state.acc_swap is not None:
        head = accept & (partner == idx + 1)
        changes['acc_swap'] = state.acc_swap + head.to(state.acc_swap.dtype)
    return state.replace(**changes)


def make_pt_step(sweep_fn, cfg, Y, n_temps, swap_every=1, adapt_until=0,
                 adapt_interval=100):
    """Wrap a chain-batched sweep into a parallel-tempering step
    ``pt_step(state, gen, log_u=None) -> state`` for a state with
    ``temper`` (and ``acc_swap``): the sweep, then, every ``swap_every``
    sweeps, one round of :func:`replica_exchange` with partner phase
    ``(it0 // swap_every) % 2``, ``it0`` the sweep index before the sweep.
    ``Y`` is the sweep's stored network (``sweep.Y``; ``None`` with
    ``cfg.sample_missing``, which scores each slot's ``state.Y``).
    ``log_u`` (C,) injects the swap's log-uniforms (drawn from ``gen``
    otherwise).  With ``adapt_until > 0`` the ladder adapts every
    ``adapt_interval`` sweeps while ``it0 < adapt_until``.  Every
    condition is a mask on the device, so the step never waits on the
    host.  ``pt_step(state, gen)`` plugs into ``driver.make_scan_runner``;
    it carries ``cfg``, ``Y`` and ``n_temps``, and as ``pt_step.eager``
    the step over the sweep run eager (``sweep.eager``)."""
    if cfg.n_control is not None:
        raise ValueError('parallel tempering with the case-control '
                         'likelihood is not supported (the tempered '
                         'estimator would need its own control sets)')
    step = _pt_step(sweep_fn, cfg, Y, n_temps, swap_every, adapt_until,
                    adapt_interval)
    eager = getattr(sweep_fn, 'eager', None)
    step.eager = step if eager is None else _pt_step(
        eager, cfg, Y, n_temps, swap_every, adapt_until, adapt_interval)
    return step


def _pt_step(sweep_fn, cfg, Y, n_temps, swap_every, adapt_until,
             adapt_interval):
    partners = {}   # (C, device) -> the two phases' partners, made once
    # each pair is a phase head once per two swap rounds
    n_attempts = adapt_interval / (2.0 * swap_every)

    def pt_step(state, gen, log_u=None):
        if state.temper is None:
            raise ValueError('pt_step needs a tempered state (temper set)')
        C = state.temper.shape[0]
        dev = state.temper.device
        if (C, dev) not in partners:
            partners[C, dev] = _swap_partners(C, n_temps, dev)
        partner0, partner1 = partners[C, dev]
        it0 = state.it[0]
        state = sweep_fn(state, gen)
        if log_u is None:
            log_u = torch.log(uniform(gen, (C,), dev))
        partner = torch.where((it0 // swap_every) % 2 == 0, partner0,
                              partner1)
        do = None if swap_every == 1 else (it0 + 1) % swap_every == 0
        state = replica_exchange(cfg, Y, state, partner, log_u, do)
        if adapt_until > 0 and state.acc_swap is not None:
            do_adapt = (it0 < adapt_until) & ((it0 + 1) % adapt_interval == 0)
            temper = _adapt_ladder(state.temper, state.acc_swap, n_temps,
                                   n_attempts)
            state = state.replace(
                temper=torch.where(do_adapt, temper, state.temper),
                acc_swap=torch.where(do_adapt,
                                     torch.zeros_like(state.acc_swap),
                                     state.acc_swap))
        return state

    pt_step.cfg = cfg
    pt_step.Y = Y
    pt_step.n_temps = n_temps
    return pt_step


def _every(state, k):
    """The slots 0, k, 2k, .. of a chain-batched state."""
    return state.replace(**{f.name: getattr(state, f.name)[::k]
                            for f in dataclasses.fields(state)
                            if getattr(state, f.name) is not None})


def cold_slot_trace_fn(trace_fn, n_temps):
    """Record traces from the cold (beta = 1) slots only: slot 0 of each
    ladder block (``trace_fn`` as ``driver.make_scan_runner`` takes it)."""
    if n_temps is None or int(n_temps) <= 1:
        return trace_fn
    k = int(n_temps)

    def cold(state):
        return trace_fn(_every(state, k))

    return cold


def strip_hot_slots(state, n_temps):
    """Keep only the cold (beta = 1) slots of the final state.  Returns
    ``(cold_state, ladder)``, ``ladder`` the full inverse-temperature array
    (NumPy), or ``None`` for an untempered run."""
    if n_temps is None or int(n_temps) <= 1:
        return state, None
    ladder = (state.temper.detach().cpu().numpy()
              if state.temper is not None else None)
    return _every(state, int(n_temps)), ladder
