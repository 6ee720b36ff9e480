"""The comparison that decides ``correct`` for the undirected sticky
HDP-LPCM with the exact, 'parallel' or chromatic case-control latent
update: the window's last sweep of every chain, judged by the plain
reference (``hdp_lpcm.py``, ``mixture.py``, ``case_control.py``).  A cell
names this module in its ``workloads/<cell>.json`` (``"reference"``).

What is compared, from the state that entered the last sweep, the state
it left and the generator's states around it:

* ``mh_gap``: every Metropolis decision of the sweep's latent update (each
  site of each chain) and of its intercept step, held against the
  reference's log ratio.  A decision on
  the wrong side of the reference's ratio counts by how far the
  reference's ratio lies from the log-uniform that decided it, over the
  sum of the magnitudes of the terms the ratio is made of (its scale of
  rounding: float32 rounds a ratio by ~1e-7 of it, TF32 by ~5e-4); a
  site or intercept whose new value is neither its old value nor its
  proposal counts ``ALTERED``.  The number is the widest of these gaps (0
  when every decision agrees).
* ``logp_gap``: the program's log joint of the final state (the value it
  records every sweep) against the reference's log joint of the same
  fields, over the sum of the magnitudes of the joint's terms, per chain.
  It reaches the mixture blocks (labels, tables, Dirichlet and conjugate
  draws, concentrations) through the fields they leave: the reference
  recounts the labels' transitions and recomputes every prior term.
* ``mix_pit_z``: the mixture blocks' draws (labels, initial and
  transition weights, cluster means and variances, lambda, the mean
  variance, b_scale) against their full conditionals, teacher-forced on
  the fields in effect when the sweep drew each (``mixture.py``): the
  widest of the blocks' standard-normal scores (two of each block's PITs,
  and the labels' log-probability score), pooled over the chains (one
  number for the run).
* ``stale``: per chain, the fields that every sound sweep redraws from a
  continuous law (positions, means, variances, weights, beta, the
  concentrations, the hyper-parameters) that left the sweep bit for bit
  as they entered it, plus one when the generator's state after the sweep
  is the one before it or the one before the previous sweep (a sweep
  that replays one stream).  Exact: the limit is 0.

The proposals and log-uniforms are the generator's: the judge replays them
from its state before the sweep, in the order the sweep draws them (the
latent update's normals and uniforms, then the intercept's normal and
uniform).  The reference reads the program's new positions only to take
each site's partners as the program left them when the site was updated
(teacher forcing), and to judge them.

The control (``control=True``) puts the reference in the program's place
at the nearest lower precision, TF32 (``hdp_lpcm.Arith('tf32')``): its
decisions and its log joint, on the same states and draws, judged the
same way.
"""
import numpy as np
import torch

from . import mixture
from .case_control import CaseControlLik, conflict_colors, draw_controls
from .hdp_lpcm import (
    Arith, DenseLik, intercept_log_ratio, latent_log_ratios, log_joint)

ALTERED = 1e6
_TINY = 1e-20
REF = Arith('float64')
# the fields every sound sweep redraws from a continuous law (lambda is
# not one: a draw whose conditional lies past a bound of (0, 1) is put on
# the bound's margin, the same value sweep after sweep)
REDRAWN = ('X', 'mu', 'sigma', 'weights', 'beta', 'gamma', 'alpha_init',
           'alpha', 'kappa', 'mean_var', 'b_scale')
MIXTURE = REDRAWN[1:] + ('z', 'lmbda')
# the faults the judge can plant in the program's place (readings.py):
# the mixture blocks' faults of ``mixture.FAULTS``, the mixture fields left
# as they entered the sweep, and a generator that did not advance
FAULTS = mixture.FAULTS + ('mixture_unchanged', 'generator_not_advanced')


def replay_noise(gen_state, scheme, C, T, n, d, device):
    """(eps (C, T, n, d), log_u (C, T, n), the intercept's normal (C,) and
    log-uniform (C,)) of a sweep from its generator state: the exact
    scan draws a (C, 2, n, T, d) normal field and (C, 2, n, T) uniforms and
    site (t, j) reads phase t % 2; 'parallel' draws one per site."""
    g = torch.Generator(device=device)
    g.set_state(gen_state)
    f32 = dict(generator=g, device=device, dtype=torch.float32)
    if scheme == 'exact':
        eps = torch.randn((C, 2, n, T, d), **f32)
        log_u = torch.log(torch.rand((C, 2, n, T), **f32))
        t = torch.arange(T, device=device)
        eps = eps.permute(0, 1, 3, 2, 4)[:, t % 2, t]
        log_u = log_u.permute(0, 1, 3, 2)[:, t % 2, t]
    elif scheme == 'parallel':
        eps = torch.randn((C, T, n, d), **f32)
        log_u = torch.log(torch.rand((C, T, n), **f32))
    else:
        raise ValueError('no replay of the %r latent update' % (scheme,))
    eps_b = torch.randn((C, 1), **f32)[:, 0]
    log_ub = torch.log(torch.clamp_min(torch.rand((C,), **f32), _TINY))
    return eps, log_u, eps_b, log_ub


def uncentre(X_after, X_old, x_prop):
    """The latent update's output before the sweep centred it, from the
    centred positions: each site holds its old position or its proposal
    shifted by one offset a chain.  Returns (the output (C, T, n, d), the
    accepted sites (C, T, n) bool, the sites that match neither candidate
    (C, T, n) bool)."""
    C = X_old.shape[0]
    v_rej = (X_old - X_after).reshape(C, -1, X_old.shape[-1])
    v_acc = (x_prop - X_after).reshape(C, -1, X_old.shape[-1])
    scale = 1.0 + float(torch.max(torch.abs(X_old)))
    tol = 1e-5 * scale
    # one of each site's two candidates is the offset: the offset is the
    # candidate of the first sites that most sites share
    cands = torch.cat([v_rej[:, :16], v_acc[:, :16]], dim=1)
    best, best_count = None, None
    for k in range(cands.shape[1]):
        m = cands[:, k:k + 1]
        near = torch.minimum(torch.amax(torch.abs(v_rej - m), -1),
                             torch.amax(torch.abs(v_acc - m), -1)) <= tol
        count = near.sum(1)
        if best is None:
            best, best_count = m.clone(), count
        else:
            better = count > best_count
            best = torch.where(better[:, None, None], m, best)
            best_count = torch.where(better, count, best_count)
    d_rej = torch.amax(torch.abs(v_rej - best), -1)
    d_acc = torch.amax(torch.abs(v_acc - best), -1)
    acc = (d_acc < d_rej).reshape(X_old.shape[:-1])
    altered = (torch.minimum(d_rej, d_acc) > tol).reshape(X_old.shape[:-1])
    return torch.where(acc[..., None], x_prop, X_old), acc, altered


def _gaps(decided, ref_ratio, mag, log_u, altered):
    """Per element: 0 where ``decided`` agrees with the reference
    (log_u < ratio), else |ratio - log_u| over the ratio's magnitude
    ``mag``; ``ALTERED`` where altered."""
    ref = log_u.to(ref_ratio.dtype) < ref_ratio
    gap = torch.where(decided != ref,
                      torch.abs(ref_ratio - log_u.to(ref_ratio.dtype))
                      / torch.clamp_min(mag, 1.0), 0.0)
    return torch.where(altered, torch.full_like(gap, ALTERED), gap)


def stale_fields(before, after, gens):
    """(C,) the ``stale`` count (module docstring); ``gens`` the
    generator's states (before the previous sweep, before the last, after
    it)."""
    C = before['X'].shape[0]
    count = torch.zeros(C, dtype=torch.float64)
    for k in REDRAWN:
        if k in before and k in after:
            a, b = before[k].reshape(C, -1), after[k].reshape(C, -1)
            count += torch.all(a == b, dim=1).cpu().to(torch.float64)
    prev, now, nxt = gens
    if torch.equal(now, nxt) or (prev is not None and torch.equal(prev, now)):
        count += 1.0
    return count


def mixture_scores(X, before, after, sw, seed, fault=None):
    """({block: its widest score}, the widest over the blocks) of a
    sweep's mixture draws (``mixture.block_pits``): a block's two PIT
    scores, or the labels' log-probability score; the labels'
    randomisation and any fault's draws come from ``seed``."""
    C, T, n = after['z'].shape
    g = torch.Generator().manual_seed(int(seed) % 2 ** 63)
    v = torch.rand((C, T, n), generator=g, dtype=torch.float64).to(X.device)
    pits = mixture.block_pits(X, before, after, sw, v, fault=fault,
                              rng=np.random.default_rng(int(seed)))
    blocks = {k: abs(u) if isinstance(u, float)
              else max(mixture.pit_scores(u)) for k, u in pits.items()}
    return blocks, max(blocks.values())


def judge(Y, before, after, gen_state, scheme, sw, K, control=False,
          cc=None):
    """The Metropolis and log-joint numbers of one run's last sweep, per
    chain: {'mh_gap': (C,), 'logp_gap': (C,)}.  Y (T, n, n) uint8 the network;
    ``before`` / ``after`` dicts of the state's fields entering and
    leaving the sweep; ``gen_state`` the generator's state before it;
    ``scheme`` the latent update ('exact' or 'parallel'); ``sw`` the
    configuration's constants.  ``cc`` (the case-control likelihood: {'m',
    'color_seed', 'ctrl_seed', 'every'}): the network term is the
    estimator with the controls the reference redraws for the sweep, the
    scan chromatic.  ``control``: the TF32 reference decides and computes
    the log joint in the program's place."""
    X_old, X_after = before['X'], after['X']
    C, T, n, d = X_old.shape
    dev = X_old.device
    eps, log_u, eps_b, log_ub = replay_noise(gen_state, scheme, C, T, n, d,
                                             dev)
    x_prop = X_old + before['step_X'][..., None] * eps
    X_new, acc, altered = uncentre(X_after, X_old, x_prop)
    if cc is None:
        lik = DenseLik(Y)
        rank = torch.arange(n, device=dev)
    else:
        rank = conflict_colors(Y, cc['color_seed'])
        it0 = int(before['it'][0]) // cc['every'] * cc['every']
        ctrl = draw_controls(rank, cc['m'], cc['ctrl_seed'], it0)
        lik = CaseControlLik(Y, ctrl)
        if not torch.equal(after['ctrl_out'].to(dev), ctrl):
            # the sweep ran on controls other than the draw it states
            altered = torch.ones_like(altered)
    if scheme == 'parallel':
        rank = None
    b_old = before['intercept'][:, 0]
    b_prop = b_old + before['step_int'][:, 0] * eps_b
    b_after = after['intercept'][:, 0]
    acc_b = torch.abs(b_after - b_prop) < torch.abs(b_after - b_old)
    altered_b = torch.minimum(torch.abs(b_after - b_prop),
                              torch.abs(b_after - b_old)) > 1e-6 * (
                                  1.0 + torch.abs(b_old))
    args = (lik, X_old, X_new, x_prop, b_old, before['mu'], before['sigma'],
            before['lmbda'], before['z'], rank)
    ratio, mag = latent_log_ratios(REF, *args)
    coef = (lik, X_after, b_old, b_prop, sw['intercept_prior_mean'],
            sw['intercept_variance_prior'])
    ratio_b, ll, mag_b = intercept_log_ratio(REF, *coef)
    net_ll = torch.where(acc_b, ll[:, 1], ll[:, 0])
    fields = dict(after)
    logp = fields.pop('logp')
    logp_ref, mag_logp = log_joint(
        REF, lik, fields, sw, K,
        net_ll=None if bool(altered_b.any()) else net_ll)
    decided = acc
    decided_b = acc_b
    if control:
        ctl = Arith('tf32')
        decided = log_u < latent_log_ratios(ctl, *args)[0]
        decided_b = log_ub < intercept_log_ratio(ctl, *coef)[0]
        logp = log_joint(ctl, lik, fields, sw, K)[0]
        altered = torch.zeros_like(altered)
        altered_b = torch.zeros_like(altered_b)
    gap_sites = _gaps(decided, ratio, mag, log_u, altered)
    gap_b = _gaps(decided_b, ratio_b, mag_b, log_ub, altered_b)
    mh = torch.maximum(torch.amax(gap_sites, dim=(1, 2)), gap_b)
    logp_rel = torch.abs(logp.to(torch.float64) - logp_ref) / mag_logp
    return {'mh_gap': mh.cpu(), 'logp_gap': logp_rel.cpu()}


def judge_capture(spec, capture, seeds, device, control=False, fault=None):
    """The compared numbers of a run's last sweep: per chain (C,) for
    ``mh_gap``, ``logp_gap`` and ``stale``, one 0-d number for
    ``mix_pit_z``, and each mixture block's score under ``blocks``.
    ``capture`` the run's network and the fields and generator states
    around its last sweep (``core.measure``); ``seeds`` the run's
    (network, program, check) seeds.  ``control``: the TF32 reference in
    the program's place; ``fault`` (one of ``FAULTS``): a fault planted in
    the program's place."""
    config, program = spec['config'], spec['traffic']['program']
    _, prog_seed, check_seed = seeds
    before, after = capture['before'], dict(capture['after'])
    gens = (capture['gen_prev'], capture['gen_state'], capture['gen_after'])
    if fault == 'mixture_unchanged':
        after.update({k: before[k] for k in MIXTURE if k in before})
    elif fault == 'generator_not_advanced':
        gens = (gens[0], gens[1], gens[1])
    elif fault is not None and fault not in FAULTS:
        raise ValueError('no fault %r' % (fault,))
    cc = None
    m = program.get('n_control')
    if m is not None:
        # the program's colouring and control seeds (entry.py), and its
        # redraw cadence (SweepConfig.n_resample_control)
        cc = {'m': m, 'color_seed': prog_seed, 'ctrl_seed': prog_seed + 7,
              'every': config['sweep']['n_resample_control']}
    Y = torch.as_tensor(capture['Y'], device=device)
    out = judge(Y, before, after, capture['gen_state'],
                program.get('latent_update', 'exact'), config['sweep'],
                config['K'], control=control, cc=cc)
    del Y
    blocks, widest = mixture_scores(
        after['X'], before, after, config['sweep'], check_seed,
        fault=fault if fault in mixture.FAULTS else None)
    out.update(stale=stale_fields(before, after, gens),
               mix_pit_z=torch.tensor(widest, dtype=torch.float64),
               blocks=blocks)
    return out
