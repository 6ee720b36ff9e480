"""The comparison that decides ``correct`` for the directed sticky HDP-LPCM
with social radii and the exact latent update: the window's last sweep of
every chain, judged by the plain float64 reference (``directed.py``,
``mixture.py``).  A cell names this module in its ``workloads/<cell>.json``
(``"reference"``).

The numbers are the undirected judge's (``hdp_undirected.py``), over the
directed sweep's decisions:

* ``mh_gap``: every Metropolis decision of the sweep, held against the
  reference's log ratio: each site of the exact scan (both directions of
  each partner dyad, the partners as the program left them when the site
  was updated), b_in, then b_out at the b_in the program kept, then the
  radii at the intercepts it kept.  A decision on the wrong side counts
  |ratio - log u| over the sum of the magnitudes of the ratio's terms; a
  value that is neither the old one nor the proposal counts ``ALTERED``.
  The radii's Hastings term counts at its net size: the program computes
  it in float64, where its ~2e6 lgamma terms round by ~1e-10.
* ``logp_gap``: the program's log joint against the reference's (the
  directed network term and the radii's Dirichlet(1) prior included).
* ``mix_pit_z``: the mixture blocks' draws (``mixture.py``), as
  undirected.
* ``stale``: the undirected judge's (``REDRAWN``), but for a Dirichlet
  draw (``beta``, ``weights``) whose every value is float32's tiny, 1 or
  a structural 0: where a draw's concentrations put all but one weight
  below float32's range, the sampler clips them to tiny and the draw
  comes out the same vector sweep after sweep, a sound draw that repeats
  (seen in ``hdp_ns_cc`` at seed 280836939, a window of 300 sweeps: one
  chain's beta).  The intercepts
  and the radii are Metropolis steps, which may keep their values, and
  are not counted.

The proposals and log-uniforms are replayed from the generator's state
before the sweep in the sweep's draw order: the scan's normals and
uniforms, b_in's normal and uniform, b_out's, then the radii's Dirichlet
proposal (the fixed-round gamma draws: two rounds of normals, two of
uniforms, the boost's uniforms) and its uniform.  The Dirichlet proposal
is rebuilt from its draws by the sampler's own float32 arithmetic (the JAX
package's two-round Marsaglia-Tsang gamma with its clips and
renormalisation), which reproduces the program's draw bit for bit on the
same device; where the program accepted, the judge takes the radii it
kept (teacher forcing), so a rebuild off by rounding moves no decision.

The control (``control=True``) puts the TF32 reference in the program's
place, as undirected.  The faults (``FAULTS``) planted in the program's
place: ``intercepts_swapped`` (b_in and b_out stored in each other's
slot), ``network_transposed`` (the float64 reference's decisions and log
joint on the network with every edge reversed), ``radii_prior_dropped``
(the log joint without the radii's prior), the mixture blocks' faults
and the undirected judge's two ``stale`` faults.
"""
import torch

from . import mixture
from .directed import (
    coefficient_log_ratios, latent_log_ratios, log_joint_directed,
    radii_log_prior)
from .hdp_lpcm import Arith
from .hdp_undirected import (
    FAULTS as UNDIRECTED_FAULTS, MIXTURE, REDRAWN, _gaps, mixture_scores,
    uncentre)

REF = Arith('float64')
# the float32 clamps of the program's draws (float32's tiny, and the
# uniforms' floor before a log)
SMALL_EPS = float(torch.finfo(torch.float32).tiny)
_TINY = 1e-20
GAMMA_ROUNDS = 2
# the Dirichlet draws among the redrawn fields
DIRICHLET = ('beta', 'weights')
FAULTS = ('intercepts_swapped', 'network_transposed',
          'radii_prior_dropped') + UNDIRECTED_FAULTS


def _log_uniform(g, shape, device):
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    return torch.log(torch.clamp_min(u, _TINY))


def gamma_from_draws(alpha, xs, us, ub):
    """Gamma(alpha, 1) by the fixed-round Marsaglia-Tsang method: the
    first accepted round's d v, else the last round's d v; alpha < 1 from
    alpha + 1, boosted by ub^(1 / alpha).  float32, in the sampler's own
    op order."""
    small = alpha < 1.0
    a_core = torch.where(small, alpha + 1.0, alpha)
    d = a_core - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    w = 1.0 + c * xs
    v = w * w * w
    log_v = torch.log(torch.clamp_min(v, _TINY))
    ok = (v > 0.0) & (torch.log(us) < (0.5 * xs * xs + d - d * v
                                       + d * log_v))
    val = d * torch.clamp_min(v[-1], _TINY)
    for r in range(xs.shape[0] - 1, -1, -1):
        val = torch.where(ok[r], d * v[r], val)
    boost = torch.exp(torch.log(ub) / torch.clamp_min(alpha, _TINY))
    return torch.where(small, val * boost, val)


def dirichlet_from_draws(alphas, xs, us, ub):
    """Dirichlet(alphas) over the last axis from the fixed-round gammas,
    each gamma and each weight clipped at float32's tiny and renormalised."""
    alphas = torch.clamp_min(alphas, SMALL_EPS)
    g = torch.clamp_min(gamma_from_draws(alphas, xs, us, ub), SMALL_EPS)
    out = g / torch.sum(g, dim=-1, keepdim=True)
    out = torch.clamp_min(out, SMALL_EPS)
    return out / torch.sum(out, dim=-1, keepdim=True)


def replay_noise(gen_state, C, T, n, d, radii, step, device):
    """The draws of a directed exact sweep from its generator state: eps
    (C, T, n, d) and log_u (C, T, n) of the scan (site (t, j) reads phase
    t % 2 of the (C, 2, n, T) field), then {'b_in', 'b_out': (normal (C,),
    log-uniform (C,))}, the radii's proposal (C, n) from Dirichlet(step
    radii) and its log-uniform (C,)."""
    g = torch.Generator(device=device)
    g.set_state(gen_state)
    f32 = dict(generator=g, device=device, dtype=torch.float32)
    eps = torch.randn((C, 2, n, T, d), **f32)
    log_u = torch.log(torch.rand((C, 2, n, T), **f32))
    t = torch.arange(T, device=device)
    eps = eps.permute(0, 1, 3, 2, 4)[:, t % 2, t]
    log_u = log_u.permute(0, 1, 3, 2)[:, t % 2, t]
    coef = {}
    for name in ('b_in', 'b_out'):
        normal = torch.randn((C,), **f32)
        coef[name] = (normal, _log_uniform(g, (C,), device))
    xs = torch.randn((GAMMA_ROUNDS, C, n), **f32)
    us = torch.clamp_min(torch.rand((GAMMA_ROUNDS, C, n), **f32), _TINY)
    ub = torch.clamp_min(torch.rand((C, n), **f32), _TINY)
    alphas = torch.full((C,), step, device=device,
                        dtype=torch.float32)[:, None] * radii
    x = dirichlet_from_draws(alphas, xs, us, ub)
    return eps, log_u, coef, x, _log_uniform(g, (C,), device)


def stale_fields(before, after, gens):
    """(C,) the ``stale`` count (module docstring); ``gens`` the
    generator's states (before the previous sweep, before the last, after
    it)."""
    C = before['X'].shape[0]
    count = torch.zeros(C, dtype=torch.float64)
    for k in REDRAWN:
        if k not in before or k not in after:
            continue
        a, b = before[k].reshape(C, -1), after[k].reshape(C, -1)
        same = torch.all(a == b, dim=1)
        if k in DIRICHLET:
            same &= ~torch.all((b == SMALL_EPS) | (b == 1.0) | (b == 0.0),
                               dim=1)
        count += same.cpu().to(torch.float64)
    prev, now, nxt = gens
    if torch.equal(now, nxt) or (prev is not None and torch.equal(prev, now)):
        count += 1.0
    return count


def _kept(after, old, prop, tol):
    """(accepted, altered) (C,) of a step whose candidates were ``old`` and
    ``prop`` and whose value after the sweep is ``after``, each (C,) or
    (C, k): accepted where ``after`` lies nearer the proposal, altered
    where it lies farther than ``tol`` (C,) from both."""
    def far(v):
        return torch.abs(after - v).reshape(after.shape[0], -1).amax(1)
    d_acc, d_rej = far(prop), far(old)
    return d_acc < d_rej, torch.minimum(d_acc, d_rej) > tol


def judge(Y, before, after, gen_state, sw, K, control=False, fault=None):
    """The Metropolis and log-joint numbers of one run's last sweep, per
    chain: {'mh_gap': (C,), 'logp_gap': (C,)}.  Y (T, n, n) uint8 the
    network (Y[t, i, j] the edge i -> j); ``before`` / ``after`` the
    state's fields entering and leaving the sweep; ``gen_state`` the
    generator's state before it; ``sw`` the configuration's constants
    (the radii's proposal step under ``radii_step``).  ``control``: the
    TF32 reference decides and computes the log joint in the program's
    place; ``fault`` one of the decision faults of ``FAULTS``."""
    X_old, X_after = before['X'], after['X']
    C, T, n, d = X_old.shape
    dev = X_old.device
    step = sw['radii_step']
    b_old, r_old = before['intercept'], before['radii']
    eps, log_u, coef, r_prop, log_ur = replay_noise(
        gen_state, C, T, n, d, r_old, step, dev)
    x_prop = X_old + before['step_X'][..., None] * eps
    X_new, acc, altered = uncentre(X_after, X_old, x_prop)

    b_prop = b_old + before['step_int'] * torch.stack(
        [coef['b_in'][0], coef['b_out'][0]], -1)
    b_after = after['intercept']
    tol_b = 1e-6 * (1.0 + torch.abs(b_old))
    acc_b, altered_b = zip(*(_kept(b_after[:, j], b_old[:, j], b_prop[:, j],
                                   tol_b[:, j]) for j in (0, 1)))
    r_after = after['radii']
    acc_r, altered_r = _kept(r_after, r_old, r_prop,
                             1e-5 * torch.amax(torch.abs(r_old), 1))
    # where the program accepted, its kept radii are the proposal
    r_prop = torch.where(acc_r[:, None], r_after, r_prop)
    b_new = torch.where(torch.stack(acc_b, -1), b_prop, b_old)

    def decide(a, Yk):
        lat = (Yk, X_old, X_new, x_prop, b_old, r_old, before['mu'],
               before['sigma'], before['lmbda'], before['z'])
        ratio, mag = latent_log_ratios(a, *lat)
        steps, lls = coefficient_log_ratios(
            a, Yk, X_after, b_old, b_prop, b_new, r_old, r_prop, step,
            sw['intercept_prior_mean'], sw['intercept_variance_prior'])
        return ratio, mag, steps, lls

    ratio, mag, steps, lls = decide(REF, Y)
    fields = dict(after)
    logp = fields.pop('logp')
    net_ll = torch.where(acc_r, lls['prop'], lls['cur'])
    clean = not bool(torch.stack(altered_b + (altered_r,)).any())
    logp_ref, mag_logp = log_joint_directed(
        REF, Y, fields, sw, K, net_ll=net_ll if clean else None)
    decided = [acc, acc_b[0], acc_b[1], acc_r]
    checks = [altered, altered_b[0], altered_b[1], altered_r]
    if control or fault == 'network_transposed':
        a = Arith('tf32') if control else REF
        Yk = Y if control else Y.transpose(1, 2)
        f_ratio, _, f_steps, _ = decide(a, Yk)
        decided = [log_u < f_ratio] + [
            coef[k][1] < f_steps[k][0] for k in ('b_in', 'b_out')] + [
                log_ur < f_steps['radii'][0]]
        logp = log_joint_directed(a, Yk, fields, sw, K)[0]
        checks = [torch.zeros_like(c) for c in checks]
    elif fault == 'radii_prior_dropped':
        logp = logp.to(torch.float64) - radii_log_prior(REF, after['radii'])
    log_us = [log_u, coef['b_in'][1], coef['b_out'][1], log_ur]
    ratios = [ratio, steps['b_in'][0], steps['b_out'][0], steps['radii'][0]]
    mags = [mag, steps['b_in'][1], steps['b_out'][1], steps['radii'][1]]
    gaps = [_gaps(*args).reshape(C, -1).amax(1)
            for args in zip(decided, ratios, mags, log_us, checks)]
    mh = torch.stack(gaps, -1).amax(-1)
    logp_rel = torch.abs(logp.to(torch.float64) - logp_ref) / mag_logp
    return {'mh_gap': mh.cpu(), 'logp_gap': logp_rel.cpu()}


def judge_capture(spec, capture, seeds, device, control=False, fault=None):
    """The compared numbers of a run's last sweep: per chain (C,) for
    ``mh_gap``, ``logp_gap`` and ``stale``, one 0-d number for
    ``mix_pit_z``, and each mixture block's score under ``blocks``
    (``hdp_undirected.judge_capture``'s contract).  ``fault`` one of
    ``FAULTS``, planted in the program's place."""
    config = spec['config']
    _, _, check_seed = seeds
    before, after = capture['before'], dict(capture['after'])
    gens = (capture['gen_prev'], capture['gen_state'], capture['gen_after'])
    if fault is not None and fault not in FAULTS:
        raise ValueError('no fault %r' % (fault,))
    if fault == 'intercepts_swapped':
        after['intercept'] = after['intercept'].flip(-1)
    elif fault == 'mixture_unchanged':
        after.update({k: before[k] for k in MIXTURE if k in before})
    elif fault == 'generator_not_advanced':
        gens = (gens[0], gens[1], gens[1])
    Y = torch.as_tensor(capture['Y'], device=device)
    out = judge(Y, before, after, capture['gen_state'], config['sweep'],
                config['K'], control=control, fault=fault)
    del Y
    blocks, widest = mixture_scores(
        after['X'], before, after, config['sweep'], check_seed,
        fault=fault if fault in mixture.FAULTS else None)
    out.update(stale=stale_fields(before, after, gens),
               mix_pit_z=torch.tensor(widest, dtype=torch.float64),
               blocks=blocks)
    return out
