"""Latent-position Metropolis update, exact scheme (counterpart of
``dynetlsm_tpu/mcmc/latent.py::sample_latent_positions``).

One call runs the exact single-site scan over every (t, node) site of C
chains.  On a dense network it is the sequential node scan: the CUDA
node-scan kernel for CUDA tensors at every n, its plain PyTorch version
for CPU tensors (``ops/node_scan.py``, which also holds the per-partner
likelihood terms and the prior terms of each site's conditional).  Under
the case-control likelihood it is the chromatic scan
(:func:`cc_colored_scan`), torch code on any device: one vectorised
update per colour class instead of one per node.
"""
from functools import lru_cache

import numpy as np
import torch

from ..math.distributions import normal, uniform
from ..ops.case_control import class_partial_loglik_segments, control_scale
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
    C, T, n, d = X.shape
    eps, log_u = (noise if noise is not None
                  else latent_noise(gen, C, T, n, d, X.device))
    if cc is not None:
        if 'color_groups' not in cc:
            raise NotImplementedError(
                'the sequential case-control scan without colour classes is '
                'not ported (ROADMAP.md §1 item 5); build the structures '
                'with models.base.build_case_control')
        return cc_colored_scan(X, intercept, step_size, eps, log_u,
                               radii=radii, tau_sq=tau_sq, sigma_sq=sigma_sq,
                               mu=mu, sigma=sigma, lmbda=lmbda, z=z, cc=cc,
                               is_directed=is_directed, mixture=mixture,
                               temper=temper)
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


@lru_cache(maxsize=None)
def _time_masks(T, device):
    """(t == 0, t == T - 1) as (T, 1) bool columns on ``device``."""
    t = torch.arange(T, device=device)[:, None]
    return t == 0, t == T - 1


def _sq_norm(v):
    return torch.sum(v * v, dim=-1)


def _rw_prior_class(xs, x_cur, tau_sq, sigma_sq):
    """Class-batched :func:`_rw_prior_per_t`: the random-walk prior terms
    of each site's conditional at candidates xs (..., C, T, S, d), any
    leading axes stacked (the proposal and the current positions in one
    evaluation), the temporal neighbours fixed at x_cur (C, T, S, d) ->
    (..., C, T, S); tau_sq, sigma_sq 0-d tensors.  The same arithmetic site
    by site as the JAX class prior; a neighbour that does not exist (t = 0
    back, t = T - 1 forward) is a rolled-in value the masks drop."""
    first, last = _time_masks(x_cur.shape[1], x_cur.device)
    prev = torch.roll(x_cur, 1, dims=1)
    nxt = torch.roll(x_cur, -1, dims=1)
    back0 = -0.5 * _sq_norm(xs) / tau_sq
    backt = -0.5 * _sq_norm(xs - prev) / sigma_sq
    back = torch.where(first, back0, backt)
    fwd = -0.5 * _sq_norm(nxt - xs) / sigma_sq
    return back + torch.where(last, 0.0, fwd)


def _mixture_prior_class(xs, x_cur, mu_z, sigma_z, lmbda, lam_mu,
                         lam_mu_nxt, sig_nxt):
    """Class-batched :func:`_mixture_prior_per_t`: xs (..., C, T, S, d)
    (leading axes stacked, as in :func:`_rw_prior_class`), x_cur, mu_z (C,
    T, S, d), sigma_z (C, T, S), lmbda (C,) -> (..., C, T, S), with the
    label-only terms precomputed: ``lam_mu`` = lmbda mu_z, and
    ``lam_mu_nxt`` and ``sig_nxt`` the next time's lmbda mu_z and sigma_z
    (rolled; the last time's is dropped by its mask)."""
    first, last = _time_masks(x_cur.shape[1], x_cur.device)
    one_m = 1.0 - lmbda[:, None, None, None]
    prev = torch.roll(x_cur, 1, dims=1)
    nxt = torch.roll(x_cur, -1, dims=1)
    diff0 = xs - mu_z
    difft = xs - one_m * prev - lam_mu
    diff = torch.where(first[..., None], diff0, difft)
    back = -0.5 * _sq_norm(diff) / sigma_z
    fdiff = nxt - one_m * xs - lam_mu_nxt
    fwd = -0.5 * _sq_norm(fdiff) / sig_nxt
    return back + torch.where(last, 0.0, fwd)


def _by_class(a, groups, node_axis):
    """a with its node axis replaced by (n_colors, S) through ``groups``
    (-1 read as node 0) and n_colors moved to the front."""
    return torch.movedim(torch.index_select(
        a, node_axis, torch.clamp_min(groups, 0).reshape(-1)).unflatten(
            node_axis, groups.shape), node_axis, 0).contiguous()


def _phase_of_time(a, T):
    """(C, 2, n, T, ...) per-phase draws -> (C, T, n, ...): at time t the
    draw of phase t % 2, the one the exact scan consumes there."""
    t = torch.arange(T, device=a.device)
    a = torch.movedim(a, 3, 1)                            # (C, T, 2, n, ...)
    return a[:, t, t % 2]


def cc_colored_scan(X, intercept, step_size, eps, log_u, *, radii=None,
                    tau_sq=None, sigma_sq=None, mu=None, sigma=None,
                    lmbda=None, z=None, cc=None, is_directed=False,
                    mixture=False, temper=None, margins=None):
    """Exact chromatic case-control node scan (JAX ``cc_colored_scan``).

    Under the case-control likelihood node j's conditional sees only its
    edge partners and its controls.  With the conflict graph coloured
    (``ops.case_control.color_conflict_graph``) and the controls drawn
    from other classes, the nodes of one class are conditionally
    independent, so one vectorised MH step updates a whole class: exact
    blocked Gibbs with the stationary distribution of the reference's
    sequential case-control sweep (sample_latent_positions.py:92-146), in
    n_colors dependent steps instead of n.

    Each class step runs the sequential scan's two time-parity phases on
    its nodes and consumes the same proposal stream: eps (C, 2, n, T, d)
    and log_u (C, 2, n, T), the exact scan's layout, read at (t % 2, j, t).
    A site's likelihood at time t depends on its position at t and on its
    partners, which no phase of its class moves, so one evaluation serves
    both phases: the current and the proposed positions (each time at its
    own phase's proposal) stacked into one pass.  The prior terms, which
    see the neighbouring times, are evaluated per phase, the proposal's and
    the current's stacked too.  Every site's terms are the JAX scan's, so
    are its accept decisions.

    X (C, T, n, d); intercept (C, 1), or (C, 2) = (b_in, b_out) with radii
    (C, n) when directed; step_size (C, T, n); the mixture prior mu (C, K,
    d), sigma (C, K), lmbda (C,), z (C, T, n), or with ``mixture=False``
    the random-walk prior tau_sq, sigma_sq; temper (C,) or None.  ``cc``
    (``mcmc/sweeps.py::build_cc_dict``): color_groups (n_colors, S),
    group_sizes (each class's node count), the edge lists, degrees and
    control masks, shared or per chain, and the shared controls.
    ``margins`` (C, T, n), when given, receives each site's |log_u -
    ratio| at its decision (how close it came to the other outcome).
    Returns (X_new (C, T, n, d), accepted (C, T, n))."""
    C, T, n, d = X.shape
    dev = X.device
    groups = cc['color_groups']
    sizes = cc['group_sizes']
    per_chain = cc['out_edges'].dim() == 4
    node_axis = 3 if per_chain else 2
    if is_directed:
        edge_tabs = (cc['in_edges'], cc['out_edges'])
        ctrl_tabs = (cc['ctrl_in'], cc['ctrl_out'])
        mask_tabs = (cc['ctrl_in_valid'], cc['ctrl_out_valid'])
        degs = (cc['degrees'][..., 0], cc['degrees'][..., 1])
    else:
        edge_tabs = (cc['out_edges'],)
        ctrl_tabs = (cc['ctrl_out'],)
        mask_tabs = (cc['ctrl_out_valid'],)
        degs = (cc['degrees'][..., 1],)
    widths = ([e.shape[-1] for e in edge_tabs]
              + [c.shape[-1] for c in ctrl_tabs])
    offsets = (0,) + tuple(int(v) for v in np.cumsum(widths))

    # class-sorted tables, once a scan: (n_colors, [C,] T, S, ...)
    e_cls = _by_class(torch.cat(edge_tabs, -1), groups, node_axis - 1)
    c_cls = _by_class(torch.cat(ctrl_tabs, -1), groups, 0)  # (nc, S, Mc)
    m_cls = _by_class(torch.cat(mask_tabs, -1), groups, node_axis - 1)
    c_cls = c_cls.reshape((c_cls.shape[0],) + (1,) * (e_cls.dim() - 3)
                          + c_cls.shape[1:]).expand(
        e_cls.shape[:-1] + c_cls.shape[-1:])
    partner = torch.cat([e_cls, c_cls], -1)    # (nc, [C,] T, S, Mtot)
    valid = torch.cat([e_cls >= 0, m_cls], -1)
    del e_cls, c_cls
    partner.clamp_(min=0)
    t_off = torch.arange(T, device=dev)[:, None, None] * n
    partner += t_off
    if per_chain:
        partner += (torch.arange(C, device=dev) * (T * n))[
            :, None, None, None]
    scales = tuple(_by_class(control_scale(n, deg, mask), groups,
                             node_axis - 1)
                   for deg, mask in zip(degs, mask_tabs))
    step_cls = _by_class(step_size, groups, 2)[..., None]  # (nc,C,T,S,1)
    eps_cls = _by_class(_phase_of_time(eps, T), groups, 2)
    u_cls = _by_class(_phase_of_time(log_u, T), groups, 2)
    # each phase's sites of each class: (nc, 2, T, S)
    t_par = torch.arange(T, device=dev)[:, None] % 2
    phase_sites = torch.stack([(t_par == p) & (groups >= 0)[:, None]
                               for p in (0, 1)], 1)
    if mixture:
        mu_z, sig_z = site_cluster_params(mu, sigma, z)
        lam_mu = lmbda[:, None, None, None] * mu_z
        tabs = [_by_class(a, groups, 2) for a in (
            mu_z, sig_z, lam_mu, torch.roll(lam_mu, -1, dims=1),
            torch.roll(sig_z, -1, dims=1))]

        def prior(xs, x_cur, c):
            return _mixture_prior_class(xs, x_cur, *(t[c] for t in tabs[:2]),
                                        lmbda, *(t[c] for t in tabs[2:]))
    else:
        tau = torch.as_tensor(tau_sq, dtype=X.dtype, device=dev)
        sig = torch.as_tensor(sigma_sq, dtype=X.dtype, device=dev)

        def prior(xs, x_cur, c):
            return _rw_prior_class(xs, x_cur, tau, sig)
    sender = b_out = None
    b_in = intercept[:, 0]
    if is_directed:
        sender = torch.zeros(offsets[-1], dtype=torch.bool, device=dev)
        sender[offsets[1]:offsets[2]] = True              # out edges
        sender[offsets[3]:offsets[4]] = True              # ctrl_out
        r_rows = radii[:, None, :].expand(C, T, n).reshape(-1)
        r_cls = _by_class(radii, groups, 1)               # (nc, C, S)
        b_out = intercept[:, 1]
    tb = None if temper is None else temper[:, None, None]
    g_safe = torch.clamp_min(groups, 0)

    X = X.contiguous().clone()
    acc = torch.zeros((C, T, n), dtype=X.dtype, device=dev)
    rows = X.view(-1, d)
    for c in range(groups.shape[0]):
        flat = partner[c]                                # ([C,] T, S, Mtot)
        pos = rows[flat] if per_chain else X.view(C, T * n, d)[:, flat]
        valid_c = valid[c]
        scales_c = tuple(s[c] for s in scales)
        x_cur = X[:, :, g_safe[c]]                       # (C, T, S, d)
        x_prop = x_cur + step_cls[c] * eps_cls[c]
        xq = torch.stack([x_prop, x_cur])                # (2, C, T, S, d)
        diff = pos - xq[..., None, :]                    # (2,C,T,S,Mtot,d)
        dist = torch.sqrt(_sq_norm(diff))
        r_all = None
        if is_directed:
            r_all = r_rows[flat] if per_chain else r_rows.view(C, T * n)[
                :, flat]
        ll = class_partial_loglik_segments(
            dist, valid_c, r_all, r_cls[c] if is_directed else None, sender,
            offsets, None, b_in, b_out, n, is_directed, scales=scales_c)
        delta = ll[0] - ll[1]
        if tb is not None:
            delta = tb * delta
        accepted = margin = None
        for p in (0, 1):
            lp, lc = prior(xq, x_cur, c)
            ratio = delta + lp - lc
            accept = (u_cls[c] < ratio) & phase_sites[c, p]
            x_cur = torch.where(accept[..., None], x_prop, x_cur)
            if p == 0:
                xq = torch.stack([x_prop, x_cur])
            accepted = accept if accepted is None else accepted | accept
            if margins is not None:
                m = torch.abs(u_cls[c] - ratio)
                margin = m if margin is None else torch.where(
                    phase_sites[c, 1], m, margin)
        k = sizes[c]
        X.index_copy_(2, groups[c, :k], x_cur[:, :, :k])
        acc.index_copy_(2, groups[c, :k], accepted[:, :, :k].to(X.dtype))
        if margins is not None:
            margins.index_copy_(2, groups[c, :k], margin[:, :, :k])
    return X, acc
