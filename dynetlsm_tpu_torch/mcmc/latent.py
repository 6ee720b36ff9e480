"""Latent-position Metropolis updates (counterpart of
``dynetlsm_tpu/mcmc/latent.py::sample_latent_positions``), in the JAX
package's three schemes:

* ``'exact'`` (the default): the single-site scan over every (t, node)
  site of C chains.  On a dense network it is the sequential node scan:
  the CUDA node-scan kernel for CUDA tensors at every n the kernel takes,
  its plain PyTorch version for CPU tensors (``ops/node_scan.py``, which
  also holds the per-partner likelihood terms and the prior terms of each
  site's conditional).  Under the case-control likelihood it is the
  chromatic scan (:func:`cc_colored_scan`), torch code on any device: one
  vectorised update per colour class instead of one per node; without
  colour classes, the same scan with one node a class (the sequential
  scan, 2n dependent steps), each chain with its own controls.
* ``'parallel'``: every site's proposal scored against the stale field
  with its own accept (:func:`_parallel_site_update`; a perturbed Markov
  kernel, as in JAX), dense or case-control.
* ``'mala'``: one joint Metropolis-adjusted Langevin step of each chain's
  whole field on the dense joint density (:func:`_mala_update`), the
  likelihood's gradient in closed form.

The dense 'parallel' site terms are one launch of the CUDA site kernel
for CUDA tensors (``ops/site_loglik.py`` -> ``csrc/site_loglik.cu``), its
plain PyTorch version for CPU tensors; the rest of 'parallel' (proposal,
prior, accept, O(C T n)), its case-control terms and 'mala' are torch code
on any device.  The plain dense passes run over blocks of (chains, times,
sites) of at most ``_BLOCK_ELEMS`` dyads (:func:`_site_blocks`), each site
against its whole row of partners, so no (C, T, n, n) tensor is made.  On
a node-sharded network (``ops.shards.RowShards``, ``mcmc/nodes.py``) each
shard scores its own sites from its rows, on its device with its own copy
of the field (the site kernel's row-range mode on a card), and the first
device gathers the sites' terms (and adds the shards' float64 shares of
the MALA joint); the exact scan is not sharded.
"""
from functools import lru_cache

import numpy as np
import torch

from ..math.distributions import normal, uniform
from ..ops.case_control import (
    approx_partial_loglik_all, class_partial_loglik_segments, control_scale)
from ..ops.distances import _sum_sq_last
from ..ops.likelihoods import _BLOCK_ELEMS, site_blocks, softplus
from ..ops.shards import RowShards
from ..ops.site_loglik import block_network as _block_network, site_loglik
from ..ops.node_scan import (  # noqa: F401  (re-exported counterparts)
    _directed_partial_loglik_terms, _mixture_prior_per_t,
    _partial_loglik_terms, _rw_prior_per_t, node_scan, site_cluster_params)
from .. import tracing

SCHEMES = ('exact', 'parallel', 'mala')


def latent_noise(gen, C, T, n, d, device):
    """The proposal stream of one scan: eps (C, 2, n, T, d) standard
    normals and log_u (C, 2, n, T) log-uniforms, in the JAX scan's
    layout."""
    eps = normal(gen, (C, 2, n, T, d), device)
    log_u = torch.log(uniform(gen, (C, 2, n, T), device))
    return eps, log_u


@tracing.traced
def sample_latent_positions(gen, Y, X, intercept, step_size, *, mu=None,
                            sigma=None, lmbda=None, z=None, tau_sq=None,
                            sigma_sq=None, radii=None, is_directed=False,
                            mixture=True, scheme='exact', noise=None,
                            cc=None, temper=None):
    """One full sweep of MH updates of the positions under the mixture
    prior (mu, sigma, lmbda, z) or, with ``mixture=False``, the Gaussian
    random-walk prior of the LSM (tau_sq, sigma_sq), by ``scheme``
    ('exact', 'parallel' or 'mala'; the JAX package's ``ValueError``s for
    another scheme, for MALA under case-control and for a ``noise`` stream
    the two other schemes cannot honour).

    Undirected: Y (T, n, n) uint8 0/1, intercept (C, 1).  Directed
    (``is_directed``): Y the packed ``Y + 2 Y^T`` uint8, intercept (C, 2)
    = (b_in, b_out), radii (C, n).  Y may have its rows padded
    (``ops.node_scan.pad_partners``), as the sweeps store it, and may be
    one network a chain (C, T, n, .).
    X (C, T, n, d); step_size (C, T, n); mu (C, K, d); sigma (C, K);
    lmbda (C,); z (C, T, n); tau_sq, sigma_sq floats.  ``noise`` =
    (eps, log_u) injects the exact scan's proposal stream.  ``temper``
    (C,) scales each chain's log-likelihood (parallel tempering; ``None``:
    untempered).  Returns (X_new (C, T, n, d), accepted (C, T, n))."""
    if scheme not in SCHEMES:
        raise ValueError(
            "latent_update must be 'exact', 'parallel', or 'mala', got %r"
            % (scheme,))
    if is_directed and radii is None:
        raise ValueError('the directed latent update needs radii')
    prior_kw = dict(tau_sq=tau_sq, sigma_sq=sigma_sq, mu=mu, sigma=sigma,
                    lmbda=lmbda, z=z, is_directed=is_directed,
                    mixture=mixture, temper=temper)
    if scheme == 'parallel':
        if noise is not None:
            raise ValueError(
                "scheme='parallel' draws its own (T, n) proposal field; an "
                "injected exact-scan noise stream cannot be honoured")
        return _parallel_site_update(gen, Y, X, intercept, step_size, radii,
                                     cc=cc, **prior_kw)
    if scheme == 'mala':
        if cc is not None:
            raise ValueError(
                "latent_update='mala' differentiates the dense joint "
                "likelihood; under case-control sampling use 'exact' or "
                "'parallel'")
        if noise is not None:
            raise ValueError(
                "scheme='mala' draws its own proposal noise; an injected "
                "exact-scan noise stream cannot be honoured")
        return _mala_update(gen, Y, X, intercept, step_size, radii,
                            **prior_kw)
    if isinstance(Y, RowShards) or (cc is not None and 'shards' in cc):
        raise ValueError(
            "the sequential exact node scan cannot be partitioned over node "
            "shards; use latent_update='parallel' or 'mala'")
    C, T, n, d = X.shape
    eps, log_u = (noise if noise is not None
                  else latent_noise(gen, C, T, n, d, X.device))
    if cc is not None:
        if 'color_groups' not in cc:
            # the sequential scan (JAX xla_exact_scan's case-control
            # branch) is the chromatic scan with one node a class in index
            # order (JAX latent.py:513)
            cc = dict(cc, color_groups=torch.arange(n, device=X.device)[
                :, None], group_sizes=(1,) * n)
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


def _site_blocks(C, T, n, rows=None):
    """(chains, times, sites) slices that cover (C, T, n), or the sites
    ``rows`` = [a, b) of a node shard, each block at most ``_BLOCK_ELEMS``
    dyads (its sites times their n partners) and at least one site: whole
    (time, site) fields of several chains where they fit, then whole
    fields of several times, then rows of sites
    (``ops.likelihoods.site_blocks``)."""
    return site_blocks(C, T, n, rows, _BLOCK_ELEMS)


def _shard_parts(Y):
    """(part, first row) of each node shard of a row-split network, or the
    whole network as one part at row 0."""
    if isinstance(Y, RowShards):
        return [(part, Y.bounds[s]) for s, part in enumerate(Y.parts)]
    return [(Y, 0)]


def _shift(a, step, fill):
    """a[:, t - 1] (step 1) or a[:, t + 1] (step -1) along axis 1, ``fill``
    where that time does not exist."""
    pad = torch.full_like(a[:, :1], fill)
    if step == 1:
        return torch.cat([pad, a[:, :-1]], dim=1)
    return torch.cat([a[:, 1:], pad], dim=1)


def _parallel_site_update(gen, Y, X, intercept, step_size, radii=None,
                          tau_sq=None, sigma_sq=None, mu=None, sigma=None,
                          lmbda=None, z=None, is_directed=False, mixture=True,
                          cc=None, temper=None, eps=None, log_u=None):
    """Every (t, node) proposal evaluated against the stale position field
    with its own accept (JAX ``_parallel_site_update``, SURVEY.md §7.1):
    one O(T n^2 d) pass instead of 2n dependent steps, at the cost of a
    perturbed Markov kernel (each site's accept ignores the other sites'
    moves; JAX measures the temporal-smoothness moment E|X_{t+1} - X_t|^2
    ~9% inflated at T=3, n=8).  JAX's formulas term by term, with a chain
    axis: each site's likelihood delta over its partners
    (:func:`_site_loglik`: one launch of the CUDA site kernel,
    ``csrc/site_loglik.cu``, for CUDA tensors, one a node shard; its plain
    version in blocks of eager ops, ``ops.site_loglik.site_loglik_plain``,
    for CPU tensors), the prior with stale temporal neighbours, ``temper``
    (C,) times the likelihood delta.  Under the case-control structures
    ``cc`` the site terms are ``ops.case_control.
    approx_partial_loglik_all``'s (Y unread; torch code on any device).

    Shapes as :func:`sample_latent_positions`.  The proposal eps (C, T, n,
    d) and the log-uniforms log_u (C, T, n) are drawn from ``gen`` (eps
    first) unless given.  Returns (X_new, accepted (C, T, n) float)."""
    C, T, n, d = X.shape
    if eps is None:
        eps = normal(gen, (C, T, n, d), X.device)
    if log_u is None:
        log_u = torch.log(uniform(gen, (C, T, n), X.device))
    X_prop = X + step_size[..., None] * eps

    prev = _shift(X, 1, 0.0)
    nxt = _shift(X, -1, 0.0)
    first = torch.arange(T, device=X.device)[:, None] == 0
    last = torch.arange(T, device=X.device)[:, None] == T - 1
    if mixture:
        mu_z, sig_z = site_cluster_params(mu, sigma, z)
        lam = lmbda[:, None, None, None]
        mu_nxt = _shift(mu_z, -1, 0.0)
        sig_nxt = _shift(sig_z, -1, 1.0)
    else:
        tau = torch.as_tensor(tau_sq, dtype=X.dtype, device=X.device)
        sig = torch.as_tensor(sigma_sq, dtype=X.dtype, device=X.device)

    def site_prior(Xq):
        if mixture:
            diff0 = Xq - mu_z
            difft = Xq - (1.0 - lam) * prev - lam * mu_z
            diff = torch.where(first[..., None], diff0, difft)
            back = -0.5 * _sum_sq_last(diff) / sig_z
            fdiff = nxt - (1.0 - lam) * Xq - lam * mu_nxt
            fwd = -0.5 * _sum_sq_last(fdiff) / sig_nxt
        else:
            back0 = -0.5 * _sum_sq_last(Xq) / tau
            backt = -0.5 * _sum_sq_last(Xq - prev) / sig
            back = torch.where(first, back0, backt)
            fwd = -0.5 * _sum_sq_last(nxt - Xq) / sig
        return back + torch.where(last, 0.0, fwd)

    if cc is not None:
        delta_ll = (_cc_site_loglik(X, X_prop, cc, intercept, radii,
                                    is_directed)
                    - _cc_site_loglik(X, X, cc, intercept, radii,
                                      is_directed))
    else:
        delta_ll = _site_loglik(Y, X, X_prop, intercept, radii, is_directed)
    if temper is not None:
        delta_ll = temper[:, None, None] * delta_ll
    ratio = delta_ll + site_prior(X_prop) - site_prior(X)
    accept = log_u < ratio
    X_new = torch.where(accept[..., None], X_prop, X)
    return X_new, accept.to(X.dtype)


def _cc_site_loglik(X, Xq, cc, intercept, radii, is_directed):
    """``ops.case_control.approx_partial_loglik_all`` of every site, or
    of node-sharded structures (``{'shards': [...]}``) each shard's sites
    on its device, gathered on X's device."""
    if 'shards' not in cc:
        return approx_partial_loglik_all(X, Xq, cc, intercept, radii,
                                         is_directed)
    parts = []
    for part in cc['shards']:
        dev = part['out_edges'].device
        args = [None if v is None else v.to(dev)
                for v in (X, Xq, intercept, radii)]
        parts.append(approx_partial_loglik_all(
            args[0], args[1], part, args[2], args[3], is_directed).to(
                X.device))
    return torch.cat(parts, dim=2)


def _site_loglik(Y, X, X_prop, intercept, radii, is_directed):
    """Each site's dense likelihood delta (C, T, n), its proposal X_prop
    against its position X, both against the field X over its whole row
    of partners, its own slot dropped (JAX ``_parallel_site_update``'s
    ``site_ll(X_prop) - site_ll(X)``): ``ops.site_loglik.site_loglik``,
    the CUDA kernel for CUDA tensors, its plain version (blocks of
    :func:`_site_blocks`) for CPU tensors.  A node-sharded Y: each shard's
    sites on its device (its own copy of X, X_prop and the coefficients;
    the kernel's row-range mode on a card), gathered on X's device."""
    parts = []
    for part, row0 in _shard_parts(Y):
        dev = part.device
        Xs, Xps, bs, rs = [None if v is None else v.to(dev).contiguous()
                           for v in (X, X_prop, intercept, radii)]
        parts.append(site_loglik(part, Xs, Xps, bs, rs, is_directed,
                                 row0).to(X.device))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def _joint_loglik(Y, X, intercept, radii=None, is_directed=False,
                  temper=None, grad=False):
    """The dense network log-likelihood (C,) of each chain's field, as the
    MALA target has it (JAX ``_joint_latent_logp``'s likelihood): the
    squared distances off the diagonal floored at 1e-12 and the diagonal
    set to 1 before the sqrt, the undirected sum halved (each dyad counted
    twice), times ``temper`` when given.  Blocks of :func:`_site_blocks`,
    their sums added in float64 and rounded once.  With ``grad``, also
    its gradient in X (C, T, n, d) in closed form, block by block (no
    graph spans the network): with s_ij = sigmoid(eta_ij) and e_ij = (X_i
    - X_j) / d_ij, undirected sum_j (s_ij - y_ij) e_ij; directed, with
    eta_ij = b_in (1 - d/r_j) + b_out (1 - d/r_i), sum_j [(s_ij - y_ij)
    (b_in/r_j + b_out/r_i) + (s_ji - y_ji) (b_in/r_i + b_out/r_j)] e_ij;
    a pair closer than the floor adds nothing, as the floor's gradient is
    0.  Undirected networks are symmetric.  A node-sharded Y: each shard's
    sites on its device, its float64 sums added on X's device in shard
    order and its gradient rows gathered there.  Returns (ll, grad or
    None)."""
    C, T, n, _ = X.shape
    total = torch.zeros(C, dtype=torch.float64, device=X.device)
    g = torch.empty_like(X) if grad else None
    for part, row0 in _shard_parts(Y):
        dev = part.device
        Xs, bs, rs = [None if v is None else v.to(dev)
                      for v in (X, intercept, radii)]
        share = torch.zeros(C, dtype=torch.float64, device=dev)
        for c, t, r in _site_blocks(C, T, n, (row0, row0 + part.shape[-2])):
            ll, g_block = _joint_block(part, Xs, bs, rs, is_directed, grad,
                                       c, t, r, row0)
            share[c] += ll
            if grad:
                g[c, t, r] = g_block.to(X.device)
        total += share.to(X.device)
    ll = (total if is_directed else 0.5 * total).to(X.dtype)
    if temper is not None:
        ll = temper * ll
        if grad:
            g = temper[:, None, None, None] * g
    return ll, g


def _joint_block(Y, X, intercept, radii, is_directed, grad, c, t, r,
                 row0=0):
    """:func:`_joint_loglik` of one block: its chains' float64 sums and
    its sites' gradient (or None); its temporaries freed on return."""
    Y_row, Y_col, off = _block_network(Y, c, t, r, X.shape[2], is_directed,
                                       row0)
    diff = X[c, t, r][:, :, :, None, :] - X[c, t][:, :, None, :, :]
    d2 = _sum_sq_last(diff)
    dist = torch.sqrt(torch.where(off, torch.clamp_min(d2, 1e-12), 1.0))
    b0 = intercept[c, 0, None, None, None]
    if is_directed:
        b1 = intercept[c, 1, None, None, None]
        r_i = radii[c, None, r, None]
        r_j = radii[c, None, None, :]
        eta = b0 * (1.0 - dist / r_j) + b1 * (1.0 - dist / r_i)
    else:
        eta = b0 - dist
    terms = (Y_row * eta - softplus(eta)).masked_fill_(~off, 0.0)
    ll = torch.sum(terms, dim=(1, 2, 3), dtype=torch.float64)
    if not grad:
        return ll, None
    del terms
    coef = torch.sigmoid(eta) - Y_row
    if is_directed:
        eta_t = b0 * (1.0 - dist / r_i) + b1 * (1.0 - dist / r_j)
        coef = (coef * (b0 / r_j + b1 / r_i)
                + (torch.sigmoid(eta_t) - Y_col) * (b0 / r_i + b1 / r_j))
        del eta_t
    del eta
    coef = torch.where(off & (d2 > 1e-12), coef / dist, 0.0)
    del d2, dist
    return ll, torch.sum(coef[..., None] * diff, dim=-2)


def _joint_prior(X, tau_sq=None, sigma_sq=None, mu=None, sigma=None,
                 lmbda=None, z=None, mixture=True):
    """The temporal prior (C,) of each chain's field, each transition once
    (JAX ``_joint_latent_logp``'s prior): the AR(1)-to-cluster-mean
    mixture prior or the random walk."""
    T = X.shape[1]
    if mixture:
        mu_z, sig_z = site_cluster_params(mu, sigma, z)
        diff0 = X[:, 0] - mu_z[:, 0]
        prior = -0.5 * torch.sum(_sum_sq_last(diff0) / sig_z[:, 0], dim=1)
        if T > 1:
            lam = lmbda[:, None, None, None]
            dft = X[:, 1:] - (1.0 - lam) * X[:, :-1] - lam * mu_z[:, 1:]
            prior = prior - 0.5 * torch.sum(_sum_sq_last(dft) / sig_z[:, 1:],
                                            dim=(1, 2))
    else:
        prior = -0.5 * torch.sum(X[:, 0] * X[:, 0], dim=(1, 2)) / tau_sq
        if T > 1:
            dft = X[:, 1:] - X[:, :-1]
            prior = prior - 0.5 * torch.sum(dft * dft,
                                            dim=(1, 2, 3)) / sigma_sq
    return prior


def _joint_latent_logp(Y, X, intercept, radii=None, tau_sq=None,
                       sigma_sq=None, mu=None, sigma=None, lmbda=None, z=None,
                       is_directed=False, mixture=True, temper=None):
    """Joint log density (C,) of each chain's position field, the network
    likelihood (times ``temper`` when given, :func:`_joint_loglik`) plus
    the temporal prior, each transition once (:func:`_joint_prior`): the
    MALA target (JAX ``_joint_latent_logp``).  Y in the kernels' form, as
    :func:`sample_latent_positions` takes it."""
    ll, _ = _joint_loglik(Y, X, intercept, radii, is_directed, temper)
    return ll + _joint_prior(X, tau_sq, sigma_sq, mu, sigma, lmbda, z,
                             mixture)


def _joint_value_and_grad(X, Y, intercept, radii=None, is_directed=False,
                          temper=None, **prior_kw):
    """(_joint_latent_logp (C,), its gradient in X (C, T, n, d)): the
    likelihood's in closed form (:func:`_joint_loglik`), the prior's,
    O(C T n d), from ``torch.autograd``."""
    ll, g_ll = _joint_loglik(Y, X, intercept, radii, is_directed, temper,
                             grad=True)
    with torch.enable_grad():
        Xg = X.detach().requires_grad_(True)
        prior = _joint_prior(Xg, **prior_kw)
        g_prior, = torch.autograd.grad(prior.sum(), Xg)
    return ll + prior.detach(), g_ll + g_prior


def _mala_update(gen, Y, X, intercept, step_size, radii=None, tau_sq=None,
                 sigma_sq=None, mu=None, sigma=None, lmbda=None, z=None,
                 is_directed=False, mixture=True, temper=None, eps=None,
                 log_u=None):
    """One joint Metropolis-adjusted Langevin step of each chain's whole
    position field (JAX ``_mala_update``): the proposal drifts along the
    gradient of :func:`_joint_latent_logp` (:func:`_joint_value_and_grad`),
    scaled per site by ``step_size`` (C, T, n) as a fixed diagonal
    preconditioner, and one MH test per chain, with the drift's correction
    log q(X | X') - log q(X' | X), accepts or keeps the whole field.  The
    accept is broadcast to (C, T, n), so the acceptance counters and the
    'mala' tuning schedule apply.  The proposal eps (C, T, n, d) and the
    log-uniform log_u (C,) are drawn from ``gen`` (eps first) unless given.
    Returns (X_new, accepted (C, T, n) float)."""
    C, T, n, d = X.shape
    kw = dict(Y=Y, intercept=intercept, radii=radii, tau_sq=tau_sq,
              sigma_sq=sigma_sq, mu=mu, sigma=sigma, lmbda=lmbda, z=z,
              is_directed=is_directed, mixture=mixture, temper=temper)
    s = step_size[..., None]
    s2 = s * s
    logp_cur, g_cur = _joint_value_and_grad(X, **kw)
    mean_fwd = X + 0.5 * s2 * g_cur
    if eps is None:
        eps = normal(gen, (C, T, n, d), X.device)
    X_prop = mean_fwd + s * eps
    logp_prop, g_prop = _joint_value_and_grad(X_prop, **kw)
    mean_rev = X_prop + 0.5 * s2 * g_prop
    # log q(X | X') - log q(X' | X); the normalisations cancel
    log_q_rev = -0.5 * torch.sum((X - mean_rev) ** 2 / s2, dim=(1, 2, 3))
    log_q_fwd = -0.5 * torch.sum((X_prop - mean_fwd) ** 2 / s2,
                                 dim=(1, 2, 3))
    ratio = logp_prop - logp_cur + log_q_rev - log_q_fwd
    if log_u is None:
        log_u = torch.log(uniform(gen, (C,), X.device))
    accept = log_u < ratio
    X_new = torch.where(accept[:, None, None, None], X_prop, X)
    return X_new, accept.to(X.dtype)[:, None, None].expand(C, T, n)


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
    control masks, shared or per chain, and the controls, shared (n, m)
    or one draw a chain (C, n, m).
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
    ctrl_chain = ctrl_tabs[0].dim() == 3
    if ctrl_chain and not per_chain:
        # one control draw a chain (the sequential scan's): the shared
        # lists as every chain's own, so each chain gathers its controls
        edge_tabs = tuple(e.expand((C,) + e.shape) for e in edge_tabs)
        degs = tuple(dg.expand((C,) + dg.shape) for dg in degs)
        per_chain, node_axis = True, 3
    widths = ([e.shape[-1] for e in edge_tabs]
              + [c.shape[-1] for c in ctrl_tabs])
    offsets = (0,) + tuple(int(v) for v in np.cumsum(widths))

    # class-sorted tables, once a scan: (n_colors, [C,] T, S, ...)
    e_cls = _by_class(torch.cat(edge_tabs, -1), groups, node_axis - 1)
    m_cls = _by_class(torch.cat(mask_tabs, -1), groups, node_axis - 1)
    if ctrl_chain:
        c_cls = _by_class(torch.cat(ctrl_tabs, -1), groups, 1)[:, :, None]
    else:
        c_cls = _by_class(torch.cat(ctrl_tabs, -1), groups, 0)  # (nc, S, Mc)
        c_cls = c_cls.reshape((c_cls.shape[0],) + (1,) * (e_cls.dim() - 3)
                              + c_cls.shape[1:])
    c_cls = c_cls.expand(e_cls.shape[:-1] + c_cls.shape[-1:])
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
        with tracing.span('cc_class'):
            flat = partner[c]                            # ([C,] T, S, Mtot)
            pos = rows[flat] if per_chain else X.view(C, T * n, d)[:, flat]
            valid_c = valid[c]
            scales_c = tuple(s[c] for s in scales)
            x_cur = X[:, :, g_safe[c]]                   # (C, T, S, d)
            x_prop = x_cur + step_cls[c] * eps_cls[c]
            xq = torch.stack([x_prop, x_cur])            # (2, C, T, S, d)
            diff = pos - xq[..., None, :]                # (2,C,T,S,Mtot,d)
            dist = torch.sqrt(_sq_norm(diff))
            r_all = None
            if is_directed:
                r_all = (r_rows[flat] if per_chain
                         else r_rows.view(C, T * n)[:, flat])
            ll = class_partial_loglik_segments(
                dist, valid_c, r_all, r_cls[c] if is_directed else None,
                sender, offsets, None, b_in, b_out, n, is_directed,
                scales=scales_c)
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
            acc.index_copy_(2, groups[c, :k],
                            accepted[:, :, :k].to(X.dtype))
            if margins is not None:
                margins.index_copy_(2, groups[c, :k], margin[:, :, :k])
    return X, acc
