"""Plain PyTorch reference of the directed sticky HDP-LPCM with social radii
(github.com/joshloyal/dynetlsm: directed_likelihoods_fast.pyx:185-205,
hdp_lpcm.py; radii of Sewell and Chen, JASA 2015): the network
log-likelihood, the Metropolis log ratios of one sweep's latent update,
intercept steps and radii step, and the log joint of a state.

It imports nothing of the program.  Every function takes an
``hdp_lpcm.Arith``: float64 for the reference, TF32 for the control.

The model: each ordered dyad (i, j), i != j, of each time is an edge
i -> j with probability expit(eta_ij),

    eta_ij = b_in (1 - d_ij / r_j) + b_out (1 - d_ij / r_i),

d_ij = |x_ti - x_tj|, the radii r on the simplex with a Dirichlet(1)
prior, b_in and b_out each N(0, 2); the positions and labels as the
undirected model's (``hdp_lpcm.py``).  Y (T, n, n) uint8 holds the edges
as drawn: Y[t, i, j] is the edge i -> j.  The sums run over every ordered
dyad, both directions of each pair, with eta written as above (not in the
program's hoisted-reciprocal form).
"""
import torch

from .hdp_lpcm import (
    BLOCK, _cluster_params, _dirichlet_logpdf, _dist, _mixture_prior,
    _shifted, _softplus, log_joint)


def _eta(a, dist, b_in, b_out, r_recv, r_send):
    """b_in (1 - d / r_recv) + b_out (1 - d / r_send), every step rounded
    by ``a``."""
    return a(a(b_in * a(1.0 - a(dist / r_recv)))
             + a(b_out * a(1.0 - a(dist / r_send))))


def _edge_terms(a, y, eta, other):
    """y eta - softplus(eta) where ``other`` (a dyad with another node),
    else 0, every step rounded by ``a``."""
    t = a(a(y * eta) - a(_softplus(eta)))
    return torch.where(other, t, torch.zeros_like(t))


def _blocks(C, n, per_chain):
    """Chain ranges of at most ``BLOCK`` elements of ``per_chain`` each, and
    row ranges of at most ``BLOCK`` elements of one chain."""
    chains = max(1, BLOCK // max(per_chain * n, 1))
    rows = max(1, BLOCK // max(per_chain, 1))
    return ([slice(c0, min(C, c0 + chains)) for c0 in range(0, C, chains)],
            [slice(r0, min(n, r0 + rows)) for r0 in range(0, n, rows)])


def network_loglik(a, Y, X, b, radii):
    """The directed network log-likelihood of each chain at each candidate:
    the sum over t and every ordered dyad i -> j, in blocks of chains and
    rows.  Y (T, n, n) uint8 0/1; X (C, T, n, d); b (C, B, 2) the
    candidates' (b_in, b_out); radii (C, B, n).  Returns (C, B) in ``a``'s
    precision."""
    C, T, n, _ = X.shape
    B = b.shape[1]
    dev = X.device
    out = torch.zeros((C, B), dtype=a.dtype, device=dev)
    chain_blocks, row_blocks = _blocks(C, n, n)
    nodes = torch.arange(n, device=dev)
    b, radii = a(b), a(radii)
    for t in range(T):
        for js in row_blocks:
            y = Y[t, js].to(a.dtype)                           # (r, n)
            other = nodes[js, None] != nodes[None, :]
            for cs in chain_blocks:
                field = a(X[cs, t])
                dist = _dist(a, field[:, js], field)           # (c, r, n)
                for k in range(B):
                    r = radii[cs, k]
                    eta = _eta(a, dist, b[cs, k, 0, None, None],
                               b[cs, k, 1, None, None], r[:, None, :],
                               r[:, js, None])
                    out[cs, k] = a(out[cs, k] + torch.sum(
                        _edge_terms(a, y, eta, other), dim=(1, 2)))
    return out


def latent_log_ratios(a, Y, X_old, X_new, x_prop, b, radii, mu, sigma,
                      lmbda, z):
    """The log Metropolis ratio (C, T, n) of every site's proposal in the
    exact scan of one sweep, in ``a``'s precision: the scan visits the
    nodes in index order and, for each node, its even times, then its odd
    times; when site (t, j) is updated the partners i < j hold their new
    positions ``X_new`` and the others their old ones ``X_old``, and its
    temporal neighbours their new positions at odd t, their old ones at
    even t.  Each partner i adds both directions: the edge j -> i at
    eta_ji and the edge i -> j at eta_ij.

    X_old, X_new, x_prop (C, T, n, d) float32: the positions before the
    update, after it (before centring) and each site's proposal; b (C, 2)
    the intercepts and radii (C, n) the radii the scan read; mu, sigma,
    lmbda, z the mixture parameters.  Returns (the ratios, the sum of
    each ratio's terms' magnitudes, float64)."""
    C, T, n, d = X_old.shape
    dev = X_old.device
    out = torch.empty((C, T, n), dtype=a.dtype, device=dev)
    mag = torch.empty((C, T, n), dtype=torch.float64, device=dev)
    chain_blocks, row_blocks = _blocks(C, n, 4 * n)
    nodes = torch.arange(n, device=dev)
    b, radii = a(b), a(radii)
    for t in range(T):
        for js in row_blocks:
            y_out = Y[t, js].to(a.dtype)                       # j -> i
            y_in = Y[t][:, js].T.to(a.dtype)                   # i -> j
            earlier = nodes[None, :] < nodes[js, None]         # (r, n)
            other = nodes[js, None] != nodes[None, :]
            for cs in chain_blocks:
                old = a(X_old[cs, t])                          # (c, n, d)
                cand = torch.stack([a(x_prop[cs, t, js]), old[:, js]],
                                   1)                          # (c,2,r,d)
                dist = torch.where(
                    earlier, _dist(a, cand, a(X_new[cs, t])[:, None]),
                    _dist(a, cand, old[:, None]))              # (c,2,r,n)
                b_in = b[cs, 0, None, None, None]
                b_out = b[cs, 1, None, None, None]
                r = radii[cs]
                r_i, r_j = r[:, None, None, :], r[:, None, js, None]
                t_out = _edge_terms(a, y_out, _eta(a, dist, b_in, b_out,
                                                   r_i, r_j), other)
                t_in = _edge_terms(a, y_in, _eta(a, dist, b_in, b_out,
                                                 r_j, r_i), other)
                ll = a(t_out + t_in)
                out[cs, t, js] = a(torch.sum(a(ll[:, 0] - ll[:, 1]),
                                             dim=-1))
                mag[cs, t, js] = torch.sum(
                    torch.abs(t_out.to(torch.float64))
                    + torch.abs(t_in.to(torch.float64)), dim=(1, -1))
    mu_z, sig_z = _cluster_params(mu, sigma, z)
    odd = (torch.arange(T, device=dev) % 2 == 1)[None, :, None, None]
    # neighbours of an odd time are even times, updated first
    nb_prev = torch.where(odd, _shifted(X_new, 1), _shifted(X_old, 1))
    nb_next = torch.where(odd, _shifted(X_new, -1), _shifted(X_old, -1))
    mu_nxt = _shifted(mu_z, -1)
    sig_nxt = _shifted(sig_z[..., None], -1)[..., 0]
    sig_nxt[:, -1] = 1.0

    def prior(xs):
        return _mixture_prior(a, xs, nb_prev, nb_next, mu_z, sig_z, mu_nxt,
                              sig_nxt, lmbda)

    lp, lc = prior(x_prop), prior(X_old)
    mag = mag + torch.abs(lp.to(torch.float64)) + torch.abs(
        lc.to(torch.float64))
    return a(a(out + lp) - lc), mag


def _logprior(a, b, prior_mean, prior_var):
    return a(-a(a(a(b) - prior_mean) ** 2) / (2.0 * prior_var))


def coefficient_log_ratios(a, Y, X, b_old, b_prop, b_new, radii_old,
                           radii_prop, step, prior_mean, prior_var):
    """The three Metropolis steps after the latent update, in the program's
    order, each at the state the previous one left (``b_new`` (C, 2), the
    intercepts the program kept): b_in from b_old[:, 0] to b_prop[:, 0]
    (b_out at b_old[:, 1]); b_out from b_old[:, 1] to b_prop[:, 1] at
    the kept b_in; the radii from ``radii_old`` to ``radii_prop`` (C, n)
    under a Dirichlet(step r) proposal (``step`` a float), at the kept
    intercepts, its ratio with the proposal's Hastings term (the radii's
    Dirichlet(1) prior is flat).  X (C, T, n, d) the positions the steps
    read.  Returns {'b_in', 'b_out', 'radii': (the log ratio (C,), the sum
    of its terms' magnitudes (C,) float64)} and the log-likelihoods at
    the kept intercepts: {'cur': radii_old, 'prop': radii_prop} (C,)."""
    b_in0, b_out0 = b_old[:, 0], b_old[:, 1]
    b_in = b_new[:, 0]
    cands = torch.stack([
        torch.stack([b_in0, b_out0], -1), torch.stack([b_prop[:, 0], b_out0],
                                                      -1),
        torch.stack([b_in, b_out0], -1), torch.stack([b_in, b_prop[:, 1]],
                                                     -1),
        b_new], dim=1)                                           # (C, 5, 2)
    r = torch.stack([radii_old] * 5, dim=1)
    ll = network_loglik(a, Y, X, cands, r)
    ll_prop_r = network_loglik(a, Y, X, b_new[:, None],
                               radii_prop[:, None])[:, 0]
    out = {}
    for name, j, lo, hi in (('b_in', 0, 0, 1), ('b_out', 1, 2, 3)):
        parts = (ll[:, hi], ll[:, lo],
                 _logprior(a, b_prop[:, j], prior_mean, prior_var),
                 _logprior(a, b_old[:, j], prior_mean, prior_var))
        out[name] = (a(a(a(parts[0] - parts[1]) + parts[2]) - parts[3]),
                     sum(torch.abs(p.to(torch.float64)) for p in parts))
    x0, x = a(radii_old), a(radii_prop)
    s = a(torch.as_tensor(step, dtype=a.dtype))
    hastings = a(_dirichlet_logpdf(a, x0, a(s * x))
                 - _dirichlet_logpdf(a, x, a(s * x0)))
    diff = a(ll_prop_r - ll[:, 4])
    out['radii'] = (a(diff + hastings),
                    torch.abs(ll_prop_r.to(torch.float64))
                    + torch.abs(ll[:, 4].to(torch.float64))
                    + torch.abs(hastings.to(torch.float64)))
    return out, {'cur': ll[:, 4], 'prop': ll_prop_r}


def radii_log_prior(a, radii):
    """The radii's Dirichlet(1) log density (C,), with the reference
    package's clipping."""
    return _dirichlet_logpdf(a, radii, torch.ones_like(a(radii)))


def log_joint_directed(a, Y, s, sw, K, net_ll=None):
    """(the log joint (C,) of the directed HDP-LPCM at the state ``s`` (the
    undirected model's fields with ``intercept`` (C, 2) and ``radii`` (C,
    n)), the sum of its terms' magnitudes (C,) float64): the undirected
    model's terms (``hdp_lpcm.log_joint``, both intercepts' priors) with
    the directed network term (``net_ll`` (C,) when computed already) and
    the radii's Dirichlet(1) prior."""
    if net_ll is None:
        net_ll = network_loglik(a, Y, s['X'], s['intercept'][:, None],
                                s['radii'][:, None])[:, 0]
    lp, mag = log_joint(a, None, s, sw, K, net_ll=net_ll)
    term = radii_log_prior(a, s['radii'])
    return a(lp + term), mag + torch.abs(term.to(torch.float64))

