"""Plain PyTorch reference of the undirected sticky HDP-LPCM (the model of
github.com/joshloyal/dynetlsm, hdp_lpcm.py): the network log-likelihood,
the log joint of a state, and the Metropolis log ratios of the latent and
intercept updates of one sweep.

It imports nothing of the program.  Every function takes an
:class:`Arith`: ``Arith('float64')`` is the reference;
``Arith('tf32')`` is the control, the same arithmetic in TF32: every
value it stores, inputs, intermediates and results, rounded to TF32's
10-bit mantissa (round to nearest, ties to even), and each reduction
accumulated in float32 before its result is rounded.  The program's
kernels have no matrix product for the hardware's TF32 switch to reach,
so the control rounds in software, the same on the CPU and the card.

The undirected model (hdp_lpcm.py:1188-1280 of the reference package):
eta_tij = b - |x_ti - x_tj|, each unordered dyad an edge with
probability expit(eta); positions follow an AR(1) pull toward their
cluster's mean, x_t ~ N((1 - lambda) x_{t-1} + lambda mu_z, sigma_z),
x_0 ~ N(mu_z, sigma_z); labels a sticky HDP-HMM with global weights beta,
initial weights w0 and time-inhomogeneous transition rows.  The network
term takes a likelihood's row weights: :class:`DenseLik` (every dyad), or
``case_control.CaseControlLik`` (the case-control estimator).
"""
import math

import torch

F32_TINY = float(torch.finfo(torch.float32).tiny)
# the row blocks of the dense passes: at most this many dyads a block
BLOCK = 1 << 23


def tf32_round(x):
    """float32 x rounded to TF32's 10-bit mantissa (nearest, ties to
    even), kept as float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & -8192).view(torch.float32)


class Arith:
    """The precision of a computation: ``'float64'`` (the reference) or
    ``'tf32'`` (the control)."""

    def __init__(self, kind):
        if kind not in ('float64', 'tf32'):
            raise ValueError(kind)
        self.kind = kind
        self.dtype = torch.float64 if kind == 'float64' else torch.float32

    def __call__(self, x):
        """x in this precision (rounded to TF32 for the control)."""
        if not torch.is_tensor(x):
            x = torch.tensor(x)
        x = x.to(self.dtype)
        return tf32_round(x) if self.kind == 'tf32' else x


class DenseLik:
    """The full likelihood, every dyad: row weights A = y (the edge
    term's eta) and B = 1 off the diagonal (softplus)."""

    def __init__(self, Y):
        self.Y = Y

    def rows(self, a, t, js):
        A = self.Y[t, js].to(a.dtype)
        B = torch.ones_like(A)
        B[torch.arange(js.shape[0], device=js.device), js] = 0.0
        return A, B


def _softplus(eta):
    return torch.clamp_min(eta, 0.0) + torch.log1p(torch.exp(-eta.abs()))


def _terms(a, A, B, eta):
    """Each dyad's A eta - B softplus(eta), every step rounded by ``a``:
    A and B the likelihood's row weights (``case_control.DenseLik``,
    ``CaseControlLik``)."""
    return a(a(A * eta) - a(B * a(_softplus(eta))))


def _dist(a, x, field):
    """|x_k - field_i| (..., k, i) for candidates x (..., k, d) and a field
    (..., i, d), every step rounded by ``a``."""
    diff = a(x[..., :, None, :] - field[..., None, :, :])
    return a(torch.sqrt(a(torch.sum(a(diff * diff), dim=-1))))


def network_loglik(a, lik, X, b):
    """The network log-likelihood of each chain at each intercept: half
    the sum over (t, j) of node j's row terms (every dyad lies in two
    rows).  ``lik`` the likelihood's row weights, X (C, T, n, d), b (C, B)
    intercept candidates.  Returns (C, B) in ``a``'s precision."""
    C, T, n, _ = X.shape
    B = b.shape[1]
    out = torch.zeros((C, B), dtype=a.dtype, device=X.device)
    rows = max(1, BLOCK // max(n * B, 1))
    for t in range(T):
        for r0 in range(0, n, rows):
            js = torch.arange(r0, min(n, r0 + rows), device=X.device)
            wA, wB = lik.rows(a, t, js)
            for c in range(C):
                field = a(X[c, t])
                dist = _dist(a, field[js], field)              # (r, n)
                eta = a(a(b[c])[:, None, None] - dist[None])   # (B, r, n)
                out[c] += torch.sum(_terms(a, wA[None], wB[None], eta),
                                    dim=(1, 2))
    return a(0.5 * out)


def _mixture_prior(a, xs, prev, nxt, mu_z, sig_z, mu_nxt, sig_nxt, lam):
    """Each site's prior terms (C, T, n) at candidates xs (C, T, n, d),
    its temporal neighbours ``prev`` / ``nxt`` (C, T, n, d) held fixed:
    the pull of x_t toward (1 - lambda) x_{t-1} + lambda mu_z (x_0 toward
    mu_z) and of x_{t+1} toward (1 - lambda) x_t + lambda mu_z'."""
    T = xs.shape[1]
    t = torch.arange(T, device=xs.device)[None, :, None]
    lam = a(lam)[:, None, None, None]
    one_m = a(1.0 - lam)
    mean_t = torch.where(t[..., None] == 0, a(mu_z),
                         a(a(one_m * a(prev)) + a(lam * a(mu_z))))
    diff = a(a(xs) - mean_t)
    back = a(a(-0.5 * a(torch.sum(a(diff * diff), dim=-1))) / a(sig_z))
    fdiff = a(a(a(nxt) - a(one_m * a(xs))) - a(lam * a(mu_nxt)))
    fwd = a(a(-0.5 * a(torch.sum(a(fdiff * fdiff), dim=-1))) / a(sig_nxt))
    return a(back + torch.where(t == T - 1, 0.0, fwd))


def _shifted(field, step):
    """field[:, t - 1] (step 1) or field[:, t + 1] (step -1) along the
    time axis, zeros where that time does not exist."""
    out = torch.zeros_like(field)
    if step == 1:
        out[:, 1:] = field[:, :-1]
    else:
        out[:, :-1] = field[:, 1:]
    return out


def _cluster_params(mu, sigma, z):
    c = torch.arange(z.shape[0], device=z.device)[:, None, None]
    return mu[c, z], sigma[c, z]


def latent_log_ratios(a, lik, X_old, X_new, x_prop, b, mu, sigma, lmbda,
                      z, rank=None):
    """The log Metropolis ratio of every site's proposal (C, T, n)
    in the latent update of one sweep, in ``a``'s precision, the other
    sites taken as the program left them when the site was updated.

    * A scan (``rank`` (n,), each node's turn: its index for the exact
      scan, its colour class for the chromatic case-control scan) visits
      the nodes by rank and, for each node, its even times, then its odd
      times.  When site (t, j) is updated, the partners i of lower rank
      hold their new positions ``X_new`` and the others their old ones
      ``X_old``; its temporal neighbours hold their new positions at odd
      t (their even times came first) and their old ones at even t.
    * Without ``rank`` ('parallel'): every site against the old field,
      neighbours old.

    ``lik`` the likelihood's row weights; X_old, X_new, x_prop (C, T, n,
    d) float32: the positions before the update, after it (before
    centring) and each site's proposal; b (C,) the intercept; mu, sigma,
    lmbda, z the mixture parameters the update read.  Returns (the
    ratios, the sum of each ratio's terms' magnitudes, float64): both
    candidates' partner terms and prior terms."""
    C, T, n, d = X_old.shape
    dev = X_old.device
    out = torch.empty((C, T, n), dtype=a.dtype, device=dev)
    mag = torch.empty((C, T, n), dtype=torch.float64, device=dev)
    rows = max(1, BLOCK // max(2 * n, 1))
    for t in range(T):
        for r0 in range(0, n, rows):
            js = torch.arange(r0, min(n, r0 + rows), device=dev)
            wA, wB = lik.rows(a, t, js)
            if rank is not None:
                earlier = rank[None, :] < rank[js][:, None]    # (r, n)
            for c in range(C):
                old = a(X_old[c, t])
                cand = torch.stack([a(x_prop[c, t, js]), old[js]])  # (2,r,d)
                dist = _dist(a, cand, old)                          # (2,r,n)
                if rank is not None:
                    dist = torch.where(earlier[None],
                                       _dist(a, cand, a(X_new[c, t])), dist)
                ll = _terms(a, wA[None], wB[None], a(a(b[c]) - dist))
                out[c, t, r0:r0 + rows] = a(torch.sum(a(ll[0] - ll[1]),
                                                      dim=-1))
                mag[c, t, r0:r0 + rows] = torch.sum(
                    torch.abs(ll.to(torch.float64)), dim=(0, -1))
    mu_z, sig_z = _cluster_params(mu, sigma, z)
    if rank is not None:
        odd = (torch.arange(T, device=dev) % 2 == 1)[None, :, None, None]
        # neighbours of an odd time are even times, updated first
        nb_prev = torch.where(odd, _shifted(X_new, 1), _shifted(X_old, 1))
        nb_next = torch.where(odd, _shifted(X_new, -1), _shifted(X_old, -1))
    else:
        nb_prev, nb_next = _shifted(X_old, 1), _shifted(X_old, -1)
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


def intercept_log_ratio(a, lik, X, b_old, b_prop, prior_mean, prior_var):
    """(the log ratio (C,) of the intercept step from b_old to b_prop (C,)
    at positions X, the log-likelihoods (C, 2) at b_old and b_prop, the sum
    of the ratio's terms' magnitudes (C,) float64)."""
    ll = network_loglik(a, lik, X, torch.stack([b_old, b_prop], dim=1))

    def logprior(b):
        return a(-a(a(a(b) - prior_mean) ** 2) / (2.0 * prior_var))

    parts = (ll[:, 1], ll[:, 0], logprior(b_prop), logprior(b_old))
    ratio = a(a(a(parts[0] - parts[1]) + parts[2]) - parts[3])
    return ratio, ll, sum(torch.abs(p.to(torch.float64)) for p in parts)


def _dirichlet_logpdf(a, x, alphas):
    """Dirichlet log density over the last axis, with the reference
    package's clipping of x and alphas at the float32 tiny."""
    alphas = torch.clamp_min(a(alphas), F32_TINY)
    x = torch.clamp_min(a(x), F32_TINY)
    return a(a(torch.sum(a(a(alphas - 1.0) * a(torch.log(x))), dim=-1))
             + a(torch.lgamma(a(torch.sum(alphas, dim=-1))))
             - a(torch.sum(a(torch.lgamma(alphas)), dim=-1)))


def _truncnorm_logpdf(a, x, mean, var, lower=0.0, upper=1.0):
    std = math.sqrt(var)
    z = a(a(a(x) - mean) / std)
    log_phi = a(-0.5 * a(z * z) - 0.5 * math.log(2.0 * math.pi)
                - math.log(std))
    mass = 0.5 * (math.erfc(-(upper - mean) / std / math.sqrt(2.0))
                  - math.erfc(-(lower - mean) / std / math.sqrt(2.0)))
    # the support is tested on the stored value: a value that rounds onto
    # a bound still has a density
    inside = (x > lower) & (x < upper)
    return torch.where(inside, a(log_phi - math.log(max(mass, F32_TINY))),
                       torch.full_like(log_phi, -math.inf))


def label_counts(z, K):
    """(initial counts (C, K), transitions (C, T - 1, K, K)) of labels
    z (C, T, n): transitions[:, t - 1, j, k] counts nodes with label j
    at t - 1 and k at t."""
    C, T, n = z.shape
    init = torch.zeros((C, K), dtype=torch.float64, device=z.device)
    init.scatter_add_(1, z[:, 0], torch.ones_like(z[:, 0], dtype=init.dtype))
    pair = (z[:, :-1] * K + z[:, 1:]).reshape(C, T - 1, n)
    trans = torch.zeros((C, T - 1, K * K), dtype=torch.float64,
                        device=z.device)
    trans.scatter_add_(2, pair, torch.ones_like(pair, dtype=trans.dtype))
    return init, trans.reshape(C, T - 1, K, K)


def log_joint(a, lik, s, sw, K, net_ll=None):
    """(the log joint (C,) of the undirected HDP-LPCM at the state ``s``,
    the sum of its terms' magnitudes (C,) float64), the network term by the
    likelihood ``lik``.  ``s`` a dict of the fields X, intercept, z, mu,
    sigma, lmbda, weights, beta, gamma, alpha_init, alpha, kappa, mean_var,
    b_scale; ``sw`` the configuration's constants (a, lambda_prior,
    lambda_variance_prior, intercept_variance_prior, intercept_prior_mean,
    a0, b0, c0, d0).  ``net_ll`` (C,) replaces the network term when it
    was computed already."""
    f = {k: (a(v) if v.is_floating_point() else v) for k, v in s.items()}
    X, z = f['X'], f['z']
    C, T, n, d = X.shape
    beta, weights = f['beta'], f['weights']
    w0 = weights[:, 0, 0]
    eye = a(torch.eye(K, device=X.device))
    conc = a(a(f['alpha'][:, None, None] * beta[:, None, :])
             + a(f['kappa'][:, None, None] * eye))
    init, trans = label_counts(z, K)
    if net_ll is None:
        net_ll = network_loglik(a, lik, s['X'], s['intercept'][:, :1])[:, 0]
    diff = a(f['intercept'] - sw['intercept_prior_mean'])
    mu_z, sig_z = _cluster_params(f['mu'], f['sigma'], z)
    lam = f['lmbda'][:, None, None, None]
    mean_t = torch.cat([mu_z[:, :1], a(a(a(1.0 - lam) * X[:, :-1])
                                       + a(lam * mu_z[:, 1:]))], 1)
    dx = a(X - mean_t)
    log_sig = a(torch.log(sig_z))
    mv, bs = f['mean_var'], f['b_scale']
    terms = [
        # the sticky HDP's weights
        _dirichlet_logpdf(a, beta, a(f['gamma'] / K)[:, None].expand(C, K)),
        _dirichlet_logpdf(a, w0, a(f['alpha_init'][:, None] * beta)),
        torch.sum(_dirichlet_logpdf(
            a, weights[:, 1:], conc[:, None].expand(C, T - 1, K, K)),
            dim=(1, 2)),
        # the labels' initial and transition counts
        torch.sum(a(a(init) * a(torch.log(torch.clamp_min(w0, F32_TINY)))),
                  dim=1),
        torch.sum(a(a(trans) * a(torch.log(
            torch.clamp_min(weights[:, 1:], F32_TINY)))), dim=(1, 2, 3)),
        a(net_ll),
        -torch.sum(a(a(0.5 * a(diff * diff))
                     / sw['intercept_variance_prior']), dim=1),
        # the positions under the mixture dynamics
        torch.sum(a(a(-0.5 * log_sig)
                    - a(a(0.5 * a(torch.sum(a(dx * dx), dim=-1)))
                        / sig_z)), dim=(1, 2)),
        -a(a(0.5 * a(torch.sum(a(f['mu'] * f['mu']), dim=(1, 2))))
           / f['mean_var']),
        torch.sum(a(a(-(0.5 * sw['a'] + 1.0) * log_sig)
                    - a(a(0.5 * f['b_scale'])[:, None, None] / sig_z)),
                  dim=(1, 2)),
        _truncnorm_logpdf(a, s['lmbda'], sw['lambda_prior'],
                          sw['lambda_variance_prior']),
        a(a(-(0.5 * sw['a0'] + 1.0) * a(torch.log(mv)))
          - a(0.5 * sw['b0'] / mv)),
        a(a((sw['c0'] - 1.0) * a(torch.log(bs))) - a(sw['d0'] * bs)),
    ]
    lp = a(terms[0])
    for term in terms[1:]:
        lp = a(lp + a(term))
    mag = sum(torch.abs(t.to(torch.float64)) for t in terms)
    return lp, mag
