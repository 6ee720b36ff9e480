"""Plain reference of the sticky HDP-LPCM's mixture blocks: the full
conditional of each Gibbs draw of a sweep, teacher-forced on the fields
that were in effect when the sweep drew it, and a test of the program's
draws against those conditionals.

The sweep draws, in this order (the reference package's hdp_lpcm.py:
877-1023): the labels z by forward-filter backward-sample given the new
positions X and the old mu, sigma, lambda and weights; the tables and the
global weights beta (auxiliary, not tested here); the initial and
transition weights given beta's new value, the new labels and the old
alpha_init, alpha, kappa; the cluster means given X, z and the old sigma,
lambda and mean variance; the variances given the new means and the old
lambda and b_scale; lambda given the new means and variances; the mean
variance given the new means; b_scale given the new variances; then the
concentrations (auxiliary, not tested here).

Each draw the program made is turned into a probability integral
transform (PIT) u = F(draw) under the reference's conditional F: uniform
on (0, 1) when the draw is right.  A discrete label gets a randomised PIT
F(z-) + v p(z), v uniform from the check's seed, taken along each node's
path in time so its values are independent, and the labels' log
probabilities a score of their own; a Dirichlet row gets one PIT
a stick-breaking fraction (independent Beta variables), for fractions
whose two Beta parameters are both at least ``MIN_CONC`` (where a float32
draw has not underflowed; the choice reads the conditional alone).  Each
block's PITs give two standard-normal scores, of their mean and of their
mean squared distance from 1/2: :func:`pit_scores`.

All arithmetic is float64.  It imports nothing of the program.
"""
import math

import numpy as np
import torch
from scipy import special

MIN_CONC = 0.5
LOG_FLOOR = -50.0
EDGE, EDGE_MASS = 1e-4, 1e-3
_LOG_2PI = math.log(2.0 * math.pi)


def pit_scores(u):
    """(|z| of the mean, |z| of the mean of (u - 1/2)^2) of PITs u: each
    standard normal when u are independent uniforms (variances 1 / 12 N
    and 1 / 180 N)."""
    u = u.reshape(-1).to(torch.float64)
    N = u.numel()
    if N == 0:
        return 0.0, 0.0
    z1 = (float(u.mean()) - 0.5) * math.sqrt(12.0 * N)
    z2 = (float(((u - 0.5) ** 2).mean()) - 1.0 / 12.0) * math.sqrt(180.0 * N)
    return abs(z1), abs(z2)


def _f64(v):
    return v.to(torch.float64)


def _prev(X):
    """x_{t-1} (zeros at t = 0)."""
    out = torch.zeros_like(X)
    out[:, 1:] = X[:, :-1]
    return out


def emission_logliks(X, mu, sigma, lmbda):
    """log N(x_ti; m_tk, sigma_k I) (C, T, n, K): m_0k = mu_k, m_tk =
    (1 - lambda) x_{t-1,i} + lambda mu_k."""
    X, mu, sigma, lam = _f64(X), _f64(mu), _f64(sigma), _f64(lmbda)
    C, T, n, d = X.shape
    lam_t = torch.where(torch.arange(T, device=X.device) == 0, 1.0,
                        lam[:, None])                          # (C, T)
    base = X - (1.0 - lam_t)[..., None, None] * _prev(X)       # (C, T, n, d)
    out = torch.empty((C, T, n, sigma.shape[1]), dtype=torch.float64,
                      device=X.device)
    for t in range(T):
        mean = lam_t[:, t, None, None] * mu                    # (C, K, d)
        diff = base[:, t, :, None, :] - mean[:, None]          # (C, n, K, d)
        out[:, t] = (-0.5 * d * (_LOG_2PI + torch.log(sigma))[:, None]
                     - 0.5 * torch.sum(diff * diff, -1) / sigma[:, None])
    return out


def _label_messages(X, mu, sigma, lmbda, weights):
    """(emissions, log transitions, backward messages), each (C, T, n, K)
    but the transitions (C, T, K, K), in float64."""
    e = emission_logliks(X, mu, sigma, lmbda)
    logw = torch.log(_f64(weights))
    logb = torch.zeros_like(e)
    for t in range(e.shape[1] - 1, 0, -1):
        s = e[:, t] + logb[:, t]                               # (C, n, K)
        top = torch.amax(s, -1, keepdim=True)
        # b_{t-1, j} = sum_k w_tjk exp(s_k)
        back = torch.bmm(torch.exp(s - top), torch.exp(logw[:, t])
                         .transpose(1, 2))
        logb[:, t - 1] = torch.log(back) + top
    return e, logw, logb


def _label_conditional(e, logw, logb, z, t):
    """p(z_t | z_{t-1}, X) (C, n, K), z_{t-1} taken from z."""
    C, _, n, K = e.shape
    if t == 0:
        prior = logw[:, 0, 0][:, None, :].expand(C, n, K)
    else:
        prior = torch.gather(logw[:, t], 1, z[:, t - 1, :, None]
                             .expand(C, n, K))
    return torch.softmax(prior + e[:, t] + logb[:, t], dim=-1)


def label_pits(X, mu, sigma, lmbda, weights, z, v):
    """(randomised PITs (C, T, n), the log-probability score) of labels z
    under the labels' full conditional given X and the label-step
    parameters: p(z_0 = k) ∝ w0_k b_0k e_0k, p(z_t = k | z_{t-1} = j) ∝
    w_tjk b_tk e_tk, with e the emissions and b the backward messages.
    ``weights`` (C, T, K, K), weights[:, 0, 0] the initial distribution; v
    (C, T, n) uniforms.  The score is the sum over sites of log p(z_t |
    z_{t-1}) less its expectation under p, over the square root of the sum
    of its variances: standard normal for draws from p (a martingale), and
    negative for draws from a conditional less sure than p.  Each log
    probability is floored at ``LOG_FLOOR`` on both sides."""
    e, logw, logb = _label_messages(X, mu, sigma, lmbda, weights)
    C, T, n, K = e.shape
    u = torch.empty((C, T, n), dtype=torch.float64, device=e.device)
    score = var = 0.0
    for t in range(T):
        p = _label_conditional(e, logw, logb, z, t)
        zt = z[:, t, :, None]
        p_z = torch.gather(p, -1, zt)[..., 0]
        below = torch.sum(torch.where(
            torch.arange(K, device=p.device) < zt, p, 0.0), -1)
        u[:, t] = below + _f64(v[:, t]) * p_z
        logp = torch.clamp_min(torch.log(p), LOG_FLOOR)
        mean = torch.sum(p * logp, -1)
        score += float(torch.sum(torch.gather(logp, -1, zt)[..., 0] - mean))
        var += float(torch.sum(torch.sum(p * logp * logp, -1) - mean ** 2))
    return u, score / math.sqrt(max(var, 1e-300))


def draw_labels(X, mu, sigma, lmbda, weights, rng):
    """Label paths (C, T, n) drawn from the labels' full conditional (as
    :func:`label_pits` states it), by inverse CDF from the NumPy
    generator ``rng``."""
    e, logw, logb = _label_messages(X, mu, sigma, lmbda, weights)
    C, T, n, K = e.shape
    z = torch.zeros((C, T, n), dtype=torch.int64, device=e.device)
    for t in range(T):
        cdf = torch.cumsum(_label_conditional(e, logw, logb, z, t), -1)
        u = torch.as_tensor(rng.random((C, n, 1)), device=e.device)
        z[:, t] = torch.clamp_max(torch.sum(cdf < u, -1), K - 1)
    return z


def dirichlet_pits(w, conc):
    """PITs of Dirichlet rows w (..., K) under Dirichlet(conc): the
    stick-breaking fractions w_k / sum_{j >= k} w_j, independent
    Beta(conc_k, sum_{j > k} conc_j), where both parameters are at least
    ``MIN_CONC``.  Returns a 1-D tensor on the CPU."""
    w, conc = _f64(w).cpu(), _f64(conc).cpu()
    rest_w = torch.flip(torch.cumsum(torch.flip(w, [-1]), -1), [-1])
    rest_c = torch.flip(torch.cumsum(torch.flip(conc, [-1]), -1), [-1])
    frac = (w / rest_w)[..., :-1]
    a, b = conc[..., :-1], rest_c[..., 1:]
    keep = (a >= MIN_CONC) & (b >= MIN_CONC)
    u = special.betainc(a[keep].numpy(), b[keep].numpy(),
                        np.clip(frac[keep].numpy(), 0.0, 1.0))
    return torch.as_tensor(u)


def weight_concentrations(beta, alpha_init, alpha, kappa, z):
    """(conc0 (C, K), conc (C, T - 1, K, K)) of the weights' Dirichlet
    conditionals given the new beta and labels and the old concentrations:
    w0 ~ Dir(alpha_init beta + the initial counts), row j of w_t ~
    Dir(alpha beta + kappa e_j + the counts of t-1 -> t transitions out of
    j)."""
    beta = _f64(beta)
    C, T = z.shape[:2]
    K = beta.shape[1]
    init = torch.zeros((C, K), dtype=torch.float64, device=z.device)
    init.scatter_add_(1, z[:, 0], torch.ones_like(z[:, 0], dtype=init.dtype))
    pair = (z[:, :-1] * K + z[:, 1:]).reshape(C, T - 1, -1)
    trans = torch.zeros((C, T - 1, K * K), dtype=torch.float64,
                        device=z.device)
    trans.scatter_add_(2, pair, torch.ones_like(pair, dtype=trans.dtype))
    conc0 = _f64(alpha_init)[:, None] * beta + init
    eye = torch.eye(K, dtype=torch.float64, device=z.device)
    conc = (_f64(alpha)[:, None, None, None] * beta[:, None, None, :]
            + _f64(kappa)[:, None, None, None] * eye
            + trans.reshape(C, T - 1, K, K))
    return conc0, conc


def draw_dirichlet(conc, rng):
    """Dirichlet rows of ``conc`` (..., K) from the NumPy generator
    ``rng``, float64 on the CPU."""
    g = rng.standard_gamma(np.maximum(conc.cpu().numpy(), 1e-300))
    g = np.maximum(g, 1e-300)
    return torch.as_tensor(g / g.sum(-1, keepdims=True))


def _members(z, K):
    return torch.nn.functional.one_hot(z, K).to(torch.float64)  # (C,T,n,K)


def mean_conditional(X, z, sigma, lmbda, mean_var):
    """(mean (C, K, d), variance (C, K)) of the cluster means' normal
    conditional: prior N(0, mean_var I); x_0 ~ N(mu, sigma); x_t -
    (1 - lambda) x_{t-1} ~ N(lambda mu, sigma)."""
    X, sigma, lam, mv = _f64(X), _f64(sigma), _f64(lmbda), _f64(mean_var)
    r = _members(z, sigma.shape[1])
    base = X[:, 1:] - (1.0 - lam)[:, None, None, None] * X[:, :-1]
    n0 = r[:, 0].sum(1)
    n_rest = r[:, 1:].sum((1, 2))
    prec = 1.0 / mv[:, None] + n0 / sigma + lam[:, None] ** 2 * n_rest / sigma
    s0 = torch.einsum('cik,cid->ckd', r[:, 0], X[:, 0])
    s_rest = torch.einsum('ctik,ctid->ckd', r[:, 1:], base)
    lin = (s0 + lam[:, None, None] * s_rest) / sigma[..., None]
    return lin / prec[..., None], 1.0 / prec


def variance_conditional(X, z, mu, lmbda, a, b_scale):
    """(shape, scale) (C, K) of the cluster variances' inverse-gamma
    conditional: prior InvGamma(a / 2, b_scale / 2); each member site adds
    d / 2 to the shape and half its squared residual to the scale."""
    X, mu, lam = _f64(X), _f64(mu), _f64(lmbda)
    C, T, n, d = X.shape
    K = mu.shape[1]
    r = _members(z, K)
    lam_t = torch.where(torch.arange(T, device=X.device) == 0, 1.0,
                        lam[:, None])
    base = X - (1.0 - lam_t)[..., None, None] * _prev(X)
    ss = torch.zeros((C, K), dtype=torch.float64, device=X.device)
    for t in range(T):
        diff = base[:, t, :, None, :] - lam_t[:, t, None, None, None] * \
            mu[:, None]
        ss += torch.einsum('cik,cik->ck', r[:, t], torch.sum(diff * diff, -1))
    shape = 0.5 * (r.sum((1, 2)) * d + a)
    return shape, 0.5 * _f64(b_scale)[:, None] + 0.5 * ss


def lambda_conditional(X, z, mu, sigma, prior_mean, prior_var):
    """(mean, variance) (C,) of lambda's normal conditional before its
    truncation to (0, 1): x_t - x_{t-1} ~ N(lambda (mu_z - x_{t-1}),
    sigma_z) for t >= 1, prior N(prior_mean, prior_var)."""
    X, mu, sigma = _f64(X), _f64(mu), _f64(sigma)
    c = torch.arange(X.shape[0], device=X.device)[:, None, None]
    zt = z[:, 1:]
    g = mu[c, zt] - X[:, :-1]                                 # (C,T-1,n,d)
    s = sigma[c, zt][..., None]
    prec = 1.0 / prior_var + torch.sum(g * g / s, (1, 2, 3))
    lin = torch.sum(g * (X[:, 1:] - X[:, :-1]) / s, (1, 2, 3)) \
        + prior_mean / prior_var
    return lin / prec, 1.0 / prec


def _ndtr_between(lo, x, hi):
    """(Phi(x) - Phi(lo)) / (Phi(hi) - Phi(lo)), in the tail where the
    interval lies (log-space, so an interval far out stays exact)."""
    upper = lo > 0                 # the interval in the upper tail: mirror
    lo2 = torch.where(upper, -hi, lo)
    hi2 = torch.where(upper, -lo, hi)
    x2 = torch.where(upper, -x, x)
    lh = torch.special.log_ndtr(hi2)
    frac = ((torch.exp(torch.special.log_ndtr(x2) - lh)
             - torch.exp(torch.special.log_ndtr(lo2) - lh))
            / (1.0 - torch.exp(torch.special.log_ndtr(lo2) - lh)))
    frac = torch.clamp(frac, 0.0, 1.0)
    return torch.where(upper, 1.0 - frac, frac)


def hyper_pits(X, z, before, after, sw):
    """PITs of lambda (truncated normal), the mean variance
    (InvGamma((a0 + K) / 2, (b0 + sum mu^2) / 2), the reference package's
    shape) and b_scale (Gamma((c0 + K a) / 2, rate (d0 + sum 1 / sigma) /
    2)), up to (3 C,).  A chain's lambda counts only where its
    conditional puts under ``EDGE_MASS`` within ``EDGE`` of a bound: the
    sweep draws lambda by the inverse CDF in float32 and puts a draw on
    the bounds' margins (1e-6), so where the conditional crowds a bound
    the draw is the margin and no draw of the law."""
    mu, sigma = _f64(after['mu']), _f64(after['sigma'])
    K = mu.shape[1]
    m, var = lambda_conditional(X, z, mu, sigma, sw['lambda_prior'],
                                sw['lambda_variance_prior'])
    sd = torch.sqrt(var)
    lo, hi = (0.0 - m) / sd, (1.0 - m) / sd
    u_lam = _ndtr_between(lo, (_f64(after['lmbda']) - m) / sd, hi)
    near = torch.maximum(_ndtr_between(lo, (EDGE - m) / sd, hi),
                         1.0 - _ndtr_between(lo, (1.0 - EDGE - m) / sd, hi))
    u_lam = u_lam[near < EDGE_MASS]
    shape = torch.full_like(m, 0.5 * (sw['a0'] + K))
    scale = 0.5 * sw['b0'] + 0.5 * torch.sum(mu * mu, (1, 2))
    u_mv = torch.special.gammaincc(shape, scale / _f64(after['mean_var']))
    shape = torch.full_like(m, 0.5 * (sw['c0'] + K * sw['a']))
    rate = 0.5 * sw['d0'] + 0.5 * torch.sum(1.0 / sigma, 1)
    u_bs = torch.special.gammainc(shape, rate * _f64(after['b_scale']))
    return torch.cat([u_lam, u_mv, u_bs])


# the faults a block can be read under (``block_pits(fault=...)``): each
# replaces one block's draws by draws from a wrong conditional
FAULTS = ('labels_no_transitions', 'means_wide', 'weights_half')


def block_pits(X, before, after, sw, v, fault=None, rng=None):
    """{block: PITs} of the sweep's mixture draws, each conditional
    teacher-forced on the fields in effect when the sweep drew it.  X the
    positions the blocks read (the sweep's output, centred); ``before`` /
    ``after`` the state's fields entering and leaving the sweep; v (C, T,
    n) uniforms for the labels' randomised PITs.

    ``fault`` (one of ``FAULTS``, with a NumPy generator ``rng``) tests
    one block's draws made from a wrong conditional in place of the
    program's, the other blocks as the program drew them: the labels with
    the transitions ignored (uniform), the means at three times their
    conditional's deviation, the weights from half their
    concentrations."""
    z = after['z']
    z_test = z
    if fault == 'labels_no_transitions':
        flat = torch.ones_like(_f64(before['weights']))
        z_test = draw_labels(X, before['mu'], before['sigma'],
                             before['lmbda'], flat / flat.shape[-1], rng)
    u, score = label_pits(X, before['mu'], before['sigma'], before['lmbda'],
                          before['weights'], z_test, v)
    out = {'labels': u, 'label_score': score}
    conc0, conc = weight_concentrations(after['beta'], before['alpha_init'],
                                        before['alpha'], before['kappa'], z)
    w0, w = after['weights'][:, 0, 0], after['weights'][:, 1:]
    if fault == 'weights_half':
        w0, w = draw_dirichlet(conc0 / 2, rng), draw_dirichlet(conc / 2, rng)
    out['weights'] = torch.cat([dirichlet_pits(w0, conc0),
                                dirichlet_pits(w, conc)])
    mean, var = mean_conditional(X, z, before['sigma'], before['lmbda'],
                                 before['mean_var'])
    mu = _f64(after['mu'])
    if fault == 'means_wide':
        noise = torch.as_tensor(rng.standard_normal(mean.shape),
                                device=mean.device)
        mu = mean + 3.0 * torch.sqrt(var)[..., None] * noise
    out['means'] = torch.special.ndtr((mu - mean)
                                      / torch.sqrt(var)[..., None])
    shape, scale = variance_conditional(X, z, after['mu'], before['lmbda'],
                                        sw['a'], before['b_scale'])
    out['variances'] = torch.special.gammaincc(
        shape, scale / _f64(after['sigma']))
    out['hyper'] = hyper_pits(X, z, before, after, sw)
    return out
