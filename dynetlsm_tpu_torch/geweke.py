"""Geweke (2004) "getting it right" joint-distribution checks of the
port's sweeps (counterpart of ``tests/test_geweke_joint.py`` and of
``tests/test_tempering.py::test_pt_swap_preserves_distribution`` in the JAX
package), in NumPy and torch alone, so that the CPU tests and
``chip_smoke.py`` on the card run the same checks.

Two simulators of one joint p(theta, Y) are compared:

* marginal-conditional: theta ~ prior, Y | theta ~ model (NumPy, iid);
* successive-conditional: the port's sweep with every off-diagonal dyad
  missing, so its missing-dyad Gibbs step (``resample_missing``) draws
  Y' ~ p(Y | theta') after the parameter blocks' theta' ~ K(. | Y).

Iff every block targets its exact full conditional, the successive chain
is stationary for the joint and every moment of the test statistics
matches the iid sample: z-scores with Geyer-ESS standard errors on the
chain side (:func:`compare`).  Each chain starts from an exact prior draw,
so every sweep is a draw from the joint, and many short chains test the
same joint as a few long ones.  The scales, the statistics and the
``SweepConfig`` switches are the JAX tests': no centering, burn-in never
over (so no Procrustes rotation), concentrations fixed in the HDP.  The
mixture models add one statistic, the mean log cluster variance: the mean
cluster variance, whose InvGamma(2, 1/2) prior has no variance, gives
heavy-tailed z-scores (4.1 on an NVIDIA H100 at 1,024 chains x 600
sweeps, the chains' draws short of the tail), and its logarithm has every
moment.

The case-control LSM (``'lsm cc'``, JAX
``test_lsm_case_control_joint_distribution``) runs the LSM's check with
the case-control likelihood at its full-control limit: every other node a
control (masked per time to the current non-edges), where the estimator
equals the exact likelihood, so the kernel is exact for the true joint.
Every dyad is missing, so the sweep rebuilds each chain's edge lists
every sweep, and its conflict graph is complete (one node a colour
class).  ``it`` starts at 1 and the redraw cadence is never reached, so
the enumerated controls stay.

The MALA LSM (``'lsm mala'``, JAX ``test_lsm_mala_joint_distribution``)
runs the LSM's check with ``latent_update='mala'``: the joint Langevin
move is MH-exact, so a wrong gradient or proposal correction shows as
shifted moments.
"""
import numpy as np
import scipy.special
import scipy.stats
import torch

from .diagnostics import effective_n_geyer
from .mcmc.states import state_from_numpy
from .mcmc.sweeps import (
    SweepConfig, make_hdp_sweep, make_lpcm_sweep, make_lsm_sweep)
from .mcmc.tempering import make_pt_step
from .models.base import case_control_static
from .ops.case_control import build_edge_lists, max_degree_bound
from .ops.distances import pairwise_distances

T, N_NODES, D = 3, 8, 2
TAU_SQ, SIGMA_SQ = 2.0, 0.3
B_MEAN, B_VAR = 0.5, 1.0
NEVER_BURN = 10**8
N_MC = 30000

# mixture extras
K = 3
A_SIGMA, B_SIGMA = 4.0, 1.0          # sigma_k ~ InvGamma(a/2, b/2)
MEAN_VAR = 1.0                       # mu_k ~ N(0, MEAN_VAR I)
LAMBDA_MEAN, LAMBDA_VAR = 0.5, 0.09  # lambda ~ TruncNormal(0,1)
GAMMA_C, ALPHA_INIT_C, ALPHA_C, KAPPA_C = 3.0, 1.5, 2.0, 2.0

# the directed joint's scales (distances commensurate with the O(1/n)
# radii; a tight intercept prior): see tests/test_geweke_joint.py
B_IN, B_OUT = 0.5, 0.3
D_BVAR = 0.25
D_TAU_SQ, D_SIGMA_SQ = 0.01, 0.0025

CC = 'lsm cc'
MALA = 'lsm mala'
MODELS = ('lsm', 'directed', 'lpcm', 'hdp', CC, MALA)
# the LSM's check under other likelihoods or latent updates
LSM_LIKE = ('lsm', CC, MALA)
# the JAX tests' seeds, of each model and of the equal-temperature swap
SEEDS = {'lsm': 7, 'directed': 23, 'lpcm': 13, 'hdp': 17, CC: 7, MALA: 7,
         'swap': 23}
LIMIT = 5.0          # every |z| below it
PT_LIMIT = 4.5       # the equal-temperature swap's block z-scores
POWER_LIMIT = 8.0    # the perturbed prior's smoothness z above it

_IU = np.triu(np.ones((N_NODES, N_NODES), bool), 1)
_OFFD = _IU | _IU.T
_MISS = np.broadcast_to(_OFFD, (T, N_NODES, N_NODES)).copy()


# ---------------------------------------------------------------------------
# marginal-conditional draws (NumPy), as the JAX tests draw them
# ---------------------------------------------------------------------------

def _symmetric_bernoulli(rng, P):
    U = rng.uniform(size=P.shape)
    draw = (U < P) & _IU
    return (draw | np.swapaxes(draw, -1, -2)).astype(np.float64)


def _random_walk(rng, M, tau_sq, sigma_sq):
    X = np.zeros((M, T, N_NODES, D))
    X[:, 0] = np.sqrt(tau_sq) * rng.randn(M, N_NODES, D)
    for t in range(1, T):
        X[:, t] = X[:, t - 1] + np.sqrt(sigma_sq) * rng.randn(M, N_NODES, D)
    return X


def _distances(X):
    return np.linalg.norm(X[..., :, None, :] - X[..., None, :, :], axis=-1)


def lsm_prior_draws(rng, M, sigma_sq=SIGMA_SQ):
    beta = B_MEAN + np.sqrt(B_VAR) * rng.randn(M)
    X = _random_walk(rng, M, TAU_SQ, sigma_sq)
    P = scipy.special.expit(beta[:, None, None, None] - _distances(X))
    return dict(beta=beta, X=X, Y=_symmetric_bernoulli(rng, P))


def directed_prior_draws(rng, M):
    b_in = B_IN + np.sqrt(D_BVAR) * rng.randn(M)
    b_out = B_OUT + np.sqrt(D_BVAR) * rng.randn(M)
    radii = rng.dirichlet(np.ones(N_NODES), size=M)
    X = _random_walk(rng, M, D_TAU_SQ, D_SIGMA_SQ)
    D_ = _distances(X)
    eta = (b_in[:, None, None, None] * (1.0 - D_ / radii[:, None, None, :])
           + b_out[:, None, None, None]
           * (1.0 - D_ / radii[:, None, :, None]))
    P = scipy.special.expit(eta)
    Y = ((rng.uniform(size=P.shape) < P) & _OFFD).astype(np.float64)
    return dict(b_in=b_in, b_out=b_out, radii=radii, X=X, Y=Y)


def _cluster_draws(rng, M):
    mu = np.sqrt(MEAN_VAR) * rng.randn(M, K, D)
    sigma = (0.5 * B_SIGMA) / rng.gamma(0.5 * A_SIGMA, 1.0, size=(M, K))
    a, b = (-LAMBDA_MEAN / np.sqrt(LAMBDA_VAR),
            (1 - LAMBDA_MEAN) / np.sqrt(LAMBDA_VAR))
    lmbda = scipy.stats.truncnorm.rvs(a, b, loc=LAMBDA_MEAN,
                                      scale=np.sqrt(LAMBDA_VAR), size=M,
                                      random_state=rng)
    beta = B_MEAN + np.sqrt(B_VAR) * rng.randn(M)
    return mu, sigma, lmbda, beta


def _mixture_positions(rng, M, z, mu, sigma, lmbda, beta):
    X = np.zeros((M, T, N_NODES, D))
    midx = np.arange(M)[:, None, None]
    sig_z, mu_z = sigma[midx, z], mu[midx, z]
    X[:, 0] = mu_z[:, 0] + np.sqrt(sig_z[:, 0, :, None]) * rng.randn(
        M, N_NODES, D)
    for t in range(1, T):
        mean_t = ((1.0 - lmbda[:, None, None]) * X[:, t - 1]
                  + lmbda[:, None, None] * mu_z[:, t])
        X[:, t] = mean_t + np.sqrt(sig_z[:, t, :, None]) * rng.randn(
            M, N_NODES, D)
    P = scipy.special.expit(beta[:, None, None, None] - _distances(X))
    return X, _symmetric_bernoulli(rng, P)


def _labels(rng, M, w0, rows_of):
    z = np.zeros((M, T, N_NODES), np.int64)
    u = rng.uniform(size=(M, T, N_NODES, 1))
    z[:, 0] = (u[:, 0] > np.cumsum(w0, -1)[:, None, :]).sum(-1)
    for t in range(1, T):
        z[:, t] = (u[:, t] > np.cumsum(rows_of(t, z[:, t - 1]), -1)).sum(-1)
    return np.clip(z, 0, K - 1)


def lpcm_prior_draws(rng, M):
    init_w = rng.dirichlet(np.ones(K), size=M)
    trans_w = rng.dirichlet(np.ones(K), size=(M, K))
    mu, sigma, lmbda, beta = _cluster_draws(rng, M)
    z = _labels(rng, M, init_w,
                lambda t, prev: trans_w[np.arange(M)[:, None], prev])
    X, Y = _mixture_positions(rng, M, z, mu, sigma, lmbda, beta)
    return dict(beta=beta, lmbda=lmbda, sigma=sigma, mu=mu, X=X, Y=Y, z=z,
                init_w=init_w, trans_w=trans_w)


def hdp_prior_draws(rng, M):
    beta_w = rng.dirichlet(np.full(K, GAMMA_C / K), size=M)
    # Dirichlet via normalised Gammas (vectorised concentrations)
    g0 = rng.gamma(ALPHA_INIT_C * beta_w + 1e-10)
    w0 = g0 / g0.sum(-1, keepdims=True)
    conc = (ALPHA_C * beta_w[:, None, None, :]
            + KAPPA_C * np.eye(K)[None, None])
    gt = rng.gamma(np.broadcast_to(conc, (M, T - 1, K, K)) + 1e-10)
    trans = gt / gt.sum(-1, keepdims=True)
    mu, sigma, lmbda, beta = _cluster_draws(rng, M)
    z = _labels(rng, M, w0,
                lambda t, prev: trans[np.arange(M)[:, None], t - 1, prev])
    X, Y = _mixture_positions(rng, M, z, mu, sigma, lmbda, beta)
    return dict(beta=beta, lmbda=lmbda, sigma=sigma, mu=mu, X=X, Y=Y, z=z,
                beta_w=beta_w, w0=w0, trans=trans)


PRIOR_DRAWS = {'lsm': lsm_prior_draws, 'directed': directed_prior_draws,
               'lpcm': lpcm_prior_draws, 'hdp': hdp_prior_draws,
               CC: lsm_prior_draws, MALA: lsm_prior_draws}


# ---------------------------------------------------------------------------
# test statistics: the same functions of (theta, Y) on both simulators
# ---------------------------------------------------------------------------

def _base_stats(beta, X, Y, dist, offd):
    """The LSM statistics of NumPy arrays or float64 tensors, every input
    batched on axis 0; ``offd`` the off-diagonal mask."""
    n_dyads = T * _OFFD.sum()
    dims = (1, 2, 3)
    return [beta, beta ** 2, (X ** 2).mean(axis=dims),
            (Y * offd).sum(axis=dims) / n_dyads,
            ((X[:, 1:] - X[:, :-1]) ** 2).mean(axis=dims),
            (Y * dist * offd).sum(axis=dims) / n_dyads]


def _mixture_extra(lmbda, sigma, mu, log):
    return [lmbda, sigma.mean(-1), (mu ** 2).sum(-1).mean(-1),
            log(sigma).mean(-1)]


def iid_stats(model, draws):
    """(M, S) statistics of the marginal-conditional draws."""
    d = draws
    model = 'lsm' if model in LSM_LIKE else model
    if model == 'directed':
        s = _base_stats(d['b_in'], d['X'], d['Y'], _distances(d['X']),
                        _OFFD)
        s[1] = d['b_out']
        s += [np.sum(d['radii'] ** 2, -1), np.sum(np.sqrt(d['radii']), -1)]
        return np.stack(s, -1)
    s = _base_stats(d['beta'], d['X'], d['Y'], _distances(d['X']), _OFFD)
    if model in ('lpcm', 'hdp'):
        s += _mixture_extra(d['lmbda'], d['sigma'], d['mu'], np.log)
    if model == 'hdp':
        diag = np.einsum('mtkk->mt', d['trans']).mean(-1) / K
        s += [np.sum(d['beta_w'] ** 2, -1), diag]
    return np.stack(s, -1)


def chain_stats(model, state):
    """(C, S) float64 statistics of a chain-batched port state, on its
    device."""
    model = 'lsm' if model in LSM_LIKE else model
    f = torch.float64
    X = state.X.to(f)
    Y = state.Y.to(f)
    b = state.intercept.to(f)
    s = _base_stats(b[:, 0], X, Y, pairwise_distances(X),
                    torch.as_tensor(_OFFD, device=X.device))
    if model == 'directed':
        r = state.radii.to(f)
        s[1] = b[:, 1]
        s += [(r ** 2).sum(-1), torch.sqrt(r).sum(-1)]
    if model in ('lpcm', 'hdp'):
        s += _mixture_extra(state.lmbda.to(f), state.sigma.to(f),
                            state.mu.to(f), torch.log)
    if model == 'hdp':
        w = state.weights[:, 1:].to(f)
        diag = torch.diagonal(w, dim1=-2, dim2=-1).sum(-1).mean(-1) / K
        s += [(state.beta.to(f) ** 2).sum(-1), diag]
    return torch.stack(s, -1)


# ---------------------------------------------------------------------------
# the successive-conditional chains
# ---------------------------------------------------------------------------

def sweep_config(model):
    """The JAX tests' ``SweepConfig`` of each model, with every dyad
    missing."""
    if model in LSM_LIKE:
        cc = (dict(n_control=N_NODES - 1, n_resample_control=NEVER_BURN)
              if model == CC else {})
        return SweepConfig(sample_missing=True, tune=0, n_burn=NEVER_BURN,
                           tau_sq=TAU_SQ, sigma_sq=SIGMA_SQ,
                           intercept_variance_prior=B_VAR, center=False,
                           latent_update='mala' if model == MALA else 'exact',
                           **cc)
    if model == 'directed':
        return SweepConfig(is_directed=True, sample_missing=True, tune=0,
                           n_burn=NEVER_BURN, tau_sq=D_TAU_SQ,
                           sigma_sq=D_SIGMA_SQ,
                           intercept_variance_prior=D_BVAR,
                           tune_radii=False, center=False)
    common = dict(sample_missing=True, tune=0, n_burn=NEVER_BURN,
                  n_components=K, a=A_SIGMA, lambda_prior=LAMBDA_MEAN,
                  lambda_variance_prior=LAMBDA_VAR, a0=None, c0=None,
                  intercept_variance_prior=B_VAR, center=False)
    if model == 'lpcm':
        return SweepConfig(dirichlet_prior=1.0, **common)
    return SweepConfig(table_cap=N_NODES, sample_concentrations=False,
                       **common)


def make_sweep(model, device):
    cfg = sweep_config(model)
    prior = np.array([B_IN, B_OUT] if model == 'directed' else [B_MEAN],
                     np.float32)
    make = {'lsm': make_lsm_sweep, 'directed': make_lsm_sweep,
            'lpcm': make_lpcm_sweep, 'hdp': make_hdp_sweep,
            CC: make_lsm_sweep, MALA: make_lsm_sweep}[model]
    cc_static = None
    if model == CC:
        empty = np.zeros(_MISS.shape)
        cc_static, _ = case_control_static(
            cfg, build_edge_lists(empty), N_NODES, device, color_seed=0,
            ctrl_seed=0, miss_mask=_MISS,
            max_deg=max_degree_bound(empty, _MISS))
    return make(None, prior, cfg, device=device, miss_mask=_MISS,
                cc_static=cc_static)


def all_others(n):
    """(n, n - 1) controls enumerating every other node: with the per-time
    masks every non-edge is a valid control (the full-control limit)."""
    base = np.arange(n)[None, :].repeat(n, axis=0)
    return base[base != np.arange(n)[:, None]].reshape(n, n - 1)


def initial_state(model, rng, n_chains, device):
    """A chain-batched port state whose chains start from independent
    exact prior draws, with the JAX tests' step sizes."""
    d = PRIOR_DRAWS[model](rng, n_chains)
    C = n_chains
    a = {'it': np.zeros(C, np.int64), 'X': d['X'], 'Y': d['Y'],
         'missing_sum': np.zeros_like(d['Y']),
         'acc_X': np.zeros((C, T, N_NODES)), 'logp': np.zeros(C)}
    if model == 'directed':
        b = np.stack([d['b_in'], d['b_out']], -1)
        a.update(intercept=b, radii=d['radii'], step_X=0.1, step_int=0.4,
                 acc_int=np.zeros((C, 2)), step_radii=100.0, acc_radii=0.0)
    else:
        a.update(intercept=d['beta'][:, None], step_X=0.8, step_int=0.4,
                 acc_int=np.zeros((C, 1)))
    if model == MALA:
        # the whole field moves jointly: a smaller per-site scale than the
        # single-site scan keeps the acceptance high (the JAX test's 0.12)
        a['step_X'] = 0.12
    if model in ('lsm', 'directed', CC, MALA):
        a.update(logp_map=-1e30, X_map=d['X'], intercept_map=a['intercept'],
                 logp_ref=-1e30, X_ref=d['X'], radii_map=a.get('radii'))
    else:
        a.update(z=d['z'], mu=d['mu'], sigma=d['sigma'], lmbda=d['lmbda'],
                 mean_var=MEAN_VAR, b_scale=B_SIGMA)
    if model == CC:
        a.update(it=np.ones(C, np.int64), ctrl_out=all_others(N_NODES))
    if model == 'lpcm':
        a.update(init_weights=d['init_w'], trans_weights=d['trans_w'])
    if model == 'hdp':
        w = np.zeros((C, T, K, K))
        w[:, 0, 0] = d['w0']
        w[:, 1:] = d['trans']
        a.update(weights=w, beta=d['beta_w'], gamma=GAMMA_C,
                 alpha_init=ALPHA_INIT_C, alpha=ALPHA_C, kappa=KAPPA_C)
    shapes = {'step_X': (T, N_NODES), 'step_int': a['intercept'].shape[1:]}
    for k, v in list(a.items()):
        if v is None:
            continue
        v = np.asarray(v)
        if k in shapes:
            v = np.broadcast_to(v, (C,) + shapes[k])
        elif v.ndim == 0:
            v = np.full(C, v)
        a[k] = v
    return state_from_numpy(a, device)


def run_chains(step, state, gen, n_sweeps, stats_of):
    """``n_sweeps`` steps, the statistics after each: (final state,
    (C, n_sweeps, S) NumPy float64)."""
    out = []
    for _ in range(n_sweeps):
        state = step(state, gen)
        out.append(stats_of(state))
    return state, torch.stack(out, 1).cpu().numpy()


def geweke_samples(model, n_chains, n_sweeps, seed, device):
    """(iid statistics (N_MC, S), chain statistics (C, n_sweeps, S)) of one
    model, the iid draws and the chains' starts from ``seed``."""
    rng = np.random.RandomState(seed)
    mc = iid_stats(model, PRIOR_DRAWS[model](rng, N_MC))
    state = initial_state(model, rng, n_chains, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    _, sc = run_chains(make_sweep(model, device), state, gen, n_sweeps,
                       lambda s: chain_stats(model, s))
    return mc, sc


def compare(mc_stats, sc_stats, maxlags=200):
    """z-scores between the iid moments (M, S) and the chain moments
    (C, N, S).  The chain side's squared standard error is the larger of
    two: the variance over the Geyer ESS summed over chains (the JAX
    tests'), and the variance of the C chain means over C, which holds
    because every chain starts from an independent draw of the joint.  The
    first alone undercounts a slowly mixing statistic when chains are
    short (each chain's autocorrelation is taken about its own mean): with
    64 chains of 400 sweeps on the CPU it put the HDP's mean cluster
    variance, whose prior has no variance, at z = 6.8."""
    mc_mean = mc_stats.mean(axis=0)
    mc_se2 = mc_stats.var(axis=0, ddof=1) / mc_stats.shape[0]
    C, N, S = sc_stats.shape
    sc_mean = sc_stats.mean(axis=(0, 1))
    sc_var = sc_stats.reshape(-1, S).var(axis=0, ddof=1)
    ess = np.array([
        sum(effective_n_geyer(sc_stats[c, :, s], maxlags=maxlags)
            for c in range(C))
        for s in range(S)])
    between = sc_stats.mean(axis=1).var(axis=0, ddof=1) / C
    return (mc_mean - sc_mean) / np.sqrt(
        mc_se2 + np.maximum(sc_var / ess, between))


def lsm_power_z(sc_stats, seed=11):
    """z-scores of the LSM chains against iid draws whose innovation
    variance is 1.8 times the model's: the temporal-smoothness moment
    (index 4) must move by more than ``POWER_LIMIT``."""
    rng = np.random.RandomState(seed)
    return compare(iid_stats('lsm', lsm_prior_draws(rng, N_MC,
                                                    1.8 * SIGMA_SQ)),
                   sc_stats)


def pt_swap_samples(n_ladders, n_sweeps, seed, device, n_temps=4):
    """The directed LSM under replica exchange at equal temperatures (pure
    relabelling of configurations): (iid statistics, the statistics of
    every slot (n_sweeps, C, S))."""
    rng = np.random.RandomState(seed)
    mc = iid_stats('directed', directed_prior_draws(rng, N_MC))
    C = n_ladders * n_temps
    state = initial_state('directed', rng, C, device)
    state = state.replace(temper=torch.ones(C, device=device),
                          acc_swap=torch.zeros(C, device=device))
    sweep = make_sweep('directed', device)
    pt = make_pt_step(sweep, sweep.cfg, None, n_temps, swap_every=1)
    gen = torch.Generator(device=device).manual_seed(seed)
    _, sc = run_chains(pt, state, gen, n_sweeps,
                       lambda s: chain_stats('directed', s))
    return mc, sc.transpose(1, 0, 2)


def pt_block_z(mc, sc, n_temps=4):
    """Block z-scores of the equal-temperature swap: each ladder's mean
    over sweeps and rungs is one block, the standard error from the
    spread of the blocks."""
    n_sweeps, C, S = sc.shape
    blocks = sc.reshape(n_sweeps, C // n_temps, n_temps, S).mean(axis=(0, 2))
    gm = blocks.mean(0)
    se = blocks.std(0, ddof=1) / np.sqrt(blocks.shape[0])
    mc_se = mc.std(0, ddof=1) / np.sqrt(mc.shape[0])
    return (gm - mc.mean(0)) / np.sqrt(se ** 2 + mc_se ** 2)

