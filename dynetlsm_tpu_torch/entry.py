"""Entry points of the port (counterparts of ``__graft_entry__.entry`` and
``bench.build_state_and_sweep``).

* :func:`entry` — one HDP-LPCM Gibbs sweep on a tiny random problem, with
  its arguments.
* :func:`build_state_and_sweep` — a replicated chain state and the sweep
  of the sticky HDP-LPCM, the finite LPCM or the dynamic LSM for a dense
  undirected or directed network, with random initialisation (the
  ``quality_init=False`` path of ``bench.py``; GMDS and k-means
  initialisation belong to the estimator, not ported yet); with
  ``n_temps``, the parallel-tempering step over ladders of that many
  rungs (``bench.py``'s ``tempered`` row).  A network with missing dyads
  (coded -1 or NaN) is filled once by the imputer and its missing dyads
  are resampled every sweep, as the JAX estimators do.

Both run on the card unless the caller passes ``device='cpu'``; without a
CUDA device they raise (``config.resolve_device``).
"""
import numpy as np
import torch

from .config import resolve_device
from .imputer import SimpleNetworkImputer
from .math.init import initialize_radii
from .mcmc.driver import replicate_state
from .mcmc.sweeps import (
    SweepConfig, _lsm_logp, make_hdp_sweep, make_lpcm_sweep, make_lsm_sweep)
from .mcmc.tempering import make_pt_step, temper_ladder
from .models.base import validate_network
from .ops.distances import pairwise_distances

# the estimators' hyper-prior shapes at std 4 (mixture_base.py:77-88)
_HYPER = dict(a0=36.0, b0=40.0, c0=5.0, d0=2.0)


def _single_state(T, n, X0, n_int=1):
    """The fields every model's initial state shares: positions X0,
    intercept(s) 1.0, step sizes 0.1."""
    return {
        'it': 0, 'X': X0, 'intercept': np.ones(n_int),
        'step_X': np.full((T, n), 0.1), 'acc_X': np.zeros((T, n)),
        'step_int': np.full((n_int,), 0.1), 'acc_int': np.zeros(n_int),
        'logp': 0.0}


def _mixture_fields(mu0, sigma0, z0):
    return {'z': z0, 'mu': mu0, 'sigma': sigma0, 'lmbda': 0.9,
            'mean_var': 1.0, 'b_scale': 2.4}


def _hdp_fields(weights0, beta0):
    return {'weights': weights0, 'beta': beta0, 'gamma': 1.0,
            'alpha_init': 1.0, 'alpha': 1.0, 'kappa': 4.0}


def _tiny_problem(device, n_chains=1, T=3, n=18, K=5, d=2, seed=0):
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.3, size=(T, n, n)).astype(np.float32)
    Y = np.triu(Y, 1)
    Y = Y + Y.transpose(0, 2, 1)
    z0 = rng.randint(0, K, size=(T, n))
    weights0 = np.full((T, K, K), 1.0 / K)
    cfg = SweepConfig(tune=100, tune_interval=100, n_components=K, **_HYPER)
    sweep = make_hdp_sweep(Y, np.zeros(1, np.float32), cfg, device=device)
    s0 = _single_state(T, n, rng.randn(T, n, d))
    s0.update(_mixture_fields(rng.randn(K, d), np.ones(K), z0),
              **_hdp_fields(weights0, np.full(K, 1.0 / K)))
    state = replicate_state(s0, n_chains, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return sweep, state, gen


def entry(device='cuda'):
    """(fn, example_args): one HDP-LPCM Gibbs sweep, ``fn(state, gen)``,
    on ``device`` (the card by default)."""
    sweep, state, gen = _tiny_problem(resolve_device(device))
    return sweep, (state, gen)


def _initial_lsm_logp(cfg, Y, s0, prior, device):
    """The LSM log joint of the single-chain start, from dense distances
    (the initial sample's logp, lsm.py:252-257)."""
    X = torch.as_tensor(s0['X'], dtype=torch.float32, device=device)[None]
    b = torch.as_tensor(s0['intercept'], dtype=torch.float32,
                        device=device)[None]
    radii = s0.get('radii')
    if radii is not None:
        radii = torch.as_tensor(radii, dtype=torch.float32,
                                device=device)[None]
    Yd = torch.as_tensor(np.asarray(Y, np.float32), device=device)
    prior = torch.as_tensor(prior, device=device)
    return float(_lsm_logp(cfg, Yd, X, b, radii, pairwise_distances(X),
                           prior)[0])


def _fill_missing(Y, is_directed):
    """(the network Y (T, n, n) with its missing dyads filled, the
    missing-dyad mask), or (Y, None) when no dyad is missing: Y validated
    (``models.base``), its -1 or NaN dyads filled by the imputer's
    ``'random'`` strategy as the JAX estimators fill them
    (models/lsm.py:182-183, the same draws), the observed dyads kept (the
    fill mirrors the upper triangle, which on a directed network would
    overwrite the observed lower triangle) and the diagonal 0."""
    Y_valid, _, miss, sample_missing = validate_network(Y, is_directed)
    if not sample_missing:
        return Y, None
    fill = SimpleNetworkImputer(strategy='random',
                                missing_value=-1).fit_transform(Y_valid)
    Y = np.where(miss, fill, Y_valid)
    Y[:, np.arange(Y.shape[1]), np.arange(Y.shape[1])] = 0.0
    if not np.isin(Y, (0.0, 1.0)).all():
        raise ValueError('Y must hold 0/1 dyads, with missing ones coded '
                         '-1 or NaN')
    return Y, miss


def build_state_and_sweep(Y, n_chains, K=10, seed=0, table_cap=64,
                          device='cuda', is_directed=False, model='hdp',
                          n_temps=None, beta_min=0.2):
    """A replicated chain state, the sweep and its generator for the dense
    network Y (T, n, n), undirected or directed, on ``device`` (the card
    by default).  Returns (state, sweep, gen).

    Dyads coded -1 or NaN are missing: they are filled once (the JAX
    estimators' random imputation, observed dyads kept), every chain
    starts from that network in ``state.Y`` with a zero
    ``state.missing_sum``, and the sweep (``cfg.sample_missing``)
    resamples them every sweep.

    With ``n_temps``, the ``n_chains`` slots form ``n_chains // n_temps``
    ladders of ``n_temps`` rungs from 1 down to ``beta_min``
    (``temper_ladder``; ``acc_swap`` zeros), and the returned step is
    ``make_pt_step(sweep, cfg, sweep.Y, n_temps)``: the tempered sweep then
    a replica exchange, as ``bench.py``'s ``tempered`` row builds it.

    * ``model='hdp'``: the sticky HDP-LPCM with K components, in the
      configuration of ``bench.py``'s headline and directed rows; the
      initial state draws the same NumPy random numbers as
      ``bench.build_state_and_sweep(..., quality_init=False)``.
    * ``model='lpcm'``: the finite LPCM with K components, the same
      hyper-priors, ``dirichlet_prior=1.0``, uniform transitions and the
      initial distribution of the random labels (lpcm.py:157-162).
    * ``model='lsm'``: the dynamic LSM with ``tau_sq=2.0``,
      ``sigma_sq=0.1``, no tuning and no burn-in (``n_burn=0``: the
      Procrustes rotation toward the start runs from the first sweep);
      its logp, MAP and Procrustes reference start at the log joint of the
      initial positions.

    Every model starts from N(0, 1) positions and intercept(s) 1.0;
    directed, from radii of the degrees (``initialize_radii``) with step
    175000, tuned in the mixture models (``tune_radii``) and not in the
    LSM (lsm.py:222)."""
    if model not in ('hdp', 'lpcm', 'lsm'):
        raise ValueError("model must be 'hdp', 'lpcm' or 'lsm', got %r"
                         % (model,))
    if n_temps is not None and n_chains % n_temps:
        raise ValueError('n_chains=%d is not a whole number of %d-rung '
                         'ladders' % (n_chains, n_temps))
    device = resolve_device(device)
    Y, miss = _fill_missing(Y, is_directed)
    missing = dict(sample_missing=miss is not None)
    rng = np.random.RandomState(seed)
    T, n, _ = Y.shape
    d = 2
    n_int = 2 if is_directed else 1
    prior = np.zeros(n_int, np.float32)
    s0 = _single_state(T, n, rng.randn(T, n, d), n_int)
    if miss is not None:
        s0['Y'] = Y
    if is_directed:
        s0.update(radii=initialize_radii(Y), step_radii=175000.0,
                  acc_radii=0.0)

    if model == 'lsm':
        cfg = SweepConfig(is_directed=is_directed, tune=0, n_burn=0,
                          tau_sq=2.0, sigma_sq=0.1, **missing)
        sweep = make_lsm_sweep(Y, prior, cfg, device=device, miss_mask=miss)
        logp0 = _initial_lsm_logp(cfg, Y, s0, prior, device)
        s0.update(logp=logp0, logp_map=logp0, X_map=s0['X'],
                  intercept_map=s0['intercept'], logp_ref=logp0,
                  X_ref=s0['X'], radii_map=s0.get('radii'))
    else:
        mu0 = rng.randn(K, d)
        z0 = rng.randint(0, K, size=(T, n))
        s0.update(_mixture_fields(mu0, np.ones(K), z0))
        cfg = SweepConfig(is_directed=is_directed, tune=0, tune_interval=100,
                          n_components=K, table_cap=table_cap,
                          tune_radii=is_directed, **_HYPER, **missing)
        if model == 'hdp':
            weights0 = np.zeros((T, K, K))
            weights0[0, 0] = np.bincount(z0[0], minlength=K) / n
            beta0 = rng.dirichlet(np.full(K, 1.0 / K))
            for t in range(1, T):
                for k in range(K):
                    weights0[t, k] = rng.dirichlet(beta0 + 4.0 * np.eye(K)[k])
            s0.update(_hdp_fields(weights0, beta0))
            sweep = make_hdp_sweep(Y, prior, cfg, device=device,
                                   miss_mask=miss)
        else:
            s0.update(init_weights=np.bincount(z0[0], minlength=K) / n,
                      trans_weights=np.full((K, K), 1.0 / K))
            sweep = make_lpcm_sweep(Y, prior, cfg, device=device,
                                    miss_mask=miss)
    state = replicate_state(s0, n_chains, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if n_temps is not None:
        betas = temper_ladder(n_temps, beta_min, n_chains // n_temps,
                              device=device)
        state = state.replace(temper=betas, acc_swap=torch.zeros_like(betas))
        return state, make_pt_step(sweep, sweep.cfg, sweep.Y, n_temps), gen
    return state, sweep, gen
