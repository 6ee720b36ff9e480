"""Full Gibbs sweeps (counterpart of ``dynetlsm_tpu/mcmc/sweeps.py``) on a
dense undirected or directed (social-radii) network with fixed Y and the
exact latent update:

* LSM (:func:`make_lsm_sweep`, reference lsm.py:474-572): random-walk
  prior on the positions, Procrustes alignment after burn-in, MAP
  tracking;
* LPCM (:func:`make_lpcm_sweep`, reference lpcm.py:514-701): a finite
  Gaussian-mixture HMM over cluster labels;
* sticky HDP-LPCM (:func:`make_hdp_sweep`, reference
  hdp_lpcm.py:823-1069).

Each sweep is a plain function ``sweep(state, gen) -> state`` over a
chain-batched :class:`~dynetlsm_tpu_torch.mcmc.states.LSMState` or
:class:`~dynetlsm_tpu_torch.mcmc.states.MixtureState`; every block draws
from the explicit ``torch.Generator``.  On a CUDA device the latent update
runs the node-scan kernel, and the coefficient steps the pair kernel
(undirected intercept) or the directed kernel (b_in, b_out and radii:
three launches per sweep), so no sweep builds a (C, T, n, n) distance
tensor; the log joint reuses the last coefficient step's log-likelihood at
the accepted state.  The factories store Y on ``device``, the card unless
the caller asks for the CPU (``config.resolve_device``), and expose it as
``sweep.Y`` beside ``sweep.cfg``.

A state with ``temper`` (C,) runs the tempered sweep of parallel tempering
(``mcmc/tempering.py``): the latent update, the intercept step(s) and the
radii step scale their log-likelihood differences by each chain's inverse
temperature; the prior-side blocks (labels, CRF, Dirichlet, conjugate,
concentrations) do not see Y and are unchanged, and ``logp`` stays the
untempered log joint.
"""
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SMALL_EPS, resolve_device
from ..math.distributions import (
    dirichlet_logpdf, sample_dirichlet, truncated_normal_logpdf)
from ..math.procrustes import longitudinal_procrustes_rotation
from ..ops.distances import pairwise_distances
from ..ops.likelihoods import directed_loglik_full, undirected_loglik_full
from ..ops.node_scan import pack_directed, pad_partners, site_cluster_params
from .coefficients import (
    sample_intercept_undirected, sample_intercepts_directed, sample_radii)
from .conjugate import (
    sample_cluster_means, sample_cluster_variances, sample_lambda,
    sample_mean_variance_hyper, sample_sigma_scale_hyper)
from .hdp import (
    sample_alpha_kappa_rho, sample_concentration_param, sample_mbar,
    sample_tables)
from .labels import (
    _label_statistics, sample_labels_block, sample_labels_block_lpcm)
from .latent import sample_latent_positions
from .metropolis import maybe_tune
from .states import LSMState, MixtureState


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Static sweep configuration (the LSM, LPCM and HDP-LPCM fields of
    the JAX package's ``SweepConfig``)."""
    is_directed: bool = False
    sample_missing: bool = False
    tune: int = 0                 # sweeps of step-size adaptation
    tune_interval: int = 100
    n_burn: int = 0               # tune + burn
    # LSM random-walk prior variances
    tau_sq: float = 2.0
    sigma_sq: float = 0.1
    tune_radii: bool = False      # adapt the directed radii's step size
    intercept_variance_prior: float = 2.0
    n_components: int = 10
    a: float = 2.0
    lambda_prior: float = 0.9
    lambda_variance_prior: float = 0.01
    # hyper-prior shapes (None disables resampling)
    a0: Optional[float] = None
    b0: Optional[float] = None
    c0: Optional[float] = None
    d0: Optional[float] = None
    gamma_prior_shape: float = 1.0
    gamma_prior_rate: float = 0.1
    alpha_init_shape: float = 1.0
    alpha_init_rate: float = 1.0
    alpha_kappa_shape: float = 5.0
    alpha_kappa_rate: float = 0.1
    dirichlet_prior: float = 1.0  # LPCM Dirichlet concentration
    n_control: Optional[int] = None
    latent_update: str = 'exact'
    table_cap: int = 64
    sample_concentrations: bool = True
    center: bool = True


def _check_supported(cfg):
    if cfg.sample_missing:
        raise NotImplementedError('missing-dyad resampling is not ported '
                                  'yet')
    if cfg.n_control is not None:
        raise NotImplementedError('the case-control likelihood is not '
                                  'ported yet')
    if cfg.latent_update != 'exact':
        raise NotImplementedError(
            "latent_update=%r is not ported yet; only 'exact'"
            % (cfg.latent_update,))


def _fixed_network(Y_fixed, intercept_prior, cfg, device):
    """Check the configuration and store the fixed 0/1 network Y (T, n, n)
    as uint8 on ``device`` (packed as ``Y + 2 Y^T`` for the directed
    model, once here).  Returns (Y, Y with its rows padded for the node
    scan (``pad_partners``, once here), the prior means as a (1, P)
    tensor, the same as a list of floats)."""
    _check_supported(cfg)
    device = resolve_device(device)
    Y_np = np.asarray(Y_fixed)
    if not np.isin(Y_np, (0, 1)).all():
        raise ValueError('Y_fixed must be a 0/1 adjacency (missing dyads '
                         'are not ported yet)')
    Y = torch.as_tensor(Y_np.astype(np.uint8), device=device)
    if cfg.is_directed:
        Y = pack_directed(Y)
    prior = torch.as_tensor(np.asarray(intercept_prior, np.float32),
                            device=device).reshape(1, -1)
    return Y, pad_partners(Y), prior, [float(m) for m in prior[0]]


def _sample_coefficients(cfg, gen, Y, X, state, prior_means):
    """The intercept step, then the radii step when directed.  Returns
    (intercept, acc_int, radii, acc_radii, the network log-likelihood at
    the accepted state)."""
    radii, acc_radii = state.radii, state.acc_radii
    if cfg.is_directed:
        intercept, acc_i, net_ll = sample_intercepts_directed(
            gen, Y, X, state.intercept, state.radii, state.step_int,
            prior_means, cfg.intercept_variance_prior, temper=state.temper)
        radii, acc_r, net_ll = sample_radii(
            gen, Y, X, intercept, state.radii, state.step_radii,
            loglik_cur=net_ll, temper=state.temper)
        acc_radii = state.acc_radii + acc_r
    else:
        intercept, acc_i, net_ll = sample_intercept_undirected(
            gen, Y, X, state.intercept, state.step_int, prior_means[0],
            cfg.intercept_variance_prior, temper=state.temper)
    return intercept, state.acc_int + acc_i, radii, acc_radii, net_ll


def _intercept_logprior(cfg, intercept, intercept_prior):
    diff = intercept - intercept_prior
    return -torch.sum(0.5 * diff * diff / cfg.intercept_variance_prior,
                      dim=1)


def _lsm_logp(cfg, Y, X, intercept, radii, dist, intercept_prior,
              net_ll=None):
    """LSM log joint per chain (reference lsm.py:576-625): the network
    log-likelihood (``net_ll`` if given, else from the dense distances
    ``dist`` and the 0/1 Y), the random-walk prior of the positions and
    the intercepts' Gaussian prior.  intercept_prior (1, P) or (P,)."""
    ll = (net_ll if net_ll is not None
          else _network_loglik(cfg, Y, dist, intercept, radii))
    ll = ll - 0.5 * torch.sum(X[:, 0] * X[:, 0], dim=(1, 2)) / cfg.tau_sq
    if X.shape[1] > 1:
        diff = X[:, 1:] - X[:, :-1]
        ll = ll - 0.5 * torch.sum(diff * diff, dim=(1, 2, 3)) / cfg.sigma_sq
    return ll + _intercept_logprior(cfg, intercept, intercept_prior)


def _latent_mixture_loglik(X, z, mu, sigma, lmbda):
    """Latent-position log density under the mixture dynamics (reference
    hdp_lpcm.py:1247-1253), per chain."""
    mu_z, sig_z = site_cluster_params(mu, sigma, z)
    diff0 = X[:, 0] - mu_z[:, 0]
    ll = torch.sum(-0.5 * torch.log(sig_z[:, 0])
                   - 0.5 * torch.sum(diff0 * diff0, dim=-1) / sig_z[:, 0],
                   dim=1)
    if X.shape[1] > 1:
        lam = lmbda[:, None, None, None]
        difft = X[:, 1:] - (1.0 - lam) * X[:, :-1] - lam * mu_z[:, 1:]
        ll = ll + torch.sum(
            -0.5 * torch.log(sig_z[:, 1:])
            - 0.5 * torch.sum(difft * difft, dim=-1) / sig_z[:, 1:],
            dim=(1, 2))
    return ll


def _count_chain_loglik(n_trans, nk, w0, w_trans):
    """sum_k nk[0,k] log w0[k] + sum_{t>0} n_trans[t] . log w[t], per
    chain."""
    ll = torch.sum(nk[:, 0] * torch.log(torch.clamp_min(w0, SMALL_EPS)),
                   dim=1)
    if n_trans.shape[1] > 1:
        ll = ll + torch.sum(
            n_trans[:, 1:] * torch.log(torch.clamp_min(w_trans[:, 1:],
                                                       SMALL_EPS)),
            dim=(1, 2, 3))
    return ll


def _network_loglik(cfg, Y, dist, intercept, radii):
    """Dense network log-likelihood; Y (T, n, n) 0/1."""
    if cfg.is_directed:
        return directed_loglik_full(Y, dist, radii, intercept[:, 0],
                                    intercept[:, 1])
    return undirected_loglik_full(Y, dist, intercept[:, 0])


def _mixture_common_logp(cfg, Y, X, intercept, dist, z, mu, sigma, lmbda,
                         mean_var, b_scale, intercept_prior, net_ll=None,
                         radii=None):
    """Network + latent + cluster-parameter + hyper-prior terms of the log
    joint (reference hdp_lpcm.py:1213-1278), with the radii's Dirichlet(1)
    prior when directed.  ``net_ll`` reuses an already-computed network
    log-likelihood at the current state."""
    ll = (net_ll if net_ll is not None
          else _network_loglik(cfg, Y, dist, intercept, radii))
    ll = ll + _intercept_logprior(cfg, intercept, intercept_prior)
    ll = ll + _latent_mixture_loglik(X, z, mu, sigma, lmbda)
    ll = ll - 0.5 * torch.sum(mu * mu, dim=(1, 2)) / mean_var
    _, sig_z = site_cluster_params(mu, sigma, z)
    ll = ll + torch.sum(-(0.5 * cfg.a + 1.0) * torch.log(sig_z)
                        - 0.5 * b_scale[:, None, None] / sig_z, dim=(1, 2))
    ll = ll + truncated_normal_logpdf(lmbda, cfg.lambda_prior,
                                      cfg.lambda_variance_prior)
    if cfg.is_directed:
        ll = ll + dirichlet_logpdf(radii, torch.ones_like(radii))
    if cfg.a0 is not None:
        ll = ll + (-(0.5 * cfg.a0 + 1.0) * torch.log(mean_var)
                   - 0.5 * cfg.b0 / mean_var)
    if cfg.c0 is not None:
        ll = ll + (cfg.c0 - 1.0) * torch.log(b_scale) - cfg.d0 * b_scale
    return ll


def _hdp_weights_logp(beta, w0, weights, gamma, alpha_init, alpha, kappa):
    """Dirichlet prior terms of beta, the initial and the transition
    distributions, per chain."""
    C, K = beta.shape
    T = weights.shape[1]
    eye = torch.eye(K, dtype=beta.dtype, device=beta.device)
    logp = dirichlet_logpdf(beta, (gamma / K)[:, None].expand(C, K))
    logp = logp + dirichlet_logpdf(w0, alpha_init[:, None] * beta)
    conc_w = (alpha[:, None, None, None] * beta[:, None, None, :]
              + kappa[:, None, None, None] * eye)
    logp = logp + torch.sum(dirichlet_logpdf(
        weights[:, 1:], conc_w.expand(C, T - 1, K, K)), dim=(1, 2))
    return logp


def hdp_logp_at_state(cfg, Y, intercept_prior, X, intercept, z, mu, sigma,
                      lmbda, weights, beta, gamma, alpha_init, alpha, kappa,
                      mean_var, b_scale, radii=None):
    """Full HDP-LPCM log joint at an arbitrary chain-batched state, with
    the network term from dense distances (reference hdp_lpcm.py:798-809).
    Y (T, n, n) 0/1; intercept_prior (1,), or (2,) and radii (C, n) for
    the directed model."""
    K = cfg.n_components
    n_trans, nk, _ = _label_statistics(z, K)
    prior = torch.as_tensor(intercept_prior, dtype=X.dtype, device=X.device)
    w0 = weights[:, 0, 0]
    logp = _hdp_weights_logp(beta, w0, weights, gamma, alpha_init, alpha,
                             kappa)
    logp = logp + _count_chain_loglik(n_trans, nk, w0, weights)
    return logp + _mixture_common_logp(
        cfg, Y, X, intercept, pairwise_distances(X), z, mu, sigma, lmbda,
        mean_var, b_scale, prior, radii=radii)


def _finish_tuning(cfg, state, acc_X, acc_int, acc_radii):
    step_X, acc_X = maybe_tune(state.it, cfg.tune, cfg.tune_interval,
                               state.step_X, acc_X)
    step_int, acc_int = maybe_tune(state.it, cfg.tune, cfg.tune_interval,
                                   state.step_int, acc_int)
    step_radii = state.step_radii
    if cfg.is_directed and cfg.tune_radii:
        step_radii, acc_radii = maybe_tune(
            state.it, cfg.tune, cfg.tune_interval, state.step_radii,
            acc_radii, kind='dirichlet')
    return step_X, acc_X, step_int, acc_int, step_radii, acc_radii


def _chain_mask(mask, like):
    """A (C,) mask shaped to broadcast against ``like`` (C, ...)."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def make_lsm_sweep(Y_fixed, intercept_prior, cfg: SweepConfig,
                   device='cuda'):
    """Build the dynamic LSM sweep (reference lsm.py:474-572) over the
    fixed 0/1 network ``Y_fixed`` (T, n, n), on ``device``.
    ``intercept_prior`` holds one prior mean, or (b_in, b_out)'s two when
    directed.  In order: the latent positions under the random-walk prior
    (``cfg.tau_sq``, ``cfg.sigma_sq``); the Procrustes rotation toward
    ``X_ref`` once a chain's sweep count passes ``cfg.n_burn``; centering;
    the intercept(s) and, directed, the radii; the log joint; MAP tracking
    (reset at the end of tuning) and ``X_ref`` tracking up to
    ``cfg.n_burn``; step-size tuning.  The returned ``sweep(state, gen)``
    carries its configuration as ``sweep.cfg`` and the stored network as
    ``sweep.Y``."""
    Y, Y_scan, prior, prior_means = _fixed_network(Y_fixed, intercept_prior,
                                                   cfg, device)

    def sweep(state: LSMState, gen: torch.Generator) -> LSMState:
        it_next = state.it + 1

        # latent positions (random-walk prior)
        X, acc_new = sample_latent_positions(
            gen, Y_scan, state.X, state.intercept, state.step_X,
            tau_sq=cfg.tau_sq, sigma_sq=cfg.sigma_sq, radii=state.radii,
            is_directed=cfg.is_directed, mixture=False, temper=state.temper)
        acc_X = state.acc_X + acc_new

        # Procrustes toward the burn-phase reference (lsm.py:495-498),
        # then centering across time (lsm.py:501)
        X_rot, _ = longitudinal_procrustes_rotation(state.X_ref, X)
        X = torch.where(_chain_mask(it_next > cfg.n_burn, X), X_rot, X)
        if cfg.center:
            X = X - torch.mean(X, dim=(1, 2), keepdim=True)

        intercept, acc_int, radii, acc_radii, net_ll = _sample_coefficients(
            cfg, gen, Y, X, state, prior_means)

        # log joint and MAP tracking (lsm.py:547-566)
        logp = _lsm_logp(cfg, Y, X, intercept, radii, None, prior,
                         net_ll=net_ll)
        better = logp > state.logp_map
        if cfg.tune > 0:
            better = better | (it_next == cfg.n_burn)
        logp_map = torch.where(better, logp, state.logp_map)
        X_map = torch.where(_chain_mask(better, X), X, state.X_map)
        intercept_map = torch.where(better[:, None], intercept,
                                    state.intercept_map)
        radii_map = state.radii_map
        if cfg.is_directed:
            radii_map = torch.where(better[:, None], radii, state.radii_map)

        # Procrustes reference: the best sample up to the end of burn-in
        ref_better = (it_next <= cfg.n_burn) & (logp > state.logp_ref)
        logp_ref = torch.where(ref_better, logp, state.logp_ref)
        X_ref = torch.where(_chain_mask(ref_better, X), X, state.X_ref)

        step_X, acc_X, step_int, acc_int, step_radii, acc_radii = (
            _finish_tuning(cfg, state, acc_X, acc_int, acc_radii))
        return state.replace(
            it=it_next, X=X, intercept=intercept, radii=radii,
            step_X=step_X, acc_X=acc_X, step_int=step_int, acc_int=acc_int,
            step_radii=step_radii, acc_radii=acc_radii, logp=logp,
            logp_map=logp_map, X_map=X_map, intercept_map=intercept_map,
            radii_map=radii_map, logp_ref=logp_ref, X_ref=X_ref)

    sweep.cfg = cfg
    sweep.Y = Y
    return sweep


def _lpcm_weights_logp(cfg, init_weights, trans_weights):
    """Dirichlet(dirichlet_prior) prior terms of the LPCM's initial
    distribution (C, K) and transition rows (C, K, K), per chain."""
    dp = cfg.dirichlet_prior
    logp = dirichlet_logpdf(init_weights, torch.full_like(init_weights, dp))
    return logp + torch.sum(dirichlet_logpdf(
        trans_weights, torch.full_like(trans_weights, dp)), dim=1)


def _lpcm_count_loglik(n_trans, nk, init_weights, trans_weights):
    C, T, K, _ = n_trans.shape
    return _count_chain_loglik(n_trans, nk, init_weights,
                               trans_weights[:, None].expand(C, T, K, K))


def lpcm_logp_at_state(cfg, Y, intercept_prior, X, intercept, z, mu, sigma,
                       lmbda, init_weights, trans_weights, mean_var, b_scale,
                       radii=None):
    """Full LPCM log joint at an arbitrary chain-batched state, with the
    network term from dense distances (reference lpcm.py:770-856).
    Y (T, n, n) 0/1; intercept_prior (1,), or (2,) and radii (C, n) for
    the directed model."""
    n_trans, nk, _ = _label_statistics(z, cfg.n_components)
    prior = torch.as_tensor(intercept_prior, dtype=X.dtype, device=X.device)
    logp = _lpcm_weights_logp(cfg, init_weights, trans_weights)
    logp = logp + _lpcm_count_loglik(n_trans, nk, init_weights,
                                     trans_weights)
    return logp + _mixture_common_logp(
        cfg, Y, X, intercept, pairwise_distances(X), z, mu, sigma, lmbda,
        mean_var, b_scale, prior, radii=radii)


def _conjugate_blocks(cfg, gen, X, state, z, resp, nk):
    """The cluster means, variances and lambda given the new labels, then
    the hyper-priors (hdp_lpcm.py:901-972).  Returns (mu, sigma, lmbda,
    mean_var, b_scale)."""
    mu = sample_cluster_means(gen, X, resp, nk, state.sigma, state.lmbda,
                              state.mean_var)
    sigma = sample_cluster_variances(gen, X, resp, nk, mu, state.lmbda,
                                     cfg.a, state.b_scale)
    lmbda = sample_lambda(gen, X, z, mu, sigma, cfg.lambda_prior,
                          cfg.lambda_variance_prior)
    mean_var = state.mean_var
    if cfg.a0 is not None:
        mean_var = sample_mean_variance_hyper(gen, mu, cfg.a0, cfg.b0)
    b_scale = state.b_scale
    if cfg.c0 is not None:
        b_scale = sample_sigma_scale_hyper(gen, sigma, cfg.a, cfg.c0,
                                           cfg.d0)
    return mu, sigma, lmbda, mean_var, b_scale


def _mixture_latent_and_coefficients(cfg, gen, Y, Y_scan, state,
                                     prior_means):
    """The latent positions under the mixture prior (on the padded
    ``Y_scan``), centering, then the intercept(s) and radii.  Returns (X,
    acc_X, intercept, acc_int, radii, acc_radii, net_ll)."""
    X, acc_new = sample_latent_positions(
        gen, Y_scan, state.X, state.intercept, state.step_X, mu=state.mu,
        sigma=state.sigma, lmbda=state.lmbda, z=state.z, radii=state.radii,
        is_directed=cfg.is_directed, temper=state.temper)
    if cfg.center:
        X = X - torch.mean(X, dim=(1, 2), keepdim=True)
    return (X, state.acc_X + acc_new) + _sample_coefficients(
        cfg, gen, Y, X, state, prior_means)


def make_lpcm_sweep(Y_fixed, intercept_prior, cfg: SweepConfig,
                    device='cuda'):
    """Build the finite-K LPCM sweep (reference lpcm.py:514-701) over the
    fixed 0/1 network ``Y_fixed`` (T, n, n), on ``device``: latent
    positions (mixture prior) and centering, intercept(s) and radii,
    blocked FFBS labels with one transition matrix, Dirichlet draws of the
    initial and transition distributions, the conjugate cluster blocks and
    hyper-priors, the log joint and tuning.  ``sweep.cfg`` is its
    configuration and ``sweep.Y`` the stored network."""
    Y, Y_scan, prior, prior_means = _fixed_network(Y_fixed, intercept_prior,
                                                   cfg, device)

    def sweep(state: MixtureState, gen: torch.Generator) -> MixtureState:
        (X, acc_X, intercept, acc_int, radii, acc_radii,
         net_ll) = _mixture_latent_and_coefficients(cfg, gen, Y, Y_scan,
                                                    state, prior_means)

        # labels via blocked FFBS (lpcm.py:567-570)
        z, n_trans, nk, resp = sample_labels_block_lpcm(
            gen, X, state.mu, state.sigma, state.lmbda, state.init_weights,
            state.trans_weights)

        # initial and transition distributions (lpcm.py:572-579)
        init_weights = sample_dirichlet(gen, cfg.dirichlet_prior + nk[:, 0])
        trans_weights = sample_dirichlet(
            gen, cfg.dirichlet_prior + torch.sum(n_trans[:, 1:], dim=1))

        mu, sigma, lmbda, mean_var, b_scale = _conjugate_blocks(
            cfg, gen, X, state, z, resp, nk)

        # log joint (lpcm.py:770-856)
        logp = _lpcm_weights_logp(cfg, init_weights, trans_weights)
        logp = logp + _lpcm_count_loglik(n_trans, nk, init_weights,
                                         trans_weights)
        logp = logp + _mixture_common_logp(
            cfg, Y, X, intercept, None, z, mu, sigma, lmbda, mean_var,
            b_scale, prior, net_ll=net_ll, radii=radii)

        step_X, acc_X, step_int, acc_int, step_radii, acc_radii = (
            _finish_tuning(cfg, state, acc_X, acc_int, acc_radii))
        return state.replace(
            it=state.it + 1, X=X, intercept=intercept, z=z, mu=mu,
            sigma=sigma, lmbda=lmbda, init_weights=init_weights,
            trans_weights=trans_weights, mean_var=mean_var, b_scale=b_scale,
            step_X=step_X, acc_X=acc_X, step_int=step_int, acc_int=acc_int,
            radii=radii, step_radii=step_radii, acc_radii=acc_radii,
            logp=logp)

    sweep.cfg = cfg
    sweep.Y = Y
    return sweep


def make_hdp_sweep(Y_fixed, intercept_prior, cfg: SweepConfig,
                   device='cuda'):
    """Build the sticky HDP-LPCM sweep over the fixed 0/1 network
    ``Y_fixed`` (T, n, n), stored as uint8 on ``device`` (packed as
    ``Y + 2 Y^T`` for the directed model, once here).  ``intercept_prior``
    holds one prior mean, or (b_in, b_out)'s two when directed.  The
    returned ``sweep(state, gen)`` carries its configuration as
    ``sweep.cfg`` and the stored network as ``sweep.Y``."""
    Y, Y_scan, prior, prior_means = _fixed_network(Y_fixed, intercept_prior,
                                                   cfg, device)
    K = cfg.n_components

    def sweep(state: MixtureState, gen: torch.Generator) -> MixtureState:
        C, T, n, _ = state.X.shape
        eye = torch.eye(K, dtype=state.X.dtype, device=state.X.device)
        (X, acc_X, intercept, acc_int, radii, acc_radii,
         net_ll) = _mixture_latent_and_coefficients(cfg, gen, Y, Y_scan,
                                                    state, prior_means)

        # blocked label sampling (hdp_lpcm.py:877)
        z, n_trans, nk, resp = sample_labels_block(
            gen, X, state.mu, state.sigma, state.lmbda, state.weights)

        # CRF auxiliary variables (hdp_lpcm.py:881-884)
        m = sample_tables(gen, n_trans, state.beta, state.alpha_init,
                          state.alpha, state.kappa, n_max=n,
                          cap=cfg.table_cap)
        m_bar, w_override = sample_mbar(gen, m, state.beta, state.kappa,
                                        state.alpha, n_max=n,
                                        cap=cfg.table_cap)

        # global stick weights, initial and transition distributions
        beta = sample_dirichlet(gen, state.gamma[:, None] / K + m_bar)
        w0 = sample_dirichlet(gen, state.alpha_init[:, None] * beta
                              + nk[:, 0])
        conc_t = (state.alpha[:, None, None, None] * beta[:, None, None, :]
                  + state.kappa[:, None, None, None] * eye + n_trans[:, 1:])
        w_rest = sample_dirichlet(gen, conc_t)
        w_first = torch.zeros((C, 1, K, K), dtype=X.dtype, device=X.device)
        w_first[:, 0, 0] = w0
        weights = torch.cat([w_first, w_rest], dim=1)

        mu, sigma, lmbda, mean_var, b_scale = _conjugate_blocks(
            cfg, gen, X, state, z, resp, nk)

        # concentration parameters (hdp_lpcm.py:977-1023)
        if cfg.sample_concentrations:
            gamma = sample_concentration_param(
                gen, state.gamma,
                n_clusters=torch.sum(m_bar > 0, dim=1).to(X.dtype),
                n_samples=torch.clamp_min(torch.sum(m_bar, dim=1), 1.0),
                prior_shape=cfg.gamma_prior_shape,
                prior_rate=cfg.gamma_prior_rate)
            alpha_init = sample_concentration_param(
                gen, state.alpha_init,
                n_clusters=torch.sum(m[:, 0, 0], dim=1),
                n_samples=torch.full_like(state.alpha_init, float(n)),
                prior_shape=cfg.alpha_init_shape,
                prior_rate=cfg.alpha_init_rate)
            alpha, kappa = sample_alpha_kappa_rho(
                gen, n_trans, m, w_override, state.alpha, state.kappa,
                cfg.alpha_kappa_shape, cfg.alpha_kappa_rate)
        else:
            gamma, alpha_init = state.gamma, state.alpha_init
            alpha, kappa = state.alpha, state.kappa

        # log joint (hdp_lpcm.py:1188-1280)
        logp = _hdp_weights_logp(beta, w0, weights, gamma, alpha_init,
                                 alpha, kappa)
        logp = logp + _count_chain_loglik(n_trans, nk, w0, weights)
        logp = logp + _mixture_common_logp(
            cfg, Y, X, intercept, None, z, mu, sigma, lmbda, mean_var,
            b_scale, prior, net_ll=net_ll, radii=radii)

        step_X, acc_X, step_int, acc_int, step_radii, acc_radii = (
            _finish_tuning(cfg, state, acc_X, acc_int, acc_radii))
        return state.replace(
            it=state.it + 1, X=X, intercept=intercept, z=z, mu=mu,
            sigma=sigma, lmbda=lmbda, weights=weights, beta=beta,
            gamma=gamma, alpha_init=alpha_init, alpha=alpha, kappa=kappa,
            mean_var=mean_var, b_scale=b_scale, step_X=step_X, acc_X=acc_X,
            step_int=step_int, acc_int=acc_int, radii=radii,
            step_radii=step_radii, acc_radii=acc_radii, logp=logp)

    sweep.cfg = cfg
    sweep.Y = Y
    return sweep
