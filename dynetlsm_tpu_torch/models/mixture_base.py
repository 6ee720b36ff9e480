"""Shared fitting machinery of the LPCM and HDP-LPCM estimators
(counterpart of ``dynetlsm_tpu/models/mixture_base.py``):

* the nested LSM + longitudinal k-means initialisation
  (hdp_lpcm.py:48-141), on the fit's device;
* hyper-prior auto-scaling (hdp_lpcm.py:753-793);
* trace post-processing: co-occurrence, Procrustes alignment (batched on
  the device, in float32, in chunks of samples), posterior means, Geweke
  diagnostics and forecasts (hdp_lpcm.py:1140-1176, 498-629).
"""
from math import ceil

import numpy as np
import torch
from scipy.spatial.distance import pdist, squareform
from scipy.special import expit

from ..config import resolve_device
from ..diagnostics import (
    geweke_diag, multichain_effective_n, potential_scale_reduction)
from ..label_utils import (
    calculate_posterior_cooccurrence, calculate_posterior_group_counts)
from ..math.init import check_random_state, longitudinal_kmeans
from ..math.procrustes import longitudinal_procrustes_rotation
from ..metrics import network_auc
from ..ops.node_scan import check_smem
from ..ops.distances import pairwise_distances
from ..ops.forecast import marginal_forecast
from .base import (
    StageTimer, build_case_control, check_supported, controls_of, fit_mesh,
    fit_rng, init_cc_dict, resolve_n_control, validate_network)
from .lsm import DynamicNetworkLSM, _f32, network_probas


def init_from_lsm(Y, is_directed, n_features, sample_missing,
                  n_control, n_resample_control, random_state,
                  lsm_kwargs=None, device='cuda', node_devices=1,
                  devices=None):
    """Nested short LSM run used to initialise X / intercept / radii
    (reference hdp_lpcm.py:58-86), on ``device``.  ``node_devices`` /
    ``devices`` propagate the caller's sharding (JAX
    mixture_base.py:33-45): a network that needs a node-sharded main fit
    would not fit the init on one device, and the init must not spill onto
    devices the caller excluded; under node sharding the nested LSM takes
    ``latent_update='parallel'``.  Returns (the fitted LSM, Y with its
    missing dyads set to the LSM's rounded probabilities)."""
    common = dict(n_iter=500, tune=250, burn=250, n_features=n_features,
                  is_directed=is_directed, random_state=random_state,
                  device=device, devices=devices)
    if node_devices and node_devices > 1:
        common.update(node_devices=node_devices, latent_update='parallel')
    if is_directed:
        common.update(sigma_sq=0.001, tau_sq='auto', step_size_X=0.0075,
                      n_control=n_control,
                      n_resample_control=n_resample_control)
    else:
        common.update(sigma_sq=0.1, tau_sq=2.0, step_size_X=0.1)
    if lsm_kwargs:
        common.update(lsm_kwargs)
    emb = DynamicNetworkLSM(**common).fit(Y)

    Y_fit = np.array(Y, copy=True)
    if sample_missing:
        nan_mask = Y == -1
        Y_fit[nan_mask] = (emb.probas_[nan_mask] > 0.5).astype(np.float64)
    return emb, Y_fit


def resolve_hyperpriors(self, n_nodes):
    """Auto-scale tau^2 / b hyper-priors (reference hdp_lpcm.py:753-793).
    Sets mean_variance_prior_, a0_, b0_, b_, c0_, d0_ on the estimator."""
    if self.mean_variance_prior == 'auto':
        if self.is_directed:
            self.mean_variance_prior_ = (
                2.0 * (1.0 / n_nodes) ** (2.0 / self.n_features))
        else:
            self.mean_variance_prior_ = (
                n_nodes ** (2.0 / self.n_features)) / 50.0
    else:
        self.mean_variance_prior_ = float(self.mean_variance_prior)

    self.a0_ = self.b0_ = None
    if self.mean_variance_prior_std is not None:
        self.a0_ = (self.mean_variance_prior_std ** 2 + 2) * 2
        self.b0_ = (self.a0_ - 2) * self.mean_variance_prior_ * 2

    if self.b == 'auto':
        self.b_ = (self.a + 2) * self.mean_variance_prior_
    else:
        self.b_ = float(self.b)

    self.c0_ = self.d0_ = None
    if self.sigma_prior_std is not None:
        self.d0_ = (self.sigma_prior_std ** 2 / self.b_) * 2
        self.c0_ = self.b_ * self.d0_


class MixtureModelMixin:
    """Post-fit machinery shared by DynamicNetworkLPCM / HDPLPCM."""

    @property
    def n_burn_(self):
        n_burn = 0
        if self.burn is not None:
            n_burn += self.burn
        if self.tune is not None:
            n_burn += self.tune
        return ceil(n_burn / self.thin) if self.thin else n_burn

    @property
    def distances_(self):
        if not hasattr(self, 'X_'):
            raise ValueError('Model not fit.')
        return pairwise_distances(_f32(self.X_)).numpy()

    @property
    def probas_(self):
        if not hasattr(self, 'X_'):
            raise ValueError('Model not fit.')
        return network_probas(self.X_, self.intercept_,
                              getattr(self, 'radii_', None), self.is_directed)

    @property
    def auc_(self):
        if not hasattr(self, 'X_'):
            raise ValueError('Model not fit.')
        return network_auc(self.Y_fit_, self.probas_,
                           is_directed=self.is_directed,
                           nan_mask=self.nan_mask_)

    # ------------------------------------------------------------ fitting

    def _initialise(self, Y):
        """The fit's first stages: the unsupported keywords, the device,
        the network (validated, its size checked against the node-scan
        kernel before any work), the nested LSM fit and the longitudinal
        k-means, drawing from the fit's RandomState in the JAX estimators'
        order (hdp_lpcm.py:150-183).  Returns (rng, the network's missing
        mask or None, X0, intercept0, radii0, mu0, sigma0, z0)."""
        check_supported(self)
        self.device_ = resolve_device(self.device)
        self._timer = StageTimer(self.device_)
        rng = fit_rng(self.random_state)
        Y, nan_mask, miss_mask, sample_missing = validate_network(
            Y, self.is_directed, copy=self.copy)
        self.nan_mask_ = nan_mask
        T, n, _ = Y.shape
        # the mesh before any initialisation work (JAX lsm.py:171-178)
        fit_mesh(self, n, self.device_)
        self.n_control_ = resolve_n_control(self.n_control, n)
        # the node-scan kernel's limit (ops/node_scan.py::max_nodes),
        # before the nested LSM fit (the case-control sweep runs no node
        # scan)
        if self.n_control_ is None:
            check_smem(T, n, self.n_features, self.is_directed)

        # ---- nested LSM init + kmeans (reference hdp_lpcm.py:48-141)
        with self._timer('nested lsm fit'):
            emb, self.Y_fit_ = init_from_lsm(
                Y, self.is_directed, self.n_features, sample_missing,
                self.n_control, self.n_resample_control,
                rng.randint(0, 2**31 - 1), device=self.device_,
                node_devices=self.node_devices, devices=self.devices)
        for stage, sec in getattr(emb, 'stage_seconds_', {}).items():
            self._timer.seconds['nested lsm: ' + stage] = sec
        with self._timer('kmeans'):
            mu0, sigma0, z0 = longitudinal_kmeans(
                emb.X_, n_clusters=self.n_components,
                random_state=rng.randint(0, 2**31 - 1))
        return (rng, miss_mask if sample_missing else None, emb.X_,
                emb.intercept_, emb.radii_ if self.is_directed else None,
                mu0, sigma0, z0)

    def _resolve_priors(self, intercept0, n):
        """``step_size_X_``, ``intercept_prior_`` and the hyper-priors;
        returns the prior means as float32."""
        if self.step_size_X == 'auto':
            self.step_size_X_ = 0.01 if self.is_directed else 0.1
        else:
            self.step_size_X_ = float(self.step_size_X)
        intercept_prior = self.intercept_prior
        if isinstance(intercept_prior, str) and intercept_prior == 'auto':
            intercept_prior = intercept0.copy()
        intercept_prior = np.broadcast_to(
            np.asarray(intercept_prior, np.float64), intercept0.shape)
        self.intercept_prior_ = np.asarray(intercept_prior)
        resolve_hyperpriors(self, n)
        return self.intercept_prior_.astype(np.float32)

    def _case_control(self, cfg, rng, miss_mask):
        """(cc_static, initial controls, the initial logp's structures) of
        the fit when ``cfg.n_control`` is set (``base.build_case_control``,
        drawing from ``rng`` where the JAX estimators do), else Nones."""
        cc_static, ctrl0 = build_case_control(cfg, self.Y_fit_, rng,
                                              self.device_,
                                              miss_mask=miss_mask)
        Y = (torch.as_tensor(self.Y_fit_, dtype=torch.uint8,
                             device=self.device_)
             if cfg.sample_missing and cc_static else None)
        return cc_static, ctrl0, init_cc_dict(cfg, Y, cc_static, ctrl0)

    def _initial_state(self, X0, intercept0, radii0, z0, mu0, sigma0,
                       Y_missing, ctrl0=None):
        """The single-chain start shared by both mixture models
        (hdp_lpcm.py:277-308); the caller adds its weights and logp."""
        T, n = z0.shape
        s0 = {'it': 0, 'X': X0, 'intercept': intercept0, 'radii': radii0,
              'z': z0, 'mu': mu0, 'sigma': sigma0,
              'lmbda': float(self.lambda_prior),
              'mean_var': self.mean_variance_prior_, 'b_scale': self.b_,
              'step_X': np.full((T, n), self.step_size_X_),
              'acc_X': np.zeros((T, n)),
              'step_int': np.full(intercept0.shape,
                                  float(self.step_size_intercept)),
              'acc_int': np.zeros(intercept0.shape)}
        if self.is_directed:
            s0.update(step_radii=float(self.step_size_radii), acc_radii=0.0)
        if Y_missing is not None:
            s0['Y'] = Y_missing
        s0.update(controls_of(ctrl0))
        return s0

    def _store_missings(self, cfg, n_total):
        """``missings_``: chain 0's average draw of each missing dyad after
        burn-in (hdp_lpcm.py:437-441)."""
        if cfg.sample_missing:
            denom = max(n_total - 1 - cfg.n_burn, 1)
            self.missings_ = np.asarray(self._final_state.missing_sum[0],
                                        np.float64) / denom

    # -------------------------------------------------------- post-fit glue

    def _flat_posterior(self, name):
        """Post-burn samples of a trace, flattened across chains."""
        arr = getattr(self, name)
        nb = self.n_burn_
        if self.n_chains == 1:
            return arr[nb:]
        return arr[:, nb:].reshape((-1,) + arr.shape[2:])

    def _calculate_posterior_cooccurrences(self):
        T, n, _ = self.Y_fit_.shape
        zs = self._flat_posterior('zs_')
        self.cooccurrence_probas_ = np.stack([
            calculate_posterior_cooccurrence(zs, n_burn=0, t=t,
                                             n_groups=self.n_components)
            for t in range(T)])

    def _align_traces(self, chunk=4096):
        """Procrustes-rotate every stored sample (and cluster means) onto the
        selected model (reference hdp_lpcm.py:1140-1146), ``chunk``
        samples at a time on the fit's device, in float32."""
        device = self.device_
        X_ref = torch.as_tensor(np.asarray(self.X_, np.float32),
                                device=device)
        Xs_np = np.asarray(self.Xs_, np.float32)
        mus_np = np.asarray(self.mus_, np.float32)
        lead = Xs_np.shape[:2] if self.n_chains > 1 else Xs_np.shape[:1]
        Xs_flat = Xs_np.reshape((-1,) + Xs_np.shape[len(lead):])
        mus_flat = mus_np.reshape((-1,) + mus_np.shape[len(lead):])

        out_X = np.empty(Xs_flat.shape, np.float64)
        out_mu = np.empty(mus_flat.shape, np.float64)
        for s0 in range(0, Xs_flat.shape[0], chunk):
            X = torch.as_tensor(Xs_flat[s0:s0 + chunk], device=device)
            mu = torch.as_tensor(mus_flat[s0:s0 + chunk], device=device)
            Xr, R = longitudinal_procrustes_rotation(
                X_ref.expand_as(X), X)
            out_X[s0:s0 + chunk] = Xr.cpu().numpy()
            out_mu[s0:s0 + chunk] = torch.matmul(mu, R).cpu().numpy()

        self.Xs_ = out_X.reshape(Xs_np.shape)
        self.mus_ = out_mu.reshape(mus_np.shape)

    def _store_posterior_means(self):
        self.X_mean_ = self._flat_posterior('Xs_').mean(axis=0)
        self.lambda_mean_ = self._flat_posterior('lambdas_').mean(axis=0)
        self.intercepts_mean_ = self._flat_posterior(
            'intercepts_').mean(axis=0)
        if self.is_directed:
            self.radii_mean_ = self._flat_posterior('radiis_').mean(axis=0)

    def _store_group_counts(self):
        T = self.Y_fit_.shape[0]
        zs = self._flat_posterior('zs_')
        self.posterior_group_ids_, self.posterior_group_counts_ = [], []
        for t in range(T):
            idx, counts = calculate_posterior_group_counts(zs, n_burn=0, t=t)
            self.posterior_group_ids_.append(idx)
            self.posterior_group_counts_.append(counts)

    def _store_geweke(self):
        """Geweke z-scores per chain, reporting the worst |z|; multichain
        fits also get split-R-hat and total ESS of logp."""
        nb = self.n_burn_

        def worst(series_2d):
            # series_2d : (n_chains, n_samples)
            diags = [geweke_diag(c, n_burn=nb) for c in series_2d]
            return diags[int(np.argmax([abs(z) for z, _ in diags]))]

        def chains_of(arr):
            return arr[None] if self.n_chains == 1 else arr

        logps = chains_of(self.logps_)
        lambdas = chains_of(self.lambdas_)
        ints = chains_of(self.intercepts_)
        self.logp_geweke_ = worst(logps)
        self.lambda_geweke_ = worst(lambdas.reshape(lambdas.shape[:2]))
        if self.is_directed:
            self.intercept_in_geweke_ = worst(ints[..., 0])
            self.intercept_out_geweke_ = worst(ints[..., 1])
        else:
            self.intercept_geweke_ = worst(ints[..., 0])

        if self.n_chains > 1:
            post = logps[:, nb:]
            self.logp_rhat_ = potential_scale_reduction(post)
            self.logp_effective_n_ = multichain_effective_n(post)

    # -------------------------------------------------------- forecasting

    def _forecast_samples(self):
        """The per-sample (last labels, last transition matrix, mus,
        sigmas) the plug-in and marginal forecasts average, as a function
        of the flattened sample index: the LPCM's own transition weights
        (reference lpcm.py:243-283); the HDP-LPCM renormalises over each
        sample's active clusters."""
        flat = {name: self._flat_posterior(name + '_') for name in (
            'zs', 'trans_weights', 'mus', 'sigmas')}
        return lambda i: (flat['zs'][i][-1], flat['trans_weights'][i],
                          flat['mus'][i], flat['sigmas'][i])

    def _forecast_xhat(self, renormalized_fn):
        """Posterior-averaged plug-in forecast position X_hat
        (reference hdp_lpcm.py:530-544)."""
        n = self.Y_fit_.shape[1]
        Xs = self._flat_posterior('Xs_')
        lams = np.ravel(self._flat_posterior('lambdas_'))
        S = Xs.shape[0]
        X_hat = np.zeros((n, self.n_features))
        for i in range(S):
            z_last, trans_last, mu, _ = renormalized_fn(i)
            ws = trans_last[z_last]                      # (n, k)
            contrib = ws[..., None] * (
                lams[i] * mu[None, :, :]
                + (1 - lams[i]) * Xs[i, -1][:, None, :])
            X_hat += contrib.sum(axis=1) / S
        return X_hat

    @property
    def forecast_probas_plugin_(self):
        """Posterior-averaged plug-in forecast (reference lpcm.py:243-258,
        hdp_lpcm.py:511-527)."""
        return self._forecast_from(
            self._forecast_xhat(self._forecast_samples()),
            np.ravel(self.intercepts_mean_)[0])

    def _marginal_forecast_inputs(self):
        """The arguments of ``ops.forecast.marginal_forecast`` (x, x_prev,
        z, trans_weights, mus, sigmas, intercepts, lmbdas, renormalize)
        from the flattened traces: the LPCM's (reference lpcm.py:261-283),
        each sample's own transition matrix, not renormalised."""
        return (self._forecast_xhat(self._forecast_samples()),
                self._flat_posterior('Xs_')[:, -1],
                self._flat_posterior('zs_')[:, -1],
                self._flat_posterior('trans_weights_'),
                self._flat_posterior('mus_'),
                self._flat_posterior('sigmas_'),
                self._flat_posterior('intercepts_')[:, 0],
                np.ravel(self._flat_posterior('lambdas_')), False)

    @property
    def forecast_probas_marginalized_(self):
        """Posterior-marginalised one-step-ahead forecast (n, n) float64,
        computed on the fit's device in blocks of posterior samples
        (``ops.forecast.marginal_forecast``; reference lpcm.py:261-283,
        hdp_lpcm.py:530-553)."""
        *args, renormalize = self._marginal_forecast_inputs()
        return marginal_forecast(*args, renormalize=renormalize,
                                 device=self.device_).cpu().numpy()

    def _forecast_from(self, X_ahead, intercept):
        """expit(intercept - distances) of the forecast positions."""
        return expit(float(intercept)
                     - pairwise_distances(_f32(X_ahead)).numpy())

    def _selected_trans_matrix(self):
        """Last-time transition matrix of the selected model: LPCM stores it
        as ``trans_weight_`` (K, K); HDP-LPCM as ``trans_weights_``
        (T, k, k) after renormalisation."""
        if hasattr(self, 'trans_weight_'):
            return np.asarray(self.trans_weight_)
        tw = np.asarray(self.trans_weights_)
        return tw[-1] if tw.ndim == 3 else tw

    def forecast_probas(self, n_samples=5000):
        """Monte-Carlo one-step-ahead probabilities from the selected model
        (reference hdp_lpcm.py:555-587)."""
        rng = check_random_state(self.random_state)
        n = self.X_.shape[1]
        mu, sigma = np.asarray(self.mu_), np.asarray(self.sigma_)
        n_groups = mu.shape[0]
        wt = self._selected_trans_matrix()
        lam = float(np.ravel(self.lambda_)[0])
        z_last = self.z_[-1]
        X_last = self.X_[-1]

        probas = np.zeros((n, n))
        for _ in range(n_samples):
            zt = np.zeros(n, dtype=int)
            for g in range(n_groups):
                mask = z_last == g
                if mask.any():
                    zt[mask] = rng.choice(n_groups, p=wt[g], size=mask.sum())
            Xt = np.zeros_like(X_last)
            for g in range(n_groups):
                mask = zt == g
                if mask.any():
                    Xt[mask] = (sigma[g] * rng.randn(mask.sum(),
                                                     self.n_features)
                                + lam * mu[g] + (1 - lam) * X_last[mask])
            dist = squareform(pdist(Xt))
            probas += expit(float(self.intercept_[0]) - dist) / n_samples
        np.fill_diagonal(probas, 0.0)
        return probas

