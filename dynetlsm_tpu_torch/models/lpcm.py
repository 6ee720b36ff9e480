"""Dynamic latent position cluster model (finite K) on the card
(counterpart of ``dynetlsm_tpu/models/lpcm.py``, reference
lpcm.py:134-873): Gaussian-mixture clustering of the latent positions with
a time-constant HMM over labels, conjugate Gibbs blocks for the mixture
parameters, and MAP/VI model selection.

The constructor keywords, ``.fit(Y)`` and the fitted attributes are the
JAX estimator's, plus ``device`` (the card by default; ``'cpu'`` runs
every kernel's plain version) and ``stage_seconds_``.
"""
import numpy as np
import torch

from ..mcmc.sweeps import SweepConfig, lpcm_logp_at_state, make_lpcm_sweep
from ..model_selection.posterior_vi import minimize_posterior_expected_vi
from .base import sample_chains, with_init
from .mixture_base import MixtureModelMixin

__all__ = ['DynamicNetworkLPCM']


class DynamicNetworkLPCM(MixtureModelMixin):
    """Dynamic latent position clustering model: LSM plus a finite
    Gaussian-mixture HMM over cluster labels (reference lpcm.py:134-327 API
    surface).

    Examples
    --------
    >>> from dynetlsm_tpu_torch import DynamicNetworkLPCM
    >>> from dynetlsm_tpu_torch.datasets import load_dynamic_monks
    >>> Y = load_dynamic_monks(is_directed=False)
    >>> model = DynamicNetworkLPCM(n_components=4, n_iter=100, tune=50,
    ...                            burn=50, random_state=42,
    ...                            device='cpu').fit(Y)
    >>> model.z_.shape
    (3, 18)
    """

    def __init__(self,
                 n_features=2,
                 n_components=5,
                 is_directed=False,
                 selection_type='map',
                 n_iter=5000,
                 tune=2500,
                 tune_interval=100,
                 burn=2500,
                 thin=None,
                 intercept_prior='auto',
                 intercept_variance_prior=2,
                 mean_variance_prior='auto',
                 a=2.0,
                 b='auto',
                 lambda_prior=0.9,
                 lambda_variance_prior=0.01,
                 dirichlet_prior='uniform',
                 sigma_prior_std=4.0,
                 mean_variance_prior_std=4.0,
                 step_size_X='auto',
                 step_size_intercept=0.1,
                 step_size_radii=175000,
                 n_control=None,
                 n_resample_control=100,
                 copy=True,
                 random_state=None,
                 n_chains=1,
                 devices=None,
                 node_devices=1,
                 trace_chunk=512,
                 checkpoint_dir=None,
                 latent_update='exact',
                 n_temps=1,
                 beta_min=0.1,
                 swap_every=1,
                 verbose=False,
                 device='cuda'):
        self.n_iter = n_iter
        self.is_directed = is_directed
        self.selection_type = selection_type
        self.n_features = n_features
        self.n_components = n_components
        self.dirichlet_prior = dirichlet_prior
        self.step_size_X = step_size_X
        self.intercept_prior = intercept_prior
        self.intercept_variance_prior = intercept_variance_prior
        self.step_size_intercept = step_size_intercept
        self.mean_variance_prior = mean_variance_prior
        self.a = a
        self.b = b
        self.lambda_prior = lambda_prior
        self.lambda_variance_prior = lambda_variance_prior
        self.mean_variance_prior_std = mean_variance_prior_std
        self.sigma_prior_std = sigma_prior_std
        self.step_size_radii = step_size_radii
        self.tune = tune
        self.tune_interval = tune_interval
        self.burn = burn
        self.thin = thin
        self.n_control = n_control
        self.n_resample_control = n_resample_control
        self.copy = copy
        self.random_state = random_state
        self.n_chains = n_chains
        self.devices = devices
        self.node_devices = node_devices
        self.trace_chunk = trace_chunk
        self.checkpoint_dir = checkpoint_dir
        self.latent_update = latent_update
        self.n_temps = n_temps
        self.beta_min = beta_min
        self.swap_every = swap_every
        self.verbose = verbose
        self.device = device

    # ------------------------------------------------------------------ fit

    def fit(self, Y):
        K = self.n_components
        (rng, miss_mask, X0, intercept0, radii0, mu0, sigma0,
         z0) = self._initialise(Y)
        T, n, _ = self.Y_fit_.shape
        resp0 = np.eye(K)[z0[0]]
        init_weights0 = resp0.sum(axis=0) / n
        trans_weights0 = np.full((K, K), 1.0 / K)
        lmbda0 = float(self.lambda_prior)

        self.dirichlet_prior_ = (1.0 if self.dirichlet_prior == 'uniform'
                                 else 1.0 / K)
        prior32 = self._resolve_priors(intercept0, n)
        cfg = SweepConfig(
            is_directed=self.is_directed,
            latent_update=self.latent_update,
            sample_missing=miss_mask is not None,
            tune=int(self.tune or 0),
            tune_interval=self.tune_interval,
            n_burn=(self.tune or 0) + (self.burn or 0),
            intercept_variance_prior=float(self.intercept_variance_prior),
            n_components=K,
            a=float(self.a),
            lambda_prior=float(self.lambda_prior),
            lambda_variance_prior=float(self.lambda_variance_prior),
            a0=self.a0_, b0=self.b0_, c0=self.c0_, d0=self.d0_,
            dirichlet_prior=float(self.dirichlet_prior_),
            tune_radii=True, n_control=self.n_control_,
            n_resample_control=int(self.n_resample_control))
        self._cfg = cfg
        cc_static, ctrl0, cc0 = self._case_control(cfg, rng, miss_mask)
        stored = None if cfg.sample_missing or cc_static else self.Y_fit_

        def make_sweep(node_devices, node_seed):
            return make_lpcm_sweep(
                stored, prior32, cfg, device=node_devices[0],
                miss_mask=miss_mask, cc_static=cc_static,
                node_devices=node_devices, node_seed=node_seed)

        s0 = self._initial_state(
            X0, intercept0, radii0, z0, mu0, sigma0,
            self.Y_fit_ if cfg.sample_missing else None, ctrl0)
        s0.update(init_weights=init_weights0, trans_weights=trans_weights0)
        # true log joint of the initial sample (reference lpcm.py:489),
        # on the device: dense, or the case-control estimator
        logp0 = float(self._logp_at(s0, self.Y_fit_, self.device_, cc0))
        s0['logp'] = logp0

        def trace_fn(s):
            out = {'X': s.X, 'intercept': s.intercept, 'z': s.z, 'mu': s.mu,
                   'sigma': s.sigma, 'lmbda': s.lmbda,
                   'init_weights': s.init_weights,
                   'trans_weights': s.trans_weights, 'logp': s.logp}
            if self.is_directed:
                out['radii'] = s.radii
            return out

        tr, n_total = sample_chains(self, make_sweep, cfg, s0, trace_fn,
                                    rng, self.device_, self._timer,
                                    thin=self.thin or 1)
        c = self.n_chains
        self.Xs_ = with_init(tr, 'X', X0, c)
        self.intercepts_ = with_init(tr, 'intercept', intercept0, c)
        self.mus_ = with_init(tr, 'mu', mu0, c)
        self.sigmas_ = with_init(tr, 'sigma', sigma0, c)
        self.zs_ = with_init(tr, 'z', z0, c, np.int32)
        self.init_weights_ = with_init(tr, 'init_weights', init_weights0, c)
        self.trans_weights_ = with_init(tr, 'trans_weights', trans_weights0,
                                        c)
        self.lambdas_ = with_init(tr, 'lmbda', np.asarray(lmbda0), c)
        self.logps_ = with_init(tr, 'logp', np.asarray(logp0), c)
        if self.is_directed:
            self.radiis_ = with_init(tr, 'radii', radii0, c)

        # ---- model selection (reference lpcm.py:717-740; the reference's
        # MAP branch indexes logps_[n_burn:] without re-offsetting — fixed
        # here to select among post-burn samples)
        with self._timer('model selection'):
            self._calculate_posterior_cooccurrences()
            nb = self.n_burn_
            logps_flat = self._flat_posterior('logps_')
            if self.selection_type == 'map':
                best = int(np.argmax(logps_flat))
            else:
                best = minimize_posterior_expected_vi(
                    self._flat_posterior('zs_'), self.cooccurrence_probas_,
                    tie_break=logps_flat, n_groups=self.n_components,
                    device=self.device_)

            self.logp_ = float(logps_flat[best])
            self.X_ = self._flat_posterior('Xs_')[best]
            self.intercept_ = self._flat_posterior('intercepts_')[best]
            self.lambda_ = np.atleast_1d(
                self._flat_posterior('lambdas_')[best])
            if self.is_directed:
                self.radii_ = self._flat_posterior('radiis_')[best]
            self.z_ = self._flat_posterior('zs_')[best]
            self.init_weight_ = self._flat_posterior('init_weights_')[best]
            self.trans_weight_ = self._flat_posterior('trans_weights_')[best]
            self.mu_ = self._flat_posterior('mus_')[best]
            self.sigma_ = self._flat_posterior('sigmas_')[best]
            self.selected_id_ = best + nb if self.n_chains == 1 else best

        with self._timer('alignment'):
            self._align_traces()
        with self._timer('post-processing'):
            self._store_posterior_means()
            self._store_missings(cfg, n_total)
        self.case_control_sampler_ = None
        self.stage_seconds_ = self._timer.seconds
        return self

    def _logp_at(self, s, Y, device, cc=None):
        """The dense log joint (lpcm_logp_at_state) of one state given as
        a dict of arrays (no chain axis), on ``device``; with the
        case-control structures ``cc``, their estimator (Y unread)."""
        def t(name, dtype=torch.float32):
            return torch.as_tensor(np.asarray(s[name]), dtype=dtype,
                                   device=device)[None]
        radii = t('radii') if s.get('radii') is not None else None
        return lpcm_logp_at_state(
            self._cfg, None if cc is not None else torch.as_tensor(
                np.asarray(Y, np.float32), device=device),
            self.intercept_prior_.astype(np.float32), t('X'),
            t('intercept').reshape(1, -1), t('z', torch.int64), t('mu'),
            t('sigma'), t('lmbda'), t('init_weights'), t('trans_weights'),
            t('mean_var'), t('b_scale'), radii=radii, cc=cc)[0]

    def logp(self, X, intercept, mu, sigma, z, init_weights, trans_weights,
             lmbda, radii=None):
        """Log joint density of a posterior sample under the fitted
        hyperparameters (reference lpcm.py:770-856), on the fit's device
        in float32, with the exact dense network likelihood and the final
        tau^2 / b values of the fit's first chain."""
        fs = getattr(self, '_final_state', None)
        s = {'X': X, 'intercept': np.atleast_1d(intercept), 'mu': mu,
             'sigma': sigma, 'z': z, 'init_weights': init_weights,
             'trans_weights': trans_weights, 'lmbda': lmbda, 'radii': radii,
             'mean_var': (fs.mean_var[0] if fs is not None
                          else self.mean_variance_prior_),
             'b_scale': fs.b_scale[0] if fs is not None else self.b_}
        return float(self._logp_at(s, self.Y_fit_, self.device_))

    # ------------------------------------------------------------ forecasts

    @property
    def forecast_probas_map_(self):
        """Plug-in forecast from the selected model (reference
        lpcm.py:230-240)."""
        ws = self.trans_weight_[self.z_[-1]]
        X_ahead = np.zeros((self.Y_fit_.shape[1], self.n_features))
        for g in range(self.n_components):
            X_ahead += ws[:, [g]] * (
                float(self.lambda_[0]) * self.mu_[g]
                + (1 - float(self.lambda_[0])) * self.X_[-1])
        return self._forecast_from(X_ahead, self.intercept_[0])

    @property
    def trans_weights_last_(self):
        return self.trans_weight_

    def delete_traces(self):
        """Free trace storage (reference lpcm.py:858-873)."""
        for name in ('Xs_', 'intercepts_', 'zs_', 'mus_', 'sigmas_',
                     'init_weights_', 'trans_weights_', 'lambdas_', 'logps_'):
            if hasattr(self, name):
                delattr(self, name)
        if self.is_directed and hasattr(self, 'radiis_'):
            del self.radiis_
