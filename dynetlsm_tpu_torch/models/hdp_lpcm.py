"""Sticky HDP latent position cluster model (Loyal & Chen 2020) on the card
(counterpart of ``dynetlsm_tpu/models/hdp_lpcm.py``, reference
hdp_lpcm.py:144-1330): weak-limit sticky HDP-HMM over community labels
with time-inhomogeneous transitions, CRF auxiliary-variable sampling,
resampled concentration parameters, and VI/BIC/MAP model selection.

The constructor keywords, ``.fit(Y)`` and the fitted attributes are the
JAX estimator's, plus ``device`` (the card by default; ``'cpu'`` runs
every kernel's plain version) and ``stage_seconds_``.
"""
import numpy as np
import torch

from ..label_utils import renormalize_sample
from ..mcmc.sweeps import SweepConfig, hdp_logp_at_state, make_hdp_sweep
from ..model_selection.approx_bic import select_bic
from ..model_selection.posterior_vi import minimize_posterior_expected_vi
from ..ops.forecast import posterior_predictive_forecast
from .base import sample_chains, with_init
from .mixture_base import MixtureModelMixin

__all__ = ['DynamicNetworkHDPLPCM']


class DynamicNetworkHDPLPCM(MixtureModelMixin):
    """Hierarchical Dirichlet process latent position clustering model: a
    sticky HDP-HMM (weak-limit approximation) infers the number of
    communities and their time-varying memberships (reference
    hdp_lpcm.py:144-496 API surface).

    Examples
    --------
    >>> from dynetlsm_tpu_torch import DynamicNetworkHDPLPCM
    >>> from dynetlsm_tpu_torch.datasets import load_dynamic_monks
    >>> Y = load_dynamic_monks(is_directed=False)
    >>> model = DynamicNetworkHDPLPCM(n_components=10, n_iter=100, tune=50,
    ...                               burn=50, random_state=42,
    ...                               device='cpu').fit(Y)
    >>> model.z_.shape
    (3, 18)
    """

    def __init__(self,
                 n_features=2,
                 n_components=10,
                 is_directed=False,
                 selection_type='vi',
                 n_iter=5000,
                 tune=2500,
                 tune_interval=100,
                 burn=2500,
                 thin=None,
                 gamma=1.0,
                 gamma_prior_shape=1.0,
                 gamma_prior_rate=0.1,
                 alpha_init=1.0,
                 alpha_init_shape=1.0,
                 alpha_init_rate=1.0,
                 alpha=1.0,
                 kappa=4.0,
                 alpha_kappa_shape=5,
                 alpha_kappa_rate=0.1,
                 intercept_prior='auto',
                 intercept_variance_prior=2,
                 mean_variance_prior='auto',
                 a=2.0,
                 b='auto',
                 lambda_prior=0.9,
                 lambda_variance_prior=0.01,
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
        self.n_features = n_features
        self.n_components = n_components
        self.step_size_X = step_size_X
        self.intercept_prior = intercept_prior
        self.intercept_variance_prior = intercept_variance_prior
        self.step_size_intercept = step_size_intercept
        self.mean_variance_prior = mean_variance_prior
        self.a = a
        self.b = b
        self.alpha_init = alpha_init
        self.alpha = alpha
        self.alpha_init_shape = alpha_init_shape
        self.alpha_init_rate = alpha_init_rate
        self.gamma = gamma
        self.gamma_prior_shape = gamma_prior_shape
        self.gamma_prior_rate = gamma_prior_rate
        self.kappa = kappa
        self.alpha_kappa_shape = alpha_kappa_shape
        self.alpha_kappa_rate = alpha_kappa_rate
        self.lambda_prior = lambda_prior
        self.lambda_variance_prior = lambda_variance_prior
        self.mean_variance_prior_std = mean_variance_prior_std
        self.sigma_prior_std = sigma_prior_std
        self.step_size_radii = step_size_radii
        self.tune = tune
        self.tune_interval = tune_interval
        self.burn = burn
        self.thin = thin
        self.selection_type = selection_type
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
        lmbda0 = float(self.lambda_prior)

        # initial weights: empirical w0; transitions from the sticky prior
        # (reference hdp_lpcm.py:117-139)
        weights0 = np.zeros((T, K, K))
        resp0 = np.eye(K)[z0[0]]
        weights0[0, 0] = resp0.sum(axis=0) / n
        beta0 = rng.dirichlet(np.repeat(self.gamma / K, K))
        for t in range(1, T):
            for k in range(K):
                weights0[t, k] = rng.dirichlet(
                    self.alpha * beta0 + self.kappa * np.eye(K)[k])

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
            gamma_prior_shape=float(self.gamma_prior_shape),
            gamma_prior_rate=float(self.gamma_prior_rate),
            alpha_init_shape=float(self.alpha_init_shape),
            alpha_init_rate=float(self.alpha_init_rate),
            alpha_kappa_shape=float(self.alpha_kappa_shape),
            alpha_kappa_rate=float(self.alpha_kappa_rate),
            tune_radii=True, n_control=self.n_control_,
            n_resample_control=int(self.n_resample_control))
        self._cfg = cfg
        cc_static, ctrl0, cc0 = self._case_control(cfg, rng, miss_mask)
        stored = None if cfg.sample_missing or cc_static else self.Y_fit_

        def make_sweep(node_devices, node_seed):
            return make_hdp_sweep(
                stored, prior32, cfg, device=node_devices[0],
                miss_mask=miss_mask, cc_static=cc_static,
                node_devices=node_devices, node_seed=node_seed)

        s0 = self._initial_state(
            X0, intercept0, radii0, z0, mu0, sigma0,
            self.Y_fit_ if cfg.sample_missing else None, ctrl0)
        s0.update(weights=weights0, beta=beta0, gamma=float(self.gamma),
                  alpha_init=float(self.alpha_init),
                  alpha=float(self.alpha), kappa=float(self.kappa))
        # true log joint of the initial sample (reference
        # hdp_lpcm.py:798-809), on the device: dense, or the case-control
        # estimator
        logp0 = float(self._logp_at(s0, self.Y_fit_, self.device_, cc0))
        s0['logp'] = logp0

        def trace_fn(s):
            out = {'X': s.X, 'intercept': s.intercept, 'z': s.z, 'mu': s.mu,
                   'sigma': s.sigma, 'lmbda': s.lmbda, 'weights': s.weights,
                   'beta': s.beta, 'logp': s.logp, 'gamma': s.gamma,
                   'alpha': s.alpha, 'kappa': s.kappa,
                   'alpha_init': s.alpha_init}
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
        self.weights_ = with_init(tr, 'weights', weights0, c)
        self.betas_ = with_init(tr, 'beta', beta0, c)
        self.lambdas_ = with_init(tr, 'lmbda', np.asarray(lmbda0), c)
        self.logps_ = with_init(tr, 'logp', np.asarray(logp0), c)
        self.gammas_ = with_init(tr, 'gamma', np.asarray(float(self.gamma)),
                                 c)
        self.alphas_ = with_init(tr, 'alpha', np.asarray(float(self.alpha)),
                                 c)
        self.kappas_ = with_init(tr, 'kappa', np.asarray(float(self.kappa)),
                                 c)
        self.alpha_inits_ = with_init(
            tr, 'alpha_init', np.asarray(float(self.alpha_init)), c)
        if self.is_directed:
            self.radiis_ = with_init(tr, 'radii', radii0, c)

        # ---- model selection (reference hdp_lpcm.py:1085-1138)
        with self._timer('model selection'):
            flat = {name: self._flat_posterior(name + '_') for name in (
                'Xs', 'intercepts', 'mus', 'sigmas', 'betas', 'weights',
                'lambdas', 'zs', 'logps')}
            if self.is_directed:
                flat['radiis'] = self._flat_posterior('radiis_')
            self.bic_, self.models_, self.counts_ = select_bic(
                self.Y_fit_, flat, n_burn=0, is_directed=self.is_directed,
                n_features=self.n_features)

            self._calculate_posterior_cooccurrences()

            if self.selection_type == 'vi':
                best = minimize_posterior_expected_vi(
                    flat['zs'], self.cooccurrence_probas_,
                    tie_break=flat['logps'], n_groups=K, device=self.device_)
                self.logp_ = float(flat['logps'][best])
                self.X_ = flat['Xs'][best]
                self.intercept_ = flat['intercepts'][best]
                self.lambda_ = np.atleast_1d(flat['lambdas'][best])
                if self.is_directed:
                    self.radii_ = flat['radiis'][best]
                z, beta, init_w, trans_w, mu, sigma = self._renormalize_flat(
                    flat, best)
                self.z_ = z
                self.beta_ = beta
                self.init_weights_ = init_w
                self.trans_weights_ = trans_w
                self.mu_ = mu
                self.sigma_ = sigma
                self.selected_id_ = best
            else:
                model_id = self._model_id(self.selection_type)
                self._set_from_model(model_id, flat)

        with self._timer('alignment'):
            self._align_traces()
        with self._timer('post-processing'):
            self._store_posterior_means()
            self._store_group_counts()
            self._store_geweke()
            self._store_missings(cfg, n_total)
        self.case_control_sampler_ = None
        self.stage_seconds_ = self._timer.seconds
        return self

    # ------------------------------------------------------------- helpers

    def _logp_at(self, s, Y, device, cc=None):
        """The dense log joint (hdp_logp_at_state) of one state given as
        a dict of arrays (no chain axis), on ``device``; with the
        case-control structures ``cc``, their estimator (Y unread)."""
        def t(name, dtype=torch.float32):
            return torch.as_tensor(np.asarray(s[name]), dtype=dtype,
                                   device=device)[None]
        radii = t('radii') if s.get('radii') is not None else None
        return hdp_logp_at_state(
            self._cfg, None if cc is not None else torch.as_tensor(
                np.asarray(Y, np.float32), device=device),
            self.intercept_prior_.astype(np.float32), t('X'),
            t('intercept').reshape(1, -1), t('z', torch.int64), t('mu'),
            t('sigma'), t('lmbda'), t('weights'), t('beta'), t('gamma'),
            t('alpha_init'), t('alpha'), t('kappa'), t('mean_var'),
            t('b_scale'), radii=radii, cc=cc)[0]

    @staticmethod
    def _renormalize_flat(flat, sample_id):
        """Active-cluster renormalisation of one flattened posterior sample
        (reference label_utils.py:10-37)."""
        return renormalize_sample(*(flat[name][sample_id] for name in (
            'zs', 'betas', 'weights', 'mus', 'sigmas')))

    def _model_id(self, selection_type):
        """The row of ``bic_`` that ``'bic'`` (least BIC) or ``'map'`` (the
        modal cluster count) selects; sets ``best_k_``."""
        if selection_type == 'bic':
            model_id = int(np.argmin(self.bic_[:, 1]))
            self.best_k_ = int(self.bic_[model_id, 0])
        elif selection_type == 'map':
            self.best_k_ = int(np.argmax(np.bincount(self.counts_)))
            model_id = int(
                np.argwhere(self.bic_[:, 0] == self.best_k_)[0, 0])
        else:
            raise ValueError('Selection type not recognized')
        return model_id

    def _set_from_model(self, model_id, flat):
        """Populate fitted attributes from a per-K MAP model
        (reference hdp_lpcm.py:1113-1138, set_best_model)."""
        T, n, _ = self.Y_fit_.shape
        m = self.models_[model_id]
        self.logp_ = float(flat['logps'][int(self.bic_[model_id, 3])])
        self.X_ = m.X
        self.intercept_ = m.intercept
        self.mu_ = m.mu
        self.sigma_ = m.sigma
        if self.is_directed:
            self.radii_ = m.radii
        _, z = np.unique(np.asarray(m.z).ravel(), return_inverse=True)
        self.z_ = z.reshape(T, n)
        self.beta_ = m.beta
        self.init_weights_ = m.init_weights
        self.trans_weights_ = m.trans_weights
        self.lambda_ = np.atleast_1d(m.lmbda)
        self.selected_id_ = int(self.bic_[model_id, 3])

    def set_best_model(self, selection_type='bic'):
        """Re-select the reported model from the stored BIC table
        (reference hdp_lpcm.py:1282-1313)."""
        self.selection_type = selection_type
        model_id = self._model_id(selection_type)
        self._set_from_model(model_id,
                             {'logps': self._flat_posterior('logps_')})
        return self

    def logp(self, X, intercept, mu, sigma, z, weights, beta, lmbda,
             radii=None):
        """Log joint density of a posterior sample under the fitted
        hyperparameters (reference hdp_lpcm.py:1188-1280), on the fit's
        device in float32, with the exact dense network likelihood and the final
        gamma / alpha / kappa / alpha_init / tau^2 / b values of the fit's
        first chain."""
        fs = getattr(self, '_final_state', None)

        def cur(field, fallback):
            v = getattr(fs, field, None) if fs is not None else None
            return fallback if v is None else v[0]

        s = {'X': X, 'intercept': np.atleast_1d(intercept), 'mu': mu,
             'sigma': sigma, 'z': z, 'weights': weights, 'beta': beta,
             'lmbda': lmbda, 'radii': radii,
             'gamma': cur('gamma', self.gamma),
             'alpha_init': cur('alpha_init', self.alpha_init),
             'alpha': cur('alpha', self.alpha),
             'kappa': cur('kappa', self.kappa),
             'mean_var': cur('mean_var', self.mean_variance_prior_),
             'b_scale': cur('b_scale', self.b_)}
        return float(self._logp_at(s, self.Y_fit_, self.device_))

    # ------------------------------------------------------------ forecasts

    @property
    def forecast_probas_map_(self):
        """Plug-in forecast from the selected model
        (reference hdp_lpcm.py:498-508)."""
        ws = self.trans_weights_[-1][self.z_[-1]]
        X_ahead = np.zeros((self.Y_fit_.shape[1], self.n_features))
        lam = float(np.ravel(self.lambda_)[0])
        for g in np.unique(self.z_[-1]):
            X_ahead += ws[:, [g]] * (lam * self.mu_[g]
                                     + (1 - lam) * self.X_[-1])
        return self._forecast_from(X_ahead, self.intercept_[0])

    def _forecast_samples(self):
        """Each sample's (last labels, last transition matrix, mus,
        sigmas) renormalised over its active clusters (reference
        hdp_lpcm.py:511-553)."""
        flat = {name: self._flat_posterior(name + '_') for name in (
            'zs', 'betas', 'weights', 'mus', 'sigmas')}

        def renorm(i):
            z, _, _, trans_w, mu, sigma = self._renormalize_flat(flat, i)
            return z[-1], trans_w[-1], mu, sigma
        return renorm

    def _marginal_forecast_inputs(self):
        """The HDP-LPCM's arguments of ``ops.forecast.marginal_forecast``
        (reference hdp_lpcm.py:530-553): the raw last-time transition
        matrices, renormalised over each sample's active clusters inside
        the forecast."""
        return (self._forecast_xhat(self._forecast_samples()),
                self._flat_posterior('Xs_')[:, -1],
                self._flat_posterior('zs_')[:, -1],
                self._flat_posterior('weights_')[:, -1],
                self._flat_posterior('mus_'),
                self._flat_posterior('sigmas_'),
                self._flat_posterior('intercepts_')[:, 0],
                np.ravel(self._flat_posterior('lambdas_')), True)

    def _pp_forecast_inputs(self):
        """The trace arguments of
        ``ops.forecast.posterior_predictive_forecast`` (x_last, z_full,
        trans_last, mus, sigmas, intercepts, lmbdas)."""
        return (self._flat_posterior('Xs_')[:, -1],
                self._flat_posterior('zs_'),
                self._flat_posterior('weights_')[:, -1],
                self._flat_posterior('mus_'),
                self._flat_posterior('sigmas_'),
                self._flat_posterior('intercepts_')[:, 0],
                np.ravel(self._flat_posterior('lambdas_')))

    @property
    def forecast_probas_pp_(self):
        """Posterior-predictive one-step forecast (n, n) float64: per
        posterior sample, labels resampled from the active-renormalised
        transition row and positions from the mixture dynamics, the edge
        probabilities averaged (reference hdp_lpcm.py:590-630), on the
        fit's device with draws from a ``torch.Generator`` seeded by
        ``random_state`` (0 unless an int).

        Undirected-only, like the reference (whose implementation
        broadcasts a scalar intercept; the directed pair would not
        broadcast against the distance matrix there either).
        """
        if self.is_directed:
            raise ValueError(
                'forecast_probas_pp_ supports undirected models only (the '
                'reference implementation, hdp_lpcm.py:590-630, has no '
                'directed path either); use forecast_probas_marginalized_ '
                'or forecast_probas(n_samples) instead.')
        seed = (self.random_state
                if isinstance(self.random_state, (int, np.integer)) else 0)
        gen = torch.Generator(device=self.device_).manual_seed(int(seed))
        return posterior_predictive_forecast(
            gen, *self._pp_forecast_inputs(),
            device=self.device_).cpu().numpy()

    def delete_traces(self):
        """Free trace storage (reference hdp_lpcm.py:1315-1330)."""
        for name in ('Xs_', 'intercepts_', 'zs_', 'mus_', 'sigmas_',
                     'weights_', 'betas_', 'lambdas_', 'logps_',
                     'gammas_', 'alphas_', 'kappas_', 'alpha_inits_'):
            if hasattr(self, name):
                delattr(self, name)
        if self.is_directed and hasattr(self, 'radiis_'):
            del self.radiis_
