"""Dynamic latent space model (Sewell & Chen 2015) on the card
(counterpart of ``dynetlsm_tpu/models/lsm.py``).

The public API is the JAX estimator's: the same constructor keywords,
``.fit(Y)`` and fitted attributes (``X_``, ``intercept_``, ``radii_``,
``Xs_``, ``logps_``, ``probas_``, ``auc_``, ...), plus ``device`` (the
card by default; ``'cpu'`` runs every kernel's plain version) and
``stage_seconds_``, the wall time of each stage of the fit.  With
``n_chains == 1`` trace attributes match the reference layout (``Xs_[i]``
is sample i); with more chains they gain a leading chain axis.  With
``n_control`` the sampler runs the case-control likelihood (the chromatic
scan, no dense network on the device), and the node-scan kernel's limit
on n no longer applies.  ``devices`` and ``node_devices`` lay the sampling
stage on a mesh as in JAX (``models/base.py::resolve_fit_mesh``): the
chains split over devices, and with ``node_devices > 1`` the network's
rows too (``mcmc/nodes.py``); ``mesh_`` and ``state_sharding_`` report
the layout.
"""
import numpy as np
import torch

from ..array_utils import diag_indices_from_3d
from ..config import resolve_device
from ..diagnostics import multichain_effective_n, potential_scale_reduction
from ..entry import _initial_lsm_logp
from ..math.init import (
    directed_intercept_mle, generalized_mds, initialize_radii,
    scale_intercept_mle)
from ..mcmc.sweeps import SweepConfig, _lsm_logp, make_lsm_sweep
from ..metrics import network_auc
from ..ops.distances import pairwise_distances
from ..ops.likelihoods import (
    directed_network_probas, undirected_network_probas)
from ..ops.node_scan import check_smem
from .base import (
    StageTimer, build_case_control, check_supported, controls_of, fit_mesh,
    fit_rng, impute_missing, init_cc_dict, resolve_n_control, sample_chains,
    validate_network, with_init)

__all__ = ['DynamicNetworkLSM']


def _f32(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def network_probas(X, intercept, radii, is_directed):
    """Edge probabilities (T, n, n) float64 of one sample, zero diagonal
    (reference lsm.py:290-308), on the CPU in float32, a time at a time
    (no float32 (T, n, n) temporaries beside the result)."""
    X = _f32(X)
    probas = np.empty((X.shape[0], X.shape[1], X.shape[1]), np.float64)
    for t in range(X.shape[0]):
        dist = pairwise_distances(X[t])
        if is_directed:
            p = directed_network_probas(dist[None], _f32(radii),
                                        float(intercept[0]),
                                        float(intercept[1]))[0]
        else:
            p = undirected_network_probas(dist[None], float(intercept[0]))[0]
        probas[t] = p.numpy()
    probas[diag_indices_from_3d(probas)] = 0.0
    return probas


class DynamicNetworkLSM:
    """Dynamic latent space model with a Gaussian random-walk prior on the
    latent positions (reference lsm.py:100-317 API surface).

    Examples
    --------
    >>> from dynetlsm_tpu_torch import DynamicNetworkLSM
    >>> from dynetlsm_tpu_torch.datasets import load_dynamic_monks
    >>> Y = load_dynamic_monks(is_directed=False)
    >>> model = DynamicNetworkLSM(n_iter=100, tune=50, burn=50,
    ...                           random_state=42, device='cpu').fit(Y)
    >>> model.X_.shape
    (3, 18, 2)
    """

    def __init__(self,
                 n_features=2,
                 is_directed=False,
                 n_iter=5000,
                 tune=2500,
                 tune_interval=100,
                 burn=2500,
                 intercept_prior='auto',
                 intercept_variance_prior=2.0,
                 tau_sq=2.0,
                 sigma_sq=0.1,
                 step_size_X=0.1,
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
        self.tau_sq = tau_sq
        self.sigma_sq = sigma_sq
        self.step_size_X = step_size_X
        self.intercept_prior = intercept_prior
        self.intercept_variance_prior = intercept_variance_prior
        self.step_size_intercept = step_size_intercept
        self.step_size_radii = step_size_radii
        self.tune = tune
        self.tune_interval = tune_interval
        self.burn = burn
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

    # ------------------------------------------------------------------ api

    @property
    def n_burn_(self):
        n_burn = 0
        if self.burn is not None:
            n_burn += self.burn
        if self.tune is not None:
            n_burn += self.tune
        return n_burn

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
                           is_directed=self.is_directed)

    # ------------------------------------------------------------------ fit

    def fit(self, Y):
        """Run the Metropolis-within-Gibbs sampler on a dynamic network Y of
        shape (n_time_steps, n_nodes, n_nodes); missing dyads coded -1."""
        check_supported(self)
        device = resolve_device(self.device)
        rng = fit_rng(self.random_state)

        Y, nan_mask, miss_mask, sample_missing = validate_network(
            Y, self.is_directed, copy=self.copy)
        self.nan_mask_ = nan_mask
        T, n, _ = Y.shape
        # the mesh first: it validates devices / node_devices before any
        # initialisation work (JAX lsm.py:171-178)
        fit_mesh(self, n, device)
        n_control = resolve_n_control(self.n_control, n)
        # the node-scan kernel's shared-memory limit (past n = 2048 at
        # T = 10 its split-field mode; ops/node_scan.py::max_nodes),
        # checked on every device before any initialisation work: the
        # card's first sweep would raise it only after GMDS and the
        # intercept MLE.  The case-control sweep runs no node scan.
        if n_control is None:
            check_smem(T, n, self.n_features, self.is_directed)
        self.Y_fit_ = impute_missing(Y, miss_mask) if sample_missing else Y
        timer = StageTimer(device)

        # ---- initialisation (reference lsm.py:386-417): GMDS on the
        # host, the intercept MLE on the fit's device
        with timer('gmds'):
            X = generalized_mds(self.Y_fit_, n_features=self.n_features,
                                is_directed=self.is_directed,
                                random_state=rng)
        with timer('intercept mle'):
            if self.is_directed:
                radii = initialize_radii(self.Y_fit_)
                b_in, b_out = directed_intercept_mle(self.Y_fit_, X, radii,
                                                    device=device)
                intercept = np.array([b_in, b_out])
            else:
                radii = None
                scale, b = scale_intercept_mle(self.Y_fit_, X,
                                               device=device)
                intercept = np.array([b])
                X = X * np.exp(scale)
        X = X - X.mean(axis=(0, 1))

        tau_sq = self.tau_sq
        if tau_sq == 'auto':
            tau_sq = float(np.mean(X[0] * X[0]))
        self.tau_sq_ = tau_sq

        intercept_prior = self.intercept_prior
        if isinstance(intercept_prior, str) and intercept_prior == 'auto':
            intercept_prior = intercept.copy()
        intercept_prior = np.broadcast_to(
            np.asarray(intercept_prior, dtype=np.float64), intercept.shape)
        self.intercept_prior_ = np.asarray(intercept_prior)

        cfg = SweepConfig(
            is_directed=self.is_directed,
            latent_update=self.latent_update,
            sample_missing=sample_missing,
            tune=int(self.tune or 0),
            tune_interval=self.tune_interval,
            n_burn=self.n_burn_,
            tau_sq=float(tau_sq),
            sigma_sq=float(self.sigma_sq),
            intercept_variance_prior=float(self.intercept_variance_prior),
            tune_radii=False, n_control=n_control,
            n_resample_control=int(self.n_resample_control))
        self._cfg = cfg
        prior32 = intercept_prior.astype(np.float32)
        cc_static, ctrl0 = build_case_control(cfg, self.Y_fit_, rng, device,
                                              miss_mask=miss_mask)

        def make_sweep(node_devices, node_seed):
            return make_lsm_sweep(
                None if sample_missing or cc_static else self.Y_fit_,
                prior32, cfg, device=node_devices[0],
                miss_mask=miss_mask if sample_missing else None,
                cc_static=cc_static, node_devices=node_devices,
                node_seed=node_seed)

        # ---- initial state (the JAX state's fields, lsm.py:259-277)
        s0 = {'it': 0, 'X': X, 'intercept': intercept, 'radii': radii,
              'step_X': np.full((T, n), float(self.step_size_X)),
              'acc_X': np.zeros((T, n)),
              'step_int': np.full(intercept.shape,
                                  float(self.step_size_intercept)),
              'acc_int': np.zeros(intercept.shape)}
        if self.is_directed:
            s0.update(step_radii=float(self.step_size_radii), acc_radii=0.0)
        if sample_missing:
            s0['Y'] = self.Y_fit_
        s0.update(controls_of(ctrl0))
        cc0 = init_cc_dict(cfg, torch.as_tensor(
            self.Y_fit_, dtype=torch.uint8, device=device)
            if sample_missing else None, cc_static, ctrl0)
        logp0 = _initial_lsm_logp(cfg, self.Y_fit_, s0, prior32, device,
                                  cc=cc0)
        s0.update(logp=logp0, logp_map=logp0, X_map=X, intercept_map=intercept,
                  radii_map=radii, logp_ref=logp0, X_ref=X)

        def trace_fn(s):
            out = {'X': s.X, 'intercept': s.intercept, 'logp': s.logp}
            if self.is_directed:
                out['radii'] = s.radii
            return out

        tr, n_total = sample_chains(self, make_sweep, cfg, s0, trace_fn,
                                    rng, device, timer)

        with timer('post-processing'):
            self._store_traces(tr, X, intercept, radii, logp0)

            # ---- MAP estimates from the tracked maxima (lsm.py:547-566)
            fs = self._final_state
            best_chain = int(np.argmax(fs.logp_map))
            self.logp_ = float(fs.logp_map[best_chain])
            self.X_ = np.asarray(fs.X_map[best_chain], dtype=np.float64)
            self.intercept_ = np.asarray(fs.intercept_map[best_chain],
                                         dtype=np.float64)
            if self.is_directed:
                self.radii_ = np.asarray(fs.radii_map[best_chain],
                                         dtype=np.float64)
            if sample_missing:
                denom = max(n_total - 1 - self.n_burn_, 1)
                self.missings_ = np.asarray(
                    fs.missing_sum[best_chain], dtype=np.float64) / denom
        self.case_control_sampler_ = None
        self.stage_seconds_ = timer.seconds
        return self

    def _store_traces(self, tr, X, intercept, radii, logp0):
        """Reference-style traces (sample 0 = the initial draw) from the
        sampler's ``tr`` and, with several chains, the log joint's
        split-R-hat and ESS."""
        c = self.n_chains
        self.Xs_ = with_init(tr, 'X', X, c)
        self.intercepts_ = with_init(tr, 'intercept', intercept, c)
        self.logps_ = with_init(tr, 'logp', float(logp0), c)
        if self.is_directed:
            self.radiis_ = with_init(tr, 'radii', radii, c)

        # ---- multichain convergence diagnostics on the log joint
        if self.n_chains > 1:
            post = self.logps_[:, self.n_burn_:]
            if post.shape[1] > 2:
                self.logp_rhat_ = potential_scale_reduction(post)
                self.logp_effective_n_ = multichain_effective_n(post)

    def logp(self, Y, X, intercept, radii=None, dist=None):
        """Log joint density at the given parameters (reference lsm.py:576),
        on the fit's device in float32."""
        device = resolve_device(self.device)

        def t(x):
            return _f32(x).to(device)
        X = t(X)[None]
        if dist is not None:
            dist = t(dist)[None]
        return float(_lsm_logp(
            self._cfg, t(Y), X, t(intercept).reshape(1, -1),
            None if radii is None else t(radii)[None], dist,
            t(self.intercept_prior_))[0])
