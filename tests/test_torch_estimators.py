"""Real fits of the port's three estimators on the CPU at small budgets:
shapes and finiteness of the fitted attributes, each estimator's ``logp``
at the fit's final state against that state's logp, tempered fits keeping
their cold slots only, thinning and missing dyads, and the keywords and
networks the port refuses before any initialisation work.

A mixture model's nested LSM initialisation is fixed at 500 + 250 + 250
sweeps; all but one test here cut it through ``init_from_lsm``'s own
``lsm_kwargs``, which the estimators leave at None."""
import numpy as np
import pytest
import torch

from dynetlsm_tpu_torch import (
    DynamicNetworkHDPLPCM, DynamicNetworkLPCM, DynamicNetworkLSM)
from dynetlsm_tpu_torch.datasets import load_dynamic_monks, with_missing_dyads
from dynetlsm_tpu_torch.mcmc.sweeps import (
    hdp_logp_at_state, lpcm_logp_at_state)
from dynetlsm_tpu_torch.models import lsm as lsm_mod, mixture_base
from dynetlsm_tpu_torch.ops.node_scan import max_nodes

CLASSES = [DynamicNetworkLSM, DynamicNetworkLPCM, DynamicNetworkHDPLPCM]
BUDGET = dict(n_iter=30, tune=20, burn=20, random_state=11, device='cpu')


@pytest.fixture
def short_nested_lsm(monkeypatch):
    """The mixture models' nested LSM cut to 20 + 10 + 10 sweeps."""
    init = mixture_base.init_from_lsm

    def short(*args, **kw):
        kw['lsm_kwargs'] = dict(n_iter=20, tune=10, burn=10)
        return init(*args, **kw)
    monkeypatch.setattr(mixture_base, 'init_from_lsm', short)


def _dense_args(fs, fields):
    """The final state's fields as CPU tensors, labels as int64."""
    return [torch.as_tensor(getattr(fs, f)).to(
        torch.int64 if f == 'z' else torch.float32) for f in fields]


def _check_forecast(probas, n, diagonal=None):
    """A one-step-ahead forecast: (n, n) float64 probabilities, finite,
    in [0, 1], its diagonal ``diagonal`` where given."""
    assert probas.shape == (n, n) and probas.dtype == np.float64
    assert np.isfinite(probas).all()
    assert ((probas >= 0) & (probas <= 1)).all()
    if diagonal is not None:
        assert (np.diag(probas) == diagonal).all()


def _first_chain(model):
    return {k: (None if v is None else v[0])
            for k, v in vars(model._final_state).items()}


@pytest.mark.parametrize('directed', [False, True])
def test_lsm_fit(directed):
    Y = load_dynamic_monks(is_directed=directed)
    T, n, _ = Y.shape
    m = DynamicNetworkLSM(is_directed=directed, n_chains=2, **BUDGET).fit(Y)
    assert m.Xs_.shape == (2, 70, T, n, 2)
    assert m.intercepts_.shape == (2, 70, 2 if directed else 1)
    assert m.logps_.shape == (2, 70) and np.isfinite(m.logps_).all()
    assert m.X_.shape == (T, n, 2) and np.isfinite(m.X_).all()
    assert m.probas_.shape == Y.shape and 0.5 < m.auc_ <= 1.0
    assert m.distances_.shape == Y.shape
    assert np.isfinite(m.logp_rhat_) and m.logp_effective_n_ > 0
    if directed:
        assert m.radiis_.shape == (2, 70, n)
        np.testing.assert_allclose(m.radii_.sum(), 1.0, rtol=1e-5)
    assert set(m.stage_seconds_) == {'gmds', 'intercept mle', 'sampling',
                                     'post-processing'}
    # the estimator's log joint at the final state is that state's logp
    s = _first_chain(m)
    lp = m.logp(m.Y_fit_, s['X'], s['intercept'], radii=s.get('radii'))
    np.testing.assert_allclose(lp, s['logp'], rtol=1e-4)
    # the MAP attributes are the best chain's tracked maximum
    assert m.logp_ == pytest.approx(m._final_state.logp_map.max())


def test_hdp_fit_end_to_end():
    """One fit through the whole path, nested LSM at its fixed budget."""
    Y = load_dynamic_monks()
    T, n, _ = Y.shape
    m = DynamicNetworkHDPLPCM(n_components=5, n_chains=2, **BUDGET).fit(Y)
    K = 5
    assert m.Xs_.shape == (2, 70, T, n, 2)
    assert m.zs_.shape == (2, 70, T, n) and m.zs_.max() < K
    assert m.weights_.shape == (2, 70, T, K, K)
    assert m.betas_.shape == (2, 70, K)
    for name in ('logps_', 'lambdas_', 'gammas_', 'alphas_', 'kappas_',
                 'alpha_inits_'):
        assert getattr(m, name).shape == (2, 70), name
        assert np.isfinite(getattr(m, name)).all(), name
    assert m.z_.shape == (T, n) and m.X_.shape == (T, n, 2)
    k = m.mu_.shape[0]
    assert m.trans_weights_.shape == (T, k, k) and m.z_.max() < k
    assert m.counts_.shape == (2 * 30,) and m.counts_.min() >= 1
    assert m.bic_.shape[1] == 4 and len(m.models_) == m.bic_.shape[0]
    assert m.cooccurrence_probas_.shape == (T, n, n)
    assert len(m.posterior_group_counts_) == T
    assert np.isfinite(m.logp_geweke_[0]) and np.isfinite(m.logp_rhat_)
    assert m.X_mean_.shape == (T, n, 2) and 0.5 < m.auc_ <= 1.0
    assert {'nested lsm fit', 'kmeans', 'sampling', 'model selection',
            'alignment', 'post-processing'} <= set(m.stage_seconds_)
    # the estimator's log joint at the final state is that state's logp
    s = _first_chain(m)
    lp = m.logp(s['X'], s['intercept'], s['mu'], s['sigma'], s['z'],
                s['weights'], s['beta'], s['lmbda'])
    np.testing.assert_allclose(lp, s['logp'], rtol=1e-4)
    fs = m._final_state
    dense = hdp_logp_at_state(
        m._cfg, torch.as_tensor(m.Y_fit_, dtype=torch.float32),
        m.intercept_prior_.astype(np.float32),
        *_dense_args(fs, (
            'X', 'intercept', 'z', 'mu', 'sigma', 'lmbda', 'weights', 'beta',
            'gamma', 'alpha_init', 'alpha', 'kappa', 'mean_var', 'b_scale')))
    np.testing.assert_allclose(dense.numpy(), fs.logp, rtol=1e-4)
    # forecasts from the selected model
    assert m.forecast_probas_map_.shape == (n, n)
    assert m.forecast_probas_plugin_.shape == (n, n)
    assert m.forecast_probas(n_samples=3).shape == (n, n)
    _check_forecast(m.forecast_probas_marginalized_, n, diagonal=0.0)
    _check_forecast(m.forecast_probas_pp_, n)
    # the reference's refusal of a directed posterior-predictive forecast
    with pytest.raises(ValueError, match='undirected models only'):
        DynamicNetworkHDPLPCM(is_directed=True,
                              device='cpu').forecast_probas_pp_
    m.set_best_model('map')
    assert m.best_k_ == np.argmax(np.bincount(m.counts_))
    m.delete_traces()
    assert not hasattr(m, 'Xs_') and not hasattr(m, 'zs_')


@pytest.mark.parametrize('directed', [False, True])
def test_lpcm_fit(short_nested_lsm, directed):
    Y = load_dynamic_monks(is_directed=directed)
    T, n, _ = Y.shape
    m = DynamicNetworkLPCM(n_components=3, is_directed=directed,
                           **BUDGET).fit(Y)
    assert m.Xs_.shape == (70, T, n, 2) and m.zs_.shape == (70, T, n)
    assert m.init_weights_.shape == (70, 3)
    assert m.trans_weights_.shape == (70, 3, 3)
    assert np.isfinite(m.logps_).all() and 0.5 < m.auc_ <= 1.0
    assert m.trans_weight_.shape == (3, 3)
    s = _first_chain(m)
    lp = m.logp(s['X'], s['intercept'], s['mu'], s['sigma'], s['z'],
                s['init_weights'], s['trans_weights'], s['lmbda'],
                radii=s.get('radii'))
    np.testing.assert_allclose(lp, s['logp'], rtol=1e-4)
    fs = m._final_state
    dense = lpcm_logp_at_state(
        m._cfg, torch.as_tensor(m.Y_fit_, dtype=torch.float32),
        m.intercept_prior_.astype(np.float32),
        *_dense_args(fs, (
            'X', 'intercept', 'z', 'mu', 'sigma', 'lmbda', 'init_weights',
            'trans_weights', 'mean_var', 'b_scale')),
        radii=(torch.as_tensor(fs.radii) if directed else None))
    np.testing.assert_allclose(dense.numpy(), fs.logp, rtol=1e-4)
    if not directed:
        assert m.forecast_probas_map_.shape == (n, n)
        assert m.forecast_probas_plugin_.shape == (n, n)
    _check_forecast(m.forecast_probas_marginalized_, n, diagonal=0.0)


def test_tempered_fits_keep_cold_slots(short_nested_lsm):
    Y = load_dynamic_monks()
    m = DynamicNetworkLSM(n_chains=2, n_temps=3, beta_min=0.2,
                          tune_interval=20, **BUDGET).fit(Y)
    assert m.Xs_.shape[0] == 2 and m.logps_.shape == (2, 70)
    assert np.isfinite(m.logps_).all() and m.auc_ > 0.5
    assert m._final_state.X.shape[0] == 2
    ladder = m.temper_ladder_.reshape(2, 3)
    np.testing.assert_allclose(ladder[:, 0], 1.0)
    np.testing.assert_allclose(ladder[:, -1], 0.2, rtol=1e-5)
    assert np.all(np.diff(ladder, axis=1) < 0)

    h = DynamicNetworkHDPLPCM(n_components=4, n_temps=2, beta_min=0.3,
                              **BUDGET).fit(Y)
    assert h.Xs_.shape == (70,) + Y.shape[:2] + (2,)
    assert h._final_state.X.shape[0] == 1 and h.temper_ladder_.shape == (2,)
    assert np.isfinite(h.logps_).all()


@pytest.mark.parametrize('cls', [DynamicNetworkLPCM, DynamicNetworkHDPLPCM])
def test_thinned_fit(short_nested_lsm, cls):
    Y = load_dynamic_monks()
    m = cls(n_components=3, thin=2, n_chains=2, **BUDGET).fit(Y)
    n_total = 70
    assert m.Xs_.shape[:2] == (2, (n_total - 1) // 2 + 1)
    assert m.n_burn_ == 20 and np.isfinite(m.logps_).all()


@pytest.mark.parametrize('cls', CLASSES)
def test_missing_dyads_fit(short_nested_lsm, cls):
    Y = load_dynamic_monks()
    coded = with_missing_dyads(Y, 0.1, seed=2)
    kw = {} if cls is DynamicNetworkLSM else dict(n_components=3)
    m = cls(**kw, **BUDGET).fit(coded)
    observed = coded != -1
    np.testing.assert_array_equal(m.Y_fit_[observed], Y[observed])
    assert np.isin(m.Y_fit_, (0.0, 1.0)).all()
    assert m.missings_.shape == Y.shape
    assert np.all((m.missings_ >= 0) & (m.missings_ <= 1))
    assert not m.missings_[observed].any()
    assert np.isfinite(m.logps_).all()


UNSUPPORTED = [('devices', ['cuda:0']), ('node_devices', 2)]


@pytest.mark.parametrize('cls', CLASSES)
@pytest.mark.parametrize('name, value', UNSUPPORTED)
def test_unsupported_keywords_raise(cls, name, value):
    with pytest.raises(NotImplementedError, match='ROADMAP.md §1 item'):
        cls(**{name: value}, device='cpu').fit(load_dynamic_monks())


@pytest.mark.parametrize('cls', CLASSES)
def test_unknown_latent_update_raises(monkeypatch, cls):
    """JAX's ValueError for a scheme other than 'exact', 'parallel' and
    'mala', before any initialisation work."""
    def no_init(*args, **kw):
        raise AssertionError('initialisation ran')
    monkeypatch.setattr(lsm_mod, 'generalized_mds', no_init)
    monkeypatch.setattr(mixture_base, 'init_from_lsm', no_init)
    with pytest.raises(ValueError, match="latent_update must be 'exact', "
                       "'parallel', or 'mala', got 'gibbs'"):
        cls(latent_update='gibbs', device='cpu').fit(load_dynamic_monks())


@pytest.mark.parametrize('cls', CLASSES)
def test_fit_runs_on_the_card_by_default(cls):
    assert cls().device == 'cuda'
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(n_iter=2, tune=0, burn=0).fit(load_dynamic_monks())


@pytest.mark.parametrize('cls', CLASSES)
def test_large_network_reaches_initialisation(monkeypatch, cls):
    """n = 2049 at T = 10, past the resident node scan's shared memory,
    runs in the split-field mode: the fit passes the size check and
    reaches GMDS or the nested LSM (monkeypatched to raise).  A field past
    every launch (n = max_nodes + 1 at T = 400) still raises before any
    initialisation, naming the limit and case-control."""
    def no_init(*args, **kw):
        raise AssertionError('initialisation ran')
    monkeypatch.setattr(lsm_mod, 'generalized_mds', no_init)
    monkeypatch.setattr(mixture_base, 'init_from_lsm', no_init)
    Y = np.zeros((10, 2049, 2049), np.uint8)
    with pytest.raises(AssertionError, match='initialisation ran'):
        cls(device='cpu').fit(Y)
    limit = max_nodes(400, 2)
    assert 32 <= limit < 256
    Y = np.zeros((400, limit + 1, limit + 1), np.uint8)
    with pytest.raises(ValueError, match='at most n = %d.*case-control'
                       % limit):
        cls(device='cpu').fit(Y)


@pytest.mark.parametrize('kind', ['undirected', 'directed', 'missing'])
@pytest.mark.parametrize('cls', CLASSES)
def test_n_control_fits(monkeypatch, short_nested_lsm, cls, kind):
    """Case-control fits (JAX tests/test_case_control.py:236, :250, :290):
    finite traces, missing dyads resampled, and the initial sample's logp
    from the case-control estimator of the fit's own structures."""
    from dynetlsm_tpu_torch.entry import _initial_lsm_logp
    from dynetlsm_tpu_torch.models import base
    seen = {}

    def spy(fn, name):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            seen.setdefault(name, []).append((args, kw, out))
            return out
        return wrapped
    for mod in (lsm_mod, mixture_base):
        monkeypatch.setattr(mod, 'init_cc_dict',
                            spy(base.init_cc_dict, 'cc0'))
    monkeypatch.setattr(lsm_mod, '_initial_lsm_logp',
                        spy(_initial_lsm_logp, 'lsm logp0'))
    directed = kind == 'directed'
    Y = load_dynamic_monks(is_directed=directed)
    if kind == 'missing':
        Y = with_missing_dyads(Y, 0.1, seed=2)
    kw = {} if cls is DynamicNetworkLSM else dict(n_components=3)
    m = cls(**kw, **BUDGET, is_directed=directed, n_control=8,
            n_resample_control=10).fit(Y)
    assert np.isfinite(m.logps_).all() and m.logps_.shape == (70,)
    assert m.X_.shape == (3, 18, 2) and np.isfinite(m.X_).all()
    assert 0.5 < m.auc_ <= 1.0
    # the fit's own structures (the last call: a mixture's nested LSM
    # makes one too, when directed)
    cc0 = seen['cc0'][-1][2]
    assert cc0 is not None and cc0['ctrl_out'].shape == (18, 8)
    if cls is DynamicNetworkLSM:
        args, kw_, logp0 = seen['lsm logp0'][-1]
        assert kw_['cc'] is cc0 and m.logps_[0] == np.float32(logp0)
    else:
        s0 = _first_sample(m)
        np.testing.assert_allclose(
            m.logps_[0], float(m._logp_at(s0, m.Y_fit_, 'cpu', cc0)),
            rtol=1e-5)
        assert m.logps_[0] != float(m._logp_at(s0, m.Y_fit_, 'cpu'))
    if kind == 'missing':
        assert m.missings_.shape == Y.shape
        assert np.all((m.missings_ >= 0) & (m.missings_ <= 1))


def _first_sample(m):
    """A mixture fit's initial sample as ``_logp_at`` takes it (the
    traces' sample 0; the alignment's rotation leaves the log joint)."""
    s = {'X': m.Xs_[0], 'intercept': m.intercepts_[0], 'z': m.zs_[0],
         'mu': m.mus_[0], 'sigma': m.sigmas_[0], 'lmbda': m.lambdas_[0],
         'mean_var': m.mean_variance_prior_, 'b_scale': m.b_,
         'radii': m.radiis_[0] if m.is_directed else None}
    if hasattr(m, 'weights_'):
        s.update(weights=m.weights_[0], beta=m.betas_[0],
                 gamma=m.gamma, alpha_init=m.alpha_init, alpha=m.alpha,
                 kappa=m.kappa)
    else:
        s.update(init_weights=m.init_weights_[0],
                 trans_weights=m.trans_weights_[0])
    return s


@pytest.mark.parametrize('cls', CLASSES)
def test_n_control_passes_the_smem_check(monkeypatch, cls):
    """With n_control the node-scan kernel's limit does not apply: at n =
    2049 the fit reaches initialisation (the monkeypatched initialisers
    raise) instead of the node_scan_cuda refusal."""
    def no_init(*args, **kw):
        raise AssertionError('initialisation ran')
    monkeypatch.setattr(lsm_mod, 'generalized_mds', no_init)
    monkeypatch.setattr(mixture_base, 'init_from_lsm', no_init)
    Y = np.zeros((10, 2049, 2049), np.uint8)
    with pytest.raises(AssertionError, match='initialisation ran'):
        cls(device='cpu', n_control=64).fit(Y)


def test_import_needs_no_jax_sklearn_or_build():
    """Importing the estimators imports neither jax nor scikit-learn (the
    card's machine has neither) and builds no CUDA kernel."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['sklearn'] = None; "
            "import dynetlsm_tpu_torch as p; "
            "from dynetlsm_tpu_torch.ops import cuda_lib; "
            "p.DynamicNetworkHDPLPCM(device='cpu'); "
            "assert cuda_lib.library.cache_info().misses == 0; "
            "assert 'dynetlsm_tpu' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == 'ok', out.stderr
