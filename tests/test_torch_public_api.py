"""The port's copy of the JAX package's public surface: every name the
JAX subpackages export (``ops``, ``math``, ``mcmc``, ``datasets``,
``model_selection``) and every name ``tests/test_reference_compat.py``
imports exists in the matching ``dynetlsm_tpu_torch`` module, and each
function added for it agrees with its JAX counterpart on the same
numpy-seeded inputs:

* deterministic functions at rtol 1e-5 (float32), the NumPy host helpers
  at 1e-12 against the reference formulas (and at JAX's own 1e-4 against
  its float32 autodiff);
* samplers by the moment, frequency and KS checks of JAX's tests at their
  thresholds; the label sampler on JAX's Gumbel noise replayed, exactly.
"""
import ast
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import stats
from scipy.special import expit

import jax
import jax.numpy as jnp

import dynetlsm_tpu.datasets as jd
from dynetlsm_tpu.math import distributions as jdist
from dynetlsm_tpu.math import init as jinit
from dynetlsm_tpu.math import procrustes as jproc
from dynetlsm_tpu.mcmc import labels as jlabels
from dynetlsm_tpu.ops import distances as jdistances
from dynetlsm_tpu.ops import emissions as jem
from dynetlsm_tpu.ops import likelihoods as jlik

import dynetlsm_tpu_torch.datasets as pdat
from dynetlsm_tpu_torch.math import distributions as pdist
from dynetlsm_tpu_torch.math import init as pinit
from dynetlsm_tpu_torch.math import procrustes as pproc
from dynetlsm_tpu_torch.mcmc import labels as plabels
from dynetlsm_tpu_torch.mcmc import metropolis as pmet
from dynetlsm_tpu_torch.ops import distances as pdistances
from dynetlsm_tpu_torch.ops import emissions as pem
from dynetlsm_tpu_torch.ops import likelihoods as plik

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ('ops', 'math', 'mcmc', 'datasets', 'model_selection')


def jax_exports(sub):
    """The names ``dynetlsm_tpu/<sub>/__init__.py`` imports (a star
    import's module ``__all__``)."""
    path = os.path.join(ROOT, 'dynetlsm_tpu', sub, '__init__.py')
    names = []
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == '*':
                    names += importlib.import_module(
                        'dynetlsm_tpu.%s.%s' % (sub, node.module)).__all__
                else:
                    names.append(a.asname or a.name)
    return names


def compat_imports():
    """(module, name) of every ``from dynetlsm_tpu... import name`` in
    tests/test_reference_compat.py."""
    path = os.path.join(ROOT, 'tests', 'test_reference_compat.py')
    return [(node.module, a.name)
            for node in ast.walk(ast.parse(open(path).read()))
            if isinstance(node, ast.ImportFrom) and node.module
            and node.module.startswith('dynetlsm_tpu')
            for a in node.names]


@pytest.mark.parametrize('sub', SUBPACKAGES)
def test_port_has_every_jax_export(sub):
    names = jax_exports(sub)
    assert names
    port = importlib.import_module('dynetlsm_tpu_torch.' + sub)
    assert [n for n in names if not hasattr(port, n)] == []


def test_port_has_every_reference_compat_name():
    pairs = compat_imports()
    assert len(pairs) > 20
    missing = ['%s.%s' % (m, n) for m, n in pairs
               if not hasattr(importlib.import_module(m.replace(
                   'dynetlsm_tpu', 'dynetlsm_tpu_torch', 1)), n)]
    assert missing == []


def test_subpackage_imports_build_nothing_and_need_no_extras():
    code = ('import sys\n'
            'sys.modules["jax"] = None\n'
            'import dynetlsm_tpu_torch.ops, dynetlsm_tpu_torch.math\n'
            'import dynetlsm_tpu_torch.mcmc, dynetlsm_tpu_torch.datasets\n'
            'import dynetlsm_tpu_torch.model_selection\n'
            'from dynetlsm_tpu_torch.ops import cuda_lib\n'
            "assert cuda_lib.library.cache_info().currsize == 0\n"
            'bad = [m for m in ("matplotlib", "pandas", "sklearn",\n'
            '                   "networkx", "dynetlsm_tpu")\n'
            '       if m in sys.modules]\n'
            'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], check=True, cwd=ROOT)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _net(rng, T=3, n=10, directed=False):
    Y = (rng.uniform(size=(T, n, n)) < 0.35).astype(np.float32)
    if not directed:
        Y = np.triu(Y, 1)
        Y = Y + Y.transpose(0, 2, 1)
    for t in range(T):
        np.fill_diagonal(Y[t], 0)
    return Y


def test_distances_to_point_matches_jax():
    rng = np.random.RandomState(0)
    X, x = rng.randn(3, 9, 2).astype(np.float32), rng.randn(3, 2).astype(
        np.float32)
    for sq in (False, True):
        _close(pdistances.distances_to_point(torch.as_tensor(X),
                                             torch.as_tensor(x), squared=sq),
               jdistances.distances_to_point(jnp.asarray(X), jnp.asarray(x),
                                             squared=sq))


@pytest.mark.parametrize('directed', [False, True])
def test_likelihood_exports_match_jax(directed):
    rng = np.random.RandomState(1 + directed)
    Y = _net(rng, directed=directed)
    X = rng.randn(3, 10, 2).astype(np.float32)
    radii = rng.uniform(0.5, 1.0, 10).astype(np.float32)
    tY, tX, tr = map(torch.as_tensor, (Y, X, radii))
    jY, jX, jr = map(jnp.asarray, (Y, X, radii))
    dist, jdist_ = pdistances.pairwise_distances(tX), \
        jdistances.pairwise_distances(jX)
    if directed:
        _close(torch.stack(plik.directed_loglik_pair(
                   tY, dist, tr, (0.3, -0.2), (0.5, 0.1))),
               jnp.stack(jlik.directed_loglik_pair(
                   jY, jdist_, jr, (0.3, -0.2), (0.5, 0.1))))
        _close(plik.directed_intercept_grad(tY, dist, tr, 0.3, -0.2),
               jlik.directed_intercept_grad(jY, jdist_, jr, 0.3, -0.2),
               rtol=1e-4, atol=1e-4)
        j = 4
        _close(plik.directed_partial_loglik(
                   tY[:, j], tY[:, :, j], tX, tX[:, j] + 0.1, tr,
                   tr[j].expand(3), 0.3, -0.2),
               jlik.directed_partial_loglik(
                   jY[:, j], jY[:, :, j], jX, jX[:, j] + 0.1, jr,
                   jnp.broadcast_to(jr[j], (3,)), 0.3, -0.2))
        b = np.asarray([0.3, -0.2], np.float32)
        _close(plik.dynamic_network_loglikelihood(tY, tX, torch.as_tensor(b),
                                                  radii=tr),
               jlik.dynamic_network_loglikelihood(jY, jX, jnp.asarray(b),
                                                  radii=jr))
        _close(plik.dynamic_network_loglikelihood(tY, tX, b, radii=tr),
               plik.dynamic_network_loglikelihood_directed(tY, tX, 0.3, -0.2,
                                                           tr))
    else:
        _close(torch.stack(plik.undirected_loglik_pair(tY, dist, 0.3, -0.4)),
               jnp.stack(jlik.undirected_loglik_pair(jY, jdist_, 0.3, -0.4)))
        _close(plik.undirected_partial_loglik(tY[:, 2], tX, tX[:, 2] + 0.1,
                                              0.3),
               jlik.undirected_partial_loglik(jY[:, 2], jX, jX[:, 2] + 0.1,
                                              0.3))
        for sq in (False, True):
            _close(plik.dynamic_network_loglikelihood(tY, tX, 0.3,
                                                      squared=sq),
                   jlik.dynamic_network_loglikelihood(jY, jX, 0.3,
                                                      squared=sq))
        _close(plik.dynamic_network_loglikelihood_undirected(tY, None, 0.3,
                                                             dist=dist),
               jlik.dynamic_network_loglikelihood_undirected(jY, None, 0.3,
                                                             dist=jdist_))


def test_emission_exports_match_jax():
    rng = np.random.RandomState(3)
    X = rng.randn(4, 7, 2).astype(np.float32)
    mu = rng.randn(3, 2).astype(np.float32)
    sigma = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    args_t = (torch.as_tensor(X), torch.as_tensor(mu), torch.as_tensor(sigma),
              0.8)
    args_j = (jnp.asarray(X), jnp.asarray(mu), jnp.asarray(sigma), 0.8)
    got = pem.emission_logliks(*args_t)
    assert got.shape == (4, 7, 3)
    _close(got, jem.emission_logliks(*args_j), atol=1e-5)
    for norm in (True, False):
        _close(pem.emission_likelihoods(*args_t, normalize=norm),
               jem.emission_likelihoods(*args_j, normalize=norm))
    _close(pem.spherical_normal_logpdf(args_t[0], args_t[1][0], 0.7),
           jem.spherical_normal_logpdf(args_j[0], args_j[1][0], 0.7))


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

def test_densities_match_jax_and_scipy():
    rng = np.random.RandomState(0)
    x, mean = rng.randn(5, 3, 2), rng.randn(2)
    for fn in ('spherical_normal_log_pdf', 'spherical_normal_pdf'):
        _close(getattr(pdist, fn)(torch.as_tensor(x, dtype=torch.float32),
                                  torch.as_tensor(mean), 0.7),
               getattr(jdist, fn)(jnp.asarray(x), jnp.asarray(mean), 0.7))
    x1 = rng.randn(2)
    want = stats.multivariate_normal.logpdf(x1, mean, 0.7 * np.eye(2))
    assert np.isclose(float(pdist.spherical_normal_log_pdf(
        torch.as_tensor(x1, dtype=torch.float32), torch.as_tensor(mean),
        0.7)), want, rtol=1e-5)
    S = np.asarray([[2.0, 0.3], [0.3, 1.0]])
    for scale in (1.7, S):
        for fn in ('multivariate_t_logpdf', 'multivariate_t_pdf'):
            _close(getattr(pdist, fn)(torch.as_tensor(x1, dtype=torch.float32),
                                      4.0, torch.as_tensor(mean), scale),
                   getattr(jdist, fn)(jnp.asarray(x1), 4.0, jnp.asarray(mean),
                                      scale))
    want = stats.multivariate_t.logpdf(x1, mean, S, df=4.0)
    assert np.isclose(float(pdist.multivariate_t_log_pdf(
        torch.as_tensor(x1), 4.0, torch.as_tensor(mean), S)), want,
        rtol=1e-10)


def test_truncated_normal_moments_and_strict_bounds():
    """tests/test_distributions.py's two checks, at its thresholds."""
    gen = torch.Generator().manual_seed(1)
    mean, var = 0.85, 0.01
    d = pdist.truncated_normal(gen, torch.full((8000,), mean),
                               torch.tensor(var)).numpy()
    assert np.all((d > 0) & (d < 1))
    a, b = (0 - mean) / np.sqrt(var), (1 - mean) / np.sqrt(var)
    want = stats.truncnorm.mean(a, b, loc=mean, scale=np.sqrt(var))
    np.testing.assert_allclose(d.mean(), want, atol=5e-3)
    for i, (mean, var) in enumerate([(5.0, 1e-4), (-3.0, 1e-6),
                                     (0.99999, 1e-8), (1.5, 4.0)]):
        gen = torch.Generator().manual_seed(i)
        draws = pdist.truncated_normal(gen, torch.full((4096,), mean),
                                       torch.full((4096,), var))
        assert ((draws > 0.0) & (draws < 1.0)).all(), (mean, var)
        lp = pdist.truncated_normal_logpdf(draws, mean, var)
        assert torch.isfinite(lp).all(), (mean, var)


def test_inv_gamma_and_categorical_samplers():
    gen = torch.Generator().manual_seed(2)
    shape, rate = 5.0, 2.0
    draws = pdist.sample_inv_gamma(gen, torch.full((8000,), shape),
                                   torch.tensor(rate))
    np.testing.assert_allclose(draws.mean().item(), rate / (shape - 1),
                               rtol=0.05)
    d = pdist.sample_inv_gamma(gen, 30.0, 2.0)
    assert d.shape == () and d.device == gen.device
    _, p = stats.kstest(pdist.sample_inv_gamma(
        gen, torch.full((20000,), 3.0), 2.0).numpy().astype(np.float64),
        stats.invgamma(3.0, scale=2.0).cdf)
    assert p > 1e-3
    probas = torch.as_tensor(np.tile([0.1, 0.7, 0.2], (8000, 1)))
    z = pdist.sample_categorical(gen, probas).numpy()
    assert np.allclose(np.bincount(z, minlength=3) / 8000, [0.1, 0.7, 0.2],
                       atol=0.03)
    logits = torch.log(torch.tensor([[0.5, 0.25, 0.25]] * 8000)).T
    z = pdist.sample_categorical_logits(gen, logits, axis=0).numpy()
    assert np.allclose(np.bincount(z, minlength=3) / 8000,
                       [0.5, 0.25, 0.25], atol=0.03)


def test_procrustes_reference_names():
    rng = np.random.RandomState(0)
    assert pproc.compute_procrustes_rotation is pproc.procrustes_rotation
    X = rng.randn(3, 5, 2).astype(np.float32)
    assert pproc.flatten_array(torch.as_tensor(X)).shape == (15, 2)
    Xr, Xm = rng.randn(5, 2).astype(np.float32), X[0]
    got, R = pproc.static_procrustes_rotation(torch.as_tensor(Xr),
                                              torch.as_tensor(Xm))
    want, Rj = jproc.static_procrustes_rotation(jnp.asarray(Xr),
                                                jnp.asarray(Xm))
    _close(got, want, atol=1e-5)
    _close(R, Rj, atol=1e-5)
    Xs = rng.randn(4, 3, 6, 2).astype(np.float32)
    means = rng.randn(4, 2, 2).astype(np.float32)
    got, gm = pproc.longitudinal_procrustes_transform(torch.as_tensor(Xs),
                                                      torch.as_tensor(means))
    want, wm = jproc.longitudinal_procrustes_transform(jnp.asarray(Xs),
                                                       jnp.asarray(means))
    _close(got, want, atol=1e-5)
    _close(gm, wm, atol=1e-5)
    assert pproc.longitudinal_procrustes_transform(
        torch.as_tensor(Xs))[1] is None


def test_host_gradient_helpers():
    """tests/test_reference_compat.py's check: the reference formulas in
    float64 at 1e-12, and JAX's float32 autodiff values at its 1e-4."""
    rng = np.random.RandomState(3)
    X = rng.randn(3, 10, 2)
    Y = np.zeros((3, 10, 10))
    for t in range(3):
        upper = np.triu(rng.uniform(size=(10, 10)) < 0.3, k=1)
        Y[t] = upper + upper.T
    dist = pinit.calculate_distances(X)
    assert dist.shape == (3, 10, 10)
    assert pinit.calculate_distances(X[0]).shape == (10, 10)
    _close(dist, jinit.calculate_distances(X), rtol=1e-5, atol=1e-6)
    _close(pinit.calculate_distances(X, squared=True),
           np.sum((X[:, :, None] - X[:, None]) ** 2, -1), rtol=1e-12,
           atol=0)
    g_ref = Y - expit(0.4 - dist)
    want_b = 0.5 * (np.sum(g_ref) - np.einsum('ikk', g_ref).sum())
    got_b = pinit.undirected_intercept_grad(Y, X, 0.4)
    assert np.isclose(got_b, want_b, rtol=1e-12, atol=0)
    assert np.isclose(got_b, jinit.undirected_intercept_grad(Y, X, 0.4),
                      rtol=1e-4)
    sd = np.exp(0.2) * dist
    g_ref = -sd * (Y - expit(0.4 - sd))
    want_s = np.sum(g_ref) - np.einsum('ikk', g_ref).sum()
    got_s = pinit.scale_grad(Y, X, 0.4, 0.2)
    assert np.isclose(got_s, want_s, rtol=1e-12, atol=0)
    assert np.isclose(got_s, jinit.scale_grad(Y, X, 0.4, 0.2), rtol=1e-4)


# ---------------------------------------------------------------------------
# mcmc
# ---------------------------------------------------------------------------

def test_log_normalize():
    logits = torch.tensor([[0.0, 1.0, 2.0], [-1.0, -1.0, -1.0]])
    p = plabels.log_normalize(logits).numpy()
    _close(p, jlabels.log_normalize(jnp.asarray(logits.numpy())))
    assert np.allclose(p.sum(axis=-1), 1.0, atol=1e-6)
    assert np.allclose(p[1], 1.0 / 3.0, atol=1e-6)


def test_sample_labels_gibbs_matches_jax_on_its_gumbel_noise():
    rng = np.random.RandomState(5)
    T, n, K = 4, 30, 3
    X = rng.randn(T, n, 2).astype(np.float32)
    mu = 1.5 * rng.randn(K, 2).astype(np.float32)
    sigma = rng.uniform(0.5, 1.5, K).astype(np.float32)
    w0 = rng.dirichlet(np.ones(K)).astype(np.float32)
    w = rng.dirichlet(np.ones(K) + 4 * np.eye(K)[0], size=K).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    want = jlabels.sample_labels_gibbs(key, jnp.asarray(X), jnp.asarray(mu),
                                       jnp.asarray(sigma), 0.8,
                                       jnp.asarray(w0), jnp.asarray(w))
    keys = jax.random.split(key, T)
    g = np.stack([np.asarray(jax.random.gumbel(keys[t], (n, K),
                                               jnp.float32))
                  for t in range(T)])
    t32 = lambda a: torch.as_tensor(a)[None]  # noqa: E731
    z = plabels.labels_gibbs_from_gumbel(
        t32(X), t32(mu), t32(sigma), torch.tensor([0.8]), t32(w0), t32(w),
        t32(g))
    np.testing.assert_array_equal(z[0].numpy(), np.asarray(want[0]))
    got = plabels.sample_labels_gibbs(
        torch.Generator().manual_seed(0), t32(X), t32(mu), t32(sigma),
        torch.tensor([0.8]), t32(w0), t32(w))
    z = got[0]
    for a, b in zip(got[1:], plabels._label_statistics(z, K)):
        assert torch.equal(a, b)
    assert got[1].shape == (1, T, K, K)


def test_random_walk_metropolis_standard_normal():
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(2)
    xs = []
    for _ in range(3000):
        x, acc, _ = pmet.random_walk_metropolis(
            gen, x, lambda v: -0.5 * torch.sum(v * v), 1.2)
        xs.append(x.numpy())
    xs = np.asarray(xs)[500:]
    assert np.abs(xs.mean(axis=0)).max() < 0.3
    assert np.abs(xs.std(axis=0) - 1.0).max() < 0.3


def test_metropolis_class_tunes_and_samples():
    mh = pmet.Metropolis(step_size=40.0, tune=400, tune_interval=50, seed=3,
                         device='cpu')
    x = torch.zeros(2)
    xs = []
    for _ in range(1500):
        x = mh.step(x, lambda v: -0.5 * torch.sum(v * v))
        xs.append(x.numpy())
    assert mh.step_size < 40.0
    xs = np.asarray(xs[600:])
    assert np.abs(xs.mean(axis=0)).max() < 0.4
    assert np.abs(xs.std(axis=0) - 1.0).max() < 0.4
    with pytest.raises(ValueError):
        pmet.Metropolis(proposal_type='hamiltonian')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmet.Metropolis()


def test_dirichlet_metropolis_targets_a_dirichlet():
    """The Dirichlet-proposal class samples Dirichlet(alpha) (mean
    alpha / sum alpha), and its counters follow JAX's schedule."""
    alpha = torch.tensor([2.0, 5.0, 3.0])
    mh = pmet.Metropolis(step_size=20.0, tune=300, tune_interval=50,
                         proposal_type='dirichlet', seed=1, device='cpu')
    x = torch.full((3,), 1.0 / 3.0)
    xs = []
    for _ in range(3000):
        x = mh.step(x, lambda v: pdist.dirichlet_logpdf(v, alpha))
        xs.append(x.numpy())
    assert mh.n_steps == 3000
    np.testing.assert_allclose(np.asarray(xs[500:]).mean(axis=0),
                               (alpha / alpha.sum()).numpy(), atol=0.03)
    gen = torch.Generator().manual_seed(2)
    x_new, acc, ratio = pmet.dirichlet_metropolis(
        gen, x, lambda v: pdist.dirichlet_logpdf(v, alpha), 30.0)
    assert ratio.dtype == torch.float64 and acc.shape == ()


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('directed', [True, False])
def test_load_static_monks_matches_jax(directed):
    for kw in (dict(), dict(encode_labels=False, include_waverers=True)):
        got = pdat.load_static_monks(is_directed=directed, **kw)
        want = jd.load_static_monks(is_directed=directed, **kw)
        assert len(got) == 2 and got[0].shape == (18, 18)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_load_got_edgelists_matches_jax():
    got, want = pdat.load_got_edgelists(), jd.load_got_edgelists()
    assert list(got.columns) == list(want.columns)
    assert got.shape == want.shape
    assert (got.dtypes == want.dtypes).all()
    assert got.equals(want)
