"""The port's model selection and post-processing against the JAX
package's, on seeded random traces: approximate BIC, posterior expected VI
(batched in chunks), label co-occurrence and counts, the forward-algorithm
marginal of the latent mixture, the convergence diagnostics and the
metrics (AUC by ranks, mutual information, adjusted Rand index)."""
import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.metrics as skm

from dynetlsm_tpu import diagnostics as jdiag, label_utils as jlab
from dynetlsm_tpu import metrics as jmet
from dynetlsm_tpu.array_utils import triu_indices_from_3d
from dynetlsm_tpu.datasets import load_monks
from dynetlsm_tpu.mcmc import labels as jlabels
from dynetlsm_tpu.model_selection import approx_bic as jbic
from dynetlsm_tpu.model_selection import posterior_vi as jvi

from dynetlsm_tpu_torch import diagnostics as pdiag, label_utils as plab
from dynetlsm_tpu_torch import metrics as pmet
from dynetlsm_tpu_torch.datasets import (
    synthetic_static_community_dynamic_network)
from dynetlsm_tpu_torch.mcmc import labels as plabels
from dynetlsm_tpu_torch.model_selection import approx_bic as pbic
from dynetlsm_tpu_torch.model_selection import posterior_vi as pvi


def _labels(rng, S, T, n, K):
    """(S, T, n) labels with runs of repeated samples (exact VI ties) and
    a few clusters left empty."""
    zs = rng.randint(0, K - 1, size=(S, T, n))
    zs[1::4] = zs[::4][:zs[1::4].shape[0]]
    return zs.astype(np.int32)


def _traces(seed, directed, S=24, K=6):
    """Seeded random posterior traces on Sampson's network."""
    rng = np.random.RandomState(seed)
    Y, _, _ = load_monks(is_directed=directed)
    T, n, _ = Y.shape
    tr = {
        'Xs': rng.randn(S, T, n, 2),
        'intercepts': rng.randn(S, 2 if directed else 1) + 1.0,
        'mus': rng.randn(S, K, 2),
        'sigmas': rng.uniform(0.3, 1.5, size=(S, K)),
        'betas': rng.dirichlet(np.ones(K), size=S),
        'weights': rng.dirichlet(np.ones(K), size=(S, T, K)),
        'lambdas': rng.uniform(0.5, 1.0, size=S),
        'zs': _labels(rng, S, T, n, K),
        'logps': rng.randn(S) * 10.0 - 200.0,
    }
    if directed:
        tr['radiis'] = rng.dirichlet(np.ones(n), size=S)
    return Y, tr


@pytest.mark.parametrize('directed', [False, True])
def test_select_bic_matches_jax(directed):
    Y, tr = _traces(1 + directed, directed)
    bic_j, models_j, counts_j = jbic.select_bic(Y, tr, 4, directed, 2)
    bic_p, models_p, counts_p = pbic.select_bic(Y, tr, 4, directed, 2)
    np.testing.assert_array_equal(counts_p, counts_j)
    assert bic_p.shape == bic_j.shape
    np.testing.assert_array_equal(bic_p[:, [0, 3]], bic_j[:, [0, 3]])
    np.testing.assert_allclose(bic_p[:, 1:3], bic_j[:, 1:3], rtol=1e-6)
    assert len(models_p) == len(models_j)
    for mp, mj in zip(models_p, models_j):
        for k, v in vars(mj).items():
            if v is None:
                assert getattr(mp, k) is None
            else:
                np.testing.assert_allclose(getattr(mp, k), v, rtol=1e-6,
                                           err_msg=k)


@pytest.mark.parametrize('chunk', [1, 5, 256])
def test_batched_vi_matches_jax_and_the_loop(chunk):
    rng = np.random.RandomState(7)
    zs = _labels(rng, 13, 3, 18, 5)
    C = np.stack([plab.calculate_posterior_cooccurrence(zs, t=t, n_groups=5)
                  for t in range(3)])
    got = pvi.batched_posterior_expected_vi(zs, C, 5, chunk=chunk)
    want = jvi.batched_posterior_expected_vi(zs, C, 5)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    loop = [np.mean([jvi.nonvectorized_posterior_expected_vi(z[t], C[t])
                     for t in range(3)]) for z in zs]
    np.testing.assert_allclose(got, loop, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        [pvi.time_averaged_posterior_expected_vi(z, C) for z in zs], loop,
        rtol=1e-10)


def test_minimize_vi_breaks_ties_by_logp():
    rng = np.random.RandomState(8)
    zs = _labels(rng, 16, 2, 12, 4)
    C = np.stack([plab.calculate_posterior_cooccurrence(zs, t=t, n_groups=4)
                  for t in range(2)])
    vis = pvi.batched_posterior_expected_vi(zs, C, 4)
    best = int(np.argmin(vis))
    twins = np.flatnonzero(vis == vis[best])
    logps = rng.randn(16)
    # make the tied twins the only candidates and let the tie-break decide
    zs = zs.copy()
    zs[twins] = zs[best]
    logps[twins[-1]] = 10.0
    got = pvi.minimize_posterior_expected_vi(zs, C, tie_break=logps,
                                             n_groups=4)
    want = jvi.minimize_posterior_expected_vi(zs, C, tie_break=logps,
                                              n_groups=4)
    assert got == want
    assert pvi.minimize_posterior_expected_vi(zs, C, n_groups=4) == \
        jvi.minimize_posterior_expected_vi(zs, C, n_groups=4)


def test_cooccurrence_and_counts_match_jax():
    rng = np.random.RandomState(9)
    zs = _labels(rng, 40, 3, 15, 6)
    for t in range(3):
        np.testing.assert_array_equal(
            plab.calculate_posterior_cooccurrence(zs, n_burn=5, t=t),
            jlab.calculate_posterior_cooccurrence(zs, n_burn=5, t=t))
        for got, want in zip(
                plab.calculate_posterior_group_counts(zs, n_burn=5, t=t),
                jlab.calculate_posterior_group_counts(zs, n_burn=5, t=t)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plab.calculate_cluster_counts(zs, 3),
                                  jlab.calculate_cluster_counts(zs, 3))
    np.testing.assert_array_equal(plab.calculate_cluster_counts_t(zs, 3),
                                  jlab.calculate_cluster_counts_t(zs, 3))


@pytest.mark.parametrize('seed', [0, 1])
def test_latent_marginal_loglikelihood_matches_jax(seed):
    rng = np.random.RandomState(seed)
    T, n, K = 4, 20, 5
    X = rng.randn(T, n, 2).astype(np.float32)
    init_w = rng.dirichlet(np.ones(K)).astype(np.float32)
    trans_w = rng.dirichlet(np.ones(K), size=(T, K)).astype(np.float32)
    mu = rng.randn(K, 2).astype(np.float32)
    sigma = rng.uniform(0.5, 1.5, size=K).astype(np.float32)
    got = float(plabels.latent_marginal_loglikelihood(
        X, init_w, trans_w, mu, sigma, 0.8))
    want = float(jlabels.latent_marginal_loglikelihood(
        *map(jnp.asarray, (X, init_w, trans_w, mu, sigma)), 0.8))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_diagnostics_match_jax():
    rng = np.random.RandomState(10)
    # four AR(1) chains, one of them shifted
    e = rng.randn(4, 400)
    x = np.zeros_like(e)
    for i in range(1, 400):
        x[:, i] = 0.8 * x[:, i - 1] + e[:, i]
    x[3] += 0.5
    for c in x:
        for n_burn in (None, 50):
            np.testing.assert_allclose(
                pdiag.geweke_diag(c, n_burn=n_burn),
                jdiag.geweke_diag(c, n_burn=n_burn), rtol=1e-6)
        np.testing.assert_allclose(pdiag.spectrum0_ar(c),
                                   jdiag.spectrum0_ar(c), rtol=1e-6)
        assert pdiag.effective_n(c) == jdiag.effective_n(c)
    np.testing.assert_allclose(pdiag.potential_scale_reduction(x),
                               jdiag.potential_scale_reduction(x), rtol=1e-6)
    np.testing.assert_allclose(pdiag.multichain_effective_n(x),
                               jdiag.multichain_effective_n(x), rtol=1e-6)
    assert pdiag.potential_scale_reduction(np.ones((3, 10))) == 1.0
    np.testing.assert_allclose(pdiag.xcorr(x[0], x[1])[1],
                               jdiag.xcorr(x[0], x[1])[1], rtol=1e-6)


@pytest.mark.parametrize('directed', [False, True])
def test_network_auc_with_ties_and_a_nan_mask(directed):
    rng = np.random.RandomState(11 + directed)
    Y, _, _ = load_monks(is_directed=directed)
    # scores on a coarse grid: many ties
    probas = np.round(rng.uniform(size=Y.shape), 1)
    got = pmet.network_auc(Y, probas, is_directed=directed)
    np.testing.assert_allclose(got, jmet.network_auc(
        Y, probas, is_directed=directed), rtol=1e-12)
    nan_mask = rng.uniform(size=int(directed and 3 * 18 * 17
                                    or 3 * 18 * 17 // 2)) < 0.2
    got = pmet.network_auc(Y, probas, is_directed=directed,
                           nan_mask=nan_mask)
    np.testing.assert_allclose(got, jmet.network_auc(
        Y, probas, is_directed=directed, nan_mask=nan_mask), rtol=1e-12)


def test_roc_auc_raises_on_one_class():
    with pytest.raises(ValueError, match='Only one class'):
        pmet.roc_auc(np.ones(5), np.arange(5))


def test_out_of_sample_auc_matches_jax():
    rng = np.random.RandomState(12)
    Y, _, _ = load_monks(is_directed=False)
    probas = np.round(rng.uniform(size=Y.shape), 2)
    test = rng.uniform(size=3 * 18 * 17 // 2) < 0.3
    flat = probas[triu_indices_from_3d(Y, 1)][test]
    for pred in (probas, flat):
        np.testing.assert_allclose(pmet.out_of_sample_auc(Y, pred, test),
                                   jmet.out_of_sample_auc(Y, pred, test),
                                   rtol=1e-12)


def test_label_metrics_match_sklearn_and_jax():
    rng = np.random.RandomState(13)
    for _ in range(5):
        a = rng.randint(0, 4, size=50)
        b = rng.randint(0, 6, size=50)
        assert pmet.entropy(a) == jmet.entropy(a)
        np.testing.assert_allclose(pmet.mutual_info_score(a, b),
                                   skm.mutual_info_score(a, b), rtol=1e-12)
        np.testing.assert_allclose(pmet.variation_of_information(a, b),
                                   jmet.variation_of_information(a, b),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(pmet.adjusted_rand_score(a, b),
                                   skm.adjusted_rand_score(a, b), rtol=1e-12)
    assert pmet.adjusted_rand_score(a, 3 - a) == 1.0
    assert pmet.mutual_info_score(a, np.zeros_like(a)) == 0.0


def test_community_generator_matches_jax():
    from dynetlsm_tpu.datasets import (
        synthetic_static_community_dynamic_network as jgen)
    kw = dict(n_nodes=40, n_time_steps=2, n_groups=3,
              simulation_type='easy', random_state=42)
    Y, X, z = synthetic_static_community_dynamic_network(**kw)
    Yj, Xj, zj = jgen(**kw)[:3]
    np.testing.assert_array_equal(Y, Yj)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(z, zj)


@pytest.mark.parametrize('directed, n_chains', [(False, 1), (True, 3)])
def test_posterior_mean_probas_match_jax(directed, n_chains):
    """The posterior-mean edge probabilities and their AUC of a fitted
    model's traces, pooled over chains and thinned to ``max_samples``."""
    import types
    rng = np.random.RandomState(14)
    Y, _, _ = load_monks(is_directed=directed)
    T, n, _ = Y.shape
    lead = (n_chains, 30) if n_chains > 1 else (30,)
    model = types.SimpleNamespace(
        n_chains=n_chains, n_burn_=10, is_directed=directed, Y_fit_=Y,
        Xs_=rng.randn(*lead, T, n, 2),
        intercepts_=rng.randn(*lead, 2 if directed else 1),
        radiis_=rng.dirichlet(np.ones(n), size=lead))
    for max_samples in (2000, 7):
        np.testing.assert_allclose(
            pmet.posterior_mean_probas(model, max_samples),
            jmet.posterior_mean_probas(model, max_samples), rtol=1e-12)
        np.testing.assert_allclose(
            pmet.posterior_mean_auc(model, max_samples),
            jmet.posterior_mean_auc(model, max_samples), rtol=1e-12)
