"""The port's host-side initialisation (``dynetlsm_tpu_torch/math/init.py``)
against the JAX package's and scikit-learn's: GMDS with its SMACOF start,
k-means++ seeding, Lloyd iterations, the longitudinal k-means and the two
intercept MLEs, and ``entry.build_state_and_sweep(..., quality_init=True)``
against ``bench.build_state_and_sweep``.

The copies draw the same numbers from the same ``np.random.RandomState``,
so after each call the caller's stream stands where the JAX package's
does; the tests check that by the next draw."""
import numpy as np
import pytest
from sklearn.cluster import KMeans, kmeans_plusplus as sk_kmeans_plusplus

import bench
from dynetlsm_tpu.datasets import load_monks
from dynetlsm_tpu.math import init as jinit

from dynetlsm_tpu_torch import entry
from dynetlsm_tpu_torch.math import init as pinit


def _monks(directed):
    Y, _, _ = load_monks(is_directed=directed)
    return Y


def _isolated(directed):
    """A small network (T=2, n=9) whose node 8 has no tie at t=0: its
    shortest-path distances are imputed as the largest finite one + 1."""
    rng = np.random.RandomState(0)
    Y = (rng.uniform(size=(2, 9, 9)) < 0.4).astype(np.float64)
    if not directed:
        Y = np.triu(Y, 1)
        Y = Y + Y.transpose(0, 2, 1)
    Y[:, np.arange(9), np.arange(9)] = 0.0
    Y[0, 8, :] = Y[0, :, 8] = 0.0
    return Y


def _three_clusters():
    """(T=4, n=60, d=2) trajectories in three separated groups."""
    rng = np.random.RandomState(3)
    centres = np.array([[-5.0, 0.0], [5.0, 0.0], [0.0, 6.0]])
    z = np.repeat(np.arange(3), 20)
    return centres[z][None] + 0.5 * rng.randn(4, 60, 2)


@pytest.mark.parametrize('network', ['monks', 'isolated'])
@pytest.mark.parametrize('directed', [False, True])
def test_generalized_mds_matches_jax(network, directed):
    Y = _monks(directed) if network == 'monks' else _isolated(directed)
    rng_j, rng_p = np.random.RandomState(11), np.random.RandomState(11)
    X_j = jinit.generalized_mds(Y, is_directed=directed, random_state=rng_j)
    X_p = pinit.generalized_mds(Y, is_directed=directed, random_state=rng_p)
    assert X_p.shape == X_j.shape
    np.testing.assert_allclose(X_p, X_j, rtol=0, atol=1e-6)
    assert rng_p.randint(2**31 - 1) == rng_j.randint(2**31 - 1)


def test_shortest_path_imputes_unreachable_pairs():
    D = pinit.shortest_path_dissimilarity(_isolated(False)[0])
    np.testing.assert_array_equal(D[8, :8], D.max())
    assert D.max() == D[D < D.max()].max() + 1
    np.testing.assert_array_equal(
        D, jinit.shortest_path_dissimilarity(_isolated(False)[0]))


@pytest.mark.parametrize('k', [2, 5, 9])
def test_kmeans_plusplus_matches_sklearn(k):
    X = np.random.RandomState(k).randn(80, 6)
    _, want = sk_kmeans_plusplus(X, k, random_state=np.random.RandomState(4))
    rng = np.random.RandomState(4)
    centres, got = pinit.kmeans_plusplus(X, k, rng)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(centres, X[want])


@pytest.mark.parametrize('k', [3, 6])
def test_lloyd_matches_sklearn(k):
    X = _three_clusters()[:2].transpose(1, 2, 0).reshape(60, -1)
    X = X + 0.3 * np.random.RandomState(k).randn(*X.shape)
    init = X[np.random.RandomState(k + 1).choice(60, k, replace=False)]
    km = KMeans(n_clusters=k, init=init, n_init=1).fit(X)
    # KMeans centres the data (and the given centres) before iterating
    mean = X.mean(axis=0)
    tol = np.mean(np.var(X, axis=0)) * 1e-4
    labels, inertia, centres = pinit.lloyd(X - mean, init - mean, tol=tol)
    np.testing.assert_array_equal(labels, km.labels_)
    np.testing.assert_allclose(centres + mean, km.cluster_centers_,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(inertia, km.inertia_, rtol=1e-10)


def _assert_same_kmeans(got, want, X):
    """The same labels, centres and variances (rtol 1e-8), or, where the
    float order of the sums differs, the same partition with the inertia
    within 1e-9 relative."""
    (mu_p, var_p, z_p), (mu_j, var_j, z_j) = got, want
    if np.array_equal(z_p, z_j):
        np.testing.assert_allclose(mu_p, mu_j, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(var_p, var_j, rtol=1e-8)
        return
    assert pinit._same_clustering(z_p[0], z_j[0], mu_p.shape[0])

    def inertia(z, mu):
        return sum(((X[:, z[0] == g] - mu[g]) ** 2).sum()
                   for g in range(mu.shape[0]))
    np.testing.assert_allclose(inertia(z_p, mu_p), inertia(z_j, mu_j),
                               rtol=1e-9)


@pytest.mark.parametrize('case, k', [('clusters', 3), ('clusters', 5),
                                     ('monks', 4), ('monks', 10)])
def test_longitudinal_kmeans_matches_jax(case, k):
    if case == 'clusters':
        X = _three_clusters()
    else:
        X = jinit.generalized_mds(_monks(False), random_state=7)
    rng_j, rng_p = np.random.RandomState(5), np.random.RandomState(5)
    want = jinit.longitudinal_kmeans(X, n_clusters=k, random_state=rng_j)
    got = pinit.longitudinal_kmeans(X, n_clusters=k, random_state=rng_p)
    _assert_same_kmeans(got, want, X)
    assert rng_p.randint(2**31 - 1) == rng_j.randint(2**31 - 1)


def test_kmeans_raises_with_fewer_samples_than_clusters():
    with pytest.raises(ValueError, match='n_samples=3'):
        pinit.kmeans(np.zeros((3, 2)), 4, random_state=0)


def test_scale_intercept_mle_matches_jax():
    Y = _monks(False)
    X = jinit.generalized_mds(Y, random_state=3)
    got = pinit.scale_intercept_mle(Y, X)
    want = jinit.scale_intercept_mle(Y, X)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_directed_intercept_mle_matches_jax():
    Y = _monks(True)
    X = jinit.generalized_mds(Y, is_directed=True, random_state=3)
    radii = pinit.initialize_radii(Y)
    np.testing.assert_array_equal(radii, jinit.initialize_radii(Y))
    got = pinit.directed_intercept_mle(Y, X, radii)
    want = jinit.directed_intercept_mle(Y, X, radii)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize('directed', [False, True])
def test_quality_init_matches_bench(directed):
    """``build_state_and_sweep(..., quality_init=True)``: GMDS, centring and
    the longitudinal k-means from the seed's RandomState, then the
    Dirichlet draws, as ``bench.build_state_and_sweep`` makes them."""
    Y = _monks(directed)
    K = 5
    state, _, _ = entry.build_state_and_sweep(
        Y, 2, K=K, seed=3, device='cpu', is_directed=directed,
        quality_init=True)
    j_state, _ = bench.build_state_and_sweep(
        Y, 2, K=K, seed=3, quality_init=True, is_directed=directed)
    for name in ('X', 'mu', 'sigma', 'weights', 'beta'):
        np.testing.assert_allclose(
            getattr(state, name).numpy(), np.asarray(getattr(j_state, name)),
            rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(state.z.numpy(), np.asarray(j_state.z))
