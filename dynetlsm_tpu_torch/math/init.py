"""Host-side initialisation of a fit (counterpart of
``dynetlsm_tpu/math/init.py``), in NumPy, SciPy and CPU torch: the JAX
package's module imports scikit-learn, which the port does without.

* :func:`generalized_mds` — Sarkar & Moore (2005) dynamic-graph MDS
  (reference latent_space.py:47-95); its t = 0 step is metric SMACOF
  (:func:`smacof`), a copy of scikit-learn's ``_smacof_single``.
* :func:`longitudinal_kmeans` — Genolini & Falissard (2010)
  (reference latent_space.py:98-137); its k-means (:func:`kmeans`) copies
  scikit-learn's ``KMeans(n_init=10)``: k-means++ seeding and Lloyd
  iterations.
* :func:`initialize_radii` (reference latent_space.py:140-153).
* :func:`scale_intercept_mle`, :func:`directed_intercept_mle`
  (reference lsm.py:47-97): SciPy's BFGS on the float32 log-likelihood,
  with the gradient from ``torch.autograd`` on the CPU.

scikit-learn's algorithms are BSD-licensed (``sklearn/manifold/_mds.py``,
``sklearn/cluster/_kmeans.py`` and ``_k_means_lloyd.pyx`` of version
1.9.0).  The copies draw the same numbers from the same
``np.random.RandomState`` in the same order, so a seed gives the JAX
package's initial values.
"""
import numbers

import numpy as np
import torch
from scipy.optimize import minimize
from scipy.sparse import csgraph
from scipy.special import expit

from ..ops.distances import pairwise_distances
from ..ops.likelihoods import directed_loglik_full, undirected_loglik_full


def check_random_state(seed):
    """``np.random.RandomState`` from None, an int or a RandomState, as
    scikit-learn's ``check_random_state`` makes it."""
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError('%r cannot be used to seed a numpy.random.RandomState'
                     % (seed,))


def shortest_path_dissimilarity(Y, unweighted=True):
    """Shortest-path graph dissimilarity; unreachable pairs imputed with
    (max finite distance + 1) (reference latent_space.py:36-44)."""
    dist = csgraph.shortest_path(Y, directed=False, unweighted=unweighted)
    inf_mask = np.isinf(dist)
    if inf_mask.any():
        dist[inf_mask] = np.max(dist[~inf_mask]) + 1
    return dist


def euclidean_distances(X, Y=None):
    """scikit-learn's ``euclidean_distances(X, Y)`` (``pairwise_distances``
    with its default metric) for float64 arrays: the expanded square
    x^2 - 2 x.y + y^2, clipped at 0; between X and itself (Y None) the
    diagonal 0."""
    XX = np.einsum('ij,ij->i', X, X)[:, None]
    YY = XX.T if Y is None else np.einsum('ij,ij->i', Y, Y)[None, :]
    distances = -2 * np.dot(X, X.T if Y is None else Y.T)
    distances += XX
    distances += YY
    np.maximum(distances, 0, out=distances)
    if Y is None:
        np.fill_diagonal(distances, 0)
    return np.sqrt(distances)


def smacof(dissimilarities, n_components=2, max_iter=300, eps=1e-6,
           random_state=None):
    """Metric SMACOF from a uniform random start, one run (scikit-learn's
    ``_smacof_single`` with ``metric=True``): Guttman transforms until the
    stress falls by less than ``eps`` times half the sum of squared
    embedding distances.  The start is ``random_state.uniform(size=n *
    n_components)``.  Returns the (n, n_components) embedding."""
    random_state = check_random_state(random_state)
    D = np.asarray(dissimilarities, dtype=np.float64)
    n = D.shape[0]
    X = random_state.uniform(size=n * n_components).reshape(
        (n, n_components))
    distances = euclidean_distances(X)
    old_stress = None
    for _ in range(max_iter):
        distances[distances == 0] = 1e-5
        ratio = D / distances
        B = -ratio
        B[np.arange(n), np.arange(n)] += ratio.sum(axis=1)
        X = 1.0 / n * np.dot(B, X)
        distances = euclidean_distances(X)
        stress = ((distances.ravel() - D.ravel()) ** 2).sum() / 2
        if old_stress is not None:
            sum_squared_distances = (distances.ravel() ** 2).sum()
            if ((old_stress - stress) / (sum_squared_distances / 2)) < eps:
                break
        old_stress = stress
    return X


def generalized_mds(Y, n_features=2, is_directed=False, unweighted=True,
                    lmbda=10.0, random_state=None):
    """Generalized MDS initialisation of the latent trajectory.

    t=0 uses metric SMACOF on the shortest-path dissimilarity; subsequent
    steps take the top eigenvectors of a blend of the new Gram matrix and
    the previous embedding's Gram matrix, then Procrustes-align
    (reference latent_space.py:47-95).
    """
    Y = np.asarray(Y, dtype=np.float64)
    squeeze = Y.ndim == 2
    if squeeze:
        Y = Y[None]
    T, n, _ = Y.shape

    D = np.stack([shortest_path_dissimilarity(Y[t], unweighted)
                  for t in range(T)])

    X = np.empty((T, n, n_features))
    X[0] = smacof(D[0], n_components=n_features, random_state=random_state)

    H = np.eye(n) - np.full((n, n), 1.0 / n)
    a = 1.0 / (1.0 + lmbda)
    b = lmbda / (1.0 + lmbda)
    for t in range(1, T):
        gram = a * (H @ (-0.5 * D[t] ** 2) @ H) + b * (X[t - 1] @ X[t - 1].T)
        evals, evecs = np.linalg.eigh(gram)
        top = slice(-1, -n_features - 1, -1)
        X[t] = evecs[:, top] * np.sqrt(np.maximum(evals[top], 0.0))
        # align with previous step to remove the rotation ambiguity
        u, _, vt = np.linalg.svd(X[t].T @ X[t - 1], full_matrices=False)
        X[t] = X[t] @ (u @ vt)

    if is_directed:
        # match the scale of the radii simplex (reference
        # latent_space.py:92-93)
        X /= n

    return X[0] if squeeze else X


# ---------------------------------------------------------------------------
# k-means (scikit-learn's KMeans with algorithm='lloyd', unit sample weights)
# ---------------------------------------------------------------------------

def _sq_distances_to(C, X, x_squared_norms):
    """Squared distances (k, n) of the rows of C to the rows of X, in
    scikit-learn's expanded form, clipped at 0."""
    d = -2 * np.dot(C, X.T)
    d += np.einsum('ij,ij->i', C, C)[:, None]
    d += x_squared_norms[None, :]
    return np.maximum(d, 0)


def kmeans_plusplus(X, n_clusters, random_state, x_squared_norms=None):
    """k-means++ seeding with 2 + int(log k) local trials a centre
    (scikit-learn's ``_kmeans_plusplus``; the same draws: one ``choice``,
    then one ``uniform(size=n_local_trials)`` a centre).  Returns
    (centres (k, d), their row indices)."""
    n_samples, n_features = X.shape
    if x_squared_norms is None:
        x_squared_norms = np.einsum('ij,ij->i', X, X)
    sample_weight = np.ones(n_samples, dtype=X.dtype)
    centers = np.empty((n_clusters, n_features), dtype=X.dtype)
    n_local_trials = 2 + int(np.log(n_clusters))

    center_id = random_state.choice(n_samples,
                                    p=sample_weight / sample_weight.sum())
    indices = np.full(n_clusters, -1, dtype=int)
    centers[0] = X[center_id]
    indices[0] = center_id

    closest_dist_sq = _sq_distances_to(centers[0, None], X, x_squared_norms)
    current_pot = closest_dist_sq @ sample_weight

    for c in range(1, n_clusters):
        rand_vals = random_state.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(
            np.cumsum(sample_weight * closest_dist_sq), rand_vals)
        np.clip(candidate_ids, None, closest_dist_sq.size - 1,
                out=candidate_ids)
        distance_to_candidates = _sq_distances_to(X[candidate_ids], X,
                                                  x_squared_norms)
        np.minimum(closest_dist_sq, distance_to_candidates,
                   out=distance_to_candidates)
        candidates_pot = distance_to_candidates @ sample_weight.reshape(-1, 1)
        best_candidate = np.argmin(candidates_pot)
        current_pot = candidates_pot[best_candidate]
        closest_dist_sq = distance_to_candidates[best_candidate]
        best_candidate = candidate_ids[best_candidate]
        centers[c] = X[best_candidate]
        indices[c] = best_candidate
    return centers, indices


def _assign(X, centers):
    """Nearest centre of every row (first index on ties), from
    |c|^2 - 2 x.c as scikit-learn's Lloyd step ranks them."""
    d = np.einsum('ij,ij->i', centers, centers)[None, :] \
        + (-2.0) * np.dot(X, centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _update_centers(X, labels, centers_old):
    """The M-step of scikit-learn's Lloyd iteration: per-cluster sums,
    empty clusters relocated to the points farthest from their centres,
    sums scaled by the reciprocal of the counts, and each centre's shift."""
    k, d = centers_old.shape
    sums = np.zeros((k, d))
    np.add.at(sums, labels, X)
    weight = np.bincount(labels, minlength=k).astype(np.float64)
    empty = np.where(weight == 0)[0]
    if empty.size:
        dist = ((X - centers_old[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -empty.size)[:-empty.size - 1:-1]
        if np.max(dist) != 0:
            for new_id, far_idx in zip(empty, far):
                old_id = labels[far_idx]
                sums[old_id] -= X[far_idx]
                sums[new_id] = X[far_idx]
                weight[new_id] = 1.0
                weight[old_id] -= 1.0
    # in place and in index order, as scikit-learn's _average_centers
    biggest = np.argmax(weight)
    for j in range(k):
        if weight[j] > 0:
            sums[j] *= 1.0 / weight[j]
        else:
            sums[j] = sums[biggest]
    shift = np.sqrt(((sums - centers_old) ** 2).sum(axis=1))
    return sums, shift


def lloyd(X, centers_init, max_iter=300, tol=0.0):
    """One k-means run from ``centers_init`` (scikit-learn's
    ``_kmeans_single_lloyd``): stop when the labels repeat or the summed
    squared centre shift is at most ``tol``; a last assignment when they
    did not repeat.  Returns (labels int32, inertia, centres)."""
    centers = np.array(centers_init, dtype=np.float64)
    labels_old = np.full(X.shape[0], -1, dtype=np.int32)
    strict = False
    for _ in range(max_iter):
        labels = _assign(X, centers)
        centers, shift = _update_centers(X, labels, centers)
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(X, centers)
    inertia = float(((X - centers[labels]) ** 2).sum())
    return labels, inertia, centers


def _same_clustering(labels1, labels2, n_clusters):
    """Whether two labelings are equal up to a permutation of labels."""
    mapping = np.full(n_clusters, -1)
    for a, b in zip(labels1, labels2):
        if mapping[a] == -1:
            mapping[a] = b
        elif mapping[a] != b:
            return False
    return True


def kmeans(X, n_clusters, n_init=10, max_iter=300, tol=1e-4,
           random_state=None):
    """k-means as scikit-learn's ``KMeans(n_clusters, n_init=n_init,
    random_state=random_state).fit`` runs it: the tolerance ``tol`` times
    the mean feature variance, the data centred, ``n_init`` runs of
    k-means++ seeding and Lloyd iterations, and the run of least inertia
    kept (a later run replaces the best only when its inertia is lower and
    its partition differs).  The random draws are scikit-learn's; the
    float order of the sums may differ from its Cython loops in the last
    bits, so a tie between two distances or two runs' inertias that close
    could resolve otherwise.  Returns (labels int32, centres)."""
    random_state = check_random_state(random_state)
    X = np.array(X, dtype=np.float64)
    if X.shape[0] < n_clusters:
        raise ValueError('n_samples=%d should be >= n_clusters=%d.'
                         % (X.shape[0], n_clusters))
    tol = np.mean(np.var(X, axis=0)) * tol
    X_mean = X.mean(axis=0)
    X -= X_mean
    x_squared_norms = np.einsum('ij,ij->i', X, X)
    best = None
    for _ in range(n_init):
        centers, _ = kmeans_plusplus(X, n_clusters, random_state,
                                     x_squared_norms)
        labels, inertia, centers = lloyd(X, centers, max_iter, tol)
        if best is None or (inertia < best[1] and not _same_clustering(
                labels, best[0], n_clusters)):
            best = (labels, inertia, centers)
    return best[0], best[2] + X_mean


def longitudinal_kmeans(X, n_clusters=5, var_reg=1e-3, random_state=None):
    """K-means on time-stacked node trajectories; returns time-constant
    cluster means, spherical variances, and labels
    (reference latent_space.py:98-137)."""
    T, n, d = X.shape
    feats = np.moveaxis(np.asarray(X, dtype=np.float64), 0, -1).reshape(
        n, T * d)
    labels_static, cluster_centers = kmeans(feats, n_clusters,
                                            random_state=random_state)
    labels = np.tile(labels_static, (T, 1))

    centers = np.empty((n_clusters, d))
    for k in range(n_clusters):
        centers[k] = cluster_centers[k].reshape(d, T).T.mean(axis=0)

    variances = np.zeros(n_clusters)
    for k in range(n_clusters):
        for t in range(T):
            pts = X[t][labels[t] == k]
            if pts.shape[0]:
                variances[k] += np.var(pts, axis=0).mean()
        variances[k] /= T
    variances[variances == 0.0] = var_reg

    return centers, variances, labels


def initialize_radii(Y, reg=1e-5):
    """Degree-normalised social radii (reference latent_space.py:140-153)."""
    Y = np.asarray(Y)
    f64 = np.float64
    radii = 0.5 * (Y.sum(axis=(0, 1), dtype=f64) + Y.sum(axis=(0, 2),
                                                        dtype=f64))
    radii /= Y.sum(dtype=f64)
    if np.any(radii == 0.0):
        radii += reg
        radii /= radii.sum()
    return radii


# ---------------------------------------------------------------------------
# intercept MLEs (BFGS over the float32 likelihood, autograd gradients)
# ---------------------------------------------------------------------------

def _bfgs(neg_ll, x0, tol, device):
    """SciPy BFGS on ``neg_ll(params)`` (a float32 torch function of a
    float32 (2,) tensor on ``device``), its gradient from
    ``torch.autograd``."""
    def fun(x):
        p = torch.tensor(np.asarray(x, np.float32), device=device,
                         requires_grad=True)
        v = neg_ll(p)
        g, = torch.autograd.grad(v, p)
        return float(v.detach()), g.cpu().numpy().astype(np.float64)

    return minimize(fun, x0=x0, jac=True, method='BFGS', tol=tol)


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def scale_intercept_mle(Y, X, tol=1e-4, device='cpu'):
    """Joint MLE of a log-scale for X and the intercept (reference
    lsm.py:47-70), in float32 on ``device`` (the CPU, or the card of a
    fit there: each step's likelihood is a pass over T n^2 dyads).
    Returns (scale, intercept)."""
    dist = pairwise_distances(_f32(X, device))
    Yt = _f32(Y, device)
    res = _bfgs(lambda p: -undirected_loglik_full(
        Yt, torch.exp(p[0]) * dist, p[1]), np.array([0.0, 1.0]), tol,
        device)
    return float(res.x[0]), float(res.x[1])


def directed_intercept_mle(Y, X, radii, intercept_init=None, tol=1e-4,
                           device='cpu'):
    """MLE of (intercept_in, intercept_out) (reference lsm.py:73-97), in
    float32 on ``device``."""
    dist = pairwise_distances(_f32(X, device))
    Yt = _f32(Y, device)
    rt = _f32(radii, device)
    x0 = (np.asarray(intercept_init, np.float64)
          if intercept_init is not None else np.zeros(2))
    res = _bfgs(lambda p: -directed_loglik_full(Yt, dist, rt, p[0], p[1]),
                x0, tol, device)
    return float(res.x[0]), float(res.x[1])


# ---------------------------------------------------------------------------
# public gradient and distance helpers (reference latent_space.py:19-33,
# lsm.py:32-44), NumPy in float64
# ---------------------------------------------------------------------------


def calculate_distances(X, squared=False):
    """Pairwise latent distances of a static (n, d) or longitudinal (T, n,
    d) configuration (reference latent_space.py:19-33)."""
    X = np.asarray(X, np.float64)
    diff = X[..., :, None, :] - X[..., None, :, :]
    d2 = np.sum(diff * diff, axis=-1)
    return d2 if squared else np.sqrt(np.maximum(d2, 0.0))


def _offdiag_sum(g):
    """Sum of g (T, n, n) over every off-diagonal entry."""
    return np.sum(g) - np.einsum('ikk', g).sum()


def undirected_intercept_grad(Y, X, intercept, squared=False, dist=None):
    """d loglik / d intercept of the undirected model, each dyad once
    (reference lsm.py:32-36)."""
    if dist is None:
        dist = calculate_distances(X, squared=squared)
    g = np.asarray(Y, np.float64) - expit(intercept - dist)
    return 0.5 * float(_offdiag_sum(g))


def scale_grad(Y, X, intercept, scale, squared=False, dist=None):
    """d loglik / d log-scale of the latent positions, summed over the
    full off-diagonal matrix as the reference does (reference
    lsm.py:39-44; the scale is exp(scale))."""
    if dist is None:
        dist = calculate_distances(X, squared=squared)
    sd = np.exp(scale) * dist
    g = -sd * (np.asarray(Y, np.float64) - expit(intercept - sd))
    return float(_offdiag_sum(g))
