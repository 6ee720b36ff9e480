"""Posterior label post-processing (counterpart of
``dynetlsm_tpu/label_utils.py``, reference dynetlsm/label_utils.py), in
NumPy and SciPy alone: the JAX package's native C++ accumulators
(``dynetlsm_tpu/native``) are replaced by their NumPy forms, with the
one-hot co-occurrence sum as one matrix product and the occupied-cluster
counts from an occupancy table.  Every count is an integer, so the results
equal the native library's."""
import numpy as np
import scipy.cluster.hierarchy as hc
from scipy.spatial.distance import squareform


def renormalize_sample(zs, beta, weights, mus, sigmas):
    """One posterior sample restricted to its active clusters (reference
    label_utils.py:10-37, approx_bic.py:104-120): labels zs (T, n)
    relabelled 0..k-1 in the order of the cluster ids, beta, the initial
    weights and the transition rows renormalised over the active clusters
    (trans_w[0] unused), and their means and variances.  Returns (z, beta,
    init_w, trans_w (T, k, k), mu, sigma)."""
    active, z = np.unique(zs.ravel(), return_inverse=True)
    k = active.shape[0]
    T = weights.shape[0]

    beta = beta[active] / beta[active].sum()
    init_w = weights[0, 0, active] / weights[0, 0, active].sum()
    trans_w = np.zeros((T, k, k))
    for t in range(1, T):
        trans_w[t] = weights[t][np.ix_(active, active)]
        trans_w[t] /= trans_w[t].sum(axis=1, keepdims=True)
    return (z.reshape(zs.shape), beta, init_w, trans_w, mus[active],
            sigmas[active])


def renormalize_weights(model, sample_id):
    """:func:`renormalize_sample` of a fitted HDP-LPCM's sample
    ``sample_id`` (its single-chain traces)."""
    return renormalize_sample(model.zs_[sample_id], model.betas_[sample_id],
                              model.weights_[sample_id],
                              model.mus_[sample_id], model.sigmas_[sample_id])


def calculate_cooccurrence_matrix(z, n_groups=None):
    if n_groups is None:
        n_groups = np.unique(z).shape[0]
    indicator = np.eye(n_groups)[z]
    return indicator @ indicator.T


def cooccurrence(z, n_groups):
    """Mean co-clustering probabilities of labels z (S, n): (n, n)
    float64, the count of samples with z_si == z_sj over S."""
    z = np.asarray(z)
    S, n = z.shape
    onehot = np.eye(int(n_groups), dtype=np.float32)[z]     # (S, n, K)
    M = onehot.transpose(1, 0, 2).reshape(n, -1)
    return (M @ M.T).astype(np.float64) / S


def calculate_posterior_cooccurrence(zs, n_burn=0, t=0, n_groups=None):
    """Mean co-clustering probability over post-burn samples at time t;
    zs (n_samples, T, n) label traces."""
    z = np.asarray(zs)[n_burn:, t]                    # (S, n)
    if n_groups is None:
        n_groups = int(z.max()) + 1
    return cooccurrence(z, n_groups)


def cluster_posterior_coocurrence(cooccurrence_proba, threshold=0.5):
    """Average-linkage hierarchical clustering of the co-occurrence matrix
    (reference label_utils.py:65-72)."""
    linkage = hc.linkage(squareform(1.0 - cooccurrence_proba),
                         method='average', optimal_ordering=True)
    return hc.fcluster(linkage, t=threshold, criterion='distance') - 1


def _occupied(z, n_groups):
    """Boolean occupancy (S, ..., K) of labels z (S, ..., m) over their
    last axis."""
    z = np.asarray(z)
    rows = z.reshape(-1, z.shape[-1])
    occ = np.zeros((rows.shape[0], int(n_groups)), dtype=bool)
    occ[np.arange(rows.shape[0])[:, None], rows] = True
    return occ.reshape(z.shape[:-1] + (int(n_groups),))


def calculate_cluster_counts(zs, n_burn=0):
    """Number of occupied clusters per post-burn sample
    (reference approx_bic.py:42-53)."""
    z = np.asarray(zs)[n_burn:]
    z = z.reshape(z.shape[0], -1)
    return _occupied(z, int(z.max()) + 1).sum(axis=-1).astype(np.int64)


def calculate_cluster_counts_t(zs, n_burn=0):
    """Occupied-cluster counts per (time, sample)
    (reference approx_bic.py:27-39)."""
    z = np.asarray(zs)[n_burn:]                        # (S, T, n)
    counts = _occupied(z, int(z.max()) + 1).sum(axis=-1)
    return counts.T.astype(np.int64)


def calculate_posterior_group_counts(zs, n_burn=0, t=0):
    """Histogram of occupied-cluster counts at time t
    (reference label_utils.py:75-82)."""
    counts = calculate_cluster_counts_t(zs, n_burn)[t]
    freq = np.bincount(counts)
    index = np.where(freq != 0)[0]
    return index, freq[index]
