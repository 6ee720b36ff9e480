"""Goodness-of-fit and clustering metrics (counterpart of
``dynetlsm_tpu/metrics.py``, reference dynetlsm/metrics.py), in NumPy and
SciPy: scikit-learn's ``roc_auc_score``, ``mutual_info_score`` and
``adjusted_rand_score`` are replaced by the rank form of the AUC and
copies of the other two."""
import numpy as np
from scipy.special import expit
from scipy.stats import rankdata

from .array_utils import nondiag_indices_from_3d, triu_indices_from_3d


def roc_auc(y_true, y_score):
    """Area under the ROC curve of the 0/1 labels ``y_true`` by the scores
    ``y_score``: the Mann-Whitney statistic, tied scores given their mean
    rank, which is the trapezoid area scikit-learn's ``roc_auc_score``
    computes."""
    y_true = np.asarray(y_true).ravel() == 1
    ranks = rankdata(np.asarray(y_score, dtype=np.float64).ravel())
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError('Only one class present in y_true. ROC AUC score '
                         'is not defined in that case.')
    return float((ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def entropy(labels):
    """Shannon entropy (nats) of a label assignment."""
    labels = np.asarray(labels).ravel()
    if labels.size == 0:
        return 1.0
    counts = np.bincount(labels.astype(np.int64) - labels.min())
    p = counts[counts > 0] / labels.size
    return float(-np.sum(p * np.log(p)))


def _contingency(labels_true, labels_pred):
    """The (classes, clusters) table of co-assignment counts, int64."""
    _, a = np.unique(np.asarray(labels_true).ravel(), return_inverse=True)
    _, b = np.unique(np.asarray(labels_pred).ravel(), return_inverse=True)
    contingency = np.zeros((a.max() + 1, b.max() + 1), dtype=np.int64)
    np.add.at(contingency, (a, b), 1)
    return contingency


def adjusted_rand_score(labels_true, labels_pred):
    """Rand index adjusted for chance, from the pair confusion counts (the
    formula of scikit-learn's ``adjusted_rand_score``)."""
    contingency = _contingency(labels_true, labels_pred)
    n = int(contingency.sum())
    sum_squares = int((contingency ** 2).sum())
    tp = sum_squares - n
    fp = int(contingency.dot(contingency.sum(axis=0)).sum()) - sum_squares
    fn = int(contingency.T.dot(contingency.sum(axis=1)).sum()) - sum_squares
    tn = n * n - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn)
                                        + (tp + fp) * (fp + tn))


def mutual_info_score(labels_true, labels_pred):
    """Mutual information (nats) of two labelings, from their contingency
    table (the formula of scikit-learn's ``mutual_info_score``)."""
    contingency = _contingency(labels_true, labels_pred)
    nzx, nzy = np.nonzero(contingency)
    nz_val = contingency[nzx, nzy]
    contingency_sum = contingency.sum()
    pi = contingency.sum(axis=1)
    pj = contingency.sum(axis=0)
    if pi.size == 1 or pj.size == 1:
        return 0.0
    log_contingency_nm = np.log(nz_val)
    contingency_nm = nz_val / contingency_sum
    outer = pi.take(nzx).astype(np.int64) * pj.take(nzy).astype(np.int64)
    log_outer = -np.log(outer) + np.log(pi.sum()) + np.log(pj.sum())
    mi = (contingency_nm * (log_contingency_nm - np.log(contingency_sum))
          + contingency_nm * log_outer)
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def network_auc(Y_true, Y_pred, is_directed=False, nan_mask=None):
    """In-sample AUC over dyads, optionally excluding missing entries."""
    if is_directed:
        indices = nondiag_indices_from_3d(Y_true)
    else:
        indices = triu_indices_from_3d(Y_true, 1)
    y_fit = np.asarray(Y_pred)[indices]
    y_true = np.asarray(Y_true)[indices]
    if nan_mask is not None:
        y_fit = y_fit[~nan_mask]
        y_true = y_true[~nan_mask]
    return roc_auc(y_true, y_fit)


def out_of_sample_auc(y_true, y_pred, test_indices):
    """Held-out dyad AUC on a train_test_split mask: ``y_pred`` is the flat
    vector of held-out predictions or a full (T, n, n) prediction tensor
    such as an estimator's ``missings_``."""
    indices = triu_indices_from_3d(y_true, k=1)
    y_pred = np.asarray(y_pred)
    if y_pred.ndim == 3:
        y_pred = y_pred[indices][test_indices]
    return roc_auc(np.asarray(y_true)[indices][test_indices], y_pred)


def variation_of_information(labels_true, labels_pred):
    """VI(z, z') = H(z) + H(z') - 2 I(z, z')."""
    return (entropy(labels_true) + entropy(labels_pred)
            - 2.0 * mutual_info_score(labels_true, labels_pred))


def _flat_post_burn(arr, n_burn, n_chains):
    """Post-burn samples pooled over chains: (S, ...) or (C, S, ...) traces
    -> (S', ...)."""
    arr = np.asarray(arr)
    if n_chains > 1:
        return arr[:, n_burn:].reshape((-1,) + arr.shape[2:])
    return arr[n_burn:]


def posterior_mean_probas(model, max_samples=2000):
    """Posterior-mean edge-probability tensor (T, n, n): the Monte-Carlo
    average of p_ij^(s) over the stored post-burn draws (chains pooled, at
    most ``max_samples`` evenly thinned draws)."""
    n_chains = getattr(model, 'n_chains', 1)
    nb = model.n_burn_
    Xs = _flat_post_burn(model.Xs_, nb, n_chains)        # (S, T, n, d)
    bs = _flat_post_burn(model.intercepts_, nb, n_chains)
    step = max(1, Xs.shape[0] // max_samples)
    Xs, bs = Xs[::step], bs[::step]
    if model.is_directed:
        radii = _flat_post_burn(model.radiis_, nb, n_chains)[::step]
    S, T, n, _ = Xs.shape
    total = np.zeros((T, n, n))
    for s in range(S):
        diff = Xs[s][:, :, None, :] - Xs[s][:, None, :, :]
        dist = np.sqrt(np.sum(diff * diff, axis=-1))     # (T, n, n)
        if model.is_directed:
            r = radii[s]
            eta = (bs[s][0] * (1.0 - dist / r[None, None, :])
                   + bs[s][1] * (1.0 - dist / r[None, :, None]))
        else:
            eta = bs[s][0] - dist
        total += expit(eta)
    probas = total / S
    for t in range(T):
        np.fill_diagonal(probas[t], 0.0)
    return probas


def posterior_mean_auc(model, max_samples=2000):
    """In-sample AUC of :func:`posterior_mean_probas`."""
    return network_auc(model.Y_fit_, posterior_mean_probas(model,
                                                           max_samples),
                       is_directed=model.is_directed)
