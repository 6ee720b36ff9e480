"""Descriptive network statistics (counterpart of
``dynetlsm_tpu/network_statistics.py``, reference
dynetlsm/network_statistics.py), in NumPy and SciPy."""
import numpy as np
from scipy.sparse import csgraph


def is_dynamic(Y):
    return np.ndim(Y) == 3


def num_edges(Y, is_directed=False):
    total = np.sum(Y)
    return total if is_directed else 0.5 * total


def density(Y, is_directed=False):
    """Edge density over all snapshots (reference network_statistics.py:17-28)."""
    Y = np.asarray(Y)
    n = Y.shape[1] if is_dynamic(Y) else Y.shape[0]
    n_possible = n * (n - 1)
    if is_dynamic(Y):
        n_possible *= Y.shape[0]
    if not is_directed:
        n_possible *= 0.5
    return num_edges(Y, is_directed) / n_possible


def static_modularity(Y, z, is_directed=False):
    """Newman modularity of one snapshot under labels z
    (reference network_statistics.py:43-61)."""
    Y = np.asarray(Y, dtype=np.float64)
    if is_directed:
        n_edges = Y.sum()
        degree = 0.5 * (Y.sum(axis=0) + Y.sum(axis=1))
    else:
        n_edges = Y.sum() / 2
        degree = Y.sum(axis=0)
    degree = degree.reshape(-1, 1)

    groups = np.unique(np.asarray(z), return_inverse=True)[1].ravel()
    n_groups = int(groups.max()) + 1
    A = 0.5 * (Y + Y.T) if is_directed else Y
    B = A - degree @ degree.T / (2 * n_edges)
    S = np.eye(n_groups)[groups]
    return np.trace(S.T @ B @ S) / (2 * n_edges)


def modularity(Y, z, is_directed=False):
    """Snapshot-averaged modularity for dynamic networks
    (reference network_statistics.py:31-40)."""
    if is_dynamic(Y):
        return np.mean([static_modularity(Y[t], z[t], is_directed)
                        for t in range(Y.shape[0])])
    return static_modularity(Y, z, is_directed)


def connected_nodes(Y, is_directed=False, size_cutoff=1):
    """Mask of nodes in weak components larger than ``size_cutoff``
    (reference network_statistics.py:64-76)."""
    n_components, labels = csgraph.connected_components(
        Y, directed=is_directed, connection='weak')
    if n_components == 1:
        return np.arange(Y.shape[1])
    sizes = np.bincount(labels)
    keep = np.where(sizes > size_cutoff)[0]
    return np.isin(labels, keep)
