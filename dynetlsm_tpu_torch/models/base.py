"""Network validation (counterpart of ``validate_network`` in
``dynetlsm_tpu/models/base.py``), in NumPy alone: the JAX package's module
imports jax."""
import numpy as np

from ..array_utils import nondiag_indices_from_3d, triu_indices_from_3d


def validate_network(Y, is_directed, copy=True):
    """Validate the dynamic adjacency tensor and locate missing dyads.

    Returns (Y float64 array, nan_mask over the dyad vector, miss_mask
    (T, n, n) boolean array, sample_missing flag).  Missing dyads are coded
    -1 (NaNs are converted), as in reference lsm.py:341-360; the dyad
    vector is the upper triangle (undirected) or every off-diagonal entry
    (directed), and ``miss_mask`` is symmetrised when undirected, with a
    false diagonal.
    """
    # NumPy 2 made copy=False mean "never copy"; copy=None copies only if
    # needed
    Y = np.array(Y, dtype=np.float64, copy=True if copy else None)
    if Y.ndim != 3 or Y.shape[1] != Y.shape[2]:
        raise ValueError('Y must have shape (n_time_steps, n_nodes, n_nodes), '
                         'got %r' % (Y.shape,))
    Y[np.isnan(Y)] = -1.0

    if is_directed:
        indices = nondiag_indices_from_3d(Y)
    else:
        indices = triu_indices_from_3d(Y, k=1)
    nan_mask = Y[indices] == -1

    miss_mask = Y == -1
    if not is_directed:
        miss_mask |= np.swapaxes(miss_mask, 1, 2)
    for t in range(Y.shape[0]):
        np.fill_diagonal(miss_mask[t], False)

    return Y, nan_mask, miss_mask, bool(nan_mask.any())
