"""Label placement for latent-space plots (counterpart of
``dynetlsm_tpu/text_utils.py``).

Provides the same capability as the reference's ``repel_labels``
(dynetlsm/text_utils.py:5-55, a networkx spring-layout pass): text labels
are pushed away from each other and from the data points while staying
tethered to their anchors.  Implemented here as a small vectorized
force-relaxation directly in NumPy — no graph library needed.
"""
import numpy as np


def _relax(anchors, k, n_steps=50, step=0.1):
    """Force-directed label offsets: labels repel one another (and every
    anchor) with an inverse-square force of range ``k`` and are pulled back
    toward their own anchor by a unit spring.  Returns label positions."""
    m = anchors.shape[0]
    rng = np.random.RandomState(0)
    # tiny deterministic jitter so coincident labels separate
    pos = anchors + 1e-3 * k * rng.randn(m, 2)
    k2 = k * k
    for _ in range(n_steps):
        # pairwise repulsion from other labels and from all anchors
        others = np.concatenate([pos, anchors], axis=0)   # (2m, 2)
        diff = pos[:, None, :] - others[None, :, :]        # (m, 2m, 2)
        d2 = np.einsum('ijk,ijk->ij', diff, diff)
        np.fill_diagonal(d2[:, :m], np.inf)                # self-pairs
        d2[np.arange(m), m + np.arange(m)] = np.inf        # own anchor
        push = (diff * (k2 / np.maximum(d2, 1e-12))[..., None]).sum(axis=1)
        pull = anchors - pos
        force = push + pull
        # cap displacement per step at k for stability
        norm = np.sqrt(np.einsum('ij,ij->i', force, force))
        cap = np.minimum(norm, k) / np.maximum(norm, 1e-12)
        pos = pos + step * cap[:, None] * force
    return pos


def repel_labels(ax, x, y, labels, k=0.01, fontsize=9, color='k'):
    """Annotate the points ``(x, y)`` with ``labels`` nudged apart so they
    do not overlap, with a thin gray leader line back to each anchor.

    Same signature and behavior as the reference helper
    (dynetlsm/text_utils.py:5-55); ``k`` is the repulsion range in data
    units.
    """
    anchors = np.column_stack([np.asarray(x, float), np.asarray(y, float)])
    placed = _relax(anchors, k=max(float(k), 1e-12))

    for (ax_x, ax_y), (lx, ly), label in zip(anchors, placed, labels):
        ax.annotate(label,
                    xy=(ax_x, ax_y), xycoords='data',
                    xytext=(lx, ly), textcoords='data',
                    fontsize=fontsize, color=color,
                    arrowprops=dict(arrowstyle='-',
                                    shrinkA=0, shrinkB=0,
                                    connectionstyle='arc3',
                                    color='gray', alpha=0.3))
    return ax
