"""Visualization layer: traces, latent spaces, alluvial community flows,
co-occurrence heatmaps, transition matrices (counterpart of
``dynetlsm_tpu/plots.py``, on the port's fitted estimators).

Covers the reference's plotting surface (reference dynetlsm/plots.py:34-42:
plot_network_pyvis, plot_latent_space, plot_probability_matrix, plot_traces,
plot_posterior_counts, plot_transition_probabilities,
plot_adjacency_matrix, alluvial_plot, plus plot_posterior_cooccurrence and
the per-model trace/latent variants) with a shared palette/axes toolkit.
All functions run on fetched host arrays.

Needs matplotlib (and SciPy); seaborn (``get_husl``, more than 20 groups)
and pyvis (``plot_network_pyvis``) are optional and imported inside their
functions.  ``dynetlsm_tpu_torch/__init__.py`` does not import this
module, so the package runs where matplotlib is absent.
"""
import numpy as np
import matplotlib.pyplot as plt
import scipy.cluster.hierarchy as hc

from matplotlib.colors import to_hex
from matplotlib.patches import Ellipse, Rectangle, FancyArrowPatch
from matplotlib.ticker import MaxNLocator
from scipy.interpolate import CubicSpline
from scipy.spatial.distance import squareform

from .diagnostics import effective_n, autocorrelation
from .network_statistics import connected_nodes
from .text_utils import repel_labels

__all__ = ['plot_network_pyvis',
           'plot_latent_space',
           'plot_probability_matrix',
           'plot_traces',
           'plot_posterior_counts',
           'plot_transition_probabilities',
           'plot_adjacency_matrix',
           'plot_posterior_cooccurrence',
           'alluvial_plot',
           'normal_contour',
           'get_colors',
           'get_husl',
           'get_color20',
           'cmap_to_hex',
           'flatten',
           'arrow_patch']


# ---------------------------------------------------------------------------
# palette helpers
# ---------------------------------------------------------------------------

def flatten(nested):
    """One-level list flatten (reference plots.py:44-45)."""
    return [item for sublist in nested for item in sublist]


def cmap_to_hex(cmap):
    """Hex strings for a listed colormap's colors (reference plots.py:48-49)."""
    return np.asarray([to_hex(c) for c in cmap.colors])


def get_color20():
    """The tab20 hex palette with the low-contrast first pair swapped
    (reference plots.py:52-60)."""
    colors = cmap_to_hex(plt.get_cmap('tab20'))
    colors[1], colors[2] = colors[2], colors[1]
    return colors


_tab20_hex = get_color20


def get_husl(n_groups):
    """Evenly-spaced HUSL hex palette for > 20 groups
    (reference plots.py:63-65)."""
    import seaborn as sns
    return np.asarray([to_hex(c)
                       for c in sns.color_palette('husl', n_groups)])


def get_colors(labels):
    """Hex colors per distinct label: tab20 for <= 20 groups, husl beyond."""
    n_groups = int(np.max(labels)) + 1 if np.size(labels) else 1
    if n_groups <= 20:
        return _tab20_hex()[:max(n_groups, 2)]
    return get_husl(n_groups)


def _is_mixture_model(model):
    return hasattr(model, 'z_')


# ---------------------------------------------------------------------------
# geometric primitives
# ---------------------------------------------------------------------------

def normal_contour(mean, cov, n_std=2, ax=None, **kwargs):
    """Draw n_std covariance ellipse(s) of a 2-D Gaussian
    (reference plots.py:76-111)."""
    if ax is None:
        ax = plt.gca()
    cov = np.atleast_2d(cov)
    if cov.shape == (1, 1):
        cov = float(cov) * np.eye(2)
    evals, evecs = np.linalg.eigh(cov)
    angle = np.degrees(np.arctan2(evecs[1, -1], evecs[0, -1]))
    ellipses = []
    for k in np.atleast_1d(n_std):
        width, height = 2 * k * np.sqrt(np.maximum(evals, 0.0))
        ellipse = Ellipse(xy=mean, width=width[-1] if width.ndim else width,
                          height=height[0] if height.ndim else height,
                          angle=angle, **kwargs)
        ax.add_patch(ellipse)
        ellipses.append(ellipse)
    # reference return contract (plots.py:100-111): the patch for a scalar
    # n_std, the list for a sequence
    return ellipses[0] if np.isscalar(n_std) else ellipses


def draw_edge(x1, x2, ax, is_directed=False, **kwargs):
    if is_directed:
        ax.add_patch(FancyArrowPatch(x1, x2, arrowstyle='-|>',
                                     mutation_scale=10, shrinkA=8, shrinkB=8,
                                     **kwargs))
    else:
        ax.plot([x1[0], x2[0]], [x1[1], x2[1]], **kwargs)


def arrow_patch(x1, x2, source_size, target_size, ax, **kwargs):
    """Directed-edge arrow shrunk clear of its endpoint markers
    (reference plots.py:526-536)."""
    arrow = FancyArrowPatch(x1, x2,
                            shrinkA=np.sqrt(source_size) / 2,
                            shrinkB=np.sqrt(target_size) / 2,
                            **kwargs)
    ax.add_patch(arrow)
    return arrow


# ---------------------------------------------------------------------------
# trace diagnostics
# ---------------------------------------------------------------------------

def _kde_curve(values, n_grid=200):
    """Gaussian KDE with Scott's-rule bandwidth; returns (grid, density).
    Degenerate (zero-variance) samples get a single spike bin."""
    values = np.ravel(values).astype(float)
    sd = values.std()
    if sd == 0.0 or len(values) < 2:
        grid = np.array([values[0] - 0.5, values[0], values[0] + 0.5])
        return grid, np.array([0.0, 1.0, 0.0])
    bw = sd * len(values) ** (-1.0 / 5.0)
    lo, hi = values.min() - 3 * bw, values.max() + 3 * bw
    grid = np.linspace(lo, hi, n_grid)
    z = (grid[:, None] - values[None, :]) / bw
    dens = np.exp(-0.5 * z * z).sum(axis=1) / (len(values) * bw
                                               * np.sqrt(2 * np.pi))
    return grid, dens


def _trace_panel(ax_trace, ax_kde, ax_acf, values, name, n_burn, maxlags,
                 fontsize):
    """One parameter's diagnostics row: trace, marginal posterior density
    (KDE), autocorrelation — the reference's plot_traces panel set
    (reference plots.py:175-397, KDE column at :232-236)."""
    values = np.ravel(values)
    ax_trace.plot(values, lw=0.7, color='#333333')
    if n_burn:
        ax_trace.axvline(n_burn, color='crimson', ls='--', lw=1)
    ess = effective_n(values[n_burn:], maxlags=maxlags)
    ax_trace.set_ylabel(name, fontsize=fontsize)
    ax_trace.set_title('ESS = %.1f' % ess, fontsize=fontsize, loc='right')

    grid, dens = _kde_curve(values[n_burn:])
    ax_kde.fill_between(grid, dens, color='#7788aa', alpha=0.4)
    ax_kde.plot(grid, dens, color='#445577', lw=1.0)
    ax_kde.axvline(float(np.mean(values[n_burn:])), color='crimson', ls='--',
                   lw=0.8)
    ax_kde.set_ylabel('p(%s)' % name, fontsize=fontsize)

    rho = autocorrelation(values[n_burn:], maxlags=maxlags)
    ax_acf.bar(np.arange(rho.shape[0]), rho, width=1.0, color='#7788aa')
    ax_acf.axhline(0.0, color='k', lw=0.5)
    ax_acf.set_ylabel('acf(%s)' % name, fontsize=fontsize)


def plot_traces(model, figsize=(10, 12), maxlags=100, fontsize=8):
    """Trace + autocorrelation panels for the model's scalar chains
    (reference plots.py:175-397).  Dispatches on the fitted model type."""
    if _is_mixture_model(model):
        return plot_traces_hdp_lpcm(model, figsize=figsize, maxlags=maxlags,
                                    fontsize=fontsize)
    return plot_traces_lsm(model, figsize=figsize, maxlags=maxlags,
                           fontsize=fontsize)


def _first_chain(arr, n_chains):
    return arr if n_chains == 1 else arr[0]


def plot_traces_lsm(model, figsize=(10, 6), maxlags=100, fontsize=8):
    n_chains = getattr(model, 'n_chains', 1)
    logps = _first_chain(model.logps_, n_chains)
    intercepts = _first_chain(model.intercepts_, n_chains)
    n_burn = model.n_burn_

    series = [('logp', logps)]
    if model.is_directed:
        series += [('intercept_in', intercepts[:, 0]),
                   ('intercept_out', intercepts[:, 1])]
    else:
        series += [('intercept', intercepts[:, 0])]

    fig, axes = plt.subplots(len(series), 3, figsize=figsize, squeeze=False)
    for row, (name, values) in enumerate(series):
        _trace_panel(axes[row, 0], axes[row, 1], axes[row, 2], values,
                     name, n_burn, maxlags, fontsize)
    fig.tight_layout()
    return fig, axes


def plot_traces_hdp_lpcm(model, figsize=(10, 12), maxlags=100, fontsize=8):
    n_chains = getattr(model, 'n_chains', 1)
    logps = _first_chain(model.logps_, n_chains)
    intercepts = _first_chain(model.intercepts_, n_chains)
    lambdas = _first_chain(model.lambdas_, n_chains)
    n_burn = model.n_burn_

    series = [('logp', np.where(np.isfinite(logps), logps,
                                np.nanmin(logps[np.isfinite(logps)])))]
    if model.is_directed:
        series += [('intercept_in', intercepts[:, 0]),
                   ('intercept_out', intercepts[:, 1])]
    else:
        series += [('intercept', intercepts[:, 0])]
    series += [('lambda', np.ravel(lambdas))]
    for extra in ('gammas_', 'kappas_'):
        if hasattr(model, extra):
            series.append((extra.rstrip('_'),
                           np.ravel(_first_chain(getattr(model, extra),
                                                 n_chains))))

    fig, axes = plt.subplots(len(series), 3, figsize=figsize, squeeze=False)
    for row, (name, values) in enumerate(series):
        _trace_panel(axes[row, 0], axes[row, 1], axes[row, 2], values,
                     name, n_burn, maxlags, fontsize)
    fig.tight_layout()
    return fig, axes


# ---------------------------------------------------------------------------
# matrices
# ---------------------------------------------------------------------------

def _grouped_matrix_plot(M, z, figsize, cmap, cbar_label):
    order = np.argsort(np.asarray(z))
    fig, ax = plt.subplots(figsize=figsize)
    im = ax.imshow(np.asarray(M)[np.ix_(order, order)], cmap=cmap,
                   interpolation='nearest')
    # group boundaries
    sorted_z = np.asarray(z)[order]
    bounds = np.where(np.diff(sorted_z) != 0)[0]
    for b in bounds:
        ax.axhline(b + 0.5, color='white', lw=1)
        ax.axvline(b + 0.5, color='white', lw=1)
    fig.colorbar(im, ax=ax, label=cbar_label)
    return fig, ax


def plot_probability_matrix(probas, z, figsize=(10, 6), cmap='viridis'):
    """Connection-probability matrix ordered by community
    (reference plots.py:152-172)."""
    return _grouped_matrix_plot(probas, z, figsize, cmap, 'P(edge)')


def plot_adjacency_matrix(Y, z, figsize=(8, 6)):
    """Adjacency matrix ordered by community (reference plots.py:995-1021)."""
    return _grouped_matrix_plot(Y, z, figsize, 'Greys', 'edge')


def plot_posterior_cooccurrence(model, t=0, figsize=(8, 6), cmap='viridis'):
    """Posterior co-clustering probability heatmap, hierarchically ordered
    (reference plots.py:950-992; the reference returns a seaborn
    ClusterGrid — here the same average-linkage leaf ordering is applied
    directly and a plain ``(fig, ax)`` is returned)."""
    co = model.cooccurrence_probas_[t]
    linkage = hc.linkage(squareform(1.0 - co, checks=False),
                         method='average', optimal_ordering=True)
    order = hc.leaves_list(linkage)
    fig, ax = plt.subplots(figsize=figsize)
    im = ax.imshow(co[np.ix_(order, order)], cmap=cmap, vmin=0, vmax=1)
    fig.colorbar(im, ax=ax, label='P(same community)')
    ax.set_title('t = %d' % t)
    return fig, ax


# ---------------------------------------------------------------------------
# posterior summaries
# ---------------------------------------------------------------------------

def plot_posterior_counts(model, t=0, bar_width=0.25, normalize=True,
                          figsize=(8, 5), fontsize=12):
    """Posterior distribution of the number of occupied communities at time t
    (reference plots.py:400-431)."""
    index = model.posterior_group_ids_[t]
    counts = model.posterior_group_counts_[t].astype(np.float64)
    if normalize:
        counts = counts / counts.sum()
    fig, ax = plt.subplots(figsize=figsize)
    ax.bar(index, counts, width=bar_width, color='#55778899',
           edgecolor='#334455')
    ax.set_xlabel('number of communities', fontsize=fontsize)
    ax.set_ylabel('posterior probability' if normalize else 'count',
                  fontsize=fontsize)
    ax.xaxis.set_major_locator(MaxNLocator(integer=True))
    ax.set_title('t = %d' % t, fontsize=fontsize)
    return fig, ax


def plot_transition_probabilities(model, figsize=(10, 8), fontsize=8,
                                  cmap='Blues'):
    """Heatmaps of the per-time transition matrices of the selected model
    (reference plots.py:434-515)."""
    trans = np.asarray(model.trans_weights_)
    if trans.ndim == 2:
        trans = trans[None]
    T = trans.shape[0]
    start = 1 if T > 1 else 0
    n_panels = max(T - start, 1)
    ncols = min(n_panels, 3)
    nrows = -(-n_panels // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=figsize, squeeze=False)
    for i in range(n_panels):
        ax = axes[i // ncols][i % ncols]
        M = trans[start + i]
        im = ax.imshow(M, cmap=cmap, vmin=0, vmax=1)
        for (r, c), v in np.ndenumerate(M):
            ax.text(c, r, '%.2f' % v, ha='center', va='center',
                    fontsize=fontsize,
                    color='white' if v > 0.5 else 'black')
        ax.set_title('t = %d -> t = %d' % (start + i - 1, start + i),
                     fontsize=fontsize)
    for j in range(n_panels, nrows * ncols):
        axes[j // ncols][j % ncols].axis('off')
    fig.colorbar(im, ax=axes, shrink=0.7)
    return fig, axes


# ---------------------------------------------------------------------------
# latent space
# ---------------------------------------------------------------------------

def plot_latent_space(model, t=0, **kwargs):
    """Latent-space embedding at time t; dispatches on model type
    (reference plots.py:538-546)."""
    if _is_mixture_model(model):
        return plot_latent_space_lpcm(model, t=t, **kwargs)
    return plot_latent_space_lsm(model, t=t, **kwargs)


def _edge_collection(ax, Y_t, X_t, is_directed, alpha=0.15):
    rows, cols = np.nonzero(np.asarray(Y_t))
    for i, j in zip(rows, cols):
        if not is_directed and i > j:
            continue
        draw_edge(X_t[i], X_t[j], ax, is_directed=is_directed,
                  color='gray', alpha=alpha, lw=0.5, zorder=1)


def plot_latent_space_lsm(model, t=0, figsize=(8, 8), node_size=60,
                          with_edges=True, node_names=None,
                          only_connected=True, repel_strength=0.05, ax=None):
    """(reference plots.py:548-652)"""
    if ax is None:
        _, ax = plt.subplots(figsize=figsize)
    X = model.X_[t]
    Y_t = model.Y_fit_[t]
    mask = (connected_nodes(Y_t, is_directed=model.is_directed)
            if only_connected else np.ones(X.shape[0], dtype=bool))
    if mask.dtype != bool:
        sel = np.zeros(X.shape[0], dtype=bool)
        sel[mask] = True
        mask = sel

    if with_edges:
        _edge_collection(ax, Y_t[np.ix_(mask, mask)], X[mask],
                         model.is_directed)
    sizes = node_size
    if model.is_directed and hasattr(model, 'radii_'):
        sizes = node_size * model.radii_[mask] / model.radii_.max()
    ax.scatter(X[mask, 0], X[mask, 1], s=sizes, c='#4477aa', zorder=2,
               edgecolor='white', lw=0.5)
    if node_names is not None:
        repel_labels(ax, X[mask, 0], X[mask, 1],
                     np.asarray(node_names)[mask], k=repel_strength)
    ax.set_title('t = %d' % t)
    ax.set_aspect('equal', adjustable='datalim')
    return ax.figure, ax


def plot_latent_space_lpcm(model, t=0, figsize=(8, 8), node_size=60,
                           with_edges=True, node_names=None,
                           only_connected=True, n_std=2,
                           repel_strength=0.05, ax=None):
    """Embedding with community colors + cluster covariance ellipses
    (reference plots.py:655-818)."""
    if ax is None:
        _, ax = plt.subplots(figsize=figsize)
    X = model.X_[t]
    z = model.z_[t]
    Y_t = model.Y_fit_[t]
    mask = (connected_nodes(Y_t, is_directed=model.is_directed)
            if only_connected else np.ones(X.shape[0], dtype=bool))
    if mask.dtype != bool:
        sel = np.zeros(X.shape[0], dtype=bool)
        sel[mask] = True
        mask = sel

    colors = get_colors(z)
    if with_edges:
        _edge_collection(ax, Y_t[np.ix_(mask, mask)], X[mask],
                         model.is_directed)
    sizes = node_size
    if model.is_directed and hasattr(model, 'radii_'):
        sizes = node_size * model.radii_[mask] / model.radii_.max()
    ax.scatter(X[mask, 0], X[mask, 1], s=sizes, c=colors[z[mask]],
               zorder=2, edgecolor='white', lw=0.5)

    active = np.unique(z)
    mu = np.asarray(model.mu_)
    sigma = np.asarray(model.sigma_)
    for g in active:
        if g < mu.shape[0]:
            normal_contour(mu[g], sigma[g] * np.eye(2), n_std=n_std, ax=ax,
                           facecolor=colors[g], alpha=0.15, zorder=0,
                           edgecolor=colors[g])
            ax.scatter(*mu[g], marker='x', c=colors[g], s=80, zorder=3)
    if node_names is not None:
        repel_labels(ax, X[mask, 0], X[mask, 1],
                     np.asarray(node_names)[mask], k=repel_strength)
    ax.set_title('t = %d' % t)
    ax.set_aspect('equal', adjustable='datalim')
    return ax.figure, ax


# ---------------------------------------------------------------------------
# alluvial community-flow diagram
# ---------------------------------------------------------------------------

def transition_freqs(z0, z1, n_groups):
    """Row-normalised label-flow frequencies between consecutive snapshots
    (reference plots.py:820-841)."""
    freq = np.zeros((n_groups, n_groups))
    for a, b in zip(np.asarray(z0), np.asarray(z1)):
        freq[a, b] += 1
    totals = freq.sum(axis=1, keepdims=True)
    with np.errstate(invalid='ignore', divide='ignore'):
        out = np.where(totals > 0, freq / totals, 0.0)
    return out, freq


def alluvial_plot(z, figsize=(10, 6), margin=0.02, rec_width=0.02, alpha=0.5,
                  ax=None):
    """Community-flow (alluvial) diagram over time: stacked group bars per
    snapshot connected by cubic-spline ribbons proportional to the number of
    nodes flowing between groups (reference plots.py:844-948)."""
    z = np.asarray(z)
    T, n = z.shape
    labels = np.unique(z.ravel(), return_inverse=True)[1].reshape(T, n)
    n_groups = int(labels.max()) + 1
    colors = get_colors(labels)

    if ax is None:
        _, ax = plt.subplots(figsize=figsize)

    # stacked bars: bottom offsets of each group per time
    heights = np.stack([np.bincount(labels[t], minlength=n_groups)
                        for t in range(T)]) / n          # (T, K)
    bottoms = np.zeros((T, n_groups))
    for t in range(T):
        y = 0.0
        for g in range(n_groups):
            bottoms[t, g] = y
            if heights[t, g] > 0:
                y += heights[t, g] + margin
    xs = np.linspace(0.0, 1.0, T)

    for t in range(T):
        for g in range(n_groups):
            if heights[t, g] > 0:
                ax.add_patch(Rectangle((xs[t], bottoms[t, g]), rec_width,
                                       heights[t, g], facecolor=colors[g],
                                       edgecolor='k', lw=0.3, zorder=3))

    # ribbons between consecutive snapshots
    for t in range(T - 1):
        flows = np.zeros((n_groups, n_groups))
        for a, b in zip(labels[t], labels[t + 1]):
            flows[a, b] += 1
        flows /= n
        src_off = bottoms[t].copy()
        dst_off = bottoms[t + 1].copy()
        for a in range(n_groups):
            for b in range(n_groups):
                f = flows[a, b]
                if f <= 0:
                    continue
                x0, x1 = xs[t] + rec_width, xs[t + 1]
                grid = np.linspace(x0, x1, 30)
                lo = CubicSpline([x0, x1], [src_off[a], dst_off[b]],
                                 bc_type='clamped')(grid)
                hi = CubicSpline([x0, x1],
                                 [src_off[a] + f, dst_off[b] + f],
                                 bc_type='clamped')(grid)
                ax.fill_between(grid, lo, hi, color=colors[a], alpha=alpha,
                                lw=0, zorder=1)
                src_off[a] += f
                dst_off[b] += f

    ax.set_xticks(xs + rec_width / 2)
    ax.set_xticklabels(['t = %d' % t for t in range(T)])
    ax.set_yticks([])
    for side in ('left', 'right', 'top'):
        ax.spines[side].set_visible(False)
    ax.set_xlim(-0.02, 1.0 + rec_width + 0.02)
    # reference return contract (plots.py:948): (fig, ax)
    return ax.figure, ax


# ---------------------------------------------------------------------------
# interactive (optional pyvis)
# ---------------------------------------------------------------------------

def plot_network_pyvis(Y, labels=None, output_name='network_vis.html',
                       names=None, height='600px', width='800px'):
    """Interactive HTML network via pyvis (reference plots.py:114-149).
    Requires the optional ``pyvis`` dependency."""
    try:
        import pyvis.network as pyvis
    except ImportError as err:  # pragma: no cover - optional dependency
        raise ImportError('plot_network_pyvis requires pyvis') from err

    Y = np.asarray(Y)
    n = Y.shape[0]
    colors = get_colors(labels if labels is not None else np.zeros(n, int))
    net = pyvis.Network(height=height, width=width)
    for i in range(n):
        net.add_node(int(i),
                     label=str(names[i]) if names is not None else str(i),
                     color=colors[int(labels[i])] if labels is not None
                     else colors[0])
    for i, j in zip(*np.nonzero(Y)):
        net.add_edge(int(i), int(j))
    net.show(output_name)
    return net
