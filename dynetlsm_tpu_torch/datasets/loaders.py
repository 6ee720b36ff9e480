"""Real-data loaders (counterpart of ``dynetlsm_tpu/datasets/loaders.py``):
Sampson's monastery, Game of Thrones and the Cold-War military alliances,
in NumPy and the ``csv`` module.

They read the raw files shipped with the JAX package
(``dynetlsm_tpu/datasets/raw_data/``) in place, as files: importing that
package would load jax, and its loaders need scikit-learn, pandas and
networkx.  The same preprocessing gives the same arrays:
``LabelEncoder`` becomes ``np.unique(..., return_inverse=True)``, pandas'
csv reading and group sums a sort and a sum, networkx's ``core_number``
:func:`core_number`.
"""
import csv
import glob
import os

import numpy as np

RAW = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'dynetlsm_tpu', 'datasets', 'raw_data')


def load_dynamic_monks(is_directed=False):
    """The three-wave Sampson liking networks (T=3, n=18) as float64: the
    raw directed waves, or made undirected by symmetrisation (reference
    load_monks.py:22-49)."""
    return _monk_networks(True, is_directed)


def _monk_networks(dynamic, is_directed):
    files = (['sampson_%d.npy' % t for t in range(3)] if dynamic
             else ['sampson.npy'])
    Y = np.stack([np.loadtxt(os.path.join(RAW, f))
                  for f in files]).astype(np.float64)
    if not is_directed:
        Y = ((Y + Y.transpose(0, 2, 1)) > 0).astype(np.float64)
    return Y if dynamic else Y[0]


def _lines(path):
    with open(path) as f:
        return np.array([line.rstrip('\n') for line in f])


def load_monks(dynamic=True, is_directed=True, include_waverers=False,
               encode_labels=True):
    """Sampson's monastery network (1968) with the JAX loader's arguments
    and results (reference load_monks.py:11-71): the three liking waves
    (T=3, n=18) with their faction labels repeated per wave and the monk
    names, or (``dynamic=False``) the aggregated network and the labels.
    Labels are strings, or their indices in sorted order."""
    groups = _lines(os.path.join(RAW, 'sampson_groups_waverers.txt'
                                 if include_waverers else
                                 'sampson_groups.txt'))
    if encode_labels:
        groups = np.unique(groups, return_inverse=True)[1]
    Y = _monk_networks(dynamic, is_directed)
    if not dynamic:
        return Y, groups
    return (Y, np.repeat(groups[None], 3, axis=0),
            _lines(os.path.join(RAW, 'sampson_names.txt')))


def load_static_monks(encode_labels=True, include_waverers=False,
                      is_directed=True):
    """The aggregated single-wave (n=18) monastery network and its faction
    labels (reference load_monks.py:52-71)."""
    return load_monks(dynamic=False, is_directed=is_directed,
                      include_waverers=include_waverers,
                      encode_labels=encode_labels)


def network_from_edgelist(edgelist, n_nodes):
    """Symmetric binary adjacency from an (n_edges, 2) integer edge list
    (reference load_got.py:16-25)."""
    Y = np.zeros((n_nodes, n_nodes))
    Y[edgelist[:, 0], edgelist[:, 1]] = 1.0
    return ((Y + Y.T) > 0).astype(np.float64)


def _got_edges():
    """The per-season GoT co-occurrence edges, their weights summed per
    (source, target, season): (source, target) str arrays, season and
    weight int arrays (reference load_got.py:28-42)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(RAW, 'got',
                                              'got-s*-edges.csv'))):
        with open(path, newline='') as f:
            rows += list(csv.reader(f))[1:]
    src, tgt, weight, season = (np.array(col) for col in zip(*rows))
    keys, inverse = np.unique(np.stack([src, tgt, season]), axis=1,
                              return_inverse=True)
    summed = np.bincount(inverse.ravel(), weights=weight.astype(np.int64))
    return keys[0], keys[1], keys[2].astype(np.int64), summed


def load_got_edgelists():
    """Per-season GoT co-occurrence edge lists as one pandas dataframe
    with summed weights (reference load_got.py:28-42); pandas is imported
    here, as the JAX loader does."""
    import pandas as pd

    frames = [pd.read_csv(path, names=['source', 'target', 'weight',
                                       'season'], skiprows=1)
              for path in sorted(glob.glob(os.path.join(
                  RAW, 'got', 'got-s*-edges.csv')))]
    return pd.concat(frames).groupby(['source', 'target', 'season'],
                                     as_index=False).agg({'weight': 'sum'})


def load_got(seasons=None, weight_min=None):
    """Game of Thrones co-occurrence networks, one snapshot per season
    (reference load_got.py:45-67).  Returns (Y, character names)."""
    src, tgt, season, weight = _got_edges()
    keep = np.ones(src.shape[0], bool)
    if seasons is not None:
        keep &= np.isin(season, np.atleast_1d(seasons))
    if weight_min is not None:
        keep &= weight >= weight_min
    src, tgt, season = src[keep], tgt[keep], season[keep]

    names = np.unique(np.concatenate([src, tgt]))
    src = np.searchsorted(names, src)
    tgt = np.searchsorted(names, tgt)
    n = names.shape[0]
    season_vals = np.unique(season)
    Y = np.zeros((season_vals.shape[0], n, n))
    for t, s in enumerate(season_vals):
        mask = season == s
        Y[t] = network_from_edgelist(np.stack([src[mask], tgt[mask]], 1), n)
    return Y, names


def core_number(A):
    """The k-core number of each node of the undirected graph with
    adjacency A (n, n), nonzero an edge, no self-loops (networkx's
    ``core_number``): nodes of degree at most k are peeled, their
    neighbours' degrees lowered, until none is left at k; each peeled
    node's core is that k."""
    A = np.asarray(A) != 0
    deg = A.sum(axis=1)
    core = np.zeros(A.shape[0], np.int64)
    alive = np.ones(A.shape[0], bool)
    k = 0
    while alive.any():
        k = max(k, int(deg[alive].min()))
        peel = alive & (deg <= k)
        while peel.any():
            core[peel] = k
            alive &= ~peel
            deg = deg - A[:, peel].sum(axis=1)
            peel = alive & (deg <= k)
    return core


def load_alliances(min_degree=1, directed=False, remove_periphery=True):
    """Cold-War military alliances, 1950-1975 in 5-year snapshots
    (reference load_alliances.py:11-53): undirected, the nodes of core
    number at most 2 in a snapshot cut from it, then the nodes below
    ``min_degree`` over all snapshots dropped.  Returns (Y, country
    names)."""
    base = os.path.join(RAW, 'military_alliances')
    if directed:
        raise NotImplementedError(
            'directed alliance networks are not shipped with the raw data')
    years = list(range(1950, 1980, 5))
    Y = np.stack([np.loadtxt(os.path.join(base, 'network_%d.npy' % y))
                  for y in years])
    Y = (Y > 0).astype(np.float64)
    Y = (((Y + Y.transpose(0, 2, 1)) / 2.0) > 0).astype(np.float64)

    if remove_periphery:
        for t in range(Y.shape[0]):
            periphery = np.where(core_number(Y[t]) <= 2)[0]
            Y[t, periphery] = 0.0
            Y[t, :, periphery] = 0.0

    active = np.where(
        (Y.sum(axis=(0, 1)) + Y.sum(axis=(0, 2))) >= min_degree)[0]
    Y = np.ascontiguousarray(Y[:, active][:, :, active])

    with open(os.path.join(base, 'names.csv'), newline='') as f:
        names = np.array([row[0] for row in list(csv.reader(f))[1:]],
                         dtype=object)
    return Y, names[active]
