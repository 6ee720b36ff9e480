"""The synthetic networks of the sweep's headline shapes, in NumPy alone.

* :func:`northstar_network` is the synthetic community network at the
  north-star scale (T=10, n=500), a copy of ``bench.py``'s generator;
  :func:`northstar_probas` its edge probabilities.
* :func:`northstar_edge_lists` is the same community model at any n (n =
  20,000 in the case-control benchmark), drawn directly as padded edge
  lists: no dense (T, n, n) array exists.
* :func:`with_missing_dyads` codes a seeded random share of a network's
  dyads as missing (-1).
"""
import numpy as np


def _community_probas(rng, n, n_groups):
    """The generator's edge probabilities (n, n): 0.1 within one of
    ``n_groups`` uniformly drawn communities, 0.01 across."""
    z = rng.randint(0, n_groups, size=n)
    return np.where(z[:, None] == z[None, :], 0.1, 0.01)


def northstar_probas(n=500, n_groups=8, seed=3):
    """The edge probabilities (n, n) that :func:`northstar_network` draws
    its dyads from."""
    return _community_probas(np.random.RandomState(seed), n, n_groups)


def northstar_network(T=10, n=500, n_groups=8, seed=3, directed=False):
    """Synthetic community network at the north-star scale: undirected,
    or directed with a zero diagonal; uint8 (T, n, n), the draws of
    bench.py's float32 generator (0.67 GB at n = 8,192, not 2.7)."""
    rng = np.random.RandomState(seed)
    P = _community_probas(rng, n, n_groups)
    Y = np.zeros((T, n, n), np.uint8)
    for t in range(T):
        draw = (rng.uniform(size=(n, n)) < P).astype(np.uint8)
        if directed:
            np.fill_diagonal(draw, 0)
            Y[t] = draw
        else:
            upper = np.triu(draw, 1)
            Y[t] = upper + upper.T
    return Y


def _distinct_uniform(rng, N, count):
    """``count`` distinct integers from [0, N), a uniformly random subset:
    the first distinct values of an iid uniform stream (sampling without
    replacement), drawn in rounds until there are enough."""
    out = np.empty(0, np.int64)
    while out.size < count:
        need = count - out.size
        cat = np.concatenate([out, rng.randint(0, N, size=need + need // 8
                                               + 16, dtype=np.int64)])
        _, first = np.unique(cat, return_index=True)
        out = cat[np.sort(first)]
    return out[:count]


def northstar_edge_lists(T=10, n=20000, n_groups=8, seed=3, directed=True):
    """The community network of ``bench.py::northstar_edge_lists`` drawn
    directly as padded edge lists, for n too large for a dense (T, n, n)
    array (16 GB at n = 20,000).  Returns (lists, (T, n)), lists in
    ``ops.case_control.build_edge_lists``'s layout: ``degrees`` (T, n, 2)
    [in, out], ``in_edges`` / ``out_edges`` (T, n, D) int32, ascending, -1
    padded.

    bench.py's model: nodes in ``n_groups`` uniformly drawn communities;
    edge probabilities 0.1 within a community and 0.01 across, scaled by
    500 / n so the expected degree stays at the north star's; for each
    time and block pair (a, b) (a <= b when undirected) an
    ``rng.binomial`` count of distinct uniform (i in a, j in b) pairs,
    self-loops dropped, each undirected pair stored in both rows (within a
    block, once).  The same communities and counts; the pairs are drawn
    as the first distinct values of an iid stream (:func:`_distinct_uniform`)
    instead of bench.py's ``rng.choice(..., replace=False)``, a full
    permutation of up to 6.25 M pairs per block pair and time (215.6 s at n
    = 20,000).  The random stream differs, so the lists are not bench.py's
    bit for bit: they are draws of the same model."""
    rng = np.random.RandomState(seed)
    z = rng.randint(0, n_groups, size=n)
    members = [np.flatnonzero(z == g) for g in range(n_groups)]
    scale = 500.0 / n
    p_in, p_out = 0.1 * scale, 0.01 * scale

    src_all, dst_all, t_all = [], [], []
    for t in range(T):
        for a in range(n_groups):
            for b in range(n_groups):
                if not directed and b < a:
                    continue
                na, nb = members[a].shape[0], members[b].shape[0]
                count = rng.binomial(na * nb, p_in if a == b else p_out)
                if count == 0:
                    continue
                flat = _distinct_uniform(rng, na * nb, count)
                i = members[a][flat // nb]
                j = members[b][flat % nb]
                keep = i != j
                i, j = i[keep], j[keep]
                if not directed:
                    if a == b:
                        # one entry per unordered pair of the block
                        key = np.minimum(i, j) * n + np.maximum(i, j)
                        _, first = np.unique(key, return_index=True)
                        i, j = i[first], j[first]
                    i, j = np.concatenate([i, j]), np.concatenate([j, i])
                src_all.append(i)
                dst_all.append(j)
                t_all.append(np.full(i.shape[0], t, np.int64))
    src = np.concatenate(src_all)
    dst = np.concatenate(dst_all)
    ts = np.concatenate(t_all)

    degrees = np.zeros((T, n, 2), np.int32)
    np.add.at(degrees[..., 1], (ts, src), 1)         # out-degree
    np.add.at(degrees[..., 0], (ts, dst), 1)         # in-degree

    def fill(row, col):
        order = np.lexsort((col, row, ts))
        t_s, r_s, c_s = ts[order], row[order], col[order]
        run = t_s * n + r_s
        count = np.bincount(run, minlength=T * n)
        lists = np.full((T, n, max(int(count.max()), 1)), -1, np.int32)
        start = np.concatenate([[0], np.cumsum(count)[:-1]])
        lists[t_s, r_s, np.arange(run.shape[0]) - start[run]] = c_s
        return lists

    return {'degrees': degrees, 'in_edges': fill(dst, src),
            'out_edges': fill(src, dst)}, (T, n)


def network_of_edge_lists(lists, shape):
    """The dense uint8 network (T, n, n) of padded edge lists
    (``ops.case_control.build_edge_lists``'s layout, as
    :func:`northstar_edge_lists` draws them): Y[t, i, j] = 1 for each j of
    out_edges[t, i].  The fast way to a dense network of bench.py's model
    at sizes where :func:`northstar_network`'s dense draws take a minute
    (n = 16,384)."""
    T, n = shape
    out = lists['out_edges']
    t, i, k = np.nonzero(out >= 0)
    Y = np.zeros((T, n, n), np.uint8)
    Y[t, i, out[t, i, k]] = 1
    return Y


def with_missing_dyads(Y, fraction=0.1, seed=0, directed=False):
    """A float64 copy of the network Y (T, n, n) with a ``fraction`` of its
    off-diagonal dyads, chosen at random from ``seed``, coded -1: each
    ordered dyad on its own when directed, each unordered pair (both
    entries) when undirected."""
    Y = np.array(Y, dtype=np.float64)
    T, n, _ = Y.shape
    miss = np.random.RandomState(seed).uniform(size=Y.shape) < fraction
    if directed:
        miss &= ~np.eye(n, dtype=bool)
    else:
        miss = np.triu(miss, 1)
        miss |= np.swapaxes(miss, 1, 2)
    Y[miss] = -1.0
    return Y
