"""Case-control likelihood (counterpart of
``dynetlsm_tpu/ops/case_control.py``), directed and undirected: exact
Bernoulli terms for the observed edges plus a scaled sample of "control"
non-edges, so a node's conditional costs O(deg_max + n_control) and the
network log-likelihood O(n (deg_max + n_control)), with no (T, n, n)
tensor (reference case_control_likelihood.py:36-112,
directed_likelihoods_fast.pyx:83-270, static_network_fast.pyx:47-94).

The host half is NumPy, run once a fit: the padded edge lists
(:func:`build_edge_lists`), the degree bound of a network with missing
dyads (:func:`max_degree_bound`) and the balanced greedy colouring of the
conflict graph (:func:`color_conflict_graph`), each giving the JAX
package's arrays for the same inputs and seed.

The device half is torch, with the chain axis C leading where a block has
one:

* :func:`edge_lists_device` rebuilds the padded lists from each chain's
  network when missing dyads are resampled (a stable sort, so the lists
  equal :func:`build_edge_lists`'s);
* :func:`sample_controls_colored` draws ``n_control`` control nodes per
  node, shared across time steps and across chains (one draw), -1 where
  the draw is the node itself or in its own colour class;
  :func:`sample_control_nodes`, the draw of a sweep without colour
  classes, one a chain (C, n, m), -1 only at the node itself;
  :func:`control_masks` gives each draw's per-time validity (a control is
  valid at t when it is not an edge there), (T, n, m) for lists shared by
  the chains and (C, T, n, m) for per-chain lists;
* the evaluators: :func:`class_partial_loglik_segments` (a colour class's
  nodes at candidate positions, from pre-gathered partner segments),
  :func:`approx_directed_partial_loglik` /
  :func:`approx_undirected_partial_loglik` (one node),
  :func:`approx_partial_loglik_all` (every node at its own candidate, for
  the ``'parallel'`` latent update) and
  :func:`approx_directed_loglik_full` /
  :func:`approx_undirected_loglik_full` (the network, in node blocks that
  bound the gathered partners, :func:`_node_blocks`).

Every gather of a -1-padded index clamps it to 0 and masks the term.
Edge lists, degrees and masks are either one for every chain, (T, n, D),
or each chain's own, (C, T, n, D): the gathers take either.

Under node sharding (``mcmc/nodes.py``) a shard's structures hold the rows
[row0, row0 + rows) of the lists, masks and controls (``'row0'`` in the
dict) and the evaluators read the whole X: :func:`approx_partial_loglik_all`
scores the shard's own nodes, and :func:`cc_loglik` adds the shards'
float64 shares of the network log-likelihood (a dict ``{'shards': [...]}``)
and rounds once.
"""
import numpy as np
import torch

from .distances import _sum_sq_last
from .likelihoods import softplus

# elements of the largest gathered tensor of one node block of a full
# evaluator (float32: 256 MB)
_BLOCK_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# host half: edge lists, degree bound, colouring
# ---------------------------------------------------------------------------


def _padded_rows(T, n, t, row, col):
    """(T, n, D) int32 lists, -1 padded: the cols of each (t, row) in the
    order given (ascending when the triples come from ``np.nonzero``)."""
    run = t * n + row
    count = np.bincount(run, minlength=T * n)
    D = max(int(count.max()) if count.size else 0, 1)
    out = np.full((T, n, D), -1, np.int32)
    if t.size:
        start = np.concatenate([[0], np.cumsum(count)[:-1]])
        slot = np.arange(t.size) - start[run]
        out[t, row, slot] = col
    return out


def build_edge_lists(Y):
    """Padded edge lists of a 0/1 network Y (T, n, n): ``degrees`` (T, n,
    2) int32 [in, out], ``in_edges`` (T, n, max_in) and ``out_edges`` (T,
    n, max_out) int32, ascending node indices padded with -1 (JAX
    ``build_edge_lists``, reference case_control_likelihood.py:44-68)."""
    Y = np.asarray(Y)
    T, n, _ = Y.shape
    degrees = np.zeros((T, n, 2), dtype=np.int32)
    degrees[..., 0] = Y.sum(axis=1)      # in-degree (column sums)
    degrees[..., 1] = Y.sum(axis=2)      # out-degree (row sums)
    t, i, j = np.nonzero(Y == 1)
    out_edges = _padded_rows(T, n, t, i, j)
    t, j, i = np.nonzero(np.swapaxes(Y, 1, 2) == 1)
    in_edges = _padded_rows(T, n, t, j, i)
    return {'degrees': degrees, 'in_edges': in_edges, 'out_edges': out_edges}


def max_degree_bound(Y_host, miss_mask=None):
    """Bound on any row or column degree over every resampling of the
    missing dyads: the observed edges plus every missing dyad of the row
    or column, maxed over (t, node, direction), at most n - 1 and at least
    1."""
    Y = np.asarray(Y_host)
    miss = (np.zeros_like(Y, dtype=bool) if miss_mask is None
            else np.asarray(miss_mask, dtype=bool))
    fixed = (Y == 1) & ~miss
    bound = 0
    for axis in (1, 2):
        bound = max(bound, int((fixed.sum(axis=axis)
                                + miss.sum(axis=axis)).max()))
    return max(min(bound, Y.shape[-1] - 1), 1)


def color_conflict_graph(lists, n, miss_mask=None, seed=0):
    """Balanced greedy colouring of the node-conflict graph of the
    chromatic case-control scan (``mcmc/latent.py::cc_colored_scan``).

    Two nodes conflict when an edge joins them in either direction at any
    time step, or a missing dyad does (resampling can make it an edge).
    Controls are drawn only from other classes
    (:func:`sample_controls_colored`), so the nodes of one class have
    conditionally independent conditionals and one vectorised update of a
    class is exact blocked Gibbs.  The colouring is of the union graph over
    time: a node's whole trajectory belongs to one class.  Nodes are
    visited in ``np.random.RandomState(seed).permutation(n)`` order and
    each takes the least-loaded colour none of its neighbours has (a new
    colour when there is none), so the class size S stays near
    n / n_colors.  The same inputs give the JAX package's arrays.

    ``lists`` holds ``in_edges`` and ``out_edges`` of
    :func:`build_edge_lists`.  Returns (colors (n,) int32, groups
    (n_colors, S) int32: each class's nodes in ascending order, -1
    padded)."""
    pairs = []
    for name in ('in_edges', 'out_edges'):
        e = np.asarray(lists[name])                      # (T, n, D)
        _, src, _ = np.nonzero(e >= 0)
        pairs.append(np.stack([src, e[e >= 0]], axis=1))
    if miss_mask is not None:
        _, i, j = np.nonzero(np.asarray(miss_mask))
        pairs.append(np.stack([i, j], axis=1))
    pairs = np.concatenate(pairs, axis=0).astype(np.int64)
    pairs = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    pairs = np.unique(pairs[:, 0] * n + pairs[:, 1])
    src, nbr = pairs // n, pairs % n
    indptr = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=n))])

    rng = np.random.RandomState(seed)
    colors = np.full(n, -1, dtype=np.int64)
    loads = np.zeros(0, np.float64)
    for j in rng.permutation(n):
        nb_colors = colors[nbr[indptr[j]:indptr[j + 1]]]
        masked = loads.copy()
        masked[nb_colors[nb_colors >= 0]] = np.inf
        if masked.size and np.isfinite(masked).any():
            c = int(np.argmin(masked))
        else:
            c = loads.size
            loads = np.append(loads, 0.0)
        colors[j] = c
        loads[c] += 1
    S = int(loads.max())
    groups = np.full((loads.size, S), -1, dtype=np.int32)
    order = np.argsort(colors, kind='stable')
    sizes = loads.astype(np.int64)
    slot = np.arange(n) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    groups[colors[order], slot] = order
    return colors.astype(np.int32), groups


# ---------------------------------------------------------------------------
# device half: edge lists of the current network, controls, masks
# ---------------------------------------------------------------------------


def edge_lists_device(Y, max_deg, Y_in=None):
    """The padded lists of :func:`build_edge_lists` from a 0/1 network Y
    (..., T, n, n) (uint8 or float, zero diagonal) on its device, every
    row cut to ``max_deg`` (a bound on the degrees,
    :func:`max_degree_bound`).  A stable descending sort of each 0/1 row
    puts its edges first in ascending index order, so the lists equal the
    host function's.  ``Y_in``: the rows of Y^T the in-edges come from
    (a node shard's, whose Y holds only some rows), Y^T by default.
    Returns {'degrees' (..., T, n, 2) [in, out], 'in_edges', 'out_edges'
    (..., T, n, max_deg)}, int64."""
    rank = torch.arange(max_deg, device=Y.device)

    def rows(adj):
        deg = torch.sum(adj, dim=-1, dtype=torch.int64)
        idx = torch.argsort(adj, dim=-1, descending=True,
                            stable=True)[..., :max_deg]
        return torch.where(rank < deg[..., None], idx,
                           torch.full_like(idx, -1)), deg

    out_edges, deg_out = rows(Y)
    in_edges, deg_in = rows(Y.transpose(-1, -2) if Y_in is None else Y_in)
    return {'degrees': torch.stack([deg_in, deg_out], dim=-1),
            'in_edges': in_edges, 'out_edges': out_edges}


def sample_controls_colored(gen, colors, n, n_control, directed=True):
    """``n_control`` control nodes per node, uniform on [0, n) with
    replacement from ``gen`` (on the device of ``colors``), -1 where the
    draw is the node itself or in the node's colour class.  One draw,
    shared by every chain and every time step; per-time validity is
    :func:`control_masks`'s.  Returns (ctrl_in, ctrl_out) int64 (n,
    n_control), the out-controls drawn first; ctrl_in is None when
    undirected."""
    node = torch.arange(n, device=colors.device)[:, None]

    def draw():
        cand = torch.randint(0, n, (n, n_control), generator=gen,
                             device=colors.device)
        bad = (cand == node) | (colors[cand] == colors[:, None])
        return torch.where(bad, torch.full_like(cand, -1), cand)

    ctrl_out = draw()
    return (draw() if directed else None), ctrl_out


def sample_control_nodes(gen, Y, n_control, directed=True, n_chains=None):
    """The control draw of a sweep without colour classes (JAX
    ``sample_control_nodes``, the sequential scan's): ``n_control``
    control nodes per node, uniform on [0, n) with replacement from
    ``gen`` (on its device), -1 where the draw is the node itself; ``Y``
    supplies only the node count n (its last axis).  With ``n_chains``,
    one draw a chain, (C, n, m), as the JAX sweep draws them from each
    chain's key.  Returns (ctrl_in, ctrl_out) int64, the out-controls
    drawn first; ctrl_in is None when undirected."""
    n = Y.shape[-1]
    lead = () if n_chains is None else (n_chains,)
    node = torch.arange(n, device=gen.device)[:, None]

    def draw():
        cand = torch.randint(0, n, lead + (n, n_control), generator=gen,
                             device=gen.device)
        return torch.where(cand == node, torch.full_like(cand, -1), cand)

    ctrl_out = draw()
    return (draw() if directed else None), ctrl_out


def control_valid_masks(ctrl, edges):
    """Per-time validity of control draws: slot (.., t, j, k) is valid
    when ``ctrl[.., j, k]`` is a node (not -1) and not an edge partner of
    j at t.  ctrl (n, m), or one draw a chain (C, n, m); edges (..., T, n,
    D) -1-padded lists (out-edges for ctrl_out, in-edges for ctrl_in).
    Returns (..., T, n, m) bool, (C, T, n, m) for per-chain draws.
    Membership is a binary search in each sorted list row."""
    if ctrl.dim() == 3:
        ctrl = ctrl[:, None]
        edges = edges.expand(ctrl.shape[:1] + edges.shape[-3:])
    n_big = torch.iinfo(torch.int64).max
    seq, _ = torch.sort(torch.where(edges < 0, n_big, edges.to(torch.int64)),
                        dim=-1)
    cand = ctrl.expand(edges.shape[:-1] + ctrl.shape[-1:]).contiguous()
    pos = torch.searchsorted(seq.contiguous(), cand)
    pos = torch.clamp_max(pos, seq.shape[-1] - 1)
    hit = torch.gather(seq, -1, pos) == cand
    return (cand >= 0) & ~hit


def control_masks(ctrl_in, ctrl_out, lists, directed):
    """(ctrl_in_valid or None, ctrl_out_valid) of the control draws
    against the edge ``lists`` (:func:`control_valid_masks`)."""
    cov = control_valid_masks(ctrl_out, lists['out_edges'])
    if not directed:
        return None, cov
    return control_valid_masks(ctrl_in, lists['in_edges']), cov


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------


def _take(X, idx, per_chain):
    """X (C, T, n, q) rows at the -1-safe node indices ``idx`` of each
    time: idx (T, ...) shared by the chains or, ``per_chain``, (C, T, ...).
    Returns (C, T, ..., q)."""
    C, T, n, q = X.shape
    safe = torch.clamp_min(idx, 0)
    lead = 1 if per_chain else 0
    t_off = (torch.arange(T, device=X.device) * n).reshape(
        (T,) + (1,) * (idx.dim() - lead - 1))
    flat = safe + t_off
    if not per_chain:
        return X.reshape(C, T * n, q)[:, flat]
    c_off = (torch.arange(C, device=X.device) * (T * n)).reshape(
        (C,) + (1,) * (idx.dim() - 1))
    return X.reshape(C * T * n, q)[flat + c_off]


def _dist_to(partners, x_self):
    """Euclidean distances from x_self (..., d) to partners (..., m, d)."""
    return torch.sqrt(torch.clamp_min(
        _sum_sq_last(partners - x_self[..., None, :]), 0.0))


# ---------------------------------------------------------------------------
# per-node and per-class evaluators
# ---------------------------------------------------------------------------


def control_scale(n, degree, valid):
    """(n - degree - 1) / max(n_valid, 1): the factor that scales a
    control sum to the node's non-edge terms.  degree (...); valid (...,
    m)."""
    n_valid = torch.clamp_min(torch.sum(valid, dim=-1), 1)
    return (n - degree - 1).to(torch.float32) / n_valid


def _segment_terms(eta, sp, valid, offsets, scales, is_directed):
    """The class log-likelihood (..., S) from the per-partner eta and
    softplus(eta) (..., S, Mtot) of the segments [in | out | ctrl_in |
    ctrl_out] (directed) or [out | ctrl_out] (undirected): the edge
    segments' eta - softplus, less each control segment's softplus sum
    times its :func:`control_scale`."""
    def seg(a, i):
        return a[..., offsets[i]:offsets[i + 1]]

    def edge_term(i):
        return torch.sum(torch.where(seg(valid, i), seg(eta, i) - seg(sp, i),
                                     0.0), dim=-1)

    def control_term(i, scale):
        return scale * torch.sum(torch.where(seg(valid, i), seg(sp, i), 0.0),
                                 dim=-1)

    if is_directed:
        ll = edge_term(0) + edge_term(1)
        ll = ll - control_term(2, scales[0])
        return ll - control_term(3, scales[1])
    return edge_term(0) - control_term(1, scales[0])


def _directed_eta(dist, r_bin, r_bout, b_in, b_out):
    return b_in * (1.0 - dist / r_bin) + b_out * (1.0 - dist / r_bout)


def class_partial_loglik_segments(dist, valid, r_all, r_self, sender_mask,
                                  offsets, degrees, b_in, b_out, n,
                                  is_directed, scales=None):
    """Case-control log-likelihood of each node of a colour class at its
    candidate position, from pre-gathered partner segments (directed:
    [in_edges | out_edges | ctrl_in | ctrl_out]; undirected: [out_edges |
    ctrl_out]); reference directed_likelihoods_fast.pyx:83-182,
    static_network_fast.pyx:47-94.

    dist (..., C, T, S, Mtot) distances from the candidates to the
    partners (leading axes: candidate sets scored together); valid (C, T,
    S, Mtot) or (T, S, Mtot); r_all (C, T, S, Mtot) the partners' radii and
    r_self (C, S) the nodes' (directed); sender_mask (Mtot,) bool, true
    where the node sends the dyad (the out segments); offsets the
    segments' boundaries; degrees (..., T, S, 2) directed, (..., T, S)
    undirected; b_in, b_out (C,) (b_in the undirected intercept).
    ``scales``: the control segments' :func:`control_scale`, when the
    caller holds them (then ``degrees`` is not read).  Returns (..., C,
    T, S)."""
    ctrl = range(2, 4) if is_directed else range(1, 2)
    if scales is None:
        deg = ((degrees[..., 0], degrees[..., 1]) if is_directed
               else (degrees,))
        scales = tuple(control_scale(n, dg, valid[..., offsets[i]:
                                                   offsets[i + 1]])
                       for dg, i in zip(deg, ctrl))
    if is_directed:
        rs = r_self[:, None, :, None]
        r_bin = torch.where(sender_mask, r_all, rs)
        r_bout = torch.where(sender_mask, rs, r_all)
        eta = _directed_eta(dist, r_bin, r_bout, b_in[:, None, None, None],
                            b_out[:, None, None, None])
    else:
        eta = b_in[:, None, None, None] - dist
    return _segment_terms(eta, softplus(eta), valid, offsets, scales,
                          is_directed)


def approx_directed_partial_loglik(X, radii, node_id, x_new, in_edges,
                                   out_edges, degrees, ctrl_in, ctrl_out,
                                   ctrl_in_valid, ctrl_out_valid,
                                   intercept_in, intercept_out):
    """Case-control log-likelihood terms of node ``node_id`` at candidate
    positions x_new (C, T, d), every time step at once (reference
    directed_likelihoods_fast.pyx:83-182).  X (C, T, n, d); radii (C, n);
    in_edges / out_edges (T, D) or (C, T, D); degrees (T, 2) or (C, T, 2);
    ctrl_in / ctrl_out (m,) with masks (T, m) or (C, T, m); intercepts
    (C,).  Returns (C, T)."""
    n = X.shape[2]
    b_in = intercept_in[:, None, None]
    b_out = intercept_out[:, None, None]
    r_self = radii[:, node_id, None, None]

    def eta_for(dist, r_other, self_is_sender):
        if self_is_sender:
            return _directed_eta(dist, r_other, r_self, b_in, b_out)
        return _directed_eta(dist, r_self, r_other, b_in, b_out)

    radii_t = radii[:, None, :, None].expand(-1, X.shape[1], -1, 1)

    def edge_term(idx, self_is_sender):
        per_chain = idx.dim() == 3
        dist = _dist_to(_take(X, idx, per_chain), x_new)     # (C, T, D)
        r_other = _take(radii_t, idx, per_chain)[..., 0]
        eta = eta_for(dist, r_other, self_is_sender)
        return torch.sum(torch.where(idx >= 0, eta - softplus(eta), 0.0),
                         dim=-1)

    def control_term(idx, valid, degree, self_is_sender):
        safe = torch.clamp_min(idx, 0)
        dist = _dist_to(X[:, :, safe], x_new)                # (C, T, m)
        eta = eta_for(dist, radii[:, None, safe], self_is_sender)
        ctrl = torch.sum(torch.where(valid, softplus(eta), 0.0), dim=-1)
        return control_scale(n, degree, valid) * ctrl

    ll = edge_term(in_edges, False) + edge_term(out_edges, True)
    ll = ll - control_term(ctrl_in, ctrl_in_valid, degrees[..., 0], False)
    return ll - control_term(ctrl_out, ctrl_out_valid, degrees[..., 1], True)


def approx_undirected_partial_loglik(X, x_new, edges, degrees, ctrl,
                                     ctrl_valid, intercept):
    """Undirected case-control log-likelihood terms of one node at
    candidate positions x_new (C, T, d) (reference
    static_network_fast.pyx:47-94): exact terms for its edges plus the
    scaled control estimate of its non-edge terms.  X (C, T, n, d); edges
    (T, D) or (C, T, D); degrees (T,) or (C, T); ctrl (m,) with validity
    (T, m) or (C, T, m); intercept (C,).  Returns (C, T)."""
    n = X.shape[2]
    b = intercept[:, None, None]
    eta_e = b - _dist_to(_take(X, edges, edges.dim() == 3), x_new)
    ll = torch.sum(torch.where(edges >= 0, eta_e - softplus(eta_e), 0.0),
                   dim=-1)
    eta_c = b - _dist_to(X[:, :, torch.clamp_min(ctrl, 0)], x_new)
    ctrl_sum = torch.sum(torch.where(ctrl_valid, softplus(eta_c), 0.0),
                         dim=-1)
    return ll - control_scale(n, degrees, ctrl_valid) * ctrl_sum


def approx_partial_loglik_all(X, Xq, cc, intercept, radii, is_directed):
    """Case-control per-node log-likelihood terms of every node at once
    (JAX ``approx_partial_loglik_all``): node j at its candidate Xq[:, :,
    j] against the field X, as :func:`approx_directed_partial_loglik` /
    :func:`approx_undirected_partial_loglik` score one node, for the
    stale-field ``'parallel'`` latent update.  X, Xq (C, T, n, d);
    intercept (C, 1) or (C, 2); radii (C, n) when directed; ``cc`` the
    structures of ``mcmc/sweeps.py::build_cc_dict`` (lists shared or per
    chain).  Every node's partner segments [in | out | ctrl_in |
    ctrl_out] (undirected [out | ctrl_out]) are gathered in node blocks of
    at most ``_BLOCK_ELEMS`` values and scored by
    :func:`class_partial_loglik_segments`, each node's terms in the
    one-node evaluators' order.  Returns (C, T, n), or with a shard's
    structures (``cc['row0']``) (C, T, rows) of its nodes."""
    C, T, n, d = X.shape
    per_chain = cc['out_edges'].dim() == 4
    ctrl_chain = cc['ctrl_out'].dim() == 3
    row0 = cc.get('row0', 0)
    rows = cc['out_edges'].shape[-2]
    if is_directed:
        edges = torch.cat([cc['in_edges'], cc['out_edges']], -1)
        ctrl = torch.cat([cc['ctrl_in'], cc['ctrl_out']], -1)
        masks = (cc['ctrl_in_valid'], cc['ctrl_out_valid'])
        degs = (cc['degrees'][..., 0], cc['degrees'][..., 1])
        widths = [cc['in_edges'].shape[-1], cc['out_edges'].shape[-1],
                  cc['ctrl_in'].shape[-1], cc['ctrl_out'].shape[-1]]
    else:
        edges, ctrl = cc['out_edges'], cc['ctrl_out']
        masks = (cc['ctrl_out_valid'],)
        degs = (cc['degrees'][..., 1],)
        widths = [edges.shape[-1], ctrl.shape[-1]]
    offsets = (0,) + tuple(int(v) for v in np.cumsum(widths))
    scales = tuple(control_scale(n, dg, mk) for dg, mk in zip(degs, masks))
    valid_ctrl = torch.cat(masks, -1)
    if ctrl_chain and not per_chain:
        # one control draw a chain: gather per chain
        edges = edges.expand((C,) + edges.shape)
        per_chain = True
    sender = None
    b_in, b_out = intercept[:, 0], None
    Xr = X
    if is_directed:
        sender = torch.zeros(offsets[-1], dtype=torch.bool, device=X.device)
        sender[offsets[1]:offsets[2]] = True              # out edges
        sender[offsets[3]:offsets[4]] = True              # ctrl_out
        b_out = intercept[:, 1]
        Xr = torch.cat([X, radii[:, None, :, None].expand(C, T, n, 1)], -1)
    out = torch.empty((C, T, rows), dtype=X.dtype, device=X.device)
    nb = _node_blocks(rows, C * T * offsets[-1] * (d + 1))
    for lo in range(0, rows, nb):
        hi = min(lo + nb, rows)
        e = _rows(edges, lo, hi, 2)                       # ([C,] T, b, De)
        c = (ctrl[:, None, lo:hi] if ctrl_chain else ctrl[lo:hi]).expand(
            e.shape[:-1] + ctrl.shape[-1:])
        partner = torch.cat([e, c], -1)                   # ([C,] T, b, Mtot)
        valid = torch.cat([e >= 0, _rows(valid_ctrl, lo, hi, 2)], -1)
        g = _take(Xr, partner, per_chain)                 # (C, T, b, Mtot, q)
        dist = _dist_to(g[..., :d], Xq[:, :, row0 + lo:row0 + hi])
        out[:, :, lo:hi] = class_partial_loglik_segments(
            dist, valid, g[..., d] if is_directed else None,
            radii[:, row0 + lo:row0 + hi] if is_directed else None, sender,
            offsets, None, b_in, b_out, n, is_directed,
            scales=tuple(_rows(s, lo, hi, 1) for s in scales))
    return out


# ---------------------------------------------------------------------------
# full-network evaluators (intercept and radii steps, log joint)
# ---------------------------------------------------------------------------


def _node_blocks(n, per_node_elems):
    """Nodes per block of a full evaluator, so that its largest gathered
    tensor (``per_node_elems`` elements a node) stays within
    ``_BLOCK_ELEMS``: n (one block) when the whole network fits."""
    return int(min(n, max(1, _BLOCK_ELEMS // max(per_node_elems, 1))))


def _rows(a, lo, hi, node_axis_from_end):
    """a[..., lo:hi, ...] on the node axis counted from the end."""
    idx = [slice(None)] * a.dim()
    idx[a.dim() - node_axis_from_end] = slice(lo, hi)
    return a[tuple(idx)]


def _full_loglik(X, radii, edges, degree, ctrl, ctrl_valid, eta_fn, row0=0):
    """Sum over each chain's nodes and times of the exact terms of each
    node's ``edges`` (T, n, Mo) or (C, T, n, Mo) plus the scaled control
    estimates of its non-edge terms, in node blocks, accumulated in
    float64.  ``eta_fn(dist, r_other, r_self)`` gives eta (K, C, ...) of
    the dyads the node sends at K candidates (radii None when undirected);
    the distances are computed once for all of them.  With ``row0`` the
    lists, degrees, controls and masks hold the rows [row0, row0 + rows)
    (a node shard's) and X, radii stay whole.  Returns (K, C) float64."""
    C, T, n, d = X.shape
    rows = edges.shape[-2]
    Mo, m = edges.shape[-1], ctrl.shape[-1]
    q = d + (radii is not None)
    nb = _node_blocks(rows, C * T * (Mo + m) * q)
    Xr = X
    if radii is not None:
        Xr = torch.cat([X, radii[:, None, :, None].expand(C, T, n, 1)], -1)
    total = 0.0
    for lo in range(0, rows, nb):
        hi = min(lo + nb, rows)
        e = _rows(edges, lo, hi, 2)                          # (.., T, b, Mo)
        x_blk = X[:, :, row0 + lo:row0 + hi]                 # (C, T, b, d)
        r_self = (None if radii is None
                  else radii[:, None, row0 + lo:row0 + hi, None])
        ge = _take(Xr, e, e.dim() == 4)                      # (C, T, b, Mo, q)
        dist_e = _dist_to(ge[..., :d], x_blk)
        eta_e = eta_fn(dist_e, None if radii is None else ge[..., d],
                       r_self)                               # (K, C, T, b, Mo)
        ll = torch.sum(torch.where(e >= 0, eta_e - softplus(eta_e), 0.0),
                       dim=(-3, -2, -1), dtype=torch.float64)
        co = torch.clamp_min(ctrl[..., lo:hi, :], 0)         # ([C,] b, m)
        cov = _rows(ctrl_valid, lo, hi, 2)                   # (.., T, b, m)
        gc = (Xr[:, :, co] if co.dim() == 2 else             # (C, T, b, m, q)
              _take(Xr, co[:, None].expand(C, T, hi - lo, m), True))
        dist_c = _dist_to(gc[..., :d], x_blk)
        eta_c = eta_fn(dist_c, None if radii is None else gc[..., d],
                       r_self)
        ctrl_sum = torch.sum(torch.where(cov, softplus(eta_c), 0.0), dim=-1)
        adj = control_scale(n, _rows(degree, lo, hi, 1), cov)
        total = total + ll - torch.sum(adj * ctrl_sum, dim=(-2, -1),
                                       dtype=torch.float64)
    return total


def _candidates(*intercepts):
    """Intercepts (C,) or (C, K) as (K, C, 1, 1, 1) columns, and whether
    they came with a candidate axis."""
    several = intercepts[0].dim() == 2
    return [(b.T if several else b[None])[..., None, None, None]
            for b in intercepts], several


def approx_directed_loglik_full(X, radii, out_edges, degrees, ctrl_out,
                                ctrl_out_valid, intercept_in, intercept_out):
    """Case-control network log-likelihood, directed: the exact terms of
    every out-edge plus each node's scaled control estimate of its other
    sent dyads, summed over (t, i) (reference
    directed_likelihoods_fast.pyx:208-270).  X (C, T, n, d); radii (C, n);
    out_edges (T, n, Mo) or (C, T, n, Mo); degrees (T, n, 2) or (C, T, n,
    2); ctrl_out (n, m) or (C, n, m) with validity (T, n, m) or (C, T,
    n, m);
    intercepts (C,), or (C, K) to score K candidates on one set of
    distances.  Returns (C,), or (C, K), float32."""
    (b_in, b_out), several = _candidates(intercept_in, intercept_out)

    def eta_fn(dist, r_other, r_self):
        return _directed_eta(dist, r_other, r_self, b_in, b_out)

    ll = _full_loglik(X, radii, out_edges, degrees[..., 1], ctrl_out,
                      ctrl_out_valid, eta_fn).to(X.dtype)
    return ll.T if several else ll[0]


def approx_undirected_loglik_full(X, edges, degrees, ctrl, ctrl_valid,
                                  intercept):
    """Case-control network log-likelihood, undirected: each row's exact
    edge terms plus its scaled control estimate, halved because every dyad
    appears in two rows.  X (C, T, n, d); edges (T, n, D) or (C, T, n, D);
    degrees (T, n) or (C, T, n); ctrl (n, m) or (C, n, m) with validity
    (T, n, m) or (C, T, n, m); intercept (C,), or (C, K) to score K
    candidates on one set of distances.  Returns (C,), or (C, K), float32."""
    (b,), several = _candidates(intercept)

    def eta_fn(dist, r_other, r_self):
        return b - dist

    ll = (0.5 * _full_loglik(X, None, edges, degrees, ctrl, ctrl_valid,
                             eta_fn)).to(X.dtype)
    return ll.T if several else ll[0]


def cc_loglik(X, cc, is_directed, b_in, b_out=None, radii=None):
    """The case-control network log-likelihood from the structures ``cc``
    (``mcmc/sweeps.py::build_cc_dict``) at the intercept ``b_in`` (C,) or
    (C, K) candidates (undirected), or at (b_in, b_out) with radii (C, n)
    (directed), as :func:`approx_undirected_loglik_full` /
    :func:`approx_directed_loglik_full` compute it.  A node-sharded ``cc``
    (``{'shards': [...]}``, each shard's rows with its ``'row0'``) gives
    each shard's float64 share on the shard's device, added on X's device
    in shard order and rounded once.  Returns (C,) or (C, K) float32."""
    (bi, bo), several = _candidates(b_in, b_in if b_out is None else b_out)
    total = None
    for part in cc.get('shards', (cc,)):
        dev = part['out_edges'].device
        r = None if radii is None else radii.to(dev)
        if is_directed:
            def eta_fn(dist, r_other, r_self, bi=bi.to(dev), bo=bo.to(dev)):
                return _directed_eta(dist, r_other, r_self, bi, bo)
        else:
            def eta_fn(dist, r_other, r_self, b=bi.to(dev)):
                return b - dist
        share = _full_loglik(X.to(dev), r if is_directed else None,
                             part['out_edges'], part['degrees'][..., 1],
                             part['ctrl_out'],
                             part['ctrl_out_valid'], eta_fn,
                             part.get('row0', 0)).to(X.device)
        total = share if total is None else total + share
    ll = (total if is_directed else 0.5 * total).to(X.dtype)
    return ll.T if several else ll[0]


def cc_network_loglik(X, intercept, radii, cc, is_directed):
    """The case-control network log-likelihood (C,) of every chain from the
    structures ``cc`` (:func:`cc_loglik`); intercept (C, 1) or (C, 2),
    radii (C, n) when directed."""
    if is_directed:
        return cc_loglik(X, cc, True, intercept[:, 0], intercept[:, 1],
                         radii)
    return cc_loglik(X, cc, False, intercept[:, 0])
