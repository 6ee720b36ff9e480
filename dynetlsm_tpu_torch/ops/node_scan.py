"""Exact sequential latent-position node scan (counterpart of
``dynetlsm_tpu/ops/pallas_scan.py``).

One call is one full sweep of single-site random-walk MH updates over all
(t, node) sites of C chains, on an injected proposal stream: eps
(C, 2, n, T, d) and log_u (C, 2, n, T), the layout of
``dynetlsm_tpu/mcmc/latent.py::xla_exact_scan``.  Nodes go in index order;
each node has two parity phases (even t, then odd t); a site is accepted
iff log_u < ratio.

* :func:`node_scan_plain` is the chain-batched PyTorch port of
  ``xla_exact_scan`` (undirected or directed social-radii; mixture or
  random-walk prior; optional per-chain temperature).
* :func:`node_scan_cuda` launches ``csrc/node_scan.cu`` (mixture or
  random-walk prior; undirected, or directed when given ``radii``;
  untempered, or with a per-chain temperature ``temper``), in its resident
  mode (each block holds the chain's field) or, past shared memory, its
  split-field mode (the field in a scratch, each block of a cluster the
  partners of its residue mod the cluster size; :func:`launch_layout`).
* :func:`node_scan` picks by device: the kernel for CUDA tensors (or an
  error for what it does not take), the plain version for CPU tensors.

Both sum each site's partner terms as a pairwise tree over the partner
axis padded to :func:`partner_pad` (level s adds element i + s into
element i), so they compute bit-identical ratios.  The kernel splits that
tree over registers, warps, blocks of a cluster and shuffles
(:func:`_kernel_order_sum` and, split-field, :func:`_split_order_sum`
spell its order out), and reads the adjacency with its rows padded to the
partner axis (:func:`pad_partners`; split-field, that axis
residue-major, :func:`residue_major`); the launch shape comes from
:func:`scan_layout` and :func:`split_layout`.

The directed model takes the adjacency packed as ``Y + 2 Y^T`` uint8
(:func:`pack_directed`): row j of it holds both the out-edge bit Y[j, i]
(``& 1``) and the in-edge bit Y[i, j] (``>> 1``) of every partner i.

The adjacency is one network (T, n, n) that every chain reads, or one
network a chain (C, T, n, n), as the sweeps that resample missing dyads
keep it; the kernel then reads chain c's at a chain stride of T n P
bytes.
"""
import functools

import torch

from . import cuda_lib
from .distances import _sum_sq_last
from .likelihoods import softplus

# shared memory a block may opt into on sm_90 (232,448 bytes)
_MAX_SMEM_BYTES = 232448
# csrc/node_scan.cu: threads of one block, groups (named barriers), lanes
# sharing one time's partners in the resident mode (R = 32 W B <=
# 32 kMaxExchange), and the split-field mode's cluster sizes (16 is past
# the portable 8: taken where the card confirms it runs the clusters)
_MAX_THREADS = 768
_MAX_GROUPS = 15
_MAX_LANES = 512
_MAX_PORTABLE = 8
SPLIT_CLUSTERS = (1, 2, 4, 8, 16)
# the split-field launch rule's cost of one step of a block, in
# instructions a time: its P / B partner terms at the instructions of the
# compiled partner-term loop (scripts/node_scan_sass.py: 162 a term
# undirected, 264 directed, CUDA 12.8 on an H100) and a fixed share of a
# step, the same for every cluster size (the barrier, the finishing warp's
# chain and the tail of the slowest warp); fitted to the split-field
# launches of PERF.md's slices on an H100, where every cluster size from 1
# to 16 was timed (the fixed share 41,500-67,900 instructions puts every
# slice's fastest launch first)
_TERM_INSTRUCTIONS = {False: 162, True: 264}
_STEP_INSTRUCTIONS = 55000


def partner_pad(n):
    """Length of the padded partner axis: a power of two, at least 32."""
    p = 32
    while p < n:
        p *= 2
    return p


def _tree_sum(a, P):
    """Pairwise tree sum over the last axis, zero-padded to length P."""
    a = torch.nn.functional.pad(a, (0, P - a.shape[-1]))
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    return a[..., 0]


def _bit_reversed(m):
    """0 .. m-1 (m a power of two) in bit-reversed order."""
    lg = m.bit_length() - 1
    return [int(format(k, '0%db' % lg)[::-1], 2) if lg else 0
            for k in range(m)]


def _online_pairwise(seq):
    """The pairwise tree of a power-of-two sequence built online, as
    csrc/node_scan.cu's ``push_pairwise`` builds it: element k completes
    the subtrees of its trailing one bits.  Fed in bit-reversed order it
    is the tree that halves the sequence level by level."""
    stack = {}
    for k, v in enumerate(seq):
        level = 0
        while (k >> level) & 1:
            v = stack[level] + v
            level += 1
        stack[level] = v
    return v


def _kernel_order_sum(a, P, warps, cluster):
    """:func:`_tree_sum` over the last axis (zero-padded to P), in the
    order csrc/node_scan.cu adds: R = 32 * warps * cluster lanes, lane r
    holding partners r + R k; each lane's register levels, online over its
    k in bit-reversed order; the exchange levels, lane l of one warp
    halving the lane values l + 32 q; then the shuffle levels 16 .. 1,
    lane i adding lane i + h."""
    a = torch.nn.functional.pad(a, (0, P - a.shape[-1]))
    R = 32 * warps * cluster
    by_k = a.reshape(a.shape[:-1] + (P // R, R))
    lanes = _online_pairwise([by_k[..., k, :]
                              for k in _bit_reversed(P // R)])
    v = lanes.reshape(lanes.shape[:-1] + (R // 32, 32))
    while v.shape[-2] > 1:
        h = v.shape[-2] // 2
        v = v[..., :h, :] + v[..., h:, :]
    v = v[..., 0, :]
    for h in (16, 8, 4, 2, 1):
        v = v[..., :h] + v[..., h:2 * h]
    return v[..., 0]


def _split_order_sum(a, P, warps, cluster):
    """:func:`_tree_sum` over the last axis (zero-padded to P), in the
    order the kernel's split-field mode adds: block ``rank`` of the
    cluster of B = ``cluster`` holds the partners i = rank (mod B), its
    lane rl the partners rank + B (rl + 32 W k); each block adds its own
    partners as the resident mode adds a block's (:func:`_kernel_order_sum`
    of one block over its P / B elements), and the B partials are halved
    level by level (B/2 .. 1), lane l of one warp holding block l's."""
    a = torch.nn.functional.pad(a, (0, P - a.shape[-1]))
    B = cluster
    v = torch.stack([_kernel_order_sum(a[..., rank::B], P // B, warps, 1)
                     for rank in range(B)], -1)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:2 * h]
    return v[..., 0]


def pad_partners(Y):
    """The adjacency (T, n, n), or (C, T, n, n), with its rows
    zero-padded to the partner axis, (..., T, n, partner_pad(n))
    contiguous: the node-scan kernel copies whole 16-byte pieces of a
    row.  Where n is already P, Y itself (no copy: 2.7 GB at T = 10,
    n = 16,384)."""
    n = Y.shape[-1]
    if partner_pad(n) == n:
        return Y.contiguous()
    return torch.nn.functional.pad(Y, (0, partner_pad(n) - n)).contiguous()


def residue_major(Y, cluster):
    """The padded adjacency (..., T, n, P) with its partner axis
    residue-major for clusters of B = ``cluster`` blocks, as the kernel's
    split-field mode reads it: partner i = r + B m at column r P / B + m,
    so block r's partners i = r (mod B) are one run of P / B columns.  Y
    itself for B = 1."""
    if cluster == 1:
        return Y
    P = Y.shape[-1]
    return (Y.reshape(Y.shape[:-1] + (P // cluster, cluster))
            .transpose(-1, -2).reshape(Y.shape).contiguous())


def _split_rows(Y, cluster):
    """:func:`residue_major` of the padded adjacency Y, built once a
    network and cluster size: kept on Y with Y's version counter (a fixed
    network is permuted at its first split-field launch, a per-chain
    network, which a sweep makes anew, once a sweep; an in-place change
    rebuilds it)."""
    kept = getattr(Y, '_residue_major', None)
    if kept is None or kept[:2] != (Y._version, cluster):
        kept = (Y._version, cluster, residue_major(Y, cluster))
        Y._residue_major = kept
    return kept[2]


def _widest(T, P, B):
    """The widest of 4, 2, 1 warps a time that fits a block (ceil(T/2)
    groups, at most 15, and the prior warp in 768 threads) with
    32 W B <= P and <= 512 lanes a time; None if none does."""
    groups = min((T + 1) // 2, _MAX_GROUPS)
    for W in (4, 2, 1):
        if (32 * W * groups + 32 <= _MAX_THREADS
                and 32 * W * B <= min(P, _MAX_LANES)):
            return W
    return None


def scan_layout(C, T, n, sm_count, cluster=None, max_clusters=None):
    """The resident-mode node-scan launch of C chains: (warps W per
    in-phase time, cluster B blocks per chain).  A block holds ceil(T/2)
    groups of W warps (at most 15, then looping over the times) and one
    warp for the prior terms, at most 768 threads (``node_scan_threads`` in
    csrc/node_scan.cu counts them).  W is the widest of 4, 2, 1 that fits
    with 32 W B <= P lanes per time.  B, unless given, is 2 where
    C * 2 <= sm_count (the card's SMs), 64 W <= P and, where
    ``max_clusters(W, B)`` tells how many clusters the card runs at once,
    all C of them run at once; else 1: few chains spread over the idle SMs
    in one wave, many chains keep one block each.  Clusters of 4 are only
    forced (``cluster=4``): even in one wave they beat clusters of 2 by a
    few percent at most, and lost in the undirected modes (PERF.md).  A
    given ``cluster`` that no W allows raises."""
    P = partner_pad(n)

    if cluster is None:
        W = _widest(T, P, 1)
        B = next(b for b in (2, 1)
                 if b == 1 or (C * b <= sm_count and 32 * W * b <= P
                               and (max_clusters is None
                                    or C <= max_clusters(W, b))))
    else:
        if cluster not in (1, 2, 4):
            raise ValueError('node_scan: cluster must be 1, 2 or 4, got %r'
                             % (cluster,))
        B, W = cluster, _widest(T, P, cluster)
        if W is None:
            raise ValueError(
                'node_scan: a cluster of %d blocks needs 32 * %d = %d '
                'partner lanes, more than the padded partner axis P = %d '
                '(n = %d)' % (B, B, 32 * B, P, n))
    return W, B


def split_layout(C, T, n, d, sm_count, directed=False, cluster=None,
                 max_clusters=None):
    """The split-field launch (W, B) of C chains of (T, n, d) fields.  A
    step is bound by the issue rate of the SMs a chain runs on, so the
    rule takes the B of 1, 2, 4, 8, 16 whose launch it expects to finish
    first: the waves the chains take (the clusters the card runs at once,
    ``max_clusters(W, B)`` where the card is asked; without it only the
    portable clusters, at most 8, one block an SM of ``sm_count``) times a
    block's cost of a step (its P / B partner terms at
    ``_TERM_INSTRUCTIONS`` and ``_STEP_INSTRUCTIONS``), the smaller B on a
    tie; at the widest W of 4, 2, 1 whose block fits the card's shared
    memory with 32 W <= P / B.  So few chains spread over the card in one
    wave, and a larger cluster in more waves wins where the partner terms
    outweigh the fixed share.  ``None`` if no launch fits.  A given
    ``cluster`` (1, 2, 4, 8 or 16) is taken at the widest W that fits, and
    raises where no W does."""
    P = partner_pad(n)

    def widest(B):
        for W in (4, 2, 1):
            if (W <= (_widest(T, P // B, 1) or 0)
                    and smem_bytes(T, n, d, directed, W, B, split=True)
                    <= _MAX_SMEM_BYTES):
                return W
        return None

    if cluster is not None:
        if cluster not in SPLIT_CLUSTERS:
            raise ValueError('node_scan: a split-field cluster must be 1, '
                             '2, 4, 8 or 16, got %r' % (cluster,))
        W = widest(cluster)
        if W is None:
            raise ValueError(
                'node_scan: no split-field launch of clusters of %d blocks '
                'takes the padded partner axis P = %d (n = %d): a block '
                'needs 32 partners a time a warp and its shared memory '
                'within %d bytes' % (cluster, P, n, _MAX_SMEM_BYTES))
        return W, cluster
    best = None
    for B in SPLIT_CLUSTERS:
        W = widest(B)
        if W is None:
            continue
        if max_clusters is None:
            if B > _MAX_PORTABLE:
                continue
            at_once = max(sm_count // B, 1)
        else:
            at_once = max_clusters(W, B)
            if at_once < 1:
                continue
        cost = (-(-C // at_once)
                * (P // B * _TERM_INSTRUCTIONS[bool(directed)]
                   + _STEP_INSTRUCTIONS))
        if best is None or cost < best[0]:
            best = (cost, W, B)
    return None if best is None else best[1:]


def launch_layout(C, T, n, d, sm_count, directed=False, cluster=None,
                  mode=None, max_clusters=None):
    """The node-scan launch of C chains of (T, n, d) fields: (W, B,
    split).  The resident mode, every block holding the chain's field,
    wherever its block fits (:func:`scan_layout`'s W and B; for every
    n <= 2048 at T = 10, d = 2, as before the split-field mode existed);
    past that the split-field mode at :func:`split_layout`'s cluster.
    ``mode`` 'resident' or 'split' forces a mode, ``cluster`` the blocks
    per chain (with no ``mode``: the resident mode at that cluster).
    ``max_clusters(W, B, split)`` tells how many clusters the card runs at
    once.  Raises where no mode fits (:func:`check_smem`)."""
    if mode not in (None, 'resident', 'split'):
        raise ValueError("node_scan: mode must be 'resident' or 'split', "
                         "got %r" % (mode,))

    def fits(W, B):
        return smem_bytes(T, n, d, directed, W, B) <= _MAX_SMEM_BYTES

    if mode != 'split':
        # a resident launch that does not fit is never asked of the card
        W, B = scan_layout(
            C, T, n, sm_count, cluster,
            None if max_clusters is None
            else lambda W, B: max_clusters(W, B, False) if fits(W, B) else 0)
        if mode == 'resident' or cluster is not None or fits(W, B):
            return W, B, False
    layout = split_layout(
        C, T, n, d, sm_count, directed, cluster,
        None if max_clusters is None
        else lambda W, B: max_clusters(W, B, True))
    if layout is None:
        _too_large(T, n, d, directed, 'no launch of the node-scan kernel '
                   'fits')
    return layout + (True,)


def site_cluster_params(mu, sigma, z):
    """Per-site cluster mean (C, T, n, d) and variance (C, T, n) of the
    labels z (C, T, n); gathered once per scan (labels are fixed during
    the latent update)."""
    c_idx = torch.arange(z.shape[0], device=z.device)[:, None, None]
    return mu[c_idx, z], sigma[c_idx, z]


def pack_directed(Y):
    """The packed directed adjacency ``Y + 2 Y^T`` uint8 of a 0/1
    adjacency Y (..., T, n, n)."""
    Y = torch.as_tensor(Y).to(torch.uint8)
    return Y + 2 * Y.transpose(-1, -2)


def _partial_loglik_terms(Y_row, X, x, b):
    """Per-partner Bernoulli log-lik terms of one node at candidate x
    (..., C, T, d) (leading axes: candidates scored together) against the
    field X (C, T, n, d); Y_row (T, n); b (C,).  Returns (..., C, T, n),
    the node's own slot not masked."""
    dist = torch.sqrt(torch.clamp_min(_sum_sq_last(X - x[..., None, :]),
                                      0.0))
    eta = b[:, None, None] - dist
    return Y_row * eta - softplus(eta)


def _directed_partial_loglik_terms(P_row, X, x, both, p_out, p_in):
    """Directed per-partner terms of one node at candidate x (..., C, T,
    d) against the field X (C, T, n, d), in the hoisted-reciprocal op order of
    ``dynetlsm_tpu/mcmc/latent.py::_partial_loglik_terms``.  P_row (T, n)
    packed uint8; both (C,) = b_in + b_out; p_out, p_in (C, n) the
    reciprocal rows b_in/r_i + b_out/r_j and b_out/r_i + b_in/r_j.
    Returns (..., C, T, n), the node's own slot not masked."""
    dist = torch.sqrt(torch.clamp_min(_sum_sq_last(X - x[..., None, :]),
                                      0.0))
    y = (P_row & 1).to(X.dtype)
    yt = (P_row >> 1).to(X.dtype)
    eta_out = both[:, None, None] - dist * p_out[:, None, :]
    eta_in = both[:, None, None] - dist * p_in[:, None, :]
    ll = y * eta_out - softplus(eta_out)
    return ll + (yt * eta_in - softplus(eta_in))


def _shift_prev(a, fill=0.0):
    """a[:, t-1] along axis 1, ``fill`` at t = 0."""
    return torch.cat([torch.full_like(a[:, :1], fill), a[:, :-1]], dim=1)


def _shift_next(a, fill=0.0):
    """a[:, t+1] along axis 1, ``fill`` at t = T-1."""
    return torch.cat([a[:, 1:], torch.full_like(a[:, :1], fill)], dim=1)


def _mixture_prior_per_t(xs, x_cur, mu_z, sigma_z, lmbda):
    """AR(1)-to-cluster-mean prior terms of each time's conditional at
    candidates xs (C, T, d), temporal neighbours fixed at x_cur
    (reference sample_latent_positions.py:187-199).  mu_z (C, T, d),
    sigma_z (C, T), lmbda (C,).  Returns (C, T)."""
    T = xs.shape[1]
    t_idx = torch.arange(T, device=xs.device)[None, :]
    lam = lmbda[:, None, None]
    one_m = 1.0 - lam
    prev = _shift_prev(x_cur)
    nxt = _shift_next(x_cur)
    mu_nxt = _shift_next(mu_z)
    sig_nxt = _shift_next(sigma_z, 1.0)
    diff0 = xs - mu_z
    difft = xs - one_m * prev - lam * mu_z
    diff = torch.where((t_idx == 0)[..., None], diff0, difft)
    back = -0.5 * _sum_sq_last(diff) / sigma_z
    fdiff = nxt - one_m * xs - lam * mu_nxt
    fwd = -0.5 * _sum_sq_last(fdiff) / sig_nxt
    fwd = torch.where(t_idx == T - 1, torch.zeros_like(fwd), fwd)
    return back + fwd


def _rw_prior_per_t(xs, x_cur, tau_sq, sigma_sq):
    """Gaussian random-walk prior terms of each time's conditional
    (reference sample_latent_positions.py:131-141).  tau_sq, sigma_sq:
    floats, or 0-d tensors on the device of ``xs`` (then a CUDA tensor is
    divided element by element, as the kernel divides, and not multiplied
    by a reciprocal, as PyTorch divides a CUDA tensor by a Python float).
    Returns (C, T)."""
    T = xs.shape[1]
    t_idx = torch.arange(T, device=xs.device)[None, :]
    prev = _shift_prev(x_cur)
    nxt = _shift_next(x_cur)
    back0 = -0.5 * _sum_sq_last(xs) / tau_sq
    backt = -0.5 * _sum_sq_last(xs - prev) / sigma_sq
    back = torch.where(t_idx == 0, back0, backt)
    fwd = -0.5 * _sum_sq_last(nxt - xs) / sigma_sq
    fwd = torch.where(t_idx == T - 1, torch.zeros_like(fwd), fwd)
    return back + fwd


def node_scan_plain(Y, X, intercept, step_size, eps, log_u, *, mu_z=None,
                    sig_z=None, lmbda=None, tau_sq=None, sigma_sq=None,
                    mixture=True, temper=None, radii=None):
    """Chain-batched port of ``xla_exact_scan``.

    Undirected: Y (T, n, n) 0/1, intercept (C,).  Directed (``radii``
    (C, n) given): Y the packed ``Y + 2 Y^T`` (T, n, n) uint8, intercept
    (C, 2) = (b_in, b_out).  Y may also be one network a chain,
    (C, T, n, n).  X (C, T, n, d); step_size (C, T, n);
    eps (C, 2, n, T, d); log_u (C, 2, n, T).  Mixture prior: mu_z
    (C, T, n, d), sig_z (C, T, n), lmbda (C,); random-walk prior: scalar
    tau_sq, sigma_sq.  temper (C,) scales the log-likelihood delta.
    Returns (X_new (C, T, n, d), accepted (C, T, n) float 0/1)."""
    C, T, n, d = X.shape
    P = partner_pad(n)
    X = X.clone()
    directed = radii is not None
    if not mixture:
        tau_sq = torch.as_tensor(tau_sq, dtype=X.dtype, device=X.device)
        sigma_sq = torch.as_tensor(sigma_sq, dtype=X.dtype, device=X.device)
    if directed:
        Yp = Y.to(torch.uint8)
        b_in, b_out = intercept[:, 0], intercept[:, 1]
        both = b_in + b_out
        u_row = b_in[:, None] / radii
        v_row = b_out[:, None] / radii
    else:
        Yf = Y.to(X.dtype)
        b = intercept.reshape(C)
    t_idx = torch.arange(T, device=X.device)
    partner = torch.arange(n, device=X.device)
    acc = torch.zeros((C, T, n), dtype=X.dtype, device=X.device)
    for j in range(n):
        if directed:
            Y_row = Yp[..., j, :]
            r_node = radii[:, j, None]
            p_out = u_row + b_out[:, None] / r_node
            p_in = v_row + b_in[:, None] / r_node

            def terms(x):
                return _directed_partial_loglik_terms(Y_row, X, x, both,
                                                      p_out, p_in)
        else:
            Y_row = Yf[..., j, :]

            def terms(x):
                return _partial_loglik_terms(Y_row, X, x, b)
        mask = (partner != j).to(X.dtype)
        for phase in (0, 1):
            x_cur = X[:, :, j, :]
            x_prop = x_cur + step_size[:, :, j, None] * eps[:, phase, j]
            # the proposal's and the current terms in one stacked pass
            ll = terms(torch.stack([x_prop, x_cur]))
            delta_ll = _tree_sum((ll[0] - ll[1]) * mask, P)     # (C, T)
            if mixture:
                mz, sz = mu_z[:, :, j], sig_z[:, :, j]
                lp = _mixture_prior_per_t(x_prop, x_cur, mz, sz, lmbda)
                lc = _mixture_prior_per_t(x_cur, x_cur, mz, sz, lmbda)
            else:
                lp = _rw_prior_per_t(x_prop, x_cur, tau_sq, sigma_sq)
                lc = _rw_prior_per_t(x_cur, x_cur, tau_sq, sigma_sq)
            if temper is not None:
                delta_ll = temper[:, None] * delta_ll
            ratio = delta_ll + lp - lc
            accept = (log_u[:, phase, j] < ratio) & ((t_idx % 2) == phase)
            X[:, :, j, :] = torch.where(accept[..., None], x_prop, x_cur)
            acc[:, :, j] += accept.to(X.dtype)
    return X, acc


def smem_bytes(T, n, d, directed=False, warps=1, cluster=1, split=False):
    """Shared memory of one block of the node-scan kernel, without a
    card (:func:`node_scan_cuda` asks the kernel library's
    ``node_scan_smem_bytes``; ``chip_smoke.py`` holds the two equal): two
    mbarriers (16 bytes), the staged adjacency rows of two nodes (2, T, Pb)
    uint8, the (T, n, d) position field (resident mode only), the directed
    mode's u and v rows (n each; split-field: the block's Pb slots), the
    exchange buffer (2, ceil(T/2), 32 * warps * cluster), the staged
    per-node scalars of two nodes (2, 4 T + 3 T d; split-field: and the
    node's T d positions and radius), the prior terms (ceil(T/2), 2) and
    the temperature, float32 but the rows; Pb = P resident, P / cluster
    split-field, whose exchange buffer holds a block's 32 * warps lanes
    and then the cluster's partials (2, ceil(T/2), cluster)."""
    P = partner_pad(n)
    H = (T + 1) // 2
    R = 32 * warps * cluster
    Pb = P // cluster if split else P
    stage = 4 * T + 3 * T * d + (T * d + 1 if split else 0)
    exchange = 32 * warps + cluster if split else R
    return 4 * (4 + T * Pb // 2 + (0 if split else T * n * d)
                + ((2 * Pb if split else 2 * n) if directed else 0)
                + 2 * H * exchange + 2 * stage + 2 * H + 1)


def max_nodes(T, d, directed=False):
    """The largest n whose (T, n, d) field some node-scan launch takes:
    the largest power of two P at which the resident mode (one block) or
    the split-field mode (a portable cluster, at most 8 blocks) fits
    shared memory.  At T = 10, d = 2: 65,536, undirected and directed (the
    split-field mode at 8 blocks; directed one warp a time).  A limit of
    shared memory only: the card must also hold the network, T n^2 bytes
    (43 GB at n = 65,536, T = 10; the split-field mode reads a second,
    residue-major copy), and the scan has run on an H100 to n = 16,384."""
    best, P = 0, 32
    while P <= 1 << 24:
        W = _widest(T, P, 1)
        fits = ((W is not None
                 and smem_bytes(T, P, d, directed, W, 1) <= _MAX_SMEM_BYTES)
                or split_layout(1, T, P, d, 1, directed) is not None)
        if not fits:
            break
        best, P = P, 2 * P
    return best


def check_smem(T, n, d, directed=False, warps=None, cluster=None, smem=None,
               split=False):
    """Raise unless the node scan takes a (T, n, d) field.  With a launch
    given (``warps``, ``cluster``, ``split``, or the kernel library's
    count ``smem`` on the card), unless its block's shared memory
    (:func:`smem_bytes` by default) fits the card's 232,448 bytes; return
    that size.  Without one, unless some launch fits (n <=
    :func:`max_nodes`; the launch :func:`launch_layout` takes for one
    chain); return its shared memory.  The message names the largest n and
    the case-control likelihood, which has no such limit."""
    if warps is None and smem is None:
        W, B, sp = launch_layout(1, T, n, d, 1, directed)
        return smem_bytes(T, n, d, directed, W, B, sp)
    if smem is None:
        smem = smem_bytes(T, n, d, directed, warps, cluster, split)
    if smem > _MAX_SMEM_BYTES:
        _too_large(T, n, d, directed,
                   'one block needs %d bytes of shared memory (%s mode, %d '
                   'warps a time, clusters of %d); the kernel holds at most '
                   '%d' % (smem, 'split-field' if split else 'resident',
                           warps, cluster, _MAX_SMEM_BYTES))
    return smem


def _too_large(T, n, d, directed, what):
    raise ValueError(
        'node_scan_cuda: at T=%d, n=%d, d=%d, directed=%s %s.  The exact '
        'dense scan\'s shared memory takes at most n = %d at this T and d; '
        'a larger network needs the case-control likelihood '
        '(n_control=...), which runs no node scan.'
        % (T, n, d, directed, what, max_nodes(T, d, directed)))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _max_clusters(index, T, n, d, warps, cluster, directed, mixture,
                  tempered, split):
    """Clusters of the launch the card at ``index`` runs at once."""
    with torch.cuda.device(index):
        count = cuda_lib.library().node_scan_max_clusters(
            T, n, d, partner_pad(n), warps, cluster, int(directed),
            int(mixture), int(tempered), int(split))
    cuda_lib.check_launch('node_scan occupancy', -count if count < 0 else 0)
    return count


def cuda_layout(C, T, n, d, index, directed, mixture, tempered,
                cluster=None, mode=None):
    """:func:`launch_layout` of the scan of C chains of (T, n, d) fields
    on the card ``index``, with its count of clusters it runs at once:
    (W, B, split)."""
    return launch_layout(
        C, T, n, d, _sm_count(index), directed, cluster, mode,
        lambda W, B, split: _max_clusters(index, T, n, d, W, B,
                                          bool(directed), bool(mixture),
                                          bool(tempered), bool(split)))


def node_scan_cuda(Y, X, intercept, step_size, eps, log_u, mu_z=None,
                   sig_z=None, lmbda=None, radii=None, *, mixture=True,
                   tau_sq=None, sigma_sq=None, temper=None, cluster=None,
                   mode=None):
    """Launch the CUDA node-scan kernel.  Undirected: Y (T, n, n) uint8
    0/1, intercept (C,).  Directed (``radii`` (C, n) given): Y packed
    ``Y + 2 Y^T`` uint8, intercept (C, 2).  Y is one network for every
    chain or one a chain, (C, T, n, n) (the launch's chain stride T n P,
    else 0).  Y may come with its rows already padded (:func:`pad_partners`,
    (T, n, P) or (C, T, n, P)); otherwise it is padded here, once per
    call.  Mixture prior: mu_z, sig_z, lmbda;
    random-walk prior (``mixture=False``): float tau_sq, sigma_sq.
    ``temper`` (C,) scales each chain's log-likelihood delta (``None``:
    untempered).  ``mode`` ('resident' or 'split') forces the mode and
    ``cluster`` (1, 2 or 4; split-field 1, 2, 4, 8 or 16) the blocks per
    chain; ``None`` takes :func:`launch_layout`'s rule: the resident mode
    wherever it fits, else the split-field mode.  The split-field mode
    reads the padded adjacency residue-major (:func:`residue_major`, kept
    on the padded Y for its next launch) and holds the field in a
    (C, T, P, d) scratch.  A resident launch adds
    one to ``node_scan_cuda.launches``, a split-field one to
    ``node_scan_cuda.split_launches``.  Every tensor float32 on the same
    CUDA device, contiguous, shaped as in :func:`node_scan_plain`."""
    C, T, n, d = X.shape
    P = partner_pad(n)
    dev = X.device
    f32 = torch.float32
    directed = radii is not None
    if dev.type != 'cuda':
        raise ValueError('node_scan_cuda: X must be a CUDA tensor')
    if directed:
        cuda_lib.check_tensor('node_scan', 'radii', radii, (C, n), f32, dev)
    if temper is not None:
        cuda_lib.check_tensor('node_scan', 'temper', temper, (C,), f32, dev)
    if mixture:
        for name, t, shape in (('mu_z', mu_z, (C, T, n, d)),
                               ('sig_z', sig_z, (C, T, n)),
                               ('lmbda', lmbda, (C,))):
            cuda_lib.check_tensor('node_scan', name, t, shape, f32, dev)
    elif tau_sq is None or sigma_sq is None:
        raise ValueError('node_scan_cuda: the random-walk prior needs '
                         'tau_sq and sigma_sq')
    per_chain = Y.dim() == 4
    y_shape = ((C,) if per_chain else ()) + (T, n, P)
    if Y.shape[-1] == n and n != P:
        Y = pad_partners(Y)
    for name, t, shape, dtype in (
            ('X', X, (C, T, n, d), f32), ('Y', Y, y_shape, torch.uint8),
            ('intercept', intercept, (C, 2) if directed else (C,), f32),
            ('step_size', step_size, (C, T, n), f32),
            ('eps', eps, (C, 2, n, T, d), f32),
            ('log_u', log_u, (C, 2, n, T), f32)):
        cuda_lib.check_tensor('node_scan', name, t, shape, dtype, dev)
    if Y.data_ptr() % 16:
        raise ValueError('node_scan_cuda: Y must start on a 16-byte '
                         'boundary (its rows are copied 16 bytes at a time)')
    warps, cluster, split = cuda_layout(C, T, n, d, dev.index, directed,
                                        mixture, temper is not None, cluster,
                                        mode)
    lib = cuda_lib.library()
    check_smem(T, n, d, directed, warps, cluster,
               smem=lib.node_scan_smem_bytes(T, n, d, P, 32 * warps * cluster,
                                             int(directed), cluster,
                                             int(split)),
               split=split)
    X_out = torch.empty_like(X)
    acc = torch.empty((C, T, n), dtype=f32, device=dev)
    field = None
    if split:
        Y = _split_rows(Y, cluster)
        field = torch.empty((C, T, P, d), dtype=f32, device=dev)
    if mixture:
        prior = (mu_z.data_ptr(), sig_z.data_ptr(), lmbda.data_ptr(), 0.0,
                 1.0)
    else:
        prior = (None, None, None, float(tau_sq), float(sigma_sq))
    # the launch goes to the current device's stream: X's card
    with torch.cuda.device(dev):
        rc = lib.node_scan_launch(
            X.data_ptr(), Y.data_ptr(), step_size.data_ptr(), eps.data_ptr(),
            log_u.data_ptr(), prior[0], prior[1], intercept.data_ptr(),
            radii.data_ptr() if directed else None, prior[2],
            temper.data_ptr() if temper is not None else None,
            X_out.data_ptr(), acc.data_ptr(),
            None if field is None else field.data_ptr(), C, T, n, d, P,
            warps, cluster, int(directed), int(mixture), prior[3], prior[4],
            T * n * P if per_chain else 0, int(split),
            cuda_lib.stream_handle(dev))
    if split:
        node_scan_cuda.split_launches += 1
    else:
        node_scan_cuda.launches += 1
    cuda_lib.check_launch('node_scan', rc)
    return X_out, acc


node_scan_cuda.launches = 0
node_scan_cuda.split_launches = 0


def node_scan(Y, X, intercept, step_size, eps, log_u, *, mu_z=None,
              sig_z=None, lmbda=None, tau_sq=None, sigma_sq=None,
              mixture=True, radii=None, temper=None):
    """The exact node scan with the mixture prior (mu_z, sig_z, lmbda) or
    the random-walk prior (``mixture=False``: tau_sq, sigma_sq), directed
    when given ``radii``, tempered when given ``temper`` (C,): the CUDA
    kernel for CUDA tensors, :func:`node_scan_plain` for CPU tensors.
    Y (T, n, n) or one network a chain (C, T, n, n), either with its rows
    padded (:func:`pad_partners`) or not."""
    if X.is_cuda:
        return node_scan_cuda(Y, X, intercept, step_size, eps, log_u, mu_z,
                              sig_z, lmbda, radii=radii, mixture=mixture,
                              tau_sq=tau_sq, sigma_sq=sigma_sq, temper=temper)
    return node_scan_plain(Y[..., :X.shape[2]], X, intercept, step_size,
                           eps, log_u, mu_z=mu_z, sig_z=sig_z, lmbda=lmbda,
                           tau_sq=tau_sq, sigma_sq=sigma_sq, mixture=mixture,
                           temper=temper, radii=radii)
