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
  untempered, or with a per-chain temperature ``temper``).
* :func:`node_scan` picks by device: the kernel for CUDA tensors (or an
  error for what it does not take), the plain version for CPU tensors.

Both sum each site's partner terms as a pairwise tree over the partner
axis padded to :func:`partner_pad` (level s adds element i + s into
element i), so they compute bit-identical ratios.  The kernel splits that
tree over registers, warps, blocks of a cluster and shuffles
(:func:`_kernel_order_sum` spells its order out), and reads the adjacency
with its rows padded to the partner axis (:func:`pad_partners`); the
launch shape comes from :func:`scan_layout`.

The directed model takes the adjacency packed as ``Y + 2 Y^T`` uint8
(:func:`pack_directed`): row j of it holds both the out-edge bit Y[j, i]
(``& 1``) and the in-edge bit Y[i, j] (``>> 1``) of every partner i.
"""
import functools

import torch

from . import cuda_lib
from .distances import _sum_sq_last
from .likelihoods import softplus

# shared memory a block may opt into on sm_90 (232,448 bytes)
_MAX_SMEM_BYTES = 232448
# csrc/node_scan.cu: threads of one block, and groups (named barriers)
_MAX_THREADS = 768
_MAX_GROUPS = 15


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


def pad_partners(Y):
    """The adjacency (T, n, n) with its rows zero-padded to the partner
    axis, (T, n, partner_pad(n)) contiguous: the node-scan kernel copies
    whole 16-byte pieces of a row."""
    n = Y.shape[-1]
    return torch.nn.functional.pad(Y, (0, partner_pad(n) - n)).contiguous()


def scan_layout(C, T, n, sm_count, cluster=None, max_clusters=None):
    """The node-scan launch of C chains: (warps W per in-phase time,
    cluster B blocks per chain).  A block holds ceil(T/2) groups of W
    warps (at most 15, then looping over the times) and one warp for the
    prior terms, at most 768 threads (``node_scan_threads`` in
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
    groups = min((T + 1) // 2, _MAX_GROUPS)

    def widest(B):
        for W in (4, 2, 1):
            if 32 * W * groups + 32 <= _MAX_THREADS and 32 * W * B <= P:
                return W
        return None

    if cluster is None:
        W = widest(1)
        B = next(b for b in (2, 1)
                 if b == 1 or (C * b <= sm_count and 32 * W * b <= P
                               and (max_clusters is None
                                    or C <= max_clusters(W, b))))
    else:
        if cluster not in (1, 2, 4):
            raise ValueError('node_scan: cluster must be 1, 2 or 4, got %r'
                             % (cluster,))
        B, W = cluster, widest(cluster)
        if W is None:
            raise ValueError(
                'node_scan: a cluster of %d blocks needs 32 * %d = %d '
                'partner lanes, more than the padded partner axis P = %d '
                '(n = %d)' % (B, B, 32 * B, P, n))
    return W, B


def site_cluster_params(mu, sigma, z):
    """Per-site cluster mean (C, T, n, d) and variance (C, T, n) of the
    labels z (C, T, n); gathered once per scan (labels are fixed during
    the latent update)."""
    c_idx = torch.arange(z.shape[0], device=z.device)[:, None, None]
    return mu[c_idx, z], sigma[c_idx, z]


def pack_directed(Y):
    """The packed directed adjacency ``Y + 2 Y^T`` (T, n, n) uint8 of a 0/1
    adjacency Y (T, n, n)."""
    Y = torch.as_tensor(Y).to(torch.uint8)
    return Y + 2 * Y.transpose(-1, -2)


def _partial_loglik_terms(Y_row, X, x, b):
    """Per-partner Bernoulli log-lik terms of one node at candidate x
    (C, T, d) against the field X (C, T, n, d); Y_row (T, n); b (C,).
    Returns (C, T, n), the node's own slot not masked."""
    dist = torch.sqrt(torch.clamp_min(_sum_sq_last(X - x[:, :, None, :]),
                                      0.0))
    eta = b[:, None, None] - dist
    return Y_row * eta - softplus(eta)


def _directed_partial_loglik_terms(P_row, X, x, both, p_out, p_in):
    """Directed per-partner terms of one node at candidate x (C, T, d)
    against the field X (C, T, n, d), in the hoisted-reciprocal op order of
    ``dynetlsm_tpu/mcmc/latent.py::_partial_loglik_terms``.  P_row (T, n)
    packed uint8; both (C,) = b_in + b_out; p_out, p_in (C, n) the
    reciprocal rows b_in/r_i + b_out/r_j and b_out/r_i + b_in/r_j.
    Returns (C, T, n), the node's own slot not masked."""
    dist = torch.sqrt(torch.clamp_min(_sum_sq_last(X - x[:, :, None, :]),
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
    (C, 2) = (b_in, b_out).  X (C, T, n, d); step_size (C, T, n);
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
            Y_row = Yp[:, j, :]
            r_node = radii[:, j, None]
            p_out = u_row + b_out[:, None] / r_node
            p_in = v_row + b_in[:, None] / r_node

            def terms(x):
                return _directed_partial_loglik_terms(Y_row, X, x, both,
                                                      p_out, p_in)
        else:
            Y_row = Yf[:, j, :]

            def terms(x):
                return _partial_loglik_terms(Y_row, X, x, b)
        mask = (partner != j).to(X.dtype)
        for phase in (0, 1):
            x_cur = X[:, :, j, :]
            x_prop = x_cur + step_size[:, :, j, None] * eps[:, phase, j]
            ll_prop = terms(x_prop)
            ll_cur = terms(x_cur)
            delta_ll = _tree_sum((ll_prop - ll_cur) * mask, P)     # (C, T)
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


def smem_bytes(T, n, d, directed=False, warps=1, cluster=1):
    """Shared memory of one block of the node-scan kernel, without a
    card (:func:`node_scan_cuda` asks the kernel library's
    ``node_scan_smem_bytes``; ``chip_smoke.py`` holds the two equal): two
    mbarriers (16 bytes), the staged adjacency rows of two nodes (2, T, P)
    uint8, the (T, n, d) position field, the directed mode's u and v rows
    (2 n), the exchange buffer (2, ceil(T/2), 32 * warps * cluster), the
    staged per-node scalars of two nodes (2, 4 T + 3 T d), the prior terms
    (ceil(T/2), 2) and the temperature, float32 but the rows."""
    P = partner_pad(n)
    H = (T + 1) // 2
    R = 32 * warps * cluster
    return 4 * (4 + T * P // 2 + T * n * d + (2 * n if directed else 0)
                + 2 * H * R + 2 * (4 * T + 3 * T * d) + 2 * H + 1)


def check_smem(T, n, d, directed=False, warps=1, cluster=1, smem=None):
    """Raise unless one block's shared memory (``smem``, the kernel
    library's count on the card; :func:`smem_bytes` by default) fits the
    card's 232,448 bytes; return its size."""
    if smem is None:
        smem = smem_bytes(T, n, d, directed, warps, cluster)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            'node_scan_cuda: one block needs %d bytes of shared memory at '
            'T=%d, n=%d, d=%d, directed=%s, %d warps a time, clusters of %d '
            '(position field, staged rows and scalars, exchange buffer); '
            'the kernel holds at most %d.  Streaming larger fields is not '
            'implemented.' % (smem, T, n, d, directed, warps, cluster,
                              _MAX_SMEM_BYTES))
    return smem


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _max_clusters(index, T, n, d, warps, cluster, directed, mixture,
                  tempered):
    """Clusters of the launch the card at ``index`` runs at once."""
    with torch.cuda.device(index):
        count = cuda_lib.library().node_scan_max_clusters(
            T, n, d, partner_pad(n), warps, cluster, int(directed),
            int(mixture), int(tempered))
    cuda_lib.check_launch('node_scan occupancy', -count if count < 0 else 0)
    return count


def cuda_layout(C, T, n, d, index, directed, mixture, tempered,
                cluster=None):
    """:func:`scan_layout` of the scan of C chains of (T, n, d) fields on
    the card ``index``, with its count of clusters it runs at once."""
    return scan_layout(
        C, T, n, _sm_count(index), cluster,
        lambda W, B: _max_clusters(index, T, n, d, W, B, bool(directed),
                                   bool(mixture), bool(tempered)))


def node_scan_cuda(Y, X, intercept, step_size, eps, log_u, mu_z=None,
                   sig_z=None, lmbda=None, radii=None, *, mixture=True,
                   tau_sq=None, sigma_sq=None, temper=None, cluster=None):
    """Launch the CUDA node-scan kernel.  Undirected: Y (T, n, n) uint8
    0/1, intercept (C,).  Directed (``radii`` (C, n) given): Y packed
    ``Y + 2 Y^T`` uint8, intercept (C, 2).  Y may come with its rows
    already padded (:func:`pad_partners`, (T, n, P)); otherwise it is
    padded here, once per call.  Mixture prior: mu_z, sig_z, lmbda;
    random-walk prior (``mixture=False``): float tau_sq, sigma_sq.
    ``temper`` (C,) scales each chain's log-likelihood delta (``None``:
    untempered).  ``cluster`` (1, 2 or 4) forces the blocks per chain;
    ``None`` takes :func:`scan_layout`'s rule.  Every tensor float32 on
    the same CUDA device, contiguous, shaped as in
    :func:`node_scan_plain`."""
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
    if tuple(Y.shape) == (T, n, n) and n != P:
        Y = pad_partners(Y)
    for name, t, shape, dtype in (
            ('X', X, (C, T, n, d), f32), ('Y', Y, (T, n, P), torch.uint8),
            ('intercept', intercept, (C, 2) if directed else (C,), f32),
            ('step_size', step_size, (C, T, n), f32),
            ('eps', eps, (C, 2, n, T, d), f32),
            ('log_u', log_u, (C, 2, n, T), f32)):
        cuda_lib.check_tensor('node_scan', name, t, shape, dtype, dev)
    if Y.data_ptr() % 16:
        raise ValueError('node_scan_cuda: Y must start on a 16-byte '
                         'boundary (its rows are copied 16 bytes at a time)')
    warps, cluster = cuda_layout(C, T, n, d, dev.index, directed, mixture,
                                 temper is not None, cluster)
    lib = cuda_lib.library()
    check_smem(T, n, d, directed, warps, cluster,
               smem=lib.node_scan_smem_bytes(T, n, d, P, 32 * warps * cluster,
                                             int(directed)))
    X_out = torch.empty_like(X)
    acc = torch.empty((C, T, n), dtype=f32, device=dev)
    if mixture:
        prior = (mu_z.data_ptr(), sig_z.data_ptr(), lmbda.data_ptr(), 0.0,
                 1.0)
    else:
        prior = (None, None, None, float(tau_sq), float(sigma_sq))
    rc = lib.node_scan_launch(
        X.data_ptr(), Y.data_ptr(), step_size.data_ptr(), eps.data_ptr(),
        log_u.data_ptr(), prior[0], prior[1], intercept.data_ptr(),
        radii.data_ptr() if directed else None, prior[2],
        temper.data_ptr() if temper is not None else None, X_out.data_ptr(),
        acc.data_ptr(), C, T, n, d, P, warps, cluster, int(directed),
        int(mixture), prior[3], prior[4], cuda_lib.stream_handle(dev))
    node_scan_cuda.launches += 1
    cuda_lib.check_launch('node_scan', rc)
    return X_out, acc


node_scan_cuda.launches = 0


def node_scan(Y, X, intercept, step_size, eps, log_u, *, mu_z=None,
              sig_z=None, lmbda=None, tau_sq=None, sigma_sq=None,
              mixture=True, radii=None, temper=None):
    """The exact node scan with the mixture prior (mu_z, sig_z, lmbda) or
    the random-walk prior (``mixture=False``: tau_sq, sigma_sq), directed
    when given ``radii``, tempered when given ``temper`` (C,): the CUDA
    kernel for CUDA tensors, :func:`node_scan_plain` for CPU tensors.
    Y (T, n, n), or with its rows padded (:func:`pad_partners`)."""
    if X.is_cuda:
        return node_scan_cuda(Y, X, intercept, step_size, eps, log_u, mu_z,
                              sig_z, lmbda, radii=radii, mixture=mixture,
                              tau_sq=tau_sq, sigma_sq=sigma_sq, temper=temper)
    return node_scan_plain(Y[..., :X.shape[2]], X, intercept, step_size,
                           eps, log_u, mu_z=mu_z, sig_z=sig_z, lmbda=lmbda,
                           tau_sq=tau_sq, sigma_sq=sigma_sq, mixture=mixture,
                           temper=temper, radii=radii)
