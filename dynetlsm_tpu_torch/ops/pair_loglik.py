"""Fused undirected log-likelihood at one or two intercepts (counterpart of
the pair part of ``dynetlsm_tpu/ops/pallas_loglik.py``).

For every chain, the full undirected log-likelihood
sum_{t, i<j} y * eta - softplus(eta), eta = b - ||x_i - x_j||, at two
intercepts b_cur and b_prop (the intercept MH step's candidates) or at
b_cur alone (the replica swap's).

* :func:`pair_loglik_plain` builds the dense distances by differences and
  calls ``ops/likelihoods.py::undirected_loglik_full`` per intercept.
* :func:`pair_loglik_cuda` launches ``csrc/pair_loglik.cu`` once; it never
  stores a distance.
* :func:`pair_loglik` picks by device: the kernel for CUDA tensors, the
  plain version for CPU tensors.

Both accumulate in float64 and return float32 (C, 2), candidate 0 b_cur
and candidate 1 b_prop, or (C, 1) when ``b_prop`` is None.  Y is one
network (T, n, n) for every chain, or one a chain (C, T, n, n), as the
sweeps that resample missing dyads keep it.

The row-range mode serves node sharding (``mcmc/nodes.py``): a device
holds the rows [row0, row0 + rows) of the network, (T, rows, n) or (C, T,
rows, n), and scores the dyads i in its rows, j > i, against the whole X,
so the shards' shares cover every dyad once.  :func:`pair_loglik_rows`
returns the share in float64 (the shards' sum is rounded once):
:func:`pair_loglik_rows_cuda` launches the kernel's row-range mode,
:func:`pair_loglik_rows_plain` computes it in blocks of dyads
(``likelihoods.site_blocks``), never as dense distances.
"""
import torch

from . import cuda_lib, loglik_tiles
from .distances import _sum_sq_last, pairwise_distances
from .likelihoods import site_blocks, softplus, undirected_loglik_full
from .shards import RowShards


def pair_loglik_plain(Y, X, b_cur, b_prop=None):
    """Y (T, n, n) or (C, T, n, n); X (C, T, n, d); b_cur, b_prop (C,).
    Returns (C, 2), or (C, 1) without ``b_prop``."""
    dist = pairwise_distances(X)
    cands = (b_cur,) if b_prop is None else (b_cur, b_prop)
    return torch.stack([undirected_loglik_full(Y, dist, b) for b in cands],
                       dim=-1)


def pair_loglik_cuda(Y, X, b_cur, b_prop=None):
    """Launch the CUDA pair kernel, one launch.  Y (T, n, n) uint8, or
    one network a chain (C, T, n, n) (the launch's chain stride T n n, else
    0); X (C, T, n, d), b_cur and b_prop (C,) float32 (``b_prop`` None: one
    intercept), all contiguous on one CUDA device.

    The kernel's scratch (a partial sum per block and a ticket counter per
    chain, ``ops/loglik_tiles.py::workspace``) is held per device and
    reused by every call, so calls on one device must be ordered on one
    stream; the call neither synchronises nor resets anything from the
    host, so it can be captured in a CUDA graph."""
    C, T, n, d = X.shape
    dev = X.device
    if dev.type != 'cuda':
        raise ValueError('pair_loglik_cuda: X must be a CUDA tensor')
    n_cand = 1 if b_prop is None else 2
    per_chain = Y.dim() == 4
    for name, t, shape, dtype in (
            ('X', X, (C, T, n, d), torch.float32),
            ('Y', Y, ((C,) if per_chain else ()) + (T, n, n), torch.uint8),
            ('b_cur', b_cur, (C,), torch.float32),
            ('b_prop', b_prop, (C,), torch.float32))[:2 + n_cand]:
        cuda_lib.check_tensor('pair_loglik', name, t, shape, dtype, dev)
    G, partials, tickets = loglik_tiles.launch_layout(X, 'pair', n_cand)
    out = torch.empty((C, n_cand), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().pair_loglik_launch(
            X.data_ptr(), Y.data_ptr(), b_cur.data_ptr(),
            None if b_prop is None else b_prop.data_ptr(),
            partials.data_ptr(), tickets.data_ptr(), out.data_ptr(), C, T, n,
            d, G, T * n * n if per_chain else 0, cuda_lib.stream_handle(dev))
    pair_loglik_cuda.launches += 1
    cuda_lib.check_launch('pair_loglik', rc)
    return out


pair_loglik_cuda.launches = 0


def pair_loglik(Y, X, b_cur, b_prop=None):
    """(C, 2) log-likelihoods at b_cur and b_prop, or (C, 1) at b_cur
    alone: the CUDA kernel for CUDA tensors, :func:`pair_loglik_plain` for
    CPU tensors; a row-split network (``ops.shards.RowShards``) the sum of
    its shards' shares (:func:`pair_loglik_shards`)."""
    if isinstance(Y, RowShards):
        return pair_loglik_shards(Y, X, b_cur, b_prop)
    if X.is_cuda:
        return pair_loglik_cuda(Y, X, b_cur, b_prop)
    return pair_loglik_plain(Y, X, b_cur, b_prop)


def pair_loglik_rows_plain(Y, X, b_cur, b_prop=None, row0=0):
    """The share of the rows [row0, row0 + rows) held in Y (T, rows, n) or
    (C, T, rows, n): sum over t, i in the rows, j > i of y eta -
    softplus(eta), eta = b - ||x_i - x_j||, X (C, T, n, d) whole, in
    blocks of at most ``likelihoods._BLOCK_ELEMS`` dyads, each block's
    float32 terms added in float64.  Returns (C, 2) float64, or (C, 1)
    without ``b_prop``."""
    C, T, n, _ = X.shape
    rows = Y.shape[-2]
    b = torch.stack((b_cur,) if b_prop is None else (b_cur, b_prop), dim=-1)
    total = torch.zeros(b.shape, dtype=torch.float64, device=X.device)
    cols = torch.arange(n, device=X.device)
    for c, t, r in site_blocks(C, T, n, (row0, row0 + rows)):
        local = slice(r.start - row0, r.stop - row0)
        Yb = (Y[c, t] if Y.dim() == 4 else Y[t])[..., local, :]
        dist = torch.sqrt(torch.clamp_min(_sum_sq_last(
            X[c, t, r][:, :, :, None, :] - X[c, t][:, :, None, :, :]), 0.0))
        upper = torch.arange(r.start, r.stop, device=X.device)[:, None] < cols
        for k in range(b.shape[1]):
            eta = b[c, k, None, None, None] - dist
            terms = torch.where(upper, Yb * eta - softplus(eta), 0.0)
            total[c, k] += torch.sum(terms, dim=(1, 2, 3),
                                     dtype=torch.float64)
    return total


def pair_loglik_rows_cuda(Y, X, b_cur, b_prop=None, row0=0):
    """Launch the pair kernel's row-range mode, one launch: Y (T, rows, n)
    uint8, or one network a chain (C, T, rows, n), the rows [row0, row0 +
    rows); X (C, T, n, d), b_cur and b_prop (C,) float32, all contiguous
    on one CUDA device.  Returns (C, n_cand) float64.  Scratch and stream
    as :func:`pair_loglik_cuda`."""
    C, T, n, d = X.shape
    dev = X.device
    if dev.type != 'cuda':
        raise ValueError('pair_loglik_rows_cuda: X must be a CUDA tensor')
    rows = Y.shape[-2]
    n_cand = 1 if b_prop is None else 2
    per_chain = Y.dim() == 4
    for name, t, shape, dtype in (
            ('X', X, (C, T, n, d), torch.float32),
            ('Y', Y, ((C,) if per_chain else ()) + (T, rows, n),
             torch.uint8),
            ('b_cur', b_cur, (C,), torch.float32),
            ('b_prop', b_prop, (C,), torch.float32))[:2 + n_cand]:
        cuda_lib.check_tensor('pair_loglik_rows', name, t, shape, dtype, dev)
    G, partials, tickets = loglik_tiles.launch_layout(X, 'pair', n_cand,
                                                      row0, rows)
    out = torch.empty((C, n_cand), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().pair_loglik_rows_launch(
            X.data_ptr(), Y.data_ptr(), b_cur.data_ptr(),
            None if b_prop is None else b_prop.data_ptr(),
            partials.data_ptr(), tickets.data_ptr(), out.data_ptr(), C, T, n,
            row0, rows, d, G, T * rows * n if per_chain else 0,
            cuda_lib.stream_handle(dev))
    pair_loglik_rows_cuda.launches += 1
    cuda_lib.check_launch('pair_loglik_rows', rc)
    return out


pair_loglik_rows_cuda.launches = 0


def pair_loglik_rows(Y, X, b_cur, b_prop=None, row0=0):
    """The float64 share (C, 2), or (C, 1), of the rows held in Y: the
    kernel's row-range mode for CUDA tensors,
    :func:`pair_loglik_rows_plain` for CPU tensors."""
    if X.is_cuda:
        return pair_loglik_rows_cuda(Y, X, b_cur, b_prop, row0)
    return pair_loglik_rows_plain(Y, X, b_cur, b_prop, row0)


def pair_loglik_shards(Y, X, b_cur, b_prop=None):
    """The network log-likelihood of a row-split network Y (RowShards of
    (T, rows, n) or (C, T, rows, n)): each shard's float64 share
    (:func:`pair_loglik_rows`, on the shard's device with its own copy of the
    inputs), added on X's device in shard order and rounded once to
    float32, as the whole-network kernel rounds its float64 sum.  Returns
    (C, n_cand) float32."""
    total = None
    for s, part in enumerate(Y.parts):
        dev = part.device
        share = pair_loglik_rows(part, X.to(dev), b_cur.to(dev),
                                 None if b_prop is None else b_prop.to(dev),
                                 row0=Y.bounds[s]).to(X.device)
        total = share if total is None else total + share
    return total.to(torch.float32)
