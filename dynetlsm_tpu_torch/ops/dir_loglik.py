"""Multi-candidate directed social-radii log-likelihood (counterpart of the
directed part of ``dynetlsm_tpu/ops/pallas_loglik.py``).

For every chain and each of ``n_cand`` in 1..3 candidates (b_in, b_out,
radii), the full directed log-likelihood
sum_{t, i != j} y_tij * eta_ij - softplus(eta_ij) in hoisted-reciprocal
form, eta_ij = B - d_ij * (u[j] + v[i]) with u = b_in / r, v = b_out / r
and B = b_in + b_out.  The adjacency is the packed ``Y + 2 Y^T`` uint8
(``ops/node_scan.py::pack_directed``): bit 0 of entry [t, i, j] is the
edge i -> j.

* :func:`dir_loglik_plain` builds the dense distances and evaluates the
  same formula over every ordered dyad.
* :func:`dir_loglik_cuda` launches ``csrc/dir_loglik.cu`` once; it never
  stores a distance, nor u or v.
* :func:`dir_loglik` picks by device: the kernel for CUDA tensors, the
  plain version for CPU tensors.

Both accumulate in float64 and return float32 (C, n_cand).  Y is one
packed network (T, n, n) for every chain, or one a chain (C, T, n, n), as
the sweeps that resample missing dyads keep it.

The row-range mode serves node sharding (``mcmc/nodes.py``): a device
holds the packed rows [row0, row0 + rows), (T, rows, n) or (C, T, rows,
n), each of which carries both directions of its dyads, and scores the
dyads i in its rows, j > i, against the whole X and radii, so the shards'
shares cover every dyad once.  :func:`dir_loglik_rows` returns the share
in float64: :func:`dir_loglik_rows_cuda` launches the kernel's row-range
mode, :func:`dir_loglik_rows_plain` computes it in blocks of dyads
(``likelihoods.site_blocks``), never as dense distances.
"""
import torch

from . import cuda_lib, loglik_tiles
from .distances import _sum_sq_last, pairwise_distances
from .likelihoods import _dyad_sum, site_blocks, softplus
from .shards import RowShards

MAX_CANDIDATES = 3


def dir_loglik_plain(Y, X, radii_cands, b_cands):
    """Y (T, n, n) or (C, T, n, n) packed uint8; X (C, T, n, d); radii_cands
    (C, n_cand, n); b_cands (C, n_cand, 2) as (b_in, b_out).
    Returns (C, n_cand)."""
    n = X.shape[2]
    dist = pairwise_distances(X)                        # (C, T, n, n)
    y = (Y.to(torch.uint8) & 1).to(X.dtype)             # y[t, i, j]: i -> j
    u = b_cands[..., 0:1] / radii_cands                 # (C, n_cand, n)
    v = b_cands[..., 1:2] / radii_cands
    B = b_cands[..., 0] + b_cands[..., 1]               # (C, n_cand)
    out = []
    for k in range(b_cands.shape[1]):
        s = u[:, k, None, None, :] + v[:, k, None, :, None]   # u[j] + v[i]
        eta = B[:, k, None, None, None] - dist * s
        out.append(_dyad_sum(y * eta - softplus(eta), n, scale=1.0))
    return torch.stack(out, dim=-1)


def _n_cand(name, b_cands):
    """The candidates of ``b_cands`` (C, n_cand, 2), 1 to 3."""
    n_cand = b_cands.shape[1] if b_cands.dim() == 3 else 0
    if not 1 <= n_cand <= MAX_CANDIDATES:
        raise ValueError('%s: takes 1 to %d candidates, got b_cands of '
                         'shape %s' % (name, MAX_CANDIDATES,
                                       tuple(b_cands.shape)))
    return n_cand


def dir_loglik_cuda(Y, X, radii_cands, b_cands):
    """Launch the CUDA directed kernel, one launch.  Y (T, n, n) packed
    uint8, or one network a chain (C, T, n, n) (the launch's chain stride
    T n n, else 0); X (C, T, n, d), radii_cands (C, n_cand, n) and b_cands
    (C, n_cand, 2) float32, all contiguous on one CUDA device;
    1 <= n_cand <= 3.

    The kernel's scratch (a partial sum per block and a ticket counter per
    chain, ``ops/loglik_tiles.py::workspace``) is held per device and
    reused by every call, so calls on one device must be ordered on one
    stream; the call neither synchronises nor resets anything from the
    host, so it can be captured in a CUDA graph."""
    C, T, n, d = X.shape
    dev = X.device
    f32 = torch.float32
    if dev.type != 'cuda':
        raise ValueError('dir_loglik_cuda: X must be a CUDA tensor')
    n_cand = _n_cand('dir_loglik_cuda', b_cands)
    per_chain = Y.dim() == 4
    for name, t, shape, dtype in (
            ('X', X, (C, T, n, d), f32),
            ('Y', Y, ((C,) if per_chain else ()) + (T, n, n), torch.uint8),
            ('radii_cands', radii_cands, (C, n_cand, n), f32),
            ('b_cands', b_cands, (C, n_cand, 2), f32)):
        cuda_lib.check_tensor('dir_loglik', name, t, shape, dtype, dev)
    G, partials, tickets = loglik_tiles.launch_layout(X, 'dir', n_cand)
    out = torch.empty((C, n_cand), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().dir_loglik_launch(
            X.data_ptr(), Y.data_ptr(), radii_cands.data_ptr(),
            b_cands.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), C, n_cand, T, n, d, G,
            T * n * n if per_chain else 0, cuda_lib.stream_handle(dev))
    dir_loglik_cuda.launches += 1
    cuda_lib.check_launch('dir_loglik', rc)
    return out


dir_loglik_cuda.launches = 0


def dir_loglik(Y, X, radii_cands, b_cands):
    """(C, n_cand) directed log-likelihoods of the candidates: the CUDA
    kernel for CUDA tensors, :func:`dir_loglik_plain` for CPU tensors; a
    row-split network (``ops.shards.RowShards``) the sum of its shards'
    shares (:func:`dir_loglik_shards`)."""
    if isinstance(Y, RowShards):
        return dir_loglik_shards(Y, X, radii_cands, b_cands)
    if X.is_cuda:
        return dir_loglik_cuda(Y, X, radii_cands, b_cands)
    return dir_loglik_plain(Y, X, radii_cands, b_cands)


def dir_loglik_rows_plain(Yp, X, radii_cands, b_cands, row0=0):
    """The share of the packed rows [row0, row0 + rows) held in Yp (T,
    rows, n) or (C, T, rows, n): for t, i in the rows, j > i, the edge
    i -> j (bit 0) at eta = B - d (u[j] + v[i]) and the edge j -> i (bit
    1) at eta = B - d (u[i] + v[j]), X (C, T, n, d), radii_cands (C,
    n_cand, n) and b_cands (C, n_cand, 2) whole; in blocks of at most
    ``likelihoods._BLOCK_ELEMS`` dyads, each block's float32 terms added
    in float64.  Returns (C, n_cand) float64."""
    C, T, n, _ = X.shape
    rows = Yp.shape[-2]
    u = b_cands[..., 0:1] / radii_cands                 # (C, n_cand, n)
    v = b_cands[..., 1:2] / radii_cands
    B = b_cands[..., 0] + b_cands[..., 1]               # (C, n_cand)
    total = torch.zeros(B.shape, dtype=torch.float64, device=X.device)
    cols = torch.arange(n, device=X.device)
    for c, t, r in site_blocks(C, T, n, (row0, row0 + rows)):
        local = slice(r.start - row0, r.stop - row0)
        bits = (Yp[c, t] if Yp.dim() == 4 else Yp[t])[..., local, :]
        y, yt = bits & 1, bits >> 1
        dist = torch.sqrt(torch.clamp_min(_sum_sq_last(
            X[c, t, r][:, :, :, None, :] - X[c, t][:, :, None, :, :]), 0.0))
        upper = torch.arange(r.start, r.stop, device=X.device)[:, None] < cols
        for k in range(B.shape[1]):
            u_i, v_i = u[c, k, None, r, None], v[c, k, None, r, None]
            u_j, v_j = u[c, k, None, None, :], v[c, k, None, None, :]
            Bk = B[c, k, None, None, None]
            e_out = Bk - dist * (u_j + v_i)
            e_in = Bk - dist * (u_i + v_j)
            terms = (y * e_out - softplus(e_out)) + (yt * e_in
                                                     - softplus(e_in))
            total[c, k] += torch.sum(torch.where(upper, terms, 0.0),
                                     dim=(1, 2, 3), dtype=torch.float64)
    return total


def dir_loglik_rows_cuda(Yp, X, radii_cands, b_cands, row0=0):
    """Launch the directed kernel's row-range mode, one launch: Yp (T,
    rows, n) packed uint8, or one network a chain (C, T, rows, n), the
    rows [row0, row0 + rows); X (C, T, n, d), radii_cands (C, n_cand, n)
    and b_cands (C, n_cand, 2) float32, all contiguous on one CUDA device.
    Returns (C, n_cand) float64.  Scratch and stream as
    :func:`dir_loglik_cuda`."""
    C, T, n, d = X.shape
    dev = X.device
    f32 = torch.float32
    if dev.type != 'cuda':
        raise ValueError('dir_loglik_rows_cuda: X must be a CUDA tensor')
    n_cand = _n_cand('dir_loglik_rows_cuda', b_cands)
    rows = Yp.shape[-2]
    per_chain = Yp.dim() == 4
    for name, t, shape, dtype in (
            ('X', X, (C, T, n, d), f32),
            ('Y', Yp, ((C,) if per_chain else ()) + (T, rows, n),
             torch.uint8),
            ('radii_cands', radii_cands, (C, n_cand, n), f32),
            ('b_cands', b_cands, (C, n_cand, 2), f32)):
        cuda_lib.check_tensor('dir_loglik_rows', name, t, shape, dtype, dev)
    G, partials, tickets = loglik_tiles.launch_layout(X, 'dir', n_cand,
                                                      row0, rows)
    out = torch.empty((C, n_cand), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().dir_loglik_rows_launch(
            X.data_ptr(), Yp.data_ptr(), radii_cands.data_ptr(),
            b_cands.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), C, n_cand, T, n, row0, rows, d, G,
            T * rows * n if per_chain else 0, cuda_lib.stream_handle(dev))
    dir_loglik_rows_cuda.launches += 1
    cuda_lib.check_launch('dir_loglik_rows', rc)
    return out


dir_loglik_rows_cuda.launches = 0


def dir_loglik_rows(Yp, X, radii_cands, b_cands, row0=0):
    """The float64 share (C, n_cand) of the packed rows held in Yp: the
    kernel's row-range mode for CUDA tensors, :func:`dir_loglik_rows_plain`
    for CPU tensors."""
    if X.is_cuda:
        return dir_loglik_rows_cuda(Yp, X, radii_cands, b_cands, row0)
    return dir_loglik_rows_plain(Yp, X, radii_cands, b_cands, row0)


def dir_loglik_shards(Y, X, radii_cands, b_cands):
    """The network log-likelihood of a row-split network Y (RowShards of
    (T, rows, n) or (C, T, rows, n)): each shard's float64 share
    (:func:`dir_loglik_rows`, on the shard's device with its own copy of the
    inputs), added on X's device in shard order and rounded once to
    float32, as the whole-network kernel rounds its float64 sum.  Returns
    (C, n_cand) float32."""
    total = None
    for s, part in enumerate(Y.parts):
        dev = part.device
        share = dir_loglik_rows(part, X.to(dev), radii_cands.to(dev),
                                b_cands.to(dev), row0=Y.bounds[s]).to(X.device)
        total = share if total is None else total + share
    return total.to(torch.float32)
