"""Each site's log-likelihood delta of the 'parallel' latent update
(``mcmc/latent.py::_parallel_site_update``; JAX's ``site_ll`` at the
proposal minus at the current position).

For every chain c, time t and site i, its proposal X_prop[c, t, i] and its
position X[c, t, i] scored against the stale field X[c, t] over its whole
row of partners j != i: undirected y_ij eta - softplus(eta), eta = b - d;
directed the sender's and the receiver's terms from the packed ``Y + 2
Y^T`` (b_in (1 - d / r_j) + b_out (1 - d / r_i) on y_ij, the roles of the
radii swapped on y_ji).

* :func:`site_loglik_plain` is the port's eager version: each candidate's
  row sums in blocks of at most ``likelihoods._BLOCK_ELEMS`` dyads, then
  their difference.
* :func:`site_loglik_cuda` launches ``csrc/site_loglik.cu`` once; it never
  stores a distance and sums the per-partner differences.
* :func:`site_loglik` picks by device: the kernel for CUDA tensors, the
  plain version for CPU tensors.

Y is the kernels' form of the network: (T, n, S) uint8, or one network a
chain (C, T, n, S), rows of S >= n bytes (the node scan's padded rows,
``node_scan.pad_partners``, as the sweeps store them).  The row-range mode
serves node sharding (``mcmc/nodes.py``): Y holds the rows [row0, row0 +
rows), (T, rows, S) or (C, T, rows, S), and the result is the delta of
those sites, each still against all n partners
(:func:`site_loglik_rows_cuda`).  Returns (C, T, rows) float32.
"""
import functools

import torch

from . import cuda_lib, likelihoods
from .distances import _sum_sq_last
from .likelihoods import site_blocks, softplus

# the kernel's threads a block (csrc/site_loglik.cu, kThreads), the
# partners a 32-bit word of a row, the bytes of field (and radii) a block
# stages at once (three blocks an SM below 227 KB), the most sites a lane
# group takes in turn, and the blocks a launch aims at, as a multiple of
# what the card holds at once
THREADS = 256
WORD = 4
STAGE_BYTES = 72 * 1024
MAX_PER_GROUP = 8
WAVES = 8


def block_network(Y, c, t, r, n, is_directed, row0=0):
    """(Y_row, Y_col, off) of one block's sites r of times t (chains c
    when Y is one network a chain), from the kernels' form of the network
    ((C,) T, n, n or padded rows; a node shard's rows from ``row0``): the
    0/1 adjacency Y[t, i, j] of each site i of r and partner j and,
    directed, Y[t, j, i] (the packed bits ``& 1`` and ``>> 1``; None when
    undirected), uint8 (arithmetic with float32 promotes them exactly, no
    float copy made); and the (sites, n) bool mask of the partners other
    than the site itself."""
    local = slice(r.start - row0, r.stop - row0)
    Yb = (Y[c, t] if Y.dim() == 4 else Y[t])[..., local, :n]
    rows = torch.arange(r.start, r.stop, device=Yb.device)
    off = rows[:, None] != torch.arange(n, device=Yb.device)
    if is_directed:
        return Yb & 1, Yb >> 1, off
    return Yb, None, off


def site_block(Y, X, Xq, intercept, radii, is_directed, c, t, r, row0=0):
    """The row sums of one block's sites at their candidates Xq against
    the field X (its temporaries freed on return)."""
    Y_row, Y_col, off = block_network(Y, c, t, r, X.shape[2], is_directed,
                                      row0)
    diff = Xq[c, t, r][:, :, :, None, :] - X[c, t][:, :, None, :, :]
    dist = torch.sqrt(torch.clamp_min(_sum_sq_last(diff), 0.0))
    del diff
    b0 = intercept[c, 0, None, None, None]
    if is_directed:
        b1 = intercept[c, 1, None, None, None]
        r_self = radii[c, None, r, None]
        r_other = radii[c, None, None, :]
        eta_out = b0 * (1.0 - dist / r_other) + b1 * (1.0 - dist / r_self)
        eta_in = b0 * (1.0 - dist / r_self) + b1 * (1.0 - dist / r_other)
        ll = Y_row * eta_out - softplus(eta_out)
        ll = ll + (Y_col * eta_in - softplus(eta_in))
    else:
        eta = b0 - dist
        ll = Y_row * eta - softplus(eta)
    return torch.sum(ll.masked_fill_(~off, 0.0), dim=-1)


def site_loglik_plain(Y, X, X_prop, intercept, radii=None,
                      is_directed=False, row0=0):
    """The delta of the sites of Y's rows [row0, row0 + rows): each
    candidate's row sums (:func:`site_block`, in blocks of
    ``likelihoods.site_blocks`` of at most ``likelihoods._BLOCK_ELEMS``
    dyads, which cut only the site axis, so each site's sum is over the
    same row), the
    proposal's minus the position's.  X, X_prop (C, T, n, d); intercept
    (C, 1), directed (C, 2) = (b_in, b_out) with radii (C, n).  Returns
    (C, T, rows)."""
    C, T, n, _ = X.shape
    rows = Y.shape[-2]
    ll = torch.empty((2, C, T, rows), dtype=X.dtype, device=X.device)
    for c, t, r in site_blocks(C, T, n, (row0, row0 + rows),
                               likelihoods._BLOCK_ELEMS):
        local = slice(r.start - row0, r.stop - row0)
        for k, Xq in enumerate((X_prop, X)):
            ll[k, c, t, local] = site_block(Y, X, Xq, intercept, radii,
                                            is_directed, c, t, r, row0)
    return ll[0] - ll[1]


def lanes_per_site(n):
    """Lanes a site's row takes: a word of partners a lane, up to a
    warp."""
    lanes = 1
    while lanes < 32 and WORD * lanes < n:
        lanes *= 2
    return lanes


def stage_chunk(n, d, is_directed):
    """Partners a block stages at once: the whole row where its
    coordinates (and radii) fit ``STAGE_BYTES``, else equal chunks that
    do; a multiple of ``WORD``."""
    per = 4 * (d + bool(is_directed))
    chunks = -(-per * n // STAGE_BYTES)
    chunk = -(-n // chunks)
    return -(-chunk // WORD) * WORD


def launch_layout(C, T, n, rows, d, is_directed, resident):
    """(lanes a site, sites a lane group takes in turn, partners staged
    at once) of a launch over C chains, T times and ``rows`` sites of n
    partners: the most sites a group (up to ``MAX_PER_GROUP``) that still
    leaves ``WAVES`` times the blocks the card holds at once,
    ``resident(per_group, chunk)``, so the staging is shared by many
    sites without a short last wave."""
    lanes = lanes_per_site(n)
    chunk = stage_chunk(n, d, is_directed)
    groups = THREADS // lanes
    row_groups = -(-rows // groups)
    per_group = 1
    while (per_group < min(MAX_PER_GROUP, row_groups)
           and C * T * row_groups // (2 * per_group)
           >= WAVES * resident(2 * per_group, chunk)):
        per_group *= 2
    return lanes, per_group, chunk


@functools.lru_cache(maxsize=None)
def _resident(index, n, d, is_directed, per_group, chunk):
    """Blocks of the launch that the card at ``index`` holds at once."""
    with torch.cuda.device(index):
        lib = cuda_lib.library()
        smem = lib.site_loglik_smem_bytes(n, d, int(is_directed), chunk,
                                          per_group)
        per_sm = lib.site_loglik_blocks_per_sm(int(is_directed), d, smem)
        sms = torch.cuda.get_device_properties(index).multi_processor_count
    cuda_lib.check_launch('site_loglik occupancy',
                          -per_sm if per_sm < 0 else 0)
    return sms * per_sm


def _launch(name, Y, X, X_prop, intercept, radii, is_directed, row0,
            chunk=None):
    """One launch of the kernel, the launch rule's layout; ``chunk``
    forces the partners staged at once (rounded up to a word; tests)."""
    C, T, n, d = X.shape
    dev = X.device
    if dev.type != 'cuda':
        raise ValueError('%s: X must be a CUDA tensor' % name)
    rows, S = Y.shape[-2:]
    per_chain = Y.dim() == 4
    checks = [('X', X, (C, T, n, d), torch.float32),
              ('X_prop', X_prop, (C, T, n, d), torch.float32),
              ('Y', Y, ((C,) if per_chain else ()) + (T, rows, S),
               torch.uint8),
              ('intercept', intercept, (C, 2 if is_directed else 1),
               torch.float32)]
    if is_directed:
        checks.append(('radii', radii, (C, n), torch.float32))
    for arg, t, shape, dtype in checks:
        cuda_lib.check_tensor(name, arg, t, shape, dtype, dev)
    if S < n or not 0 <= row0 <= n - rows:
        raise ValueError('%s: rows [%d, %d) of %d bytes each do not hold '
                         'the network of %d nodes' % (name, row0, row0 + rows,
                                                      S, n))
    lanes, per_group, rule = launch_layout(
        C, T, n, rows, d, is_directed,
        lambda k, L: _resident(dev.index, n, d, bool(is_directed), k, L))
    chunk = rule if chunk is None else -(-chunk // WORD) * WORD
    out = torch.empty((C, T, rows), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().site_loglik_launch(
            X.data_ptr(), X_prop.data_ptr(), Y.data_ptr(),
            intercept.data_ptr(), radii.data_ptr() if is_directed else None,
            out.data_ptr(), C, T, n, row0, rows, d, int(is_directed), lanes,
            per_group, chunk, T * rows * S if per_chain else 0, rows * S, S,
            cuda_lib.stream_handle(dev))
    cuda_lib.check_launch(name, rc)
    return out


def site_loglik_cuda(Y, X, X_prop, intercept, radii=None, is_directed=False):
    """Launch the CUDA site kernel over the whole network, one launch: Y
    (T, n, S) or (C, T, n, S) uint8 (packed when directed), X and X_prop
    (C, T, n, d), intercept (C, 1) or directed (C, 2), radii (C, n)
    float32, all contiguous on one CUDA device.  Returns (C, T, n)
    float32.  It
    neither synchronises nor allocates beyond its output, so it can be
    captured in a CUDA graph."""
    out = _launch('site_loglik', Y, X, X_prop, intercept, radii,
                  is_directed, 0)
    site_loglik_cuda.launches += 1
    return out


site_loglik_cuda.launches = 0


def site_loglik_rows_cuda(Y, X, X_prop, intercept, radii=None,
                          is_directed=False, row0=0):
    """The kernel's row-range mode, one launch: Y (T, rows, S) or (C, T,
    rows, S) holds the rows [row0, row0 + rows); the rest as
    :func:`site_loglik_cuda`.  Returns (C, T, rows) float32."""
    out = _launch('site_loglik_rows', Y, X, X_prop, intercept, radii,
                  is_directed, row0)
    site_loglik_rows_cuda.launches += 1
    return out


site_loglik_rows_cuda.launches = 0


def site_loglik(Y, X, X_prop, intercept, radii=None, is_directed=False,
                row0=0):
    """(C, T, rows) deltas of the sites of Y's rows: the CUDA kernel for
    CUDA tensors (the row-range mode unless Y holds every row),
    :func:`site_loglik_plain` for CPU tensors."""
    if not X.is_cuda:
        return site_loglik_plain(Y, X, X_prop, intercept, radii,
                                 is_directed, row0)
    if row0 == 0 and Y.shape[-2] == X.shape[2]:
        return site_loglik_cuda(Y, X, X_prop, intercept, radii, is_directed)
    return site_loglik_rows_cuda(Y, X, X_prop, intercept, radii, is_directed,
                                 row0)
