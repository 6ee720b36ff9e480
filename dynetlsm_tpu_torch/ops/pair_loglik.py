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
and candidate 1 b_prop, or (C, 1) when ``b_prop`` is None.
"""
import torch

from . import cuda_lib, loglik_tiles
from .distances import pairwise_distances
from .likelihoods import undirected_loglik_full


def pair_loglik_plain(Y, X, b_cur, b_prop=None):
    """Y (T, n, n); X (C, T, n, d); b_cur, b_prop (C,).  Returns (C, 2), or
    (C, 1) without ``b_prop``."""
    dist = pairwise_distances(X)
    cands = (b_cur,) if b_prop is None else (b_cur, b_prop)
    return torch.stack([undirected_loglik_full(Y, dist, b) for b in cands],
                       dim=-1)


def pair_loglik_cuda(Y, X, b_cur, b_prop=None):
    """Launch the CUDA pair kernel, one launch.  Y (T, n, n) uint8; X
    (C, T, n, d), b_cur and b_prop (C,) float32 (``b_prop`` None: one
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
    for name, t, shape, dtype in (
            ('X', X, (C, T, n, d), torch.float32),
            ('Y', Y, (T, n, n), torch.uint8),
            ('b_cur', b_cur, (C,), torch.float32),
            ('b_prop', b_prop, (C,), torch.float32))[:2 + n_cand]:
        cuda_lib.check_tensor('pair_loglik', name, t, shape, dtype, dev)
    G, partials, tickets = loglik_tiles.launch_layout(X, 'pair', n_cand)
    out = torch.empty((C, n_cand), dtype=torch.float32, device=dev)
    rc = cuda_lib.library().pair_loglik_launch(
        X.data_ptr(), Y.data_ptr(), b_cur.data_ptr(),
        None if b_prop is None else b_prop.data_ptr(), partials.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), C, T, n, d, G,
        cuda_lib.stream_handle(dev))
    pair_loglik_cuda.launches += 1
    cuda_lib.check_launch('pair_loglik', rc)
    return out


pair_loglik_cuda.launches = 0


def pair_loglik(Y, X, b_cur, b_prop=None):
    """(C, 2) log-likelihoods at b_cur and b_prop, or (C, 1) at b_cur
    alone: the CUDA kernel for CUDA tensors, :func:`pair_loglik_plain` for
    CPU tensors."""
    if X.is_cuda:
        return pair_loglik_cuda(Y, X, b_cur, b_prop)
    return pair_loglik_plain(Y, X, b_cur, b_prop)
