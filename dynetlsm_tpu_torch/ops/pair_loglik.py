"""Fused two-candidate undirected log-likelihood (counterpart of the pair
part of ``dynetlsm_tpu/ops/pallas_loglik.py``).

For every chain, the full undirected log-likelihood
sum_{t, i<j} y * eta - softplus(eta), eta = b - ||x_i - x_j||, at two
intercepts b_cur and b_prop (the intercept MH step's candidates).

* :func:`pair_loglik_plain` builds the dense distances by differences and
  calls ``ops/likelihoods.py::undirected_loglik_pair``.
* :func:`pair_loglik_cuda` launches ``csrc/pair_loglik.cu``, which never
  stores a distance.
* :func:`pair_loglik` picks by device: the kernel for CUDA tensors, the
  plain version for CPU tensors.

Both accumulate in float64 and return float32 (C, 2): candidate 0 is
b_cur, candidate 1 b_prop.
"""
import torch

from . import cuda_lib
from .distances import pairwise_distances
from .likelihoods import undirected_loglik_pair


def pair_loglik_plain(Y, X, b_cur, b_prop):
    """Y (T, n, n); X (C, T, n, d); b_cur, b_prop (C,).  Returns (C, 2)."""
    dist = pairwise_distances(X)
    ll_cur, ll_prop = undirected_loglik_pair(Y, dist, b_cur, b_prop)
    return torch.stack([ll_cur, ll_prop], dim=-1)


def pair_loglik_cuda(Y, X, b_cur, b_prop):
    """Launch the CUDA pair kernel.  Y (T, n, n) uint8; X (C, T, n, d),
    b_cur and b_prop (C,) float32, all contiguous on one CUDA device."""
    C, T, n, d = X.shape
    dev = X.device
    if dev.type != 'cuda':
        raise ValueError('pair_loglik_cuda: X must be a CUDA tensor')
    for name, t, shape, dtype in (
            ('X', X, (C, T, n, d), torch.float32),
            ('Y', Y, (T, n, n), torch.uint8),
            ('b_cur', b_cur, (C,), torch.float32),
            ('b_prop', b_prop, (C,), torch.float32)):
        cuda_lib.check_tensor('pair_loglik', name, t, shape, dtype, dev)
    lib = cuda_lib.library()
    n_blocks = lib.pair_loglik_row_blocks(n)
    partials = torch.empty((C, T, n_blocks, 2), dtype=torch.float64,
                           device=dev)
    out = torch.empty((C, 2), dtype=torch.float32, device=dev)
    rc = lib.pair_loglik_launch(
        X.data_ptr(), Y.data_ptr(), b_cur.data_ptr(), b_prop.data_ptr(),
        partials.data_ptr(), out.data_ptr(), C, T, n, d,
        cuda_lib.stream_handle(dev))
    pair_loglik_cuda.launches += 1
    cuda_lib.check_launch('pair_loglik', rc)
    return out


pair_loglik_cuda.launches = 0


def pair_loglik(Y, X, b_cur, b_prop):
    """(C, 2) log-likelihoods at b_cur and b_prop: the CUDA kernel for CUDA
    tensors, :func:`pair_loglik_plain` for CPU tensors."""
    if X.is_cuda:
        return pair_loglik_cuda(Y, X, b_cur, b_prop)
    return pair_loglik_plain(Y, X, b_cur, b_prop)
