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
"""
import torch

from . import cuda_lib, loglik_tiles
from .distances import pairwise_distances
from .likelihoods import _dyad_sum, softplus

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
    n_cand = b_cands.shape[1] if b_cands.dim() == 3 else 0
    if not 1 <= n_cand <= MAX_CANDIDATES:
        raise ValueError('dir_loglik_cuda: takes 1 to %d candidates, got '
                         'b_cands of shape %s'
                         % (MAX_CANDIDATES, tuple(b_cands.shape)))
    per_chain = Y.dim() == 4
    for name, t, shape, dtype in (
            ('X', X, (C, T, n, d), f32),
            ('Y', Y, ((C,) if per_chain else ()) + (T, n, n), torch.uint8),
            ('radii_cands', radii_cands, (C, n_cand, n), f32),
            ('b_cands', b_cands, (C, n_cand, 2), f32)):
        cuda_lib.check_tensor('dir_loglik', name, t, shape, dtype, dev)
    G, partials, tickets = loglik_tiles.launch_layout(X, 'dir', n_cand)
    out = torch.empty((C, n_cand), dtype=f32, device=dev)
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
    kernel for CUDA tensors, :func:`dir_loglik_plain` for CPU tensors."""
    if X.is_cuda:
        return dir_loglik_cuda(Y, X, radii_cands, b_cands)
    return dir_loglik_plain(Y, X, radii_cands, b_cands)
