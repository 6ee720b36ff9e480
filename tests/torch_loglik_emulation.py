"""The two log-likelihood CUDA kernels' own source, run on the host, against
their plain versions: the host build and the helpers that
``tests/test_torch_loglik_emulated*.py`` use, a share of the cases each
(one module-scoped build a file keeps each file's time in bounds).

``dynetlsm_tpu_torch/csrc/pair_loglik.cu`` and ``dir_loglik.cu`` (with
``loglik_common.cuh``) cannot run without a card, but their kernels are
plain C++ apart from a few intrinsics.  ``tests/torch_loglik_host.cpp``
supplies those on the host (``tests/cuda_host.h``: each CUDA thread a
fiber, the block barrier and the warp shuffles emulated, blocks one after
another; a deadlock fails the case), and ``tests/torch_host_build.py``
builds it with g++ around the kernels' source as it stands.  So the
tile walk, the split of a chain's work list over its blocks, the staging,
the masks of the diagonal and the ragged edge, both adjacency loads (32-bit
words where n is a multiple of 4, bytes elsewhere), one network shared by
the chains or one a chain (the chain stride of missing-dyad resampling)
and the two reductions are held here to the card's standard: rtol 1e-5
against the plain version per candidate (a float64 sum in another order,
rounded once to float32).
The last block of a chain to finish adds the chain's partial sums; running
the blocks in the opposite order makes another block the last, and the
result must not change by a bit (the last test holds the final sum alone
to its index order, on values whose sum depends on the order).
The kernels' row-range mode (node sharding: rows [row0, row0 + rows) held,
the dyads i in them, j > i, summed to float64) is held to its plain version
the same way, at row offsets that are and are not multiples of the tile
and of 4, and the shards' shares to the whole network.
"""
import ctypes

import numpy as np
import pytest
import torch

from dynetlsm_tpu_torch.ops import loglik_tiles
from dynetlsm_tpu_torch.ops.dir_loglik import dir_loglik_plain
from dynetlsm_tpu_torch.ops.node_scan import pack_directed
from dynetlsm_tpu_torch.ops.pair_loglik import pair_loglik_plain

from .torch_host_build import build

RTOL = 1e-5

# (C, T, n, d): n a multiple of the tile and of 4; ending mid-tile with
# rows of whole words, and of odd length; Sampson's shape; the smallest
# network; three latent dimensions
SHAPES = [(2, 2, 64, 2), (2, 2, 76, 2), (3, 1, 45, 2), (4, 3, 18, 2),
          (2, 1, 2, 2), (1, 2, 37, 3)]


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory, 'torch_loglik_host.cpp',
                ['pair_loglik.cu', 'dir_loglik.cu', 'loglik_common.cuh'])
    p, i = ctypes.c_void_p, ctypes.c_int
    q = ctypes.c_longlong
    lib.pair_loglik_host.argtypes = [p] * 8 + [i] * 7 + [q, i]
    lib.dir_loglik_host.argtypes = [p] * 8 + [i] * 8 + [q, i]
    lib.block_finish_host.argtypes = [p] * 4 + [i] * 3
    return lib


def _inputs(seed, C, T, n, d, n_cand, directed, per_chain=False):
    """One seed's arguments; ``per_chain``: a network (C, T, n, n) of one
    density a chain."""
    rng = np.random.RandomState(seed)
    if per_chain:
        Y = rng.binomial(1, rng.uniform(0.05, 0.4, (C, 1, 1, 1)),
                         (C, T, n, n))
    else:
        Y = rng.binomial(1, 0.2, (T, n, n))
    if directed:
        Y[..., np.arange(n), np.arange(n)] = 0
    else:
        Y = np.triu(Y, 1)
        Y = Y + np.swapaxes(Y, -1, -2)
    Y = torch.as_tensor(Y.astype(np.uint8))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    X = f32(rng.randn(C, T, n, d))
    if not directed:
        b = f32(rng.randn(C, n_cand))
        return (Y, X) + tuple(b[:, k].contiguous() for k in range(n_cand))
    b = 0.3 + 0.5 * rng.randn(C, n_cand, 2)
    b[:, 0, 0] = -np.abs(b[:, 0, 0]) - 0.1
    return pack_directed(Y), X, f32(0.5 + rng.rand(C, n_cand, n)), f32(b)


def _block_counts(T, n):
    """One block a chain, every item its own block, and one in between."""
    items = loglik_tiles.n_items(T, n)
    return sorted({1, items, max(1, (items + 1) // 2),
                   max(1, items // 3)})


def _host(lib, directed, args, G, reverse, row0=None):
    """The kernel on the host with G blocks a chain.  The scratch starts
    as NaN and the tickets at 0; they must be 0 again at the end.  With
    ``row0`` the row-range mode: args[0] holds the rows [row0, row0 +
    rows), and the float64 share is returned."""
    X = args[1]
    C, T, n, d = X.shape
    rows = args[0].shape[-2]
    n_cand = args[3].shape[1] if directed else len(args) - 2
    partials = torch.full((C * G * n_cand,), float('nan'),
                          dtype=torch.float64)
    tickets = torch.zeros(C, dtype=torch.int32)
    out = torch.full((C, n_cand), float('nan'))
    out64 = torch.full((C, n_cand), float('nan'), dtype=torch.float64)
    o32, o64 = ((None, out64.data_ptr()) if row0 is not None
                else (out.data_ptr(), None))
    y_chain = T * rows * n if args[0].dim() == 4 else 0
    r0 = row0 or 0
    if directed:
        Yp, _, radii, b = args
        rc = lib.dir_loglik_host(
            X.data_ptr(), Yp.data_ptr(), radii.data_ptr(), b.data_ptr(),
            partials.data_ptr(), tickets.data_ptr(), o32, o64, C, n_cand, T,
            n, r0, rows, d, G, y_chain, int(reverse))
    else:
        rc = lib.pair_loglik_host(
            X.data_ptr(), args[0].data_ptr(), args[2].data_ptr(),
            args[3].data_ptr() if n_cand == 2 else None,
            partials.data_ptr(), tickets.data_ptr(), o32, o64, C, T, n, r0,
            rows, d, G, y_chain, int(reverse))
    assert rc == 0
    assert not tickets.any()
    return out64 if row0 is not None else out


def _check(lib, directed, n_cand, per_chain=False):
    plain = dir_loglik_plain if directed else pair_loglik_plain
    for k, (C, T, n, d) in enumerate(SHAPES):
        args = _inputs(70 + 10 * k + n_cand + 5 * directed + 3 * per_chain,
                       C, T, n, d, n_cand, directed, per_chain)
        want = plain(*args)
        assert want.shape == (C, n_cand)
        for G in _block_counts(T, n):
            got = _host(lib, directed, args, G, reverse=False)
            torch.testing.assert_close(got, want, rtol=RTOL, atol=0.0)
            again = _host(lib, directed, args, G, reverse=True)
            assert torch.equal(got, again), (n, G)


def _row_cuts(n, k):
    """Shard boundaries of the k-th shape: halves, or (every other shape,
    where n allows it) three shards whose offsets are not multiples of 4
    nor of the tile."""
    if n >= 6 and k % 2:
        return [0, n // 3 + 1, (2 * n) // 3 + 1, n]
    return [0, n // 2, n]


def _index_order_sum(values):
    """A chain's partial sums added as the last block adds them: lane l of
    a warp takes blocks l, l + 32, ... in turn, then the lanes meet in the
    shuffle tree (16, 8, 4, 2, 1)."""
    lanes = np.zeros(32)
    for m, v in enumerate(values):
        lanes[m % 32] += v
    for h in (16, 8, 4, 2, 1):
        lanes[:h] += lanes[h:2 * h]
    return np.float32(lanes[0])
