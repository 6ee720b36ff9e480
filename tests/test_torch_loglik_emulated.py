"""The two log-likelihood CUDA kernels' own source, run on the host, against
their plain versions.

``dynetlsm_tpu_torch/csrc/pair_loglik.cu`` and ``dir_loglik.cu`` (with
``loglik_common.cuh``) cannot run without a card, but their kernels are
plain C++ apart from a few intrinsics.  ``tests/torch_loglik_host.cpp``
supplies those on the host (each CUDA thread a ``std::thread``, the block
barrier and the warp shuffles emulated, blocks one after another), and this
test builds it with g++ around the kernels' source as it stands.  So the
tile walk, the split of a chain's work list over its blocks, the staging,
the masks of the diagonal and the ragged edge, both adjacency loads (32-bit
words where n is a multiple of 4, bytes elsewhere) and the two reductions
are held here to the card's standard: rtol 1e-5 against the plain version
per candidate (a float64 sum in another order, rounded once to float32).
The last block of a chain to finish adds the chain's partial sums; running
the blocks in the opposite order makes another block the last, and the
result must not change by a bit (the last test holds the final sum alone
to its index order, on values whose sum depends on the order).
"""
import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dynetlsm_tpu_torch.ops import loglik_tiles
from dynetlsm_tpu_torch.ops.dir_loglik import dir_loglik_plain
from dynetlsm_tpu_torch.ops.node_scan import pack_directed
from dynetlsm_tpu_torch.ops.pair_loglik import pair_loglik_plain

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / 'dynetlsm_tpu_torch' / 'csrc'
HOST = pathlib.Path(__file__).resolve().parent / 'torch_loglik_host.cpp'
RTOL = 1e-5

# (C, T, n, d): n a multiple of the tile and of 4; ending mid-tile with
# rows of whole words, and of odd length; Sampson's shape; the smallest
# network; three latent dimensions
SHAPES = [(2, 2, 64, 2), (2, 2, 76, 2), (3, 1, 45, 2), (4, 3, 18, 2),
          (2, 1, 2, 2), (1, 2, 37, 3)]


def _kernel_source(path):
    """A .cu up to its launch section (or the header), without the CUDA
    headers, its dynamic shared memory taken from the host block."""
    src = path.read_text().replace('#include <cuda_runtime.h>\n', '')
    src = src.replace('extern __shared__ __align__(16) float smem[];',
                      'float* smem = host_smem();')
    if '// ---- launch' in src:
        src = src[:src.index('// ---- launch')]
    return src


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build the kernel source for the host')
    out = tmp_path_factory.mktemp('loglik_host')
    for name in ('pair_loglik', 'dir_loglik'):
        (out / (name + '_kernel.inc')).write_text(
            _kernel_source(CSRC / (name + '.cu')))
    (out / 'loglik_common.cuh').write_text(
        _kernel_source(CSRC / 'loglik_common.cuh'))
    shutil.copy(HOST, out / HOST.name)
    so = out / 'libloglik_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-w',
                    '-fPIC', '-shared', '-pthread', '-o', str(so),
                    str(out / HOST.name)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pair_loglik_host.argtypes = [p] * 7 + [i] * 6
    lib.dir_loglik_host.argtypes = [p] * 7 + [i] * 7
    lib.block_finish_host.argtypes = [p] * 4 + [i] * 3
    return lib


def _inputs(seed, C, T, n, d, n_cand, directed):
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.2, (T, n, n))
    if directed:
        Y[:, np.arange(n), np.arange(n)] = 0
    else:
        Y = np.triu(Y, 1)
        Y = Y + Y.transpose(0, 2, 1)
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


def _host(lib, directed, args, G, reverse):
    """The kernel on the host with G blocks a chain.  The scratch starts
    as NaN and the tickets at 0; they must be 0 again at the end."""
    X = args[1]
    C, T, n, d = X.shape
    n_cand = args[3].shape[1] if directed else len(args) - 2
    partials = torch.full((C * G * n_cand,), float('nan'),
                          dtype=torch.float64)
    tickets = torch.zeros(C, dtype=torch.int32)
    out = torch.full((C, n_cand), float('nan'))
    if directed:
        Yp, _, radii, b = args
        rc = lib.dir_loglik_host(
            X.data_ptr(), Yp.data_ptr(), radii.data_ptr(), b.data_ptr(),
            partials.data_ptr(), tickets.data_ptr(), out.data_ptr(), C,
            n_cand, T, n, d, G, int(reverse))
    else:
        rc = lib.pair_loglik_host(
            X.data_ptr(), args[0].data_ptr(), args[2].data_ptr(),
            args[3].data_ptr() if n_cand == 2 else None,
            partials.data_ptr(), tickets.data_ptr(), out.data_ptr(), C, T, n,
            d, G, int(reverse))
    assert rc == 0
    assert not tickets.any()
    return out


def _check(lib, directed, n_cand):
    plain = dir_loglik_plain if directed else pair_loglik_plain
    for k, (C, T, n, d) in enumerate(SHAPES):
        args = _inputs(70 + 10 * k + n_cand + 5 * directed, C, T, n, d,
                       n_cand, directed)
        want = plain(*args)
        assert want.shape == (C, n_cand)
        for G in _block_counts(T, n):
            got = _host(lib, directed, args, G, reverse=False)
            torch.testing.assert_close(got, want, rtol=RTOL, atol=0.0)
            again = _host(lib, directed, args, G, reverse=True)
            assert torch.equal(got, again), (n, G)


@pytest.mark.parametrize('n_cand', [1, 2])
def test_host_pair_kernel_matches_plain(host_lib, n_cand):
    _check(host_lib, False, n_cand)


@pytest.mark.parametrize('n_cand', [1, 2, 3])
def test_host_dir_kernel_matches_plain(host_lib, n_cand):
    _check(host_lib, True, n_cand)


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


@pytest.mark.parametrize('G', [1, 40, 75, 100])
def test_host_ticket_reduce_is_in_index_order(host_lib, G):
    """The chain's sum does not depend on which block arrives last.  The
    log-likelihood's terms all have one sign, so their float64 sum rounds
    to the same float32 in almost any order; here, where a lane of the last
    block adds three blocks' values (G > 64), they are 2^60 + a, b and
    -2^60 + c with small a, b, c: in index order b is lost, in any other
    order it is not.  The blocks in both orders must give the index
    order's bits."""
    rng = np.random.RandomState(G)
    C = 2
    values = np.where(rng.rand(C, G) < 0.5, 1.0, 3.0)
    values[:, :max(G - 64, 0)] += 2.0 ** 60
    values[:, 64:] -= 2.0 ** 60
    want = np.array([_index_order_sum(v) for v in values])
    vals = torch.as_tensor(values)
    for reverse in (0, 1):
        partials = torch.full((C * G,), float('nan'), dtype=torch.float64)
        tickets = torch.zeros(C, dtype=torch.int32)
        out = torch.full((C, 1), float('nan'))
        assert host_lib.block_finish_host(
            vals.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), C, G, reverse) == 0
        assert not tickets.any()
        np.testing.assert_array_equal(out.numpy()[:, 0], want)
