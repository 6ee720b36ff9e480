"""The node-scan CUDA kernel's own source, run on the host, against the
plain version.

``dynetlsm_tpu_torch/csrc/node_scan.cu`` cannot run without a card, but
its kernel is plain C++ apart from a few intrinsics and its inline PTX.
``tests/torch_node_scan_host.cpp`` supplies those on the host (each CUDA
thread a ``std::thread``, the barriers, shuffles, mbarriers and
distributed-shared-memory stores emulated), and this test builds it with
g++ around the kernel's source as it stands.  So the kernel's indexing,
its split of the partner tree over lanes, warps and the blocks of a
cluster, its staging of node inputs and its barriers are held here to
the same standard as on the card: identical accepts and positions to
:func:`node_scan_plain`, in all eight instantiations and at every
(warps, cluster) the launch takes, on inputs the card check does not use.
The libraries' exp and log1p may differ from PyTorch's by an ulp, which
could flip a decision at a near-tie; none of these inputs has one.
"""
import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dynetlsm_tpu_torch.ops.node_scan import (
    node_scan_plain, pack_directed, pad_partners, partner_pad,
    site_cluster_params)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNEL = ROOT / 'dynetlsm_tpu_torch' / 'csrc' / 'node_scan.cu'
HOST = pathlib.Path(__file__).resolve().parent / 'torch_node_scan_host.cpp'

# (T, n, chains, [(warps, cluster), ...]): two partners a lane and one,
# split over warps or over a cluster; chunks of four partners (n = 130,
# P = 256); Sampson's shape
SHAPES = [(5, 40, 4, [(1, 1), (2, 1), (1, 2)]),
          (4, 130, 4, [(1, 1), (2, 2)]),
          (3, 18, 8, [(1, 1)])]


def _kernel_source():
    """The .cu up to its launch section, without the CUDA headers and the
    inline PTX, its shared memory taken from the host block."""
    src = KERNEL.read_text()
    for include in ('#include <cooperative_groups.h>\n',
                    '#include <cuda_runtime.h>\n'):
        src = src.replace(include, '')
    start = src.index('// ---- inline PTX')
    end = src.index('// ---- end of inline PTX')
    src = src[:start] + src[end:]
    src = src.replace('extern __shared__ __align__(16) float smem[];',
                      'float* smem = host_smem();')
    return src[:src.index('// ---- launch')]


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build the kernel source for the host')
    out = tmp_path_factory.mktemp('node_scan_host')
    (out / 'node_scan_kernel.inc').write_text(_kernel_source())
    shutil.copy(HOST, out / HOST.name)
    so = out / 'libnode_scan_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-w',
                    '-fPIC', '-shared', '-pthread', '-o', str(so),
                    str(out / HOST.name)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.node_scan_host.argtypes = [p] * 13 + [i] * 9 + [f] * 2
    return lib


def _inputs(seed, C, T, n, directed, d=2, K=3):
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.2, (T, n, n))
    if directed:
        Y[:, np.arange(n), np.arange(n)] = 0
    else:
        Y = np.triu(Y, 1)
        Y = Y + Y.transpose(0, 2, 1)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    t = dict(X=f32(rng.randn(C, T, n, d)), step=f32(np.full((C, T, n), 0.3)),
             eps=f32(rng.randn(C, 2, n, T, d)),
             log_u=f32(np.log(rng.rand(C, 2, n, T))),
             lmbda=f32(np.full(C, 0.8)),
             temper=f32(np.geomspace(1.0, 0.3, C)))
    mu, sig = f32(rng.randn(C, K, d)), f32(rng.rand(C, K) + 0.3)
    t['mu_z'], t['sig_z'] = (v.contiguous() for v in site_cluster_params(
        mu, sig, torch.as_tensor(rng.randint(0, K, (C, T, n)))))
    Y8 = torch.as_tensor(Y.astype(np.uint8))
    if directed:
        b = 1.0 + 0.2 * rng.randn(C, 2)
        b[::2, 0] = -0.4
        t.update(Y=pack_directed(Y8), b=f32(b),
                 radii=f32(rng.dirichlet(np.ones(n), size=C) * n / 2))
    else:
        t.update(Y=Y8, b=f32(1.0 + 0.2 * rng.randn(C)))
    return t


def _host_scan(lib, t, mixture, tempered, warps, cluster):
    C, T, n, d = t['X'].shape
    Yp = pad_partners(t['Y'])
    X_out = torch.full_like(t['X'], float('nan'))
    acc = torch.full((C, T, n), float('nan'))

    def ptr(v):
        return None if v is None else v.data_ptr()

    lib.node_scan_host(
        ptr(t['X']), ptr(Yp), ptr(t['step']), ptr(t['eps']),
        ptr(t['log_u']), ptr(t['mu_z']) if mixture else None,
        ptr(t['sig_z']) if mixture else None, ptr(t['b']),
        ptr(t.get('radii')), ptr(t['lmbda']) if mixture else None,
        ptr(t['temper']) if tempered else None, ptr(X_out), ptr(acc), C, T,
        n, d, partner_pad(n), warps, cluster, int('radii' in t),
        int(mixture), 2.0, 0.1)
    return X_out, acc


@pytest.mark.parametrize('tempered', [False, True])
@pytest.mark.parametrize('mixture', [False, True])
@pytest.mark.parametrize('directed', [False, True])
def test_host_kernel_matches_plain(host_lib, directed, mixture, tempered):
    for k, (T, n, C, layouts) in enumerate(SHAPES):
        t = _inputs(40 + 8 * k + 4 * directed + 2 * mixture + tempered, C, T,
                    n, directed)
        prior = (dict(mu_z=t['mu_z'], sig_z=t['sig_z'], lmbda=t['lmbda'])
                 if mixture else dict(mixture=False, tau_sq=2.0,
                                      sigma_sq=0.1))
        X_p, acc_p = node_scan_plain(
            t['Y'], t['X'], t['b'], t['step'], t['eps'], t['log_u'],
            radii=t.get('radii'), temper=t['temper'] if tempered else None,
            **prior)
        assert 0.0 < float(acc_p.mean()) < 1.0
        for warps, cluster in layouts:
            X_h, acc_h = _host_scan(host_lib, t, mixture, tempered, warps,
                                    cluster)
            assert torch.equal(acc_h, acc_p), (T, n, warps, cluster)
            assert torch.equal(X_h, X_p), (T, n, warps, cluster)
