"""The node-scan CUDA kernel's own source, run on the host, against the
plain version: the host build and the checks that
``tests/test_torch_node_scan_emulated*.py`` run, a share of the cases
each (one module-scoped build a file keeps each file's time in bounds).

``dynetlsm_tpu_torch/csrc/node_scan.cu`` cannot run without a card, but
its kernel is plain C++ apart from a few intrinsics and its inline PTX.
``tests/torch_node_scan_host.cpp`` supplies those on the host
(``tests/cuda_host.h``: each CUDA thread a fiber, the barriers, shuffles,
mbarriers and distributed-shared-memory stores emulated; a deadlock fails
the case), and ``tests/torch_host_build.py`` builds it with g++ around the
kernel's source as it stands.  So the kernel's indexing,
its split of the partner tree over lanes, warps and the blocks of a
cluster, its staging of node inputs and its barriers are held here to
the same standard as on the card: identical accepts and positions to
:func:`node_scan_plain`, in all eight instantiations and at every
(warps, cluster) the launch takes, on inputs the card check does not use,
with one network shared by the chains or one network a chain (the chain
stride of missing-dyad resampling), in the resident mode and in the
split-field mode (the field in X_out, each block its partners' share).
The libraries' exp and log1p may differ from PyTorch's by an ulp, which
could flip a decision at a near-tie; none of these inputs has one.
"""
import ctypes

import numpy as np
import pytest
import torch

from dynetlsm_tpu_torch.ops.node_scan import (
    node_scan_plain, pack_directed, pad_partners, partner_pad,
    residue_major, site_cluster_params)

from .torch_host_build import build

# (T, n, chains, [(warps, cluster), ...]): two partners a lane and one,
# split over warps or over a cluster; chunks of four partners (n = 130,
# P = 256); Sampson's shape
SHAPES = [(5, 40, 4, [(1, 1), (2, 1), (1, 2)]),
          (4, 130, 4, [(1, 1), (2, 2)]),
          (3, 18, 8, [(1, 1)])]


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory, 'torch_node_scan_host.cpp',
                ['node_scan.cu'])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.node_scan_host.argtypes = ([p] * 14 + [i] * 9 + [f] * 2
                                   + [ctypes.c_longlong, i])
    return lib


def _inputs(seed, C, T, n, directed, d=2, K=3, per_chain=False):
    """One seed's inputs; ``per_chain``: a network (C, T, n, n) of one
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


def _host_scan(lib, t, mixture, tempered, warps, cluster, split=False):
    """The kernel on the host, as ``node_scan_cuda`` launches it: the
    split-field mode reads the residue-major adjacency and a scratch field
    (NaN where the kernel writes before it reads)."""
    C, T, n, d = t['X'].shape
    P = partner_pad(n)
    Yp = pad_partners(t['Y'])
    y_chain = T * n * P if Yp.dim() == 4 else 0
    X_out = torch.full_like(t['X'], float('nan'))
    acc = torch.full((C, T, n), float('nan'))
    field = None
    if split:
        Yp = residue_major(Yp, cluster)
        field = torch.full((C, T, P, d), float('nan'))

    def ptr(v):
        return None if v is None else v.data_ptr()

    assert lib.node_scan_host(
        ptr(t['X']), ptr(Yp), ptr(t['step']), ptr(t['eps']),
        ptr(t['log_u']), ptr(t['mu_z']) if mixture else None,
        ptr(t['sig_z']) if mixture else None, ptr(t['b']),
        ptr(t.get('radii')), ptr(t['lmbda']) if mixture else None,
        ptr(t['temper']) if tempered else None, ptr(X_out), ptr(acc),
        ptr(field), C, T, n, d, P, warps, cluster, int('radii' in t),
        int(mixture), 2.0, 0.1, y_chain, int(split)) == 0
    return X_out, acc


def check_matches_plain(host_lib, directed, mixture, tempered):
    """The resident mode at every shape and layout of ``SHAPES``."""
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


def _prior(t, mixture):
    return (dict(mu_z=t['mu_z'], sig_z=t['sig_z'], lmbda=t['lmbda'])
            if mixture else dict(mixture=False, tau_sq=2.0, sigma_sq=0.1))


def check_per_chain_network(host_lib, directed, mixture):
    """One network a chain (the chain stride T n P): identical accepts and
    positions to the plain version, which broadcasts each chain's network
    over its own chain; and a per-chain network whose chains all equal the
    shared one gives the shared launch's bits."""
    # a cluster of two blocks, untempered; one block, tempered
    for k, (T, n, C, layouts) in enumerate([(5, 40, 4, [(1, 2)]),
                                            (3, 18, 4, [(1, 1)])]):
        tempered = k == 1
        t = _inputs(90 + 8 * k + 4 * directed + 2 * mixture, C, T, n,
                    directed, per_chain=True)
        assert t['Y'].dim() == 4 and not torch.equal(t['Y'][0], t['Y'][1])
        X_p, acc_p = node_scan_plain(
            t['Y'], t['X'], t['b'], t['step'], t['eps'], t['log_u'],
            radii=t.get('radii'), temper=t['temper'] if tempered else None,
            **_prior(t, mixture))
        assert 0.0 < float(acc_p.mean()) < 1.0
        for warps, cluster in layouts:
            X_h, acc_h = _host_scan(host_lib, t, mixture, tempered, warps,
                                    cluster)
            assert torch.equal(acc_h, acc_p), (T, n, warps, cluster)
            assert torch.equal(X_h, X_p), (T, n, warps, cluster)
        shared = _inputs(91 + 8 * k, C, T, n, directed)
        same = dict(shared, Y=shared['Y'].expand(C, -1, -1, -1).contiguous())
        warps, cluster = layouts[-1]
        want = _host_scan(host_lib, shared, mixture, tempered, warps, cluster)
        got = _host_scan(host_lib, same, mixture, tempered, warps, cluster)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the split-field mode forced at T = 4, n = 130 (P = 256): (warps,
# cluster) = (2, 4), one partner slot a lane of a block's 64 (R = P), and
# (1, 2), four partners a lane; both padded past n
SPLIT_LAYOUTS = [(2, 4), (1, 2)]


def check_split_field(host_lib, directed, mixture, tempered):
    """The split-field mode (no block holds the field: block r of a
    cluster of B reads and writes the positions of its partners i = r
    (mod B) in its run of the residue-major scratch, stages its run of the
    residue-major rows and u, v, keeps the node's own positions in shared
    memory and exchanges one partial a time) gives the plain version's
    accepts and positions, with one network shared by the chains and one a
    chain."""
    T, n = 4, 130
    # one chain shares the network; two chains read one network each at
    # the chain stride
    for per_chain, C in ((False, 1), (True, 2)):
        t = _inputs(120 + 8 * per_chain + 4 * directed + 2 * mixture
                    + tempered, C, T, n, directed, per_chain=per_chain)
        X_p, acc_p = node_scan_plain(
            t['Y'], t['X'], t['b'], t['step'], t['eps'], t['log_u'],
            radii=t.get('radii'), temper=t['temper'] if tempered else None,
            **_prior(t, mixture))
        assert 0.0 < float(acc_p.mean()) < 1.0
        for warps, cluster in SPLIT_LAYOUTS:
            X_h, acc_h = _host_scan(host_lib, t, mixture, tempered, warps,
                                    cluster, split=True)
            assert torch.equal(acc_h, acc_p), (per_chain, warps, cluster)
            assert torch.equal(X_h, X_p), (per_chain, warps, cluster)
