"""The port's node scan (dynetlsm_tpu_torch/ops/node_scan.py) against the
JAX package's exact scan on the same injected proposal stream.

The plain PyTorch version must realise the same Markov chain as
``xla_exact_scan``: identical accept indicators, positions within
atol 1e-6 (float32 partner sums taken in another order), undirected and
directed social-radii (packed ``Y + 2 Y^T`` adjacency).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynetlsm_tpu.mcmc.latent import xla_exact_scan
from dynetlsm_tpu.ops.pallas_scan import _node_scan_with_noise
from dynetlsm_tpu_torch.ops.node_scan import (
    _kernel_order_sum, _tree_sum, check_smem, node_scan, node_scan_cuda,
    node_scan_plain, pack_directed, pad_partners, partner_pad, scan_layout,
    site_cluster_params, smem_bytes)

# (chains, T, n, mixture, tempered): the cases of tests/test_pallas_scan.py
# that the port covers (undirected)
CASES = {
    'lsm': (1, 4, 30, False, False),
    'mixture': (1, 4, 30, True, False),
    'odd_T3_lsm': (1, 3, 30, False, False),
    'odd_T5_lsm': (1, 5, 30, False, False),
    'odd_T5_mixture': (1, 5, 30, True, False),
    'large_T10_lsm': (1, 10, 20, False, False),
    'large_T11_mixture': (1, 11, 20, True, False),
    'chain_batched_mixture': (3, 4, 30, True, False),
    'chain_batched_large_T': (2, 10, 20, True, False),
    'tempered': (3, 4, 30, False, True),
}
# (chains, T, n, mixture, tempered, (b_in, b_out)): the directed cases of
# tests/test_pallas_scan.py
DIRECTED_CASES = {
    'directed_lsm': (1, 4, 30, False, False, (0.4, 0.8)),
    'directed_mixture': (1, 4, 30, True, False, (0.4, 0.8)),
    'directed_negative_intercept': (1, 4, 21, False, False, (-0.5, 0.3)),
    'directed_large_T9_mixture': (1, 9, 20, True, False, (0.4, 0.8)),
    'directed_T3_mixture': (1, 3, 20, True, False, (0.4, 0.8)),
    'directed_chain_batched_mixture': (3, 4, 30, True, False, (0.4, 0.8)),
    'directed_tempered': (3, 4, 30, False, True, (0.4, 0.8)),
}
K = 3


def _inputs(seed, C, T, n, d=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(C, T, n, d).astype(np.float32)
    Y = rng.binomial(1, 0.2, (T, n, n)).astype(np.float32)
    Y = np.triu(Y, 1) + np.transpose(np.triu(Y, 1), (0, 2, 1))
    step = np.full((C, T, n), 0.3, np.float32)
    eps = rng.randn(C, 2, n, T, d).astype(np.float32)
    log_u = np.log(rng.rand(C, 2, n, T)).astype(np.float32)
    b = (1.0 + 0.2 * rng.randn(C)).astype(np.float32)
    mu = rng.randn(C, K, d).astype(np.float32)
    sig = (rng.rand(C, K) + 0.3).astype(np.float32)
    z = rng.randint(0, K, (C, T, n))
    lmbda = np.full(C, 0.8, np.float32)
    temper = np.linspace(1.0, 0.4, C).astype(np.float32)
    return dict(X=X, Y=Y, step=step, eps=eps, log_u=log_u, b=b, mu=mu,
                sig=sig, z=z, lmbda=lmbda, temper=temper)


def _directed_inputs(seed, C, T, n, b, d=2):
    """The directed setup of tests/test_pallas_scan.py, chain-batched:
    zero-diagonal directed Y, Dirichlet(1) radii, step 0.05."""
    a = _inputs(seed, C, T, n, d)
    rng = np.random.RandomState(seed + 1000)
    Y = rng.binomial(1, 0.2, (T, n, n)).astype(np.float32)
    for t in range(T):
        np.fill_diagonal(Y[t], 0.0)
    a.update(Y=Y, step=np.full((C, T, n), 0.05, np.float32),
             radii=rng.dirichlet(np.ones(n), size=C).astype(np.float32),
             b=(np.asarray(b, np.float32)
                + 0.1 * rng.randn(C, 2)).astype(np.float32))
    return a


def _jax_scan(a, mixture, tempered, directed=False):
    """xla_exact_scan vmapped over chains (one compile per case)."""
    Y = jnp.asarray(a['Y'])
    radii = a['radii'] if directed else np.zeros(a['b'].shape[:1])

    def one(X, b, step, eps, log_u, mu, sig, z, lmbda, temper, r):
        kw = (dict(mu=mu, sigma=sig, z=z, lmbda=lmbda, mixture=True)
              if mixture else dict(tau_sq=2.0, sigma_sq=0.1, mixture=False))
        return xla_exact_scan(Y, X, b if directed else b[None], step, eps,
                              log_u, radii=r if directed else None,
                              is_directed=directed,
                              temper=temper if tempered else None, **kw)

    out = jax.jit(jax.vmap(one))(
        *(jnp.asarray(a[k]) for k in ('X', 'b', 'step', 'eps', 'log_u',
                                      'mu', 'sig')),
        jnp.asarray(a['z'], jnp.int32), jnp.asarray(a['lmbda']),
        jnp.asarray(a['temper']), jnp.asarray(radii))
    return np.asarray(out[0]), np.asarray(out[1])


def _torch_scan(a, mixture, tempered, directed=False):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    if mixture:
        mu_z, sig_z = site_cluster_params(t['mu'], t['sig'], t['z'])
        kw = dict(mu_z=mu_z, sig_z=sig_z, lmbda=t['lmbda'], mixture=True)
    else:
        kw = dict(tau_sq=2.0, sigma_sq=0.1, mixture=False)
    Y = pack_directed(t['Y']) if directed else t['Y']
    X, acc = node_scan_plain(Y, t['X'], t['b'], t['step'], t['eps'],
                             t['log_u'],
                             temper=t['temper'] if tempered else None,
                             radii=t['radii'] if directed else None, **kw)
    return X.numpy(), acc.numpy()


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_node_scan_matches_xla_scan(case):
    C, T, n, mixture, tempered = CASES[case]
    a = _inputs(sorted(CASES).index(case), C, T, n)
    X_j, acc_j = _jax_scan(a, mixture, tempered)
    X_t, acc_t = _torch_scan(a, mixture, tempered)
    assert 0.0 < acc_t.mean() < 1.0
    np.testing.assert_array_equal(acc_t, acc_j)
    np.testing.assert_allclose(X_t, X_j, atol=1e-6)


@pytest.mark.parametrize('case', sorted(DIRECTED_CASES))
def test_plain_directed_node_scan_matches_xla_scan(case):
    C, T, n, mixture, tempered, b = DIRECTED_CASES[case]
    a = _directed_inputs(50 + sorted(DIRECTED_CASES).index(case), C, T, n,
                         b)
    X_j, acc_j = _jax_scan(a, mixture, tempered, directed=True)
    X_t, acc_t = _torch_scan(a, mixture, tempered, directed=True)
    assert 0.0 < acc_t.mean() < 1.0
    np.testing.assert_array_equal(acc_t, acc_j)
    np.testing.assert_allclose(X_t, X_j, atol=1e-6)


def test_plain_directed_node_scan_matches_pallas_kernel():
    """The Pallas kernel (interpret mode) on the directed mixture case."""
    a = _directed_inputs(98, 1, 4, 30, (0.4, 0.8))
    X_p, acc_p = _node_scan_with_noise(
        jnp.asarray(a['Y']), jnp.asarray(a['X'][0]), jnp.asarray(a['b'][0]),
        jnp.asarray(a['step'][0]), jnp.asarray(a['eps'][0]),
        jnp.asarray(a['log_u'][0]), radii=jnp.asarray(a['radii'][0]),
        mu=jnp.asarray(a['mu'][0]), sigma=jnp.asarray(a['sig'][0]),
        lmbda=jnp.float32(a['lmbda'][0]),
        z=jnp.asarray(a['z'][0], jnp.int32), mixture=True, interpret=True)
    X_t, acc_t = _torch_scan(a, True, False, directed=True)
    assert 0.0 < acc_t.mean() < 1.0
    np.testing.assert_array_equal(acc_t[0], np.asarray(acc_p))
    np.testing.assert_allclose(X_t[0], np.asarray(X_p), atol=1e-6)


def test_plain_node_scan_matches_pallas_kernel():
    """The Pallas kernel (interpret mode) on the mixture case: the port
    realises the same chain as the TPU kernel it replaces."""
    a = _inputs(99, 1, 4, 30)
    X_p, acc_p = _node_scan_with_noise(
        jnp.asarray(a['Y']), jnp.asarray(a['X'][0]), float(a['b'][0]),
        jnp.asarray(a['step'][0]), jnp.asarray(a['eps'][0]),
        jnp.asarray(a['log_u'][0]), mu=jnp.asarray(a['mu'][0]),
        sigma=jnp.asarray(a['sig'][0]), lmbda=jnp.float32(a['lmbda'][0]),
        z=jnp.asarray(a['z'][0], jnp.int32), mixture=True, interpret=True)
    X_t, acc_t = _torch_scan(a, True, False)
    np.testing.assert_array_equal(acc_t[0], np.asarray(acc_p))
    np.testing.assert_allclose(X_t[0], np.asarray(X_p), atol=1e-6)


def test_node_scan_dispatch_uses_plain_on_cpu():
    a = _inputs(5, 2, 4, 12)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    mu_z, sig_z = site_cluster_params(t['mu'], t['sig'], t['z'])
    before = node_scan_cuda.launches
    X_d, acc_d = node_scan(t['Y'].to(torch.uint8), t['X'], t['b'],
                           t['step'], t['eps'], t['log_u'], mu_z=mu_z,
                           sig_z=sig_z, lmbda=t['lmbda'])
    X_p, acc_p = _torch_scan(a, True, False)
    assert node_scan_cuda.launches == before
    np.testing.assert_array_equal(acc_d.numpy(), acc_p)
    np.testing.assert_array_equal(X_d.numpy(), X_p)


def test_node_scan_cuda_rejects_cpu_tensors():
    a = _inputs(6, 1, 3, 8)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    mu_z, sig_z = site_cluster_params(t['mu'], t['sig'], t['z'])
    with pytest.raises(ValueError, match='CUDA'):
        node_scan_cuda(t['Y'].to(torch.uint8), t['X'], t['b'], t['step'],
                       t['eps'], t['log_u'], mu_z, sig_z, t['lmbda'])


def test_directed_node_scan_dispatch_uses_plain_on_cpu():
    a = _directed_inputs(8, 2, 3, 12, (0.4, 0.8))
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    mu_z, sig_z = site_cluster_params(t['mu'], t['sig'], t['z'])
    before = node_scan_cuda.launches
    X_d, acc_d = node_scan(pack_directed(t['Y']), t['X'], t['b'], t['step'],
                           t['eps'], t['log_u'], mu_z=mu_z, sig_z=sig_z,
                           lmbda=t['lmbda'], radii=t['radii'])
    X_p, acc_p = _torch_scan(a, True, False, directed=True)
    assert node_scan_cuda.launches == before
    np.testing.assert_array_equal(acc_d.numpy(), acc_p)
    np.testing.assert_array_equal(X_d.numpy(), X_p)


def test_directed_node_scan_cuda_rejects_cpu_tensors():
    a = _directed_inputs(9, 1, 3, 8, (0.4, 0.8))
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    mu_z, sig_z = site_cluster_params(t['mu'], t['sig'], t['z'])
    with pytest.raises(ValueError, match='CUDA'):
        node_scan_cuda(pack_directed(t['Y']), t['X'], t['b'], t['step'],
                       t['eps'], t['log_u'], mu_z, sig_z, t['lmbda'],
                       radii=t['radii'])


def test_pack_directed_and_smem():
    Y = (np.arange(2 * 3 * 3).reshape(2, 3, 3) % 2).astype(np.float32)
    P = pack_directed(torch.as_tensor(Y))
    assert P.dtype == torch.uint8
    np.testing.assert_array_equal((P & 1).numpy(), Y)
    np.testing.assert_array_equal((P >> 1).numpy(), Y.transpose(0, 2, 1))
    # north star: two mbarriers (16 bytes), two nodes' staged rows
    # (2 x 10 x 512 bytes), 40 KB of positions, the exchange buffer
    # (2 x 5 x 32 W B), two nodes' staged scalars (2 x 100), the prior
    # terms (10) and the temperature (1); directed, the u and v rows
    assert smem_bytes(10, 500, 2) == 4 * (4 + 2560 + 10000 + 320 + 200 + 11)
    assert smem_bytes(10, 500, 2, directed=True, warps=4, cluster=4) == \
        4 * (4 + 2560 + 10000 + 1000 + 5120 + 200 + 11)


def test_partner_pad():
    assert [partner_pad(n) for n in (1, 18, 32, 33, 500)] == \
        [32, 32, 32, 64, 512]


def _lanes(P):
    """Every (warps, cluster) the kernel allows at partner axis P."""
    return [(W, B) for W in (1, 2, 4) for B in (1, 2, 4) if 32 * W * B <= P]


@pytest.mark.parametrize('P', [32, 64, 128, 256, 512, 1024, 2048])
def test_kernel_order_sum_matches_tree_sum(P):
    """The kernel's split of the partner tree (register, exchange and
    shuffle levels over 32 W B lanes) adds in ``_tree_sum``'s order, bit
    for bit, on float32 terms of both signs spread over 1e-8 .. 1e8, where
    a sequential sum gives other bits."""
    rng = np.random.RandomState(P)
    for n in (P, P - 3, P // 2 + 1):
        a = torch.as_tensor((rng.choice([-1.0, 1.0], (8, n))
                             * 10.0 ** rng.uniform(-8, 8, (8, n)))
                            .astype(np.float32))
        want = _tree_sum(a, P)
        assert not torch.equal(torch.cumsum(a, -1)[:, -1], want)
        for warps, cluster in _lanes(P):
            got = _kernel_order_sum(a, P, warps, cluster)
            assert torch.equal(got, want), (n, warps, cluster)
    assert len(_lanes(P)) == {32: 1, 64: 3, 128: 6, 256: 8}.get(P, 9)


def test_scan_layout_rule():
    """Warps per time and blocks per chain: the north star's 32 chains
    take clusters of 2 on a 132-SM card, Sampson's 512 chains one block
    each; clusters of 4 only when forced; a forced cluster keeps the
    widest group that fits."""
    assert scan_layout(32, 10, 500, 132) == (4, 2)
    assert scan_layout(512, 3, 18, 132) == (1, 1)
    assert scan_layout(16, 10, 500, 132) == (4, 2)
    assert scan_layout(66, 10, 500, 132) == (4, 2)
    assert scan_layout(67, 10, 500, 132) == (4, 1)
    assert [scan_layout(32, 10, 500, 132, cluster=b) for b in (1, 2, 4)] \
        == [(4, 1), (4, 2), (4, 4)]
    # the card's count of clusters it runs at once: no second wave
    fits = {(4, 4): 30, (4, 2): 40}
    assert scan_layout(16, 10, 500, 132,
                       max_clusters=lambda W, B: fits[W, B]) == (4, 2)
    assert scan_layout(41, 10, 500, 132,
                       max_clusters=lambda W, B: fits[W, B]) == (4, 1)
    # few partners: the lanes of a time never outnumber P
    assert scan_layout(8, 10, 40, 132) == (2, 1)
    assert scan_layout(8, 10, 40, 132, cluster=2) == (1, 2)
    # more times: narrower groups, then groups that loop over times
    assert scan_layout(32, 20, 500, 132) == (2, 2)
    assert scan_layout(32, 61, 500, 132) == (1, 2)
    assert scan_layout(32, 61, 500, 132, cluster=4) == (1, 4)
    with pytest.raises(ValueError, match='cluster of 2'):
        scan_layout(512, 3, 18, 132, cluster=2)
    with pytest.raises(ValueError, match='1, 2 or 4'):
        scan_layout(32, 10, 500, 132, cluster=3)


def test_pad_partners():
    """Rows zero-padded to P, contiguous; the dispatcher takes a padded
    adjacency and scans as with the unpadded one."""
    Y = torch.as_tensor(np.random.RandomState(3).binomial(1, 0.3, (3, 18, 18))
                        .astype(np.uint8))
    Yp = pad_partners(Y)
    assert Yp.shape == (3, 18, 32) and Yp.is_contiguous()
    assert torch.equal(Yp[..., :18], Y) and not Yp[..., 18:].any()
    assert pad_partners(torch.zeros((2, 64, 64), dtype=torch.uint8)).shape \
        == (2, 64, 64)
    a = _inputs(17, 2, 4, 12)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    mu_z, sig_z = site_cluster_params(t['mu'], t['sig'], t['z'])
    Y8 = t['Y'].to(torch.uint8)
    rest = (t['X'], t['b'], t['step'], t['eps'], t['log_u'])
    kw = dict(mu_z=mu_z, sig_z=sig_z, lmbda=t['lmbda'])
    X_p, acc_p = node_scan(pad_partners(Y8), *rest, **kw)
    X_u, acc_u = node_scan(Y8, *rest, **kw)
    assert torch.equal(acc_p, acc_u) and torch.equal(X_p, X_u)


def test_smem_limit():
    """The north star fits at every cluster size; a field too large for
    one block raises before any launch."""
    for cluster in (1, 2, 4):
        assert check_smem(10, 500, 2, True, 4, cluster) == smem_bytes(
            10, 500, 2, True, 4, cluster) < 232448
    with pytest.raises(ValueError, match='at most 232448'):
        check_smem(10, 2800, 2)


@pytest.mark.parametrize('directed', [False, True])
def test_smem_boundary_is_n_2048(directed):
    """At T=10, d=2 the largest field one block holds is n = 2048, at the
    narrowest launch and at the launch rule's (32 chains on 132 SMs); at
    n = 2049 the partner axis pads to 4096 and every launch raises, with
    the message a user of a larger network gets."""
    layouts = [(1, 1), scan_layout(32, 10, 2048, 132)]
    for warps, cluster in layouts:
        assert check_smem(10, 2048, 2, directed, warps, cluster) <= 232448
    for warps, cluster in layouts + [scan_layout(32, 10, 2049, 132)]:
        with pytest.raises(ValueError, match='T=10, n=2049, d=2.*at most '
                           '232448.*Streaming larger fields is not '
                           'implemented'):
            check_smem(10, 2049, 2, directed, warps, cluster)


@pytest.mark.cuda
@pytest.mark.parametrize('cluster', [1, 2, 4])
@pytest.mark.parametrize('tempered', [False, True])
@pytest.mark.parametrize('mixture', [False, True])
@pytest.mark.parametrize('directed', [False, True])
def test_node_scan_kernel_matches_plain_at_each_cluster(directed, mixture,
                                                        tempered, cluster):
    """Needs an NVIDIA card with nvcc: every instantiation of the kernel
    at each forced cluster size against its plain version, identical
    accepts and positions."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the node-scan kernel has no CPU '
                    'mode')
    a = (_directed_inputs(70, 4, 5, 200, (-0.3, 0.9)) if directed
         else _inputs(71, 4, 5, 200))
    t = {k: torch.as_tensor(v).cuda() for k, v in a.items()}
    mu_z, sig_z = site_cluster_params(t['mu'], t['sig'], t['z'])
    Y = pack_directed(t['Y']) if directed else t['Y'].to(torch.uint8)
    args = (Y, t['X'], t['b'], t['step'], t['eps'], t['log_u'])
    kw = (dict(mu_z=mu_z, sig_z=sig_z, lmbda=t['lmbda']) if mixture
          else dict(mixture=False, tau_sq=2.0, sigma_sq=0.1))
    radii = t['radii'] if directed else None
    temper = t['temper'] if tempered else None
    X_k, acc_k = node_scan_cuda(pad_partners(Y), *args[1:], radii=radii,
                                temper=temper, cluster=cluster, **kw)
    X_p, acc_p = node_scan_plain(*args, radii=radii, temper=temper, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc_k, acc_p)
    assert torch.equal(X_k, X_p)


@pytest.mark.cuda
def test_node_scan_kernel_matches_plain_on_card():
    """Needs an NVIDIA card with nvcc: the CUDA kernel against its plain
    version on the card, bit-identical accepts (also checked at the
    slice's shapes by chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the node-scan kernel has no CPU '
                    'mode')
    a = _inputs(7, 4, 5, 40)
    t = {k: torch.as_tensor(v).cuda() for k, v in a.items()}
    mu_z, sig_z = site_cluster_params(t['mu'], t['sig'], t['z'])
    Y8 = t['Y'].to(torch.uint8)
    X_k, acc_k = node_scan_cuda(Y8, t['X'], t['b'], t['step'], t['eps'],
                                t['log_u'], mu_z, sig_z, t['lmbda'])
    X_p, acc_p = node_scan_plain(Y8, t['X'], t['b'], t['step'], t['eps'],
                                 t['log_u'], mu_z=mu_z, sig_z=sig_z,
                                 lmbda=t['lmbda'])
    torch.cuda.synchronize()
    assert torch.equal(acc_k, acc_p)
    torch.testing.assert_close(X_k, X_p, atol=1e-5, rtol=0.0)


@pytest.mark.cuda
def test_directed_node_scan_kernel_matches_plain_on_card():
    """Needs an NVIDIA card with nvcc: the directed mode of the CUDA kernel
    against its plain version on the card, bit-identical accepts (also
    checked at the directed slice's shapes by chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the node-scan kernel has no CPU '
                    'mode')
    a = _directed_inputs(10, 4, 5, 40, (-0.3, 0.9))
    t = {k: torch.as_tensor(v).cuda() for k, v in a.items()}
    mu_z, sig_z = site_cluster_params(t['mu'], t['sig'], t['z'])
    P = pack_directed(t['Y'])
    X_k, acc_k = node_scan_cuda(P, t['X'], t['b'], t['step'], t['eps'],
                                t['log_u'], mu_z, sig_z, t['lmbda'],
                                radii=t['radii'])
    X_p, acc_p = node_scan_plain(P, t['X'], t['b'], t['step'], t['eps'],
                                 t['log_u'], mu_z=mu_z, sig_z=sig_z,
                                 lmbda=t['lmbda'], radii=t['radii'])
    torch.cuda.synchronize()
    assert torch.equal(acc_k, acc_p)
    torch.testing.assert_close(X_k, X_p, atol=1e-5, rtol=0.0)


def _rw_dispatch_args(a, directed):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    Y = pack_directed(t['Y']) if directed else t['Y'].to(torch.uint8)
    return t, (Y, t['X'], t['b'], t['step'], t['eps'], t['log_u'])


@pytest.mark.parametrize('directed', [False, True])
def test_rw_node_scan_dispatch_uses_plain_on_cpu(directed):
    """The random-walk (LSM) prior through the dispatching ``node_scan``:
    the plain version on CPU tensors, the same chain as xla_exact_scan."""
    a = (_directed_inputs(11, 2, 3, 12, (0.4, 0.8)) if directed
         else _inputs(12, 2, 4, 12))
    t, args = _rw_dispatch_args(a, directed)
    before = node_scan_cuda.launches
    X_d, acc_d = node_scan(*args, tau_sq=2.0, sigma_sq=0.1, mixture=False,
                           radii=t['radii'] if directed else None)
    assert node_scan_cuda.launches == before
    X_p, acc_p = _torch_scan(a, False, False, directed=directed)
    np.testing.assert_array_equal(acc_d.numpy(), acc_p)
    np.testing.assert_array_equal(X_d.numpy(), X_p)
    X_j, acc_j = _jax_scan(a, False, False, directed=directed)
    assert 0.0 < acc_j.mean() < 1.0
    np.testing.assert_array_equal(acc_d.numpy(), acc_j)
    np.testing.assert_allclose(X_d.numpy(), X_j, atol=1e-6)


@pytest.mark.parametrize('directed', [False, True])
def test_rw_node_scan_cuda_rejects_cpu_tensors(directed):
    a = (_directed_inputs(13, 1, 3, 8, (0.4, 0.8)) if directed
         else _inputs(14, 1, 3, 8))
    t, args = _rw_dispatch_args(a, directed)
    with pytest.raises(ValueError, match='CUDA'):
        node_scan_cuda(*args, radii=t['radii'] if directed else None,
                       mixture=False, tau_sq=2.0, sigma_sq=0.1)


def test_rw_plain_node_scan_divides_by_tensors():
    """The plain version divides the random-walk prior's squared norms by
    tau_sq and sigma_sq as tensors, so that on the card it divides as the
    kernel does; on the CPU that is the same as dividing by the floats."""
    rng = np.random.RandomState(3)
    xs = torch.as_tensor(rng.randn(2, 4, 2).astype(np.float32))
    x_cur = torch.as_tensor(rng.randn(2, 4, 2).astype(np.float32))
    from dynetlsm_tpu_torch.ops.node_scan import _rw_prior_per_t
    by_float = _rw_prior_per_t(xs, x_cur, 2.0, 0.1)
    by_tensor = _rw_prior_per_t(xs, x_cur, torch.tensor(2.0),
                                torch.tensor(0.1))
    np.testing.assert_array_equal(by_float.numpy(), by_tensor.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize('directed', [False, True])
def test_rw_node_scan_kernel_matches_plain_on_card(directed):
    """Needs an NVIDIA card with nvcc: the random-walk-prior mode of the
    CUDA kernel against its plain version on the card, bit-identical
    accepts (also checked at the LSM slices' shapes by chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the node-scan kernel has no CPU '
                    'mode')
    a = (_directed_inputs(15, 4, 5, 40, (-0.3, 0.9)) if directed
         else _inputs(16, 4, 5, 40))
    t = {k: torch.as_tensor(v).cuda() for k, v in a.items()}
    Y = pack_directed(t['Y']) if directed else t['Y'].to(torch.uint8)
    args = (Y, t['X'], t['b'], t['step'], t['eps'], t['log_u'])
    radii = t['radii'] if directed else None
    X_k, acc_k = node_scan_cuda(*args, radii=radii, mixture=False,
                                tau_sq=2.0, sigma_sq=0.1)
    X_p, acc_p = node_scan_plain(*args, radii=radii, mixture=False,
                                 tau_sq=2.0, sigma_sq=0.1)
    torch.cuda.synchronize()
    assert torch.equal(acc_k, acc_p)
    torch.testing.assert_close(X_k, X_p, atol=1e-5, rtol=0.0)


def _latent_wiring(a, directed, mixture):
    """JAX's ``sample_latent_positions`` (vmapped over chains) and the
    port's, tempered, on the same injected proposal stream."""
    from dynetlsm_tpu.mcmc.latent import (
        sample_latent_positions as jax_sample_latent_positions)
    from dynetlsm_tpu_torch.mcmc.latent import sample_latent_positions
    Y = jnp.asarray(a['Y'])
    radii = a['radii'] if directed else np.zeros(a['b'].shape[:1])
    b = a['b'] if directed else a['b'][:, None]
    prior = (dict(mixture=True) if mixture
             else dict(tau_sq=2.0, sigma_sq=0.1, mixture=False))

    def one(X, b, step, eps, log_u, mu, sig, z, lmbda, temper, r):
        kw = dict(mu=mu, sigma=sig, z=z, lmbda=lmbda) if mixture else {}
        return jax_sample_latent_positions(
            None, Y, X, b, step, radii=r if directed else None,
            is_directed=directed, noise=(eps, log_u), temper=temper,
            **prior, **kw)

    X_j, acc_j = jax.jit(jax.vmap(one))(
        *(jnp.asarray(v) for v in (a['X'], b, a['step'], a['eps'],
                                   a['log_u'], a['mu'], a['sig'])),
        jnp.asarray(a['z'], jnp.int32), jnp.asarray(a['lmbda']),
        jnp.asarray(a['temper']), jnp.asarray(radii))
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    kw = (dict(mu=t['mu'], sigma=t['sig'], lmbda=t['lmbda'], z=t['z'])
          if mixture else {})
    Yt = pack_directed(t['Y']) if directed else t['Y'].to(torch.uint8)
    X_t, acc_t = sample_latent_positions(
        None, Yt, t['X'], torch.as_tensor(b), t['step'],
        radii=t['radii'] if directed else None, is_directed=directed,
        noise=(t['eps'], t['log_u']), temper=t['temper'], **prior, **kw)
    return (np.asarray(X_j), np.asarray(acc_j)), (X_t.numpy(), acc_t.numpy())


@pytest.mark.parametrize('directed', [False, True])
@pytest.mark.parametrize('mixture', [False, True])
def test_tempered_latent_update_matches_jax(directed, mixture):
    """``sample_latent_positions(..., temper=, noise=)`` against JAX's with
    a per-chain ladder: identical accepts, positions within atol 1e-6; and
    the temperature changes the decisions (the untempered scan differs)."""
    C = 4
    a = (_directed_inputs(60 + mixture, C, 4, 20, (0.4, 0.8)) if directed
         else _inputs(62 + mixture, C, 4, 20))
    a['temper'] = np.geomspace(1.0, 0.2, C).astype(np.float32)
    (X_j, acc_j), (X_t, acc_t) = _latent_wiring(a, directed, mixture)
    assert 0.0 < acc_t.mean() < 1.0
    np.testing.assert_array_equal(acc_t, acc_j)
    np.testing.assert_allclose(X_t, X_j, atol=1e-6)
    _, acc_u = _torch_scan(a, mixture, False, directed=directed)
    np.testing.assert_array_equal(acc_u[0], acc_t[0])
    assert not np.array_equal(acc_u[1:], acc_t[1:])


@pytest.mark.parametrize('directed', [False, True])
def test_tempered_node_scan_dispatch_uses_plain_on_cpu(directed):
    """``node_scan(..., temper=)`` on CPU tensors is the plain version, and
    ``temper`` = 1 gives the untempered chain exactly."""
    a = (_directed_inputs(64, 3, 3, 12, (0.4, 0.8)) if directed
         else _inputs(65, 3, 3, 12))
    t, args = _rw_dispatch_args(a, directed)
    radii = t['radii'] if directed else None
    before = node_scan_cuda.launches
    X_d, acc_d = node_scan(*args, tau_sq=2.0, sigma_sq=0.1, mixture=False,
                           radii=radii, temper=t['temper'])
    X_1, acc_1 = node_scan(*args, tau_sq=2.0, sigma_sq=0.1, mixture=False,
                           radii=radii, temper=torch.ones(3))
    assert node_scan_cuda.launches == before
    X_p, acc_p = _torch_scan(a, False, True, directed=directed)
    np.testing.assert_array_equal(acc_d.numpy(), acc_p)
    np.testing.assert_array_equal(X_d.numpy(), X_p)
    X_u, acc_u = _torch_scan(a, False, False, directed=directed)
    np.testing.assert_array_equal(acc_1.numpy(), acc_u)
    np.testing.assert_array_equal(X_1.numpy(), X_u)


def test_tempered_node_scan_cuda_rejects_bad_temper():
    """A CUDA launch checks ``temper`` like every other input: CPU tensors
    are refused before the temperature is looked at."""
    a = _inputs(66, 2, 3, 8)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    mu_z, sig_z = site_cluster_params(t['mu'], t['sig'], t['z'])
    with pytest.raises(ValueError, match='CUDA'):
        node_scan_cuda(t['Y'].to(torch.uint8), t['X'], t['b'], t['step'],
                       t['eps'], t['log_u'], mu_z, sig_z, t['lmbda'],
                       temper=t['temper'])


@pytest.mark.cuda
@pytest.mark.parametrize('directed', [False, True])
@pytest.mark.parametrize('mixture', [False, True])
def test_tempered_node_scan_kernel_matches_plain_on_card(directed, mixture):
    """Needs an NVIDIA card with nvcc: the tempered lane of the CUDA kernel
    against its plain version on the card, bit-identical accepts (also
    checked at the slices' shapes by chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the node-scan kernel has no CPU '
                    'mode')
    a = (_directed_inputs(67, 4, 5, 40, (-0.3, 0.9)) if directed
         else _inputs(68, 4, 5, 40))
    t = {k: torch.as_tensor(v).cuda() for k, v in a.items()}
    mu_z, sig_z = site_cluster_params(t['mu'], t['sig'], t['z'])
    Y = pack_directed(t['Y']) if directed else t['Y'].to(torch.uint8)
    args = (Y, t['X'], t['b'], t['step'], t['eps'], t['log_u'])
    kw = (dict(mu_z=mu_z, sig_z=sig_z, lmbda=t['lmbda']) if mixture
          else dict(mixture=False, tau_sq=2.0, sigma_sq=0.1))
    radii = t['radii'] if directed else None
    X_k, acc_k = node_scan_cuda(*args, radii=radii, temper=t['temper'], **kw)
    X_p, acc_p = node_scan_plain(*args, radii=radii, temper=t['temper'],
                                 **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc_k, acc_p)
    torch.testing.assert_close(X_k, X_p, atol=1e-5, rtol=0.0)
