"""The port's pair log-likelihood at one or two intercepts
(dynetlsm_tpu_torch/ops/pair_loglik.py) against the JAX package's dense
``undirected_loglik_pair`` / ``undirected_loglik_full`` and its Pallas
kernel in interpret mode.

Tolerance rtol 1e-5: a float32 sum over ~10^4 dyads, taken in another
order (the port accumulates in float64).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynetlsm_tpu.ops.distances import pairwise_distances
from dynetlsm_tpu.ops.likelihoods import (
    directed_loglik_full, undirected_loglik_full, undirected_loglik_pair)
from dynetlsm_tpu.ops.pallas_loglik import (
    _MAX_C, undirected_loglik_pair_batch)
from dynetlsm_tpu_torch.ops import likelihoods as tlik
from dynetlsm_tpu_torch.ops.pair_loglik import (
    pair_loglik, pair_loglik_cuda, pair_loglik_plain)

RTOL = 1e-5


def _inputs(seed, C, T, n, p):
    rng = np.random.RandomState(seed)
    X = rng.randn(C, T, n, 2).astype(np.float32)
    Y = rng.binomial(1, p, (T, n, n)).astype(np.float32)
    Y = np.triu(Y, 1)
    Y = Y + Y.transpose(0, 2, 1)
    b_cur = rng.randn(C).astype(np.float32)
    return X, Y, b_cur


def _jax_dense(X, Y, b_cur, b_prop):
    dist = pairwise_distances(jnp.asarray(X))
    cur, prop = jax.vmap(
        lambda dd, bc, bp: undirected_loglik_pair(jnp.asarray(Y), dd, bc, bp)
    )(dist, jnp.asarray(b_cur), jnp.asarray(b_prop))
    return np.stack([np.asarray(cur), np.asarray(prop)], axis=-1)


def _torch_plain(X, Y, b_cur, b_prop):
    return pair_loglik_plain(torch.as_tensor(Y).to(torch.uint8),
                             torch.as_tensor(X), torch.as_tensor(b_cur),
                             torch.as_tensor(b_prop)).numpy()


# mirrors test_pair_loglik_matches_xla and test_pair_loglik_chunked_chains
@pytest.mark.parametrize('C,T,n,p,db', [(3, 4, 150, 0.15, 0.3),
                                        (_MAX_C + 3, 2, 140, 0.2, 0.1)])
def test_plain_pair_loglik_matches_jax(C, T, n, p, db):
    X, Y, b_cur = _inputs(C, C, T, n, p)
    b_prop = b_cur + db
    got = _torch_plain(X, Y, b_cur, b_prop)
    np.testing.assert_allclose(got, _jax_dense(X, Y, b_cur, b_prop),
                               rtol=RTOL)
    ll_cur, ll_prop = undirected_loglik_pair_batch(
        jnp.asarray(Y), jnp.asarray(X), jnp.asarray(b_cur),
        jnp.asarray(b_prop), interpret=True)
    np.testing.assert_allclose(
        got, np.stack([np.asarray(ll_cur), np.asarray(ll_prop)], -1),
        rtol=RTOL)


@pytest.mark.parametrize('C,T,n,p', [(3, 4, 150, 0.15), (5, 3, 18, 0.3)])
def test_plain_pair_loglik_one_candidate_matches_jax(C, T, n, p):
    """Without ``b_prop`` the plain version returns (C, 1): the dense JAX
    log-likelihood at that intercept, and the two-candidate call's first
    column bit for bit."""
    X, Y, b_cur = _inputs(10 + C, C, T, n, p)
    Y8 = torch.as_tensor(Y).to(torch.uint8)
    got = pair_loglik(Y8, torch.as_tensor(X), torch.as_tensor(b_cur))
    assert got.shape == (C, 1) and got.dtype == torch.float32
    dist = pairwise_distances(jnp.asarray(X))
    want = jax.vmap(lambda dd, b: undirected_loglik_full(
        jnp.asarray(Y), dd, b))(dist, jnp.asarray(b_cur))
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(want),
                               rtol=RTOL)
    both = _torch_plain(X, Y, b_cur, b_cur + 0.3)
    np.testing.assert_array_equal(got.numpy()[:, 0], both[:, 0])


@pytest.mark.parametrize('directed', [False, True])
@pytest.mark.parametrize('per_chain', [False, True])
@pytest.mark.parametrize('block', [None, 'time', 'times'])
def test_dense_network_loglik_matches_jax(directed, per_chain, block,
                                          monkeypatch):
    """``dense_network_loglik`` (the sweeps' log joint, no (C, T, n, n)
    tensor past one block) against JAX's dense log-likelihood of each
    chain, rtol 1e-5: in one block (the one call), in blocks of one time
    a chain, and in blocks of two times a chain."""
    C, T, n = 3, 4, 40
    rng = np.random.RandomState(7 + 2 * directed + per_chain)
    X = rng.randn(C, T, n, 2).astype(np.float32)
    Y = rng.binomial(1, 0.2, ((C,) if per_chain else ()) + (T, n, n))
    if directed:
        Y[..., np.arange(n), np.arange(n)] = 0
    else:
        Y = np.triu(Y, 1)
        Y = Y + np.swapaxes(Y, -1, -2)
    Y = Y.astype(np.float32)
    b = rng.randn(C, 2 if directed else 1).astype(np.float32)
    radii = (0.5 + rng.rand(C, n)).astype(np.float32) if directed else None
    if block is not None:
        monkeypatch.setattr(tlik, '_BLOCK_ELEMS',
                            n * n * (1 if block == 'time' else 2))
    got = tlik.dense_network_loglik(
        torch.as_tensor(Y).to(torch.uint8), torch.as_tensor(X),
        torch.as_tensor(b), None if radii is None else torch.as_tensor(radii))
    dist = pairwise_distances(jnp.asarray(X))
    Yc = jnp.asarray(Y if per_chain else np.broadcast_to(Y, (C,) + Y.shape))
    if directed:
        want = jax.vmap(directed_loglik_full)(Yc, dist, jnp.asarray(radii),
                                              jnp.asarray(b[:, 0]),
                                              jnp.asarray(b[:, 1]))
    else:
        want = jax.vmap(undirected_loglik_full)(Yc, dist,
                                                jnp.asarray(b[:, 0]))
    assert got.shape == (C,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_pair_loglik_dispatch_uses_plain_on_cpu():
    X, Y, b_cur = _inputs(1, 2, 3, 40, 0.2)
    before = pair_loglik_cuda.launches
    got = pair_loglik(torch.as_tensor(Y).to(torch.uint8), torch.as_tensor(X),
                      torch.as_tensor(b_cur), torch.as_tensor(b_cur + 0.2))
    assert pair_loglik_cuda.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  _torch_plain(X, Y, b_cur, b_cur + 0.2))


def test_pair_loglik_cuda_rejects_cpu_tensors():
    X, Y, b_cur = _inputs(2, 1, 2, 10, 0.2)
    with pytest.raises(ValueError, match='CUDA'):
        pair_loglik_cuda(torch.as_tensor(Y).to(torch.uint8),
                         torch.as_tensor(X), torch.as_tensor(b_cur),
                         torch.as_tensor(b_cur))


# (seed, C, T, n): a tile and a half; n below a tile, odd; one dyad; one
# time; one chain
CARD_SHAPES = [(3, 5, 3, 130), (4, 4, 2, 45), (5, 3, 2, 2), (6, 6, 1, 76),
               (7, 1, 3, 18)]


@pytest.mark.cuda
def test_pair_loglik_kernel_matches_plain_on_card():
    """Needs an NVIDIA card with nvcc: the CUDA kernel against its plain
    version on the card at one and two intercepts, at shapes that end
    mid-tile, and bit-identical on rerun (also checked at the slice's
    shapes by chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the pair kernel has no CPU mode')
    dev = torch.device('cuda')
    for seed, C, T, n in CARD_SHAPES:
        X, Y, b_cur = _inputs(seed, C, T, n, 0.2)
        two = (torch.as_tensor(Y).to(device=dev, dtype=torch.uint8),
               torch.as_tensor(X, device=dev),
               torch.as_tensor(b_cur, device=dev),
               torch.as_tensor(b_cur + 0.3, device=dev))
        for args in (two, two[:3]):
            got = pair_loglik_cuda(*args)
            again = pair_loglik_cuda(*args)
            want = pair_loglik_plain(*args)
            torch.cuda.synchronize()
            assert got.shape == (C, len(args) - 2)
            assert torch.equal(got, again)
            torch.testing.assert_close(got, want, rtol=RTOL, atol=0.0)
