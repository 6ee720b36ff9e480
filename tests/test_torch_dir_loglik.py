"""The port's multi-candidate directed log-likelihood
(dynetlsm_tpu_torch/ops/dir_loglik.py) against the JAX package's Pallas
kernel in interpret mode (``directed_loglik_cands_batch``) and its dense
``directed_loglik_full``.

Tolerance rtol 2e-5, the JAX suite's own (tests/test_pallas_loglik.py): a
float32 sum over ~10^5 ordered dyads, taken in another order (the port
accumulates in float64), and the dense JAX formula rounds its terms in
another order than the hoisted one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynetlsm_tpu.ops.distances import pairwise_distances
from dynetlsm_tpu.ops.likelihoods import directed_loglik_full
from dynetlsm_tpu.ops.pallas_loglik import (
    _MAX_C_DIR, directed_loglik_cands_batch)
from dynetlsm_tpu_torch.ops.dir_loglik import (
    dir_loglik, dir_loglik_cuda, dir_loglik_plain)
from dynetlsm_tpu_torch.ops.node_scan import pack_directed
from dynetlsm_tpu_torch.ops.shards import RowShards

RTOL = 2e-5


def _inputs(seed, C, T, n, n_cand, p=0.15):
    """Zero-diagonal directed Y, Dirichlet(1) radii per candidate, and
    intercepts with a negative b_in in every chain's first candidate."""
    rng = np.random.RandomState(seed)
    X = rng.randn(C, T, n, 2).astype(np.float32)
    Y = rng.binomial(1, p, (T, n, n)).astype(np.float32)
    for t in range(T):
        np.fill_diagonal(Y[t], 0.0)
    radii = rng.dirichlet(np.ones(n), size=(C, n_cand)).astype(np.float32)
    bs = (rng.randn(C, n_cand, 2) * 0.5 + 0.3).astype(np.float32)
    bs[:, 0, 0] = -np.abs(bs[:, 0, 0]) - 0.1
    return X, Y, radii, bs


def _jax_dense(X, Y, radii, bs):
    dist = pairwise_distances(jnp.asarray(X))

    def per_chain(dd, rc, bc):
        return jax.vmap(lambda r, b: directed_loglik_full(
            jnp.asarray(Y), dd, r, b[0], b[1]))(rc, bc)

    return np.asarray(jax.vmap(per_chain)(dist, jnp.asarray(radii),
                                          jnp.asarray(bs)))


def _torch_plain(X, Y, radii, bs):
    return dir_loglik_plain(pack_directed(torch.as_tensor(Y)),
                            torch.as_tensor(X), torch.as_tensor(radii),
                            torch.as_tensor(bs)).numpy()


# n not a multiple of the Pallas tile (128) nor of the CUDA tile (32);
# the last case has more chains than one Pallas call takes (_MAX_C_DIR)
@pytest.mark.parametrize('C,T,n,n_cand', [(3, 4, 150, 1), (3, 3, 141, 2),
                                          (3, 4, 137, 3),
                                          (_MAX_C_DIR + 2, 2, 131, 1)])
def test_plain_dir_loglik_matches_jax(C, T, n, n_cand):
    X, Y, radii, bs = _inputs(n + n_cand, C, T, n, n_cand)
    got = _torch_plain(X, Y, radii, bs)
    assert got.shape == (C, n_cand)
    assert (bs < 0).any()
    np.testing.assert_allclose(got, _jax_dense(X, Y, radii, bs), rtol=RTOL)
    want = directed_loglik_cands_batch(
        jnp.asarray(Y), jnp.asarray(X), jnp.asarray(radii), jnp.asarray(bs),
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)


def test_dir_loglik_dispatch_uses_plain_on_cpu():
    X, Y, radii, bs = _inputs(1, 2, 3, 40, 2)
    before = dir_loglik_cuda.launches
    got = dir_loglik(pack_directed(torch.as_tensor(Y)), torch.as_tensor(X),
                     torch.as_tensor(radii), torch.as_tensor(bs))
    assert dir_loglik_cuda.launches == before
    np.testing.assert_array_equal(got.numpy(), _torch_plain(X, Y, radii, bs))


def test_dyad_counter_counts_the_whole_network_and_its_row_shards_alike():
    """``dir_loglik.dyads`` adds candidates x unordered dyads x T x
    chains a call, and a row-split network's shards add up to the same."""
    C, T, n, n_cand = 2, 3, 23, 2
    X, Y, radii, bs = (torch.as_tensor(a)
                       for a in _inputs(3, C, T, n, n_cand))
    Yp = pack_directed(Y)
    before = dir_loglik.dyads
    dir_loglik(Yp, X, radii, bs)
    assert dir_loglik.dyads - before == n_cand * C * T * n * (n - 1) // 2
    before = dir_loglik.dyads
    dir_loglik(RowShards.split(Yp, ['cpu'] * 3, [0, 7, 15, n]), X, radii, bs)
    assert dir_loglik.dyads - before == n_cand * C * T * n * (n - 1) // 2


def test_dir_loglik_cuda_rejects_cpu_tensors():
    X, Y, radii, bs = _inputs(2, 1, 2, 10, 1)
    with pytest.raises(ValueError, match='CUDA'):
        dir_loglik_cuda(pack_directed(torch.as_tensor(Y)),
                        torch.as_tensor(X), torch.as_tensor(radii),
                        torch.as_tensor(bs))


# (C, T, n): a tile and a half; n below a tile, odd; one dyad; one time;
# one chain
CARD_SHAPES = [(5, 3, 133), (4, 2, 45), (3, 2, 2), (6, 1, 76), (1, 3, 18)]


@pytest.mark.cuda
def test_dir_loglik_kernel_matches_plain_on_card():
    """Needs an NVIDIA card with nvcc: the CUDA kernel against its plain
    version on the card for 1, 2 and 3 candidates, at shapes that end
    mid-tile, and bit-identical on rerun (also checked at the north-star
    and Sampson shapes by chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the directed kernel has no CPU '
                    'mode')
    dev = torch.device('cuda')
    for C, T, n in CARD_SHAPES:
        for n_cand in (1, 2, 3):
            X, Y, radii, bs = _inputs(3 + n_cand, C, T, n, n_cand)
            args = (pack_directed(torch.as_tensor(Y, device=dev)),
                    torch.as_tensor(X, device=dev),
                    torch.as_tensor(radii, device=dev),
                    torch.as_tensor(bs, device=dev))
            got = dir_loglik_cuda(*args)
            again = dir_loglik_cuda(*args)
            want = dir_loglik_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
