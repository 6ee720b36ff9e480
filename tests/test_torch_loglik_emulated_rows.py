"""The two log-likelihood kernels' source on the host against their plain
versions: one network a chain, and the row-range mode of node sharding.

The build and the helpers are in ``tests/torch_loglik_emulation.py``;
``tests/test_torch_loglik_emulated.py`` runs the whole-network mode and
the ticket reduce with its own module-scoped build.
"""
import pytest
import torch

from dynetlsm_tpu_torch.ops import loglik_tiles
from dynetlsm_tpu_torch.ops.dir_loglik import (
    dir_loglik_plain, dir_loglik_rows_plain)
from dynetlsm_tpu_torch.ops.pair_loglik import (
    pair_loglik_plain, pair_loglik_rows_plain)

from .torch_loglik_emulation import (  # noqa: F401  (host_lib: fixture)
    RTOL, SHAPES, _block_counts, _check, _host, _inputs, _row_cuts, host_lib)


@pytest.mark.parametrize('directed', [False, True])
def test_host_kernels_per_chain_network(host_lib, directed):
    """One network a chain (the chain stride T n n; 32-bit words at n = 64
    and 76, bytes at n = 45, 37, 18 and 2): rtol 1e-5 against the plain
    version and bit-stable in both block orders, at the most candidates;
    a per-chain network whose chains all equal the shared one gives the
    shared launch's bits."""
    n_cand = 3 if directed else 2
    _check(host_lib, directed, n_cand, per_chain=True)
    for k, (C, T, n, d) in enumerate(SHAPES):
        args = _inputs(60 + k, C, T, n, d, n_cand, directed)
        same = (args[0].expand(C, -1, -1, -1).contiguous(),) + args[1:]
        G = _block_counts(T, n)[-1]
        assert torch.equal(_host(lib=host_lib, directed=directed, args=same,
                                 G=G, reverse=False),
                           _host(host_lib, directed, args, G, False)), n


@pytest.mark.parametrize('per_chain', [False, True])
@pytest.mark.parametrize('directed', [False, True])
def test_host_kernels_row_range(host_lib, directed, per_chain):
    """The row-range mode on the host: each shard's float64 share within
    rtol 1e-5 of the plain row version's and bit-stable in both block
    orders; the shards' shares add to the whole network's plain value
    (rtol 1e-5), and the mode at row0 = 0, rows = n equals the whole
    launch's float64 sum rounded once."""
    n_cand = 3 if directed else 2
    plain_rows = dir_loglik_rows_plain if directed else pair_loglik_rows_plain
    plain = dir_loglik_plain if directed else pair_loglik_plain
    for k, (C, T, n, d) in enumerate(SHAPES):
        args = _inputs(40 + k + 7 * directed, C, T, n, d, n_cand, directed,
                       per_chain)
        Y = args[0]
        whole = _host(host_lib, directed, args, 1, False)
        full = _host(host_lib, directed, args, 1, False, row0=0)
        assert torch.equal(full.float(), whole), n
        for cuts in [_row_cuts(n, k)]:
            total = torch.zeros((C, n_cand), dtype=torch.float64)
            for a, b in zip(cuts[:-1], cuts[1:]):
                part = (Y[..., a:b, :].contiguous(),) + args[1:]
                want = plain_rows(*part, row0=a)
                items = loglik_tiles.n_items(T, n, a, b - a)
                for G in sorted({1, (items + 1) // 2, items}):
                    got = _host(host_lib, directed, part, G, False, row0=a)
                    torch.testing.assert_close(got, want, rtol=RTOL,
                                               atol=1e-9)
                    again = _host(host_lib, directed, part, G, True, row0=a)
                    assert torch.equal(got, again), (n, a, G)
                total += got
            torch.testing.assert_close(total.float(), plain(*args),
                                       rtol=RTOL, atol=0.0)
