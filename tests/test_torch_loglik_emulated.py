"""The two log-likelihood kernels' source on the host against their plain
versions: the whole-network mode of both kernels at every candidate
count, and the ticket reduce's index order.

The build and the helpers are in ``tests/torch_loglik_emulation.py``;
``tests/test_torch_loglik_emulated_rows.py`` runs the per-chain network
and the row-range mode with its own module-scoped build.
"""
import numpy as np
import pytest
import torch

from .torch_loglik_emulation import (  # noqa: F401  (host_lib: fixture)
    _check, _index_order_sum, host_lib)


@pytest.mark.parametrize('n_cand', [1, 2])
def test_host_pair_kernel_matches_plain(host_lib, n_cand):
    _check(host_lib, False, n_cand)


@pytest.mark.parametrize('n_cand', [1, 2, 3])
def test_host_dir_kernel_matches_plain(host_lib, n_cand):
    _check(host_lib, True, n_cand)


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
