"""The work split of the two log-likelihood kernels, spelled out in Python
(dynetlsm_tpu_torch/ops/loglik_tiles.py) as ``csrc/loglik_common.cuh``
computes it: the tiles of a chain's work list score every dyad i < j once,
and the blocks' shares cut the list into contiguous parts that differ by at
most one tile, for every network size and every block count.  The kernels'
own source is held to the same split by
tests/test_torch_loglik_emulated.py.
"""
import numpy as np
import pytest
import torch

from dynetlsm_tpu_torch.ops import loglik_tiles
from dynetlsm_tpu_torch.ops.loglik_tiles import (
    MIN_TILES, TILE, WAVES, block_share, blocks_per_chain, n_items,
    tiles_per_side, work_item, workspace)


def tile_dyads(ti, tj, n):
    """The dyads (i, j), i < j < n, that tile (ti, tj) scores."""
    return [(i, j)
            for i in range(ti * TILE, min(n, (ti + 1) * TILE))
            for j in range(max(i + 1, tj * TILE), min(n, (tj + 1) * TILE))]


# four ranges of n, so that each counts as a test and runs in seconds
@pytest.mark.parametrize('lo,hi', [(2, 150), (150, 300), (300, 450),
                                   (450, 601)])
def test_tiles_cover_every_dyad_once_and_shares_cut_the_list(lo, hi):
    for n in range(lo, hi):
        items = n_items(1, n)
        seen = np.zeros((n, n), dtype=np.int64)
        for item in range(items):
            t, ti, tj = work_item(item, n)
            assert t == 0 and 0 <= ti <= tj < tiles_per_side(n)
            rows = slice(ti * TILE, min(n, (ti + 1) * TILE))
            cols = slice(tj * TILE, min(n, (tj + 1) * TILE))
            i = np.arange(rows.start, rows.stop)[:, None]
            j = np.arange(cols.start, cols.stop)[None, :]
            seen[rows, cols] += (j > i)
        assert np.array_equal(seen, np.triu(np.ones((n, n), np.int64), 1)), n
        # every block count: the shares are contiguous, cover the list and
        # are equal to within one tile
        for G in range(1, items + 1):
            cuts = items * np.arange(G + 1) // G
            assert cuts[0] == 0 and cuts[-1] == items
            sizes = np.diff(cuts)
            assert sizes.min() >= items // G and sizes.max() <= -(-items // G)
        for G in {1, 2, items // 2 + 1, items}:
            assert [block_share(b, G, items) for b in range(G)] == [
                (int(cuts_lo), int(cuts_hi)) for cuts_lo, cuts_hi in zip(
                    items * np.arange(G) // G,
                    items * np.arange(1, G + 1) // G)]


@pytest.mark.parametrize('n', [2, 18, 33, 64, 77])
def test_tile_dyads_and_the_walk_over_times(n):
    """With T > 1 the list repeats the upper triangle's tiles time after
    time, row by row, and one time's tiles hold every dyad once."""
    T = 3
    per_t = n_items(1, n)
    assert n_items(T, n) == T * per_t
    dyads = []
    walk = []
    for item in range(n_items(T, n)):
        t, ti, tj = work_item(item, n)
        walk.append((t, ti, tj))
        if t == 1:
            dyads += tile_dyads(ti, tj, n)
    assert walk == sorted(walk)
    assert [w[0] for w in walk] == [k // per_t for k in range(T * per_t)]
    assert sorted(dyads) == [(i, j) for i in range(n)
                             for j in range(i + 1, n)]
    assert len(set(dyads)) == len(dyads)


def test_blocks_per_chain():
    """The north star (32 chains, 10 x 136 tiles) on 132 SMs that hold 8
    blocks each is cut into 4 waves of 33 blocks a chain; Sampson's 3 tiles
    stay with
    one block; no block gets fewer than MIN_TILES tiles unless it has the
    whole list; more chains than the card holds blocks still get one."""
    assert n_items(10, 500) == 1360
    assert WAVES == 4
    assert blocks_per_chain(32, 1360, 132 * 8) == 4 * 33
    assert n_items(3, 18) == 3
    assert blocks_per_chain(512, 3, 132 * 8) == 1
    assert blocks_per_chain(1, 1360, 132 * 8) == 1360 // MIN_TILES
    assert blocks_per_chain(4096, 1360, 132 * 8) == 1
    for C in (1, 7, 32, 512):
        for items in (1, 3, 4, 9, 1360):
            G = blocks_per_chain(C, items, 132 * 6)
            assert 1 <= G <= items
            assert G == 1 or items // G >= MIN_TILES


def test_workspace_is_reused_and_grows():
    """One scratch per device: a smaller request gets the same tensors, a
    larger one new ones that are at least as large in both parts (the old
    ones are kept), and the ticket counters start at zero."""
    dev = torch.device('cpu')
    loglik_tiles._WORKSPACES.pop(dev, None)
    partials, tickets = workspace(dev, 100, 8)
    assert partials.dtype == torch.float64 and partials.numel() >= 100
    assert tickets.dtype == torch.int32 and tickets.numel() >= 8
    assert not tickets.any()
    again = workspace(dev, 50, 4)
    assert again[0] is partials and again[1] is tickets
    grown = workspace(dev, 60, 16)
    assert grown[0].numel() >= 100 and grown[1].numel() >= 16
    # the outgrown pair stays alive for launches captured with it
    assert any(old[0] is partials for old in loglik_tiles._OUTGROWN)
    assert not grown[1].any()
    assert workspace(dev, 100, 16)[0] is grown[0]
    loglik_tiles._WORKSPACES.pop(dev, None)
