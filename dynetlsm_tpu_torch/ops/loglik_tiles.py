"""The work split and the scratch of the two log-likelihood kernels
(``csrc/pair_loglik.cu``, ``csrc/dir_loglik.cu``; their shared parts are in
``csrc/loglik_common.cuh``).

A chain's work list is every (t, tile_i, tile_j) with tile_j >= tile_i,
tiles of ``TILE`` x ``TILE`` dyads, t outermost and the upper triangle's
tiles row by row.  Block ``blk`` of a chain's ``n_blocks`` takes items
``[n_items * blk // n_blocks, n_items * (blk + 1) // n_blocks)``.  The
functions here spell that split out as the kernels compute it, so the CPU
tests can hold it to covering every dyad i < j once, and choose the blocks
per chain and the scratch for a launch.

The kernels' row-range mode (node sharding) holds rows ``[row0, row0 +
rows)`` of the network: its tiles count from ``row0`` on both axes, the
row tiles over the held rows and the column tiles over the columns
``row0 .. n - 1``, so a time's list is the trapezoid ``tile_j >= tile_i``
of that grid; ``row0 = 0, rows = n`` is the whole network.
"""
import functools

import torch

from . import cuda_lib

TILE = 32
# no block is launched for less than this many tiles (or the whole list)
MIN_TILES = 4
# the grid is this many times what the card holds at once: tiles differ in
# cost (the diagonal's and the ragged edge's are partly masked), and with
# one wave the last blocks set the time; at the north star 4 waves took 5%
# less time than 1 (14% with one directed candidate) and more gained
# nothing (PERF.md)
WAVES = 4

_WORKSPACES = {}
# outgrown scratch is kept alive: a CUDA graph captured earlier still
# launches with its addresses
_OUTGROWN = []


def tiles_per_side(n):
    return -(-n // TILE)


def _grid(n, row0, rows):
    """(row tiles, column tiles, tiles a time) of the rows [row0, row0 +
    rows) of n nodes (all n rows when ``rows`` is None)."""
    rows = n - row0 if rows is None else rows
    if not (0 <= row0 and 1 <= rows and row0 + rows <= n):
        raise ValueError('rows [%d, %d) do not lie in [0, %d)'
                         % (row0, row0 + rows, n))
    mt, ct = tiles_per_side(rows), tiles_per_side(n - row0)
    return mt, ct, mt * ct - mt * (mt - 1) // 2


def n_items(T, n, row0=0, rows=None):
    """Length of a chain's work list (of the rows [row0, row0 + rows) in
    the row-range mode)."""
    return T * _grid(n, row0, rows)[2]


def work_item(item, n, row0=0, rows=None):
    """(t, tile_i, tile_j) of the work list's ``item`` for n nodes, the
    tiles counted from ``row0`` (node ``row0 + TILE * tile + k``)."""
    _, ct, per_t = _grid(n, row0, rows)
    t, m = divmod(item, per_t)
    ti = 0
    while m >= ct - ti:
        m -= ct - ti
        ti += 1
    return t, ti, ti + m


def block_share(blk, n_blocks, items):
    """The half-open range of work items of block ``blk``."""
    return items * blk // n_blocks, items * (blk + 1) // n_blocks


def blocks_per_chain(C, items, resident):
    """Blocks a chain is cut into so that the grid of C chains is a small
    multiple of what the card runs at once: ``WAVES`` times the
    ``resident`` blocks the whole card holds at a time, shared among the
    chains, but at least ``MIN_TILES`` tiles a block.  A short list
    (Sampson's 3 tiles) stays with one block, which then writes its chain's
    result itself."""
    return max(1, min(WAVES * resident // C, items // MIN_TILES))


def workspace(device, n_partials, C):
    """(partials, tickets) of the device: float64 scratch of at least
    ``n_partials`` and at least C uint32 ticket counters (int32 storage),
    zero when made and left zero by every launch.  One pair per device,
    replaced by a larger one when a launch needs more (the old one is kept,
    never freed) and otherwise reused, so a call allocates nothing but its
    output; it serves one stream at a time.  Node shards on one device
    (``mcmc/nodes.py``) launch on its one current stream, so their
    launches never overlap on it."""
    held = _WORKSPACES.get(device)
    if held is not None:
        if held[0].numel() >= n_partials and held[1].numel() >= C:
            return held
        _OUTGROWN.append(held)
        n_partials = max(n_partials, held[0].numel())
        C = max(C, held[1].numel())
    held = (torch.empty(n_partials, dtype=torch.float64, device=device),
            torch.zeros(C, dtype=torch.int32, device=device))
    _WORKSPACES[device] = held
    return held


@functools.lru_cache(maxsize=None)
def resident_blocks(index, kernel, n_cand, d):
    """Blocks of ``kernel`` ('pair' or 'dir') with ``n_cand`` candidates at
    latent dimension d that the card at ``index`` holds at a time."""
    with torch.cuda.device(index):
        lib = cuda_lib.library()
        per_sm = getattr(lib, kernel + '_loglik_blocks_per_sm')(n_cand, d)
        sms = torch.cuda.get_device_properties(index).multi_processor_count
    cuda_lib.check_launch(kernel + '_loglik occupancy',
                          -per_sm if per_sm < 0 else 0)
    return sms * per_sm


def launch_layout(X, kernel, n_cand, row0=0, rows=None):
    """(blocks per chain, partials, tickets) of one launch on X's device
    (of the rows [row0, row0 + rows) in the row-range mode)."""
    C, T, n, d = X.shape
    G = blocks_per_chain(C, n_items(T, n, row0, rows),
                         resident_blocks(X.device.index, kernel, n_cand, d))
    return (G,) + workspace(X.device, C * G * n_cand, C)
