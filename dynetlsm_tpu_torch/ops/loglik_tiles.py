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


def n_items(T, n):
    """Length of a chain's work list."""
    nt = tiles_per_side(n)
    return T * nt * (nt + 1) // 2


def work_item(item, n):
    """(t, tile_i, tile_j) of the work list's ``item`` for n nodes."""
    nt = tiles_per_side(n)
    t, m = divmod(item, nt * (nt + 1) // 2)
    ti = 0
    while m >= nt - ti:
        m -= nt - ti
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
    output; it serves one stream at a time."""
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


def launch_layout(X, kernel, n_cand):
    """(blocks per chain, partials, tickets) of one launch on X's
    device."""
    C, T, n, d = X.shape
    G = blocks_per_chain(C, n_items(T, n),
                         resident_blocks(X.device.index, kernel, n_cand, d))
    return (G,) + workspace(X.device, C * G * n_cand, C)
