"""The host shim of the emulated-kernel tests (``tests/cuda_host.h``) on
toy kernels: a read that lacks its barrier sees NaN in one of the two
schedule orders, the barrier makes it read what was written, a thread
that skips a barrier fails the launch within seconds instead of hanging
it, and named barriers and an mbarrier's transaction count complete in
both orders.
"""
import ctypes
import time

import numpy as np
import pytest

from .torch_host_build import build

TOYS = r'''
#include "cuda_host.h"

// Each block's threads write their slot of shared memory, then (past a
// __syncthreads where `barrier`) read the slot `step` away, cyclically.
// Block b starts in ascending thread order where b is even, descending
// where it is odd.
extern "C" int neighbour_host(float* out, int blocks, int threads, int step,
                              int barrier) {
  for (int b = 0; b < blocks; ++b) {
    const bool ok = run_cluster(1, threads, 4 * threads, dim3(b), [&] {
      float* s = host_smem();
      const int t = threadIdx.x;
      s[t] = t + 1.0f;
      if (barrier) __syncthreads();
      out[blockIdx.x * threads + t] = s[(t + step + threads) % threads];
    });
    if (!ok) return 1;
  }
  return 0;
}

// Thread 0 skips the barrier the others wait at.
extern "C" int skip_barrier_host(int threads) {
  const bool ok = run_cluster(1, threads, 0, dim3(0), [&] {
    if (threadIdx.x != 0) __syncthreads();
  });
  return ok ? 0 : 1;
}

// Clusters of two blocks of two warps.  Warp 1 writes its lanes' slots and
// arrives at named barrier 1; warp 0 waits there and reads them.  Then,
// past a __syncwarp, block 0's warp 1 announces 4 bytes a lane on block
// 0's mbarrier and block 1's warp 1 stores them into block 0 by st_async;
// block 0's warp 0 waits for the phase and reads them.  out: (clusters,
// 2 blocks, 64).
extern "C" int named_mbarrier_host(float* out, int clusters) {
  for (int c = 0; c < clusters; ++c) {
    const bool ok = run_cluster(2, 64, 4 * 128, dim3(2 * c), [&] {
      float* s = host_smem();
      uint64_t* bar = reinterpret_cast<uint64_t*>(s);
      float* data = s + 4;
      const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
      cooperative_groups::cluster_group cluster =
          cooperative_groups::this_cluster();
      const int rank = cluster.block_rank();
      float* o = out + (c * 2 + rank) * 64;
      if (threadIdx.x == 0) mbar_init(bar, 1);
      cluster.sync();
      if (warp == 1) {
        data[lane] = 100.0f * rank + lane;
        named_arrive(1, 64);
      } else {
        named_sync(1, 64);
        o[lane] = data[(lane + 1) % 32];
      }
      if (warp == 1) {
        __syncwarp();
        if (rank == 0 && lane == 0) mbar_expect(bar, 4 * 32);
        if (rank == 1) st_async(data + 64 + lane, 2.0f * lane, bar, 0);
      } else if (rank == 0) {
        mbar_wait(bar, 0);
        o[32 + lane] = data[64 + (lane + 1) % 32];
      }
      cluster.sync();
    });
    if (!ok) return 1;
  }
  return 0;
}
'''

THREADS = 64


@pytest.fixture(scope='module')
def toys(tmp_path_factory):
    src = tmp_path_factory.mktemp('toys') / 'cuda_host_toys.cpp'
    src.write_text(TOYS)
    lib = build(tmp_path_factory, src)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.neighbour_host.argtypes = [p] + [i] * 4
    lib.skip_barrier_host.argtypes = [i]
    lib.named_mbarrier_host.argtypes = [p, i]
    return lib


def _neighbour(toys, step, barrier):
    """(block 0: ascending first, block 1: descending first) x threads."""
    out = np.full((2, THREADS), np.nan, np.float32)
    assert toys.neighbour_host(out.ctypes.data, 2, THREADS, step,
                               int(barrier)) == 0
    return out


@pytest.mark.parametrize('step', [1, -1])
def test_read_without_barrier_sees_nan(toys, step):
    """A higher neighbour's slot is NaN where the threads run in ascending
    order, a lower one's where they run in descending order (and, in the
    other order, the one slot read across the wrap)."""
    out = _neighbour(toys, step, barrier=False)
    early = 0 if step == 1 else 1
    assert np.isnan(out[early]).sum() == THREADS - 1
    assert np.isnan(out[1 - early]).sum() == 1


@pytest.mark.parametrize('step', [1, -1])
def test_read_after_barrier_sees_writes(toys, step):
    out = _neighbour(toys, step, barrier=True)
    want = (np.arange(THREADS) + step) % THREADS + 1.0
    np.testing.assert_array_equal(out, np.stack([want, want]))


def test_skipped_barrier_fails_fast(toys, capfd):
    """The threads that wait for thread 0 never run again: the launch
    returns nonzero at once and says who waits where."""
    start = time.monotonic()
    assert toys.skip_barrier_host(THREADS) != 0
    assert time.monotonic() - start < 5.0
    err = capfd.readouterr().err
    assert 'deadlock' in err
    assert 'threads 0-0: returned' in err
    assert 'threads 1-%d: wait at __syncthreads' % (THREADS - 1) in err


def test_named_barrier_and_mbarrier_in_both_orders(toys):
    """Cluster 0 starts in ascending order (block 1's stores land before
    block 0's announcement), cluster 1 in descending order (block 0's
    warp 0 waits at the mbarrier before the announcement and the stores):
    both read what the producers wrote."""
    out = np.full((2, 2, 64), np.nan, np.float32)
    assert toys.named_mbarrier_host(out.ctypes.data, 2) == 0
    nxt = (np.arange(32) + 1) % 32
    for c in range(2):
        for rank in range(2):
            np.testing.assert_array_equal(out[c, rank, :32],
                                          100.0 * rank + nxt)
        np.testing.assert_array_equal(out[c, 0, 32:], 2.0 * nxt)
        assert np.isnan(out[c, 1, 32:]).all()
