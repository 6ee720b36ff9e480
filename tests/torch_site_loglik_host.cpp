// Host emulation of the site kernel (dynetlsm_tpu_torch/csrc/
// site_loglik.cu), for tests/test_torch_site_loglik.py.
//
// tests/torch_host_build.py cuts the source's kernel part (everything
// before its "---- launch" section) and loglik_common.cuh, without the
// CUDA headers, into a build directory and builds this file around them
// with g++ -std=c++20, the device intrinsics emulated by
// tests/cuda_host.h.  Blocks run one after
// another, in index order or, with `reverse`, in the opposite order; the
// entry returns nonzero where the threads deadlock (stderr says where).
#include <algorithm>

#include "cuda_host.h"

using std::min;

#include "site_loglik_kernel.inc"

// site_loglik_launch's arguments, run on the host (grid (C, tiles, T) of
// kThreads threads, smem_bytes of dynamic shared memory).
extern "C" int site_loglik_host(const float* X, const float* Xq,
                                const uint8_t* Y, const float* b,
                                const float* radii, float* out, int C, int T,
                                int n, int row0, int rows, int d,
                                int directed, int lanes, int per_group,
                                int chunk, long long y_chain,
                                long long y_time, long long y_row,
                                int reverse) {
  const int words = (uintptr_t)Y % 4 == 0 && y_chain % 4 == 0 &&
                    y_time % 4 == 0 && y_row % 4 == 0 &&
                    y_row >= (long long)(n + kWord - 1) / kWord * kWord;
  const Shape s{T,     n,       row0,   rows,   d,     lanes, per_group,
                chunk, y_chain, y_time, y_row, words};
  const int sites = kThreads / lanes * per_group;
  const int tiles = (rows + sites - 1) / sites;
  const size_t stage = (size_t)(d + (directed ? 1 : 0)) * chunk;
  const size_t smem =
      4 * (stage + (chunk < n ? (size_t)kThreads * per_group : 0));
  const long long blocks = (long long)C * tiles * T;
  for (long long bb = 0; bb < blocks; ++bb) {
    const long long k = reverse ? blocks - 1 - bb : bb;
    const dim3 idx((unsigned)(k % C), (unsigned)(k / C % tiles),
                   (unsigned)(k / C / tiles));
    const bool ok = run_cluster(1, kThreads, smem, idx, [&] {
      auto run = [&](auto kernel) { kernel(X, Xq, Y, b, radii, out, s); };
      if (directed) {
        d == 2 ? run(site_loglik_kernel<true, 2>)
               : run(site_loglik_kernel<true, 0>);
      } else {
        d == 2 ? run(site_loglik_kernel<false, 2>)
               : run(site_loglik_kernel<false, 0>);
      }
    });
    if (!ok) return 1;
  }
  return 0;
}
