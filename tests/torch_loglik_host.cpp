// Host emulation of the two log-likelihood kernels in dynetlsm_tpu_torch/
// csrc/ (pair_loglik.cu, dir_loglik.cu and their shared loglik_common.cuh),
// for tests/test_torch_loglik_emulated.py.
//
// tests/torch_host_build.py cuts each source's kernel part (everything
// before its "---- launch" section) and the header, without the CUDA
// headers, into a build directory and builds this file around them with
// g++ -std=c++20, the device intrinsics emulated by tests/cuda_host.h.
// Blocks run one after another, in index order or, with `reverse`, in the
// opposite order, so another block is the last to take a chain's ticket.
// The entries return nonzero where the threads deadlock (stderr says
// where).
#include "cuda_host.h"

#include "pair_loglik_kernel.inc"
#include "dir_loglik_kernel.inc"

namespace {

// Run kernel() as every block of the grid (G, C), one block at a time,
// with `smem_bytes` of dynamic shared memory; nonzero on a deadlock.
template <class Kernel>
int run_grid(int C, int G, size_t smem_bytes, bool reverse, Kernel kernel) {
  for (int cc = 0; cc < C; ++cc) {
    for (int bb = 0; bb < G; ++bb) {
      const int c = reverse ? C - 1 - cc : cc;
      const int blk = reverse ? G - 1 - bb : bb;
      if (!run_cluster(1, loglik::kThreads, smem_bytes, dim3(blk, c), kernel))
        return 1;
    }
  }
  return 0;
}

}  // namespace

// The end of a block alone: block `blk` of chain c brings values[c * G +
// blk] (in its thread 0; its other threads bring 0), and block_finish
// adds them up into out (C, 1).
extern "C" int block_finish_host(const double* values, double* partials,
                                 unsigned* tickets, float* out, int C, int G,
                                 int reverse) {
  return run_grid(C, G, 0, reverse, [&] {
    const int c = blockIdx.y, blk = blockIdx.x;
    const double s[1] = {threadIdx.x == 0 ? values[c * G + blk] : 0.0};
    loglik::block_finish<1>(s, partials, tickets, out, nullptr, c, blk, G);
  });
}

// pair_loglik_launch's arguments, with the row range and the float64
// output of pair_loglik_rows_launch (out64 null: the float32 out), but run
// on the host.
extern "C" int pair_loglik_host(const float* X, const uint8_t* Y,
                                const float* b_cur, const float* b_prop,
                                double* partials, unsigned* tickets,
                                float* out, double* out64, int C, int T,
                                int n, int row0, int rows, int d, int G,
                                long long y_chain, int reverse) {
  const loglik::Rows range{row0, rows};
  const int words = loglik::word_rows(Y, n, y_chain, row0);
  const size_t smem = loglik::smem_bytes(d, 0);
  // as the launch picks them: compiled for d = 2, or for any d
  int rc = 0;
  auto run = [&](auto kernel, const float* b_second) {
    rc = run_grid(C, G, smem, reverse, [&] {
      kernel(X, Y, y_chain, b_cur, b_second, partials, tickets, out, out64, T,
             n, range, d, G, words);
    });
  };
  // the row-range instantiation where the float64 output is asked for
  auto pick = [&](auto whole, auto ranged, const float* b_second) {
    out64 == nullptr ? run(whole, b_second) : run(ranged, b_second);
  };
  if (b_prop == nullptr) {
    d == 2 ? pick(pair_loglik_kernel<1, 2, false>,
                  pair_loglik_kernel<1, 2, true>, b_cur)
           : pick(pair_loglik_kernel<1, 0, false>,
                  pair_loglik_kernel<1, 0, true>, b_cur);
  } else {
    d == 2 ? pick(pair_loglik_kernel<2, 2, false>,
                  pair_loglik_kernel<2, 2, true>, b_prop)
           : pick(pair_loglik_kernel<2, 0, false>,
                  pair_loglik_kernel<2, 0, true>, b_prop);
  }
  return rc;
}

namespace {

template <int NC>
int dir_host(const float* X, const uint8_t* Yp, long long y_chain,
             const float* radii, const float* b, double* partials,
             unsigned* tickets, float* out, double* out64, int C, int T,
             int n, loglik::Rows range, int d, int G, int reverse) {
  const int words = loglik::word_rows(Yp, n, y_chain, range.row0);
  // as the launch picks them: compiled for d = 2, or for any d
  return run_grid(C, G, loglik::smem_bytes(d, kUvFloats<NC>), reverse, [&] {
    // the row-range instantiation where the float64 output is asked for
    auto run = [&](auto kernel) {
      kernel(X, Yp, y_chain, radii, b, partials, tickets, out, out64, T, n,
             range, d, G, words);
    };
    if (out64 == nullptr) {
      d == 2 ? run(dir_loglik_kernel<NC, 2, false>)
             : run(dir_loglik_kernel<NC, 0, false>);
    } else {
      d == 2 ? run(dir_loglik_kernel<NC, 2, true>)
             : run(dir_loglik_kernel<NC, 0, true>);
    }
  });
}

}  // namespace

// dir_loglik_launch's arguments, with the row range and the float64
// output of dir_loglik_rows_launch (out64 null: the float32 out), but run
// on the host.
extern "C" int dir_loglik_host(const float* X, const uint8_t* Yp,
                               const float* radii, const float* b,
                               double* partials, unsigned* tickets,
                               float* out, double* out64, int C, int n_cand,
                               int T, int n, int row0, int rows, int d, int G,
                               long long y_chain, int reverse) {
  const loglik::Rows range{row0, rows};
  switch (n_cand) {
    case 1:
      return dir_host<1>(X, Yp, y_chain, radii, b, partials, tickets, out,
                          out64, C, T, n, range, d, G, reverse);
    case 2:
      return dir_host<2>(X, Yp, y_chain, radii, b, partials, tickets, out,
                          out64, C, T, n, range, d, G, reverse);
    case 3:
      return dir_host<3>(X, Yp, y_chain, radii, b, partials, tickets, out,
                          out64, C, T, n, range, d, G, reverse);
    default:
      return 1;
  }
}
