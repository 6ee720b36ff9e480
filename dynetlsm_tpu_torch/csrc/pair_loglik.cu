// Full undirected Bernoulli log-likelihood of every chain at one or two
// intercepts (the intercept MH step's current and proposed values; one for
// the replica swap):
//
//   ll_c(b) = sum_{t, i<j} y_tij * eta - softplus(eta),
//   eta = b - ||x_ti - x_tj||.
//
// Replaces the Pallas kernel dynetlsm_tpu/ops/pallas_loglik.py::
// _pair_tile_kernel.  Distances are computed on the fly and never stored:
// the dense path would write and re-read a (C, T, n, n) float tensor
// (320 MB at C=32, T=10, n=500).
//
// What bounds it on the H100: instruction issue.  Per dyad one sqrt and,
// per intercept, one exp/log1p pair, each a few dozen instructions with
// every multiply and add rounded separately (-fmad=false); device-memory
// traffic is one read of the uint8 adjacency per chain (L2-resident:
// 2.5 MB at T=10, n=500) plus the positions.  The inner loop as compiled
// for d = 2 (CUDA 12.8, cuobjdump -sass, scripts/loglik_sass.py; recounted
// with the row-range mode beside it): 331 instructions a pass of 4 dyads
// with one intercept, 536 with two, so 82.75 and 134 a dyad (the row-range
// mode 83.75 and 139.75), 2 and 3 of them MUFU (one rsqrt, one ex2 per
// intercept); each further softplus costs about 51: expf about 10,
// log1pf about 30, the float64 add with its conversion and mask about 6.
//
// Design (loglik_common.cuh has the shared parts): one launch.  A chain's
// upper-triangle tiles of all times form one work list, cut into G equal
// shares, one per block, so every block has the same work whatever its
// rows; the grid (G, C) is about four times what the card holds at once,
// which evens out the tiles' unequal cost.  A tile's positions
// are staged in shared memory once (the next tile's while this one is
// scored); a thread owns four consecutive columns of a row, reads their
// adjacency bytes in one load and runs their four softplus chains side by
// side.  Sums: per thread in float64 in a fixed order, per warp by
// shuffle, the warps of a block once through shared memory, and the
// chain's blocks by the last block to take a ticket, in index order.  No
// floating-point atomics, so a rerun on the same input gives a
// bit-identical result.
//
// The adjacency is one network for every chain, or one a chain (missing-
// dyad resampling): chain c reads it at Y + c * y_chain, y_chain = T n n
// bytes or 0.
//
// Row-range mode (pair_loglik_rows_launch): the launch holds rows
// [row0, row0 + rows) of the network, (T, rows, n) (a chain stride of
// T rows n), reads the whole X and sums the dyads i in its rows, j > i, to
// float64 (loglik_common.cuh).  It serves the node-sharded fits
// (devices split the network's rows: mcmc/nodes.py), in which the TPU
// package's GSPMD partitions the dense path instead
// (dynetlsm_tpu/mcmc/sweeps.py:92-94, cfg.spatial keeps it off Pallas);
// the whole network is its case row0 = 0, rows = n.
#include <cstdint>
#include <cuda_runtime.h>

#include "loglik_common.cuh"

namespace {

using namespace loglik;

// One tile from the staged buffer: s[k] gains every live dyad's term at
// intercept b[k].
template <int NB, int D>
__device__ __forceinline__ void pair_tile(const float* buf,
                                          const uint8_t* y_t, Rows rows,
                                          int ti, int tj, int n, int d,
                                          bool words, const float* b,
                                          double* s) {
  const int row0 = rows.row0;
  const int row_end = row0 + rows.rows;
  const int c4 = threadIdx.x % kColGroups;
  const int j0 = row0 + tj * kTile + kCols * c4;
  if (j0 >= n) return;
  for (int p = 0; p < kPasses; ++p) {
    const int il = threadIdx.x / kColGroups + p * kRowsPerPass;
    const int i = row0 + ti * kTile + il;
    // no column of the thread's lies right of the diagonal, or no row
    if (i >= j0 + kCols - 1 || i >= row_end) continue;
    const uint32_t w = load_y4(y_t + (size_t)(i - row0) * n + j0, n - j0,
                               words);
    float d2[kCols];
    squared_distances<D>(buf, d, il, c4, d2);
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      const int j = j0 + m;
      const bool live = j > i && j < n;
      const float dist = sqrtf(fmaxf(d2[m], 0.0f));
      const float y = (float)((w >> (8 * m)) & 0xffu);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const float e = b[k] - dist;
        const float term = y * e - softplus(e);
        s[k] += (double)(live ? term : 0.0f);
      }
    }
  }
}

// D: the latent dimension it is compiled for (2), or 0 for any d; R: the
// row-range mode (without it the rows are [0, n), which the compiler
// folds into the whole network's code).
template <int NB, int D, bool R>
__global__ void __launch_bounds__(kThreads)
pair_loglik_kernel(const float* __restrict__ X, const uint8_t* __restrict__ Y,
                   long long y_chain, const float* __restrict__ b_cur,
                   const float* __restrict__ b_prop,
                   double* __restrict__ partials,
                   unsigned* __restrict__ tickets, float* __restrict__ out,
                   double* __restrict__ out64, int T, int n, Rows rows,
                   int d, int G, int words) {
  extern __shared__ __align__(16) float smem[];
  const int blk = blockIdx.x;
  const int c = blockIdx.y;
  const float* x_c = X + (size_t)c * T * n * d;
  const uint8_t* y_c = Y + (size_t)c * y_chain;
  const int per_buf = 2 * kTile * d;
  const Rows range = R ? rows : Rows{0, n};
  float b[NB];
  double s[NB];
  b[0] = b_cur[c];
  if (NB == 2) b[NB - 1] = b_prop[c];
  for (int k = 0; k < NB; ++k) s[k] = 0.0;

  walk_tiles(
      T, n, range, blk, G,
      [&](int which, const TileWalk& w) {
        stage_positions<D>(smem + which * per_buf, x_c + (size_t)w.t * n * d,
                           range.row0, w.ti, w.tj, n, d);
      },
      [&](int which, const TileWalk& w) {
        pair_tile<NB, D>(smem + which * per_buf,
                         y_c + (size_t)w.t * range.rows * n, range, w.ti,
                         w.tj, n, d, words != 0, b, s);
      });
  block_finish<NB>(s, partials, tickets, out, R ? out64 : nullptr, c, blk, G);
}

}  // namespace

// ---- launch

namespace {

template <int NB, int D>
int launch(const float* X, const uint8_t* Y, long long y_chain,
           const float* b_cur, const float* b_prop, double* partials,
           unsigned* tickets, float* out, double* out64, int C, int T, int n,
           Rows rows, int d, int G, cudaStream_t s) {
  const int words = loglik::word_rows(Y, n, y_chain, rows.row0);
  const dim3 grid(G, C);
  const size_t smem = loglik::smem_bytes(d, 0);
  if (out64 != nullptr) {
    pair_loglik_kernel<NB, D, true><<<grid, kThreads, smem, s>>>(
        X, Y, y_chain, b_cur, b_prop, partials, tickets, out, out64, T, n,
        rows, d, G, words);
  } else {
    pair_loglik_kernel<NB, D, false><<<grid, kThreads, smem, s>>>(
        X, Y, y_chain, b_cur, b_prop, partials, tickets, out, out64, T, n,
        rows, d, G, words);
  }
  return (int)cudaGetLastError();
}

template <int NB, int D>
int blocks_per_sm(int d) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pair_loglik_kernel<NB, D, false>, kThreads,
      loglik::smem_bytes(d, 0));
  return err == cudaSuccess ? blocks : -(int)err;
}

int launch_any(const float* X, const uint8_t* Y, const float* b_cur,
               const float* b_prop, double* partials, unsigned* tickets,
               float* out, double* out64, int C, int T, int n, Rows rows,
               int d, int G, long long y_chain, void* stream) {
  const long long items = (long long)T * rows.per_t(n);
  if (C < 1 || C > 65535 || T < 1 || n < 1 || d < 1 || G < 1 || G > items ||
      rows.row0 < 0 || rows.rows < 1 || rows.row0 + rows.rows > n ||
      items > INT32_MAX || loglik::smem_bytes(d, 0) > 48 * 1024 ||
      (y_chain != 0 && y_chain != (long long)T * rows.rows * n)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (b_prop == nullptr) {
    return d == 2 ? launch<1, 2>(X, Y, y_chain, b_cur, b_cur, partials,
                                 tickets, out, out64, C, T, n, rows, d, G, s)
                  : launch<1, 0>(X, Y, y_chain, b_cur, b_cur, partials,
                                 tickets, out, out64, C, T, n, rows, d, G, s);
  }
  return d == 2 ? launch<2, 2>(X, Y, y_chain, b_cur, b_prop, partials,
                               tickets, out, out64, C, T, n, rows, d, G, s)
                : launch<2, 0>(X, Y, y_chain, b_cur, b_prop, partials,
                               tickets, out, out64, C, T, n, rows, d, G, s);
}

}  // namespace

// Blocks of the kernel one SM holds at once with n_cand intercepts at
// latent dimension d (the wrapper sizes the grid from it), or minus the
// CUDA error code.
extern "C" int pair_loglik_blocks_per_sm(int n_cand, int d) {
  if (n_cand == 1) {
    return d == 2 ? blocks_per_sm<1, 2>(d) : blocks_per_sm<1, 0>(d);
  }
  return d == 2 ? blocks_per_sm<2, 2>(d) : blocks_per_sm<2, 0>(d);
}

// One launch on `stream`; returns the CUDA error code (0 on success), or
// cudaErrorInvalidValue for a shape it does not take.  X (C, T, n, d);
// Y (T, n, n) uint8, or (C, T, n, n) with y_chain = T n n (0: shared);
// b_cur (C,); b_prop (C,) or null for one intercept;
// partials: C * G * n_cand float64 of scratch; tickets: C uint32, zero
// before the first launch (every launch leaves them zero); out
// (C, n_cand) float32, candidate 0 = b_cur, 1 = b_prop.  G blocks a chain,
// 1 <= G <= T * tiles of the upper triangle.
extern "C" int pair_loglik_launch(const float* X, const uint8_t* Y,
                                  const float* b_cur, const float* b_prop,
                                  double* partials, unsigned* tickets,
                                  float* out, int C, int T, int n, int d,
                                  int G, long long y_chain, void* stream) {
  return launch_any(X, Y, b_cur, b_prop, partials, tickets, out, nullptr, C,
                    T, n, Rows{0, n}, d, G, y_chain, stream);
}

// The row-range mode: Y (T, rows, n), or (C, T, rows, n) with y_chain =
// T rows n, the rows [row0, row0 + rows) of the network; X the whole
// (C, T, n, d); out64 (C, n_cand) float64, the sums of the dyads i in the
// rows, j > i.  G <= T * tiles of the rows' trapezoid.  The rest as
// pair_loglik_launch.
extern "C" int pair_loglik_rows_launch(const float* X, const uint8_t* Y,
                                       const float* b_cur,
                                       const float* b_prop, double* partials,
                                       unsigned* tickets, double* out64,
                                       int C, int T, int n, int row0,
                                       int rows, int d, int G,
                                       long long y_chain, void* stream) {
  return launch_any(X, Y, b_cur, b_prop, partials, tickets, nullptr, out64,
                    C, T, n, Rows{row0, rows}, d, G, y_chain, stream);
}
