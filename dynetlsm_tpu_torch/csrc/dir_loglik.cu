// Full directed social-radii Bernoulli log-likelihood of every chain at up
// to three (b_in, b_out, radii) candidates (the directed intercept and
// radii MH steps' candidates):
//
//   ll_c = sum_{t, i != j} y_tij * eta_ij - softplus(eta_ij),
//   eta_ij = B - d_ij * (u[j] + v[i]),  u = b_in / r,  v = b_out / r,
//   B = b_in + b_out
//
// (reference directed_likelihoods_fast.pyx:199-202 in hoisted-reciprocal
// form: b_in (1 - d/r_j) + b_out (1 - d/r_i)).
//
// Replaces the Pallas kernel dynetlsm_tpu/ops/pallas_loglik.py::
// _dir_tile_kernel.  Distances are computed on the fly and never stored:
// the dense path would write and re-read a (C, T, n, n) float tensor
// (320 MB at C=32, T=10, n=500) per candidate.
//
// What bounds it on the H100: instruction issue.  Per unordered dyad one
// sqrt and, per candidate, two exp/log1p pairs for the two edge
// directions, each a few dozen instructions with every multiply and add
// rounded separately (-fmad=false); device-memory traffic is one read of
// the packed uint8 adjacency per chain (L2-resident: 2.5 MB at T=10,
// n=500) plus the positions and radii.  The inner loop as compiled for
// d = 2 (CUDA 12.8, cuobjdump -sass, scripts/loglik_sass.py; recounted
// with the row-range mode beside it): 577, 954 and 1350 instructions a
// pass of 4 dyads with 1, 2 and 3 candidates, so 144.25, 238.5 and 337.5 a
// dyad (the row-range mode 146, 243.75 and 338), 3, 5 and 7 of them MUFU
// (one rsqrt, two ex2 per candidate).
//
// Design (loglik_common.cuh has the shared parts): the pair kernel's, in
// one launch.  A chain's upper-triangle tiles of all times form one work
// list, cut into G equal shares, one per block; each unordered pair i<j is
// visited once and both directions are scored from the packed byte
// p = Y[i,j] + 2 Y[j,i].  With a tile's positions, each candidate's u and
// v of the tile's row and column nodes are staged in shared memory,
// divided there (IEEE division, as PyTorch divides), so no u or v is ever
// written to device memory.  The ragged edge and the diagonal are masked
// by index (no padding: intercepts may be negative, so padded dyads would
// not cancel).  Sums: per thread in float64 in a fixed order, per warp by
// shuffle, the warps of a block once through shared memory, and the
// chain's blocks by the last block to take a ticket, in index order.  No
// floating-point atomics, so a rerun on the same input is bit-identical.
//
// The packed adjacency is one network for every chain, or one a chain
// (missing-dyad resampling): chain c reads it at Yp + c * y_chain,
// y_chain = T n n bytes or 0.
//
// Row-range mode (dir_loglik_rows_launch): the launch holds the packed rows
// [row0, row0 + rows), (T, rows, n) (a chain stride of T rows n); a packed
// row holds both directions of its dyads, so the dyads i in the rows,
// j > i, are scored from it alone, with the whole X and radii, to float64
// (loglik_common.cuh).  It serves the node-sharded fits (devices split the
// network's rows: mcmc/nodes.py), in which the TPU package's GSPMD
// partitions the dense path instead (dynetlsm_tpu/mcmc/sweeps.py:92-94,
// cfg.spatial keeps it off Pallas); the whole network is its case
// row0 = 0, rows = n.
#include <cstdint>
#include <cuda_runtime.h>

#include "loglik_common.cuh"

namespace {

using namespace loglik;

// Floats a buffer holds after the positions: uv[side][u or v][k][node].
template <int NC>
constexpr int kUvFloats = 4 * NC * kTile;

// u = b_in / r and v = b_out / r of the tile's row nodes (side 0) and
// column nodes (side 1) for each candidate; nodes past n divide by 1.
// radii_c (NC, n) and b_c (NC, 2) of one chain.
template <int NC>
__device__ __forceinline__ void stage_uv(float* uv, const float* radii_c,
                                         const float* b_c, int row0, int ti,
                                         int tj, int n) {
  for (int e = threadIdx.x; e < 2 * NC * kTile; e += kThreads) {
    const int side = e / (NC * kTile);
    const int r = e - side * NC * kTile;
    const int k = r / kTile;
    const int local = r - k * kTile;
    const int node = row0 + (side ? tj : ti) * kTile + local;
    const float rad = node < n ? radii_c[(size_t)k * n + node] : 1.0f;
    float* at = uv + (side * 2 * NC + k) * kTile + local;
    at[0] = b_c[2 * k] / rad;
    at[NC * kTile] = b_c[2 * k + 1] / rad;
  }
}

// One tile from the staged buffer: s[k] gains both directions' terms of
// every live dyad at candidate k.
template <int NC, int D>
__device__ __forceinline__ void dir_tile(const float* buf,
                                         const uint8_t* p_t, Rows rows,
                                         int ti, int tj, int n, int d,
                                         bool words, const float* B,
                                         double* s) {
  const int row0 = rows.row0;
  const int row_end = row0 + rows.rows;
  const int c4 = threadIdx.x % kColGroups;
  const int j0 = row0 + tj * kTile + kCols * c4;
  if (j0 >= n) return;
  const float* uv = buf + 2 * kTile * d;
  const float* ui = uv;
  const float* vi = uv + NC * kTile;
  const float4* uj = reinterpret_cast<const float4*>(uv + 2 * NC * kTile);
  const float4* vj = reinterpret_cast<const float4*>(uv + 3 * NC * kTile);
  for (int p = 0; p < kPasses; ++p) {
    const int il = threadIdx.x / kColGroups + p * kRowsPerPass;
    const int i = row0 + ti * kTile + il;
    // no column of the thread's lies right of the diagonal, or no row
    if (i >= j0 + kCols - 1 || i >= row_end) continue;
    const uint32_t w = load_y4(p_t + (size_t)(i - row0) * n + j0, n - j0,
                               words);
    float d2[kCols];
    squared_distances<D>(buf, d, il, c4, d2);
    float dist[kCols];
#pragma unroll
    for (int m = 0; m < kCols; ++m) dist[m] = sqrtf(fmaxf(d2[m], 0.0f));
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const float u_i = ui[k * kTile + il];
      const float v_i = vi[k * kTile + il];
      const float4 u4 = uj[k * kColGroups + c4];
      const float4 v4 = vj[k * kColGroups + c4];
      const float u_j[kCols] = {u4.x, u4.y, u4.z, u4.w};
      const float v_j[kCols] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int j = j0 + m;
        const bool live = j > i && j < n;
        const uint32_t bits = (w >> (8 * m)) & 0xffu;
        const float y = (float)(bits & 1u);    // edge i -> j
        const float yt = (float)(bits >> 1);   // edge j -> i
        const float s_out = u_j[m] + v_i;
        const float s_in = u_i + v_j[m];
        const float e_out = B[k] - dist[m] * s_out;
        const float e_in = B[k] - dist[m] * s_in;
        const float t_out = y * e_out - softplus(e_out);
        const float t_in = yt * e_in - softplus(e_in);
        s[k] += (double)(live ? t_out : 0.0f);
        s[k] += (double)(live ? t_in : 0.0f);
      }
    }
  }
}

// D: the latent dimension it is compiled for (2), or 0 for any d; R: the
// row-range mode (without it the rows are [0, n), which the compiler
// folds into the whole network's code).
template <int NC, int D, bool R>
__global__ void __launch_bounds__(kThreads)
dir_loglik_kernel(const float* __restrict__ X, const uint8_t* __restrict__ Yp,
                  long long y_chain, const float* __restrict__ radii,
                  const float* __restrict__ b, double* __restrict__ partials,
                  unsigned* __restrict__ tickets, float* __restrict__ out,
                  double* __restrict__ out64, int T, int n, Rows rows, int d,
                  int G, int words) {
  extern __shared__ __align__(16) float smem[];
  const int blk = blockIdx.x;
  const int c = blockIdx.y;
  const float* x_c = X + (size_t)c * T * n * d;
  const uint8_t* y_c = Yp + (size_t)c * y_chain;
  const float* radii_c = radii + (size_t)c * NC * n;
  const float* b_c = b + (size_t)c * NC * 2;
  const int per_buf = 2 * kTile * d + kUvFloats<NC>;
  const Rows range = R ? rows : Rows{0, n};
  float B[NC];
  double s[NC];
  for (int k = 0; k < NC; ++k) {
    B[k] = b_c[2 * k] + b_c[2 * k + 1];
    s[k] = 0.0;
  }

  walk_tiles(
      T, n, range, blk, G,
      [&](int which, const TileWalk& w) {
        float* buf = smem + which * per_buf;
        stage_positions<D>(buf, x_c + (size_t)w.t * n * d, range.row0, w.ti,
                           w.tj, n, d);
        stage_uv<NC>(buf + 2 * kTile * d, radii_c, b_c, range.row0, w.ti,
                     w.tj, n);
      },
      [&](int which, const TileWalk& w) {
        dir_tile<NC, D>(smem + which * per_buf,
                        y_c + (size_t)w.t * range.rows * n, range, w.ti,
                        w.tj, n, d, words != 0, B, s);
      });
  block_finish<NC>(s, partials, tickets, out, R ? out64 : nullptr, c, blk, G);
}

}  // namespace

// ---- launch

namespace {

template <int NC, int D>
int launch_d(const float* X, const uint8_t* Yp, long long y_chain,
             const float* radii, const float* b, double* partials,
             unsigned* tickets, float* out, double* out64, int C, int T,
             int n, Rows rows, int d, int G, cudaStream_t s) {
  const size_t smem = loglik::smem_bytes(d, kUvFloats<NC>);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int words = loglik::word_rows(Yp, n, y_chain, rows.row0);
  const dim3 grid(G, C);
  if (out64 != nullptr) {
    dir_loglik_kernel<NC, D, true><<<grid, kThreads, smem, s>>>(
        X, Yp, y_chain, radii, b, partials, tickets, out, out64, T, n, rows,
        d, G, words);
  } else {
    dir_loglik_kernel<NC, D, false><<<grid, kThreads, smem, s>>>(
        X, Yp, y_chain, radii, b, partials, tickets, out, out64, T, n, rows,
        d, G, words);
  }
  return (int)cudaGetLastError();
}

template <int NC>
int launch(const float* X, const uint8_t* Yp, long long y_chain,
           const float* radii, const float* b, double* partials,
           unsigned* tickets, float* out, double* out64, int C, int T, int n,
           Rows rows, int d, int G, cudaStream_t s) {
  return d == 2 ? launch_d<NC, 2>(X, Yp, y_chain, radii, b, partials, tickets,
                                  out, out64, C, T, n, rows, d, G, s)
                : launch_d<NC, 0>(X, Yp, y_chain, radii, b, partials, tickets,
                                  out, out64, C, T, n, rows, d, G, s);
}

template <int NC>
int blocks_per_sm(int d) {
  int blocks = 0;
  const size_t smem = loglik::smem_bytes(d, kUvFloats<NC>);
  const cudaError_t err =
      d == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, dir_loglik_kernel<NC, 2, false>, kThreads, smem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, dir_loglik_kernel<NC, 0, false>, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

int launch_any(const float* X, const uint8_t* Yp, const float* radii,
               const float* b, double* partials, unsigned* tickets,
               float* out, double* out64, int C, int n_cand, int T, int n,
               Rows rows, int d, int G, long long y_chain, void* stream) {
  const long long items = (long long)T * rows.per_t(n);
  if (C < 1 || C > 65535 || T < 1 || n < 1 || d < 1 || G < 1 || G > items ||
      rows.row0 < 0 || rows.rows < 1 || rows.row0 + rows.rows > n ||
      items > INT32_MAX ||
      (y_chain != 0 && y_chain != (long long)T * rows.rows * n)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_cand) {
    case 1:
      return launch<1>(X, Yp, y_chain, radii, b, partials, tickets, out,
                       out64, C, T, n, rows, d, G, s);
    case 2:
      return launch<2>(X, Yp, y_chain, radii, b, partials, tickets, out,
                       out64, C, T, n, rows, d, G, s);
    case 3:
      return launch<3>(X, Yp, y_chain, radii, b, partials, tickets, out,
                       out64, C, T, n, rows, d, G, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Blocks of the kernel one SM holds at once with n_cand candidates at
// latent dimension d (the wrapper sizes the grid from it), or minus the
// CUDA error code.
extern "C" int dir_loglik_blocks_per_sm(int n_cand, int d) {
  switch (n_cand) {
    case 1:
      return blocks_per_sm<1>(d);
    case 2:
      return blocks_per_sm<2>(d);
    case 3:
      return blocks_per_sm<3>(d);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

// One launch on `stream`; returns the CUDA error code (0 on success), or
// cudaErrorInvalidValue for n_cand outside 1..3 or a shape it does not
// take.  X (C, T, n, d); Yp (T, n, n) packed Y + 2 Y^T, or (C, T, n, n)
// with y_chain = T n n (0: shared); radii
// (C, n_cand, n); b (C, n_cand, 2) as (b_in, b_out); partials:
// C * G * n_cand float64 of scratch; tickets: C uint32, zero before the
// first launch (every launch leaves them zero); out (C, n_cand) float32.
// G blocks a chain, 1 <= G <= T * tiles of the upper triangle.
extern "C" int dir_loglik_launch(const float* X, const uint8_t* Yp,
                                 const float* radii, const float* b,
                                 double* partials, unsigned* tickets,
                                 float* out, int C, int n_cand, int T, int n,
                                 int d, int G, long long y_chain,
                                 void* stream) {
  return launch_any(X, Yp, radii, b, partials, tickets, out, nullptr, C,
                    n_cand, T, n, Rows{0, n}, d, G, y_chain, stream);
}

// The row-range mode: Yp (T, rows, n), or (C, T, rows, n) with y_chain =
// T rows n, the packed rows [row0, row0 + rows); X (C, T, n, d) and radii
// (C, n_cand, n) whole; out64 (C, n_cand) float64, the sums of both
// directions of the dyads i in the rows, j > i.  G <= T * tiles of the
// rows' trapezoid.  The rest as dir_loglik_launch.
extern "C" int dir_loglik_rows_launch(const float* X, const uint8_t* Yp,
                                      const float* radii, const float* b,
                                      double* partials, unsigned* tickets,
                                      double* out64, int C, int n_cand,
                                      int T, int n, int row0, int rows,
                                      int d, int G, long long y_chain,
                                      void* stream) {
  return launch_any(X, Yp, radii, b, partials, tickets, nullptr, out64, C,
                    n_cand, T, n, Rows{row0, rows}, d, G, y_chain, stream);
}
