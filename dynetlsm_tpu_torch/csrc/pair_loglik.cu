// Full undirected Bernoulli log-likelihood of every chain at two
// intercepts (the intercept MH step's current and proposed values):
//
//   ll_c(b) = sum_{t, i<j} y_tij * eta - softplus(eta),
//   eta = b - ||x_ti - x_tj||.
//
// Replaces the Pallas kernel dynetlsm_tpu/ops/pallas_loglik.py::
// _pair_tile_kernel.  Distances are computed on the fly and never stored:
// the dense path would write and re-read a (C, T, n, n) float tensor
// (320 MB at C=32, T=10, n=500).
//
// What bounds it on the H100: two exp/log1p pairs per dyad and candidate
// (the SFU); device-memory traffic is one read of the uint8 adjacency per
// chain (L2-resident: 2.5 MB at T=10, n=500) plus the positions.
//
// Design: block (row block, t, chain); each block visits every unordered
// pair i<j of its rows once, masking the ragged edge by index (no padding).
// Sums are deterministic: each thread accumulates its pairs in a fixed
// order in float64, a block tree writes one partial per block, and a
// second kernel reduces each chain's partials in a fixed order.  No
// atomics, so a rerun on the same input gives a bit-identical result.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

// logaddexp(eta, 0): the formula of torch.logaddexp and jax.nn.softplus.
__device__ __forceinline__ float softplus(float eta) {
  const float m = fmaxf(eta, 0.0f);
  return m + log1pf(expf(-fabsf(eta)));
}

// Fixed-order tree over kThreads doubles held in shared memory; the sum
// ends in r[0].  Every thread of the block must call it.
__device__ __forceinline__ void block_tree(double* r0, double* r1) {
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      r0[threadIdx.x] = r0[threadIdx.x] + r0[threadIdx.x + s];
      r1[threadIdx.x] = r1[threadIdx.x] + r1[threadIdx.x + s];
    }
    __syncthreads();
  }
}

__global__ void pair_partial_kernel(
    const float* __restrict__ X, const uint8_t* __restrict__ Y,
    const float* __restrict__ b_cur, const float* __restrict__ b_prop,
    double* __restrict__ partials, int T, int n, int d, int n_blocks) {
  __shared__ double r0[kThreads];
  __shared__ double r1[kThreads];
  const int rb = blockIdx.x;
  const int t = blockIdx.y;
  const int c = blockIdx.z;
  const float* x_t = X + ((size_t)c * T + t) * n * d;
  const uint8_t* y_t = Y + (size_t)t * n * n;
  const float b0 = b_cur[c];
  const float b1 = b_prop[c];

  double s0 = 0.0;
  double s1 = 0.0;
  const int i_end = min(n, (rb + 1) * kRows);
  for (int i = rb * kRows; i < i_end; ++i) {
    for (int j = i + 1 + threadIdx.x; j < n; j += kThreads) {
      float d2 = 0.0f;
      for (int q = 0; q < d; ++q) {
        const float diff = x_t[i * d + q] - x_t[j * d + q];
        d2 = (q == 0) ? diff * diff : d2 + diff * diff;
      }
      const float dist = sqrtf(fmaxf(d2, 0.0f));
      const float y = (float)y_t[(size_t)i * n + j];
      const float e0 = b0 - dist;
      const float e1 = b1 - dist;
      s0 += (double)(y * e0 - softplus(e0));
      s1 += (double)(y * e1 - softplus(e1));
    }
  }
  r0[threadIdx.x] = s0;
  r1[threadIdx.x] = s1;
  __syncthreads();
  block_tree(r0, r1);
  if (threadIdx.x == 0) {
    const size_t o = ((size_t)c * T + t) * n_blocks + rb;
    partials[2 * o] = r0[0];
    partials[2 * o + 1] = r1[0];
  }
}

__global__ void pair_final_kernel(const double* __restrict__ partials,
                                  float* __restrict__ out, int per_chain) {
  __shared__ double r0[kThreads];
  __shared__ double r1[kThreads];
  const int c = blockIdx.x;
  const double* p = partials + (size_t)2 * c * per_chain;
  double s0 = 0.0;
  double s1 = 0.0;
  for (int k = threadIdx.x; k < per_chain; k += kThreads) {
    s0 += p[2 * k];
    s1 += p[2 * k + 1];
  }
  r0[threadIdx.x] = s0;
  r1[threadIdx.x] = s1;
  __syncthreads();
  block_tree(r0, r1);
  if (threadIdx.x == 0) {
    out[2 * c] = (float)r0[0];
    out[2 * c + 1] = (float)r1[0];
  }
}

}  // namespace

// Number of row blocks per (chain, t); the caller sizes `partials` as
// (C, T, pair_loglik_row_blocks(n), 2) float64.
extern "C" int pair_loglik_row_blocks(int n) { return (n + kRows - 1) / kRows; }

// Launch both passes on `stream`; returns the CUDA error code (0 on
// success).  out: (C, 2) float32, candidate 0 = b_cur, 1 = b_prop.
extern "C" int pair_loglik_launch(const float* X, const uint8_t* Y,
                                  const float* b_cur, const float* b_prop,
                                  double* partials, float* out, int C, int T,
                                  int n, int d, void* stream) {
  const int n_blocks = pair_loglik_row_blocks(n);
  const dim3 grid(n_blocks, T, C);
  cudaStream_t s = (cudaStream_t)stream;
  pair_partial_kernel<<<grid, kThreads, 0, s>>>(X, Y, b_cur, b_prop,
                                                partials, T, n, d, n_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pair_final_kernel<<<C, kThreads, 0, s>>>(partials, out, T * n_blocks);
  return (int)cudaGetLastError();
}
