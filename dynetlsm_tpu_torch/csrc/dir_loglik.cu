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
// What bounds it on the H100: per dyad and candidate, two exp/log1p pairs
// (the SFU) for the two edge directions; device-memory traffic is one read
// of the packed uint8 adjacency per chain (L2-resident: 2.5 MB at T=10,
// n=500) plus the positions and the (n_cand, n) u and v rows.
//
// Design: a first kernel divides u and v once per (chain, candidate, node)
// (IEEE division, as PyTorch divides).  The main kernel takes the pair
// kernel's layout: block (row block, t, chain); each block visits every
// unordered pair i<j of its rows once and scores both directions from the
// packed byte p = Y[i,j] + 2 Y[j,i].  The ragged edge and the diagonal are
// masked by index (no padding: intercepts may be negative, so padded
// dyads would not cancel).  Each thread accumulates its pairs in a fixed
// order in float64, a block tree writes one partial per block and
// candidate, and a last kernel reduces each chain's partials in a fixed
// order.  No atomics, so a rerun on the same input is bit-identical.
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

// Fixed-order tree over kThreads doubles of each candidate, in shared
// memory; the sums end in r[k][0].  Every thread of the block must call it.
template <int NC>
__device__ __forceinline__ void block_tree(double (*r)[kThreads]) {
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      for (int k = 0; k < NC; ++k) {
        r[k][threadIdx.x] = r[k][threadIdx.x] + r[k][threadIdx.x + s];
      }
    }
    __syncthreads();
  }
}

// One block per (chain, candidate): u, v (C, NC, n) and B (C, NC).
__global__ void dir_uv_kernel(const float* __restrict__ radii,
                              const float* __restrict__ b,
                              float* __restrict__ u, float* __restrict__ v,
                              float* __restrict__ B, int n) {
  const size_t ck = blockIdx.x;
  const float b_in = b[2 * ck];
  const float b_out = b[2 * ck + 1];
  const float* r = radii + ck * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    u[ck * n + k] = b_in / r[k];
    v[ck * n + k] = b_out / r[k];
  }
  if (threadIdx.x == 0) B[ck] = b_in + b_out;
}

template <int NC>
__global__ void dir_partial_kernel(
    const float* __restrict__ X, const uint8_t* __restrict__ Yp,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ B, double* __restrict__ partials, int T,
    int n, int d, int n_blocks) {
  __shared__ double r[NC][kThreads];
  const int rb = blockIdx.x;
  const int t = blockIdx.y;
  const int c = blockIdx.z;
  const float* x_t = X + ((size_t)c * T + t) * n * d;
  const uint8_t* p_t = Yp + (size_t)t * n * n;
  const float* u_c = u + (size_t)c * NC * n;
  const float* v_c = v + (size_t)c * NC * n;
  float Bc[NC];
  double s[NC];
  for (int k = 0; k < NC; ++k) {
    Bc[k] = B[c * NC + k];
    s[k] = 0.0;
  }

  const int i_end = min(n, (rb + 1) * kRows);
  for (int i = rb * kRows; i < i_end; ++i) {
    for (int j = i + 1 + threadIdx.x; j < n; j += kThreads) {
      float d2 = 0.0f;
      for (int q = 0; q < d; ++q) {
        const float diff = x_t[i * d + q] - x_t[j * d + q];
        d2 = (q == 0) ? diff * diff : d2 + diff * diff;
      }
      const float dist = sqrtf(fmaxf(d2, 0.0f));
      const uint8_t p = p_t[(size_t)i * n + j];
      const float y = (float)(p & 1);    // edge i -> j
      const float yt = (float)(p >> 1);  // edge j -> i
      for (int k = 0; k < NC; ++k) {
        const float s_out = u_c[k * n + j] + v_c[k * n + i];
        const float s_in = u_c[k * n + i] + v_c[k * n + j];
        const float e_out = Bc[k] - dist * s_out;
        const float e_in = Bc[k] - dist * s_in;
        s[k] += (double)(y * e_out - softplus(e_out));
        s[k] += (double)(yt * e_in - softplus(e_in));
      }
    }
  }
  for (int k = 0; k < NC; ++k) r[k][threadIdx.x] = s[k];
  __syncthreads();
  block_tree<NC>(r);
  if (threadIdx.x < NC) {
    const size_t o = ((size_t)c * T + t) * n_blocks + rb;
    partials[o * NC + threadIdx.x] = r[threadIdx.x][0];
  }
}

template <int NC>
__global__ void dir_final_kernel(const double* __restrict__ partials,
                                 float* __restrict__ out, int per_chain) {
  __shared__ double r[NC][kThreads];
  const int c = blockIdx.x;
  const double* p = partials + (size_t)NC * c * per_chain;
  double s[NC];
  for (int k = 0; k < NC; ++k) s[k] = 0.0;
  for (int m = threadIdx.x; m < per_chain; m += kThreads) {
    for (int k = 0; k < NC; ++k) s[k] += p[NC * m + k];
  }
  for (int k = 0; k < NC; ++k) r[k][threadIdx.x] = s[k];
  __syncthreads();
  block_tree<NC>(r);
  if (threadIdx.x < NC) out[NC * c + threadIdx.x] = (float)r[threadIdx.x][0];
}

template <int NC>
int launch_passes(const float* X, const uint8_t* Yp, const float* u,
                  const float* v, const float* B, double* partials,
                  float* out, int C, int T, int n, int d, int n_blocks,
                  cudaStream_t s) {
  const dim3 grid(n_blocks, T, C);
  dir_partial_kernel<NC><<<grid, kThreads, 0, s>>>(X, Yp, u, v, B, partials,
                                                   T, n, d, n_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dir_final_kernel<NC><<<C, kThreads, 0, s>>>(partials, out, T * n_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of row blocks per (chain, t); the caller sizes `partials` as
// (C, T, dir_loglik_row_blocks(n), n_cand) float64.
extern "C" int dir_loglik_row_blocks(int n) { return (n + kRows - 1) / kRows; }

// Launch the three passes on `stream`; returns the CUDA error code (0 on
// success), or cudaErrorInvalidValue for n_cand outside 1..3.
// X (C, T, n, d); Yp (T, n, n) packed Y + 2 Y^T; radii (C, n_cand, n);
// b (C, n_cand, 2) as (b_in, b_out); uvB scratch of C * n_cand * (2n + 1)
// floats; out (C, n_cand) float32.
extern "C" int dir_loglik_launch(const float* X, const uint8_t* Yp,
                                 const float* radii, const float* b,
                                 float* uvB, double* partials, float* out,
                                 int C, int n_cand, int T, int n, int d,
                                 void* stream) {
  if (n_cand < 1 || n_cand > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* u = uvB;
  float* v = uvB + (size_t)C * n_cand * n;
  float* B = v + (size_t)C * n_cand * n;
  dir_uv_kernel<<<C * n_cand, kThreads, 0, s>>>(radii, b, u, v, B, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = dir_loglik_row_blocks(n);
  switch (n_cand) {
    case 1:
      return launch_passes<1>(X, Yp, u, v, B, partials, out, C, T, n, d,
                              n_blocks, s);
    case 2:
      return launch_passes<2>(X, Yp, u, v, B, partials, out, C, T, n, d,
                              n_blocks, s);
    default:
      return launch_passes<3>(X, Yp, u, v, B, partials, out, C, T, n, d,
                              n_blocks, s);
  }
}
