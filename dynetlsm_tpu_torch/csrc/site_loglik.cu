// Each site's log-likelihood delta of the 'parallel' latent update
// (mcmc/latent.py::_parallel_site_update): for every chain c, time t and
// site i of the launch's rows, its proposal X_prop[c,t,i] against its
// current position X[c,t,i], both scored against the stale field,
//
//   delta[c,t,i] = sum_{j != i} l(X_prop[c,t,i], X[c,t,j]; y_tij)
//                             - l(X[c,t,i],      X[c,t,j]; y_tij),
//
// undirected l = y * eta - softplus(eta), eta = b - d; directed the
// sender's and the receiver's terms, eta_out = b_in (1 - d / r_j) +
// b_out (1 - d / r_i) on y_ij and eta_in = b_in (1 - d / r_i) + b_out
// (1 - d / r_j) on y_ji, read from the packed Y + 2 Y^T.  The formulas,
// in their op order, of ops/site_loglik.py::site_loglik_plain and of JAX's
// site_ll (dynetlsm_tpu/mcmc/latent.py:133-151).
//
// It replaces no Pallas kernel: the JAX package runs 'parallel' as one
// fused XLA pass of O(T n^2 d).  The port ran it as eager PyTorch over
// blocks of 2^26 dyads, a dozen unfused elementwise passes that wrote and
// read back (sites x n) float32 temporaries (967.7 ms a sweep at T = 10,
// n = 8,192, 16 chains on an H100); this kernel keeps every term in
// registers.
//
// What bounds it on the H100: instruction issue.  A partner term scores
// both candidates against one read of x_j and one adjacency byte: two
// sqrt and two exp/log1p softplus (four softplus and four IEEE divisions
// directed), every multiply and add rounded separately (-fmad=false).
// Device memory: one read of the site's row of the uint8 network a chain
// and time (chains of one time and tile are neighbouring blocks, so a row
// shared by the chains is read from L2 after the first), the field staged
// once a block.  The partner loop as compiled for d = 2 (CUDA 12.8,
// sm_90a; scripts/site_loglik_sass.py counts the shortest path through
// its body from cuobjdump -sass, the square roots' and divisions' slow
// paths not taken): 507 instructions a word of four partners undirected,
// so 126.75 a term, 4 of them MUFU (two rsqrt, two ex2); 264.25 a term
// directed, 10 MUFU (four of them the divisions' rcp).  Over 132 SMs x 128
// lanes at 1,980 MHz that is an issue bound of 40.7 ms for the 1.07e10
// terms of T = 10, n = 8,192, 16 chains, where the kernel takes 46.5 ms on
// an H100 at 700 W (87%); 0.30 ms at the north star (T = 10, n = 500, 32
// chains), where it takes 0.42 (71%), and 0.63 ms directed, where it
// takes 0.83 (76%).
//
// Design: a block owns one chain and time and a tile of sites.  It stages
// the field X[c,t] (and directed the radii of chain c) in dynamic shared
// memory, coordinate-major, so that a lane reads four partners' x with one
// 16-byte load; past what the stage holds (STAGE bytes, chosen from n by
// the launch rule in ops/site_loglik.py) it stages chunks of partners in
// turn.  A site belongs to a group of G lanes (G = 32 where n > 64, fewer
// for small networks, so Sampson's 18 partners do not leave lanes idle);
// lane l of the group takes the partners j = 4 (l + G m) .. +3, one 32-bit
// load of their adjacency bytes where the rows are whole words, bytes
// elsewhere; the site's own slot and partners past n are masked by index.
// Sums: each lane adds its partners' deltas, the difference and not two
// sums (each ~10^2-10^3 nats, whose float32 difference would lose the
// delta), in a fixed order in float32, the group's lanes in a fixed
// float64 shuffle tree, rounded once.  No atomics: a rerun gives the same
// bits.
//
// Row-range mode: the launch's sites are the rows [row0, row0 + rows) of
// the network, Y holding those rows only (node sharding, mcmc/nodes.py);
// every site still meets all n partners.  The whole network is the case
// row0 = 0, rows = n.
#include <cstdint>
#include <cuda_runtime.h>

#include "loglik_common.cuh"

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kWord = 4;        // partners a 32-bit word of a row
constexpr int kMaxDevices = 16;

using loglik::load_y4;
using loglik::softplus;

struct Shape {
  int T, n, row0, rows, d;
  int lanes;      // G: lanes a site, a power of two <= 32
  int per_group;  // K: sites each lane group takes in turn
  int chunk;      // L: partners staged at once, a multiple of kWord
  long long y_chain, y_time, y_row;  // bytes between chains, times, rows
  int words;      // rows read as 32-bit words
};

// The site's two candidates' squared distances to the four partners of a
// staged word at slot m: xs the staged coordinates (coordinate q at
// xs[q L ...]), xp / xc the proposal and current position (registers for
// D = 2, device memory for any d).
template <int D>
__device__ __forceinline__ void squared_distances(const float* xs, int L,
                                                  int m, int d_any,
                                                  const float* xp,
                                                  const float* xc,
                                                  float (&d2p)[kWord],
                                                  float (&d2c)[kWord]) {
  const int d = D ? D : d_any;
#pragma unroll
  for (int q = 0; q < d; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(xs + q * L + m);
    const float xj[kWord] = {v.x, v.y, v.z, v.w};
    const float a = xp[q], b = xc[q];
#pragma unroll
    for (int k = 0; k < kWord; ++k) {
      const float ep = a - xj[k];
      const float ec = b - xj[k];
      d2p[k] = (q == 0) ? ep * ep : d2p[k] + ep * ep;
      d2c[k] = (q == 0) ? ec * ec : d2c[k] + ec * ec;
    }
  }
}

// One candidate's term against one partner: y_ij (and directed y_ji), the
// distance's square, the intercepts and, directed, r_i and r_j.
template <bool kDirected>
__device__ __forceinline__ float term(float d2, float y, float yt, float b0,
                                      float b1, float ri, float rj) {
  const float dist = sqrtf(fmaxf(d2, 0.0f));
  if (kDirected) {
    const float q_other = dist / rj;
    const float q_self = dist / ri;
    const float eta_out = b0 * (1.0f - q_other) + b1 * (1.0f - q_self);
    const float eta_in = b0 * (1.0f - q_self) + b1 * (1.0f - q_other);
    const float ll = y * eta_out - softplus(eta_out);
    return ll + (yt * eta_in - softplus(eta_in));
  }
  const float eta = b0 - dist;
  return y * eta - softplus(eta);
}

// Lane gl's partners of the staged chunk [j0, j0 + len) for site i: sum
// gains each one's delta (proposal minus current), in slot order.
template <bool kDirected, int D>
__device__ __forceinline__ void row_chunk(
    const float* xs, const float* rs, int L, int j0, int len,
    const uint8_t* y_row, int n, bool words, int i, int gl, int G,
    int d_any, const float* xp, const float* xc, float b0, float b1,
    float ri, float& sum) {
  for (int m = kWord * gl; m < len; m += kWord * G) {
    const int j = j0 + m;
    const uint32_t w = load_y4(y_row + j, n - j, words);
    float d2p[kWord], d2c[kWord];
    squared_distances<D>(xs, L, m, d_any, xp, xc, d2p, d2c);
    float rj[kWord] = {1.0f, 1.0f, 1.0f, 1.0f};
    if (kDirected) {
      const float4 r4 = *reinterpret_cast<const float4*>(rs + m);
      rj[0] = r4.x;
      rj[1] = r4.y;
      rj[2] = r4.z;
      rj[3] = r4.w;
    }
#pragma unroll
    for (int k = 0; k < kWord; ++k) {
      const uint32_t byte = (w >> (8 * k)) & 0xffu;
      const float y = (float)(kDirected ? (byte & 1u) : byte);
      const float yt = (float)(byte >> 1);
      const float llp = term<kDirected>(d2p[k], y, yt, b0, b1, ri, rj[k]);
      const float llc = term<kDirected>(d2c[k], y, yt, b0, b1, ri, rj[k]);
      const bool live = m + k < len && j + k != i;
      sum += live ? llp - llc : 0.0f;
    }
  }
}

// D: the latent dimension it is compiled for (2), or 0 for any d.
// Grid (C, tiles, T): chain c, the tile of sites, time t; chains fastest,
// so the chains of one time and tile run side by side on one row of Y.
template <bool kDirected, int D>
__global__ void __launch_bounds__(kThreads)
site_loglik_kernel(const float* __restrict__ X, const float* __restrict__ Xq,
                   const uint8_t* __restrict__ Y, const float* __restrict__ b,
                   const float* __restrict__ radii, float* __restrict__ out,
                   Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int d = D ? D : s.d;
  const int c = blockIdx.x, tile = blockIdx.y, t = blockIdx.z;
  const int G = s.lanes, L = s.chunk;
  const int groups = kThreads / G;
  const int group = threadIdx.x / G, gl = threadIdx.x % G;
  const int sites = groups * s.per_group;
  const int chunks = (s.n + L - 1) / L;
  // stage: coordinates [d][L], directed the radii [L], then (several
  // chunks) each lane's running sum of each site of the tile
  float* xs = smem;
  float* rs = smem + d * L;
  float* acc = rs + (kDirected ? L : 0);
  const size_t ct = (size_t)c * s.T + t;
  const float* x_ct = X + ct * s.n * d;
  const float* xq_ct = Xq + ct * s.n * d;
  const float* r_c = kDirected ? radii + (size_t)c * s.n : nullptr;
  const uint8_t* y_ct = Y + c * s.y_chain + t * s.y_time;
  const float b0 = kDirected ? b[2 * c] : b[c];
  const float b1 = kDirected ? b[2 * c + 1] : 0.0f;
  const bool words = s.words != 0;
  for (int ch = 0; ch < chunks; ++ch) {
    const int j0 = ch * L;
    const int len = min(L, s.n - j0);
    if (ch > 0) __syncthreads();  // every group is done with the last one
    for (int e = threadIdx.x; e < L; e += kThreads) {
      const bool in = e < len;
      for (int q = 0; q < d; ++q)
        xs[q * L + e] = in ? x_ct[(size_t)(j0 + e) * d + q] : 0.0f;
      if (kDirected) rs[e] = in ? r_c[j0 + e] : 1.0f;
    }
    __syncthreads();
    for (int k = 0; k < s.per_group; ++k) {
      const int slot = group + groups * k;
      const int li = tile * sites + slot;  // the site's row of the launch
      const bool live = li < s.rows;
      const int i = s.row0 + li;
      float sum = ch == 0 ? 0.0f : acc[slot * G + gl];
      if (live) {
        float xp2[D ? D : 1], xc2[D ? D : 1];
        const float* xp = xq_ct + (size_t)i * d;
        const float* xc = x_ct + (size_t)i * d;
        if (D) {
#pragma unroll
          for (int q = 0; q < (D ? D : 1); ++q) {
            xp2[q] = xp[q];
            xc2[q] = xc[q];
          }
          xp = xp2;
          xc = xc2;
        }
        row_chunk<kDirected, D>(xs, rs, L, j0, len, y_ct + li * s.y_row,
                                s.n, words, i, gl, G, d, xp, xc, b0, b1,
                                kDirected ? r_c[i] : 1.0f, sum);
      }
      if (ch + 1 < chunks) {
        acc[slot * G + gl] = sum;
        continue;
      }
      // the group's lanes in a fixed float64 tree (every lane of the warp
      // takes part: the groups of a warp run the same k)
      double v = sum;
      for (int h = G / 2; h > 0; h >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, h, G);
      if (gl == 0 && live) out[ct * s.rows + li] = (float)v;
    }
  }
}

}  // namespace

// ---- launch

namespace {

// Bytes of dynamic shared memory: the stage and, when the partners come in
// several chunks, a running sum a lane and site of the tile.
size_t smem_bytes(int n, int d, int directed, int chunk, int per_group) {
  const size_t stage = (size_t)(d + (directed ? 1 : 0)) * chunk;
  const size_t acc = chunk < n ? (size_t)kThreads * per_group : 0;
  return sizeof(float) * (stage + acc);
}

// The instantiation's opt-in to `smem` bytes of dynamic shared memory on
// the current device: raised when a launch asks for more than it was given,
// never lowered (one record per device; devices past kMaxDevices opt in at
// every call).
template <bool kDirected, int D>
cudaError_t opt_in(size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static size_t opted_in[kMaxDevices] = {};
  size_t unrecorded = 0;
  size_t& opted = dev < kMaxDevices ? opted_in[dev] : unrecorded;
  if (smem > opted) {
    err = cudaFuncSetAttribute(site_loglik_kernel<kDirected, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  return cudaSuccess;
}

template <bool kDirected, int D>
int launch(const float* X, const float* Xq, const uint8_t* Y, const float* b,
           const float* radii, float* out, int C, const Shape& s,
           size_t smem, cudaStream_t stream) {
  const cudaError_t err = opt_in<kDirected, D>(smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = kThreads / s.lanes;
  const int sites = groups * s.per_group;
  const dim3 grid(C, (s.rows + sites - 1) / sites, s.T);
  site_loglik_kernel<kDirected, D><<<grid, kThreads, smem, stream>>>(
      X, Xq, Y, b, radii, out, s);
  return (int)cudaGetLastError();
}

template <bool kDirected, int D>
int blocks_per_sm(size_t smem) {
  cudaError_t err = opt_in<kDirected, D>(smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, site_loglik_kernel<kDirected, D>, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// Bytes of dynamic shared memory a launch with these arguments asks for.
extern "C" int site_loglik_smem_bytes(int n, int d, int directed, int chunk,
                                      int per_group) {
  return (int)smem_bytes(n, d, directed, chunk, per_group);
}

// Blocks of the kernel one SM holds at once with `smem` bytes of dynamic
// shared memory (the wrapper sizes the tiles from it), or minus the CUDA
// error code.
extern "C" int site_loglik_blocks_per_sm(int directed, int d, int smem) {
  if (directed) {
    return d == 2 ? blocks_per_sm<true, 2>(smem)
                  : blocks_per_sm<true, 0>(smem);
  }
  return d == 2 ? blocks_per_sm<false, 2>(smem)
                : blocks_per_sm<false, 0>(smem);
}

// One launch on `stream`; returns the CUDA error code (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
// X, Xq: (C, T, n, d) float32, the field and every site's proposal;
// Y: uint8, chain c's time t row li (site row0 + li) at
// Y + c y_chain + t y_time + li y_row (y_chain 0: one network for every
// chain), each row's n bytes (more where padded), packed Y + 2 Y^T when
// directed; b: (C,) the intercept, or directed (C, 2) (b_in, b_out), with
// radii (C, n) (null when undirected); out: (C, T, rows) float32, the
// delta of each site of the rows [row0, row0 + rows).  lanes (a power of
// two <= 32) per site, per_group sites a lane group takes in turn, chunk
// (a multiple of 4) partners staged at once: the launch rule of
// ops/site_loglik.py.
extern "C" int site_loglik_launch(const float* X, const float* Xq,
                                  const uint8_t* Y, const float* b,
                                  const float* radii, float* out, int C,
                                  int T, int n, int row0, int rows, int d,
                                  int directed, int lanes, int per_group,
                                  int chunk, long long y_chain,
                                  long long y_time, long long y_row,
                                  void* stream) {
  const int groups = lanes > 0 ? kThreads / lanes : 0;
  const long long sites = (long long)groups * per_group;
  const size_t smem = smem_bytes(n, d, directed, chunk, per_group);
  if (C < 1 || C > 0x7fffffff || T < 1 || T > 65535 || n < 1 || d < 1 ||
      row0 < 0 || rows < 1 || row0 + rows > n || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || per_group < 1 || chunk < kWord ||
      chunk % kWord != 0 || (rows + sites - 1) / sites > 65535 ||
      y_row < n || y_time < (long long)rows * y_row || y_chain < 0 ||
      smem > 227 * 1024 || (directed && radii == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // 32-bit words where every row starts on a 4-byte boundary and holds
  // its last word whole
  const int words = (uintptr_t)Y % 4 == 0 && y_chain % 4 == 0 &&
                    y_time % 4 == 0 && y_row % 4 == 0 &&
                    y_row >= (long long)(n + kWord - 1) / kWord * kWord;
  const Shape s{T,     n,       row0,   rows,   d,     lanes, per_group,
                chunk, y_chain, y_time, y_row, words};
  cudaStream_t st = (cudaStream_t)stream;
  if (directed) {
    return d == 2 ? launch<true, 2>(X, Xq, Y, b, radii, out, C, s, smem, st)
                  : launch<true, 0>(X, Xq, Y, b, radii, out, C, s, smem, st);
  }
  return d == 2 ? launch<false, 2>(X, Xq, Y, b, radii, out, C, s, smem, st)
                : launch<false, 0>(X, Xq, Y, b, radii, out, C, s, smem, st);
}
