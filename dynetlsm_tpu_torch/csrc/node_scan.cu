// Exact single-site Metropolis node scan of the latent positions, for C
// chains at once.
//
// Replaces the Pallas kernels dynetlsm_tpu/ops/pallas_scan.py::
// _node_scan_kernel (T > 8) and ::_node_scan_kernel_fullT (T <= 8) in all
// their modes: undirected or directed social-radii (template kDirected),
// with the mixture (AR(1)-to-cluster-mean) prior or the Gaussian
// random-walk prior (template kMixture; pallas_scan.py:320-332 and
// :760-765 compute the random-walk prior), untempered or with a per-chain
// inverse temperature (template kTempered; the tempering lane,
// pallas_scan.py:244-250, :409 and :821).  T is a runtime argument, so one
// kernel serves both Pallas kernels.  With the same injected proposal
// stream (eps (C,2,n,T,d), log_u (C,2,n,T)) it realises the same Markov
// chain as dynetlsm_tpu/mcmc/latent.py::xla_exact_scan: nodes in index
// order, each node in two parity phases (even t, then odd t), a site
// accepted iff log_u < ratio.
//
// What bounds it on the H100.  The scan is 2n dependent phase steps per
// sweep (1,000 at the north star, T=10, n=500), so it is bound by the
// latency of one step, not by bandwidth.  Within a step a chain evaluates
// ceil(T/2) * n partner terms (two sqrt and two exp/log1p softplus each,
// four softplus directed; ~220 SASS instructions a term undirected with
// -fmad=false and the accurate expf/log1pf, each term one long dependent
// chain), so once the fixed latency is gone the next bounds are one SM's
// issue rate for those terms (~2,500 terms a step at the north star) and
// the latency of one term's chain.  The design takes on both:
//
// 1. The partner sum is a pairwise tree over the partner axis padded to a
//    power of two P >= 32, level h adding element i + h into element i;
//    ops/node_scan.py's plain version (_tree_sum) sums in that order and
//    this file is compiled with -fmad=false, so the two compute
//    bit-identical ratios and accept decisions.  The tree runs in
//    registers and shuffles, not in shared memory.  Each in-phase time has
//    a group of W warps (W in {1, 2, 4}), and a cluster of B blocks splits
//    the partners, so R = 32 W B lanes share one time's partners: the lane
//    of residue r owns partners i = r (mod R).  The levels h >= R pair only
//    elements of one residue, so the lane runs them in registers: its
//    partners in bit-reversed order, up to four side by side (independent
//    chains), each chunk's adjacent-pairs tree pushed onto an online
//    pairwise stack, which builds the same tree.  The lanes then write
//    their R values to an exchange buffer; one warp per time loads them
//    back, 32 apart, halves them level by level (R/2 .. 32) in registers,
//    and runs the levels 16 .. 1 with __shfl_down_sync (lane i gets
//    v_i + v_{i+h}, as a[:h] + a[h:] does).  A phase step has one named
//    barrier per group and one block barrier for the field update (eleven
//    block barriers in the shared-memory tree this replaces), and no
//    integer division.
// 2. No global load lies on a step's dependent path.  While node j runs,
//    cp.async copies node j+1's inputs for every time into the other half
//    of a double buffer in shared memory: the adjacency rows Y[t, j+1, :]
//    (16-byte copies; the wrapper pads the rows to P bytes, the padded
//    columns are never read), step, eps, log_u and, for the mixture prior,
//    mu_z and sig_z; each thread keeps its copy's addresses from node to
//    node.  The copies are waited for at the block barrier that ends node
//    j.  The directed per-node terms b_out / r_j and b_in / r_j are the
//    reciprocal rows v[j] and u[j], divided once per launch.  One more
//    warp, the prior warp, evaluates the prior terms of every in-phase time
//    (one lane each) while the groups evaluate the partners, so the prior
//    is off the path from the partner terms to the accept.
// 3. One SM per chain leaves most of the card idle at few chains (32 of
//    132 SMs at the north star).  With B > 1 a chain runs on a thread-block
//    cluster of B blocks, each on an SM of its own (a block asks for more
//    than half an SM's shared memory).  Every block keeps the whole
//    position field (40 KB at the north star) and evaluates its B-th of the
//    partner residues; it stores its exchange values into every peer's
//    buffer with st.async over distributed shared memory, each store
//    completing 4 bytes on the peer's mbarrier of that buffer half (the
//    buffer is double-buffered by step parity), so a block waits for its
//    peers' values alone and no barrier spans the cluster within the scan.
//    Every block then finishes the tree in the same order, decides the
//    accepts itself and updates its own copy of the field: identical
//    inputs give identical decisions, so nothing else crosses SMs.  Only
//    the cluster's block 0 writes X_out and the accepts.  A peer stores
//    into a half again only after it has received this block's values of
//    the step in between, which this block sends after reading the half,
//    so a half is never overwritten while it is read.  The wrapper takes
//    B > 1 only where the card runs all the chains' clusters at once.
//
// Random-walk prior (kMixture false): with the node's own neighbours
// prev = x[t-1] and nxt = x[t+1],
//   back = (-0.5 * |x|^2) / tau_sq at t = 0, (-0.5 * |x - prev|^2) / sigma_sq
//   after; fwd = (-0.5 * |nxt - x|^2) / sigma_sq, 0 at t = T-1,
// summed in index order and divided in IEEE single precision, the op order
// of the plain version (ops/node_scan.py::_rw_prior_per_t).  mu_z, sig_z and
// lmbda are not read and may be null.
//
// Tempering (template kTempered; parallel tempering, mcmc/tempering.py):
// temper (C,) scales the summed likelihood delta of chain c's sites,
// ratio = (temper[c] * delta + lp) - lc, the op order of the plain version,
// of the JAX scan and of the Pallas kernel; never each partner term.  The
// chain's value sits in shared memory, read by the accept lanes only.  A
// null temper launches the untempered instantiation, which has no
// multiply and no load.
//
// Directed mode (template kDirected): the adjacency arrives packed as
// Y + 2 Y^T (uint8), so row j of it gives both the out-edge bit y = Y[j,i]
// and the in-edge bit yt = Y[i,j] of every partner i in one contiguous
// read.  eta is evaluated in the hoisted-reciprocal form of the JAX scan,
//   eta_out = (b_in + b_out) - d * (b_in / r_i + b_out / r_j),
//   eta_in  = (b_in + b_out) - d * (b_out / r_i + b_in / r_j),
// with u = b_in / r and v = b_out / r divided once per launch into shared
// memory (IEEE division, as PyTorch divides), so the plain version rounds
// every term alike.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// threads of one block, and named barriers (ids 1..15) for the groups
constexpr int kMaxThreads = 768;
constexpr int kMaxGroups = 15;
// a lane evaluates up to kChunk partners at once; the pairwise stack of
// its chunks: up to 2^8 chunks, 2^10 partners a lane (P <= 32768)
constexpr int kChunk = 4;
constexpr int kChunkLevels = 9;
// exchange values a reducing lane reads: R / 32 <= 16 (R <= 512)
constexpr int kMaxExchange = 16;

// ---- inline PTX ----------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// barrier `id` among `count` threads (whole warps) of the block: wait, or
// only arrive
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// an mbarrier in shared memory that completes a phase after `count`
// arrivals and the transaction bytes they announce
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the barrier inits are visible to the cluster's other blocks
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival, announcing `bytes` of stores that will complete on `bar`
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the completion of the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// v into block `rank`'s copy of *dst, completing 4 bytes on its copy of
// the mbarrier `bar` (a store over distributed shared memory that needs
// no barrier across the cluster)
__device__ __forceinline__ void st_async(float* dst, float v, uint64_t* bar,
                                         int rank) {
  unsigned d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(smem_addr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(b)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(d),
      "r"(__float_as_uint(v)), "r"(b)
      : "memory");
}

// ---- end of inline PTX ---------------------------------------------------

// logaddexp(eta, 0): the formula of torch.logaddexp and jax.nn.softplus.
__device__ __forceinline__ float softplus(float eta) {
  const float m = fmaxf(eta, 0.0f);
  return m + log1pf(expf(-fabsf(eta)));
}

// k with its lowest `lg` bits reversed
__device__ __forceinline__ int bit_reverse(int k, int lg) {
  return lg == 0 ? 0 : (int)(__brev((unsigned)k) >> (32 - lg));
}

// One element of an online pairwise sum: element k of a sequence whose
// adjacent-pairs tree is being built, stk[l] the pending left subtree of
// 2^l elements.  Returns the subtree that element k completes.  Fed a
// power-of-two sequence in bit-reversed order, the last call returns the
// tree that halves the sequence level by level (a[:h] + a[h:]).  Every
// index is a constant, so the stack stays in registers.
template <int kLevels>
__device__ __forceinline__ float push_pairwise(float (&stk)[kLevels], int k,
                                               float v) {
  bool open = true;
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    if (open) {
      if ((k >> l) & 1) {
        v = stk[l] + v;
      } else {
        stk[l] = v;
        open = false;
      }
    }
  }
  return v;
}

// The levels 16 .. 1: lane 0 returns the sum of the warp's 32 values.
__device__ __forceinline__ float shuffle_levels(float v) {
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1)
    v = v + __shfl_down_sync(0xffffffffu, v, h);
  return v;
}

// The levels R/2 .. 32 of one time's R exchange values xb[0 .. R): lane l
// loads xb[l + 32 q] for the kN = R/32 values of q at once and halves them
// level by level in registers.
template <int kH>
__device__ __forceinline__ void halve_levels(float (&a)[2 * kH]) {
#pragma unroll
  for (int q = 0; q < kH; ++q) a[q] = a[q] + a[q + kH];
  if constexpr (kH > 1)
    halve_levels<kH / 2>(reinterpret_cast<float(&)[kH]>(a));
}

template <int kN>
__device__ __forceinline__ float halve_exchange(const float* xb, int lane) {
  float a[kN];
#pragma unroll
  for (int q = 0; q < kN; ++q) a[q] = xb[lane + 32 * q];
  halve_levels<kN / 2>(a);
  return a[0];
}

__device__ __forceinline__ float exchange_levels(const float* xb, int R,
                                                 int lane) {
  switch (R >> 5) {
    case 1:
      return xb[lane];
    case 2:
      return halve_exchange<2>(xb, lane);
    case 4:
      return halve_exchange<4>(xb, lane);
    case 8:
      return halve_exchange<8>(xb, lane);
    default:
      return halve_exchange<kMaxExchange>(xb, lane);
  }
}

// The likelihood delta of partner i (llp - llc, the node's own slot
// masked), given the squared distances to the proposal and the current
// position.
template <bool kDirected>
__device__ __forceinline__ float partner_delta(
    float d2p, float d2c, uint8_t yb, int i, int j, float bc, float both,
    const float* __restrict__ u_s, const float* __restrict__ v_s,
    float bo_rj, float bi_rj) {
  float llp, llc;
  if (kDirected) {
    const float y = (float)(yb & 1);    // edge j -> i
    const float yt = (float)(yb >> 1);  // edge i -> j
    const float p_out = u_s[i] + bo_rj;
    const float p_in = v_s[i] + bi_rj;
    const float dist_p = sqrtf(fmaxf(d2p, 0.0f));
    const float dist_c = sqrtf(fmaxf(d2c, 0.0f));
    const float eo_p = both - dist_p * p_out;
    const float ei_p = both - dist_p * p_in;
    const float eo_c = both - dist_c * p_out;
    const float ei_c = both - dist_c * p_in;
    llp = y * eo_p - softplus(eo_p);
    llp = llp + (yt * ei_p - softplus(ei_p));
    llc = y * eo_c - softplus(eo_c);
    llc = llc + (yt * ei_c - softplus(ei_c));
  } else {
    const float y = (float)yb;
    const float eta_p = bc - sqrtf(fmaxf(d2p, 0.0f));
    const float eta_c = bc - sqrtf(fmaxf(d2c, 0.0f));
    llp = y * eta_p - softplus(eta_p);
    llc = y * eta_c - softplus(eta_c);
  }
  return (llp - llc) * (i == j ? 0.0f : 1.0f);
}

// The likelihood delta of partner i at time t, the node at xc (current)
// and xp (proposal).  D = 2 keeps the node's coordinates in registers;
// D = 0 reads them for any d (then xc, xp are unused).
template <bool kDirected, int D>
__device__ __forceinline__ float partner_term(
    const float* __restrict__ x_t, const uint8_t* __restrict__ y_row,
    const float* __restrict__ e, float s, const float* xc, const float* xp,
    int i, int j, int d, float bc, float both, const float* __restrict__ u_s,
    const float* __restrict__ v_s, float bo_rj, float bi_rj) {
  float d2p = 0.0f;
  float d2c = 0.0f;
  if constexpr (D == 2) {
    const float2 xi = reinterpret_cast<const float2*>(x_t)[i];
    const float dp0 = xi.x - xp[0], dc0 = xi.x - xc[0];
    const float dp1 = xi.y - xp[1], dc1 = xi.y - xc[1];
    d2p = dp0 * dp0;
    d2c = dc0 * dc0;
    d2p = d2p + dp1 * dp1;
    d2c = d2c + dc1 * dc1;
  } else {
    for (int q = 0; q < d; ++q) {
      const float xcq = x_t[j * d + q];
      const float xpq = xcq + s * e[q];
      const float dp = x_t[i * d + q] - xpq;
      const float dc = x_t[i * d + q] - xcq;
      d2p = (q == 0) ? dp * dp : d2p + dp * dp;
      d2c = (q == 0) ? dc * dc : d2c + dc * dc;
    }
  }
  return partner_delta<kDirected>(d2p, d2c, y_row[i], i, j, bc, both, u_s,
                                  v_s, bo_rj, bi_rj);
}

// The register levels of one lane: the pairwise sum of its partners
// i = r + R * k (k < P / R; the padding i >= n contributes 0) at time t.
// Its partners go in bit-reversed k order, kCh at once (independent
// terms, evaluated side by side; a padded slot evaluates a real partner
// and is zeroed), each chunk's adjacent-pairs tree pushed as one subtree.
template <bool kDirected, int D, int kCh>
__device__ __forceinline__ float lane_chunks(
    const float* __restrict__ x_t, const uint8_t* __restrict__ y_row,
    const float* __restrict__ e, float s, const float* xc, const float* xp,
    int j, int n, int d, int r, int R, int nv, float bc, float both,
    const float* __restrict__ u_s, const float* __restrict__ v_s,
    float bo_rj, float bi_rj) {
  const int lg = __ffs(nv) - 1;
  float stk[kChunkLevels];
  float v = 0.0f;
  for (int kk = 0; kk < nv; kk += kCh) {
    float tm[kCh];
#pragma unroll
    for (int u = 0; u < kCh; ++u) {
      const int i = r + R * bit_reverse(kk + u, lg);
      const float term = partner_term<kDirected, D>(
          x_t, y_row, e, s, xc, xp, i < n ? i : j, j, d, bc, both, u_s, v_s,
          bo_rj, bi_rj);
      tm[u] = i < n ? term : 0.0f;
    }
#pragma unroll
    for (int h = kCh / 2; h >= 1; h >>= 1) {
#pragma unroll
      for (int u = 0; u < h; ++u) tm[u] = tm[2 * u] + tm[2 * u + 1];
    }
    v = push_pairwise(stk, kk / kCh, tm[0]);
  }
  return v;
}

template <bool kDirected, int D>
__device__ __forceinline__ float lane_levels(
    const float* __restrict__ x_t, const uint8_t* __restrict__ y_row,
    const float* __restrict__ e, float s, int j, int n, int d, int r, int R,
    int P, float bc, float both, const float* __restrict__ u_s,
    const float* __restrict__ v_s, float bo_rj, float bi_rj) {
  const int nv = P / R;
  float xc[2] = {0.0f, 0.0f}, xp[2] = {0.0f, 0.0f};
  if constexpr (D == 2) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      xc[q] = x_t[j * 2 + q];
      xp[q] = xc[q] + s * e[q];
    }
  }
  if (nv >= kChunk)
    return lane_chunks<kDirected, D, kChunk>(x_t, y_row, e, s, xc, xp, j, n,
                                             d, r, R, nv, bc, both, u_s, v_s,
                                             bo_rj, bi_rj);
  if (nv == 2)
    return lane_chunks<kDirected, D, 2>(x_t, y_row, e, s, xc, xp, j, n, d,
                                        r, R, nv, bc, both, u_s, v_s, bo_rj,
                                        bi_rj);
  return lane_chunks<kDirected, D, 1>(x_t, y_row, e, s, xc, xp, j, n, d, r,
                                      R, nv, bc, both, u_s, v_s, bo_rj,
                                      bi_rj);
}

// One 4- or 16-byte copy of a node's inputs into shared memory: node jn
// reads src + jn * stride; dst is its byte offset in the first staging
// half, half the byte distance to the second.
struct Copy {
  const char* src;
  int stride, dst, half, bytes;
};

// Per-buffer layout of the staged per-node scalars (floats).
struct Stage {
  int step, logu, eps, mu, sig, size;
  __device__ __forceinline__ Stage(int T, int d)
      : step(0), logu(T), eps(3 * T), mu(3 * T + 2 * T * d),
        sig(3 * T + 3 * T * d), size(4 * T + 3 * T * d) {}
};

// b: (C,) intercepts, or (C, 2) = (b_in, b_out) when kDirected; radii:
// (C, n) when kDirected, unused otherwise; Y: the 0/1 adjacency, or the
// packed Y + 2 Y^T when kDirected, its rows padded to P bytes (T, n, P).
// mu_z, sig_z, lmbda: the mixture prior's per-site cluster means and
// variances and per-chain lambda (kMixture); tau_sq, sigma_sq: the
// random-walk prior's variances (!kMixture).  temper: (C,) per-chain
// inverse temperatures (kTempered), unused otherwise.  W warps per
// in-phase time, B blocks (a cluster) per chain.
template <bool kDirected, bool kMixture, bool kTempered>
__global__ void __launch_bounds__(kMaxThreads) node_scan_kernel(
    const float* __restrict__ X_in, const uint8_t* __restrict__ Y,
    const float* __restrict__ step, const float* __restrict__ eps,
    const float* __restrict__ log_u, const float* __restrict__ mu_z,
    const float* __restrict__ sig_z, const float* __restrict__ b,
    const float* __restrict__ radii, const float* __restrict__ lmbda,
    const float* __restrict__ temper, float* __restrict__ X_out,
    float* __restrict__ acc, int T, int n, int d, int P, int W, int B,
    float tau_sq, float sigma_sq) {
  extern __shared__ __align__(16) float smem[];
  const int field = T * n * d;
  const int H = (T + 1) / 2;  // in-phase times, at most
  const int R = 32 * W * B;   // lanes that share one time's partners
  const Stage st(T, d);
  // (2,) mbarriers of the exchange halves, then (2, T, P) staged rows
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ys = reinterpret_cast<uint8_t*>(smem + 4);
  float* xs = smem + 4 + T * P / 2;                // (T, n, d) positions
  float* u_s = xs + field;                         // directed: b_in / r
  float* v_s = u_s + n;                            // directed: b_out / r
  float* xbuf = xs + field + (kDirected ? 2 * n : 0);  // (2, H, R)
  float* ss = xbuf + 2 * H * R;                    // (2, st.size) scalars
  float* pri = ss + 2 * st.size;                   // (H, 2) lp, lc
  float* beta_s = pri + 2 * H;                     // the chain's temper

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = (nthr / 32 - 1) / W;  // groups of W warps
  const int pw = G * W;               // the last warp: the prior terms
  const int g = warp / W;  // the group: in-phase times g, g + G, ..
  const int w = warp - g * W;
  const int c = blockIdx.x / B;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = B > 1 ? (int)cluster.block_rank() : 0;
  const int r = 32 * W * rank + 32 * w + lane;  // this lane's residue

  const float* X_c = X_in + (size_t)c * field;
  for (int k = tid; k < field; k += nthr) xs[k] = X_c[k];

  const float bc = kDirected ? 0.0f : b[c];
  const float b_in = kDirected ? b[2 * c] : 0.0f;
  const float b_out = kDirected ? b[2 * c + 1] : 0.0f;
  const float both = b_in + b_out;
  if (kDirected) {
    const float* radii_c = radii + (size_t)c * n;
    for (int k = tid; k < n; k += nthr) {
      const float rk = radii_c[k];
      u_s[k] = b_in / rk;
      v_s[k] = b_out / rk;
    }
  }
  if (kTempered && tid == 0) beta_s[0] = temper[c];
  const float lam = kMixture ? lmbda[c] : 0.0f;
  const float one_m = 1.0f - lam;
  const float* step_c = step + (size_t)c * T * n;
  const float* eps_c = eps + (size_t)c * 2 * n * T * d;
  const float* logu_c = log_u + (size_t)c * 2 * n * T;
  const float* muz_c = kMixture ? mu_z + (size_t)c * T * n * d : nullptr;
  const float* sigz_c = kMixture ? sig_z + (size_t)c * T * n : nullptr;
  float* acc_c = acc + (size_t)c * T * n;

  // node jn's inputs into half `half` of the staging buffers: copy k of
  // a node reads src + jn * stride and writes at byte dst + half * cp.half
  // of shared memory; each thread keeps its first copy's description
  const int row_chunks = P / 16;
  const int n_copies = T * row_chunks + 3 * T + 2 * T * d
                       + (kMixture ? T * d + T : 0);
  const int ys_half = T * P;           // bytes
  const int ss_half = 4 * st.size;     // bytes
  const int ys_at = 4 * 4;             // bytes: after the mbarriers
  const int ss_at = 4 * (ss - smem);   // bytes
  auto copy_of = [&](int k) {
    Copy cp;
    if (k < T * row_chunks) {
      const int t = k / row_chunks;
      const int off = 16 * (k - t * row_chunks);
      cp = {reinterpret_cast<const char*>(Y + (size_t)t * n * P + off), P,
            ys_at + t * P + off, ys_half, 16};
      return cp;
    }
    k -= T * row_chunks;
    const float* src;
    int stride, at;
    if (k < T) {
      src = step_c + (size_t)k * n, stride = 1, at = st.step + k;
    } else if ((k -= T) < 2 * T) {
      const int ph = k / T;
      src = logu_c + (size_t)ph * n * T + (k - ph * T), stride = T;
      at = st.logu + k;
    } else if ((k -= 2 * T) < 2 * T * d) {
      const int ph = k / (T * d);
      src = eps_c + (size_t)ph * n * T * d + (k - ph * T * d);
      stride = T * d, at = st.eps + k;
    } else if ((k -= 2 * T * d) < T * d) {
      const int t = k / d;
      src = muz_c + (size_t)t * n * d + (k - t * d), stride = d;
      at = st.mu + k;
    } else {
      k -= T * d;
      src = sigz_c + (size_t)k * n, stride = 1, at = st.sig + k;
    }
    cp = {reinterpret_cast<const char*>(src), 4 * stride, ss_at + 4 * at,
          ss_half, 4};
    return cp;
  };
  auto issue = [&](Copy cp, int jn, int half) {
    char* dst = reinterpret_cast<char*>(smem) + cp.dst + half * cp.half;
    const char* src = cp.src + (long long)jn * cp.stride;
    if (cp.bytes == 16) {
      cp_async16(dst, src);
    } else {
      cp_async4(dst, src);
    }
  };
  const Copy mine = copy_of(tid < n_copies ? tid : 0);
  auto stage_node = [&, mine](int jn, int half) {
    if (tid < n_copies) issue(mine, jn, half);
    for (int k = tid + nthr; k < n_copies; k += nthr)
      issue(copy_of(k), jn, half);
    cp_async_commit();
  };

  stage_node(0, 0);
  cp_async_wait_all();
  if (B > 1 && tid == 0) {
    mbar_init(&mbar[0], 1);
    mbar_init(&mbar[1], 1);
    mbar_init_fence();
  }
  // every block of the cluster is running, its mbarriers ready, before
  // the first remote store
  if (B > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }

  for (int j = 0; j < n; ++j) {
    const int cur = j & 1;
    if (j + 1 < n) stage_node(j + 1, cur ^ 1);
    const uint8_t* yst = ys + cur * T * P;
    const float* sc = ss + cur * st.size;
    // directed: the node's own reciprocal terms b_out / r_j and b_in / r_j
    const float bo_rj = kDirected ? v_s[j] : 0.0f;
    const float bi_rj = kDirected ? u_s[j] : 0.0f;
    for (int phase = 0; phase < 2; ++phase) {
      const int th = (T - phase + 1) / 2;  // in-phase times phase, phase+2, ..
      const int xoff = phase * H * R;  // double-buffered by step parity
      const float* e_ph = sc + st.eps + phase * T * d;

      // prior delta, accept and write-back of in-phase time m, by the lane
      // that holds its summed likelihood delta dll
      auto accept_site = [&](int m, float dll) {
        const int t = phase + 2 * m;
        const float s = sc[st.step + t];
        const float* e = e_ph + t * d;
        const float dl = kTempered ? beta_s[0] * dll : dll;
        const float ratio = (dl + pri[2 * m]) - pri[2 * m + 1];
        const bool accept = sc[st.logu + phase * T + t] < ratio;
        if (accept) {
          float* x_j = xs + (t * n + j) * d;
          for (int q = 0; q < d; ++q) x_j[q] = x_j[q] + s * e[q];
        }
        if (rank == 0) acc_c[t * n + j] = accept ? 1.0f : 0.0f;
      };

      // the prior terms lp, lc of in-phase time m, into pri (one lane);
      // both branches of t = 0 and t = T-1 are evaluated and selected, on
      // neighbours clamped into the field, so the lanes of the prior warp
      // do not diverge
      auto prior_site = [&](int m) {
        const int t = phase + 2 * m;
        const bool first = (t == 0);
        const bool last = (t == T - 1);
        const int tp = first ? t : t - 1;
        const int tn = last ? t : t + 1;
        const float s = sc[st.step + t];
        const float* e = e_ph + t * d;
        const float* x_j = xs + (t * n + j) * d;
        const float* x_prev = xs + (tp * n + j) * d;
        const float* x_next = xs + (tn * n + j) * d;
        float bp = 0.0f, bcur = 0.0f, fp = 0.0f, fcur = 0.0f;
        for (int q = 0; q < d; ++q) {
          const float xc = x_j[q];
          const float xp = xc + s * e[q];
          const float prev = x_prev[q];
          const float nxt = x_next[q];
          float dp, dc, gp, gc;
          if (kMixture) {
            const float mu_t = sc[st.mu + t * d + q];
            const float mu_nxt = sc[st.mu + tn * d + q];
            dp = first ? xp - mu_t : (xp - one_m * prev) - lam * mu_t;
            dc = first ? xc - mu_t : (xc - one_m * prev) - lam * mu_t;
            gp = (nxt - one_m * xp) - lam * mu_nxt;
            gc = (nxt - one_m * xc) - lam * mu_nxt;
          } else {
            dp = first ? xp : xp - prev;
            dc = first ? xc : xc - prev;
            gp = nxt - xp;
            gc = nxt - xc;
          }
          bp = (q == 0) ? dp * dp : bp + dp * dp;
          bcur = (q == 0) ? dc * dc : bcur + dc * dc;
          fp = (q == 0) ? gp * gp : fp + gp * gp;
          fcur = (q == 0) ? gc * gc : fcur + gc * gc;
        }
        float back_p, back_c, fwd_p, fwd_c;
        if (kMixture) {
          const float sig = sc[st.sig + t];
          const float sig_nxt = last ? 1.0f : sc[st.sig + tn];
          back_p = (-0.5f * bp) / sig;
          back_c = (-0.5f * bcur) / sig;
          fwd_p = last ? 0.0f : (-0.5f * fp) / sig_nxt;
          fwd_c = last ? 0.0f : (-0.5f * fcur) / sig_nxt;
        } else {
          const float var0 = first ? tau_sq : sigma_sq;
          back_p = (-0.5f * bp) / var0;
          back_c = (-0.5f * bcur) / var0;
          fwd_p = last ? 0.0f : (-0.5f * fp) / sigma_sq;
          fwd_c = last ? 0.0f : (-0.5f * fcur) / sigma_sq;
        }
        pri[2 * m] = back_p + fwd_p;
        pri[2 * m + 1] = back_c + fwd_c;
      };

      // 1. the prior warp evaluates the prior terms of every in-phase
      // time, one lane each, while the groups evaluate the partners; a
      // lane's register levels go to the exchange buffer (every block's,
      // in a cluster)
      if (warp == pw) {
        // the peers' stores this step completes on this half's mbarrier
        if (B > 1 && lane == 0)
          mbar_expect(&mbar[phase], 4 * (B - 1) * 32 * W * th);
        for (int m = lane; m < th; m += 32) prior_site(m);
        for (int gg = 0; gg < G && gg < th; ++gg)
          named_arrive(1 + gg, 32 * W + 32);
      } else {
        for (int m = g; m < th; m += G) {
          const int t = phase + 2 * m;
          const float s = sc[st.step + t];
          const float* e = e_ph + t * d;
          const float* x_t = xs + t * n * d;
          const uint8_t* y_row = yst + t * P;
          const float v =
              d == 2 ? lane_levels<kDirected, 2>(x_t, y_row, e, s, j, n, d,
                                                 r, R, P, bc, both, u_s, v_s,
                                                 bo_rj, bi_rj)
                     : lane_levels<kDirected, 0>(x_t, y_row, e, s, j, n, d,
                                                 r, R, P, bc, both, u_s, v_s,
                                                 bo_rj, bi_rj);
          float* slot = xbuf + xoff + m * R + r;
          *slot = v;
          for (int q = 0; q < B; ++q)
            if (q != rank) st_async(slot, v, &mbar[phase], q);
        }
      }

      // 2. the group's warps and the prior warp meet at the group's named
      // barrier (a cluster's peer values complete on this half's mbarrier,
      // phase j & 1: no barrier across the cluster); then the exchange
      // levels, the shuffles and the accept, one warp per time
      if (warp != pw && g < th) {
        if (w == 0) {
          named_sync(1 + g, 32 * W + 32);
          if (B > 1) mbar_wait(&mbar[phase], j & 1);
        } else {
          named_arrive(1 + g, 32 * W + 32);
        }
      }
      if (warp != pw && w == 0) {
        for (int m = g; m < th; m += G) {
          const float dll =
              shuffle_levels(exchange_levels(xbuf + xoff + m * R, R, lane));
          if (lane == 0) accept_site(m, dll);
        }
      }
      // node j+1's inputs have landed before node j+1 starts
      if (phase == 1) cp_async_wait_all();
      __syncthreads();
    }
  }

  if (rank == 0) {
    float* out_c = X_out + (size_t)c * field;
    for (int k = tid; k < field; k += nthr) out_c[k] = xs[k];
  }
  // no block leaves while a peer may still address its shared memory
  if (B > 1) cluster.sync();
}

int min3(int a, int b, int c) {
  return a < b ? (a < c ? a : c) : (b < c ? b : c);
}

}  // namespace

// Shared memory of one block: two mbarriers, the (2, T, P) staged
// adjacency rows, the (T, n, d) field, the directed (n,) u and v rows, the
// (2, ceil(T/2), R) exchange buffer, the (2, 4T + 3Td) staged scalars, the
// (ceil(T/2), 2) prior terms and the temperature, R = 32 * warps * cluster.
// A cluster launch asks for at least half an SM's shared memory (see
// configure).
extern "C" int node_scan_smem_bytes(int T, int n, int d, int P, int R,
                                    int directed) {
  const int H = (T + 1) / 2;
  return 4 * (4 + T * P / 2 + T * n * d + (directed ? 2 * n : 0)
              + 2 * H * R + 2 * (4 * T + 3 * T * d) + 2 * H + 1);
}

// Threads of one block: ceil(T/2) groups of `warps` warps and the prior
// warp, at most kMaxThreads threads and kMaxGroups groups (which then
// loop over the times).
extern "C" int node_scan_threads(int T, int warps) {
  return 32 * (warps * min3((T + 1) / 2, (kMaxThreads - 32) / (32 * warps),
                            kMaxGroups)
               + 1);
}

// ---- launch --------------------------------------------------------------

namespace {

using NodeScanKernel = void (*)(
    const float*, const uint8_t*, const float*, const float*, const float*,
    const float*, const float*, const float*, const float*, const float*,
    const float*, float*, float*, int, int, int, int, int, int, float, float);

template <bool kDirected, bool kMixture>
NodeScanKernel pick_tempered(bool tempered) {
  return tempered ? node_scan_kernel<kDirected, kMixture, true>
                  : node_scan_kernel<kDirected, kMixture, false>;
}

constexpr int kMaxDevices = 64;

// The instantiation, its launch configuration and, once per device,
// instantiation and larger shared-memory size, its opt-in to that size.
// Returns the CUDA error of the opt-in, or of arguments the kernel does
// not take.
cudaError_t configure(int C, int T, int n, int d, int P, int warps,
                      int cluster, int directed, int mixture, bool tempered,
                      void* stream, NodeScanKernel* kernel,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const int R = 32 * warps * cluster;
  if ((warps != 1 && warps != 2 && warps != 4)
      || (cluster != 1 && cluster != 2 && cluster != 4) || P % R != 0
      || P / R > (kChunk << (kChunkLevels - 1)) || P < 32
      || (P & (P - 1)) != 0)
    return cudaErrorInvalidValue;
  const int smem = node_scan_smem_bytes(T, n, d, P, R, directed);
  *kernel = directed ? (mixture ? pick_tempered<true, true>(tempered)
                                : pick_tempered<true, false>(tempered))
                     : (mixture ? pick_tempered<false, true>(tempered)
                                : pick_tempered<false, false>(tempered));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // a cluster's blocks each take an SM of their own: they ask for more
  // than half of an SM's shared memory
  int smem_launch = smem;
  if (cluster > 1) {
    int per_sm = 0;
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err != cudaSuccess) return err;
    if (smem_launch < per_sm / 2) smem_launch = per_sm / 2;
  }
  // the opt-in holds for the current device only: one record per device
  // (devices past kMaxDevices opt in at every launch)
  static int opted_in[kMaxDevices][8] = {};
  int unrecorded = 0;
  int& opted = dev < kMaxDevices
      ? opted_in[dev][4 * (directed != 0) + 2 * (mixture != 0) + tempered]
      : unrecorded;
  if (smem_launch > opted) {
    err = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_launch);
    if (err != cudaSuccess) return err;
    opted = smem_launch;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C * cluster);
  cfg->blockDim = dim3(node_scan_threads(T, warps));
  cfg->dynamicSmemBytes = smem_launch;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = cluster > 1 ? 1 : 0;
  return cudaSuccess;
}

}  // namespace

// How many clusters of `cluster` blocks the card runs at once (for
// cluster 1, blocks), or minus a CUDA error code.
extern "C" int node_scan_max_clusters(int T, int n, int d, int P, int warps,
                                      int cluster, int directed, int mixture,
                                      int tempered) {
  NodeScanKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(cluster, T, n, d, P, warps, cluster, directed,
                              mixture, tempered != 0, nullptr, &kernel, &cfg,
                              &attr);
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  if (cluster > 1) {
    err = cudaOccupancyMaxActiveClusters(&count, (void*)kernel, &cfg);
  } else {
    int per_sm = 0, sms = 0, dev = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, (int)cfg.blockDim.x, cfg.dynamicSmemBytes);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    count = per_sm * sms;
  }
  return err != cudaSuccess ? -(int)err : count;
}

// Launch on `stream`; returns the CUDA error code (0 on success).
// Y: (T, n, P) uint8, rows padded to P bytes, 16-byte aligned; P: the
// partner axis padded to a power of two >= 32.  directed != 0 selects the
// social-radii likelihood (b (C, 2), radii (C, n), Y packed Y + 2 Y^T);
// otherwise b is (C,) and radii may be null.  mixture != 0 selects the
// mixture prior (mu_z, sig_z, lmbda); otherwise the random-walk prior with
// tau_sq and sigma_sq, and mu_z, sig_z, lmbda may be null.  temper: (C,)
// inverse temperatures, or null for the untempered scan.  warps (1, 2, 4)
// per in-phase time and cluster (1, 2, 4) blocks per chain, with
// 32 * warps * cluster dividing P; a cluster the card refuses returns its
// error.
extern "C" int node_scan_launch(
    const float* X, const uint8_t* Y, const float* step, const float* eps,
    const float* log_u, const float* mu_z, const float* sig_z,
    const float* b, const float* radii, const float* lmbda,
    const float* temper, float* X_out, float* acc, int C, int T, int n,
    int d, int P, int warps, int cluster, int directed, int mixture,
    float tau_sq, float sigma_sq, void* stream) {
  NodeScanKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(C, T, n, d, P, warps, cluster, directed,
                              mixture, temper != nullptr, stream, &kernel,
                              &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, X, Y, step, eps, log_u, mu_z, sig_z,
                           b, radii, lmbda, temper, X_out, acc, T, n, d, P,
                           warps, cluster, tau_sq, sigma_sq);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
