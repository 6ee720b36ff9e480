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
// four softplus directed; ~165 SASS instructions a term undirected and
// ~263 directed on the compiled loop's path with -fmad=false and the
// accurate expf/log1pf, scripts/node_scan_sass.py, each term one long
// dependent chain), so once the fixed latency is gone the next bounds are
// one SM's issue rate for those terms (~2,500 terms a step at the north
// star) and the latency of one term's chain.  The design takes on both:
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
// 4. Split-field mode (template kSplit), for fields past shared memory
//    (n > 2048 at T = 10, d = 2: the (T, n, d) field and two staged rows
//    of P bytes a time outgrow a block's 227 KB).  There a step evaluates
//    thousands of partner terms, so it is bound by the issue rate of the
//    SMs it runs on: a chain spreads over a cluster of B blocks (1 to 16;
//    16 is a non-portable cluster, which the H100 runs), as many as the
//    waves of its chains make worth it (ops/node_scan.py::split_layout).
//    Block `rank` owns the partners i = rank (mod B).  The tree's levels
//    h >= B pair elements of one residue mod B, so each block runs them
//    itself, over its own P / B partners, as the resident mode runs a
//    block's tree (lane rl the partners rank + B (rl + 32 W k), register,
//    exchange and shuffle levels); it sends its one partial a time to each
//    peer (st.async, as above: (B - 1) ceil(T/2) stores a step, whatever
//    the lanes), and every block adds the B partials with the last log2 B
//    levels in the same order (shuffles), decides the accepts itself and
//    moves its copy of the node.  The block's partners are every B-th
//    column of a row and every B-th position of the field, so both are
//    kept residue-major: partner i = rank + B m at slot rank P / B + m.
//    Block rank's partners are then one contiguous run of P / B slots, and
//    the lanes of a warp read adjacent slots, as in the resident mode.  The
//    wrapper passes the adjacency so permuted (ops/node_scan.py::
//    residue_major, built once a network and cluster size) and a scratch
//    field (C, T, P, d), into which each block copies its share of X_in at
//    the start, zeros at padded partners, and from which it writes its
//    share to X_out at the end.  Every block reaches the same accept
//    decisions, so the owner of node j's residue writes its moves into the
//    scratch after each accept and no block ever reads another's writes: a
//    block barrier orders them.  The phase steps are pipelined: step
//    s = 2 j + phase reads positions of its parity, which only step s - 2
//    moved, so each group's reducing warp finishes step s - 1 (the
//    exchange, the prior terms while the partials are in flight, the
//    accepts) during step s, while the other warps already evaluate step
//    s's partners and keep the SM issuing; one block barrier ends a step
//    (the prior warp only announces the partials).  The node's own positions
//    (T, d), which its two phases read and move, are staged from X_in with
//    its other inputs (a node is at its input values until its step) and
//    updated in shared memory by every block.  A block stages only its run
//    of the two adjacency rows (2 T P / B bytes) and, directed, its run of
//    the u and v rows; the node's own b_out / r_j and b_in / r_j are
//    divided from its staged radius.  The field is read with ordinary
//    loads (no read-only cache path: the kernel writes it).  The terms, the
//    tree and the decisions are the resident mode's, so both give the same
//    bits.
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
//
// Per-chain network (missing-dyad resampling, mcmc/sweeps.py): chain c
// reads its adjacency at Y + c * y_chain, y_chain = T n P bytes when every
// chain has its own (C, T, n, P) network, 0 when all share one (T, n, P).
// Only the base of the row copies moves, so a shared launch is the launch
// it was, and P >= 32 keeps each chain's rows on 16-byte boundaries.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// threads of one block (split-field: fewer, so that a thread may hold up to
// 96 registers), and named barriers (ids 1..15) for the groups
constexpr int kMaxThreads = 768;
constexpr int kMaxSplitThreads = 672;
constexpr int kMaxGroups = 15;
// the split-field mode's finishing warp reduces up to kBatch in-phase times
// at once (their shuffles independent)
constexpr int kBatch = 8;
// a lane evaluates up to kChunk partners at once; the pairwise stack of
// its chunks: up to 2^8 chunks, 2^10 partners a lane (P <= 32768)
constexpr int kChunk = 4;
constexpr int kChunkLevels = 9;
// exchange values a reducing lane reads: R / 32 <= 16 (R <= 512; the
// split-field mode's reducing lane reads W <= 4)
constexpr int kMaxExchange = 16;
// blocks of a cluster: at most 8, the portable cluster size; the
// split-field mode also takes 16, a non-portable size
constexpr int kMaxCluster = 8;
constexpr int kMaxSplitCluster = 16;

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

// The levels B/2 .. 1 of the split-field mode's B partials of one time,
// p[0 .. B): p[i] + p[i + h] level by level, as _tree_sum adds.
template <int kN>
__device__ __forceinline__ float partial_tree(const float* p) {
  float a[kN];
#pragma unroll
  for (int q = 0; q < kN; ++q) a[q] = p[q];
  if constexpr (kN > 1) halve_levels<kN / 2>(a);
  return a[0];
}

__device__ __forceinline__ float cluster_levels(const float* p, int B) {
  switch (B) {
    case 1:
      return p[0];
    case 2:
      return partial_tree<2>(p);
    case 4:
      return partial_tree<4>(p);
    case 8:
      return partial_tree<8>(p);
    default:
      return partial_tree<kMaxSplitCluster>(p);
  }
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
// position; li indexes the partner's u and v values.
template <bool kDirected>
__device__ __forceinline__ float partner_delta(
    float d2p, float d2c, uint8_t yb, int i, int li, int j, float bc,
    float both, const float* __restrict__ u_s, const float* __restrict__ v_s,
    float bo_rj, float bi_rj) {
  float llp, llc;
  if (kDirected) {
    const float y = (float)(yb & 1);    // edge j -> i
    const float yt = (float)(yb >> 1);  // edge i -> j
    const float p_out = u_s[li] + bo_rj;
    const float p_in = v_s[li] + bi_rj;
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

// The likelihood delta of partner i at time t: its position in the
// field x_t (shared memory, or in the split-field mode the block's run of
// the scratch field: no __restrict__, so never the read-only cache path),
// its adjacency byte y_row[li], the node at xn (its position at t), xc
// (current) and xp (proposal).  D = 2 keeps the node's coordinates in
// registers; D = 0 reads them for any d (then xc, xp are unused).  The
// split-field mode reads the position at the partner's slot li too.
template <bool kDirected, bool kSplit, int D>
__device__ __forceinline__ float partner_term(
    const float* x_t, const uint8_t* __restrict__ y_row,
    const float* __restrict__ xn, const float* __restrict__ e, float s,
    const float* xc, const float* xp, int i, int li, int j, int n, int d,
    float bc, float both, const float* __restrict__ u_s,
    const float* __restrict__ v_s, float bo_rj, float bi_rj) {
  float d2p = 0.0f;
  float d2c = 0.0f;
  if constexpr (D == 2) {
    float2 xi;
    if constexpr (kSplit) {
      xi = reinterpret_cast<const float2*>(x_t)[li];
    } else {
      xi = reinterpret_cast<const float2*>(x_t)[i];
    }
    const float dp0 = xi.x - xp[0], dc0 = xi.x - xc[0];
    const float dp1 = xi.y - xp[1], dc1 = xi.y - xc[1];
    d2p = dp0 * dp0;
    d2c = dc0 * dc0;
    d2p = d2p + dp1 * dp1;
    d2c = d2c + dc1 * dc1;
  } else {
    for (int q = 0; q < d; ++q) {
      const float xcq = xn[q];
      const float xpq = xcq + s * e[q];
      const float xiq = x_t[(kSplit ? li : i) * d + q];
      const float dp = xiq - xpq;
      const float dc = xiq - xcq;
      d2p = (q == 0) ? dp * dp : d2p + dp * dp;
      d2c = (q == 0) ? dc * dc : d2c + dc * dc;
    }
  }
  return partner_delta<kDirected>(d2p, d2c, y_row[li], i, li, j, bc, both,
                                  u_s, v_s, bo_rj, bi_rj);
}

// The register levels of one lane: the pairwise sum of its partners
// i = r + R * k (k < nv = P / R; the padding i >= n contributes 0) at time
// t.  Its partners go in bit-reversed k order, kCh at once (independent
// terms, evaluated side by side; a padded slot evaluates a real partner,
// or in the split-field mode the zeros of its slot, and is zeroed), each
// chunk's adjacent-pairs tree pushed as one subtree.  Resident: partner i's
// position, adjacency byte (and directed u, v values) sit at i.  Split-
// field: partner i = rank + B (rl + Rl k) sits at slot rl + Rl k of the
// block's residue-major run (rl the lane's residue in the block, Rl its
// lanes of one time).
template <bool kDirected, bool kSplit, int D, int kCh>
__device__ __forceinline__ float lane_chunks(
    const float* x_t, const uint8_t* __restrict__ y_row,
    const float* __restrict__ xn, const float* __restrict__ e, float s,
    const float* xc, const float* xp, int j, int n, int d, int r, int R,
    int rl, int Rl, int nv, float bc, float both,
    const float* __restrict__ u_s, const float* __restrict__ v_s,
    float bo_rj, float bi_rj) {
  const int lg = __ffs(nv) - 1;
  float stk[kChunkLevels];
  float v = 0.0f;
  for (int kk = 0; kk < nv; kk += kCh) {
    float tm[kCh];
    // split-field: the chunk's k as the first's plus a constant multiple
    // of nv / kCh (kk is a multiple of kCh: its bits and u's reverse apart)
    const int k0 = kSplit ? bit_reverse(kk, lg) : 0;
#pragma unroll
    for (int u = 0; u < kCh; ++u) {
      const int k = kSplit ? k0 + (kCh == 4 ? ((u & 1) << 1) | (u >> 1) : u)
                                      * (nv / kCh)
                           : bit_reverse(kk + u, lg);
      const int i = r + R * k;
      const int ie = kSplit ? i : (i < n ? i : j);
      const float term = partner_term<kDirected, kSplit, D>(
          x_t, y_row, xn, e, s, xc, xp, ie, kSplit ? rl + Rl * k : ie, j, n,
          d, bc, both, u_s, v_s, bo_rj, bi_rj);
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

template <bool kDirected, bool kSplit, int D>
__device__ __forceinline__ float lane_levels(
    const float* x_t, const uint8_t* __restrict__ y_row,
    const float* __restrict__ xn, const float* __restrict__ e, float s, int j,
    int n, int d, int r, int R, int rl, int Rl, int P, float bc, float both,
    const float* __restrict__ u_s, const float* __restrict__ v_s, float bo_rj,
    float bi_rj) {
  const int nv = P / R;
  float xc[2] = {0.0f, 0.0f}, xp[2] = {0.0f, 0.0f};
  if constexpr (D == 2) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      xc[q] = xn[q];
      xp[q] = xc[q] + s * e[q];
    }
  }
  if (nv >= kChunk)
    return lane_chunks<kDirected, kSplit, D, kChunk>(
        x_t, y_row, xn, e, s, xc, xp, j, n, d, r, R, rl, Rl, nv, bc, both,
        u_s, v_s, bo_rj, bi_rj);
  if (nv == 2)
    return lane_chunks<kDirected, kSplit, D, 2>(
        x_t, y_row, xn, e, s, xc, xp, j, n, d, r, R, rl, Rl, nv, bc, both,
        u_s, v_s, bo_rj, bi_rj);
  return lane_chunks<kDirected, kSplit, D, 1>(
      x_t, y_row, xn, e, s, xc, xp, j, n, d, r, R, rl, Rl, nv, bc, both, u_s,
      v_s, bo_rj, bi_rj);
}

// One 4- or 16-byte copy of a node's inputs into shared memory: node jn
// reads src + jn * stride; dst is its byte offset in the first staging
// half, half the byte distance to the second.
struct Copy {
  const char* src;
  int stride, dst, half, bytes;
};

// Per-buffer layout of the staged per-node scalars (floats); the
// split-field mode adds the node's positions (T, d) and its radius.
struct Stage {
  int step, logu, eps, mu, sig, xj, rad, size;
  __device__ __forceinline__ Stage(int T, int d, bool split)
      : step(0), logu(T), eps(3 * T), mu(3 * T + 2 * T * d),
        sig(3 * T + 3 * T * d), xj(4 * T + 3 * T * d),
        rad(4 * T + 4 * T * d),
        size(4 * T + 3 * T * d + (split ? T * d + 1 : 0)) {}
};

// b: (C,) intercepts, or (C, 2) = (b_in, b_out) when kDirected; radii:
// (C, n) when kDirected, unused otherwise; Y: the 0/1 adjacency, or the
// packed Y + 2 Y^T when kDirected, its rows padded to P bytes (T, n, P),
// chain c's at Y + c * y_chain (0: one network for all chains); in the
// split-field mode with each row residue-major (partner i = r + B m at
// r P / B + m).
// mu_z, sig_z, lmbda: the mixture prior's per-site cluster means and
// variances and per-chain lambda (kMixture); tau_sq, sigma_sq: the
// random-walk prior's variances (!kMixture).  temper: (C,) per-chain
// inverse temperatures (kTempered), unused otherwise.  W warps per
// in-phase time, B blocks (a cluster) per chain.  kSplit: the
// split-field mode (Xs, (C, T, P, d) scratch, holds the field during the
// scan, residue-major; unused otherwise).
template <bool kDirected, bool kMixture, bool kTempered, bool kSplit>
__global__ void __launch_bounds__(kSplit ? kMaxSplitThreads : kMaxThreads)
    node_scan_kernel(
    const float* __restrict__ X_in, const uint8_t* __restrict__ Y,
    long long y_chain, const float* __restrict__ step,
    const float* __restrict__ eps, const float* __restrict__ log_u,
    const float* __restrict__ mu_z, const float* __restrict__ sig_z,
    const float* __restrict__ b,
    const float* __restrict__ radii, const float* __restrict__ lmbda,
    const float* __restrict__ temper, float* X_out,
    float* __restrict__ acc, float* Xs, int T, int n, int d, int P, int W,
    int B, float tau_sq, float sigma_sq) {
  extern __shared__ __align__(16) float smem[];
  const int field = T * n * d;
  const int H = (T + 1) / 2;  // in-phase times, at most
  const int R = 32 * W * B;   // lanes that share one time's partners
  const int Rl = 32 * W;      // a block's lanes of one time
  // a block's partner slots of one time: its staged row bytes and, when
  // directed, its u and v values (resident: the whole row)
  const int Pb = kSplit ? P / B : P;
  const int nu = kSplit ? Pb : n;
  // the lane values of one time in the exchange buffer: the cluster's
  // (resident) or the block's (split-field: its blocks exchange partials)
  const int Rx = kSplit ? Rl : R;
  const Stage st(T, d, kSplit);
  // (2,) mbarriers of the exchange halves, then (2, T, Pb) staged rows
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ys = reinterpret_cast<uint8_t*>(smem + 4);
  float* xs = smem + 4 + T * Pb / 2;                // (T, n, d) positions
  float* u_s = xs + (kSplit ? 0 : field);          // directed: b_in / r
  float* v_s = u_s + nu;                           // directed: b_out / r
  float* xbuf = u_s + (kDirected ? 2 * nu : 0);    // (2, H, Rx)
  float* pbuf = xbuf + 2 * H * Rx;                 // split: (2, H, B)
  float* ss = pbuf + (kSplit ? 2 * H * B : 0);     // (2, st.size) scalars
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
  const int rl = 32 * w + lane;   // this lane's residue within the block
  // this lane's residue: resident, the block's run of Rl residues from
  // Rl rank; split-field, every B-th residue from rank
  const int r = kSplit ? rank + B * rl : Rl * rank + rl;
  // split-field: the block's run of the residue-major partner axis (its
  // partners i = rank + B m at slots base + m, m < Pb)
  const int base = kSplit ? rank * Pb : 0;
  // the partner of the block's slot m (m < Pb)
  auto slot_partner = [&](int m) { return kSplit ? rank + B * m : m; };

  const float* X_c = X_in + (size_t)c * field;
  float* Xo_c = X_out + (size_t)c * field;
  // split-field: the chain's scratch field (T, P, d)
  float* Xf_c = kSplit ? Xs + (size_t)c * T * P * d : nullptr;
  const uint8_t* Y_c = Y + (size_t)c * y_chain;
  const float* radii_c = kDirected ? radii + (size_t)c * n : nullptr;
  if constexpr (kSplit) {
    // this block's partners' positions at every time, into its run of the
    // scratch (a padded partner's: zeros)
    for (int k = tid; k < T * Pb; k += nthr) {
      const int t = k / Pb;
      const int m = k - t * Pb;
      const int i = slot_partner(m);
      for (int q = 0; q < d; ++q)
        Xf_c[((size_t)t * P + base + m) * d + q] =
            i < n ? X_c[(t * n + i) * d + q] : 0.0f;
    }
  } else {
    for (int k = tid; k < field; k += nthr) xs[k] = X_c[k];
  }

  const float bc = kDirected ? 0.0f : b[c];
  const float b_in = kDirected ? b[2 * c] : 0.0f;
  const float b_out = kDirected ? b[2 * c + 1] : 0.0f;
  const float both = b_in + b_out;
  if (kDirected) {
    for (int k = tid; k < nu; k += nthr) {
      const int i = slot_partner(k);
      if (kSplit && i >= n) {
        u_s[k] = 0.0f;
        v_s[k] = 0.0f;
      } else {
        const float rk = radii_c[i];
        u_s[k] = b_in / rk;
        v_s[k] = b_out / rk;
      }
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
  // of shared memory; each thread keeps its first copy's description.  A
  // row is copied as its block's share: the whole row, or in the
  // split-field mode the block's run of Pb bytes.
  const int row_chunks = Pb / 16;
  const int n_mu = kMixture ? T * d : 0;
  const int n_sig = kMixture ? T : 0;
  const int n_copies = T * row_chunks + 3 * T + 2 * T * d + n_mu + n_sig
                       + (kSplit ? T * d + (kDirected ? 1 : 0) : 0);
  const int ys_half = T * Pb;          // bytes
  const int ss_half = 4 * st.size;     // bytes
  const int ys_at = 4 * 4;             // bytes: after the mbarriers
  const int ss_at = 4 * (ss - smem);   // bytes
  auto copy_of = [&](int k) {
    Copy cp;
    if (k < T * row_chunks) {
      const int t = k / row_chunks;
      const int q = k - t * row_chunks;  // 16-byte piece of the share
      const int src = base + 16 * q, dst = 16 * q;
      cp = {reinterpret_cast<const char*>(Y_c + (size_t)t * n * P + src), P,
            ys_at + t * Pb + dst, ys_half, 16};
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
    } else if ((k -= 2 * T * d) < n_mu) {
      const int t = k / d;
      src = muz_c + (size_t)t * n * d + (k - t * d), stride = d;
      at = st.mu + k;
    } else if ((k -= n_mu) < n_sig) {
      src = sigz_c + (size_t)k * n, stride = 1, at = st.sig + k;
    } else if ((k -= n_sig) < T * d) {
      const int t = k / d;
      src = X_c + (size_t)t * n * d + (k - t * d), stride = d;
      at = st.xj + k;
    } else {
      src = radii_c, stride = 1, at = st.rad;
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

  if constexpr (kSplit) {
    // the block's run of the chain's scratch field, floats of one time;
    // node j's staged scalars, and its own positions (staged with them):
    // time t at node_at(j) + t * d
    float* xf = Xf_c + (size_t)base * d;
    const int fts = P * d;
    const int xts = d;
    auto scalars = [&](int j) { return ss + (j & 1) * st.size; };
    auto node_at = [&](int j) { return scalars(j) + st.xj; };
    // directed: node j's own reciprocal terms b_out / r_j and b_in / r_j,
    // divided from its staged radius
    auto node_terms = [&](int j, float& bo_rj, float& bi_rj) {
      bo_rj = b_out / scalars(j)[st.rad];
      bi_rj = b_in / scalars(j)[st.rad];
    };

    // prior delta, accept and write-back of in-phase time m of node j's
    // phase, by the lane that holds its summed likelihood delta dll; the
    // block that owns node j's residue writes its moves at the node's slot
    // of the scratch
    auto accept_site = [&](int j, int phase, int m, float dll) {
      const float* sc = scalars(j);
      const int t = phase + 2 * m;
      const float s = sc[st.step + t];
      const float* e = sc + st.eps + phase * T * d + t * d;
      const float dl = kTempered ? beta_s[0] * dll : dll;
      const float ratio = (dl + pri[2 * m]) - pri[2 * m + 1];
      const bool accept = sc[st.logu + phase * T + t] < ratio;
      if (accept) {
        float* x_j = node_at(j) + t * xts;
        for (int q = 0; q < d; ++q) x_j[q] = x_j[q] + s * e[q];
        if ((j & (B - 1)) == rank)
          for (int q = 0; q < d; ++q)
            Xf_c[((size_t)t * P + base + (j >> (__ffs(B) - 1))) * d + q] =
                x_j[q];
      }
      if (rank == 0) acc_c[t * n + j] = accept ? 1.0f : 0.0f;
    };

    // the prior terms lp, lc of in-phase time m of node j's phase, into pri
    // (one lane), as the resident loop's prior_site computes them
    auto prior_site = [&](int j, int phase, int m) {
      const float* sc = scalars(j);
      const float* xnode = node_at(j);
      const int t = phase + 2 * m;
      const bool first = (t == 0);
      const bool last = (t == T - 1);
      const int tp = first ? t : t - 1;
      const int tn = last ? t : t + 1;
      const float s = sc[st.step + t];
      const float* e = sc + st.eps + phase * T * d + t * d;
      const float* x_j = xnode + t * xts;
      const float* x_prev = xnode + tp * xts;
      const float* x_next = xnode + tn * xts;
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

    // this lane's register levels of in-phase time m of node j's phase
    auto lane_value = [&](int j, int phase, int m, float bo_rj, float bi_rj) {
      const float* sc = scalars(j);
      const int t = phase + 2 * m;
      const float s = sc[st.step + t];
      const float* e = sc + st.eps + phase * T * d + t * d;
      const float* x_t = xf + t * fts;
      const uint8_t* y_row = ys + (j & 1) * T * Pb + t * Pb;
      const float* xn = node_at(j) + t * xts;
      return d == 2 ? lane_levels<kDirected, kSplit, 2>(
                          x_t, y_row, xn, e, s, j, n, d, r, R, rl, Rl, P, bc,
                          both, u_s, v_s, bo_rj, bi_rj)
                    : lane_levels<kDirected, kSplit, 0>(
                          x_t, y_row, xn, e, s, j, n, d, r, R, rl, Rl, P, bc,
                          both, u_s, v_s, bo_rj, bi_rj);
    };

    // split-field: a pipeline of phase steps s = 2 j + phase.  A step's
    // partner terms read the positions of its parity, which only the
    // accepts of step s - 2 moved, so while every group evaluates step s's
    // partners the prior warp finishes step s - 1: its block's levels
    // Rl/2 .. 1 over the lanes of every in-phase time (up to kBatch times
    // at once) and each partial into every block's partials buffer
    // (2, H, B), slot rank, one lane a peer; the prior terms while the
    // partials are in flight; then, lane m for time m, the levels
    // B/2 .. 1 over the B partials and the accept.  No warp is late to its
    // partners, so the SM keeps issuing, and one block barrier ends a
    // step.  Node j + 1's inputs are staged during step 2 j + 1, once step
    // 2 j - 1 has read node j - 1's half of the staging buffers, and have
    // landed at its end.
    auto finish_step = [&](int s) {
      const int j = s >> 1, phase = s & 1;
      const int th = (T - phase + 1) / 2;
      const float* xb = xbuf + phase * H * Rl;
      float* pb = pbuf + phase * H * B;
      for (int m0 = 0; m0 < th; m0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          v[u] = m0 + u < th ? exchange_levels(xb + (m0 + u) * Rl, Rl, lane)
                             : 0.0f;
#pragma unroll
        for (int h = 16; h >= 1; h >>= 1)
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (m0 + u < th)
              v[u] = v[u] + __shfl_down_sync(0xffffffffu, v[u], h);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int m = m0 + u;
          if (m >= th) break;
          const float part = __shfl_sync(0xffffffffu, v[u], 0);
          if (lane == rank) {
            pb[m * B + rank] = part;
          } else if (lane < B) {
            st_async(pb + m * B + rank, part, &mbar[phase], lane);
          }
        }
      }
      for (int m = lane; m < th; m += 32) prior_site(j, phase, m);
      __syncwarp();
      if (B > 1) mbar_wait(&mbar[phase], j & 1);
      for (int m = lane; m < th; m += 32)
        accept_site(j, phase, m, cluster_levels(pb + m * B, B));
    };
    for (int s = 0; s <= 2 * n; ++s) {
      const int j = s >> 1, phase = s & 1;
      const int th = (T - phase + 1) / 2;
      if (s < 2 * n && phase == 1 && j + 1 < n)
        stage_node(j + 1, (j + 1) & 1);
      if (warp == pw) {
        // the peers' partials of this step complete on this half's
        // mbarrier
        if (s < 2 * n && B > 1 && lane == 0)
          mbar_expect(&mbar[phase], 4 * (B - 1) * th);
        if (s > 0) finish_step(s - 1);
      } else if (s < 2 * n) {
        float bo_rj = 0.0f, bi_rj = 0.0f;
        if (kDirected) node_terms(j, bo_rj, bi_rj);
        for (int m = g; m < th; m += G)
          xbuf[phase * H * Rl + m * Rl + rl] =
              lane_value(j, phase, m, bo_rj, bi_rj);
      }
      // node j+1's inputs have landed before node j+1 starts
      if (s < 2 * n && phase == 1) cp_async_wait_all();
      __syncthreads();
    }
  }
  // resident: the field in shared memory, one phase step after another
  // (the split-field instantiations ran their loop above)
  float* xf = xs;
  for (int j = 0; j < (kSplit ? 0 : n); ++j) {
    const int cur = j & 1;
    if (j + 1 < n) stage_node(j + 1, cur ^ 1);
    const uint8_t* yst = ys + cur * T * Pb;
    float* sc = ss + cur * st.size;
    // the node's own positions: time t at xnode + t * xts
    float* xnode = xs + j * d;
    const int xts = n * d;
    // directed: the node's own reciprocal terms b_out / r_j and b_in / r_j
    float bo_rj = 0.0f, bi_rj = 0.0f;
    if (kDirected) {
      bo_rj = v_s[j];
      bi_rj = u_s[j];
    }
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
          float* x_j = xnode + t * xts;
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
        const float* x_j = xnode + t * xts;
        const float* x_prev = xnode + tp * xts;
        const float* x_next = xnode + tn * xts;
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
          const float* x_t = xf + t * n * d;
          const uint8_t* y_row = yst + t * Pb;
          const float* xn = xnode + t * xts;
          const float v =
              d == 2 ? lane_levels<kDirected, kSplit, 2>(
                           x_t, y_row, xn, e, s, j, n, d, r, R, rl, Rl, P,
                           bc, both, u_s, v_s, bo_rj, bi_rj)
                     : lane_levels<kDirected, kSplit, 0>(
                           x_t, y_row, xn, e, s, j, n, d, r, R, rl, Rl, P,
                           bc, both, u_s, v_s, bo_rj, bi_rj);
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

  // resident: the cluster's block 0 writes the field; split-field: each
  // block its partners' positions, from its run of the scratch
  if constexpr (kSplit) {
    for (int k = tid; k < T * Pb; k += nthr) {
      const int t = k / Pb;
      const int m = k - t * Pb;
      const int i = slot_partner(m);
      if (i < n)
        for (int q = 0; q < d; ++q)
          Xo_c[(t * n + i) * d + q] =
              Xf_c[((size_t)t * P + base + m) * d + q];
    }
  } else if (rank == 0) {
    for (int k = tid; k < field; k += nthr) Xo_c[k] = xs[k];
  }
  // no block leaves while a peer may still address its shared memory
  if (B > 1) cluster.sync();
}

int min3(int a, int b, int c) {
  return a < b ? (a < c ? a : c) : (b < c ? b : c);
}

}  // namespace

// Shared memory of one block: two mbarriers, the (2, T, Pb) staged
// adjacency rows, the (T, n, d) field (resident only), the directed u and
// v rows (n each; split-field: the block's Pb slots), the
// (2, ceil(T/2), R) exchange buffer (split-field: (2, ceil(T/2), R /
// cluster), and the (2, ceil(T/2), cluster) partials), the (2, 4T + 3Td)
// staged scalars (split-field: and the node's (T, d) positions and
// radius), the (ceil(T/2), 2) prior terms and the temperature;
// R = 32 * warps * cluster, Pb = P (resident) or P / cluster
// (split-field).  A cluster launch asks for at least half an SM's shared
// memory (see configure).
extern "C" int node_scan_smem_bytes(int T, int n, int d, int P, int R,
                                    int directed, int cluster, int split) {
  const int H = (T + 1) / 2;
  const int Pb = split ? P / cluster : P;
  const int stage = 4 * T + 3 * T * d + (split ? T * d + 1 : 0);
  const int exchange = split ? R / cluster + cluster : R;
  return 4 * (4 + T * Pb / 2 + (split ? 0 : T * n * d)
              + (directed ? 2 * (split ? Pb : n) : 0) + 2 * H * exchange
              + 2 * stage + 2 * H + 1);
}

// Threads of one block: ceil(T/2) groups of `warps` warps and the prior
// warp, at most kMaxThreads threads (split-field: kMaxSplitThreads) and
// kMaxGroups groups (which then loop over the times).
extern "C" int node_scan_threads(int T, int warps, int split) {
  const int most = split ? kMaxSplitThreads : kMaxThreads;
  return 32 * (warps * min3((T + 1) / 2, (most - 32) / (32 * warps),
                            kMaxGroups)
               + 1);
}

// ---- launch --------------------------------------------------------------

namespace {

using NodeScanKernel = void (*)(
    const float*, const uint8_t*, long long, const float*, const float*,
    const float*, const float*, const float*, const float*, const float*,
    const float*, const float*, float*, float*, float*, int, int, int, int,
    int, int, float, float);

template <bool kDirected, bool kMixture, bool kSplit>
NodeScanKernel pick_tempered(bool tempered) {
  return tempered ? node_scan_kernel<kDirected, kMixture, true, kSplit>
                  : node_scan_kernel<kDirected, kMixture, false, kSplit>;
}

template <bool kSplit>
NodeScanKernel pick(bool directed, bool mixture, bool tempered) {
  return directed ? (mixture ? pick_tempered<true, true, kSplit>(tempered)
                             : pick_tempered<true, false, kSplit>(tempered))
                  : (mixture ? pick_tempered<false, true, kSplit>(tempered)
                             : pick_tempered<false, false, kSplit>(tempered));
}

constexpr int kMaxDevices = 64;

// The instantiation, its launch configuration and, once per device,
// instantiation and larger shared-memory size, its opt-in to that size.
// Returns the CUDA error of the opt-in, or of arguments the kernel does
// not take.
cudaError_t configure(int C, int T, int n, int d, int P, int warps,
                      int cluster, int directed, int mixture, bool tempered,
                      int split, void* stream, NodeScanKernel* kernel,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const int R = 32 * warps * cluster;
  if ((warps != 1 && warps != 2 && warps != 4) || cluster < 1
      || cluster > (split ? kMaxSplitCluster : kMaxCluster)
      || (cluster & (cluster - 1)) != 0
      || (!split && R > 32 * kMaxExchange) || P % R != 0
      || P / R > (kChunk << (kChunkLevels - 1)) || P < 32
      || (P & (P - 1)) != 0)
    return cudaErrorInvalidValue;
  const int smem =
      node_scan_smem_bytes(T, n, d, P, R, directed, cluster, split);
  *kernel = split ? pick<true>(directed, mixture, tempered)
                  : pick<false>(directed, mixture, tempered);
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
  static int opted_in[kMaxDevices][16] = {};
  int unrecorded = 0;
  int& opted = dev < kMaxDevices
      ? opted_in[dev][8 * (split != 0) + 4 * (directed != 0)
                      + 2 * (mixture != 0) + tempered]
      : unrecorded;
  if (smem_launch > opted) {
    err = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_launch);
    if (err != cudaSuccess) return err;
    opted = smem_launch;
  }
  // a cluster past the portable size: the split-field instantiations opt
  // in to it once per device
  static bool non_portable[kMaxDevices][8] = {};
  bool unrecorded_np = false;
  bool& np = dev < kMaxDevices
      ? non_portable[dev][4 * (directed != 0) + 2 * (mixture != 0) + tempered]
      : unrecorded_np;
  if (cluster > kMaxCluster && !np) {
    err = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    np = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C * cluster);
  cfg->blockDim = dim3(node_scan_threads(T, warps, split));
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
// cluster 1, blocks), or minus a CUDA error code; 0 for a cluster past
// the portable size that the card does not run.
extern "C" int node_scan_max_clusters(int T, int n, int d, int P, int warps,
                                      int cluster, int directed, int mixture,
                                      int tempered, int split) {
  NodeScanKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(cluster, T, n, d, P, warps, cluster, directed,
                              mixture, tempered != 0, split, nullptr, &kernel,
                              &cfg, &attr);
  int count = 0;
  if (err == cudaSuccess && cluster > 1) {
    err = cudaOccupancyMaxActiveClusters(&count, (void*)kernel, &cfg);
  } else if (err == cudaSuccess) {
    int per_sm = 0, sms = 0, dev = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, (int)cfg.blockDim.x, cfg.dynamicSmemBytes);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    count = per_sm * sms;
  }
  if (err != cudaSuccess && cluster > kMaxCluster) {
    cudaGetLastError();
    return 0;
  }
  return err != cudaSuccess ? -(int)err : count;
}

// Launch on `stream`; returns the CUDA error code (0 on success).
// Y: (T, n, P) uint8, rows padded to P bytes, 16-byte aligned, or one
// such network a chain, (C, T, n, P), chain c's at Y + c * y_chain
// (y_chain = T n P; 0 for the shared network); P: the partner axis padded
// to a power of two >= 32.  directed != 0 selects the
// social-radii likelihood (b (C, 2), radii (C, n), Y packed Y + 2 Y^T);
// otherwise b is (C,) and radii may be null.  mixture != 0 selects the
// mixture prior (mu_z, sig_z, lmbda); otherwise the random-walk prior with
// tau_sq and sigma_sq, and mu_z, sig_z, lmbda may be null.  temper: (C,)
// inverse temperatures, or null for the untempered scan.  warps (1, 2, 4)
// per in-phase time and cluster blocks per chain, with
// R = 32 * warps * cluster dividing P: cluster 1, 2, 4 or 8 and R at most
// 512 in the resident mode, 1, 2, 4, 8 or 16 in the split-field mode; a
// cluster the card refuses returns its error.  split != 0 selects the
// split-field mode: Y with each row residue-major (partner i = r + B m
// at column r P / B + m, B = cluster), and `field` a (C, T, P, d) float
// scratch that holds the field during the scan (null otherwise).
extern "C" int node_scan_launch(
    const float* X, const uint8_t* Y, const float* step, const float* eps,
    const float* log_u, const float* mu_z, const float* sig_z,
    const float* b, const float* radii, const float* lmbda,
    const float* temper, float* X_out, float* acc, float* field, int C,
    int T, int n, int d, int P, int warps, int cluster, int directed,
    int mixture, float tau_sq, float sigma_sq, long long y_chain, int split,
    void* stream) {
  if ((y_chain != 0 && y_chain != (long long)T * n * P)
      || (split && field == nullptr))
    return (int)cudaErrorInvalidValue;
  NodeScanKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(C, T, n, d, P, warps, cluster, directed,
                              mixture, temper != nullptr, split, stream,
                              &kernel, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, X, Y, y_chain, step, eps, log_u,
                           mu_z, sig_z, b, radii, lmbda, temper, X_out, acc,
                           field, T, n, d, P, warps, cluster, tau_sq,
                           sigma_sq);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
