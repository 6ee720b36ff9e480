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
// pallas_scan.py:244-250, :409 and :821).  T is a runtime argument, so one kernel serves both Pallas
// kernels.  With the same injected proposal stream (eps (C,2,n,T,d), log_u
// (C,2,n,T)) it realises the same Markov chain as dynetlsm_tpu/mcmc/
// latent.py::xla_exact_scan: nodes in index order, each node in two parity
// phases (even t, then odd t), a site accepted iff log_u < ratio.
//
// What bounds it on the H100: the scan is 2n dependent steps per sweep, so
// it is latency-bound, not bandwidth- or FLOP-bound.  Per step a chain does
// ceil(T/2) * n partner terms (two sqrt/exp/log1p evaluations each, four
// directed) and a reduction; the adjacency (T*n*n bytes, 2.5 MB at T=10,
// n=500) stays in L2 across chains.  The prior is a handful of operations
// per in-phase time, so the two priors cost the same step latency.
//
// Design: one thread block per chain keeps that chain's (T, n, d) position
// field in shared memory for the whole scan (40 KB at T=10, n=500, d=2),
// so the only device-memory traffic per step is one adjacency row per
// in-phase time and the node's noise.  Threads spread over (in-phase time,
// partner).  The partner sum is a pairwise tree over the partner axis
// padded to a power of two, P >= 32: level s adds element i + s into
// element i.  ops/node_scan.py's plain version sums in the same order, and
// this file is compiled with -fmad=false, so the two compute bit-identical
// ratios and accept decisions.  One thread per in-phase time then adds the
// prior delta, decides, and writes the site back to shared memory.
// C blocks on 132 SMs is low occupancy at few chains; a chain's steps
// cannot be spread over blocks without a grid-wide barrier per step.
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
// of the JAX scan and of the Pallas kernel; never each partner term.  Each
// block reads its chain's value once, into shared memory, where only the
// accept threads read it: held in a register across the scan instead, it
// made the directed mixture instantiation 7% slower on an H100 (the
// partner loop scheduled differently).  A null temper launches the
// untempered instantiation, which has no multiply and no load: it computes
// the ratios of the kernel without the lane, in its time.
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
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;

// logaddexp(eta, 0): the formula of torch.logaddexp and jax.nn.softplus.
__device__ __forceinline__ float softplus(float eta) {
  const float m = fmaxf(eta, 0.0f);
  return m + log1pf(expf(-fabsf(eta)));
}

// b: (C,) intercepts, or (C, 2) = (b_in, b_out) when kDirected; radii:
// (C, n) when kDirected, unused otherwise; Y: the 0/1 adjacency, or the
// packed Y + 2 Y^T when kDirected.  mu_z, sig_z, lmbda: the mixture prior's
// per-site cluster means and variances and per-chain lambda (kMixture);
// tau_sq, sigma_sq: the random-walk prior's variances (!kMixture).  temper:
// (C,) per-chain inverse temperatures (kTempered), unused otherwise.
template <bool kDirected, bool kMixture, bool kTempered>
__global__ void node_scan_kernel(
    const float* __restrict__ X_in, const uint8_t* __restrict__ Y,
    const float* __restrict__ step, const float* __restrict__ eps,
    const float* __restrict__ log_u, const float* __restrict__ mu_z,
    const float* __restrict__ sig_z, const float* __restrict__ b,
    const float* __restrict__ radii, const float* __restrict__ lmbda,
    const float* __restrict__ temper, float* __restrict__ X_out,
    float* __restrict__ acc, int T, int n, int d, int P, float tau_sq,
    float sigma_sq) {
  extern __shared__ float smem[];
  const int field = T * n * d;
  float* xs = smem;           // (T, n, d) this chain's positions
  float* red = smem + field;  // (ceil(T/2), P) per-partner deltas
  float* u_s = red + ((T + 1) / 2) * P;  // directed: b_in / r, (n,)
  float* v_s = u_s + n;                  // directed: b_out / r, (n,)
  float* r_s = v_s + n;                  // directed: r, (n,)

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  const float* X_c = X_in + (size_t)c * field;
  for (int k = tid; k < field; k += nthr) xs[k] = X_c[k];

  const float bc = kDirected ? 0.0f : b[c];
  const float b_in = kDirected ? b[2 * c] : 0.0f;
  const float b_out = kDirected ? b[2 * c + 1] : 0.0f;
  const float both = b_in + b_out;
  if (kDirected) {
    const float* radii_c = radii + (size_t)c * n;
    for (int k = tid; k < n; k += nthr) {
      const float r = radii_c[k];
      r_s[k] = r;
      u_s[k] = b_in / r;
      v_s[k] = b_out / r;
    }
  }
  // the chain's inverse temperature, read by the accept threads only
  __shared__ float beta_s;
  if (kTempered && tid == 0) beta_s = temper[c];
  const float lam = kMixture ? lmbda[c] : 0.0f;
  const float one_m = 1.0f - lam;
  const float* step_c = step + (size_t)c * T * n;
  const float* eps_c = eps + (size_t)c * 2 * n * T * d;
  const float* logu_c = log_u + (size_t)c * 2 * n * T;
  const float* muz_c = kMixture ? mu_z + (size_t)c * T * n * d : nullptr;
  const float* sigz_c = kMixture ? sig_z + (size_t)c * T * n : nullptr;
  float* acc_c = acc + (size_t)c * T * n;
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    // directed: the node's own reciprocal terms b_out / r_j and b_in / r_j
    const float bo_rj = kDirected ? b_out / r_s[j] : 0.0f;
    const float bi_rj = kDirected ? b_in / r_s[j] : 0.0f;
    for (int phase = 0; phase < 2; ++phase) {
      const int th = (T - phase + 1) / 2;  // in-phase times phase, phase+2, ..
      const float* eps_j = eps_c + ((size_t)phase * n + j) * T * d;

      // 1. per-partner log-likelihood deltas at every in-phase time
      for (int k = tid; k < th * P; k += nthr) {
        const int m = k / P;
        const int i = k - m * P;
        float term = 0.0f;
        if (i < n) {
          const int t = phase + 2 * m;
          const float* x_t = xs + t * n * d;
          const float s = step_c[t * n + j];
          const float* e = eps_j + t * d;
          float d2p = 0.0f;
          float d2c = 0.0f;
          for (int q = 0; q < d; ++q) {
            const float xc = x_t[j * d + q];
            const float xp = xc + s * e[q];
            const float dp = x_t[i * d + q] - xp;
            const float dc = x_t[i * d + q] - xc;
            d2p = (q == 0) ? dp * dp : d2p + dp * dp;
            d2c = (q == 0) ? dc * dc : d2c + dc * dc;
          }
          const uint8_t yb = Y[((size_t)t * n + j) * n + i];
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
          term = (llp - llc) * (i == j ? 0.0f : 1.0f);
        }
        red[m * P + i] = term;
      }
      __syncthreads();

      // 2. pairwise tree over the padded partner axis
      for (int s = P / 2; s >= 1; s >>= 1) {
        for (int k = tid; k < th * s; k += nthr) {
          const int m = k / s;
          const int i = k - m * s;
          red[m * P + i] = red[m * P + i] + red[m * P + i + s];
        }
        __syncthreads();
      }

      // 3. prior delta, accept and write-back, one thread per in-phase time
      for (int m = tid; m < th; m += nthr) {
        const int t = phase + 2 * m;
        const float s = step_c[t * n + j];
        const float* e = eps_j + t * d;
        const float* x_t = xs + t * n * d;
        const bool last = (t == T - 1);
        float back_p, back_c, fwd_p, fwd_c;
        if (kMixture) {
          const float sig = sigz_c[t * n + j];
          const float sig_nxt = last ? 1.0f : sigz_c[(t + 1) * n + j];
          float bp = 0.0f, bcur = 0.0f, fp = 0.0f, fcur = 0.0f;
          for (int q = 0; q < d; ++q) {
            const float xc = x_t[j * d + q];
            const float xp = xc + s * e[q];
            const float mu = muz_c[(t * n + j) * d + q];
            float dp, dc;
            if (t == 0) {
              dp = xp - mu;
              dc = xc - mu;
            } else {
              const float prev = xs[((t - 1) * n + j) * d + q];
              dp = (xp - one_m * prev) - lam * mu;
              dc = (xc - one_m * prev) - lam * mu;
            }
            bp = (q == 0) ? dp * dp : bp + dp * dp;
            bcur = (q == 0) ? dc * dc : bcur + dc * dc;
            if (!last) {
              const float nxt = xs[((t + 1) * n + j) * d + q];
              const float mu_nxt = muz_c[((t + 1) * n + j) * d + q];
              const float gp = (nxt - one_m * xp) - lam * mu_nxt;
              const float gc = (nxt - one_m * xc) - lam * mu_nxt;
              fp = (q == 0) ? gp * gp : fp + gp * gp;
              fcur = (q == 0) ? gc * gc : fcur + gc * gc;
            }
          }
          back_p = (-0.5f * bp) / sig;
          back_c = (-0.5f * bcur) / sig;
          fwd_p = last ? 0.0f : (-0.5f * fp) / sig_nxt;
          fwd_c = last ? 0.0f : (-0.5f * fcur) / sig_nxt;
        } else {
          float bp = 0.0f, bcur = 0.0f, fp = 0.0f, fcur = 0.0f;
          for (int q = 0; q < d; ++q) {
            const float xc = x_t[j * d + q];
            const float xp = xc + s * e[q];
            float dp = xp, dc = xc;
            if (t > 0) {
              const float prev = xs[((t - 1) * n + j) * d + q];
              dp = xp - prev;
              dc = xc - prev;
            }
            bp = (q == 0) ? dp * dp : bp + dp * dp;
            bcur = (q == 0) ? dc * dc : bcur + dc * dc;
            if (!last) {
              const float nxt = xs[((t + 1) * n + j) * d + q];
              const float gp = nxt - xp;
              const float gc = nxt - xc;
              fp = (q == 0) ? gp * gp : fp + gp * gp;
              fcur = (q == 0) ? gc * gc : fcur + gc * gc;
            }
          }
          const float var0 = (t == 0) ? tau_sq : sigma_sq;
          back_p = (-0.5f * bp) / var0;
          back_c = (-0.5f * bcur) / var0;
          fwd_p = last ? 0.0f : (-0.5f * fp) / sigma_sq;
          fwd_c = last ? 0.0f : (-0.5f * fcur) / sigma_sq;
        }
        const float lp = back_p + fwd_p;
        const float lc = back_c + fwd_c;
        const float dll = kTempered ? beta_s * red[m * P] : red[m * P];
        const float ratio = (dll + lp) - lc;
        const bool accept = logu_c[((size_t)phase * n + j) * T + t] < ratio;
        if (accept) {
          for (int q = 0; q < d; ++q) {
            const float xc = x_t[j * d + q];
            xs[(t * n + j) * d + q] = xc + s * e[q];
          }
        }
        acc_c[t * n + j] = accept ? 1.0f : 0.0f;
      }
      __syncthreads();
    }
  }

  float* out_c = X_out + (size_t)c * field;
  for (int k = tid; k < field; k += nthr) out_c[k] = xs[k];
}

using NodeScanKernel = void (*)(
    const float*, const uint8_t*, const float*, const float*, const float*,
    const float*, const float*, const float*, const float*, const float*,
    const float*, float*, float*, int, int, int, int, float, float);

template <bool kDirected, bool kMixture>
NodeScanKernel pick_tempered(bool tempered) {
  return tempered ? node_scan_kernel<kDirected, kMixture, true>
                  : node_scan_kernel<kDirected, kMixture, false>;
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success).
// P: the partner axis padded to a power of two >= 32.  directed != 0
// selects the social-radii likelihood (b (C, 2), radii (C, n), Y packed
// Y + 2 Y^T); otherwise b is (C,) and radii may be null.  mixture != 0
// selects the mixture prior (mu_z, sig_z, lmbda); otherwise the random-walk
// prior with tau_sq and sigma_sq, and mu_z, sig_z, lmbda may be null.
// temper: (C,) inverse temperatures, or null for the untempered scan.
extern "C" int node_scan_launch(
    const float* X, const uint8_t* Y, const float* step, const float* eps,
    const float* log_u, const float* mu_z, const float* sig_z,
    const float* b, const float* radii, const float* lmbda,
    const float* temper, float* X_out, float* acc, int C, int T, int n,
    int d, int P, int directed, int mixture, float tau_sq, float sigma_sq,
    void* stream) {
  const size_t smem =
      ((size_t)T * n * d + (size_t)((T + 1) / 2) * P
       + (directed ? 3 * (size_t)n : 0)) * sizeof(float);
  const bool tempered = temper != nullptr;
  const NodeScanKernel kernel =
      directed ? (mixture ? pick_tempered<true, true>(tempered)
                          : pick_tempered<true, false>(tempered))
               : (mixture ? pick_tempered<false, true>(tempered)
                          : pick_tempered<false, false>(tempered));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = P < kMaxThreads ? P : kMaxThreads;
  kernel<<<C, threads, smem, (cudaStream_t)stream>>>(
      X, Y, step, eps, log_u, mu_z, sig_z, b, radii, lmbda, temper, X_out, acc,
      T, n, d, P, tau_sq, sigma_sq);
  return (int)cudaGetLastError();
}
