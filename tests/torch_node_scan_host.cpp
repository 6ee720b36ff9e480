// Host emulation of the node-scan kernel in dynetlsm_tpu_torch/csrc/
// node_scan.cu, for tests/test_torch_node_scan_emulated*.py.
//
// tests/torch_host_build.py cuts the kernel's part of the .cu (everything
// before its "---- launch" section, without the CUDA headers and the
// "inline PTX" section) into node_scan_kernel.inc and builds this file
// around it with g++ -std=c++20.  tests/cuda_host.h stands in for the
// intrinsics, the barriers, the mbarriers, st.async, cp.async and the
// cluster.  Each cluster (chain) runs alone, its blocks' threads as
// fibers of one OS thread.
#include "cuda_host.h"

#include "node_scan_kernel.inc"

namespace {

using Kernel = void (*)(const float*, const uint8_t*, long long,
                        const float*, const float*, const float*,
                        const float*, const float*, const float*,
                        const float*, const float*, const float*, float*,
                        float*, float*, int, int, int, int, int, int, float,
                        float);

template <bool kDirected, bool kMixture, bool kSplit>
Kernel pick_tempered(bool tempered) {
  return tempered ? node_scan_kernel<kDirected, kMixture, true, kSplit>
                  : node_scan_kernel<kDirected, kMixture, false, kSplit>;
}

template <bool kSplit>
Kernel pick_mode(bool directed, bool mixture, bool tempered) {
  return directed ? (mixture ? pick_tempered<true, true, kSplit>(tempered)
                             : pick_tempered<true, false, kSplit>(tempered))
                  : (mixture ? pick_tempered<false, true, kSplit>(tempered)
                             : pick_tempered<false, false, kSplit>(tempered));
}

}  // namespace

// node_scan_launch's arguments, but run on the host, one cluster (chain)
// at a time; `warps`, `cluster` and `split` as the wrapper chooses them.
// Nonzero where the threads deadlock (stderr says where).
extern "C" int node_scan_host(
    const float* X, const uint8_t* Y, const float* step, const float* eps,
    const float* log_u, const float* mu_z, const float* sig_z,
    const float* b, const float* radii, const float* lmbda,
    const float* temper, float* X_out, float* acc, float* field, int C,
    int T, int n, int d, int P, int warps, int cluster, int directed,
    int mixture, float tau_sq, float sigma_sq, long long y_chain,
    int split) {
  const int threads = node_scan_threads(T, warps, split);
  const int smem = node_scan_smem_bytes(T, n, d, P, 32 * warps * cluster,
                                        directed, cluster, split);
  const bool tempered = temper != nullptr;
  const Kernel kernel =
      split ? pick_mode<true>(directed, mixture, tempered)
            : pick_mode<false>(directed, mixture, tempered);
  for (int c = 0; c < C; ++c) {
    const dim3 first(c * cluster);
    const bool ok = run_cluster(cluster, threads, smem, first, [&] {
      kernel(X, Y, y_chain, step, eps, log_u, mu_z, sig_z, b, radii, lmbda,
             temper, X_out, acc, field, T, n, d, P, warps, cluster, tau_sq,
             sigma_sq);
    });
    if (!ok) return 1;
  }
  return 0;
}
