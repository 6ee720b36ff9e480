// Host emulation of the two log-likelihood kernels in dynetlsm_tpu_torch/
// csrc/ (pair_loglik.cu, dir_loglik.cu and their shared loglik_common.cuh),
// for tests/test_torch_loglik_emulated.py.
//
// The test copies each source's kernel part (everything before its
// "---- launch" section) and the header, without the CUDA headers, beside
// this file and builds all with g++ -std=c++20.  Here every CUDA thread of
// a block is a std::thread; __syncthreads and the warp shuffles are
// std::barriers; static shared memory is a function-local static (blocks
// run one after another); dynamic shared memory starts as NaN, so a read
// of a slot nothing wrote shows.  Blocks run in index order or, with
// `reverse`, in the opposite order, so another block is the last to take a
// chain's ticket.
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) float4 {
  float x, y, z, w;
};
thread_local dim3 threadIdx, blockIdx;

using Barrier = std::barrier<>;

struct Block {
  std::vector<float4> smem;
  std::unique_ptr<Barrier> all;
  std::vector<std::unique_ptr<Barrier>> warp;
  std::vector<double> shuffle_d;
  std::vector<unsigned> shuffle_u;
};

thread_local Block* this_block;

inline float* host_smem() {
  return reinterpret_cast<float*>(this_block->smem.data());
}

inline void __syncthreads() { this_block->all->arrive_and_wait(); }

inline double __shfl_down_sync(unsigned, double v, int h) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  this_block->shuffle_d[threadIdx.x] = v;
  this_block->warp[w]->arrive_and_wait();
  const double got =
      lane + h < 32 ? this_block->shuffle_d[threadIdx.x + h] : v;
  this_block->warp[w]->arrive_and_wait();
  return got;
}

inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
  const int w = threadIdx.x / 32;
  this_block->shuffle_u[threadIdx.x] = v;
  this_block->warp[w]->arrive_and_wait();
  const unsigned got = this_block->shuffle_u[32 * w + src];
  this_block->warp[w]->arrive_and_wait();
  return got;
}

// blocks run one after another, so these need no atomicity
inline void __threadfence() {}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old + v;
  return old;
}
inline double __ldcg(const double* p) { return *p; }

#include "pair_loglik_kernel.inc"
#include "dir_loglik_kernel.inc"

namespace {

// Run kernel(blk, c) for every block of the grid (G, C), each block's
// kThreads threads at once, with `smem_bytes` of dynamic shared memory.
template <class Kernel>
void run_grid(int C, int G, size_t smem_bytes, bool reverse, Kernel kernel) {
  for (int cc = 0; cc < C; ++cc) {
    for (int bb = 0; bb < G; ++bb) {
      const int c = reverse ? C - 1 - cc : cc;
      const int blk = reverse ? G - 1 - bb : bb;
      Block block;
      float4 nan4;
      nan4.x = nan4.y = nan4.z = nan4.w = std::nanf("");
      block.smem.assign(smem_bytes / 16 + 1, nan4);
      block.all = std::make_unique<Barrier>(loglik::kThreads);
      for (int w = 0; w < loglik::kWarps; ++w)
        block.warp.push_back(std::make_unique<Barrier>(32));
      block.shuffle_d.assign(loglik::kThreads, 0.0);
      block.shuffle_u.assign(loglik::kThreads, 0u);
      std::vector<std::thread> pool;
      for (int t = 0; t < loglik::kThreads; ++t)
        pool.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(blk, c);
          this_block = &block;
          kernel();
        });
      for (auto& t : pool) t.join();
    }
  }
}

}  // namespace

// The end of a block alone: block `blk` of chain c brings values[c * G +
// blk] (in its thread 0; its other threads bring 0), and block_finish
// adds them up into out (C, 1).
extern "C" int block_finish_host(const double* values, double* partials,
                                 unsigned* tickets, float* out, int C, int G,
                                 int reverse) {
  run_grid(C, G, 0, reverse, [&] {
    const int c = blockIdx.y, blk = blockIdx.x;
    const double s[1] = {threadIdx.x == 0 ? values[c * G + blk] : 0.0};
    loglik::block_finish<1>(s, partials, tickets, out, c, blk, G);
  });
  return 0;
}

// pair_loglik_launch's arguments, but run on the host.
extern "C" int pair_loglik_host(const float* X, const uint8_t* Y,
                                const float* b_cur, const float* b_prop,
                                double* partials, unsigned* tickets,
                                float* out, int C, int T, int n, int d, int G,
                                int reverse) {
  const int words = n % 4 == 0 && (uintptr_t)Y % 4 == 0;
  const size_t smem = loglik::smem_bytes(d, 0);
  // as the launch picks them: compiled for d = 2, or for any d
  auto run = [&](auto kernel, const float* b_second) {
    run_grid(C, G, smem, reverse, [&] {
      kernel(X, Y, b_cur, b_second, partials, tickets, out, T, n, d, G,
             words);
    });
  };
  if (b_prop == nullptr) {
    d == 2 ? run(pair_loglik_kernel<1, 2>, b_cur)
           : run(pair_loglik_kernel<1, 0>, b_cur);
  } else {
    d == 2 ? run(pair_loglik_kernel<2, 2>, b_prop)
           : run(pair_loglik_kernel<2, 0>, b_prop);
  }
  return 0;
}

namespace {

template <int NC>
void dir_host(const float* X, const uint8_t* Yp, const float* radii,
              const float* b, double* partials, unsigned* tickets, float* out,
              int C, int T, int n, int d, int G, int reverse) {
  const int words = n % 4 == 0 && (uintptr_t)Yp % 4 == 0;
  // as the launch picks them: compiled for d = 2, or for any d
  run_grid(C, G, loglik::smem_bytes(d, kUvFloats<NC>), reverse, [&] {
    if (d == 2) {
      dir_loglik_kernel<NC, 2>(X, Yp, radii, b, partials, tickets, out, T, n,
                               d, G, words);
    } else {
      dir_loglik_kernel<NC, 0>(X, Yp, radii, b, partials, tickets, out, T, n,
                               d, G, words);
    }
  });
}

}  // namespace

// dir_loglik_launch's arguments, but run on the host.
extern "C" int dir_loglik_host(const float* X, const uint8_t* Yp,
                               const float* radii, const float* b,
                               double* partials, unsigned* tickets,
                               float* out, int C, int n_cand, int T, int n,
                               int d, int G, int reverse) {
  switch (n_cand) {
    case 1:
      dir_host<1>(X, Yp, radii, b, partials, tickets, out, C, T, n, d, G,
                  reverse);
      return 0;
    case 2:
      dir_host<2>(X, Yp, radii, b, partials, tickets, out, C, T, n, d, G,
                  reverse);
      return 0;
    case 3:
      dir_host<3>(X, Yp, radii, b, partials, tickets, out, C, T, n, d, G,
                  reverse);
      return 0;
    default:
      return 1;
  }
}
