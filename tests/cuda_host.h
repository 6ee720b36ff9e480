// The CUDA device intrinsics the port's kernels use, emulated on the host,
// for the host builds of tests/torch_loglik_host.cpp and
// tests/torch_site_loglik_host.cpp.
//
// Every CUDA thread of a block is a std::thread (run_block); __syncthreads
// and the warp shuffles are std::barriers; static shared memory is a
// function-local static (blocks run one after another); dynamic shared
// memory starts as NaN, so a read of a slot nothing wrote shows.
#pragma once

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __host__
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

// the value of lane + h within the lane's segment of `width` lanes, its
// own where that lies past the segment
inline double __shfl_down_sync(unsigned, double v, int h, int width = 32) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  this_block->shuffle_d[threadIdx.x] = v;
  this_block->warp[w]->arrive_and_wait();
  const double got = lane % width + h < width
                         ? this_block->shuffle_d[threadIdx.x + h]
                         : v;
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

// Run body() as block `idx` of `threads` threads (a multiple of 32) at
// once, with `smem_bytes` of dynamic shared memory.
template <class Body>
void run_block(int threads, size_t smem_bytes, dim3 idx, Body body) {
  Block block;
  float4 nan4;
  nan4.x = nan4.y = nan4.z = nan4.w = std::nanf("");
  block.smem.assign(smem_bytes / 16 + 1, nan4);
  block.all = std::make_unique<Barrier>(threads);
  for (int w = 0; w < threads / 32; ++w)
    block.warp.push_back(std::make_unique<Barrier>(32));
  block.shuffle_d.assign(threads, 0.0);
  block.shuffle_u.assign(threads, 0u);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx = dim3(t);
      blockIdx = idx;
      this_block = &block;
      body();
    });
  for (auto& t : pool) t.join();
}
