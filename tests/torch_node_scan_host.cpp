// Host emulation of the node-scan kernel in dynetlsm_tpu_torch/csrc/
// node_scan.cu, for tests/test_torch_node_scan_emulated.py.
//
// The test copies the kernel's part of the .cu (everything before its
// "---- launch" section, without the CUDA headers and the "inline PTX"
// section) into node_scan_kernel.inc beside this file and builds both with
// g++ -std=c++20.  Here every CUDA thread of a block, and every block of a
// cluster, is a std::thread; __syncthreads, named barriers, the cluster
// barrier and the warp shuffles are std::barriers; an mbarrier counts its
// arrivals and transaction bytes under a mutex; cp.async is a memcpy.
// Shared memory starts as NaN, so a read of a slot nothing wrote shows.
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 {
  float x, y;
};
thread_local dim3 threadIdx, blockIdx, blockDim;

inline unsigned __brev(unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    if ((v >> i) & 1) r |= 1u << (31 - i);
  return r;
}
inline int __ffs(int v) { return __builtin_ffs(v); }

using Barrier = std::barrier<>;

struct Mbarrier {
  std::mutex mu;
  std::condition_variable cv;
  int count = 0, pending = 0, phase = 0;
  long tx = 0;
  void complete_if_done() {
    if (pending == 0 && tx == 0) {
      phase ^= 1;
      pending = count;
      cv.notify_all();
    }
  }
};

struct Block {
  std::vector<float> smem;
  std::unique_ptr<Barrier> all;
  std::vector<std::unique_ptr<Barrier>> named, warp;
  // two rounds of shuffle slots, used in turn
  std::vector<float> shuffle[2];
  std::map<const void*, std::unique_ptr<Mbarrier>> mbar;
  std::mutex mbar_mu;
  int group_threads;
};

struct Cluster {
  std::unique_ptr<Barrier> all;
  std::vector<Block*> blocks;
};

thread_local Block* this_block;
// the thread's count of shuffles: a shuffle's slots are those of its
// round's parity, which no thread rewrites before every thread has passed
// the next shuffle's barrier (and so read this one's)
thread_local unsigned shuffle_round;
thread_local Cluster* this_cluster_;
thread_local int this_rank;

inline float* host_smem() { return this_block->smem.data(); }

inline Mbarrier* mbarrier_of(Block* blk, const void* p) {
  std::lock_guard<std::mutex> lk(blk->mbar_mu);
  auto& m = blk->mbar[p];
  if (!m) m = std::make_unique<Mbarrier>();
  return m.get();
}

// the address p of this block's shared memory, in block `rank`'s
template <class T>
T* in_block(T* p, int rank) {
  const char* base = reinterpret_cast<const char*>(host_smem());
  char* peer =
      reinterpret_cast<char*>(this_cluster_->blocks[rank]->smem.data());
  const char* at = reinterpret_cast<const char*>(p);
  return reinterpret_cast<T*>(peer + (at - base));
}

inline void __syncthreads() { this_block->all->arrive_and_wait(); }

inline void __syncwarp() { this_block->warp[threadIdx.x / 32]->arrive_and_wait(); }

inline float __shfl_sync(unsigned, float v, int src) {
  const int w = threadIdx.x / 32;
  std::vector<float>& slots = this_block->shuffle[shuffle_round++ & 1];
  slots[threadIdx.x] = v;
  this_block->warp[w]->arrive_and_wait();
  return slots[32 * w + src];
}

inline float __shfl_down_sync(unsigned, float v, int h) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::vector<float>& slots = this_block->shuffle[shuffle_round++ & 1];
  slots[threadIdx.x] = v;
  this_block->warp[w]->arrive_and_wait();
  return lane + h < 32 ? slots[threadIdx.x + h] : v;
}

// the kernel's inline PTX, on the host
inline void cp_async4(void* dst, const void* src) { std::memcpy(dst, src, 4); }
inline void cp_async16(void* dst, const void* src) {
  std::memcpy(dst, src, 16);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
inline void named_sync(int id, int count) {
  if (count != this_block->group_threads)
    throw std::runtime_error("named barrier: unexpected thread count");
  this_block->named[id]->arrive_and_wait();
}
inline void named_arrive(int id, int count) {
  if (count != this_block->group_threads)
    throw std::runtime_error("named barrier: unexpected thread count");
  (void)this_block->named[id]->arrive();
}
inline void mbar_init(uint64_t* bar, int count) {
  Mbarrier* m = mbarrier_of(this_block, bar);
  std::lock_guard<std::mutex> lk(m->mu);
  m->count = m->pending = count;
}
inline void mbar_init_fence() {}
inline void mbar_expect(uint64_t* bar, int bytes) {
  Mbarrier* m = mbarrier_of(this_block, bar);
  std::lock_guard<std::mutex> lk(m->mu);
  m->tx += bytes;
  m->pending -= 1;
  m->complete_if_done();
}
inline void mbar_wait(uint64_t* bar, int parity) {
  Mbarrier* m = mbarrier_of(this_block, bar);
  std::unique_lock<std::mutex> lk(m->mu);
  m->cv.wait(lk, [&] { return m->phase != parity; });
}
inline void st_async(float* dst, float v, uint64_t* bar, int rank) {
  Mbarrier* m = mbarrier_of(this_cluster_->blocks[rank], in_block(bar, rank));
  std::lock_guard<std::mutex> lk(m->mu);
  *in_block(dst, rank) = v;
  m->tx -= 4;
  m->complete_if_done();
}

namespace cooperative_groups {
struct cluster_group {
  void sync() { this_cluster_->all->arrive_and_wait(); }
  unsigned block_rank() { return this_rank; }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

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
    Cluster cl;
    cl.all = std::make_unique<Barrier>(cluster * threads);
    std::vector<std::unique_ptr<Block>> blocks;
    for (int rank = 0; rank < cluster; ++rank) {
      auto blk = std::make_unique<Block>();
      blk->smem.assign(smem / 4 + 4, std::nanf(""));
      blk->all = std::make_unique<Barrier>(threads);
      blk->group_threads = 32 * warps + 32;
      for (int id = 0; id < 16; ++id)
        blk->named.push_back(std::make_unique<Barrier>(blk->group_threads));
      for (int w = 0; w < threads / 32; ++w)
        blk->warp.push_back(std::make_unique<Barrier>(32));
      blk->shuffle[0].assign(threads, 0.0f);
      blk->shuffle[1].assign(threads, 0.0f);
      cl.blocks.push_back(blk.get());
      blocks.push_back(std::move(blk));
    }
    std::vector<std::thread> pool;
    for (int rank = 0; rank < cluster; ++rank)
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, rank, t] {
          threadIdx = dim3(t);
          shuffle_round = 0;
          blockIdx = dim3(c * cluster + rank);
          blockDim = dim3(threads);
          this_block = cl.blocks[rank];
          this_cluster_ = &cl;
          this_rank = rank;
          kernel(X, Y, y_chain, step, eps, log_u, mu_z, sig_z, b, radii,
                 lmbda, temper, X_out, acc, field, T, n, d, P, warps,
                 cluster, tau_sq, sigma_sq);
        });
    for (auto& t : pool) t.join();
  }
  return 0;
}
