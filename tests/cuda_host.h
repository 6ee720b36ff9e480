// The CUDA device intrinsics the port's kernels use, emulated on the host,
// for the host builds of tests/torch_node_scan_host.cpp,
// tests/torch_loglik_host.cpp and tests/torch_site_loglik_host.cpp.
//
// One OS thread runs a block, or the blocks of a cluster, at a time; each
// CUDA thread is a fiber that runs until it reaches a wait point:
// __syncthreads, __syncwarp, a warp shuffle, a named barrier, the cluster
// barrier or an mbarrier's phase.  Every wait point yields, and the
// arrival that completes a barrier's phase makes the threads that wait for
// it ready.  Ready fibers run in ascending thread order on one pass and in
// descending order on the next, and neighbouring blocks (clusters) start
// in opposite orders; dynamic shared memory starts as NaN.  So a read of a
// slot whose writer has not passed a barrier yet reads NaN in one of the
// two orders, whether the writer's index is higher or lower.  When no
// fiber can run and some have not returned, the launch stops, prints
// which threads wait where to stderr, and run_cluster returns false.
// A fiber starts on its own stack by ucontext's setcontext; the switches
// are _setjmp / _longjmp, which unlike swapcontext make no system call to
// save and restore the signal mask.
// Static shared memory is a function-local static, one for all blocks: a
// kernel that has it runs its blocks alone, one after another.
#pragma once

#include <setjmp.h>
#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
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
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};

// the running fiber's indices, installed when it is switched in
inline dim3 threadIdx, blockIdx, blockDim;

namespace cuda_host {

struct Block;

struct Fiber {
  ucontext_t start;
  jmp_buf at;  // where it yielded
  std::unique_ptr<char[]> stack;
  dim3 tid, bid;
  Block* block;
  int rank;
  // the thread's count of shuffles: a shuffle's slots are those of its
  // round's parity, which no thread rewrites before every thread of the
  // warp has passed the next shuffle's barrier (and so read this one's)
  unsigned shuffle_round = 0;
  bool started = false, done = false, parked = false;
  unsigned first_pass = 0;  // the first pass it may run in
  const char* waits = "";   // what it is parked at
  int waits_id = -1;
};

using Waiters = std::vector<Fiber*>;

// `count` arrivals complete a phase
struct Barrier {
  int count = 0, arrived = 0;
  unsigned phase = 0;
  Waiters waiting;
};

// completes a phase after `count` arrivals and the transaction bytes they
// announce; tx goes below 0 where a peer's store lands first
struct Mbarrier {
  int count = 0, pending = 0, phase = 0;
  long tx = 0;
  Waiters waiting;
};

struct Block {
  std::vector<float4> smem;
  Barrier all;
  std::vector<Barrier> warp;
  Barrier named[16];
  // two rounds of shuffle slots, used in turn
  std::vector<uint64_t> shuffle[2];
  std::map<const void*, Mbarrier> mbar;

  Block(int threads, size_t smem_bytes) : warp(threads / 32) {
    float4 nan4;
    nan4.x = nan4.y = nan4.z = nan4.w = std::nanf("");
    smem.assign(smem_bytes / 16 + 1, nan4);
    all.count = threads;
    for (Barrier& w : warp) w.count = 32;
    shuffle[0].assign(threads, 0);
    shuffle[1].assign(threads, 0);
  }
};

struct Cluster {
  std::vector<std::unique_ptr<Block>> blocks;
  Barrier all;
  std::vector<Fiber> fibers;
  jmp_buf scheduler;
  unsigned pass = 0;
  const char* error = nullptr;
  void (*entry)(void*);
  void* body;
};

inline Cluster* cluster;
inline Fiber* fiber;

// back to the scheduler, to run again on a later pass unless parked
inline void yield() {
  fiber->first_pass = cluster->pass + 1;
  if (_setjmp(fiber->at) == 0) _longjmp(cluster->scheduler, 1);
}

[[noreturn]] inline void fail(const char* what) {
  cluster->error = what;
  _longjmp(cluster->scheduler, 1);
}

inline void wake(Waiters& waiting) {
  for (Fiber* f : waiting) {
    f->parked = false;
    f->first_pass = cluster->pass + 1;
  }
  waiting.clear();
}

// Yield until done(); parked on `waiting` while it is false.
template <class Done>
void wait(Waiters& waiting, const char* what, int id, Done done) {
  do {
    if (!done()) {
      fiber->parked = true;
      fiber->waits = what;
      fiber->waits_id = id;
      waiting.push_back(fiber);
    }
    yield();
  } while (!done());
}

inline void arrive(Barrier& b) {
  if (++b.arrived < b.count) return;
  b.arrived = 0;
  ++b.phase;
  wake(b.waiting);
}

inline void sync(Barrier& b, const char* what, int id = -1) {
  const unsigned phase = b.phase;
  arrive(b);
  wait(b.waiting, what, id, [&] { return b.phase != phase; });
}

inline void complete_if_done(Mbarrier& m) {
  if (m.pending == 0 && m.tx == 0) {
    m.phase ^= 1;
    m.pending = m.count;
    wake(m.waiting);
  }
}

// This lane's v to the warp; the value lane `from` of the warp gave.
template <class T>
T shuffle(T v, int from) {
  static_assert(sizeof(T) <= sizeof(uint64_t));
  std::vector<uint64_t>& slots =
      fiber->block->shuffle[fiber->shuffle_round++ & 1];
  const int w = threadIdx.x / 32;
  std::memcpy(&slots[threadIdx.x], &v, sizeof v);
  sync(fiber->block->warp[w], "the shuffle of warp", w);
  T got;
  std::memcpy(&got, &slots[32 * w + from], sizeof got);
  return got;
}

// the named barrier `id` of `count` threads; every arrival of a phase
// must give the same count
inline Barrier& named(int id, int count) {
  Barrier& b = fiber->block->named[id];
  if (b.arrived == 0) {
    b.count = count;
  } else if (b.count != count) {
    fail("named barrier: two thread counts in one phase");
  }
  return b;
}

// the address p of this block's shared memory, in block `rank`'s
template <class T>
T* in_block(T* p, int rank) {
  const char* base = reinterpret_cast<const char*>(fiber->block->smem.data());
  char* peer = reinterpret_cast<char*>(cluster->blocks[rank]->smem.data());
  return reinterpret_cast<T*>(peer + (reinterpret_cast<const char*>(p) - base));
}

// stderr: each run of consecutive threads of a block in one state
inline void report(const Cluster& cl, const char* why) {
  const std::vector<Fiber>& fs = cl.fibers;
  std::fprintf(stderr, "cuda_host: %s in the cluster of block (%u, %u, %u)\n",
               why, fs[0].bid.x, fs[0].bid.y, fs[0].bid.z);
  auto same = [](const Fiber& a, const Fiber& b) {
    return a.rank == b.rank && a.done == b.done && a.parked == b.parked &&
           (!a.parked || (a.waits == b.waits && a.waits_id == b.waits_id));
  };
  for (size_t a = 0, b; a < fs.size(); a = b) {
    for (b = a + 1; b < fs.size() && same(fs[a], fs[b]); ++b) {
    }
    const Fiber& f = fs[a];
    std::fprintf(stderr, "  block rank %d threads %u-%u: %s%s", f.rank,
                 f.tid.x, fs[b - 1].tid.x,
                 f.done ? "returned" : f.parked ? "wait at " : "ready",
                 f.parked ? f.waits : "");
    if (f.parked && f.waits_id >= 0) std::fprintf(stderr, " %d", f.waits_id);
    std::fprintf(stderr, "\n");
  }
}

inline void fiber_main() {
  cluster->entry(cluster->body);
  fiber->done = true;
  _longjmp(cluster->scheduler, 1);
}

// run f until it yields, fails or returns
inline void resume(Fiber& f) {
  fiber = &f;
  threadIdx = f.tid;
  blockIdx = f.bid;
  if (_setjmp(cluster->scheduler) != 0) return;
  if (f.started) _longjmp(f.at, 1);
  f.started = true;
  setcontext(&f.start);
}

}  // namespace cuda_host

// Run body() as the `blocks` blocks of one cluster (a block alone: a
// cluster of one), block r at blockIdx (idx.x + r, idx.y, idx.z), each of
// `threads` threads (a multiple of 32) with `smem_bytes` of dynamic shared
// memory.  False where the threads deadlock or misuse a barrier (stderr
// says which).
template <class Body>
bool run_cluster(int blocks, int threads, size_t smem_bytes, dim3 idx,
                 Body body) {
  using namespace cuda_host;
  constexpr size_t kStack = 64 << 10;  // the kernels' frames take ~1 KiB
  Cluster cl;
  cl.all.count = blocks * threads;
  cl.fibers.resize((size_t)blocks * threads);
  cl.entry = [](void* b) { (*static_cast<Body*>(b))(); };
  cl.body = &body;
  for (int r = 0; r < blocks; ++r) {
    cl.blocks.push_back(std::make_unique<Block>(threads, smem_bytes));
    for (int t = 0; t < threads; ++t) {
      Fiber& f = cl.fibers[(size_t)r * threads + t];
      f.tid = dim3(t);
      f.bid = dim3(idx.x + r, idx.y, idx.z);
      f.block = cl.blocks[r].get();
      f.rank = r;
      f.stack.reset(new char[kStack]);
      getcontext(&f.start);
      f.start.uc_stack.ss_sp = f.stack.get();
      f.start.uc_stack.ss_size = kStack;
      f.start.uc_link = nullptr;
      makecontext(&f.start, fiber_main, 0);
    }
  }
  cluster = &cl;
  blockDim = dim3(threads);
  const bool descending_first = (idx.x / blocks + idx.y + idx.z) & 1;
  const size_t n = cl.fibers.size();
  size_t returned = 0;
  for (;; ++cl.pass) {
    const bool descending = (cl.pass & 1) != descending_first;
    bool ran = false;
    for (size_t k = 0; k < n; ++k) {
      Fiber& f = cl.fibers[descending ? n - 1 - k : k];
      if (f.done || f.parked || f.first_pass > cl.pass) continue;
      resume(f);
      ran = true;
      if (cl.error != nullptr) {
        report(cl, cl.error);
        return false;
      }
      returned += f.done;
    }
    if (returned == n) return true;
    if (!ran) {
      report(cl, "deadlock");
      return false;
    }
  }
}

inline float* host_smem() {
  return reinterpret_cast<float*>(cuda_host::fiber->block->smem.data());
}

inline void __syncthreads() {
  cuda_host::sync(cuda_host::fiber->block->all, "__syncthreads");
}

inline void __syncwarp() {
  const int w = threadIdx.x / 32;
  cuda_host::sync(cuda_host::fiber->block->warp[w], "__syncwarp of warp", w);
}

// the value of lane `src` of the lane's segment of `width` lanes
template <class T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int lane = threadIdx.x % 32;
  return cuda_host::shuffle(v, lane - lane % width + src % width);
}

// the value of lane + h within the lane's segment of `width` lanes, its
// own where that lies past the segment
template <class T>
T __shfl_down_sync(unsigned, T v, int h, int width = 32) {
  const int lane = threadIdx.x % 32;
  return cuda_host::shuffle(v, lane % width + h < width ? lane + h : lane);
}

inline unsigned __brev(unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    if ((v >> i) & 1) r |= 1u << (31 - i);
  return r;
}
inline int __ffs(int v) { return __builtin_ffs(v); }

// one thread runs at a time, so these need no atomicity
inline void __threadfence() {}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old + v;
  return old;
}
inline double __ldcg(const double* p) { return *p; }

// the node-scan kernel's inline PTX, on the host: cp.async is a memcpy
inline void cp_async4(void* dst, const void* src) { std::memcpy(dst, src, 4); }
inline void cp_async16(void* dst, const void* src) {
  std::memcpy(dst, src, 16);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}

inline void named_sync(int id, int count) {
  cuda_host::sync(cuda_host::named(id, count), "named barrier", id);
}
inline void named_arrive(int id, int count) {
  cuda_host::arrive(cuda_host::named(id, count));
}

inline void mbar_init(uint64_t* bar, int count) {
  cuda_host::Mbarrier& m = cuda_host::fiber->block->mbar[bar];
  m.count = m.pending = count;
}
inline void mbar_init_fence() {}
inline void mbar_expect(uint64_t* bar, int bytes) {
  cuda_host::Mbarrier& m = cuda_host::fiber->block->mbar[bar];
  m.tx += bytes;
  m.pending -= 1;
  cuda_host::complete_if_done(m);
}
inline void mbar_wait(uint64_t* bar, int parity) {
  cuda_host::Mbarrier& m = cuda_host::fiber->block->mbar[bar];
  cuda_host::wait(m.waiting, "mbarrier", -1,
                  [&] { return m.phase != parity; });
}
inline void st_async(float* dst, float v, uint64_t* bar, int rank) {
  using cuda_host::in_block;
  cuda_host::Mbarrier& m =
      cuda_host::cluster->blocks[rank]->mbar[in_block(bar, rank)];
  *in_block(dst, rank) = v;
  m.tx -= 4;
  cuda_host::complete_if_done(m);
}

namespace cooperative_groups {
struct cluster_group {
  void sync() {
    cuda_host::sync(cuda_host::cluster->all, "the cluster barrier");
  }
  unsigned block_rank() { return cuda_host::fiber->rank; }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
