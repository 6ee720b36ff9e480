// What the two log-likelihood kernels (pair_loglik.cu, dir_loglik.cu)
// share: the walk over upper-triangle tiles, the staging of a tile's
// positions in shared memory, the distance, softplus, the adjacency load
// and the two reductions (a block's warps by shuffle, a chain's blocks by a
// ticket).
//
// The work list of a chain is every (t, tile_i, tile_j) with tile_j >=
// tile_i, tiles of kTile x kTile dyads, in that order; block `blk` of the
// chain's G blocks takes items [N blk / G, N (blk + 1) / G), so shares are
// equal to within one tile and depend on the shapes only
// (ops/loglik_tiles.py spells the same split out in Python).  In a tile a
// thread owns kCols consecutive columns j of one row i per pass, so it
// carries kCols independent softplus chains and reads the adjacency four
// bytes at a time; dyads off the upper triangle or past n are masked by
// index.  Every thread adds its dyads in a fixed order in float64, so a
// rerun on the same card gives the same bits.
//
// Row-range mode (node sharding: one device holds rows [row0, row0 + rows)
// of the network, (T, rows, n), and sums the dyads i in its rows, j > i):
// tiles start at row0 on both axes, tile_i over the held rows and tile_j
// over the columns row0 .. n - 1, so a time's list is the trapezoid
// tile_j >= tile_i of an mt x ct grid (mt = ceil(rows / kTile) <= ct =
// ceil((n - row0) / kTile)); the last row tile is masked at row0 + rows.
// The whole network is the case row0 = 0, rows = n (mt = ct): the same
// list, the same order, the same bits.  The shares of the shards cover
// every dyad once.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace loglik {

constexpr int kTile = 32;                           // dyads a tile side
constexpr int kThreads = 128;                       // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                            // columns a thread owns
constexpr int kColGroups = kTile / kCols;           // threads a tile row
constexpr int kRowsPerPass = kThreads / kColGroups; // rows a pass covers
constexpr int kPasses = kTile / kRowsPerPass;

// logaddexp(eta, 0): the formula of torch.logaddexp and jax.nn.softplus.
__device__ __forceinline__ float softplus(float eta) {
  const float m = fmaxf(eta, 0.0f);
  return m + log1pf(expf(-fabsf(eta)));
}

// The rows a launch holds: [row0, row0 + rows) of an n-node network.
struct Rows {
  int row0, rows;
  // tiles a time: row tiles mt, column tiles ct, the trapezoid's per_t
  __host__ __device__ __forceinline__ int mt() const {
    return (rows + kTile - 1) / kTile;
  }
  __host__ __device__ __forceinline__ int ct(int n) const {
    return (n - row0 + kTile - 1) / kTile;
  }
  __host__ __device__ __forceinline__ long long per_t(int n) const {
    const long long m = mt();
    return m * ct(n) - m * (m - 1) / 2;
  }
};

// One item of a chain's work list: time t and the tile (ti, tj), tj >= ti,
// both counted from row0.
struct TileWalk {
  int t, ti, tj;
  // item = t * per_t + m, m counting the tiles of the trapezoid row by
  // row: row tile ti has ct - ti of them.
  __device__ __forceinline__ TileWalk(int item, int per_t, int ct) {
    t = item / per_t;
    int m = item % per_t;
    ti = 0;
    while (m >= ct - ti) {
      m -= ct - ti;
      ++ti;
    }
    tj = ti + m;
  }
  __device__ __forceinline__ void advance(int ct, int mt) {
    if (++tj == ct) {
      if (++ti == mt) {
        ti = 0;
        ++t;
      }
      tj = ti;
    }
  }
};

// Block `blk` of a chain's G walks its share of the work list:
// stage(buffer, tile) fills one of two shared-memory buffers with a tile's
// inputs, work(buffer, tile) scores the tile from it.  The next tile is
// staged while this one is scored, so the block meets once per tile.
// Every thread of the block must call it.
template <class Stage, class Work>
__device__ __forceinline__ void walk_tiles(int T, int n, Rows rows, int blk,
                                           int G, Stage stage, Work work) {
  const int ct = rows.ct(n);
  const int mt = rows.mt();
  const int per_t = (int)rows.per_t(n);
  const long long N = (long long)T * per_t;
  int item = (int)(N * blk / G);
  const int end = (int)(N * (blk + 1) / G);
  if (item >= end) return;
  TileWalk w(item, per_t, ct);
  stage(item & 1, w);
  for (; item < end; ++item) {
    __syncthreads();
    TileWalk next = w;
    next.advance(ct, mt);
    if (item + 1 < end) stage((item + 1) & 1, next);
    work(item & 1, w);
    w = next;
  }
}

// Positions of the tile's kTile row nodes and kTile column nodes into
// buf[side][q][node], side 0 the rows (ti) and 1 the columns (tj), both
// counted from row0; nodes past n read as 0.  x_t: (n, d) of one chain and
// time.  D is the latent dimension where the kernel was compiled for it
// (2), else 0 and `d_any` holds it.
template <int D>
__device__ __forceinline__ void stage_positions(float* buf, const float* x_t,
                                                int row0, int ti, int tj,
                                                int n, int d_any) {
  const int d = D ? D : d_any;
  const int per_side = kTile * d;
  for (int e = threadIdx.x; e < 2 * per_side; e += kThreads) {
    const int side = e / per_side;
    const int r = e - side * per_side;
    const int local = r / d;
    const int q = r - local * d;
    const int node = row0 + (side ? tj : ti) * kTile + local;
    buf[side * per_side + q * kTile + local] =
        node < n ? x_t[(size_t)node * d + q] : 0.0f;
  }
}

// Squared distances from row node `il` to the thread's kCols column nodes
// (group c4), from a buffer stage_positions filled.
template <int D>
__device__ __forceinline__ void squared_distances(const float* buf,
                                                  int d_any, int il, int c4,
                                                  float* d2) {
  const int d = D ? D : d_any;
  const float* xi = buf;
  const float4* xj = reinterpret_cast<const float4*>(buf + kTile * d);
#pragma unroll
  for (int q = 0; q < d; ++q) {
    const float a = xi[q * kTile + il];
    const float4 b = xj[q * kColGroups + c4];
    const float e0 = a - b.x, e1 = a - b.y, e2 = a - b.z, e3 = a - b.w;
    d2[0] = (q == 0) ? e0 * e0 : d2[0] + e0 * e0;
    d2[1] = (q == 0) ? e1 * e1 : d2[1] + e1 * e1;
    d2[2] = (q == 0) ? e2 * e2 : d2[2] + e2 * e2;
    d2[3] = (q == 0) ? e3 * e3 : d2[3] + e3 * e3;
  }
}

// Four adjacency bytes from p, byte m in bits 8m..8m+7: one 32-bit load
// where the rows are 4-byte aligned (`words`; the caller has checked that
// all four lie in the row), else the `left` bytes the row still has.
__device__ __forceinline__ uint32_t load_y4(const uint8_t* p, int left,
                                            bool words) {
  if (words) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0;
  for (int m = 0; m < kCols; ++m) {
    if (m < left) w |= (uint32_t)p[m] << (8 * m);
  }
  return w;
}

// Whether the launch reads the adjacency as 32-bit words: every row of
// every chain's network starts on a 4-byte boundary, and so does every
// thread's first column, row0 + a multiple of 4 (y_chain: the chain stride
// in bytes, 0 for one network shared by the chains).
inline bool word_rows(const uint8_t* Y, int n, long long y_chain, int row0) {
  return n % 4 == 0 && row0 % 4 == 0 && y_chain % 4 == 0 &&
         (uintptr_t)Y % 4 == 0;
}

// Lane 0 gets the warp's sum, lanes added in a fixed tree (the shuffle
// moves a double as its two 32-bit halves).
__device__ __forceinline__ double warp_sum(double v) {
  for (int h = 16; h > 0; h >>= 1) v += __shfl_down_sync(0xffffffffu, v, h);
  return v;
}

// The end of a block: its threads' sums s[NC] become one partial per
// candidate (warps by shuffle, then one meeting in shared memory), and the
// chain's last block to arrive adds the chain's G partials in index order
// and writes out[c, :] as float32, or when out64 is given the float64 sum
// to out64[c, :] (a row range's share, which the shards' sum rounds once).
// Which block is last changes nothing: the order of the sum is the blocks'
// index order.  The ticket counter of the chain goes back to 0, so the
// next launch needs no reset.  With G = 1 the block writes out directly.
// Every thread of the block must call it.
template <int NC>
__device__ __forceinline__ void block_finish(const double* s,
                                             double* partials,
                                             unsigned* tickets, float* out,
                                             double* out64, int c, int blk,
                                             int G) {
  __shared__ double red[NC][kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int k = 0; k < NC; ++k) {
    const double v = warp_sum(s[k]);
    if (lane == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (warp != 0) return;
  double* p = partials + (size_t)c * G * NC;
  unsigned ticket = 0;
  if (lane == 0) {
    for (int k = 0; k < NC; ++k) {
      double tot = red[k][0];
      for (int w = 1; w < kWarps; ++w) tot += red[k][w];
      if (G == 1) {
        if (out64) {
          out64[c * NC + k] = tot;
        } else {
          out[c * NC + k] = (float)tot;
        }
      } else {
        p[blk * NC + k] = tot;
      }
    }
    if (G > 1) {
      __threadfence();
      ticket = atomicAdd(&tickets[c], 1u);
    }
  }
  if (G == 1) return;
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  if (ticket != (unsigned)(G - 1)) return;
  __threadfence();
  for (int k = 0; k < NC; ++k) {
    double v = 0.0;
    for (int m = lane; m < G; m += 32) v += __ldcg(&p[m * NC + k]);
    v = warp_sum(v);
    if (lane == 0) {
      if (out64) {
        out64[c * NC + k] = v;
      } else {
        out[c * NC + k] = (float)v;
      }
    }
  }
  if (lane == 0) tickets[c] = 0u;
}

// Bytes of dynamic shared memory: two buffers (the tile in work and the
// next one), each the positions of both sides and `extra` more floats.
inline size_t smem_bytes(int d, int extra) {
  return sizeof(float) * 2 * ((size_t)2 * kTile * d + extra);
}

}  // namespace loglik
