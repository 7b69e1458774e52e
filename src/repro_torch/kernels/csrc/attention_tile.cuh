// Shared pieces of the hand-written Hopper attention kernels: the tile body
// of flash decode (decode_attention.cu), an online softmax of up to kRows
// query rows over K/V tiles staged in shared memory; and, shared with the
// chunked flash prefill (prefill_attention.cu, which has its own tensor-core
// body), key_range, the row-addressing types and the small helpers.
//
// Numerics follow the reference Pallas kernels exactly in kind: f32 scores,
// f32 running max / sum / accumulator, the finite mask value -1e30 (never
// -inf, so a row with no visible key stays finite), and the final divide by
// max(l, 1e-30). Inputs are f32 or bf16; every tile is widened to f32 as it
// lands in shared memory, so all arithmetic is f32 on the CUDA cores.
//
// Layouts are the serving model's own: K/V caches (B, S, KVH, HD) or shared
// pools (NB, BS, KVH, HD) read through a (B, MB) block table, and the query
// rows of one KV head, gathered by the caller into sm.q. Where a cache row
// lives is the one thing the two layouts differ in, so the tile body is
// templated on a row-addressing type (DenseRows, PagedRows) and written once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kThreads = 128;      // threads per block (4 warps)
constexpr int kWarps = kThreads / 32;
constexpr int kTileS = 64;         // keys per shared-memory K/V tile
constexpr int kRows = 16;          // query rows one block holds

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// float4 reads of q and p rows need 16-byte alignment: q sits at offset 0
// and every member before p is a multiple of 16 bytes long.
template <int HD>
struct Smem {
  float q[kRows][HD];
  float k[kTileS][HD + 1];  // +1 pad: threads reading one key each hit distinct banks
  float v[kTileS][HD];
  float p[kRows][kTileS];   // scores, then exp(score - running max)
  float m[kRows];           // running max
  float l[kRows];           // running sum
  float alpha[kRows];       // exp(m_old - m_new) of the current tile
  int qpos[kRows];          // absolute position of each query row
  long off[2][kTileS];      // paged: element offsets of a tile's rows (double buffer)
};

// Keys a block must visit, as an inclusive range [lo, hi] of cache rows.
// Rows sit at positions pmin..pmax and see kv <= p (and kv > p - window).
// When every row sees at least one key, tiles outside the union of the rows'
// windows hold only masked keys, and skipping them is exact: once a row has
// met a visible key its running max is finite and a masked key adds
// exp(-1e30 - m) == 0. When some row sees no key at all, the reference gives
// it the uniform average over all S keys, so the whole cache is visited.
// S counts logical rows: MB * BS for a paged pool, so the paged kernels may
// skip pages only when every row sees a key, and otherwise walk every table
// entry, null block and unmapped pages included, as the reference does.
__device__ __forceinline__ void key_range(int pmin, int pmax, int S, int window,
                                          int* lo, int* hi) {
  const bool every_row_sees_a_key =
      pmin >= 0 && (window <= 0 || pmax - window + 1 <= S - 1);
  if (every_row_sees_a_key) {
    *lo = window > 0 ? max(0, pmin - window + 1) : 0;
    *hi = min(pmax, S - 1);
  } else {
    *lo = 0;
    *hi = S - 1;
  }
}

// Row addressing of one KV head. A layout descriptor says where logical
// cache row j (0 <= j < S) lives, as an element offset from the head's base
// pointer (k or v + h * HD for a pool, the slot's row 0 of the head for a
// dense cache).
//
// Dense cache (B, S, KVH, HD): row j is j * stride, stride = KVH * HD.
struct DenseRows {
  static constexpr bool kPaged = false;
  long stride;
};

// Paged pool (NB, BS, KVH, HD) through the slot's table row (MB entries):
// logical row j is pool[table[j / BS], j % BS]. The physical id is clamped
// to [0, NB - 1], as the reference's gather clamps, so a bad table entry
// reads a wrong page, never stray memory. The physical row is resolved per
// key, so any block size works and one kTileS-key tile may span several
// pages. attend_tiles resolves a tile's 64 rows once, into shared memory,
// while the tile before it computes (see there).
struct PagedRows {
  static constexpr bool kPaged = true;
  long stride;
  const int* table;
  int bs;
  int nb;
  __device__ __forceinline__ int page(int j) const { return __ldg(table + j / bs); }
  __device__ __forceinline__ long offset(int blk, int j) const {
    return ((long)min(max(blk, 0), nb - 1) * bs + j % bs) * stride;
  }
};

// The rows of one tile as load_tile reads them: row(j) points at logical
// row j. Dense: computed from the stride. Paged: looked up in the tile's
// staged offsets (off[j - s0], filled by attend_tiles).
template <typename T>
struct DenseTile {
  const T* base;
  long stride;
  __device__ __forceinline__ const T* row(int j) const { return base + (long)j * stride; }
};
template <typename T>
struct StagedTile {
  const T* base;
  const long* off;
  int s0;
  __device__ __forceinline__ const T* row(int j) const { return base + off[j - s0]; }
};

// Copy K or V rows [s0, s0 + kTileS) of one KV head into shared memory as
// f32, 16 bytes per load, neighbouring threads on neighbouring addresses.
// Every load of the tile is issued before the first store, so a thread has
// all its loads in flight at once. Rows at or past S are zero-filled.
template <typename T, int HD, int STRIDE, typename Tile>
__device__ __forceinline__ void load_tile(float (*dst)[STRIDE], const Tile& rows, int s0,
                                          int S) {
  constexpr int VW = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = HD / VW;        // loads per row
  constexpr int kIters = kTileS * VPR / kThreads;
  static_assert(kTileS * VPR % kThreads == 0, "a tile splits evenly over the block");
  uint4 raw[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / VPR;
    raw[it] = s0 + r < S
                  ? __ldg(reinterpret_cast<const uint4*>(rows.row(s0 + r) + (i % VPR) * VW))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const T* vals = reinterpret_cast<const T*>(&raw[it]);
#pragma unroll
    for (int e = 0; e < VW; ++e) dst[i / VPR][(i % VPR) * VW + e] = to_float(vals[e]);
  }
}

// Online softmax of the block's `nrows` query rows (staged in sm.q, with
// sm.qpos, sm.m = -1e30 and sm.l = 0 set, and a __syncthreads() behind them)
// over key tiles [t_begin, t_end) of logical rows [0, S). kbase/vbase point
// at this KV head's row 0 (dense) or its pool column (paged); rows
// (DenseRows or PagedRows) places each logical row.
//
// Paged, the 64 row offsets of a tile are staged in sm.off before its loads:
// one table read and one division per row and tile, shared by the K and V
// loads of every thread. The table reads of tile t + 1 are issued at the
// top of tile t and stored after its p @ V, so their latency hides behind
// the tile's compute; the two halves of sm.off alternate between tiles.
//
// Thread roles per tile:
//   load    thread -> 16-byte pieces tid + kThreads * it of the K and V tiles
//   scores  thread -> key j = tid % kTileS, rows tid / kTileS + 2i
//   softmax warp   -> rows warp + 4i (max and sum by shuffles)
//   p @ V   thread -> dim d = tid % HD, rows tid / HD + (kThreads / HD) i
// On return acc[i] holds the unnormalised output of row
// tid / HD + (kThreads / HD) * i, dim tid % HD.
template <typename T, int HD, typename Rows>
__device__ __forceinline__ void attend_tiles(Smem<HD>& sm, const T* __restrict__ kbase,
                                             const T* __restrict__ vbase, const Rows& rows,
                                             int S, int nrows, int t_begin, int t_end,
                                             int window, float scale,
                                             float (&acc)[kRows * HD / kThreads]) {
  constexpr int kSStep = kThreads / kTileS;  // score rows interleave
  constexpr int kSRows = kRows / kSStep;     // score rows per thread
  constexpr int kOStep = kThreads / HD;      // output rows interleave
  constexpr int kORows = kRows / kOStep;     // output rows per thread
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sj = tid % kTileS;
  const int sr = tid / kTileS;
  const int od = tid % HD;
  const int orow = tid / HD;
  // rows this thread owns in each phase (warp-uniform: sr and orow are)
  const int n_srows = nrows > sr ? (nrows - sr + kSStep - 1) / kSStep : 0;
  const int n_orows = nrows > orow ? (nrows - orow + kOStep - 1) / kOStep : 0;

  if constexpr (Rows::kPaged) {
    const int j = t_begin * kTileS + tid;
    if (t_begin < t_end && tid < kTileS && j < S) {
      sm.off[t_begin & 1][tid] = rows.offset(rows.page(j), j);
    }
    __syncthreads();
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int s0 = t * kTileS;
    const int jmax = min(kTileS, S - s0);  // keys of this tile inside the cache
    int next_page = 0;  // paged: page of this thread's row of tile t + 1
    if constexpr (Rows::kPaged) {
      const int jn = s0 + kTileS + tid;
      if (t + 1 < t_end && tid < kTileS && jn < S) next_page = rows.page(jn);
      load_tile<T, HD, HD + 1>(sm.k, StagedTile<T>{kbase, sm.off[t & 1], s0}, s0, S);
      load_tile<T, HD, HD>(sm.v, StagedTile<T>{vbase, sm.off[t & 1], s0}, s0, S);
    } else {
      load_tile<T, HD, HD + 1>(sm.k, DenseTile<T>{kbase, rows.stride}, s0, S);
      load_tile<T, HD, HD>(sm.v, DenseTile<T>{vbase, rows.stride}, s0, S);
    }
    __syncthreads();

    // scores: q . k * scale, masked to -1e30; q rows read 4 dims at a time
    float dot[kSRows];
#pragma unroll
    for (int i = 0; i < kSRows; ++i) dot[i] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float k0 = sm.k[sj][d], k1 = sm.k[sj][d + 1];
      const float k2 = sm.k[sj][d + 2], k3 = sm.k[sj][d + 3];
#pragma unroll
      for (int i = 0; i < kSRows; ++i) {
        if (i < n_srows) {
          const float4 qv = *reinterpret_cast<const float4*>(&sm.q[sr + i * kSStep][d]);
          dot[i] = fmaf(qv.x, k0, dot[i]);
          dot[i] = fmaf(qv.y, k1, dot[i]);
          dot[i] = fmaf(qv.z, k2, dot[i]);
          dot[i] = fmaf(qv.w, k3, dot[i]);
        }
      }
    }
    const int kv = s0 + sj;
#pragma unroll
    for (int i = 0; i < kSRows; ++i) {
      if (i < n_srows) {
        const int r = sr + i * kSStep;
        const int qp = sm.qpos[r];
        const bool seen = kv <= qp && (window <= 0 || kv > qp - window);
        sm.p[r][sj] = seen ? dot[i] * scale : kNegInf;
      }
    }
    __syncthreads();

    // running max / sum update, one warp per row; keys past the cache
    // (j >= jmax) take no part and get p = 0
    for (int r = warp; r < nrows; r += kWarps) {
      float sv[kTileS / 32];
      float mt = kNegInf;
#pragma unroll
      for (int u = 0; u < kTileS / 32; ++u) {
        const int j = lane + 32 * u;
        sv[u] = sm.p[r][j];
        if (j < jmax) mt = fmaxf(mt, sv[u]);
      }
      mt = warp_max(mt);
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kTileS / 32; ++u) {
        const int j = lane + 32 * u;
        const float e = j < jmax ? expf(sv[u] - m_new) : 0.f;
        sm.p[r][j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        sm.alpha[r] = a;
        sm.l[r] = a * sm.l[r] + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p @ V over the whole tile (p = 0 and V rows = 0
    // past the cache); p rows read 4 keys at a time
#pragma unroll
    for (int i = 0; i < kORows; ++i) {
      if (i < n_orows) acc[i] *= sm.alpha[orow + i * kOStep];
    }
#pragma unroll 2
    for (int j = 0; j < kTileS; j += 4) {
      const float v0 = sm.v[j][od], v1 = sm.v[j + 1][od];
      const float v2 = sm.v[j + 2][od], v3 = sm.v[j + 3][od];
#pragma unroll
      for (int i = 0; i < kORows; ++i) {
        if (i < n_orows) {
          const float4 pv = *reinterpret_cast<const float4*>(&sm.p[orow + i * kOStep][j]);
          acc[i] = fmaf(pv.x, v0, acc[i]);
          acc[i] = fmaf(pv.y, v1, acc[i]);
          acc[i] = fmaf(pv.z, v2, acc[i]);
          acc[i] = fmaf(pv.w, v3, acc[i]);
        }
      }
    }
    if constexpr (Rows::kPaged) {
      const int jn = s0 + kTileS + tid;
      if (t + 1 < t_end && tid < kTileS && jn < S) {
        sm.off[(t + 1) & 1][tid] = rows.offset(next_page, jn);
      }
    }
    __syncthreads();  // the next tile overwrites k, v and p, and reads off
  }
}

}  // namespace attn
