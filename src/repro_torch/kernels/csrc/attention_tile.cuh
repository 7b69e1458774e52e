// Shared pieces of the hand-written Hopper attention kernels: the tile body
// of flash decode (decode_attention.cu), where each warp runs its own online
// softmax over its share of the keys; and, shared with the chunked flash
// prefill (prefill_attention.cu, which has its own tensor-core body),
// key_range, the row-addressing type of a paged pool, the cp.async helpers
// and the small conversions.
//
// Numerics follow the reference Pallas kernels exactly in kind: f32 scores,
// f32 running max / sum / accumulator, the finite mask value -1e30 (never
// -inf, so a row with no visible key stays finite), and the final divide by
// max(l, 1e-30). Inputs are f32 or bf16; K/V land in shared memory in their
// own dtype (bf16 at half the bytes) and are widened to f32 as they are read,
// so all arithmetic is f32 on the CUDA cores.
//
// The decode body (attend_chunks). Decode does G / 2 flops per byte in f32
// (G per byte in bf16) at G <= 16 query rows per KV head, far below the 20
// f32 flops per byte of the card's CUDA cores: bytes bound it, so the body
// is built to keep the K/V copies in flight and every thread busy, not to
// compute faster. No tensor cores (they cannot speed up a byte-bound loop)
// and no TMA (a tensor map cannot follow a block table row by row, so it
// would split the dense and paged bodies in two).
//  * A block's keys come in tiles of kTileS = kWarps * kChunk keys; warp w
//    owns chunk w (kChunk = 8 keys) of every tile of the block, so the
//    warps of a block walk the keys side by side and never wait on each
//    other: no block barrier inside the tile loop, one __syncwarp after a
//    chunk lands and one before its stage is refilled.
//  * Each warp has its own kStages-deep ring of 16-byte cp.async.cg copies
//    (a commit group per chunk, empty past the end; keys past S zero-filled
//    by src-size 0): chunks u + 1 .. u + kStages - 1 are in flight while
//    chunk u computes. Rows are stored XOR-swizzled in 16-byte pieces, so
//    the reads below hit distinct banks without padding.
//  * Scores: lane = part * 8 + key, each of the 4 parts holds a quarter of
//    the head dim, so all 32 lanes work at G = 1; two shuffles finish a dot.
//    The softmax of a chunk is 8 keys wide: three shuffles for the max, three
//    for the sum. P @ V: lanes over the head dim, 4 dims each (128 / DP key
//    groups of lanes take alternate keys), the weights of a key broadcast
//    from the lane that scored it. A row wider than one warp's 32 x 4 dims
//    (DP 256: Pixtral's 160) gives each lane DP / 128 groups of 4 dims, 128
//    apart, and one key group.
//  * Each warp keeps its own (m, l, acc); the block merges its warps' partials
//    once, at the end, through shared memory that aliases the ring.
//
// Layouts are the serving model's own: K/V caches (B, S, KVH, HD) or shared
// pools (NB, BS, KVH, HD) read through a (B, MB) block table, and the query
// rows of one KV head, copied by the caller into shared memory. Where a cache
// row lives is the one thing the two layouts differ in, so the body is
// templated on a row-addressing type (DenseRows, PagedRows) and written once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kRows = 16;          // query rows (G) one decode block holds

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

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
// key, so any block size works and one tile may span several pages.
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

// ------------------------------------------------------------- decode body
// Geometry of the decode partial kernel. DECODE_WARPS and DECODE_STAGES are
// compile-time knobs (scripts/decode_probe.py builds variants); the port's
// build takes the defaults.
#ifndef DECODE_WARPS
#define DECODE_WARPS 4
#endif
#ifndef DECODE_STAGES
#define DECODE_STAGES 3
#endif
constexpr int kWarps = DECODE_WARPS;    // warps per decode block
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = DECODE_STAGES;  // ring depth of each warp
constexpr int kChunk = 8;               // keys a warp takes per tile
constexpr int kTileS = kWarps * kChunk; // keys per tile: the unit of the split
static_assert(kStages >= 2, "a ring needs two stages");

// The head dim a decode block computes at: HD rounded up to a power of two
// (32, 64, 128, 256). A head dim in between (Zamba2's 112, Pixtral's 160:
// the next power of two keeps the XOR swizzle below inside a row, which needs
// a multiple of 8 pieces, and every lane map a power of two; the price at 160
// is 96 zero dims in shared memory, one decode block per SM in f32 and two in
// bf16, where a 160-wide row would hold two in bf16 at best) keeps its rows HD long
// in the caches and in q and out; only the block's shared-memory rows and
// its registers are DP wide, their last DP - HD elements zero (copies past
// HD read nothing and write zeros), so every lane mapping below stays the
// power-of-two one, the zero dims add exact zeros to the dots, and their
// accumulator columns (zero too) are never written out.
__host__ __device__ constexpr int padded_dim(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

// Shared memory of a decode block: the query rows (raw dtype, [kRows][DP]);
// the warps' rings, kStages x (K chunk, V chunk) of [kChunk][DP] each, which
// the end-of-block merge reuses for the warps' accumulators
// ([kWarps][kRows][DP] f32); then the warps' (m, l) [kWarps][kRows] each.
template <typename T, int HD>
struct DecodePlan {
  static constexpr int DP = padded_dim(HD);       // shared-memory row length
  static constexpr int VW = 16 / (int)sizeof(T);  // elements per 16-byte piece
  static constexpr int VPR = DP / VW;             // pieces per row: 4 .. 32
  static constexpr int kHDPieces = HD / VW;       // ... of them holding data
  static constexpr int kQBytes = kRows * DP * (int)sizeof(T);
  static constexpr int kChunkElems = kChunk * DP;
  static constexpr int kWarpRingElems = kStages * 2 * kChunkElems;
  static constexpr int kRingBytes = kWarps * kWarpRingElems * (int)sizeof(T);
  static constexpr int kMergeBytes = kWarps * kRows * DP * 4;
  static constexpr int kShared = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  static constexpr int kBytes = kQBytes + kShared + 2 * kWarps * kRows * 4;
  // P @ V: each lane holds kVG groups of 4 dims of a row (dims 4 * (dq +
  // kLPR * g)), kLPR lanes a row, kKG key groups of lanes
  static constexpr int kVG = DP > 128 ? DP / 128 : 1;
  static constexpr int kLPR = DP / 4 / kVG;
  static constexpr int kKG = 32 / kLPR;
  static_assert(HD % VW == 0 && HD % 4 == 0 && HD <= DP, "rows of whole 16-byte pieces");
  static_assert(VPR >= 4 && VPR % 4 == 0, "four score parts of whole pieces");
  static_assert(kChunk * VPR % 32 == 0, "a chunk's copies split evenly over a warp");
  static_assert(kKG >= 1 && kLPR * kKG == 32 && kChunk % kKG == 0, "P @ V lanes fill a warp");
};

// Physical 16-byte piece of logical piece `pc` in row `r` of a chunk: the
// low bits are XORed with the row, so the 8 rows of a chunk put one logical
// piece in 8 distinct bank groups (rows are VPR pieces long; at VPR 4 two
// rows share a 128-byte bank line, so the row's upper bits are used).
template <int VPR>
__device__ __forceinline__ int swizzle(int r, int pc) {
  if constexpr (VPR >= 8) {
    return pc ^ (r & 7);
  } else {
    return pc ^ ((r >> 1) & 3);
  }
}

// VW elements of a 16-byte piece in shared memory, widened to f32.
template <typename T>
__device__ __forceinline__ void load_piece(const T* src, float (&x)[16 / sizeof(T)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < (int)(16 / sizeof(T)); ++e) x[e] = to_float(vals[e]);
}

// Four consecutive elements of a shared-memory row, widened to f32 (16 bytes
// of f32, 8 of bf16).
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// One warp's online softmax over its chunk of each tile in [t_begin,
// t_end): warp w reads keys t * kTileS + w * kChunk + [0, kChunk) of every
// tile t, through its ring (kWarpRingElems elements of T), for the G query
// rows in qs ([G][DP], raw dtype, zero past HD), all at position qpos. The
// caller has issued the copies of qs as the last cp.async group before the
// call; every warp of the block calls this, which waits for them (after
// issuing its first K/V copies) and synchronizes the block once. kbase/vbase point at
// this KV head's row 0 (dense) or its pool column (paged); rows (DenseRows
// or PagedRows) places each logical row.
// Keys at or past S take no part (their copies are zero-filled).
//
// On return m[r] and l[r] (the same in every lane) are row r's running max
// and sum over the warp's keys, and acc[r][4 g + e] the unnormalised output
// of row r at dim 4 * (lane % kLPR + kLPR * g) + e, summed over the warp's
// key groups (zero at dims past HD).
template <typename T, int HD, typename Rows>
__device__ __forceinline__ void attend_chunks(T* ring, const T* qs, const T* __restrict__ kbase,
                                              const T* __restrict__ vbase, const Rows& rows,
                                              int S, int G, int t_begin, int t_end, int qpos,
                                              int window, float scale, float (&m)[kRows],
                                              float (&l)[kRows],
                                              float (&acc)[kRows][4 * DecodePlan<T, HD>::kVG]) {
  using P = DecodePlan<T, HD>;
  constexpr int DP = P::DP;
  constexpr int VW = P::VW;
  constexpr int VPR = P::VPR;
  constexpr int kCopies = kChunk * VPR / 32;  // 16-byte copies per lane, K and V each
  constexpr int kQ = VPR / 4;                 // pieces per score part
  constexpr int kVG = P::kVG;                 // groups of 4 dims per lane in P @ V
  constexpr int kLPR = P::kLPR;               // lanes per V row in P @ V
  constexpr int kKG = P::kKG;                 // key groups in P @ V
  constexpr int kKeysPerGroup = kChunk / kKG;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = t_end - t_begin;
  const int first = t_begin * kTileS + warp * kChunk;  // the warp's first key

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * kVG; ++e) acc[r][e] = 0.f;
  }

  // paged: the page of row lane % kChunk of the next chunk to issue, read
  // one issue ahead so its latency hides behind a chunk's compute
  int pg = 0;
  if constexpr (Rows::kPaged) {
    const int j = first + (lane & (kChunk - 1));
    if (n > 0 && j < S) pg = rows.page(j);
  }

  // copies of chunk u into stage u % kStages, one commit group per chunk
  // (empty past the end, so wait_group counts stay uniform)
  auto issue = [&](int u) {
    if (u < n) {
      const int j0 = first + u * kTileS;
      T* dk = ring + (u % kStages) * 2 * P::kChunkElems;
      T* dv = dk + P::kChunkElems;
      long row_off = 0;  // paged: offset of row lane % kChunk of this chunk
      if constexpr (Rows::kPaged) {
        const int j = j0 + (lane & (kChunk - 1));
        if (j < S) row_off = rows.offset(pg, j);
        const int jn = j + kTileS;
        pg = u + 1 < n && jn < S ? rows.page(jn) : 0;
      }
#pragma unroll
      for (int c = 0; c < kCopies; ++c) {
        const int i = lane + 32 * c;
        const int r = i / VPR;
        const int pc = i % VPR;
        const int j = j0 + r;
        long o;
        if constexpr (Rows::kPaged) {
          o = __shfl_sync(0xffffffffu, row_off, r);
        } else {
          o = (long)j * rows.stride;
        }
        // a key past S, or a piece past HD, lands as zeros and reads nothing
        const bool in = j < S && pc < P::kHDPieces;
        const int dst = r * DP + swizzle<VPR>(r, pc) * VW;
        const long src = in ? o + pc * VW : 0;
        cp_async16(dk + dst, kbase + src, in ? 16 : 0);
        cp_async16(dv + dst, vbase + src, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  // the caller's q copies, the group committed before these, landed: make
  // them visible to every warp
  cp_async_wait<kStages - 1>();
  __syncthreads();

  const int key = lane & (kChunk - 1);  // scores: this lane's key of a chunk
  const int part = lane >> 3;           // ... and its quarter of the head dim
  const int kg = lane / kLPR;           // P @ V: this lane's key group
  const int dq = lane % kLPR;           // ... and its groups of 4 dims
  for (int u = 0; u < n; ++u) {
    issue(u + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();  // chunk u landed for every lane of the warp
    const T* tk = ring + (u % kStages) * 2 * P::kChunkElems;
    const T* tv = tk + P::kChunkElems;

    // q . k over this lane's part of the head dim, then across the parts
    float dot[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) dot[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int pc = part * kQ + i;
      float kf[VW];
      load_piece(tk + key * DP + swizzle<VPR>(key, pc) * VW, kf);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < G) {
          float qf[VW];
          load_piece(qs + r * DP + pc * VW, qf);
#pragma unroll
          for (int e = 0; e < VW; ++e) dot[r] = fmaf(qf[e], kf[e], dot[r]);
        }
      }
    }
    // this lane's V values: keys kg + kKG * t of the chunk, dims 4 * (dq +
    // kLPR * g) ..
    float4 vf[kVG][kKeysPerGroup];
#pragma unroll
    for (int g = 0; g < kVG; ++g) {
#pragma unroll
      for (int t = 0; t < kKeysPerGroup; ++t) {
        const int jr = kg + kKG * t;
        const int d = 4 * (dq + kLPR * g);  // logical element; its piece is d / VW
        vf[g][t] = load4(tv + jr * DP + swizzle<VPR>(jr, d / VW) * VW + d % VW);
      }
    }
    const int kv = first + u * kTileS + key;
    const bool live = kv < S;
    const bool seen = kv <= qpos && (window <= 0 || kv > qpos - window);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < G) {
        float d = dot[r];
        d += __shfl_xor_sync(0xffffffffu, d, 8);
        d += __shfl_xor_sync(0xffffffffu, d, 16);
        // keys past the cache score -1e30 in the max (no effect) and get p 0
        const float s = live && seen ? d * scale : kNegInf;
        float mt = s;
#pragma unroll
        for (int o = 1; o < kChunk; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[r], mt);
        const float p = live ? expf(s - m_new) : 0.f;
        float sum = p;
#pragma unroll
        for (int o = 1; o < kChunk; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float a = expf(m[r] - m_new);
        l[r] = a * l[r] + sum;
        m[r] = m_new;
#pragma unroll
        for (int g = 0; g < kVG; ++g) {
          float4 o4 = make_float4(acc[r][4 * g] * a, acc[r][4 * g + 1] * a,
                                  acc[r][4 * g + 2] * a, acc[r][4 * g + 3] * a);
#pragma unroll
          for (int t = 0; t < kKeysPerGroup; ++t) {
            const float pj = __shfl_sync(0xffffffffu, p, kg + kKG * t);
            o4.x = fmaf(pj, vf[g][t].x, o4.x);
            o4.y = fmaf(pj, vf[g][t].y, o4.y);
            o4.z = fmaf(pj, vf[g][t].z, o4.z);
            o4.w = fmaf(pj, vf[g][t].w, o4.w);
          }
          acc[r][4 * g] = o4.x;
          acc[r][4 * g + 1] = o4.y;
          acc[r][4 * g + 2] = o4.z;
          acc[r][4 * g + 3] = o4.w;
        }
      }
    }
    __syncwarp();  // every lane is done with stage u before it is refilled
  }

  // sum the key groups' accumulators (same m and l in every lane)
#pragma unroll
  for (int o = kLPR; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < G) {
#pragma unroll
        for (int e = 0; e < 4 * kVG; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
      }
    }
  }
}

}  // namespace attn
