// Chunked flash prefill for Hopper (sm_90a): a (B, C) chunk of queries
// against the KV cache prefix, dense or paged, every slot at its own offset.
//
// Replaces the TPU kernels prefill_attention_pallas (_prefill_kernel) and
// paged_prefill_attention_pallas (_paged_prefill_kernel) in
// src/repro/kernels/prefill_attention/kernel.py. Same function: the C * G
// query rows of slot b and KV head h form a slab; row r is chunk token
// i = r / G at absolute position pos[b] + i and reads
// kv <= pos[b] + i [and kv > pos[b] + i - window], so in-chunk causality
// falls out of the same mask. f32 running max, sum and accumulator, the
// finite mask value -1e30, a final divide by max(l, 1e-30); a row that sees
// no key averages all S rows. Paged, kv is a logical row of the slot, read
// from pool[clamp(table[b, kv / BS], 0, NB - 1), kv % BS].
//
// What bounds it on the H100: at the main path's shapes (C = 32, HD = 128,
// S = 1024, f32) a (b, h) does 4 * C * G * HD flops per key row it reads
// (2 * HD * 4 bytes), 16 flops per byte for OLMo-1B (G = 1) and 80 for
// Qwen2.5-14B (G = 5). On the tensor cores (495 TFLOP/s of TF32, a third of
// that in 3xTF32) that is below the ridge, so bytes bound it: the visible
// K/V rows read once. What held the earlier SIMT kernel at 13x that bound
// was latency: one block walked a slot's whole prefix alone, loads and
// compute never overlapped, and every product ran on the CUDA cores. What
// holds this one is latency still, now per tile: one block of 8 warps per
// SM, and each phase (scores, softmax, P @ V) ends at a barrier.
//
// Design:
//  * The visible key range of a (b, h) (key_range in attention_tile.cuh,
//    computed on the device from pos) is split across blocks: grid
//    (row_tiles * nsplit, KVH, B). Each block runs the online softmax over
//    its share of the 64-key tiles and writes partial (m, l, acc) for its
//    rows; a second kernel merges the partials of the splits that had tiles,
//    M = max m_s, out = sum e^{m_s - M} acc_s / max(sum e^{m_s - M} l_s, 1e-30),
//    into the model's (B, C, H, HD) layout. A split whose keys are all masked
//    for a row has m = -1e30 there and weight 0 once another split saw a key;
//    a row that sees no key anywhere keeps weight 1 everywhere and averages
//    all S rows, as the reference does.
//  * All C * G rows of a (b, h) share one block where they fit (Plan::
//    kMaxRows): OLMo-1B's 32 and multitask-LM's 128 do. At HD 128 a block
//    holds 48 rows beside the ring in f32 and 144 in bf16, so Qwen2.5-14B's
//    160 take four row tiles (two in bf16). Each K/V tile of a split is read
//    once per row tile. G is padded inside the kernel: row r maps to head
//    h * G + r % G of chunk token r / G.
//  * K/V tiles arrive through a 2-stage ring of 16-byte cp.async.cg copies
//    (rows past S zero-filled by src-size 0): tile t + 1, 64 keys, is in
//    flight while tile t computes. bf16 tiles land raw, at half the bytes.
//    Paged, a tile's 64 row offsets are resolved through the table into
//    shared memory one stage ahead of its copies: the table read of tile
//    t + 2 is issued at the top of tile t and stored after its P @ V.
//  * Q @ K^T and P @ V run on the tensor cores as mma.sync m16n8k8 TF32 with
//    f32 accumulators, in 3xTF32: x = hi + lo with hi = tf32(x) and
//    lo = tf32(x - hi), and a @ b = a_lo b_hi + a_hi b_lo + a_hi b_hi. bf16
//    operands are exact in TF32, so bf16 Q @ K^T is one product and P @ V
//    two (P_lo V + P_hi V). Q is split once per block and P once per tile,
//    into shared memory, so the warps that share them do not split them
//    again; K and V are split as their fragments are read. Q @ K^T keeps the
//    three terms in separate accumulators (independent mma chains). The mask
//    is applied after the product (seen ? s * scale : -1e30).
//  * 8 warps: for Q @ K^T warp w owns the key n-tile w of the tile and every
//    m-tile of rows; for P @ V it owns the HD n-tiles w, w + 8 and every
//    m-tile, so all warps work at any row count. Shared-memory row strides
//    are padded so the fragment reads hit 32 distinct banks.
//  * Head dims 32, 64, 112, 128 and 160: every loop runs over HD / 8 n-tiles
//    and HD / VW 16-byte pieces, so 112 (Zamba2: 14 n-tiles, the warps'
//    second tile guarded) and 160 (Pixtral: 20 n-tiles, three a warp, the
//    third guarded) need no padding; the combine kernel's HD / 4 threads a
//    row leave 4 of its 256 threads idle at 112 (9 rows of 28) and 16 at 160
//    (6 rows of 40). At 160 a block holds 32 rows in f32 and 112 in bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

using attn::kNegInf;
using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::key_range;
using attn::PagedRows;
using attn::store;
using attn::to_float;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 64;     // keys per ring stage
constexpr int kStages = 2;     // ring depth
constexpr int kRowCap = 160;   // query rows one block holds at most (10 m16 tiles)
constexpr int kRowCapLo = 128; // ... when operands carry a low part (registers)
constexpr int kSmemCap = 232448;  // shared memory a block may use (227 KB)
constexpr int kKeyNT = kTileK / 8;               // key n-tiles of Q @ K^T
constexpr int kQKGroups = kWarps / kKeyNT;       // warps sharing one key n-tile
constexpr int kSStride = kTileK + 4;             // score row stride (floats)
constexpr int kThreadsPerRow = kThreads / 32;    // softmax: 8 threads a row
constexpr int kKeysPerThread = kTileK / kThreadsPerRow;
static_assert(kKeysPerThread % 4 == 0, "softmax reads whole float4s");

// Phases compiled out by -DPREFILL_PROBE_SKIP=<mask of the bits below>, for
// the time breakdown of scripts/prefill_probe.py (the results are then wrong
// by design). 0 in the port's build: every phase runs.
#ifndef PREFILL_PROBE_SKIP
#define PREFILL_PROBE_SKIP 0
#endif
constexpr int kSkip = PREFILL_PROBE_SKIP;
constexpr int kSkipQK = 1, kSkipSoftmax = 2, kSkipPV = 4, kSkipCopy = 8, kSkipTiles = 16;

// Where the K/V rows come from. Dense: table == nullptr, S cache rows per
// slot. Paged: S = MB * BS logical rows per slot through table (B, MB) into
// pools of NB blocks of BS rows.
struct Layout {
  const int* table;
  int S;
  int mb;
  int bs;
  int nb;
};

// Shared-memory plan of one block holding `rt` query rows (a multiple of
// 16): the K/V ring, the paged row offsets, then per row Q as TF32 parts
// (hi, and lo unless the dtype is exact in TF32), the scores (then P's high
// part) and P's low part, and m, l, alpha and the row's position. Row
// strides are padded by 16 bytes (K, Q) or 32 bytes (V) so the m16n8k8
// fragment reads of a warp fall on 32 distinct banks. Every region is a
// multiple of 16 bytes long, so each starts 16-byte aligned. kMaxRows is
// the most rows that fit beside the ring, at most kRowCap.
template <typename T, int HD>
struct Plan {
  static constexpr bool kLo = !std::is_same<T, __nv_bfloat16>::value;  // operands need a lo
  static constexpr int kKStride = HD + 16 / (int)sizeof(T);  // elements
  static constexpr int kVStride = HD + 32 / (int)sizeof(T);
  static constexpr int kQStride = HD + 4;                     // words
  static constexpr int kKBytes = kTileK * kKStride * (int)sizeof(T);
  static constexpr int kVBytes = kTileK * kVStride * (int)sizeof(T);
  static constexpr int kRingBytes = kStages * (kKBytes + kVBytes);
  static constexpr int kOffBytes = kStages * kTileK * (int)sizeof(long);
  static constexpr int kFixed = kRingBytes + kOffBytes;
  static constexpr int kRowBytes = kQStride * 4 * (kLo ? 2 : 1) + kSStride * 4 * 2 + 16;
  static constexpr int kFit = (kSmemCap - kFixed) / kRowBytes / 16 * 16;
  static constexpr int kCap = kLo ? kRowCapLo : kRowCap;
  static constexpr int kMaxRows = kFit < kCap ? kFit : kCap;
  static constexpr int kMaxMT = kMaxRows / 16;
  static_assert(kMaxMT >= 1 && kMaxRows % 16 == 0, "whole m16 tiles of rows must fit");
  // every 16-byte ring and Q row starts 16-byte aligned (HD 112: 464 / 480 B
  // rows in f32, 240 / 256 B in bf16; HD 160: 656 / 672 B and 336 / 352 B)
  static_assert(kKStride * sizeof(T) % 16 == 0 && kVStride * sizeof(T) % 16 == 0,
                "16-byte aligned K/V rows");
  __host__ __device__ static constexpr int bytes(int rt) { return kFixed + rt * kRowBytes; }
};

// ------------------------------------------------------------ primitives
// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's result for every finite x (and inf stays inf),
// in two integer operations where the cvt expands to six with its NaN/inf
// checks.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An mma operand: the TF32 high part and, where the value is not exact in
// TF32, the rounded remainder.
struct Split {
  uint32_t hi;
  uint32_t lo;
};
__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = tf32(x);
  return {hi, tf32(x - __uint_as_float(hi))};
}
// bf16 widened to f32 is exact in TF32: its bits go in as they are.
__device__ __forceinline__ Split exact_tf32(float x) { return {__float_as_uint(x), 0u}; }

// c += a @ b for one m16n8k8 TF32 tile (row-major A, column-major B). Not
// volatile: the compiler may interleave independent accumulators.
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The three products of 3xTF32, a_lo b_hi, a_hi b_lo and a_hi b_hi, one
// m16n8k8 tile each. hi(a, b) takes the high parts; lo_hi and hi_lo the
// corrections.
__device__ __forceinline__ void mma_hi(float (&c)[4], const Split (&a)[4], const Split (&b)[2]) {
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}
__device__ __forceinline__ void mma_lo_hi(float (&c)[4], const Split (&a)[4],
                                          const Split (&b)[2]) {
  mma(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
}
__device__ __forceinline__ void mma_hi_lo(float (&c)[4], const Split (&a)[4],
                                          const Split (&b)[2]) {
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
}

// The tiles split `split` of `nsplit` walks, for the block of slab rows
// [r0, r0 + nrows) of a slot at pos p: [t_begin, t_end) in units of
// kTileK keys (empty when t_begin >= t_end). The partial and combine
// kernels both call it, so they agree on which splits hold partials.
__device__ __forceinline__ void split_tiles(int p, int r0, int nrows, int G, int S, int window,
                                            int nsplit, int split, int* t_begin, int* t_end) {
  int lo, hi;
  key_range(p + r0 / G, p + (r0 + nrows - 1) / G, S, window, &lo, &hi);
  const int t_lo = lo / kTileK;
  const int ntiles = hi / kTileK - t_lo + 1;
  const int per = (ntiles + nsplit - 1) / nsplit;
  *t_begin = t_lo + split * per;
  *t_end = min(t_lo + ntiles, *t_begin + per);
}

}  // namespace

namespace {

// One split of the visible key tiles of (slot b, KV head h) for the slab
// rows [r0, r0 + nrows) of row tile blockIdx.x / nsplit: the online softmax
// over tiles [t_begin, t_end), written as partial (m, l) to part_ml
// (B, KVH, nsplit, C * G, 2) and the unnormalised accumulator to part_acc
// (B, KVH, nsplit, C * G, HD). An empty split returns at once and writes
// nothing; the combine kernel skips it.
template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(kThreads, 1)
prefill_partial_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const int* __restrict__ pos, float* __restrict__ part_ml,
                       float* __restrict__ part_acc, Layout lay, int KVH, int C, int G,
                       int window, int nsplit, int row_tile, float scale) {
  using P = Plan<T, HD>;
  constexpr bool kLo = P::kLo;
  constexpr int kMaxMT = P::kMaxMT;
  constexpr int kQKM = (kMaxMT + kQKGroups - 1) / kQKGroups;  // m-tiles per warp, Q @ K^T
  constexpr int KS = P::kKStride, VS = P::kVStride, QS = P::kQStride;
  constexpr int VW = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int VPR = HD / VW;             // copies per row
  constexpr int kChunks = kTileK * VPR;
  constexpr int kHDNT = HD / 8;                        // n-tiles of P @ V
  constexpr int kNW = (kHDNT + kWarps - 1) / kWarps;   // of them per warp
  static_assert(HD % 8 == 0 && VPR >= 1, "head dim");

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring_k = reinterpret_cast<T*>(smem);  // [kStages][kTileK][KS]
  T* ring_v = reinterpret_cast<T*>(smem + kStages * P::kKBytes);  // [kStages][kTileK][VS]
  long* off = reinterpret_cast<long*>(smem + P::kRingBytes);     // [kStages][kTileK]
  uint32_t* qhi = reinterpret_cast<uint32_t*>(smem + P::kFixed);  // [row_tile][QS]
  uint32_t* qlo = qhi + row_tile * QS;  // [row_tile][QS], only if kLo
  float* ss = reinterpret_cast<float*>(qhi + (kLo ? 2 : 1) * row_tile * QS);  // S, then P_hi
  float* plo = ss + row_tile * kSStride;                        // [row_tile][kSStride]: P_lo
  float* sm_m = plo + row_tile * kSStride;
  float* sm_l = sm_m + row_tile;
  float* sm_alpha = sm_l + row_tile;
  int* qpos = reinterpret_cast<int*>(sm_alpha + row_tile);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row / column group
  const int tq = lane & 3;  // thread in group
  const int split = blockIdx.x % nsplit;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int R = C * G;
  const int r0 = (blockIdx.x / nsplit) * row_tile;
  const int nrows = min(row_tile, R - r0);
  const int mt = (nrows + 15) / 16;  // m16 tiles of rows
  const int p = pos[b];
  const int S = lay.S;
  int t_begin, t_end;
  split_tiles(p, r0, nrows, G, S, window, nsplit, split, &t_begin, &t_end);
  if (t_begin >= t_end) return;
  if (kSkip & kSkipTiles) t_end = t_begin;

  const long H = (long)KVH * G;
  const long stride = (long)KVH * HD;
  const T* kb;
  const T* vb;
  PagedRows rows{stride, nullptr, 1, 1};
  if constexpr (PAGED) {
    kb = k + (long)h * HD;
    vb = v + (long)h * HD;
    rows = PagedRows{stride, lay.table + (long)b * lay.mb, lay.bs, lay.nb};
  } else {
    const long head0 = (long)b * S * stride + (long)h * HD;
    kb = k + head0;
    vb = v + head0;
  }

  // slab row r0 + r is chunk token (r0 + r) / G, head h * G + (r0 + r) % G;
  // rows past nrows (up to the m16 tile) are zero. 16-byte loads, four a
  // thread in flight before the first store.
  {
    constexpr int kQBatch = 4;
    const int nq = mt * 16 * VPR;
    for (int base = tid; base < nq; base += kThreads * kQBatch) {
      uint4 raw[kQBatch];
#pragma unroll
      for (int u = 0; u < kQBatch; ++u) {
        const int i = base + u * kThreads;
        const int r = i / VPR;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < nq && r < nrows) {
          const int row = r0 + r;
          const T* src = q + (((long)b * C + row / G) * H + (long)h * G + row % G) * HD;
          raw[u] = __ldg(reinterpret_cast<const uint4*>(src) + i % VPR);
        }
      }
#pragma unroll
      for (int u = 0; u < kQBatch; ++u) {
        const int i = base + u * kThreads;
        if (i < nq) {
          const T* vals = reinterpret_cast<const T*>(&raw[u]);
          const int o = (i / VPR) * QS + (i % VPR) * VW;
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            const Split x = kLo ? split_tf32(to_float(vals[e])) : exact_tf32(to_float(vals[e]));
            qhi[o + e] = x.hi;
            if constexpr (kLo) qlo[o + e] = x.lo;
          }
        }
      }
    }
  }
  for (int r = tid; r < mt * 16; r += kThreads) {
    sm_m[r] = kNegInf;
    sm_l[r] = 0.f;
    sm_alpha[r] = 1.f;
    qpos[r] = p + (r0 + min(r, nrows - 1)) / G;
  }
  if constexpr (PAGED) {  // row offsets of the first kStages tiles
    for (int i = tid; i < kStages * kTileK; i += kThreads) {
      const int u = t_begin + i / kTileK;
      const int j = u * kTileK + i % kTileK;
      if (u < t_end && j < S) {
        off[(u % kStages) * kTileK + i % kTileK] = rows.offset(rows.page(j), j);
      }
    }
  }
  __syncthreads();

  // copies of tile u into stage u % kStages, one commit group per tile
  // (empty past t_end, so wait_group counts stay uniform)
  auto issue = [&](int u) {
    if (!(kSkip & kSkipCopy) && u < t_end) {
      const int st = u % kStages;
      const int s0 = u * kTileK;
      T* dk = ring_k + st * kTileK * KS;
      T* dv = ring_v + st * kTileK * VS;
#pragma unroll
      for (int i = tid; i < kChunks; i += kThreads) {
        const int r = i / VPR;
        const int c = (i % VPR) * VW;
        const int j = s0 + r;
        long o = 0;
        if (j < S) {
          if constexpr (PAGED) {
            o = off[st * kTileK + r];
          } else {
            o = (long)j * stride;
          }
        }
        const int nbytes = j < S ? 16 : 0;
        cp_async16(dk + r * KS + c, kb + o + c, nbytes);
        cp_async16(dv + r * VS + c, vb + o + c, nbytes);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(t_begin + s);

  float acc[kMaxMT][kNW][4];
#pragma unroll
  for (int m = 0; m < kMaxMT; ++m)
#pragma unroll
    for (int jn = 0; jn < kNW; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][jn][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    issue(t + kStages - 1);
    // paged: the page of this thread's row of tile t + kStages, read now
    // and stored after P @ V, so its latency hides behind the tile's work
    const int jn_row = (t + kStages) * kTileK + tid;
    const bool has_next = PAGED && tid < kTileK && t + kStages < t_end && jn_row < S;
    int next_page = 0;
    if constexpr (PAGED) {
      if (has_next) next_page = rows.page(jn_row);
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile t landed for every thread

    const int st = t % kStages;
    const int s0 = t * kTileK;
    const T* tk = ring_k + st * kTileK * KS;
    const T* tv = ring_v + st * kTileK * VS;

    // scores: warp owns key n-tile nk and m-tiles mg, mg + kQKGroups, ...
    {
      const int nk = warp % kKeyNT;
      const int mg = warp / kKeyNT;
      // each product term in its own accumulator: three independent mma
      // chains where the warp has only one (row tile, key tile) pair
      constexpr int kTerms = kLo ? 3 : 1;
      float sacc[kQKM][kTerms][4];
#pragma unroll
      for (int i = 0; i < kQKM; ++i)
#pragma unroll
        for (int u = 0; u < kTerms; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[i][u][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ((kSkip & kSkipQK) ? 0 : HD); kk += 8) {
        const T* kr = tk + (nk * 8 + g) * KS + kk + tq;
        Split bk[2];
        if constexpr (kLo) {
          bk[0] = split_tf32(to_float(kr[0]));
          bk[1] = split_tf32(to_float(kr[4]));
        } else {
          bk[0] = exact_tf32(to_float(kr[0]));
          bk[1] = exact_tf32(to_float(kr[4]));
        }
#pragma unroll
        for (int i = 0; i < kQKM; ++i) {
          const int m = mg + i * kQKGroups;
          if (m < mt) {
            const int o = (m * 16 + g) * QS + kk + tq;  // Q split once, in the prologue
            Split a[4];
            a[0].hi = qhi[o];
            a[1].hi = qhi[o + 8 * QS];
            a[2].hi = qhi[o + 4];
            a[3].hi = qhi[o + 8 * QS + 4];
            if constexpr (kLo) {
              a[0].lo = qlo[o];
              a[1].lo = qlo[o + 8 * QS];
              a[2].lo = qlo[o + 4];
              a[3].lo = qlo[o + 8 * QS + 4];
            }
            mma_hi(sacc[i][0], a, bk);
            if constexpr (kLo) {
              mma_lo_hi(sacc[i][1], a, bk);
              mma_hi_lo(sacc[i][2], a, bk);
            }
          }
        }
      }
      // mask after the product: seen ? s * scale : -1e30
      const int j = nk * 8 + 2 * tq;
#pragma unroll
      for (int i = 0; i < kQKM; ++i) {
        const int m = mg + i * kQKGroups;
        if (m < mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = m * 16 + g + 8 * half;
            const int qp = qpos[r];
            float dot[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              dot[e] = sacc[i][0][2 * half + e];
              if constexpr (kLo) dot[e] += sacc[i][1][2 * half + e] + sacc[i][2][2 * half + e];
            }
            float2 val;
            const int kv0 = s0 + j;
            const int kv1 = kv0 + 1;
            val.x = kv0 <= qp && (window <= 0 || kv0 > qp - window) ? dot[0] * scale : kNegInf;
            val.y = kv1 <= qp && (window <= 0 || kv1 > qp - window) ? dot[1] * scale : kNegInf;
            *reinterpret_cast<float2*>(ss + r * kSStride + j) = val;
          }
        }
      }
    }
    __syncthreads();

    // running max / sum, 8 threads a row, 8 keys each; keys past the cache
    // (j >= jmax) take no part and get p = 0
    {
      const int c = tid % kThreadsPerRow;
      const int jmax = min(kTileK, S - s0);
      for (int r = tid / kThreadsPerRow; r < ((kSkip & kSkipSoftmax) ? 0 : mt * 16);
           r += kThreads / kThreadsPerRow) {
        constexpr int kV4 = kKeysPerThread / 4;
        const int j0 = kKeysPerThread * c;
        float x[kKeysPerThread];
#pragma unroll
        for (int u = 0; u < kV4; ++u) {
          const float4 sv = *reinterpret_cast<const float4*>(ss + r * kSStride + j0 + 4 * u);
          x[4 * u] = sv.x;
          x[4 * u + 1] = sv.y;
          x[4 * u + 2] = sv.z;
          x[4 * u + 3] = sv.w;
        }
        float mx = kNegInf;
#pragma unroll
        for (int e = 0; e < kKeysPerThread; ++e) {
          if (j0 + e < jmax) mx = fmaxf(mx, x[e]);
        }
#pragma unroll
        for (int o = kThreadsPerRow / 2; o > 0; o >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        const float m_old = sm_m[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        float hi[kKeysPerThread], lo[kKeysPerThread];
#pragma unroll
        for (int e = 0; e < kKeysPerThread; ++e) {
          x[e] = j0 + e < jmax ? expf(x[e] - m_new) : 0.f;
          sum += x[e];
          const Split pe = split_tf32(x[e]);  // P split once for every warp of P @ V
          hi[e] = __uint_as_float(pe.hi);
          lo[e] = __uint_as_float(pe.lo);
        }
#pragma unroll
        for (int u = 0; u < kV4; ++u) {
          *reinterpret_cast<float4*>(ss + r * kSStride + j0 + 4 * u) =
              make_float4(hi[4 * u], hi[4 * u + 1], hi[4 * u + 2], hi[4 * u + 3]);
          *reinterpret_cast<float4*>(plo + r * kSStride + j0 + 4 * u) =
              make_float4(lo[4 * u], lo[4 * u + 1], lo[4 * u + 2], lo[4 * u + 3]);
        }
#pragma unroll
        for (int o = kThreadsPerRow / 2; o > 0; o >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        }
        if (c == 0) {
          const float a = expf(m_old - m_new);
          sm_alpha[r] = a;
          sm_l[r] = a * sm_l[r] + sum;
          sm_m[r] = m_new;
        }
      }
    }
    __syncthreads();

    // acc = alpha * acc + P @ V: warp owns HD n-tiles warp, warp + 8, ...
#pragma unroll
    for (int m = 0; m < kMaxMT; ++m) {
      if (m < mt) {
        const float a0 = sm_alpha[m * 16 + g];
        const float a1 = sm_alpha[m * 16 + g + 8];
#pragma unroll
        for (int jn = 0; jn < kNW; ++jn) {
          acc[m][jn][0] *= a0;
          acc[m][jn][1] *= a0;
          acc[m][jn][2] *= a1;
          acc[m][jn][3] *= a1;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < ((kSkip & kSkipPV) ? 0 : kTileK); kk += 8) {
      Split bv[kNW][2];
#pragma unroll
      for (int jn = 0; jn < kNW; ++jn) {
        const int nv = warp + jn * kWarps;
        if (nv < kHDNT) {
          const T* vr = tv + (kk + tq) * VS + nv * 8 + g;
          if constexpr (kLo) {
            bv[jn][0] = split_tf32(to_float(vr[0]));
            bv[jn][1] = split_tf32(to_float(vr[4 * VS]));
          } else {
            bv[jn][0] = exact_tf32(to_float(vr[0]));
            bv[jn][1] = exact_tf32(to_float(vr[4 * VS]));
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kMaxMT; ++m) {
        if (m < mt) {
          const int o = (m * 16 + g) * kSStride + kk + tq;
          const Split a[4] = {{__float_as_uint(ss[o]), __float_as_uint(plo[o])},
                              {__float_as_uint(ss[o + 8 * kSStride]),
                               __float_as_uint(plo[o + 8 * kSStride])},
                              {__float_as_uint(ss[o + 4]), __float_as_uint(plo[o + 4])},
                              {__float_as_uint(ss[o + 8 * kSStride + 4]),
                               __float_as_uint(plo[o + 8 * kSStride + 4])}};
          // term-major over the warp's n-tiles: independent chains interleave
#pragma unroll
          for (int jn = 0; jn < kNW; ++jn) {
            if (warp + jn * kWarps < kHDNT) mma_lo_hi(acc[m][jn], a, bv[jn]);
          }
          if constexpr (kLo) {
#pragma unroll
            for (int jn = 0; jn < kNW; ++jn) {
              if (warp + jn * kWarps < kHDNT) mma_hi_lo(acc[m][jn], a, bv[jn]);
            }
          }
#pragma unroll
          for (int jn = 0; jn < kNW; ++jn) {
            if (warp + jn * kWarps < kHDNT) mma_hi(acc[m][jn], a, bv[jn]);
          }
        }
      }
    }
    if constexpr (PAGED) {
      if (has_next) off[(t % kStages) * kTileK + tid] = rows.offset(next_page, jn_row);
    }
    __syncthreads();  // the next issue overwrites stage t - 1, the next scores ss
  }

  // partials of (b, h, split) for rows r0 .. r0 + nrows - 1 of the slab
  const long part = ((long)b * KVH + h) * nsplit + split;
  for (int r = tid; r < nrows; r += kThreads) {
    part_ml[(part * R + r0 + r) * 2 + 0] = sm_m[r];
    part_ml[(part * R + r0 + r) * 2 + 1] = sm_l[r];
  }
#pragma unroll
  for (int m = 0; m < kMaxMT; ++m) {
    if (m < mt) {
#pragma unroll
      for (int jn = 0; jn < kNW; ++jn) {
        const int nv = warp + jn * kWarps;
        if (nv >= kHDNT) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m * 16 + g + 8 * half;
          if (r < nrows) {
            *reinterpret_cast<float2*>(part_acc + (part * R + r0 + r) * HD + nv * 8 + 2 * tq) =
                make_float2(acc[m][jn][2 * half], acc[m][jn][2 * half + 1]);
          }
        }
      }
    }
  }
}

// Merge of the splits that had tiles, per slab row: thread -> (row, 4 dims).
// Writes out (B, C, KVH * G, HD) in the model's layout.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
prefill_combine_kernel(const int* __restrict__ pos, const float* __restrict__ part_ml,
                       const float* __restrict__ part_acc, T* __restrict__ out, int S, int KVH,
                       int C, int G, int window, int nsplit, int row_tile) {
  constexpr int kLanes = HD / 4;  // threads per row
  constexpr int kRowsPer = kThreads / kLanes;  // 9 at HD 112, 6 at 160: threads 252.., 240.. idle
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int R = C * G;
  const int row = blockIdx.x * kRowsPer + threadIdx.x / kLanes;
  if (threadIdx.x >= kRowsPer * kLanes || row >= R) return;
  const int d = (threadIdx.x % kLanes) * 4;
  const int r0 = row / row_tile * row_tile;
  const int nrows = min(row_tile, R - r0);
  const int p = pos[b];
  const long part0 = ((long)b * KVH + h) * nsplit;
  int used = 0;  // splits are filled in order: the first empty one ends them
  float mx = kNegInf;
  for (int s = 0; s < nsplit; ++s) {
    int tb, te;
    split_tiles(p, r0, nrows, G, S, window, nsplit, s, &tb, &te);
    if (tb >= te) break;
    mx = fmaxf(mx, part_ml[((part0 + s) * R + row) * 2]);
    ++used;
  }
  float l = 0.f;
  float o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < used; ++s) {
    const long pr = (part0 + s) * R + row;
    const float w = expf(part_ml[pr * 2] - mx);
    l = fmaf(w, part_ml[pr * 2 + 1], l);
    const float4 a = *reinterpret_cast<const float4*>(part_acc + pr * HD + d);
    o[0] = fmaf(w, a.x, o[0]);
    o[1] = fmaf(w, a.y, o[1]);
    o[2] = fmaf(w, a.z, o[2]);
    o[3] = fmaf(w, a.w, o[3]);
  }
  const float den = fmaxf(l, 1e-30f);
  T* dst = out + (((long)b * C + row / G) * ((long)KVH * G) + (long)h * G + row % G) * HD + d;
#pragma unroll
  for (int e = 0; e < 4; ++e) store(dst + e, o[e] / den);
}

// Query rows per block: all C * G rows up to max_rows, else near-equal
// tiles of them, each a multiple of 16.
inline int row_tile_for(int R, int max_rows) {
  const int n = (R + max_rows - 1) / max_rows;
  return ((R + n - 1) / n + 15) / 16 * 16;
}

template <typename T, int HD, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos, void* out,
                   void* part_ml, void* part_acc, int B, const Layout& lay, int KVH, int C,
                   int G, int window, int nsplit, float scale, cudaStream_t stream) {
  static bool smem_set = false;  // one opt-in per instantiation, for the largest block
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(prefill_partial_kernel<T, HD, PAGED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Plan<T, HD>::bytes(Plan<T, HD>::kMaxRows));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int R = C * G;
  const int row_tile = row_tile_for(R, Plan<T, HD>::kMaxRows);
  const int row_tiles = (R + row_tile - 1) / row_tile;
  prefill_partial_kernel<T, HD, PAGED>
      <<<dim3(row_tiles * nsplit, KVH, B), kThreads, Plan<T, HD>::bytes(row_tile), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const int*>(pos), static_cast<float*>(part_ml),
          static_cast<float*>(part_acc), lay, KVH, C, G, window, nsplit, row_tile, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int kRowsPer = kThreads / (HD / 4);
  prefill_combine_kernel<T, HD><<<dim3((R + kRowsPer - 1) / kRowsPer, KVH, B), kThreads, 0,
                                  stream>>>(
      static_cast<const int*>(pos), static_cast<const float*>(part_ml),
      static_cast<const float*>(part_acc), static_cast<T*>(out), lay.S, KVH, C, G, window,
      nsplit, row_tile);
  return cudaGetLastError();
}

template <bool PAGED>
int dispatch(int dtype, int HD, const void* q, const void* k, const void* v, const void* pos,
             void* out, void* part_ml, void* part_acc, int B, const Layout& lay, int KVH,
             int C, int G, int window, int nsplit, float scale, void* stream) {
  if (B < 1 || lay.S < 1 || KVH < 1 || C < 1 || G < 1 || nsplit < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PREFILL_CASE(TYPE, DIM)                                                                \
  return (int)launch<TYPE, DIM, PAGED>(q, k, v, pos, out, part_ml, part_acc, B, lay, KVH, C, G, \
                                       window, nsplit, scale, st)
  if (dtype == 0) {
    switch (HD) {
      case 32: PREFILL_CASE(float, 32);
      case 64: PREFILL_CASE(float, 64);
      case 112: PREFILL_CASE(float, 112);
      case 128: PREFILL_CASE(float, 128);
      case 160: PREFILL_CASE(float, 160);
    }
  } else if (dtype == 1) {
    switch (HD) {
      case 32: PREFILL_CASE(__nv_bfloat16, 32);
      case 64: PREFILL_CASE(__nv_bfloat16, 64);
      case 112: PREFILL_CASE(__nv_bfloat16, 112);
      case 128: PREFILL_CASE(__nv_bfloat16, 128);
      case 160: PREFILL_CASE(__nv_bfloat16, 160);
    }
  }
#undef PREFILL_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q and out are (B, C, KVH * G, HD); pos (B,) int32; part_ml
// (B, KVH, nsplit, C * G, 2) and part_acc (B, KVH, nsplit, C * G, HD) f32
// scratch. window <= 0 means no sliding window. Each returns the
// cudaError_t of its two launches (0 on success); the kernels run
// asynchronously on `stream`.

// Query rows one block holds for a dtype and head dim (what fits in shared
// memory beside the ring, at most 160); 0 for an unsupported pair.
extern "C" int prefill_max_rows(int dtype, int HD) {
  if (dtype == 0) {
    switch (HD) {
      case 32: return Plan<float, 32>::kMaxRows;
      case 64: return Plan<float, 64>::kMaxRows;
      case 112: return Plan<float, 112>::kMaxRows;
      case 128: return Plan<float, 128>::kMaxRows;
      case 160: return Plan<float, 160>::kMaxRows;
    }
  } else if (dtype == 1) {
    switch (HD) {
      case 32: return Plan<__nv_bfloat16, 32>::kMaxRows;
      case 64: return Plan<__nv_bfloat16, 64>::kMaxRows;
      case 112: return Plan<__nv_bfloat16, 112>::kMaxRows;
      case 128: return Plan<__nv_bfloat16, 128>::kMaxRows;
      case 160: return Plan<__nv_bfloat16, 160>::kMaxRows;
    }
  }
  return 0;
}

// Dense: k and v (B, S, KVH, HD).
extern "C" int prefill_attention_launch(const void* q, const void* k, const void* v,
                                        const void* pos, void* out, void* part_ml,
                                        void* part_acc, int B, int S, int KVH, int C, int G,
                                        int HD, int window, int nsplit, float scale, int dtype,
                                        void* stream) {
  const Layout lay{nullptr, S, 0, 0, 0};
  return dispatch<false>(dtype, HD, q, k, v, pos, out, part_ml, part_acc, B, lay, KVH, C, G,
                         window, nsplit, scale, stream);
}

// Paged: k_pool and v_pool (NB, BS, KVH, HD); table (B, MB) int32 physical
// block ids (clamped to [0, NB - 1] on read).
extern "C" int paged_prefill_attention_launch(const void* q, const void* k_pool,
                                              const void* v_pool, const void* table,
                                              const void* pos, void* out, void* part_ml,
                                              void* part_acc, int B, int MB, int BS, int NB,
                                              int KVH, int C, int G, int HD, int window,
                                              int nsplit, float scale, int dtype,
                                              void* stream) {
  if (table == nullptr || MB < 1 || BS < 1 || NB < 1) return (int)cudaErrorInvalidValue;
  const Layout lay{static_cast<const int*>(table), MB * BS, MB, BS, NB};
  return dispatch<true>(dtype, HD, q, k_pool, v_pool, pos, out, part_ml, part_acc, B, lay, KVH,
                        C, G, window, nsplit, scale, stream);
}
