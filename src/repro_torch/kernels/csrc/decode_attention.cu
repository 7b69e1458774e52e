// Flash decode for Hopper (sm_90a): one query token per slot against a dense
// KV cache or a paged KV pool, every slot at its own position.
//
// Replaces the TPU kernels decode_attention_pallas (_decode_kernel) and
// paged_decode_attention_pallas (_paged_decode_kernel) in
// src/repro/kernels/decode_attention/kernel.py. Same function: for slot b,
// KV head h and the G query heads of its group,
//   out = softmax(q . k[kv] / sqrt(HD), kv <= pos[b] [and kv > pos[b] - window]) @ v
// with f32 accumulation and the -1e30 finite mask. Paged, kv is a logical row
// of the slot, read from pool[table[b, kv / BS], kv % BS].
//
// What bounds it on the H100: bytes. Each (b, h) reads its K and V rows up to
// pos[b] once and does 4 * G * HD flops per key row of 2 * HD elements, i.e.
// G / 2 flops per byte in f32 (G in bf16) -- far below the card's 20 f32
// flops per byte (67 TFLOP/s over 3.35 TB/s), so the floor is
// (K/V bytes up to pos, plus the table when paged) / 3.35 TB/s. Tensor cores
// would not move that floor, so the products stay on the CUDA cores; TMA is
// not used because a tensor map cannot follow a block table row by row.
//
// What held the earlier body (one 4-warp block loading a 64-key tile through
// registers, then scores, softmax and P @ V, each phase behind a block
// barrier) was latency: nothing was in flight while a tile computed, and at
// G = 1 half the threads scored nothing and three warps of four sat out the
// softmax. This design:
//  * Only the tiles holding visible keys are read: a slot's blocks start at
//    the window's first tile and stop at the tile holding pos[b] (exact, see
//    key_range in attention_tile.cuh). Ragged slots read only their prefix;
//    paged, the pages past pos are never touched.
//  * The visible tiles (kTileS keys) of each (b, h) are split into nsplit
//    near-equal runs, on the device from pos (decode_split): grid
//    (nsplit, KVH, B), so the split needs no host sync. An empty split
//    returns at once and writes nothing; the merge knows from pos which
//    splits had tiles. The wrapper picks nsplit from the shapes and from how
//    many blocks of this kernel an SM holds (decode_geometry).
//  * Inside a block each warp streams its own chunk of every tile through
//    its own cp.async ring and runs its own online softmax with all 32
//    lanes (attend_chunks in attention_tile.cuh); no block barrier inside
//    the tile loop. At the end the block merges its warps' (m, l, acc) once
//    and writes one partial per split. Paged, each lane resolves one row of
//    its warp's next chunk through the table one issue ahead of the copies.
//  * All G query heads of a KV head share one pass over its K/V chunks.
//  * Head dims 32, 64, 112, 128 and 160. A head dim that is no power of two
//    (Zamba2's 112, Pixtral's 160) runs at the next one inside the block
//    (padded_dim in attention_tile.cuh): q, K and V rows land zero-padded in
//    shared memory (the padding copies read nothing), so the lane mappings
//    stay the power-of-two ones; the partials and the output keep HD-long
//    rows, and the lanes that would hold dims past HD write nothing. At 160
//    (padded to 256) each lane of P @ V holds two groups of 4 dims, 128
//    apart, and the merge's lanes 8 floats each; the block takes 213,504 B of
//    shared memory in f32 (one block per SM) and 107,008 B in bf16 (two).
//  * The merge is a second kernel with one warp per (row, KV head, slot):
//    lanes read the splits' (m, l) once each, lanes over HD sum the
//    weighted accumulators,
//      M = max_s m_s,  out = sum_s e^{m_s - M} acc_s / max(sum_s e^{m_s - M} l_s, 1e-30).
//    A split whose keys are all masked for a row has m = -1e30: weight 0
//    once another split saw a key, and 1 everywhere for a row that sees no
//    key, which so averages all S rows, as the reference does.
//
// What holds it now (H100, OLMo-1B's decode shape; scripts/decode_probe.py):
// a call takes a little over twice the byte bound. The partial kernel alone
// runs at about 60 % of the bound; the rest is the merge (its read of pos,
// then of the partials, ~2.5 us) and the gap between the two launches.
// Launching the merge as a programmatic dependent of the partial kernel hid
// 1-2 us of that gap in CUDA-graph replays, but folds its wait into the
// merge's own device time; it is left for the CUDA-graph capture of the
// serving tick.
#include "attention_tile.cuh"

using namespace attn;

namespace {

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

// The tiles split `split` of `nsplit` walks for a slot at pos p:
// [t_begin, t_end) in units of kTileS keys (empty when t_begin >= t_end),
// and how many of the nsplit splits hold tiles (they are filled in order).
// The partial and combine kernels both call it, so they agree.
__device__ __forceinline__ int decode_split(int p, int S, int window, int nsplit, int split,
                                            int* t_begin, int* t_end) {
  int lo, hi;
  key_range(p, p, S, window, &lo, &hi);
  const int t_lo = lo / kTileS;
  const int ntiles = hi / kTileS - t_lo + 1;
  const int per = (ntiles + nsplit - 1) / nsplit;
  *t_begin = t_lo + split * per;
  *t_end = min(t_lo + ntiles, *t_begin + per);
  return (ntiles + per - 1) / per;
}

// One split of the visible key tiles of (slot b, KV head h) for its G query
// rows: the online softmax over tiles [t_begin, t_end), written as partial
// (m, l) to part_ml (B, KVH, nsplit, kRows, 2) and the unnormalised
// accumulator to part_acc (B, KVH, nsplit, kRows, HD).
template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ pos,
                      float* __restrict__ part_ml, float* __restrict__ part_acc, Layout lay,
                      int KVH, int G, int window, float scale) {
  using P = DecodePlan<T, HD>;
  constexpr int DP = P::DP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);                                   // [kRows][DP]
  T* rings = reinterpret_cast<T*>(smem + P::kQBytes);                   // per warp
  float* wacc = reinterpret_cast<float*>(smem + P::kQBytes);            // aliases the rings
  float* wm = reinterpret_cast<float*>(smem + P::kQBytes + P::kShared);  // [kWarps][kRows]
  float* wl = wm + kWarps * kRows;
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int S = lay.S;

  // q is (B, 1, KVH * G, HD): the G heads of group h are contiguous. Its
  // copies go out before pos is read, so the two latencies overlap; the
  // first K/V copies go out before q is waited for (attend_chunks). Row r
  // lands at r * DP, pieces past HD zero-filled.
  const T* qb = q + ((long)b * KVH + h) * G * HD;
  for (int i = tid; i < G * P::VPR; i += kThreads) {
    const int r = i / P::VPR;
    const int pc = i % P::VPR;
    const bool in = pc < P::kHDPieces;
    cp_async16(qs + r * DP + pc * P::VW, qb + (in ? r * HD + pc * P::VW : 0), in ? 16 : 0);
  }
  cp_async_commit();
  const int p = pos[b];
  int t_begin, t_end;
  decode_split(p, S, window, nsplit, split, &t_begin, &t_end);
  if (t_begin >= t_end) {  // an empty split: the merge skips it
    cp_async_wait<0>();
    return;
  }

  float m[kRows], l[kRows], acc[kRows][4 * P::kVG];
  T* ring = rings + warp * P::kWarpRingElems;
  const long stride = (long)KVH * HD;
  if constexpr (PAGED) {
    const PagedRows rows{stride, lay.table + (long)b * lay.mb, lay.bs, lay.nb};
    attend_chunks<T, HD>(ring, qs, k + (long)h * HD, v + (long)h * HD, rows, S, G, t_begin,
                         t_end, p, window, scale, m, l, acc);
  } else {
    const long head0 = (long)b * S * stride + (long)h * HD;
    const DenseRows rows{stride};
    attend_chunks<T, HD>(ring, qs, k + head0, v + head0, rows, S, G, t_begin, t_end, p, window,
                         scale, m, l, acc);
  }
  cp_async_wait<0>();  // only empty groups remain; the rings become wacc
  __syncthreads();

  // each warp's partial into shared memory, then one merge over the warps
  if (lane < P::kLPR) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < G) {
#pragma unroll
        for (int g = 0; g < P::kVG; ++g) {
          *reinterpret_cast<float4*>(wacc + (warp * kRows + r) * DP + 4 * (lane + P::kLPR * g)) =
              make_float4(acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2], acc[r][4 * g + 3]);
        }
      }
    }
  }
  if (lane == 0) {  // m and l are the same in every lane
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < G) {
        wm[warp * kRows + r] = m[r];
        wl[warp * kRows + r] = l[r];
      }
    }
  }
  __syncthreads();

  // the merged partial's HD dims (the zero dims past HD stay behind)
  const long part = ((long)b * KVH + h) * nsplit + split;
  constexpr int kOutLanes = HD / 4;
  for (int i = tid; i < G * kOutLanes; i += kThreads) {
    const int r = i / kOutLanes;
    const int d = 4 * (i % kOutLanes);
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kRows + r]);
    float ls = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(wm[w * kRows + r] - mx);
      ls = fmaf(e, wl[w * kRows + r], ls);
      const float4 a = *reinterpret_cast<const float4*>(wacc + (w * kRows + r) * DP + d);
      o.x = fmaf(e, a.x, o.x);
      o.y = fmaf(e, a.y, o.y);
      o.z = fmaf(e, a.z, o.z);
      o.w = fmaf(e, a.w, o.w);
    }
    *reinterpret_cast<float4*>(part_acc + (part * kRows + r) * HD + d) = o;
    if (d == 0) *reinterpret_cast<float2*>(part_ml + (part * kRows + r) * 2) = make_float2(mx, ls);
  }
}

// kPer consecutive floats of global memory (kPer = 1, 2, 4 or 8; src
// aligned to the load's width).
template <int kPer>
__device__ __forceinline__ void load_floats(const float* src, float (&x)[kPer]) {
  static_assert(kPer == 1 || kPer == 2 || kPer == 4 || kPer == 8, "a width load_floats reads");
  if constexpr (kPer == 8) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (kPer == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (kPer == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = *src;
  }
}

// Merge of the splits that had tiles: one warp per (row r, KV head h, slot
// b), grid (G, KVH, B). Lane s holds split s's (m, l) (32 splits at a time,
// each read once) and its weight e^{m_s - M}; every lane sums the weighted
// accumulators over its DP / 32 dims (the lanes whose dims lie past HD, at
// a head dim that is no power of two, load and store nothing). The (m, l) of the first 32 splits
// and the accumulators of the first kBatch are loaded together with pos,
// before the number of splits that had tiles is known: a split past them
// holds no partial, so its values are read (the scratch is nsplit long) but
// never used. Later loads take only the splits that had tiles. Writes out
// (B, 1, KVH * G, HD).
template <typename T, int HD>
__global__ void __launch_bounds__(32)
decode_combine_kernel(const int* __restrict__ pos, const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc, T* __restrict__ out, int S, int KVH,
                      int G, int window, int nsplit) {
  constexpr int kPer = padded_dim(HD) / 32;
  constexpr int kBatch = 16;  // splits whose accumulators are in flight at once
  static_assert(HD % kPer == 0, "each lane's dims lie wholly inside or past HD");
  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x;
  const bool has_dims = lane * kPer < HD;  // true for every lane at HD = DP
  const int p = pos[b];
  const long part0 = ((long)b * KVH + h) * nsplit;
  const float* ml0 = part_ml + (part0 * kRows + r) * 2;                // split s: + s * kRows * 2
  const float* acc0 = part_acc + (part0 * kRows + r) * HD + lane * kPer;  // + s * kRows * HD
  float mx = kNegInf;
  float ls = 0.f;
  float o[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) o[e] = 0.f;
  int used = -1;
  for (int s0 = 0; s0 < nsplit; s0 += 32) {
    const int n = min(32, nsplit - s0);
    float2 ml = make_float2(kNegInf, 0.f);
    if (lane < n) ml = *reinterpret_cast<const float2*>(ml0 + (long)(s0 + lane) * kRows * 2);
    for (int b0 = 0; b0 < n; b0 += kBatch) {
      // the first batch is loaded before `used` is known; later ones only
      // where splits had tiles
      const int nload = used < 0 ? n : min(max(used - s0, 0), n);
      if (b0 >= nload) break;
      float x[kBatch][kPer];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (b0 + i < nload && has_dims) {
          load_floats<kPer>(acc0 + (long)(s0 + b0 + i) * kRows * HD, x[i]);
        }
      }
      if (used < 0) {  // once, after the first loads are out
        int tb, te;
        used = decode_split(p, S, window, nsplit, 0, &tb, &te);
      }
      const int nu = min(max(used - s0, 0), n);  // splits of this group that had tiles
      if (b0 == 0) {
        if (lane >= nu) ml = make_float2(kNegInf, 0.f);
        const float m_new = fmaxf(mx, warp_max(ml.x));
        const float a = expf(mx - m_new);  // rescales the earlier groups of 32
        ml.x = lane < nu ? expf(ml.x - m_new) : 0.f;  // now the split's weight
        ls = a * ls + warp_sum(ml.x * ml.y);
#pragma unroll
        for (int e = 0; e < kPer; ++e) o[e] *= a;
        mx = m_new;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int sl = b0 + i;  // < 32
        const float w = __shfl_sync(0xffffffffu, ml.x, sl & 31);
        if (sl < nu) {
#pragma unroll
          for (int e = 0; e < kPer; ++e) o[e] = fmaf(w, x[i][e], o[e]);
        }
      }
    }
  }
  if (!has_dims) return;
  const float den = fmaxf(ls, 1e-30f);
  T* dst = out + (((long)b * KVH + h) * G + r) * HD + lane * kPer;
#pragma unroll
  for (int e = 0; e < kPer; ++e) store(dst + e, o[e] / den);
}

// Opt the partial kernel into its shared memory once per instantiation.
template <typename T, int HD, bool PAGED>
cudaError_t prepare() {
  static bool done = false;
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(decode_partial_kernel<T, HD, PAGED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               DecodePlan<T, HD>::kBytes);
    if (e != cudaSuccess) return e;
    done = true;
  }
  return cudaSuccess;
}

template <typename T, int HD, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos, void* out,
                   void* part_ml, void* part_acc, int B, const Layout& lay, int KVH, int G,
                   int window, int nsplit, float scale, cudaStream_t stream) {
  cudaError_t e = prepare<T, HD, PAGED>();
  if (e != cudaSuccess) return e;
  decode_partial_kernel<T, HD, PAGED>
      <<<dim3(nsplit, KVH, B), kThreads, DecodePlan<T, HD>::kBytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const int*>(pos), static_cast<float*>(part_ml),
          static_cast<float*>(part_acc), lay, KVH, G, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T, HD><<<dim3(G, KVH, B), 32, 0, stream>>>(
      static_cast<const int*>(pos), static_cast<const float*>(part_ml),
      static_cast<const float*>(part_acc), static_cast<T*>(out), lay.S, KVH, G, window, nsplit);
  return cudaGetLastError();
}

// Blocks of the partial kernel one SM holds (shared memory, registers).
template <typename T, int HD, bool PAGED>
cudaError_t blocks_per_sm(int* n) {
  const cudaError_t e = prepare<T, HD, PAGED>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, decode_partial_kernel<T, HD, PAGED>,
                                                       kThreads, DecodePlan<T, HD>::kBytes);
}

template <bool PAGED>
int dispatch(int dtype, int HD, const void* q, const void* k, const void* v, const void* pos,
             void* out, void* part_ml, void* part_acc, int B, const Layout& lay, int KVH,
             int G, int window, int nsplit, float scale, void* stream) {
  if (B < 1 || lay.S < 1 || KVH < 1 || G < 1 || G > kRows || nsplit < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DECODE_CASE(TYPE, DIM)                                                              \
  return (int)launch<TYPE, DIM, PAGED>(q, k, v, pos, out, part_ml, part_acc, B, lay, KVH, G, \
                                       window, nsplit, scale, st)
  if (dtype == 0) {
    switch (HD) {
      case 32: DECODE_CASE(float, 32);
      case 64: DECODE_CASE(float, 64);
      case 112: DECODE_CASE(float, 112);
      case 128: DECODE_CASE(float, 128);
      case 160: DECODE_CASE(float, 160);
    }
  } else if (dtype == 1) {
    switch (HD) {
      case 32: DECODE_CASE(__nv_bfloat16, 32);
      case 64: DECODE_CASE(__nv_bfloat16, 64);
      case 112: DECODE_CASE(__nv_bfloat16, 112);
      case 128: DECODE_CASE(__nv_bfloat16, 128);
      case 160: DECODE_CASE(__nv_bfloat16, 160);
    }
  }
#undef DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// part_ml: (B, KVH, nsplit, 16, 2) f32, part_acc: (B, KVH, nsplit, 16, HD) f32
// scratch. window <= 0 means no sliding window. Each returns the cudaError_t
// of its launches (0 on success); the kernels run asynchronously on `stream`.

// The split geometry of a dtype and head dim: keys per tile (the unit the
// split divides) and blocks of the partial kernel one SM holds.
extern "C" int decode_geometry(int dtype, int HD, int paged, int* tile_keys,
                               int* blocks_per_sm_out) {
  *tile_keys = kTileS;
#define GEOMETRY_CASE(TYPE, DIM)                                                    \
  return (int)(paged ? blocks_per_sm<TYPE, DIM, true>(blocks_per_sm_out)           \
                     : blocks_per_sm<TYPE, DIM, false>(blocks_per_sm_out))
  if (dtype == 0) {
    switch (HD) {
      case 32: GEOMETRY_CASE(float, 32);
      case 64: GEOMETRY_CASE(float, 64);
      case 112: GEOMETRY_CASE(float, 112);
      case 128: GEOMETRY_CASE(float, 128);
      case 160: GEOMETRY_CASE(float, 160);
    }
  } else if (dtype == 1) {
    switch (HD) {
      case 32: GEOMETRY_CASE(__nv_bfloat16, 32);
      case 64: GEOMETRY_CASE(__nv_bfloat16, 64);
      case 112: GEOMETRY_CASE(__nv_bfloat16, 112);
      case 128: GEOMETRY_CASE(__nv_bfloat16, 128);
      case 160: GEOMETRY_CASE(__nv_bfloat16, 160);
    }
  }
#undef GEOMETRY_CASE
  return (int)cudaErrorInvalidValue;
}

// Dense: q and out (B, 1, KVH * G, HD); k and v (B, S, KVH, HD); pos (B,).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* part_ml,
                                       void* part_acc, int B, int S, int KVH, int G, int HD,
                                       int window, int nsplit, float scale, int dtype,
                                       void* stream) {
  const Layout lay{nullptr, S, 0, 0, 0};
  return dispatch<false>(dtype, HD, q, k, v, pos, out, part_ml, part_acc, B, lay, KVH, G,
                         window, nsplit, scale, stream);
}

// Paged: k_pool and v_pool (NB, BS, KVH, HD); table (B, MB) int32 physical
// block ids (clamped to [0, NB - 1] on read); q, out and pos as dense.
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const void* table,
                                             const void* pos, void* out, void* part_ml,
                                             void* part_acc, int B, int MB, int BS, int NB,
                                             int KVH, int G, int HD, int window, int nsplit,
                                             float scale, int dtype, void* stream) {
  if (table == nullptr || MB < 1 || BS < 1 || NB < 1) return (int)cudaErrorInvalidValue;
  const Layout lay{static_cast<const int*>(table), MB * BS, MB, BS, NB};
  return dispatch<true>(dtype, HD, q, k_pool, v_pool, pos, out, part_ml, part_acc, B, lay,
                        KVH, G, window, nsplit, scale, stream);
}
