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
// (K/V bytes up to pos, plus the table when paged) / 3.35 TB/s.
//
// Design against that bound:
//  * Only the tiles holding visible keys are read: a block starts at the
//    window's first tile and stops at the tile holding pos[b] (exact, see
//    key_range in attention_tile.cuh). Ragged slots read only their prefix;
//    paged, the pages past pos are never touched.
//  * The TPU walks S sequentially in one grid row; here S is split
//    (flash-decoding): grid (nsplit, KVH, B), each block runs the online
//    softmax over its share of the visible tiles and writes a partial
//    (max, sum, acc). At B = 4, KVH = 16 a grid of (b, h) alone is 64 blocks
//    for 132 SMs; the wrapper picks nsplit so about two blocks land on every
//    SM. A second, small kernel merges the partials:
//      M = max_i m_i,  out = sum_i e^{m_i - M} acc_i / max(sum_i e^{m_i - M} l_i, 1e-30).
//    Paged, the splits are taken over the logical key range, as dense.
//  * All G query heads of a KV head share one pass over its K/V tiles.
//  * Tiles land in shared memory through 16-byte coalesced loads and are
//    widened to f32 there; all arithmetic is f32 FMAs on the CUDA cores
//    (no tensor cores: at G <= 16 rows the product is too skinny to pay).
//    Paged, each tile's 64 rows are found through the table once, into
//    shared memory, while the tile before computes (attend_tiles), so a
//    64-key tile may span several pages of any block size.
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

template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ pos,
                      float* __restrict__ part_ml, float* __restrict__ part_acc, Layout lay,
                      int KVH, int G, int window, float scale) {
  extern __shared__ float4 smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int p = pos[b];
  const int S = lay.S;

  // q is (B, 1, KVH * G, HD): the G heads of group h are contiguous
  const T* qb = q + ((long)b * KVH + h) * G * HD;
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD;
    sm.q[r][i % HD] = r < G ? to_float(qb[i]) : 0.f;
  }
  if (tid < kRows) {
    sm.m[tid] = kNegInf;
    sm.l[tid] = 0.f;
    sm.qpos[tid] = p;
  }
  int lo, hi;
  key_range(p, p, S, window, &lo, &hi);
  const int t_lo = lo / kTileS;
  const int ntiles = hi / kTileS - t_lo + 1;
  const int per = (ntiles + nsplit - 1) / nsplit;
  const int t_begin = t_lo + split * per;
  const int t_end = min(t_lo + ntiles, t_begin + per);  // empty split: no tiles
  __syncthreads();

  float acc[kRows * HD / kThreads];
#pragma unroll
  for (int i = 0; i < kRows * HD / kThreads; ++i) acc[i] = 0.f;
  const long stride = (long)KVH * HD;
  if constexpr (PAGED) {
    const int* tb = lay.table + (long)b * lay.mb;
    const PagedRows rows{stride, tb, lay.bs, lay.nb};
    attend_tiles<T, HD>(sm, k + (long)h * HD, v + (long)h * HD, rows, S, G, t_begin, t_end,
                        window, scale, acc);
  } else {
    const long head0 = (long)b * S * stride + (long)h * HD;
    const DenseRows rows{stride};
    attend_tiles<T, HD>(sm, k + head0, v + head0, rows, S, G, t_begin, t_end, window, scale,
                        acc);
  }
  __syncthreads();

  // partials of slot (b, h, split): rows padded to kRows
  const long part = ((long)b * KVH + h) * nsplit + split;
  if (tid < G) {
    part_ml[(part * kRows + tid) * 2 + 0] = sm.m[tid];
    part_ml[(part * kRows + tid) * 2 + 1] = sm.l[tid];
  }
  constexpr int kOStep = kThreads / HD;
#pragma unroll
  for (int i = 0; i < kRows * HD / kThreads; ++i) {
    const int r = tid / HD + i * kOStep;
    if (r < G) part_acc[(part * kRows + r) * HD + tid % HD] = acc[i];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                      T* __restrict__ out, int KVH, int G, int nsplit) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long part0 = ((long)b * KVH + h) * nsplit;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    float mx = kNegInf;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_ml[((part0 + s) * kRows + r) * 2]);
    float l = 0.f;
    float o = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const long pr = (part0 + s) * kRows + r;
      const float w = expf(part_ml[pr * 2] - mx);
      l = fmaf(w, part_ml[pr * 2 + 1], l);
      o = fmaf(w, part_acc[pr * HD + d], o);
    }
    // out is (B, 1, KVH * G, HD), like q
    store(out + (((long)b * KVH + h) * G + r) * HD + d, o / fmaxf(l, 1e-30f));
  }
}

template <typename T, int HD, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos, void* out,
                   void* part_ml, void* part_acc, int B, const Layout& lay, int KVH, int G,
                   int window, int nsplit, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<HD>);
  static bool smem_set = false;  // one opt-in per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(decode_partial_kernel<T, HD, PAGED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  decode_partial_kernel<T, HD, PAGED><<<dim3(nsplit, KVH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), lay, KVH, G, window, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T, HD><<<dim3(KVH, B), kThreads, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), KVH, G, nsplit);
  return cudaGetLastError();
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
      case 128: DECODE_CASE(float, 128);
    }
  } else if (dtype == 1) {
    switch (HD) {
      case 32: DECODE_CASE(__nv_bfloat16, 32);
      case 64: DECODE_CASE(__nv_bfloat16, 64);
      case 128: DECODE_CASE(__nv_bfloat16, 128);
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
