// Chunked flash prefill for Hopper (sm_90a): a (B, C) chunk of queries
// against the KV cache prefix, dense or paged, every slot at its own offset.
//
// Replaces the TPU kernels prefill_attention_pallas (_prefill_kernel) and
// paged_prefill_attention_pallas (_paged_prefill_kernel) in
// src/repro/kernels/prefill_attention/kernel.py. Same function: the C * G
// query rows of slot b and KV head h form a slab; row r is chunk token
// i = r / G at absolute position pos[b] + i and reads
// kv <= pos[b] + i [and kv > pos[b] + i - window], so in-chunk causality
// falls out of the same mask. f32 accumulation, -1e30 finite mask. Paged, kv
// is a logical row of the slot, read from pool[table[b, kv / BS], kv % BS].
//
// What bounds it on the H100: at the main path's shapes (C = 32, HD = 128,
// S = 1024) a (b, h) does 4 * C * G * HD flops per key row it reads
// (2 * HD elements), i.e. C * G / 2 flops per byte in f32: 16 for OLMo-1B
// (G = 1) and 80 for Qwen2.5-14B (G = 5) against the card's 20 f32 CUDA-core
// flops per byte. So it sits near the ridge: bytes bound it at G = 1, f32
// flops at G = 5 (bf16 inputs halve the bytes and, on tensor cores, would
// raise the flop roof 15x -- work for a later kernel).
//
// Design:
//  * One block per (tile of 16 slab rows, KV head, slot): grid
//    (ceil(C * G / 16), KVH, B). The rows of one block share every K/V tile
//    they load, and the blocks of one (b, h) re-read the same prefix through
//    the 50 MB L2.
//  * G is padded inside the kernel, not by the caller: row r maps to head
//    h * G + r % G of chunk token r / G in the model's (B, C, H, HD) layout,
//    so r / G stays exact for any G (G = 5 for Qwen2.5-14B) and q / out need
//    no transpose or padding copy.
//  * A block visits only the tiles from the first row's window start to the
//    last row's position (exact, see key_range in attention_tile.cuh); paged,
//    over logical rows, so pages past the chunk are never touched.
//  * Tiles land in shared memory through 16-byte coalesced loads, widened to
//    f32; scores and p @ V are f32 FMAs on the CUDA cores. Paged, each
//    tile's rows are found through the table once, while the tile before
//    computes (attend_tiles).
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
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ pos, T* __restrict__ out, Layout lay, int KVH, int C,
               int G, int window, float scale) {
  extern __shared__ float4 smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;  // first slab row of this block
  const int nrows = min(kRows, C * G - r0);
  const int p = pos[b];
  const long H = (long)KVH * G;
  const int S = lay.S;

  // slab row r0 + r is chunk token (r0 + r) / G, head h * G + (r0 + r) % G
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    float x = 0.f;
    if (r < nrows) {
      const int row = r0 + r;
      x = to_float(q[(((long)b * C + row / G) * H + (long)h * G + row % G) * HD + d]);
    }
    sm.q[r][d] = x;
  }
  if (tid < kRows) {
    sm.m[tid] = kNegInf;
    sm.l[tid] = 0.f;
    sm.qpos[tid] = p + (r0 + min(tid, nrows - 1)) / G;
  }
  int lo, hi;
  key_range(p + r0 / G, p + (r0 + nrows - 1) / G, S, window, &lo, &hi);
  __syncthreads();

  float acc[kRows * HD / kThreads];
#pragma unroll
  for (int i = 0; i < kRows * HD / kThreads; ++i) acc[i] = 0.f;
  const long stride = (long)KVH * HD;
  if constexpr (PAGED) {
    const int* tb = lay.table + (long)b * lay.mb;
    const PagedRows rows{stride, tb, lay.bs, lay.nb};
    attend_tiles<T, HD>(sm, k + (long)h * HD, v + (long)h * HD, rows, S, nrows, lo / kTileS,
                        hi / kTileS + 1, window, scale, acc);
  } else {
    const long head0 = (long)b * S * stride + (long)h * HD;
    const DenseRows rows{stride};
    attend_tiles<T, HD>(sm, k + head0, v + head0, rows, S, nrows, lo / kTileS, hi / kTileS + 1,
                        window, scale, acc);
  }
  __syncthreads();

  constexpr int kOStep = kThreads / HD;
#pragma unroll
  for (int i = 0; i < kRows * HD / kThreads; ++i) {
    const int r = tid / HD + i * kOStep;
    if (r < nrows) {
      const int row = r0 + r;
      const float o = acc[i] / fmaxf(sm.l[r], 1e-30f);
      store(out + (((long)b * C + row / G) * H + (long)h * G + row % G) * HD + tid % HD, o);
    }
  }
}

template <typename T, int HD, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos, void* out,
                   int B, const Layout& lay, int KVH, int C, int G, int window, float scale,
                   cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<HD>);
  static bool smem_set = false;  // one opt-in per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(prefill_kernel<T, HD, PAGED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int row_tiles = (C * G + kRows - 1) / kRows;
  prefill_kernel<T, HD, PAGED><<<dim3(row_tiles, KVH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<T*>(out), lay, KVH, C, G, window, scale);
  return cudaGetLastError();
}

template <bool PAGED>
int dispatch(int dtype, int HD, const void* q, const void* k, const void* v, const void* pos,
             void* out, int B, const Layout& lay, int KVH, int C, int G, int window,
             float scale, void* stream) {
  if (B < 1 || lay.S < 1 || KVH < 1 || C < 1 || G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PREFILL_CASE(TYPE, DIM) \
  return (int)launch<TYPE, DIM, PAGED>(q, k, v, pos, out, B, lay, KVH, C, G, window, scale, st)
  if (dtype == 0) {
    switch (HD) {
      case 32: PREFILL_CASE(float, 32);
      case 64: PREFILL_CASE(float, 64);
      case 128: PREFILL_CASE(float, 128);
    }
  } else if (dtype == 1) {
    switch (HD) {
      case 32: PREFILL_CASE(__nv_bfloat16, 32);
      case 64: PREFILL_CASE(__nv_bfloat16, 64);
      case 128: PREFILL_CASE(__nv_bfloat16, 128);
    }
  }
#undef PREFILL_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q and out are (B, C, KVH * G, HD); pos (B,) int32. window <= 0 means no
// sliding window. Each returns the cudaError_t of its launch (0 on success);
// the kernel runs asynchronously on `stream`.

// Dense: k and v (B, S, KVH, HD).
extern "C" int prefill_attention_launch(const void* q, const void* k, const void* v,
                                        const void* pos, void* out, int B, int S, int KVH,
                                        int C, int G, int HD, int window, float scale,
                                        int dtype, void* stream) {
  const Layout lay{nullptr, S, 0, 0, 0};
  return dispatch<false>(dtype, HD, q, k, v, pos, out, B, lay, KVH, C, G, window, scale,
                         stream);
}

// Paged: k_pool and v_pool (NB, BS, KVH, HD); table (B, MB) int32 physical
// block ids (clamped to [0, NB - 1] on read).
extern "C" int paged_prefill_attention_launch(const void* q, const void* k_pool,
                                              const void* v_pool, const void* table,
                                              const void* pos, void* out, int B, int MB,
                                              int BS, int NB, int KVH, int C, int G, int HD,
                                              int window, float scale, int dtype,
                                              void* stream) {
  if (table == nullptr || MB < 1 || BS < 1 || NB < 1) return (int)cudaErrorInvalidValue;
  const Layout lay{static_cast<const int*>(table), MB * BS, MB, BS, NB};
  return dispatch<true>(dtype, HD, q, k_pool, v_pool, pos, out, B, lay, KVH, C, G, window,
                        scale, stream);
}
