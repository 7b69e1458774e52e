// Graph mixing for Hopper (sm_90a): the paper's neighbour-averaging
// contraction over task-stacked parameters,
//   out[i, j] = sum_k mu[k, i] * theta[k, j]      (out = mu^T @ theta)
// with mu (m, m) f32, theta and out (m, d) f32 or bf16, f32 accumulation and
// one rounding to theta's dtype on store.
//
// Replaces the TPU kernel graph_mix_pallas (_graph_mix_kernel) in
// src/repro/kernels/graph_mix/kernel.py. The TPU kernel keeps the whole
// padded mu resident in VMEM and walks d in 512-wide tiles. At m = 256 that
// mu is 256 KB of f32, more than the 227 KB of shared memory a Hopper block
// can have, so this kernel tiles the contraction over k instead.
//
// What bounds it on the H100: operations. One call does 2 m^2 d flops over
// (m d) elements read and written, m / 4 flops per byte in f32: at m = 256,
// 64 flops per byte, above the card's ~20 f32 flops per byte (67 TFLOP/s on
// the CUDA cores over 3.35 TB/s). It stays in f32 FMAs (no TF32 tensor
// cores): the reference holds f32 to 1e-5.
//
// Design against that bound:
//  * Both operands are k-major: row k of mu is contiguous in i, row k of
//    theta in d. So each k-step is an outer-product update: a block stages a
//    kBK x kBM slice of mu and a kBK x kBN slice of theta in shared memory
//    (16-byte loads; 8-byte for bf16 theta, widened to f32 on load) and each
//    of its 256 threads accumulates an 8 x 8 register tile of outputs, 64
//    FMAs for every four 16-byte shared-memory reads.
//  * Shared memory is double-buffered and the next k-slice is loaded into
//    registers while the current one computes, so one barrier per k-step.
//  * Ragged m and d need no padding by the caller: a load outside (m, m) or
//    (m, d) reads nothing and zero-fills, so no stale value (a NaN times 0)
//    can reach a live output; stores outside are skipped. Vector loads are
//    used when m and d are multiples of 4 (a quad is then wholly inside or
//    wholly outside), scalar loads otherwise.
//  * The m-tiles of one d-tile are neighbouring blocks, so the second reads
//    its theta slice from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output rows (tasks i) per block
constexpr int kBN = 128;  // output columns (personalization axis d) per block
constexpr int kBK = 8;    // contraction (source tasks k) per step
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

// Elements [r, c .. c + 3] of a row-major (rows, cols) matrix, widened to
// f32; zero where outside. kVec: cols % 4 == 0 and c % 4 == 0, so the quad
// is wholly inside or wholly outside.
template <typename T, bool kVec>
__device__ __forceinline__ float4 load_quad(const T* __restrict__ src, int rows, int cols,
                                            int r, int c) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= rows || c >= cols) return v;
  const T* p = src + (long long)r * cols + c;
  if constexpr (kVec) {
    return load4(p);
  } else {
    v.x = to_float(p[0]);
    if (c + 1 < cols) v.y = to_float(p[1]);
    if (c + 2 < cols) v.z = to_float(p[2]);
    if (c + 3 < cols) v.w = to_float(p[3]);
    return v;
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_quad(T* __restrict__ dst, int cols, int r, int c,
                                           const float* v) {
  if (c >= cols) return;
  T* p = dst + (long long)r * cols + c;
  if constexpr (kVec) {
    store4(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
    for (int e = 0; e < 4 && c + e < cols; ++e) store1(p + e, v[e]);
  }
}

// Grid: one block per (m-tile, d-tile), m-tiles fastest. Thread (ty, tx) of
// the 16 x 16 layout owns output rows i0 + {ty*4 .. ty*4+3, 64+ty*4 .. +3}
// and columns j0 + {tx*4 .. tx*4+3, 64+tx*4 .. +3}: each of its shared-memory
// reads is a float4 that a half-warp shares or reads from one 256-byte run.
// At most 128 registers a thread, so two blocks share an SM.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
graph_mix_kernel(const float* __restrict__ mu, const T* __restrict__ theta,
                 T* __restrict__ out, int m, int d, int m_tiles) {
  __shared__ __align__(16) float a_s[2][kBK][kBM];
  __shared__ __align__(16) float b_s[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int i0 = (blockIdx.x % m_tiles) * kBM;
  const int j0 = (blockIdx.x / m_tiles) * kBN;
  const int lr = tid / 32;        // k row of the slice this thread loads
  const int lc = (tid % 32) * 4;  // first column of its quad
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }

  const int nk = (m + kBK - 1) / kBK;
  float4 ra = load_quad<float, kVec>(mu, m, m, lr, i0 + lc);
  float4 rb = load_quad<T, kVec>(theta, m, d, lr, j0 + lc);
  *reinterpret_cast<float4*>(&a_s[0][lr][lc]) = ra;
  *reinterpret_cast<float4*>(&b_s[0][lr][lc]) = rb;
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {  // next slice into registers while this one computes
      const int k = (kt + 1) * kBK + lr;
      ra = load_quad<float, kVec>(mu, m, m, k, i0 + lc);
      rb = load_quad<T, kVec>(theta, m, d, k, j0 + lc);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&a_s[cur][kk][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&a_s[cur][kk][64 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&b_s[cur][kk][tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&b_s[cur][kk][64 + tx * 4]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
    if (more) {  // the other buffer was last read before the previous barrier
      *reinterpret_cast<float4*>(&a_s[cur ^ 1][lr][lc]) = ra;
      *reinterpret_cast<float4*>(&b_s[cur ^ 1][lr][lc]) = rb;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + (r - 4));
    if (i >= m) continue;
    store_quad<T, kVec>(out, d, i, j0 + tx * 4, &acc[r][0]);
    store_quad<T, kVec>(out, d, i, j0 + 64 + tx * 4, &acc[r][4]);
  }
}

template <typename T>
cudaError_t launch(const void* mu, const void* theta, void* out, int m, int d, bool vec,
                   cudaStream_t stream) {
  const int m_tiles = (m + kBM - 1) / kBM;
  const long long blocks = (long long)m_tiles * ((d + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* mu_p = static_cast<const float*>(mu);
  const T* th = static_cast<const T*>(theta);
  T* o = static_cast<T*>(out);
  if (vec) {
    graph_mix_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(mu_p, th, o, m, d,
                                                                          m_tiles);
  } else {
    graph_mix_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(mu_p, th, o, m, d,
                                                                           m_tiles);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. mu: (m, m) float32; theta and
// out: (m, d), dtype 0 = float32, 1 = bfloat16; all contiguous. vec != 0
// asks for vector loads and stores: the caller guarantees m % 4 == 0,
// d % 4 == 0 and 16-byte aligned pointers. Returns the cudaError_t of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int graph_mix_launch(const void* mu, const void* theta, void* out, int m, int d,
                                int dtype, int vec, void* stream) {
  if (m < 1 || d < 1 || mu == nullptr || theta == nullptr || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(mu, theta, out, m, d, vec != 0, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(mu, theta, out, m, d, vec != 0, st);
  return (int)cudaErrorInvalidValue;
}
