// Pieces shared by the flash attention kernels (flash_attention_qkv.cu and
// flash_attention.cu): the reference's dropout hash (and its integer keep
// threshold), the f32 FMA tile product, the 16-bit fragment helpers and
// the delta pre-pass.
//
// The 16-bit element type. A source builds its tensor-core kernels for
// bfloat16; built with -DPTT_F16 (the `_f16` libraries of
// kernels/_build.py) the same kernels take float16: `e16`, the pair
// packing, the products' operand type (`PTT_AB`, hopper.cuh), the TMA
// data type and the dtype code a C entry takes (`kCode16`: 1 bfloat16,
// 2 float16) follow it. Accumulation is float32 in both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kThreads = 256;         // f32 path, delta pre-pass: 16 x 16
constexpr int kTile = 64;             // query and key tile
constexpr int kTM = kTile / 16;       // tile rows per thread (ty + 16 i)
constexpr int kLS = kTile + 1;        // padded row stride of a score tile
constexpr float kMasked = -1e30f;     // the TPU kernel's _NEG_INF

// `_mix32` (paddle_tpu/kernels/flash_attention.py:90-98): uint32
// hash-combine of the seed with three block ids.
__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t a, uint32_t b,
                                          uint32_t c) {
  x ^= a + 0x9E3779B9u + (x << 6) + (x >> 2);
  x ^= b + 0x9E3779B9u + (x << 6) + (x >> 2);
  x ^= c + 0x9E3779B9u + (x << 6) + (x >> 2);
  return x;
}

// `_hash_keep_scale` (:101-116) at one tile-relative (row, col): the
// hash's top 24 bits, whose u = bits * 2^-24 the reference compares with
// keep.
__device__ __forceinline__ uint32_t hash24(uint32_t base, uint32_t row,
                                           uint32_t col) {
  uint32_t x = base + row * 0x9E3779B1u + col * 0x85EBCA77u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >> 8;
}

// The integer form of the reference's compare: bits * 2^-24 < keep exactly
// when bits < ceil(keep * 2^24). Both products are exact in f32 (bits <
// 2^24; scaling by a power of two), and for an integer n, n < x holds
// exactly when n < ceil(x); so the mask is bit for bit the reference's,
// with no int-to-float conversion per element. Formed once per kernel.
__device__ __forceinline__ uint32_t keep_threshold(float keep) {
  return (uint32_t)ceilf(keep * 16777216.0f);
}

// The same element's 1/keep or 0, with thr = keep_threshold(keep).
__device__ __forceinline__ float keep_scale(uint32_t base, uint32_t row,
                                            uint32_t col, uint32_t thr,
                                            float inv_keep) {
  return hash24(base, row, col) < thr ? inv_keep : 0.f;
}

// ------------------------------------------------------- f32: plain FMAs
// A [64, D] f32 tile (rows `ld` elements apart in global memory) into
// shared memory with row stride D + 1, 16 bytes a load; rows at or past
// `nvalid` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t ld, int nvalid) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const float4 v = r < nvalid
                         ? *reinterpret_cast<const float4*>(src + r * ld + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d = dst + r * (D + 1) + c;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
}

// acc[i][j] += sum_k A(ty + 16i, k) * B(k, tx + 16j), A and B in shared
// memory with element (m, k) of A at A[m*SAM + k*SAK] and (k, n) of B at
// B[k*SBK + n*SBN]. With the padded strides every warp reads at most two
// addresses of A (a broadcast) and 16 distinct banks of B.
template <int TN, int K, int SAM, int SAK, int SBK, int SBN>
__device__ __forceinline__ void tile_product(float (&acc)[kTM][TN],
                                             const float* __restrict__ A,
                                             const float* __restrict__ B,
                                             int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[kTM], b[TN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) a[i] = A[(ty + 16 * i) * SAM + k * SAK];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = B[k * SBK + (tx + 16 * j) * SBN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Reductions over the 16 threads of one tile row (one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ------------------------------------------------- both: the delta pre-pass
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
// delta[b, h, s] = sum_d dO * O over o and dO [B, S, H, D], one warp per
// (b, s, h) row; with `zero` (an f32 [B, S, H, D] accumulator, the
// general bf16 backward's dq) the row is zeroed there too. With `dlse`
// (f32 [B, H, S], the cotangent of an exposed lse: B4) the row's dlse is
// subtracted: the kernels form ds = p * (dp - delta), and the reference's
// dp - delta + dlse (`_packed_head_attn_bwd`) is dp - (delta - dlse).
// D = 0: the head dim is `d_rt`, known at run time (heads above 128).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                   float* __restrict__ delta, float* __restrict__ zero,
                   const float* __restrict__ dlse, int B, int S, int H,
                   int d_rt) {
  const int dd = D > 0 ? D : d_rt;
  const int64_t row =
      (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= (int64_t)B * S * H) return;
  const int lane = threadIdx.x & 31;
  const int hg = (int)(row % H);
  const int64_t bs = row / H;
  const int64_t off = bs * H * dd + (int64_t)hg * dd;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < dd; d += 32)
    acc += to_f32(dout[off + d]) * to_f32(o[off + d]);
  if (zero != nullptr)
#pragma unroll
    for (int d = lane; d < dd; d += 32) zero[off + d] = 0.f;
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, k);
  if (lane == 0) {
    const int64_t b = bs / S, s = bs % S;
    const int64_t at = (b * H + hg) * S + s;
    delta[at] = dlse != nullptr ? acc - dlse[at] : acc;
  }
}

template <typename T, int D>
cudaError_t launch_delta(const T* dout, const T* o, float* delta, int B, int S,
                         int H, cudaStream_t stream, float* zero = nullptr,
                         const float* dlse = nullptr, int d_rt = 0) {
  const int64_t rows = (int64_t)B * S * H;
  const int warps = kThreads / 32;
  flash_delta_kernel<T, D><<<(unsigned)((rows + warps - 1) / warps), kThreads,
                              0, stream>>>(dout, o, delta, zero, dlse, B, S,
                                           H, d_rt);
  return cudaGetLastError();
}

// ---------------------------------------------- 16-bit: the fragments
// The warpgroup products' accumulator holds each warp's 16 rows in the
// mma.sync m16n8 C layout (row gi or gi + 8, columns 2qi and 2qi + 1 of
// each 8-column n-tile), and their register A operand is the mma.sync A
// fragment: the f32 results of one product become the 16-bit A operand
// of the next in registers (P for P.V, dS^T for dK).
#ifdef PTT_F16
using e16 = __half;
constexpr int kCode16 = 2;

__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
#else
using e16 = __nv_bfloat16;
constexpr int kCode16 = 1;

__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
#endif
// The A fragment of columns [16k, 16k + 16) of a 16-row f32 result held as
// C fragments c[n] (n-tiles of 8 columns), rounded to e16.
template <int N>
__device__ __forceinline__ void as_a(uint32_t (&a)[4], const float (&c)[N][4],
                                     int k) {
  a[0] = pack16(c[2 * k][0], c[2 * k][1]);
  a[1] = pack16(c[2 * k][2], c[2 * k][3]);
  a[2] = pack16(c[2 * k + 1][0], c[2 * k + 1][1]);
  a[3] = pack16(c[2 * k + 1][2], c[2 * k + 1][3]);
}
// Reductions over the 4 threads that share a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------- shared memory
template <int D>
constexpr size_t fwd_smem() {
  return (3 * kTile * (D + 1) + kTile * kLS) * sizeof(float);
}
template <int D>
constexpr size_t dkdv_smem() {
  return (4 * kTile * (D + 1) + 2 * kTile * kLS) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (4 * kTile * (D + 1) + kTile * kLS) * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace flash
