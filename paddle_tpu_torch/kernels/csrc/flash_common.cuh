// Pieces shared by the flash attention kernels (flash_attention_qkv.cu and
// flash_attention.cu): the reference's dropout hash, the f32 FMA tile
// product, the bf16 mma.sync fragments, tile copies and the delta pre-pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// `_hash_keep_scale` (:101-116) at one tile-relative (row, col): 1/keep or 0.
__device__ __forceinline__ float keep_scale(uint32_t base, uint32_t row,
                                            uint32_t col, float keep,
                                            float inv_keep) {
  uint32_t x = base + row * 0x9E3779B1u + col * 0x85EBCA77u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  const float u = (float)(x >> 8) * 5.9604644775390625e-08f;  // 2^-24
  return u < keep ? inv_keep : 0.f;
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
// delta[b, h, s] = sum_d dO * O over o and dO [B, S, H, D], one warp per
// (b, s, h) row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                   float* __restrict__ delta, int B, int S, int H) {
  const int64_t row =
      (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= (int64_t)B * S * H) return;
  const int lane = threadIdx.x & 31;
  const int hg = (int)(row % H);
  const int64_t bs = row / H;
  const int64_t off = bs * H * D + (int64_t)hg * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc += to_f32(dout[off + d]) * to_f32(o[off + d]);
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, k);
  if (lane == 0) {
    const int64_t b = bs / S, s = bs % S;
    delta[(b * H + hg) * S + s] = acc;
  }
}

template <typename T, int D>
cudaError_t launch_delta(const T* dout, const T* o, float* delta, int B, int S,
                         int H, cudaStream_t stream) {
  const int64_t rows = (int64_t)B * S * H;
  const int warps = kThreads / 32;
  flash_delta_kernel<T, D><<<(unsigned)((rows + warps - 1) / warps), kThreads,
                              0, stream>>>(dout, o, delta, B, S, H);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16: the tensor cores
// mma.sync m16n8k16, bf16 in, f32 accumulate. Each of 4 warps owns 16
// rows of its block's 64-row tile. Operands come from bf16 tiles in
// shared memory whose contraction dimension is contiguous, rows padded by
// 8 elements so the 8 rows x 4 words of a fragment load hit 32 distinct
// banks; an operand needed with its other dimension contiguous is stored
// a second time, transposed. The f32 results of one product become the
// bf16 A operand of the next in registers (P for P.V, dS for dS.K).
using bf16 = __nv_bfloat16;
constexpr int kThreadsTC = 128;       // 4 warps x 16 rows
constexpr int kPad = 8;               // row padding of bf16 tiles
constexpr int kBQ = 32;               // query rows per step of the dk/dv pass

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// A fragment (16 x 16) of a tile stored [m][k] with row stride ld.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int ld,
                                       int m0, int k0, int gi, int qi) {
  const bf16* p = t + (m0 + gi) * ld + k0 + 2 * qi;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}
// B fragment (k 16 x n 8) of a tile stored [n][k] with row stride ld.
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const bf16* t, int ld,
                                       int n0, int k0, int gi, int qi) {
  const bf16* p = t + (n0 + gi) * ld + k0 + 2 * qi;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// The A fragment of columns [16k, 16k + 16) of a 16-row f32 result held as
// C fragments c[n] (n-tiles of 8 columns), rounded to bf16.
template <int N>
__device__ __forceinline__ void as_a(uint32_t (&a)[4], const float (&c)[N][4],
                                     int k) {
  a[0] = pack_bf16(c[2 * k][0], c[2 * k][1]);
  a[1] = pack_bf16(c[2 * k][2], c[2 * k][3]);
  a[2] = pack_bf16(c[2 * k + 1][0], c[2 * k + 1][1]);
  a[3] = pack_bf16(c[2 * k + 1][2], c[2 * k + 1][3]);
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
// ROWS x D from global (row stride ld) into shared [ROWS][D + kPad]; rows
// at or past `nvalid` are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          int64_t ld, int nvalid) {
  constexpr int kPer = D / 8;
  for (int i = threadIdx.x; i < ROWS * kPer; i += kThreadsTC) {
    const int r = i / kPer, c = (i % kPer) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) =
        r < nvalid ? *reinterpret_cast<const uint4*>(src + r * ld + c)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
}
// The same tile transposed into shared [D][ROWS + kPad]; a warp takes 32
// rows of one 8-column chunk, so its stores land on consecutive halves.
template <int D, int ROWS>
__device__ __forceinline__ void copy_tile_t(bf16* dst, const bf16* src,
                                            int64_t ld, int nvalid) {
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += kThreadsTC) {
    const int r = i % ROWS, c = (i / ROWS) * 8;
    const uint4 v = r < nvalid
                        ? *reinterpret_cast<const uint4*>(src + r * ld + c)
                        : make_uint4(0u, 0u, 0u, 0u);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * (ROWS + kPad) + r] = e[j];
  }
}

// ------------------------------------------------------- shared memory
template <int D>
constexpr size_t fwd_tc_smem() {
  return (2 * kTile * (D + kPad) + D * (kTile + kPad)) * sizeof(bf16);
}
template <int D>
constexpr size_t dkdv_tc_smem() {
  return (2 * kTile * (D + kPad) + 2 * kBQ * (D + kPad) +
          2 * D * (kBQ + kPad)) * sizeof(bf16) + 2 * kBQ * sizeof(float);
}
template <int D>
constexpr size_t dq_tc_smem() {
  return (4 * kTile * (D + kPad) + D * (kTile + kPad)) * sizeof(bf16);
}
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
