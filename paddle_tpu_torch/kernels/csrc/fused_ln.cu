// Fused (residual +) LayerNorm for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels paddle_tpu/kernels/fused_ln.py:45 `_fwd_kernel`
// (launched by `_fwd`, :83) and :62 `_bwd_kernel` (launched by
// `_bwd_call`, :113).
//
// What they compute, as the TPU kernels do, over rows of x [N, M]:
// - forward: a = x (+ residual) in f32; mean = sum(a) / M, then (a second
//   pass) var = sum((a - mean)^2) / M, rstd = rsqrt(var + eps);
//   y = (a - mean) * rstd * g + b in x's dtype; mean and rstd [N] saved in
//   f32 (the TPU's 8-row broadcast of them is a tiling artifact);
// - backward: x^ = (a - mean) * rstd recomputed from the saved statistics,
//   dx = rstd * (dy*g - mean(dy*g) - x^ * mean(dy*g*x^)) in x's dtype (the
//   residual's gradient is the same dx); dg and db as f32 partial column
//   sums, one row of partials per 32-row block, summed outside by the
//   caller (the reference sums its per-block partials outside, :142).
// g and b are read as f32 [M] (the caller casts them).
//
// Design: the forward and the dx pass give each row one warp (8 rows per
// block of 256 threads); lane l owns the 4-column groups 4l + 128k, read
// as one 16-byte (f32) or 8-byte (bf16, f16) load, and the row sums are warp
// shuffles. A row is read again for each pass (three times in the
// forward, twice in the dx pass) rather than held, so any M works; the
// re-reads hit the L1 and L2 (a row is 2 KB at M=1024 bf16). The dg/db
// pass gives each thread one column of one 32-row block and walks the
// rows, so a warp reads 32 neighbouring elements of a row at a time.
//
// Bound on the H100 at BERT-large's shape ([8*512, 1024] bf16, with
// residual): the forward moves 25.2 MB (x, residual in; y out; g, b,
// mean, rstd) and the backward 33.6 MB (x, residual, dy in; dx out; the
// statistics and partials), 0.0075 and 0.010 ms at 3.35 TB/s; both do a
// few operations a byte, so bytes bound them. What the design leaves: the
// backward reads x, residual and dy twice over (dx pass and dg/db pass)
// and recomputes a; the re-reads of a row within a pass go through the
// caches; the dg/db pass walks its rows one after another in each thread.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
constexpr int kThreads = 256;                // 8 warps, one row each
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kPartRows = 32;                // rows of one dg/db partial

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}
__device__ __forceinline__ void load4(const f16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&x.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&x.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<uint32_t*>(&lo);
  x.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}
__device__ __forceinline__ void store4(f16* p, const float (&v)[4]) {
  __half2 lo = __floats2half2_rn(v[0], v[1]);
  __half2 hi = __floats2half2_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<uint32_t*>(&lo);
  x.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a = x (+ r) at 4 columns from `off`, in f32.
template <typename T>
__device__ __forceinline__ void load_a(const T* x, const T* r, int64_t off,
                                       float (&a)[4]) {
  load4(x + off, a);
  if (r != nullptr) {
    float b[4];
    load4(r + off, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] += b[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
              const float* __restrict__ g, const float* __restrict__ b,
              T* __restrict__ y, float* __restrict__ mean,
              float* __restrict__ rstd, int N, int M, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)row * M;
  float s = 0.f;
  for (int c = 4 * lane; c < M; c += 128) {
    float a[4];
    load_a(x, r, base + c, a);
    s += (a[0] + a[1]) + (a[2] + a[3]);
  }
  const float mu = warp_sum(s) / (float)M;
  float v = 0.f;
  for (int c = 4 * lane; c < M; c += 128) {
    float a[4];
    load_a(x, r, base + c, a);
#pragma unroll
    for (int i = 0; i < 4; ++i) v += (a[i] - mu) * (a[i] - mu);
  }
  const float rs = rsqrtf(warp_sum(v) / (float)M + eps);
  for (int c = 4 * lane; c < M; c += 128) {
    float a[4], gv[4], bv[4], out[4];
    load_a(x, r, base + c, a);
    load4(g + c, gv);
    load4(b + c, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = (a[i] - mu) * rs * gv[i] + bv[i];
    store4(y + base + c, out);
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ r,
                 const float* __restrict__ g, const float* __restrict__ mean,
                 const float* __restrict__ rstd, const T* __restrict__ dy,
                 T* __restrict__ dx, int N, int M) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)row * M;
  const float mu = mean[row], rs = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int c = 4 * lane; c < M; c += 128) {
    float a[4], d[4], gv[4];
    load_a(x, r, base + c, a);
    load4(dy + base + c, d);
    load4(g + c, gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dyg = d[i] * gv[i];
      s1 += dyg;
      s2 += dyg * ((a[i] - mu) * rs);
    }
  }
  const float m1 = warp_sum(s1) / (float)M, m2 = warp_sum(s2) / (float)M;
  for (int c = 4 * lane; c < M; c += 128) {
    float a[4], d[4], gv[4], out[4];
    load_a(x, r, base + c, a);
    load4(dy + base + c, d);
    load4(g + c, gv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[i] = rs * (d[i] * gv[i] - m1 - (a[i] - mu) * rs * m2);
    store4(dx + base + c, out);
  }
}

// dg_part[p, c] = sum over rows i of block p of dy * x^, db_part the
// same of dy.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_dgdb_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd, const T* __restrict__ dy,
                   float* __restrict__ dg_part, float* __restrict__ db_part,
                   int M) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= M) return;
  const int r0 = blockIdx.y * kPartRows;
  float sg = 0.f, sb = 0.f;
  for (int i = r0; i < r0 + kPartRows; ++i) {
    const int64_t off = (int64_t)i * M + col;
    float a = to_f32(x[off]);
    if (r != nullptr) a += to_f32(r[off]);
    const float d = to_f32(dy[off]);
    sg += d * ((a - mean[i]) * rstd[i]);
    sb += d;
  }
  dg_part[(int64_t)blockIdx.y * M + col] = sg;
  db_part[(int64_t)blockIdx.y * M + col] = sb;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* r, const void* g,
                       const void* b, void* y, void* mean, void* rstd, int N,
                       int M, float eps, cudaStream_t stream) {
  ln_fwd_kernel<T><<<(N + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0,
                     stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), N, M, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* r, const void* g,
                       const void* mean, const void* rstd, const void* dy,
                       void* dx, void* dg_part, void* db_part, int N, int M,
                       cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const T* dyt = static_cast<const T*>(dy);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  ln_bwd_dx_kernel<T><<<(N + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0,
                        stream>>>(xt, rt, static_cast<const float*>(g), mu, rs,
                                  dyt, static_cast<T*>(dx), N, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kThreads - 1) / kThreads, N / kPartRows);
  ln_bwd_dgdb_kernel<T><<<grid, kThreads, 0, stream>>>(
      xt, rt, mu, rs, dyt, static_cast<float*>(dg_part),
      static_cast<float*>(db_part), M);
  return cudaGetLastError();
}

bool valid_shape(int N, int M) {
  return N > 0 && M > 0 && N % kPartRows == 0 && M % 128 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, residual, y, dy and
// dx share it; the statistics and every sum are f32 whatever it is);
// g, b, mean, rstd and the partials are f32. r (the residual) may be null.
// The backward's partials are f32 [N / 32, M]. Returns the CUDA error of
// the launch (0 = launched). The caller checks shapes, dtypes, contiguity
// and 16-byte alignment.
extern "C" int ptt_ln_fwd(const void* x, const void* r, const void* g,
                          const void* b, void* y, void* mean, void* rstd,
                          int N, int M, float eps, int dtype, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_shape(N, M)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_fwd<float>(x, r, g, b, y, mean, rstd, N, M, eps, s);
  else if (dtype == 1)
    err = launch_fwd<bf16>(x, r, g, b, y, mean, rstd, N, M, eps, s);
  else if (dtype == 2)
    err = launch_fwd<f16>(x, r, g, b, y, mean, rstd, N, M, eps, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" int ptt_ln_bwd(const void* x, const void* r, const void* g,
                          const void* mean, const void* rstd, const void* dy,
                          void* dx, void* dg_part, void* db_part, int N, int M,
                          int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_shape(N, M)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_bwd<float>(x, r, g, mean, rstd, dy, dx, dg_part, db_part, N,
                            M, s);
  else if (dtype == 1)
    err = launch_bwd<bf16>(x, r, g, mean, rstd, dy, dx, dg_part, db_part, N,
                           M, s);
  else if (dtype == 2)
    err = launch_bwd<f16>(x, r, g, mean, rstd, dy, dx, dg_part, db_part, N,
                          M, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
