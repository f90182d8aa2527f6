// Paged-attention decode kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_attention.py:120
// `_paged_attn_kernel` (launched by `fused_paged_attention`, :179), in its
// unquantized form: pools in f32 or bf16, no in-kernel dequantization.
//
// What it computes, exactly as the TPU kernel does: window queries
// q [N,H,W,D] against the page pools [P,H,ps,D] through the block table
// [N,Pmax] (int32). Query j of row n attends logical column c (page
// c / ps, in-page column c % ps) when c <= steps[n] + j and
// valid_cols[n, c] != 0. Scores are q.k / sqrt(D) in f32; a masked score
// is -1e30 (not -inf), so a row with no readable column gets the uniform
// average of every column of its table instead of NaN — parked serving
// slots, whose block-table rows all name the sentinel page, rely on that.
// Accumulation is f32 with online softmax; out [N,H,W,D] is written in the
// query dtype and lse [N,H,W] = m + log(l) in f32.
//
// How it differs from the TPU kernel: the TPU grid is (n, h, page) with
// the page axis sequential and the softmax state carried in VMEM scratch
// across grid steps. GPU blocks run in no order, so here one thread block
// owns an (n, h) pair (and a tile of up to 4 queries) and loops over that
// row's pages itself, reading block_table[n, p] directly (no scalar
// prefetch). It reads only the pages that hold a column <= steps[n]+W-1:
// a page past the cursor adds exactly nothing (exp(-1e30 - m) = 0) to a
// query that has a readable column. A query with none (m still -1e30 at
// the cursor) gets the TPU kernel's uniform average over every page of
// the table, so for such a tile the block keeps walking to Pmax.
//
// Bound on the H100: memory. Per call it must read the live pages once,
// at most sum_n ceil((steps[n]+W)/ps)*ps * H * D * 2 (K and V) * bytes, at
// 3.35 TB/s; the arithmetic (4*W*D flops per column) is far below the
// card's rate. A page that holds only left padding (valid_cols all 0)
// cannot change a row that has a readable column, so the least the call
// needs leaves such pages out. The design answers that bound by reading
// no page past the cursor, each page it reads exactly once per (row,
// head, query tile), with 16-byte loads (neighbouring threads on
// neighbouring addresses) into shared memory. It still reads the pages
// of left padding; skipping them, split-K over pages (flash-decoding),
// cp.async/TMA page streaming and a larger query tile are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // 4 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kWTile = 4;               // queries per block
constexpr int kChunk = 16;              // largest column chunk in shared memory
constexpr float kMasked = -1e30f;       // the TPU kernel's _NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One 16-byte load, widened to f32 in shared memory.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                  const T* __restrict__ pool_v,
                  const int32_t* __restrict__ block_table,
                  const int32_t* __restrict__ steps,
                  const int32_t* __restrict__ valid_cols,
                  T* __restrict__ out, float* __restrict__ lse,
                  int H, int W, int ps, int pmax, int chunk) {
  constexpr int kVec = 16 / sizeof(T);               // elements per load
  constexpr int kPer = kWTile * D / kThreads;        // acc slots per thread
  __shared__ __align__(16) float q_s[kWTile][D];
  __shared__ __align__(16) float k_s[kChunk][D];
  __shared__ __align__(16) float v_s[kChunk][D];
  __shared__ float p_s[kWTile][kChunk];              // scores, then weights
  __shared__ float m_s[kWTile], l_s[kWTile], a_s[kWTile];

  const int nh = blockIdx.x;                         // n * H + h
  const int n = nh / H, h = nh % H;
  const int w0 = blockIdx.y * kWTile;
  const int wt = min(kWTile, W - w0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int step = steps[n];
  const int n_read = max(1, min(pmax, (step + W - 1) / ps + 1));
  const int32_t* bt = block_table + (int64_t)n * pmax;
  const int32_t* vc = valid_cols + (int64_t)n * pmax * ps;
  const int64_t head_stride = (int64_t)ps * D;
  const int64_t page_stride = (int64_t)H * head_stride;
  const float scale = sqrtf((float)D);

  const T* qrow = q + ((int64_t)nh * W + w0) * D;
  for (int i = tid; i < wt * D; i += kThreads) q_s[i / D][i % D] = to_f32(qrow[i]);
  if (tid < kWTile) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  int p_end = n_read;
  for (int p = 0; p < p_end; ++p) {
    const int64_t base = (int64_t)bt[p] * page_stride + (int64_t)h * head_stride;
    for (int c0 = 0; c0 < ps; c0 += chunk) {
      __syncthreads();  // the previous chunk is consumed; q_s/m_s are set
      const T* ks = pool_k + base + (int64_t)c0 * D;
      const T* vs = pool_v + base + (int64_t)c0 * D;
      for (int i = tid; i < chunk * D / kVec; i += kThreads) {
        load16(ks + i * kVec, &k_s[0][0] + i * kVec);
        load16(vs + i * kVec, &v_s[0][0] + i * kVec);
      }
      __syncthreads();
      // scores: warp `warp` owns columns warp, warp + 4, ...; lanes split D
      const int col0 = p * ps + c0;
      for (int c = warp; c < chunk; c += kWarps) {
        const int col = col0 + c;
        const bool readable = vc[col] != 0;
        for (int w = 0; w < wt; ++w) {
          float part = 0.f;
#pragma unroll
          for (int d = lane; d < D; d += 32) part += q_s[w][d] * k_s[c][d];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if (lane == 0)
            p_s[w][c] = (readable && col <= step + w0 + w) ? part / scale
                                                           : kMasked;
        }
      }
      __syncthreads();
      // online softmax: one thread per query of the tile
      if (tid < wt) {
        const float m_prev = m_s[tid];
        float m_new = m_prev;
        for (int c = 0; c < chunk; ++c) m_new = fmaxf(m_new, p_s[tid][c]);
        float sum = 0.f;
        for (int c = 0; c < chunk; ++c) {
          const float e = expf(p_s[tid][c] - m_new);
          p_s[tid][c] = e;
          sum += e;
        }
        const float alpha = expf(m_prev - m_new);
        l_s[tid] = l_s[tid] * alpha + sum;
        m_s[tid] = m_new;
        a_s[tid] = alpha;
      }
      __syncthreads();
      // acc = acc * alpha + P . V; thread slot i holds (w, d) = divmod(idx, D)
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = tid + i * kThreads;
        const int w = idx / D, d = idx % D;
        if (w < wt) {
          float a = acc[i] * a_s[w];
          for (int c = 0; c < chunk; ++c) a += p_s[w][c] * v_s[c][d];
          acc[i] = a;
        }
      }
    }
    if (p == n_read - 1) {
      // m_s was last written before the barrier ahead of the P.V update,
      // so every thread reads the same values here
      bool none = false;
      for (int w = 0; w < wt; ++w) none |= m_s[w] == kMasked;
      if (none) p_end = pmax;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = tid + i * kThreads;
    const int w = idx / D, d = idx % D;
    if (w < wt) store(out + ((int64_t)nh * W + w0 + w) * D + d, acc[i] / l_s[w]);
  }
  if (tid < wt) lse[(int64_t)nh * W + w0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <typename T, int D>
void launch(const void* q, const void* pk, const void* pv, const void* bt,
            const void* st, const void* vc, void* out, void* lse, int N,
            int H, int W, int ps, int pmax, cudaStream_t stream) {
  const dim3 grid(N * H, (W + kWTile - 1) / kWTile);
  const int chunk = ps % kChunk == 0 ? kChunk : 8;
  paged_attn_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(st), static_cast<const int32_t*>(vc),
      static_cast<T*>(out), static_cast<float*>(lse), H, W, ps, pmax, chunk);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, both pools and out share it).
// Returns the CUDA error of the launch (0 = launched). The caller checks
// shapes, dtypes, contiguity and alignment; ps % 8 == 0, D in {64, 128}.
extern "C" int ptt_paged_attention(const void* q, const void* pool_k,
                                   const void* pool_v, const void* block_table,
                                   const void* steps, const void* valid_cols,
                                   void* out, void* lse, int N, int H, int W,
                                   int D, int ps, int pmax, int dtype,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ps % 8 != 0 || N < 1 || H < 1 || W < 1 || pmax < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    launch<float, 64>(q, pool_k, pool_v, block_table, steps, valid_cols, out,
                      lse, N, H, W, ps, pmax, s);
  else if (dtype == 0 && D == 128)
    launch<float, 128>(q, pool_k, pool_v, block_table, steps, valid_cols, out,
                       lse, N, H, W, ps, pmax, s);
  else if (dtype == 1 && D == 64)
    launch<__nv_bfloat16, 64>(q, pool_k, pool_v, block_table, steps,
                              valid_cols, out, lse, N, H, W, ps, pmax, s);
  else if (dtype == 1 && D == 128)
    launch<__nv_bfloat16, 128>(q, pool_k, pool_v, block_table, steps,
                               valid_cols, out, lse, N, H, W, ps, pmax, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
