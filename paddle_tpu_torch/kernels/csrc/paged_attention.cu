// Paged-attention decode/verify kernel for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_attention.py:120
// `_paged_attn_kernel` (launched by `fused_paged_attention`, :179), in both
// of its forms: float pools (f32 or bf16) and quantized pools of 1-byte
// pages with per-(page, head, in-page column) f32 scales, dequantized in
// the kernel (the TPU kernel's `quantized=True` body, :143-147). Pages are
// int8, as in the TPU kernel, or fp8 e4m3 (`__nv_fp8_e4m3`), which the
// reference sends to its gather oracle only because Mosaic lacked 1-byte
// float tiles; both dequantize the same way, `float(page) * scale` in f32.
// Queries and out are f32 or bf16.
//
// What it computes, exactly as the TPU kernel does: window queries
// q [N,H,W,D] against the page pools [P,H,ps,D] through the block table
// [N,Pmax] (int32). W is 1 for a decode step and k+1 for a speculative
// verify window. Query j of row n attends logical column c (page c / ps,
// in-page column c % ps) when c <= steps[n] + j and valid_cols[n, c] != 0.
// Scores are q.k / sqrt(D) in f32; a masked score is -1e30 (not -inf), so
// a row with no readable column gets the uniform average of every column
// of its table instead of NaN: parked serving slots, whose block-table
// rows all name the sentinel page, rely on that. Accumulation is f32 with
// online softmax; out [N,H,W,D] is written in the query dtype and
// lse [N,H,W] = m + log(l) in f32.
//
// One difference from the reference's own fp8 path: its gather oracle
// rounds the dequantized view to q's dtype before attending (:268), while
// this kernel, like the TPU kernel's int8 body, attends the f32 values.
// With bf16 queries on the card the two differ by that rounding; in f32
// they agree.
//
// How it differs from the TPU kernel: the TPU grid is (n, h, page) with
// the page axis sequential and the softmax state carried in VMEM scratch
// across grid steps. GPU blocks run in no order, so here one thread block
// owns an (n, h) pair and a tile of up to WT queries (WT = 4, or 8 for a
// window of 5 to 8 queries, so a k+1 = 5 verify window runs one block per
// (row, head)) and loops over that row's pages itself, reading
// block_table[n, p] directly (no scalar prefetch). It reads only the pages
// that hold a column <= steps[n]+W-1 and a column valid_cols marks
// readable: a page past the cursor or of left padding alone adds exactly
// nothing (exp(-1e30 - m) = 0, or alpha = 0 once a readable column
// arrives) to a query that has a readable column. A tile with a query
// that has none (m still -1e30 at the cursor) starts again at page 0 and
// walks every page of the table, skipping nothing: the TPU kernel's
// uniform average.
//
// Bound on the H100: memory. Per call it must read the live pages once:
// H * ps * D * 2 (K and V) * page bytes per page, plus, for a quantized
// pool, H * ps * 4 * 2 bytes of scales, at 3.35 TB/s; the arithmetic
// (4*W*D flops per column) is far below the card's rate. The design
// answers that bound by reading each live page exactly once per (row,
// head, query tile), with 16-byte loads (neighbouring threads on
// neighbouring addresses; 16 one-byte elements per load for a quantized
// pool) into shared memory as f32, each column's scale read once per
// chunk. Split-K over pages (flash-decoding) and cp.async/TMA page
// streaming are later work.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // 4 warps per block
constexpr int kWarps = kThreads / 32;
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

// One 16-byte load of page elements, widened to f32 in shared memory. The
// 1-byte forms dequantize with the column's scale; the float forms take
// no scale.
__device__ __forceinline__ void load16(const float* src, float* dst, float) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst,
                                       float) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* src, float* dst,
                                       float scale) {
  const int4 v = *reinterpret_cast<const int4*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(b[i]) * scale;
}
__device__ __forceinline__ void load16(const __nv_fp8_e4m3* src, float* dst,
                                       float scale) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_fp8_e4m3* b = reinterpret_cast<const __nv_fp8_e4m3*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(b[i]) * scale;
}

// TQ: query/out type (float, bf16). TP: page type (TQ, int8_t or
// __nv_fp8_e4m3; the 1-byte types read k_scale/v_scale). D: head dim.
// WT: queries per block.
template <typename TQ, typename TP, int D, int WT>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const TQ* __restrict__ q, const TP* __restrict__ pool_k,
                  const TP* __restrict__ pool_v,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int32_t* __restrict__ block_table,
                  const int32_t* __restrict__ steps,
                  const int32_t* __restrict__ valid_cols,
                  TQ* __restrict__ out, float* __restrict__ lse,
                  int H, int W, int ps, int pmax, int chunk) {
  constexpr bool kQuant = sizeof(TP) == 1;
  constexpr int kVec = 16 / sizeof(TP);              // elements per load
  constexpr int kPer = WT * D / kThreads;            // acc slots per thread
  static_assert(WT * D % kThreads == 0, "query tile must fill the block");
  __shared__ __align__(16) float q_s[WT][D];
  __shared__ __align__(16) float k_s[kChunk][D];
  __shared__ __align__(16) float v_s[kChunk][D];
  __shared__ float p_s[WT][kChunk];                  // scores, then weights
  __shared__ float m_s[WT], l_s[WT], a_s[WT];
  __shared__ float ksc_s[kChunk], vsc_s[kChunk];     // the chunk's scales

  const int nh = blockIdx.x;                         // n * H + h
  const int n = nh / H, h = nh % H;
  const int w0 = blockIdx.y * WT;
  const int wt = min(WT, W - w0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int step = steps[n];
  const int n_read = max(1, min(pmax, (step + W - 1) / ps + 1));
  const int32_t* bt = block_table + (int64_t)n * pmax;
  const int32_t* vc = valid_cols + (int64_t)n * pmax * ps;
  const int64_t head_stride = (int64_t)ps * D;
  const int64_t page_stride = (int64_t)H * head_stride;
  const float scale = sqrtf((float)D);

  const TQ* qrow = q + ((int64_t)nh * W + w0) * D;
  for (int i = tid; i < wt * D; i += kThreads)
    q_s[i / D][i % D] = to_f32(qrow[i]);
  if (tid < WT) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  // first pass: pages up to the cursor that hold a readable column;
  // a tile with a query that found none walks the whole table again
  bool first_pass = true;
  int p_end = n_read;
  for (int p = 0; p < p_end; ++p) {
    bool live = true;
    if (first_pass) {
      int any = 0;
      for (int c = tid; c < ps; c += kThreads) any |= vc[p * ps + c] != 0;
      live = __syncthreads_or(any) != 0;
    }
    if (live) {
      const int64_t base =
          (int64_t)bt[p] * page_stride + (int64_t)h * head_stride;
      const int64_t sbase = ((int64_t)bt[p] * H + h) * ps;
      for (int c0 = 0; c0 < ps; c0 += chunk) {
        __syncthreads();  // the previous chunk is consumed; q_s/m_s are set
        if constexpr (kQuant) {
          if (tid < chunk) {
            ksc_s[tid] = k_scale[sbase + c0 + tid];
            vsc_s[tid] = v_scale[sbase + c0 + tid];
          }
          __syncthreads();
        }
        const TP* ks = pool_k + base + (int64_t)c0 * D;
        const TP* vs = pool_v + base + (int64_t)c0 * D;
        for (int i = tid; i < chunk * D / kVec; i += kThreads) {
          const int c = i * kVec / D;
          load16(ks + i * kVec, &k_s[0][0] + i * kVec,
                 kQuant ? ksc_s[c] : 1.f);
          load16(vs + i * kVec, &v_s[0][0] + i * kVec,
                 kQuant ? vsc_s[c] : 1.f);
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
    }
    if (first_pass && p == n_read - 1) {
      // m_s was last written before a barrier every thread has passed
      // since (the one ahead of the P.V update, or a later page's
      // __syncthreads_or), so every thread reads the same values here
      bool none = false;
      for (int w = 0; w < wt; ++w) none |= m_s[w] == kMasked;
      if (none) {
        __syncthreads();  // every thread has read m_s
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
        if (tid < WT) {
          m_s[tid] = kMasked;
          l_s[tid] = 0.f;
        }
        first_pass = false;
        p_end = pmax;
        p = -1;  // again from page 0, skipping nothing
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = tid + i * kThreads;
    const int w = idx / D, d = idx % D;
    if (w < wt)
      store(out + ((int64_t)nh * W + w0 + w) * D + d, acc[i] / l_s[w]);
  }
  if (tid < wt) lse[(int64_t)nh * W + w0 + tid] = m_s[tid] + logf(l_s[tid]);
}

struct Args {
  const void *q, *pk, *pv, *ks, *vs, *bt, *st, *vc;
  void *out, *lse;
  int N, H, W, D, ps, pmax;
  cudaStream_t stream;
};

template <typename TQ, typename TP, int D, int WT>
void launch(const Args& a) {
  const dim3 grid(a.N * a.H, (a.W + WT - 1) / WT);
  const int chunk = a.ps % kChunk == 0 ? kChunk : 8;
  paged_attn_kernel<TQ, TP, D, WT><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TP*>(a.pk),
      static_cast<const TP*>(a.pv), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.bt),
      static_cast<const int32_t*>(a.st), static_cast<const int32_t*>(a.vc),
      static_cast<TQ*>(a.out), static_cast<float*>(a.lse), a.H, a.W, a.ps,
      a.pmax, chunk);
}

// D in {64, 128}; a window of up to 4 queries takes 4-query tiles, a
// longer one 8-query tiles
template <typename TQ, typename TP>
bool dispatch(const Args& a) {
  const bool wide = a.W > 4;
  if (a.D == 64) {
    wide ? launch<TQ, TP, 64, 8>(a) : launch<TQ, TP, 64, 4>(a);
  } else if (a.D == 128) {
    wide ? launch<TQ, TP, 128, 8>(a) : launch<TQ, TP, 128, 4>(a);
  } else {
    return false;
  }
  return true;
}

template <typename TQ>
bool dispatch_pages(const Args& a, int pdtype) {
  switch (pdtype) {
    case 0: return dispatch<TQ, TQ>(a);
    case 1: return dispatch<TQ, int8_t>(a);
    case 2: return dispatch<TQ, __nv_fp8_e4m3>(a);
    default: return false;
  }
}

}  // namespace

// qdtype: 0 = float32, 1 = bfloat16 (q and out). pdtype: 0 = pages in q's
// dtype (k_scale and v_scale unused, may be null), 1 = int8 pages, 2 = fp8
// e4m3 pages (both with f32 scales [P, H, ps]). Returns the CUDA error of
// the launch (0 = launched). The caller checks shapes, dtypes, contiguity
// and alignment; ps % 8 == 0, D in {64, 128}.
extern "C" int ptt_paged_attention(const void* q, const void* pool_k,
                                   const void* pool_v, const void* k_scale,
                                   const void* v_scale,
                                   const void* block_table, const void* steps,
                                   const void* valid_cols, void* out,
                                   void* lse, int N, int H, int W, int D,
                                   int ps, int pmax, int qdtype, int pdtype,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ps % 8 != 0 || N < 1 || H < 1 || W < 1 || pmax < 1)
    return (int)cudaErrorInvalidValue;
  if (pdtype != 0 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q,     pool_k, pool_v, k_scale, v_scale, block_table,
               steps, valid_cols, out, lse, N, H, W, D, ps, pmax,
               static_cast<cudaStream_t>(stream)};
  bool ok = false;
  if (qdtype == 0)
    ok = dispatch_pages<float>(a, pdtype);
  else if (qdtype == 1)
    ok = dispatch_pages<__nv_bfloat16>(a, pdtype);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
