// Paged-attention decode/verify kernel for Hopper (sm_90a), plain C
// interface: flash-decoding, the page walk split across blocks.
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
// a query with no readable column gets the uniform average of every
// column of its table instead of NaN: parked serving slots, whose
// block-table rows all name the sentinel page, rely on that. Accumulation
// is f32 with online softmax; out [N,H,W,D] is written in the query dtype
// and lse [N,H,W] = m + log(l) in f32.
//
// One difference from the reference's own fp8 path: its gather oracle
// rounds the dequantized view to q's dtype before attending (:268), while
// this kernel, like the TPU kernel's int8 body, attends the f32 values.
// With bf16 queries on the card the two differ by that rounding; in f32
// they agree.
//
// Bound on the H100: memory. Per call it must read the live pages once:
// H * ps * D * 2 (K and V) * page bytes per page, plus, for a quantized
// pool, H * ps * 4 * 2 bytes of scales, at 3.35 TB/s; the arithmetic
// (4*W*D flops per column) is far below the card's rate. At the engine's
// shape (N=8 rows x H=16 heads) one block per (row, head) fills 128 of the
// 132 SMs with one block each, so the call lasts as long as the longest
// row's serial page walk. The design, for this card:
//
// - Split-K over pages (flash-decoding). The grid is (N*H, W tiles,
//   splits); split s owns the contiguous table range [s*pps, (s+1)*pps).
//   The wrapper picks the split count from the shapes and the SM count
//   alone (`plan_splits` in kernels/paged_attention.py), never from
//   steps or valid_cols, so choosing it never waits for the card.
// - Inside a split the 4 warps take the range's pages round robin and
//   work independently, each with its own running max and sum per query
//   and its own accumulator: no block barrier in the walk. A warp reads
//   the valid_cols of 32 of its pages at once (one ballot says which hold
//   a readable column up to the tile's cursor) and the block-table
//   entries with them, and skips the rest: a page past the cursor or of
//   left padding alone adds exactly nothing to a query that has a
//   readable column. The 4 warps merge once, at the end of the split.
//   valid_cols is read 16 bytes a load where ps % 4 == 0 (every page's
//   columns then start 16-byte aligned), else 4 bytes a load.
// - Page loads are asynchronous: each warp streams chunks of C in-page
//   columns of its (page, head) slabs ([ps, D], contiguous in the pool)
//   with cp.async copies into its own 2-stage shared-memory ring (K, V,
//   their scales and the chunk's valid_cols), so the next chunk is in
//   flight while the warp computes on the current one.
// - Any head dim up to 256 and any page size, with the pools at the
//   model's own D (never padded or copied). The kernel is instantiated at
//   a padded width DP (32, 64, 96, 128 or 256; the wrapper's
//   `kernel_width`), each lane holding DP/32 coordinates; the ring's rows
//   are DP elements apart, their columns past D zeroed once per block and
//   never written, and the query's coordinates past D are zeros, so they
//   add nothing to a score and are never stored. Rows are copied at the
//   pool's real row stride in the widest pieces that divide a row's bytes
//   (cp.async of 16, 8 or 4 bytes; byte loads otherwise). A chunk is C =
//   16 columns (8 for f32 pages at DP 256, to fit the ring); a page of
//   ps columns takes ceil(ps / C) chunks, the last one partial: its
//   columns past the page get a score of -inf (not -1e30: they are not
//   columns of the table, and must weigh 0 even in a uniform average),
//   so p = 0 there. Where a ring byte can be read that no copy wrote
//   (pad columns, rows past a partial chunk), the ring is zeroed once a
//   block, so every such byte is finite and the loops test no column.
//   valid_cols and the scales are copied 16 bytes at a time where ps %
//   4 == 0, else 4 bytes a column.
// - The combine stays in the same launch. Every split writes its
//   unnormalised f32 partial (o, m, l) per query to a workspace; the last
//   split of a (row.head, W tile) to finish, known from an atomic ticket
//   taken after a __threadfence(), merges them with the flash rule
//   (M = max m, weights exp(m - M)) and resets the ticket to 0 for the
//   next call. One wrapper call stays one launch.
// - A query with no readable column: every block of the tile first scans
//   the row's valid_cols up to the tile's first cursor (block-wide, 16
//   bytes a load where ps % 4 == 0, else 4). When that query has none, every split walks all of its
//   pages, skipping nothing and ignoring the cursor for the walk; the
//   masked scores then all equal -1e30, each split's partial is the plain
//   sum of its V columns with l its column count, and the merge's weights
//   are all exp(0) = 1: the uniform average over every column of the
//   table, as the TPU kernel gives. The mask itself is unchanged, so a
//   later query of the same tile that does have readable columns gets its
//   masked softmax (its masked columns weigh exp(-1e30 - m) = 0).
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // 4 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;              // a warp's ring of chunks
constexpr float kMasked = -1e30f;       // the TPU kernel's _NEG_INF
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// VD consecutive ring elements in f32, times `scale` (1 for float pages):
// one vector load where VD * sizeof(T) is a power of two up to 16 bytes
// (the row offset is a multiple of it), else element by element.
template <typename T, int VD>
__device__ __forceinline__ void load_row(const T* src, float scale,
                                         float (&x)[VD]) {
  constexpr int kBytes = VD * (int)sizeof(T);
  if constexpr ((kBytes & (kBytes - 1)) == 0 && kBytes <= 16) {
    struct alignas(kBytes) Vec { T e[VD]; };
    const Vec v = *reinterpret_cast<const Vec*>(src);
#pragma unroll
    for (int i = 0; i < VD; ++i) x[i] = to_f32(v.e[i]) * scale;
  } else {
#pragma unroll
    for (int i = 0; i < VD; ++i) x[i] = to_f32(src[i]) * scale;
  }
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(N)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [0, nrows) of a K or V slab (rows of `row_bytes`, contiguous in
// the pool) into ring rows `dst_row` bytes apart, by the warp, in
// `unit`-byte pieces: cp.async of 16, 8 or 4 bytes, or (unit 1, rows
// whose bytes are not a multiple of 4) plain byte copies, done before the
// warp's next __syncwarp like the others.
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_row,
                                          const unsigned char* src,
                                          int row_bytes, int nrows, int unit,
                                          int lane) {
  const int per_row = row_bytes / unit, total = per_row * nrows;
  for (int u = lane; u < total; u += 32) {
    const int r = u / per_row, off = (u - r * per_row) * unit;
    unsigned char* d = dst + r * dst_row + off;
    const unsigned char* s = src + r * row_bytes + off;
    switch (unit) {
      case 16: cp_async<16>(d, s); break;
      case 8: cp_async<8>(d, s); break;
      case 4: cp_async<4>(d, s); break;
      default: *d = *s;
    }
  }
}

// Does vc[c0, c1) hold a nonzero entry? 16 bytes a load with `vec` (c0 and
// the row 16-byte aligned, c1 - c0 padded by readable memory: ps % 4 ==
// 0), else 4.
__device__ __forceinline__ bool any_nonzero(const int32_t* vc, int c0,
                                            int c1, bool vec) {
  bool any = false;
  if (vec) {
    for (int c = c0; c < c1; c += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(vc + c));
      any |= (v.x != 0) | ((c + 1 < c1) & (v.y != 0)) |
             ((c + 2 < c1) & (v.z != 0)) | ((c + 3 < c1) & (v.w != 0));
    }
  } else {
    for (int c = c0; c < c1; ++c) any |= __ldg(vc + c) != 0;
  }
  return any;
}

// v[c] holds this lane's part of column c's dot product. Afterwards v[0]
// holds the whole warp's sum for column lane / (32 / C): each halving
// stage (OFF = 16, 8, ...) sends the half of the columns the partner
// keeps (C - 1 shuffles in all), then the R = 32 / C lanes of one column
// add up. The stages are templates, so every index into v is a constant
// and v stays in registers.
template <int C, int HALF, int OFF>
__device__ __forceinline__ void reduce_stage(float (&v)[C], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(kAll, send, OFF);
  }
  if constexpr (HALF > 1) reduce_stage<C, HALF / 2, OFF / 2>(v, lane);
}
template <int C>
__device__ __forceinline__ float reduce_scatter(float (&v)[C], int lane) {
  reduce_stage<C, C / 2, 16>(v, lane);
  float x = v[0];
#pragma unroll
  for (int o = 16 / C; o >= 1; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

struct Params {
  const void *q, *pk, *pv;
  const float *ks, *vs;
  const int32_t *bt, *st, *vc;
  void* out;
  float* lse;
  float* part_o;     // [N*H*W, splits, D] unnormalised partial out
  float* part_ml;    // [N*H*W, splits, 2] partial (m, l)
  int32_t* tickets;  // [N*H*tiles], 0 between calls
  int H, W, D, ps, pmax, pps;
  int unit;          // bytes a copy of a pool row's pieces (16, 8, 4, 1)
};

// Layout of one ring stage in shared memory: K and V chunks [C][DP] in
// the page type, then (1-byte pages) their C scales each, then the
// chunk's C valid_cols entries.
template <typename TP, int DP, int C>
struct Stage {
  static constexpr bool kQuant = sizeof(TP) == 1;
  static constexpr int kKV = C * DP * (int)sizeof(TP);
  static constexpr int kScales = 2 * kKV;
  static constexpr int kVc = kScales + (kQuant ? 2 * C * 4 : 0);
  static constexpr int kBytes = kVc + C * 4;
};

// The pages of one warp inside its split: candidates p0 + warp + k*kWarps
// below p_end; `next` yields the live ones in order with their physical
// page, 32 candidates per ballot.
struct PageWalk {
  int first, end, lim, ps, base;
  bool all, vec;
  uint32_t mask;
  int phys;                 // this lane's candidate's physical page
  const int32_t *bt, *vc;

  __device__ __forceinline__ void scan(int lane) {
    const int p = first + (base + lane) * kWarps;
    bool live = p < end;
    phys = live ? __ldg(bt + p) : 0;     // in flight beside the scan
    // any readable column in [p*ps, min(p*ps + ps, lim + 1))
    if (live && !all)
      live = any_nonzero(vc, p * ps, min(p * ps + ps, lim + 1), vec);
    mask = __ballot_sync(kAll, live);
  }
  // the next live page (-1 when none), its physical page in `ph`
  __device__ __forceinline__ int next(int lane, int& ph) {
    while (mask == 0) {
      base += 32;
      if (first + base * kWarps >= end) return -1;
      scan(lane);
    }
    const int bit = __ffs(mask) - 1;
    mask &= mask - 1;
    ph = __shfl_sync(kAll, phys, bit);
    return first + (base + bit) * kWarps;
  }
};

// TQ: query/out type (float, bf16). TP: page type (TQ, int8_t or
// __nv_fp8_e4m3; the 1-byte types read the scales). DP: the padded head
// dim (a multiple of 32, >= D). WT: queries per block. C: columns per ring
// chunk.
template <typename TQ, typename TP, int DP, int WT, int C>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const Params a) {
  using St = Stage<TP, DP, C>;
  constexpr bool kQuant = St::kQuant;
  constexpr int VD = DP / 32;            // coordinates a lane holds
  constexpr int R = 32 / C;              // lanes holding one column's score
  constexpr int kRow = DP * (int)sizeof(TP);   // a ring row's bytes
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;

  const int nh = blockIdx.x, tile = blockIdx.y, split = blockIdx.z;
  const int S = gridDim.z, tiles = gridDim.y;
  const int H = a.H, W = a.W, D = a.D, ps = a.ps, pmax = a.pmax;
  const int n = nh / H, h = nh % H;
  const int w0 = tile * WT, wt = min(WT, W - w0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lp = pmax * ps;
  const int step = a.st[n];
  const int32_t* vc = a.vc + (int64_t)n * lp;
  const bool vec = ps % 4 == 0;

  // does the tile's first query have a readable column? (later queries
  // see a superset of its columns)
  const int lim0 = min(step + w0, lp - 1);
  const int per = vec ? 4 : 1;
  int any = 0;
  for (int c = tid * per; c <= lim0; c += kThreads * per)
    any |= any_nonzero(vc, c, min(c + per, lim0 + 1), vec);
  const bool uniform = __syncthreads_or(any) == 0;

  const int p0 = split * a.pps, p1 = min(pmax, p0 + a.pps);
  const int lim = step + w0 + wt - 1;    // the tile's last cursor
  const int p_end = uniform ? p1 : min(p1, lim / ps + 1);

  float qv[WT][VD], acc[WT][VD], m[WT], l[WT];
  const TQ* qrow = static_cast<const TQ*>(a.q) + ((int64_t)nh * W + w0) * D;
#pragma unroll
  for (int w = 0; w < WT; ++w) {
    m[w] = kMasked;
    l[w] = 0.f;
#pragma unroll
    for (int i = 0; i < VD; ++i) {
      const int d = lane * VD + i;
      qv[w][i] = w < wt && d < D ? to_f32(qrow[w * D + d]) : 0.f;
      acc[w][i] = 0.f;
    }
  }

  unsigned char* ring = smem + warp * kStages * St::kBytes;
  // Where a ring row can hold bytes no copy writes (the columns past D,
  // the rows of a page's partial last chunk past the page), the ring is
  // zeroed once: those bytes then hold zeros or an earlier chunk's
  // finite values, which the -inf score and the zero columns of q cancel
  // exactly, so the loops below need no per-column test
  const int row_bytes = D * (int)sizeof(TP);
  if (row_bytes != kRow || ps % C != 0) {
    for (int i = lane * 16; i < kStages * St::kBytes; i += 32 * 16)
      *reinterpret_cast<uint4*>(ring + i) = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();  // zeroed before any copy lands
  }
  const int64_t head_stride = (int64_t)ps * D;
  const TP* pool_k = static_cast<const TP*>(a.pk);
  const TP* pool_v = static_cast<const TP*>(a.pv);
  const int cpp = (ps + C - 1) / C;      // chunks a page, the last partial
  const float inv_scale = 1.f / sqrtf((float)D);

  auto issue = [&](int stage, int page, int phys, int chunk) {
    unsigned char* dst = ring + stage * St::kBytes;
    if (page >= 0) {
      const int c0 = chunk * C, cols = min(C, ps - c0);
      const int64_t slab = ((int64_t)phys * H + h) * head_stride +
                           (int64_t)c0 * D;
      const unsigned char* ks =
          reinterpret_cast<const unsigned char*>(pool_k + slab);
      const unsigned char* vs =
          reinterpret_cast<const unsigned char*>(pool_v + slab);
      if (row_bytes == kRow && cols == C) {
        // a whole chunk at the kernel's width: one contiguous run
#pragma unroll
        for (int i = lane * 16; i < St::kKV; i += 32 * 16) {
          cp_async<16>(dst + i, ks + i);
          cp_async<16>(dst + St::kKV + i, vs + i);
        }
      } else {
        copy_rows(dst, kRow, ks, row_bytes, cols, a.unit, lane);
        copy_rows(dst + St::kKV, kRow, vs, row_bytes, cols, a.unit, lane);
      }
      // the chunk's scales and valid_cols: 16 bytes a copy where ps % 4
      // == 0 (then every piece is 16-byte aligned and whole), else 4
      const int64_t sc = ((int64_t)phys * H + h) * ps + c0;
      const int32_t* vcc = vc + page * ps + c0;
      if (vec) {
        // lanes 4g + i copy piece i of group g: k scales, v scales, vc
        const int piece = lane & 3, group = lane >> 2;
        if (piece < cols / 4) {
          if (kQuant && group < 2)
            cp_async<16>(dst + St::kScales + group * C * 4 + piece * 16,
                         (group == 0 ? a.ks : a.vs) + sc + piece * 4);
          else if (group == 2)
            cp_async<16>(dst + St::kVc + piece * 16, vcc + piece * 4);
        }
      } else {
        const int c = lane % 16;
        if (kQuant && c < cols)
          cp_async<4>(dst + St::kScales + (lane / 16) * C * 4 + c * 4,
                      (lane < 16 ? a.ks : a.vs) + sc + c);
        if (lane < cols) cp_async<4>(dst + St::kVc + lane * 4, vcc + lane);
      }
    }
    cp_async_commit();
  };

  PageWalk walk{split * a.pps + warp, p_end, lim, ps, 0, uniform, vec, 0u,
                0, a.bt + (int64_t)n * pmax, vc};
  walk.scan(lane);
  int cur_page, cur_phys = 0, cur_chunk = 0;
  int nxt_page, nxt_phys = 0, nxt_chunk = 0;
  cur_page = walk.next(lane, cur_phys);
  issue(0, cur_page, cur_phys, 0);
  nxt_page = cur_page;
  nxt_phys = cur_phys;
  if (nxt_page >= 0 && ++nxt_chunk == cpp) {
    nxt_chunk = 0;
    nxt_page = walk.next(lane, nxt_phys);
  }
  issue(1, nxt_page, nxt_phys, nxt_chunk);

  for (int stage = 0; cur_page >= 0; stage ^= 1) {
    cp_async_wait1();
    __syncwarp();
    const unsigned char* buf = ring + stage * St::kBytes;
    const TP* k_s = reinterpret_cast<const TP*>(buf);
    const TP* v_s = reinterpret_cast<const TP*>(buf + St::kKV);
    const float* ksc = reinterpret_cast<const float*>(buf + St::kScales);
    const float* vsc = ksc + C;
    const int32_t* vc_s = reinterpret_cast<const int32_t*>(buf + St::kVc);
    // the chunk's columns: ncols of C (fewer in a page's last chunk)
    const int ncols = min(C, ps - cur_chunk * C);
    const int cr = lane / R;             // this lane's column in the chunk
    const int col = cur_page * ps + cur_chunk * C + cr;
    const bool readable = vc_s[cr] != 0;
    float pw[WT];
#pragma unroll
    for (int w = 0; w < WT; ++w) {
      pw[w] = 0.f;
      if (w < wt) {
        float part[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float kf[VD];
          load_row<TP, VD>(k_s + c * DP + lane * VD, kQuant ? ksc[c] : 1.f,
                           kf);
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < VD; ++i) s = fmaf(qv[w][i], kf[i], s);
          part[c] = s;
        }
        float sc = reduce_scatter<C>(part, lane) * inv_scale;
        if (cr >= ncols)
          sc = -INFINITY;                // past the page: not a column
        else if (!(readable && col <= step + w0 + w))
          sc = kMasked;
        float cmax = sc;
#pragma unroll
        for (int o = 16; o >= R; o >>= 1)
          cmax = fmaxf(cmax, __shfl_xor_sync(kAll, cmax, o));
        const float m_new = fmaxf(m[w], cmax);
        const float alpha = expf(m[w] - m_new);
        const float p = expf(sc - m_new);
        l[w] = l[w] * alpha + (lane % R == 0 ? p : 0.f);
        m[w] = m_new;
#pragma unroll
        for (int i = 0; i < VD; ++i) acc[w][i] *= alpha;
        pw[w] = p;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float vf[VD];
      load_row<TP, VD>(v_s + c * DP + lane * VD, kQuant ? vsc[c] : 1.f, vf);
#pragma unroll
      for (int w = 0; w < WT; ++w) {
        const float pc = __shfl_sync(kAll, pw[w], c * R);
#pragma unroll
        for (int i = 0; i < VD; ++i) acc[w][i] = fmaf(pc, vf[i], acc[w][i]);
      }
    }
    __syncwarp();  // every lane has read the stage before it is refilled
    cur_page = nxt_page;
    cur_phys = nxt_phys;
    cur_chunk = nxt_chunk;
    if (nxt_page >= 0 && ++nxt_chunk == cpp) {
      nxt_chunk = 0;
      nxt_page = walk.next(lane, nxt_phys);
    }
    issue(stage, nxt_page, nxt_phys, nxt_chunk);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // merge the 4 warps' states through shared memory (the rings are done)
#pragma unroll
  for (int w = 0; w < WT; ++w)
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) l[w] += __shfl_xor_sync(kAll, l[w], o);
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(smem);        // [kWarps][WT][DP]
  float* ml_s = o_s + kWarps * WT * DP;                // [kWarps][WT][2]
#pragma unroll
  for (int w = 0; w < WT; ++w) {
#pragma unroll
    for (int i = 0; i < VD; ++i)
      o_s[(warp * WT + w) * DP + lane * VD + i] = acc[w][i];
    if (lane == 0) {
      ml_s[(warp * WT + w) * 2] = m[w];
      ml_s[(warp * WT + w) * 2 + 1] = l[w];
    }
  }
  __syncthreads();
  // the merges walk the padded width, whose divisions are constants
  const int64_t q_base = (int64_t)nh * W + w0;
  for (int idx = tid; idx < wt * DP; idx += kThreads) {
    const int w = idx / DP, d = idx % DP;
    if (d >= D) continue;
    float mx = kMasked;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) mx = fmaxf(mx, ml_s[(k * WT + w) * 2]);
    float o = 0.f, lsum = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const float e = expf(ml_s[(k * WT + w) * 2] - mx);
      o += e * o_s[(k * WT + w) * DP + d];
      lsum += e * ml_s[(k * WT + w) * 2 + 1];
    }
    const int64_t part = (q_base + w) * S + split;
    a.part_o[part * D + d] = o;
    if (d == 0) {
      a.part_ml[part * 2] = mx;
      a.part_ml[part * 2 + 1] = lsum;
    }
  }

  // the last split of this (row.head, tile) to finish merges the partials
  __threadfence();
  __syncthreads();
  int32_t* ticket = a.tickets + (int64_t)nh * tiles + tile;
  if (tid == 0) last_s = S == 1 || atomicAdd(ticket, 1) == S - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int idx = tid; idx < wt * DP; idx += kThreads) {
    const int w = idx / DP, d = idx % DP;
    if (d >= D) continue;
    const int64_t part = (q_base + w) * S;
    float mx = kMasked;
    for (int s = 0; s < S; ++s)
      mx = fmaxf(mx, __ldcg(a.part_ml + (part + s) * 2));
    float o = 0.f, lsum = 0.f;
    for (int s = 0; s < S; ++s) {
      const float e = expf(__ldcg(a.part_ml + (part + s) * 2) - mx);
      o += e * __ldcg(a.part_o + (part + s) * D + d);
      lsum += e * __ldcg(a.part_ml + (part + s) * 2 + 1);
    }
    store(static_cast<TQ*>(a.out) + (q_base + w) * D + d, o / lsum);
    if (d == 0) a.lse[q_base + w] = mx + logf(lsum);
  }
  if (tid == 0 && S > 1) *ticket = 0;
}

template <typename TQ, typename TP, int DP, int WT, int C>
cudaError_t launch(const Params& a, int N, int splits, cudaStream_t stream) {
  using St = Stage<TP, DP, C>;
  const dim3 grid(N * a.H, (a.W + WT - 1) / WT, splits);
  const size_t ring = (size_t)kWarps * kStages * St::kBytes;
  const size_t merge = (size_t)kWarps * WT * (DP + 2) * sizeof(float);
  const size_t bytes = ring > merge ? ring : merge;
  auto k = paged_attn_kernel<TQ, TP, DP, WT, C>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  k<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The instantiated (DP, WT, C): the wrapper's plan (`kernel_width`,
// `query_tile`, `chunk_cols` in kernels/paged_attention.py): DP 32, 64,
// 96 or 128 with 4- or 8-query tiles, or 256 with 4-query tiles; C 16,
// or 8 where a row of the page type spans more than 512 bytes (f32 pages
// at DP 256).
template <typename TQ, typename TP, int DP>
cudaError_t dispatch_tile(const Params& a, int N, int S, int wt, int c,
                          cudaStream_t st) {
  constexpr int kC = DP * (int)sizeof(TP) > 512 ? 8 : 16;
  if (c != kC) return cudaErrorInvalidValue;
  if (wt == 4) return launch<TQ, TP, DP, 4, kC>(a, N, S, st);
  if constexpr (DP <= 128)
    if (wt == 8) return launch<TQ, TP, DP, 8, kC>(a, N, S, st);
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TP>
cudaError_t dispatch(const Params& a, int N, int S, int dp, int wt, int c,
                     cudaStream_t st) {
  switch (dp) {
    case 32: return dispatch_tile<TQ, TP, 32>(a, N, S, wt, c, st);
    case 64: return dispatch_tile<TQ, TP, 64>(a, N, S, wt, c, st);
    case 96: return dispatch_tile<TQ, TP, 96>(a, N, S, wt, c, st);
    case 128: return dispatch_tile<TQ, TP, 128>(a, N, S, wt, c, st);
    case 256: return dispatch_tile<TQ, TP, 256>(a, N, S, wt, c, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_pages(const Params& a, int N, int S, int dp, int wt,
                           int c, int pdtype, cudaStream_t st) {
  switch (pdtype) {
    case 0: return dispatch<TQ, TQ>(a, N, S, dp, wt, c, st);
    case 1: return dispatch<TQ, int8_t>(a, N, S, dp, wt, c, st);
    case 2: return dispatch<TQ, __nv_fp8_e4m3>(a, N, S, dp, wt, c, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qdtype: 0 = float32, 1 = bfloat16 (q and out). pdtype: 0 = pages in q's
// dtype (k_scale and v_scale unused, may be null), 1 = int8 pages, 2 = fp8
// e4m3 pages (both with f32 scales [P, H, ps]). D: the head dim (1 to
// 256; q, out and the pools at D); dp, wt, chunk: the wrapper's plan
// (padded width, queries a block, columns a ring chunk). splits x pps
// covers the table (splits = ceil(pmax / pps)). part_o: f32 [N*H*W,
// splits, D] and part_ml: f32 [N*H*W, splits, 2] scratch; tickets: int32
// [N*H*ceil(W / wt)], all 0 before the call and left 0 after it. Any
// ps >= 1. Returns the CUDA error of the launch (0 = launched). The
// caller checks shapes, dtypes, contiguity and 16-byte alignment.
extern "C" int ptt_paged_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* steps, const void* valid_cols, void* out, void* lse,
    void* part_o, void* part_ml, void* tickets, int N, int H, int W, int D,
    int dp, int wt, int chunk, int ps, int pmax, int splits, int pps,
    int qdtype, int pdtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ps < 1 || N < 1 || H < 1 || W < 1 || D < 1 || D > dp || pmax < 1 ||
      splits < 1 || pps < 1 || (int64_t)splits * pps < pmax ||
      (int64_t)(splits - 1) * pps >= pmax)
    return (int)cudaErrorInvalidValue;
  if (pdtype != 0 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  Params a;
  a.q = q;
  a.pk = pool_k;
  a.pv = pool_v;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.bt = static_cast<const int32_t*>(block_table);
  a.st = static_cast<const int32_t*>(steps);
  a.vc = static_cast<const int32_t*>(valid_cols);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.tickets = static_cast<int32_t*>(tickets);
  a.H = H;
  a.W = W;
  a.D = D;
  a.ps = ps;
  a.pmax = pmax;
  a.pps = pps;
  const int row = D * (pdtype == 0 ? (qdtype == 0 ? 4 : 2) : 1);
  a.unit = row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : row % 4 == 0 ? 4 : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qdtype == 0)
    err = dispatch_pages<float>(a, N, splits, dp, wt, chunk, pdtype, st);
  else if (qdtype == 1)
    err = dispatch_pages<__nv_bfloat16>(a, N, splits, dp, wt, chunk, pdtype,
                                        st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
