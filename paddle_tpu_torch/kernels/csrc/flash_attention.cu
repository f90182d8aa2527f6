// General [B,S,H,D] flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of paddle_tpu/kernels/flash_attention.py:
// `_fwd_kernel` (:207, launched by `_fwd` :319), `_merged_bwd_kernel`
// (:536, launched by `_bwd_merged` :575), `_dq_kernel` (:375) and
// `_dkdv_kernel` (:427), both launched by `_bwd` (:622). One forward and
// one backward here cover all four: the TPU's split between a merged
// one-block backward and split dq / dk-dv grids is a VMEM and grid
// artifact; all of them compute the same dq, dk and dv
// (`_packed_head_attn_bwd`, :488-533).
//
// The backward also serves the qkv kernels' backwards, B1's `_bwd_qkv`
// (:936, body :876) and B5's `_bwd_qkv3` (:1107, body :1044), over the
// fused projection qkv [B,S,3*H*D] as it lies (`ptt_flash_qkv_bwd`):
// q, k and v are read, and dq, dk and dv written, through a row stride
// (ldq for q and dq, ldk for the rest) and a rule from head to column
// that the caller fills, head h's columns at (h / group) * gstride +
// (h % group) * D plus qcol, kcol or vcol. Separate tensors: stride H*D,
// group 1, gstride D, offsets 0. Pair-major qkv (B1): stride 3HD, group
// 2, gstride 6D, offsets 0, 2D, 4D. Which-major qkv (B5): stride 3HD,
// group 1, gstride D, offsets 0, HD, 2HD. o, dO, lse and delta keep the
// layouts below. The qkv kernels' dropout ids are per head (below).
//
// What they compute, as the TPU kernels do:
// - q [B,Sq,H,D], k and v [B,Sk,H,D], read through strides (row stride
//   H*D, head stride D; no [B*H,S,D] transpose), or the projection
//   above. D is 64, 128 or a multiple of 64 above 128 (the caller
//   zero-pads any other D up to the next of these, which changes neither
//   scores nor outputs; the reference pads to a multiple of 128); any
//   Sq, Sk >= 1.
// - s = (q.k) * scale in f32 (scale = 1/sqrt(real D), passed in); the
//   additive f32 bias [Bm,Sqm,Sk] is ADDED (Bm in {1,B}, Sqm in {1,Sq}:
//   batch index b when Bm == B else 0, row q when Sqm == Sq else 0; a
//   bool mask arrives as 0/-1e9); then a key past Sk (`_tail_mask`) or
//   past the bottom-right causal diagonal (off + q < c, off = Sk - Sq) is
//   REPLACED by -1e30. Online max and l over the raw p; p*keep rounded to
//   v's dtype before P.V; o = acc / max(l, 1e-30), lse = m +
//   log(max(l, 1e-30)). o [B,Sq,H,D] in the input dtype, lse [B,H,Sq] f32
//   (the TPU's 8-row broadcast is a tiling artifact).
// - Backward: delta = rowsum(dO*O) in f32, p = exp(s - lse), dv =
//   (p*keep)^T dO with p*keep rounded to dO's dtype, dp = (dO v^T)*keep,
//   ds = p*(dp - delta)*scale rounded to q's dtype, dk = ds^T q, dq = ds k.
//   The bias gets no gradient.
// - B4, flash attention with a differentiable lse (`_flash_lse`, :767-784:
//   `_fwd`, then `_bwd_merged` with `has_dlse`, :575 / :536): the same
//   forward, whose lse is an output already, and the same backward given
//   the lse cotangent dlse [B,H,Sq] f32. The reference adds it inside ds,
//   p*(dp - delta + dlse) (:525-527); the delta pre-pass writes delta -
//   dlse, so every pass after it runs unchanged, and with a null dlse
//   nothing differs from B2's backward.
// - Dropout: the keep/scale of score (q, c) of head bh = b*H + h is the
//   reference's interpret-mode hash (`_hash_keep_scale`, :101-116) with
//   block ids (bh, q / bq, c / bk) at tile-relative (q % bq, c % bk), where
//   bq and bk are the REFERENCE's block sizes (`_pick_block`, :1211), not
//   these kernels' tiles; the caller passes them. They are multiples of
//   128, so none of these kernels' 64- or 128-row tiles straddles one of
//   their blocks and the ids hold per tile. The qkv kernels' ids
//   (`head_ids`) are (b, h >> 1, h & 1) at global (q, c), in both
//   layouts (:865, :890, :1031, :1057): one block of origin (0, 0).
//   Computed per element from
//   global coordinates, so the masks agree bit for bit with the plain
//   version and with paddle_tpu's interpret mode. These kernels compare
//   the hash's top 24 bits with the integer threshold ceil(keep * 2^24)
//   (`keep_threshold`, the same mask without an int-to-float conversion).
//   (On the TPU itself the reference draws from the hardware PRNG, which
//   nothing reproduces.)
//
// Design. bf16 (the training path) runs on Hopper's warpgroup products
// fed by TMA (tensor maps over q, k, v and dO as 2-D [B*S, row] arrays,
// 64 x 64 boxes, 128-byte swizzle; rows that leak into the next batch are
// replaced past Sk or have p = 0 past Sq; rows past the array read 0):
// - forward (`fwd_wg_kernel`), flash_attention_qkv.cu's template: a
//   persistent grid of 128-query tiles, longest causal rows first; a
//   producer warp streams 128-key K/V tiles (64 above D = 128) through a
//   2-3 stage ring with full/empty mbarriers and stages the key-padding
//   bias row of each tile in shared memory; two consumer warpgroups of 64 rows run S = Q.K^T
//   (wgmma from shared memory), the online softmax on the accumulator
//   fragments (m in natural units, each exponential one ex2 of (s - m) *
//   log2(e)), and O += P.V with P in registers and V through a transposed
//   descriptor. Key tiles past the causal diagonal are skipped; only the
//   tiles that reach the diagonal or Sk are masked;
// - in both, the per-score loops come in forms chosen once per tile
//   (plain, key-padding row, general; with or without dropout): a check
//   per score, branched or predicated, costs as much as the softmax;
// - backward (`bwd_wg_kernel`), one pass over keys: a block per (b, h,
//   128-key block), causal's longest first; K and V are loaded once, Q and
//   dO tiles of 64 rows (with their lse and delta) stream through a ring.
//   Two consumer warpgroups own 64 keys each and form S^T = K Q^T and
//   dP^T = V dO^T (K-major descriptors: no transposed copies), P^T and
//   dS^T ONCE per score (one hash, one ex2), dV += (P^T keep) dO and
//   dK += dS^T Q (A in registers, B MN-major), and write dS^T to shared
//   memory; after a barrier of the two, each forms half of the block's dQ
//   columns, dS K over all 128 keys (A and B MN-major,
//   `wgmma_ss_n32/n64<1>`), and adds it into an f32 accumulator with
//   red.global (float2 atomicAdd). The delta pre-pass (flash_common.cuh)
//   zeroes the accumulator; a post-pass rounds it into dq. dq's f32 sums thus arrive
//   in an order that varies from run to run: dq is not bitwise
//   reproducible on the card (it stays within the same tolerances). The
//   deterministic alternative, per-key-block partials summed by the
//   post-pass, would move 2 x (Sk/128) x the accumulator's bytes more
//   (about 134 MB at BERT's shape, 0.04 ms at 3.35 TB/s), a third of the
//   whole backward's budget, so the atomics were chosen.
// f32 runs on FMAs (the tensor cores have no exact f32 mode) and serves
// the agreement checks: one block per (b, h, 64-query tile) with an online
// softmax over 64-key tiles; the backward a delta pre-pass, a dk/dv pass
// and a dq pass, both recomputing P from lse.
//
// Heads of 192 and 256 (Gemma-2B's 8 heads of 256), bf16: the same two
// kernels resized, since a 128-key tile of 256 columns is 64 KB and a 64
// x 256 f32 accumulator 128 registers a thread. The forward
// (`fwd_wg_kernel<192|256>`) takes 64-key K/V tiles, a single Q buffer,
// and forms O += P.V with N = D in one product; the scores are formed
// once. The backward (`bwd_wg_wide_kernel`) owns 64 keys a block and
// splits its two consumer groups by role (S^T, P^T and dV; dP^T, dS^T
// and dK), each holding all D columns of its accumulator across the query
// loop. Budgets at D = 256 (227 KB of shared memory, 64K registers): the
// forward Q 64 KB + 2 stages x (K 32 + V 32 KB) = 192 KB, a consumer
// thread O 128 + S 32 + P 16 registers; the backward K 32 + V 32 + 2
// stages x (Q 32 + dO 32) + dS^T 8 + P^T 16 KB = 216 KB, a consumer
// thread dV or dK 128 + S^T or dP^T 32 + its bf16 A operand 16 + a
// 64-column dQ chunk 32 registers; consumers setmaxnreg 232, the
// producer 40; ptxas: no spills. Bound at phase 13's shape (B4 S1024 H8
// D256, key padding with lengths in [768, 1024), dropout 0.1, counting
// the visible pairs): operations, 0.0296 ms forward (4*D flops a pair)
// and 0.0740 ms backward (10*D) at 989 TFLOP/s. What they leave: dQ's
// atomics come once per 64-key block (twice as often as at 128 keys), the
// backward's groups wait on each other twice a query tile (P^T, dS^T),
// the forward rescales its 128-register O every 64 keys, and neither
// overlaps its softmax with its products. The kernels sliced over D
// (below) keep f32 above 128, on the same FMA tiles (`fwd_wide_kernel`,
// `dkdv_wide_kernel`, `dq_wide_kernel`), and bf16 above 256, on mma.sync
// (`fwd_wide_tc_kernel`, `dkdv_wide_tc_kernel`, `dq_wide_tc_kernel`),
// where a 64 x 384 K tile and a 192-register O do not fit the design
// above; no model of either catalog has such heads.
//
// Bound on the H100, at BERT-large's training shape (B8 S512 H16 D64,
// bf16, a [B,1,1,S] key-padding mask with lengths in [384, 512), counting
// only the key rows some query sees, as chip_smoke.py does): the forward
// moves q, those k and v rows, the bias rows, o and lse (31.9 MB, 0.0095
// ms at 3.35 TB/s) for 4*D*H flops per visible pair (7.6 GFLOP, 0.0077
// ms at 989 TFLOP/s); the backward moves 65.5 MB (0.0195 ms) for 10*D*H
// flops per pair (19.0 GFLOP, 0.0192 ms): both bytes-bound. With dropout,
// the hash (about 12 integer operations a score) is a floor beside them:
// 33.5M scores a pass at 64 integer lanes an SM is about 0.027 ms, which
// the products can only overlap. Over the qkv projection, the backward
// at GPT's training shape (B8 S1024 H16 D128, causal) moves qkv, o, dO,
// lse and dqkv (269 MB, 0.080 ms) for 10*D per causal pair and head
// (85.9 GFLOP, 0.087 ms), and at the unmasked BERT's (B8 S512 H16 D64,
// full) 67.4 MB (0.0201 ms) for 21.5 GFLOP (0.0217 ms): both bound by
// their products, the bytes close behind. What the design leaves: both
// consumer groups softmax at the same time (no ping-pong) and each waits
// for its own products, the backward's one block an SM, dQ's atomics and
// its pre- and post-pass, and key tiles that are wholly padding still
// computed (ROADMAP B2).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

// Everything a kernel reads, passed by value.
struct Params {
  const void* q;        // [B, Sq, H, D], or the fused projection
  const void* k;        // [B, Sk, H, D], or the same projection
  const void* v;        // [B, Sk, H, D], or the same projection
  const void* o;        // backward: the forward's output [B, Sq, H, D]
  const void* dout;     // backward: [B, Sq, H, D]
  const float* lse;     // backward: [B, H, Sq]
  float* delta;         // backward: [B, H, Sq], written by the pre-pass
  const float* dlse;    // backward: [B, H, Sq] lse cotangent (B4) or null
  const float* bias;    // [bias_b, bias_q, Sk] or null
  const int32_t* seed;  // [1], read when use_drop
  void* out;            // forward: [B, Sq, H, D]
  float* lse_out;       // forward: [B, H, Sq]
  void* dq;             // backward outputs, laid out as q, k, v
  void* dk;
  void* dv;
  float* dq_acc;        // bf16 backward: f32 dq scratch [B, Sq, H, D]
  int64_t ldq, ldk;     // row strides of q and dq; of k, v, dk and dv
  int group, gstride;   // head h's columns there: (h / group) * gstride
  int qcol, kcol, vcol; //   + (h % group) * D, plus qcol, kcol or vcol
  int head_ids;         // dropout ids (b, h >> 1, h & 1) (the qkv kernels)
  int B, Sq, Sk, H, bias_b, bias_q, causal, off, use_drop, bq, bk;
  float keep, scale;
};

// Head h's first column in q, k, v, dq, dk and dv, before the q, k or v
// offset.
__device__ __forceinline__ int head_col(const Params& p, int h, int D) {
  return (h / p.group) * p.gstride + (h % p.group) * D;
}

// One (b, h) head: element offsets of (b, row 0, h) in q and dq, k and dk,
// v and dv, and in o, dO and the forward's out (row stride ldo = H*D).
struct Head {
  int b, h, bh;
  int64_t ldo, q, k, v, o;
};

__device__ __forceinline__ Head head(const Params& p, int D) {
  Head g;
  g.h = blockIdx.y;
  g.b = blockIdx.z;
  g.bh = g.b * p.H + g.h;
  g.ldo = (int64_t)p.H * D;
  const int col = head_col(p, g.h, D);
  g.q = (int64_t)g.b * p.Sq * p.ldq + col + p.qcol;
  g.k = (int64_t)g.b * p.Sk * p.ldk + col + p.kcol;
  g.v = (int64_t)g.b * p.Sk * p.ldk + col + p.vcol;
  g.o = (int64_t)g.b * p.Sq * g.ldo + (int64_t)g.h * D;
  return g;
}

// The reference's score of query row r against key column c: qk * scale
// plus the bias, or -1e30 for a key past Sk or past the causal diagonal.
__device__ __forceinline__ float score(float qk, const Params& p, int b,
                                       int r, int c) {
  if (c >= p.Sk || (p.causal && p.off + r < c)) return kMasked;
  float s = qk * p.scale;
  if (p.bias != nullptr) {
    const int64_t row = (int64_t)(p.bias_b == 1 ? 0 : b) * p.bias_q +
                        (p.bias_q == 1 ? 0 : min(r, p.Sq - 1));
    s += __ldg(p.bias + row * p.Sk + c);
  }
  return s;
}

// Dropout of one (query tile, key tile) pair: the hash base of the
// reference block that holds it and that block's origin (with head_ids,
// the head's one block at (0, 0)); an element is kept where its hash's
// top 24 bits lie under the integer threshold
// (`keep_threshold`, the reference's float compare bit for bit). `Keep`
// holds what does not depend on the tile, formed once per thread.
struct Keep {
  uint32_t seed, thr;
  float inv;
};
__device__ __forceinline__ Keep keep_consts(const Params& p) {
  return {p.use_drop ? (uint32_t)p.seed[0] : 0u, keep_threshold(p.keep),
          1.0f / p.keep};
}
struct Drop {
  uint32_t base, thr;
  int r0, c0;
  __device__ __forceinline__ bool kept(int r, int c) const {
    return hash24(base, (uint32_t)(r - r0), (uint32_t)(c - c0)) < thr;
  }
};
__device__ __forceinline__ Drop tile_drop(const Params& p, const Keep& kc,
                                          int b, int h, int q0, int k0) {
  if (p.head_ids)
    return {p.use_drop ? mix32(kc.seed, b, h >> 1, h & 1) : 0u, kc.thr, 0, 0};
  const int qb = q0 / p.bq, kb = k0 / p.bk;
  return {p.use_drop ? mix32(kc.seed, b * p.H + h, qb, kb) : 0u, kc.thr,
          qb * p.bq, kb * p.bk};
}

// Key tiles the query tile [q0, q0 + 64) needs: all, or under causal
// masking those up to its last row's diagonal.
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  const int n = (p.Sk + kTile - 1) / kTile;
  if (!p.causal) return n;
  const int last = p.off + q0 + kTile - 1;
  return last < 0 ? 0 : min(n, last / kTile + 1);
}

// The first query row that sees a key at or after k0.
__device__ __forceinline__ int first_query(const Params& p, int k0) {
  return p.causal ? max(0, k0 - p.off) : 0;
}

// ------------------------------------------------------- f32: plain FMAs
template <int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Params p) {
  constexpr int LD = D + 1, TD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;

  const Head g = head(p, D);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qb = static_cast<const float*>(p.q) + g.q;
  const float* kb = static_cast<const float*>(p.k) + g.k;
  const float* vb = static_cast<const float*>(p.v) + g.v;
  const Keep kc = keep_consts(p);

  load_tile<D>(Qs, qb + q0 * p.ldq, p.ldq, p.Sq - q0);
  float m[kTM], l[kTM], acc[kTM][TD];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(p, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous K/V/P tiles are consumed
    load_tile<D>(Ks, kb + k0 * p.ldk, p.ldk, p.Sk - k0);
    load_tile<D>(Vs, vb + k0 * p.ldk, p.ldk, p.Sk - k0);
    __syncthreads();
    float s[kTM][4];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_product<4, D, LD, 1, 1, LD>(s, Qs, Ks, ty, tx);
    const Drop dr = tile_drop(p, kc, g.b, g.h, q0, k0);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty + 16 * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score(s[i][j], p, g.b, q0 + r, k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float pv = expf(s[i][j] - m_new);
        sum += pv;
        if (p.use_drop) pv = dr.kept(q0 + r, k0 + c) ? pv * kc.inv : 0.f;
        Ps[r * kLS + c] = pv;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_product<TD, kTile, kLS, 1, LD, 1>(acc, Ps, Vs, ty, tx);
  }

  float* out = static_cast<float*>(p.out) + g.o;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j) out[r * g.ldo + tx + 16 * j] = acc[i][j] / lc;
    if (tx == 0) p.lse_out[(int64_t)g.bh * p.Sq + r] = m[i] + logf(lc);
  }
}

// lse and delta of query row q: +inf and 0 past Sq, so p = 0 there.
__device__ __forceinline__ void row_stats(const Params& p, const Head& g,
                                          int q, float& lse, float& delta) {
  const bool in = q < p.Sq;
  lse = in ? p.lse[(int64_t)g.bh * p.Sq + q] : INFINITY;
  delta = in ? p.delta[(int64_t)g.bh * p.Sq + q] : 0.f;
}

// The scores of one (64-query tile, 64-key tile) pair turned into P*keep
// and dS in shared memory; s and dp hold Q K^T and dO V^T in the
// (ty + 16i, tx + 16j) layout.
__device__ __forceinline__ void probs_and_dscores(
    const float (&s)[kTM][4], const float (&dp)[kTM][4], const float* lse_r,
    const float* delta_r, float* Ps, float* dSs, const Params& p,
    const Head& g, int q0, int k0, const Keep& kc, int ty, int tx) {
  const Drop dr = tile_drop(p, kc, g.b, g.h, q0, k0);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float pr =
          expf(score(s[i][j], p, g.b, q0 + r, k0 + c) - lse_r[i]);
      const float ks =
          !p.use_drop ? 1.f : dr.kept(q0 + r, k0 + c) ? kc.inv : 0.f;
      if (Ps != nullptr) Ps[r * kLS + c] = pr * ks;
      dSs[r * kLS + c] = pr * (dp[i][j] * ks - delta_r[i]) * p.scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Params p) {
  constexpr int LD = D + 1, TD = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;
  float* dSs = Ps + kTile * kLS;

  const Head g = head(p, D);
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qb = static_cast<const float*>(p.q) + g.q;
  const float* dob = static_cast<const float*>(p.dout) + g.o;
  const Keep kc = keep_consts(p);

  load_tile<D>(Ks, static_cast<const float*>(p.k) + g.k + k0 * p.ldk, p.ldk,
               p.Sk - k0);
  load_tile<D>(Vs, static_cast<const float*>(p.v) + g.v + k0 * p.ldk, p.ldk,
               p.Sk - k0);
  float dk[kTM][TD], dv[kTM][TD];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = first_query(p, k0) / kTile * kTile; q0 < p.Sq; q0 += kTile) {
    __syncthreads();  // the previous Q/dO/P/dS tiles are consumed
    load_tile<D>(Qs, qb + q0 * p.ldq, p.ldq, p.Sq - q0);
    load_tile<D>(dOs, dob + q0 * g.ldo, g.ldo, p.Sq - q0);
    __syncthreads();
    float s[kTM][4], dp[kTM][4], lse_r[kTM], delta_r[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      row_stats(p, g, q0 + ty + 16 * i, lse_r[i], delta_r[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    tile_product<4, D, LD, 1, 1, LD>(s, Qs, Ks, ty, tx);
    tile_product<4, D, LD, 1, 1, LD>(dp, dOs, Vs, ty, tx);
    probs_and_dscores(s, dp, lse_r, delta_r, Ps, dSs, p, g, q0, k0, kc, ty,
                      tx);
    __syncthreads();
    // dV[k][d] += sum_q Pd[q][k] dO[q][d];  dK[k][d] += sum_q dS[q][k] Q[q][d]
    tile_product<TD, kTile, 1, kLS, LD, 1>(dv, Ps, dOs, ty, tx);
    tile_product<TD, kTile, 1, kLS, LD, 1>(dk, dSs, Qs, ty, tx);
  }

  float* dkb = static_cast<float*>(p.dk) + g.k;
  float* dvb = static_cast<float*>(p.dv) + g.v;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      dkb[r * p.ldk + tx + 16 * j] = dk[i][j];
      dvb[r * p.ldk + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  constexpr int LD = D + 1, TD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;

  const Head g = head(p, D);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* kb = static_cast<const float*>(p.k) + g.k;
  const float* vb = static_cast<const float*>(p.v) + g.v;
  const Keep kc = keep_consts(p);

  load_tile<D>(Qs, static_cast<const float*>(p.q) + g.q + q0 * p.ldq, p.ldq,
               p.Sq - q0);
  load_tile<D>(dOs, static_cast<const float*>(p.dout) + g.o + q0 * g.ldo,
               g.ldo, p.Sq - q0);
  float dq[kTM][TD], lse_r[kTM], delta_r[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    row_stats(p, g, q0 + ty + 16 * i, lse_r[i], delta_r[i]);
#pragma unroll
    for (int j = 0; j < TD; ++j) dq[i][j] = 0.f;
  }

  const int nk = key_tiles(p, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous K/V/dS tiles are consumed
    load_tile<D>(Ks, kb + k0 * p.ldk, p.ldk, p.Sk - k0);
    load_tile<D>(Vs, vb + k0 * p.ldk, p.ldk, p.Sk - k0);
    __syncthreads();
    float s[kTM][4], dp[kTM][4];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_product<4, D, LD, 1, 1, LD>(s, Qs, Ks, ty, tx);
    tile_product<4, D, LD, 1, 1, LD>(dp, dOs, Vs, ty, tx);
    probs_and_dscores(s, dp, lse_r, delta_r, nullptr, dSs, p, g, q0, k0, kc,
                      ty, tx);
    __syncthreads();
    // dQ[q][d] += sum_k dS[q][k] K[k][d]
    tile_product<TD, kTile, kLS, 1, LD, 1>(dq, dSs, Ks, ty, tx);
  }

  float* dqb = static_cast<float*>(p.dq) + g.q;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) dqb[r * p.ldq + tx + 16 * j] = dq[i][j];
  }
}

// ------------------------------------------------- D > 128: D sliced
// f32 heads wider than 128 and bf16 heads wider than 256 (D a multiple of
// 64; the wrapper zero-pads a head dim between to the next one,
// `kernel_head_dim`), with D cut two ways:
// every product over D (the scores Q.K^T, and dO.V^T) runs over
// 128-column chunks streamed through shared memory, and each block owns
// one 128-column slice of its output (o; dk and dv; dq), a grid axis.
// Blocks of the same tile recompute the scores, once per slice, and all
// draw the same dropout ids: the ids depend on (bh, query block, key
// block) only. Chunks of the f32 backward run in the order that leaves
// the block's own slice of Q and dO (dk/dv pass) or of K (dq pass) in
// shared memory for its output's product. f32 runs the f32 kernels' 64 x
// 64 FMA tiles so; bf16 runs mma.sync (below). They are the first right
// kernels for such heads, the scores recomputed D/128 times; bf16 at D
// 192 and 256 runs the wgmma kernels resized instead (`fwd_wg_kernel`,
// `bwd_wg_wide_kernel`).
constexpr int kWS = 128;              // a chunk and an output slice
constexpr int kLW = kWS + 1;          // padded row stride of a chunk tile

// A [64, 128] f32 tile (rows `ld` elements apart in global memory) into
// shared memory with row stride 129, 16 bytes a load; columns at or past
// `ncols` (a multiple of 4) and rows at or past `nvalid` are zeros.
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int64_t ld, int nvalid,
                                           int ncols) {
  constexpr int kPerRow = kWS / 4;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const float4 v = r < nvalid && c < ncols
                         ? *reinterpret_cast<const float4*>(src + r * ld + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d = dst + r * kLW + c;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
}

// The output slice of a block: grid.x = slices x tiles, slice slowest.
struct Slice {
  int tile, d0, dn;                   // tile index; columns [d0, d0 + dn)
};
__device__ __forceinline__ Slice slice_of(int tiles, int D) {
  const int s = blockIdx.x / tiles;
  return {(int)blockIdx.x % tiles, s * kWS, min(kWS, D - s * kWS)};
}

__global__ void __launch_bounds__(kThreads)
fwd_wide_kernel(const Params p, int D) {
  constexpr int TD = kWS / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                   // a 128-column chunk of Q
  float* Ks = Qs + kTile * kLW;       // the same chunk of K
  float* Vs = Ks + kTile * kLW;       // this block's slice of V
  float* Ps = Vs + kTile * kLW;

  const Head g = head(p, D);
  const int nq = (p.Sq + kTile - 1) / kTile;
  const Slice sl = slice_of(nq, D);
  const int q0 = (nq - 1 - sl.tile) * kTile;   // longest rows first
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qb = static_cast<const float*>(p.q) + g.q;
  const float* kb = static_cast<const float*>(p.k) + g.k;
  const float* vb = static_cast<const float*>(p.v) + g.v;
  const Keep kc = keep_consts(p);

  float m[kTM], l[kTM], acc[kTM][TD];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(p, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    float s[kTM][4];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kWS) {
      __syncthreads();  // the previous chunks (and P, V) are consumed
      load_chunk(Qs, qb + q0 * p.ldq + c0, p.ldq, p.Sq - q0, D - c0);
      load_chunk(Ks, kb + k0 * p.ldk + c0, p.ldk, p.Sk - k0, D - c0);
      __syncthreads();
      tile_product<4, kWS, kLW, 1, 1, kLW>(s, Qs, Ks, ty, tx);
    }
    load_chunk(Vs, vb + k0 * p.ldk + sl.d0, p.ldk, p.Sk - k0, sl.dn);
    const Drop dr = tile_drop(p, kc, g.b, g.h, q0, k0);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty + 16 * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score(s[i][j], p, g.b, q0 + r, k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float pv = expf(s[i][j] - m_new);
        sum += pv;
        if (p.use_drop) pv = dr.kept(q0 + r, k0 + c) ? pv * kc.inv : 0.f;
        Ps[r * kLS + c] = pv;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_product<TD, kTile, kLS, 1, kLW, 1>(acc, Ps, Vs, ty, tx);
  }

  float* out = static_cast<float*>(p.out) + g.o + sl.d0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j)
      if (tx + 16 * j < sl.dn) out[r * g.ldo + tx + 16 * j] = acc[i][j] / lc;
    if (tx == 0 && sl.d0 == 0)
      p.lse_out[(int64_t)g.bh * p.Sq + r] = m[i] + logf(lc);
  }
}

// The scores S = Q.K^T and dP = dO.V^T of a (64-query, 64-key) pair over
// all of D, chunk by chunk, the chunk at `last` (a multiple of 128) last,
// so that it stays in Qs, dOs, Ks and Vs.
__device__ __forceinline__ void wide_scores(
    float (&s)[kTM][4], float (&dp)[kTM][4], float* Qs, float* dOs,
    float* Ks, float* Vs, const Params& p, const Head& g, int D, int q0,
    int k0, int last, int ty, int tx) {
  const float* qb = static_cast<const float*>(p.q) + g.q + q0 * p.ldq;
  const float* dob = static_cast<const float*>(p.dout) + g.o + q0 * g.ldo;
  const float* kb = static_cast<const float*>(p.k) + g.k + k0 * p.ldk;
  const float* vb = static_cast<const float*>(p.v) + g.v + k0 * p.ldk;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  const int ns = (D + kWS - 1) / kWS;
  for (int t = 1; t <= ns; ++t) {
    const int c0 = (last + t * kWS) % (ns * kWS);
    __syncthreads();  // the previous chunks (and P, dS) are consumed
    load_chunk(Qs, qb + c0, p.ldq, p.Sq - q0, D - c0);
    load_chunk(dOs, dob + c0, g.ldo, p.Sq - q0, D - c0);
    load_chunk(Ks, kb + c0, p.ldk, p.Sk - k0, D - c0);
    load_chunk(Vs, vb + c0, p.ldk, p.Sk - k0, D - c0);
    __syncthreads();
    tile_product<4, kWS, kLW, 1, 1, kLW>(s, Qs, Ks, ty, tx);
    tile_product<4, kWS, kLW, 1, 1, kLW>(dp, dOs, Vs, ty, tx);
  }
}

__global__ void __launch_bounds__(kThreads)
dkdv_wide_kernel(const Params p, int D) {
  constexpr int TD = kWS / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * kLW;
  float* Ks = dOs + kTile * kLW;
  float* Vs = Ks + kTile * kLW;
  float* Ps = Vs + kTile * kLW;
  float* dSs = Ps + kTile * kLS;

  const Head g = head(p, D);
  const Slice sl = slice_of((p.Sk + kTile - 1) / kTile, D);
  const int k0 = sl.tile * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const Keep kc = keep_consts(p);

  float dk[kTM][TD], dv[kTM][TD];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = first_query(p, k0) / kTile * kTile; q0 < p.Sq; q0 += kTile) {
    float s[kTM][4], dp[kTM][4], lse_r[kTM], delta_r[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      row_stats(p, g, q0 + ty + 16 * i, lse_r[i], delta_r[i]);
    wide_scores(s, dp, Qs, dOs, Ks, Vs, p, g, D, q0, k0, sl.d0, ty, tx);
    probs_and_dscores(s, dp, lse_r, delta_r, Ps, dSs, p, g, q0, k0, kc, ty,
                      tx);
    __syncthreads();
    // this slice: dV += (P keep)^T dO, dK += dS^T Q
    tile_product<TD, kTile, 1, kLS, kLW, 1>(dv, Ps, dOs, ty, tx);
    tile_product<TD, kTile, 1, kLS, kLW, 1>(dk, dSs, Qs, ty, tx);
  }

  float* dkb = static_cast<float*>(p.dk) + g.k + sl.d0;
  float* dvb = static_cast<float*>(p.dv) + g.v + sl.d0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int c = tx + 16 * j;
      if (c >= sl.dn) continue;
      dkb[r * p.ldk + c] = dk[i][j];
      dvb[r * p.ldk + c] = dv[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dq_wide_kernel(const Params p, int D) {
  constexpr int TD = kWS / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * kLW;
  float* Ks = dOs + kTile * kLW;
  float* Vs = Ks + kTile * kLW;
  float* dSs = Vs + kTile * kLW;

  const Head g = head(p, D);
  const int nq = (p.Sq + kTile - 1) / kTile;
  const Slice sl = slice_of(nq, D);
  const int q0 = (nq - 1 - sl.tile) * kTile;   // longest rows first
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const Keep kc = keep_consts(p);

  float dq[kTM][TD], lse_r[kTM], delta_r[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    row_stats(p, g, q0 + ty + 16 * i, lse_r[i], delta_r[i]);
#pragma unroll
    for (int j = 0; j < TD; ++j) dq[i][j] = 0.f;
  }

  const int nk = key_tiles(p, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    float s[kTM][4], dp[kTM][4];
    wide_scores(s, dp, Qs, dOs, Ks, Vs, p, g, D, q0, k0, sl.d0, ty, tx);
    probs_and_dscores(s, dp, lse_r, delta_r, nullptr, dSs, p, g, q0, k0, kc,
                      ty, tx);
    __syncthreads();
    // this slice: dQ += dS K
    tile_product<TD, kTile, kLS, 1, kLW, 1>(dq, dSs, Ks, ty, tx);
  }

  float* dqb = static_cast<float*>(p.dq) + g.q + sl.d0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j)
      if (tx + 16 * j < sl.dn) dqb[r * p.ldq + tx + 16 * j] = dq[i][j];
  }
}

// bf16 above 256: the same slicing on the tensor cores (mma.sync
// m16n8k16, f32 accumulate). Each of 4 warps owns 16 rows of its block's
// 64-row tile (query rows in the forward and the dq pass, key rows in the
// dk/dv pass); operands come from bf16 tiles in shared memory whose
// contraction dimension is contiguous, rows padded by 8 elements so the 8
// rows x 4 words of a fragment load hit 32 distinct banks; an operand
// needed with its other dimension contiguous (V for P.V, Q and dO for
// dK and dV, K for dQ) is copied transposed. The f32 results of one
// product become the bf16 A operand of the next in registers, which
// rounds p*keep and ds to bf16 as the reference does.
constexpr int kTC = 128;              // 4 warps x 16 rows
constexpr int kCP = kWS + 8;          // padded row of a [rows][128] chunk
constexpr int kBQ = 32;               // query rows a step of the dk/dv pass

__device__ __forceinline__ uint32_t ld32(const e16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// A fragment (16 x 16) of a tile stored [m][k] with row stride ld.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const e16* t, int ld,
                                       int m0, int k0, int gi, int qi) {
  const e16* p = t + (m0 + gi) * ld + k0 + 2 * qi;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}
// B fragment (k 16 x n 8) of a tile stored [n][k] with row stride ld.
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const e16* t, int ld,
                                       int n0, int k0, int gi, int qi) {
  const e16* p = t + (n0 + gi) * ld + k0 + 2 * qi;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32" PTT_AB ".f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// ROWS x 128 of src (rows `ld` apart) into shared [ROWS][kCP], 16 bytes a
// load; rows at or past `nvalid` and columns at or past `ncols` (a
// multiple of 8) are zeros.
template <int ROWS>
__device__ __forceinline__ void copy_chunk(e16* dst, const e16* src,
                                           int64_t ld, int nvalid,
                                           int ncols) {
  for (int i = threadIdx.x; i < ROWS * (kWS / 8); i += kTC) {
    const int r = i / (kWS / 8), c = (i % (kWS / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * kCP + c) =
        r < nvalid && c < ncols
            ? *reinterpret_cast<const uint4*>(src + r * ld + c)
            : make_uint4(0u, 0u, 0u, 0u);
  }
}
// The same transposed into shared [128][ROWS + 8]; a warp takes 32 rows
// of one 8-column piece, so its stores land on consecutive halves.
template <int ROWS>
__device__ __forceinline__ void copy_chunk_t(e16* dst, const e16* src,
                                             int64_t ld, int nvalid,
                                             int ncols) {
  for (int i = threadIdx.x; i < ROWS * (kWS / 8); i += kTC) {
    const int r = i % ROWS, c = (i / ROWS) * 8;
    const uint4 v = r < nvalid && c < ncols
                        ? *reinterpret_cast<const uint4*>(src + r * ld + c)
                        : make_uint4(0u, 0u, 0u, 0u);
    const e16* e = reinterpret_cast<const e16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * (ROWS + 8) + r] = e[j];
  }
}
// acc[n] += A . B^T over one 128-column chunk: A the warp's 16 rows at
// m0 of a [rows][kCP] tile, B the N x 8 rows of another.
template <int N>
__device__ __forceinline__ void chunk_product(float (&acc)[N][4],
                                              const e16* A, const e16* B,
                                              int m0, int gi, int qi) {
#pragma unroll
  for (int kk = 0; kk < kWS / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, A, kCP, m0, kk * 16, gi, qi);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      uint32_t b[2];
      frag_b(b, B, kCP, n * 8, kk * 16, gi, qi);
      mma(acc[n], a, b);
    }
  }
}

__global__ void __launch_bounds__(kTC) fwd_wide_tc_kernel(const Params p,
                                                          int D) {
  constexpr int NO = kWS / 8;            // 8-column n-tiles of the slice
  constexpr int LT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  e16* Qs = reinterpret_cast<e16*>(smem_raw);      // [64][kCP] chunk
  e16* Ks = Qs + kTile * kCP;                        // [64][kCP] chunk
  e16* Vt = Ks + kTile * kCP;                        // [128][LT] slice

  const Head g = head(p, D);
  const int nq = (p.Sq + kTile - 1) / kTile;
  const Slice sl = slice_of(nq, D);
  const int q0 = (nq - 1 - sl.tile) * kTile;   // longest rows first
  const int lane = threadIdx.x & 31, gi = lane >> 2, qi = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int row = q0 + r0 + gi;                 // this thread's rows: row,
  const e16* qb = static_cast<const e16*>(p.q) + g.q;   // row + 8
  const e16* kb = static_cast<const e16*>(p.k) + g.k;
  const e16* vb = static_cast<const e16*>(p.v) + g.v;
  const Keep kc = keep_consts(p);

  float o[NO][4], m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const int nk = key_tiles(p, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kWS) {
      __syncthreads();  // the previous chunks (and V) are consumed
      copy_chunk<kTile>(Qs, qb + q0 * p.ldq + c0, p.ldq, p.Sq - q0, D - c0);
      copy_chunk<kTile>(Ks, kb + k0 * p.ldk + c0, p.ldk, p.Sk - k0, D - c0);
      __syncthreads();
      chunk_product(s, Qs, Ks, r0, gi, qi);
    }
    copy_chunk_t<kTile>(Vt, vb + k0 * p.ldk + sl.d0, p.ldk, p.Sk - k0,
                        sl.dn);
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = score(s[n][e], p, g.b, row + 8 * (e >> 1),
                        k0 + n * 8 + 2 * qi + (e & 1));
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - m_new[h]);
    }
    const Drop dr = tile_drop(p, kc, g.b, g.h, q0, k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = expf(s[n][e] - m_new[e >> 1]);
        sum[e >> 1] += pv;
        if (p.use_drop)
          pv = dr.kept(row + 8 * (e >> 1), k0 + n * 8 + 2 * qi + (e & 1))
                   ? pv * kc.inv
                   : 0.f;
        s[n][e] = pv;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
      m[h] = m_new[h];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    __syncthreads();  // V's slice is in place
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      as_a(pa, s, kk);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b[2];
        frag_b(b, Vt, LT, n * 8, kk * 16, gi, qi);
        mma(o[n], pa, b);
      }
    }
  }

  e16* out = static_cast<e16*>(p.out) + g.o + sl.d0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= p.Sq) continue;
    const float lc = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (n * 8 < sl.dn)
        *reinterpret_cast<uint32_t*>(out + r * g.ldo + n * 8 + 2 * qi) =
            pack16(o[n][2 * h] / lc, o[n][2 * h + 1] / lc);
    if (qi == 0 && sl.d0 == 0)
      p.lse_out[(int64_t)g.bh * p.Sq + r] = m[h] + logf(lc);
  }
}

__global__ void __launch_bounds__(kTC) dkdv_wide_tc_kernel(const Params p,
                                                           int D) {
  constexpr int NO = kWS / 8, NQ = kBQ / 8, LQ = kBQ + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  e16* Ks = reinterpret_cast<e16*>(smem_raw);      // [64][kCP] chunk
  e16* Vs = Ks + kTile * kCP;                        // [64][kCP] chunk
  e16* Qs = Vs + kTile * kCP;                        // [kBQ][kCP] chunk
  e16* dOs = Qs + kBQ * kCP;                         // [kBQ][kCP] chunk
  e16* Qt = dOs + kBQ * kCP;                         // [128][LQ] slice
  e16* dOt = Qt + kWS * LQ;                          // [128][LQ] slice
  float* lse_s = reinterpret_cast<float*>(dOt + kWS * LQ);
  float* delta_s = lse_s + kBQ;

  const Head g = head(p, D);
  const Slice sl = slice_of((p.Sk + kTile - 1) / kTile, D);
  const int k0 = sl.tile * kTile;
  const int lane = threadIdx.x & 31, gi = lane >> 2, qi = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int key = k0 + r0 + gi;                 // this thread's keys: key,
  const e16* qb = static_cast<const e16*>(p.q) + g.q;   // key + 8
  const e16* dob = static_cast<const e16*>(p.dout) + g.o;
  const e16* kb = static_cast<const e16*>(p.k) + g.k + k0 * p.ldk;
  const e16* vb = static_cast<const e16*>(p.v) + g.v + k0 * p.ldk;
  const Keep kc = keep_consts(p);

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int q0 = first_query(p, k0) / kBQ * kBQ; q0 < p.Sq; q0 += kBQ) {
    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kWS) {
      __syncthreads();  // the previous chunks and slices are consumed
      copy_chunk<kTile>(Ks, kb + c0, p.ldk, p.Sk - k0, D - c0);
      copy_chunk<kTile>(Vs, vb + c0, p.ldk, p.Sk - k0, D - c0);
      copy_chunk<kBQ>(Qs, qb + q0 * p.ldq + c0, p.ldq, p.Sq - q0, D - c0);
      copy_chunk<kBQ>(dOs, dob + q0 * g.ldo + c0, g.ldo, p.Sq - q0,
                      D - c0);
      if (c0 == sl.d0) {
        copy_chunk_t<kBQ>(Qt, qb + q0 * p.ldq + c0, p.ldq, p.Sq - q0,
                          sl.dn);
        copy_chunk_t<kBQ>(dOt, dob + q0 * g.ldo + c0, g.ldo, p.Sq - q0,
                          sl.dn);
      }
      if (c0 == 0 && threadIdx.x < kBQ) {
        float lse, delta;
        row_stats(p, g, q0 + threadIdx.x, lse, delta);
        lse_s[threadIdx.x] = lse;
        delta_s[threadIdx.x] = delta;
      }
      __syncthreads();
      chunk_product(st, Ks, Qs, r0, gi, qi);
      chunk_product(dpt, Vs, dOs, r0, gi, qi);
    }
    const Drop dr = tile_drop(p, kc, g.b, g.h, q0, k0);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc_ = key + 8 * (e >> 1);
        const int ql = n * 8 + 2 * qi + (e & 1), q = q0 + ql;
        const float pr = expf(score(st[n][e], p, g.b, q, kc_) - lse_s[ql]);
        const float ks =
            !p.use_drop ? 1.f : dr.kept(q, kc_) ? kc.inv : 0.f;
        st[n][e] = pr * ks;                                          // P*keep
        dpt[n][e] = pr * (dpt[n][e] * ks - delta_s[ql]) * p.scale;   // dS
      }
    // this slice: dV += (P*keep)^T dO, dK += dS^T Q (over the queries)
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      as_a(pa, st, kk);
      as_a(da, dpt, kk);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b[2];
        frag_b(b, dOt, LQ, n * 8, kk * 16, gi, qi);
        mma(dv[n], pa, b);
        frag_b(b, Qt, LQ, n * 8, kk * 16, gi, qi);
        mma(dk[n], da, b);
      }
    }
  }

  e16* dkb = static_cast<e16*>(p.dk) + g.k + sl.d0;
  e16* dvb = static_cast<e16*>(p.dv) + g.v + sl.d0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = key + 8 * h;
    if (r >= p.Sk) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n * 8 >= sl.dn) continue;
      *reinterpret_cast<uint32_t*>(dkb + r * p.ldk + n * 8 + 2 * qi) =
          pack16(dk[n][2 * h], dk[n][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvb + r * p.ldk + n * 8 + 2 * qi) =
          pack16(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(kTC) dq_wide_tc_kernel(const Params p,
                                                         int D) {
  constexpr int NO = kWS / 8, LT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  e16* Qs = reinterpret_cast<e16*>(smem_raw);      // [64][kCP] chunks
  e16* dOs = Qs + kTile * kCP;
  e16* Ks = dOs + kTile * kCP;
  e16* Vs = Ks + kTile * kCP;
  e16* Kt = Vs + kTile * kCP;                        // [128][LT] slice

  const Head g = head(p, D);
  const int nq = (p.Sq + kTile - 1) / kTile;
  const Slice sl = slice_of(nq, D);
  const int q0 = (nq - 1 - sl.tile) * kTile;   // longest rows first
  const int lane = threadIdx.x & 31, gi = lane >> 2, qi = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int row = q0 + r0 + gi;                 // this thread's rows: row,
  const e16* qb = static_cast<const e16*>(p.q) + g.q + q0 * p.ldq;
  const e16* dob = static_cast<const e16*>(p.dout) + g.o + q0 * g.ldo;
  const e16* kb = static_cast<const e16*>(p.k) + g.k;   // row + 8
  const e16* vb = static_cast<const e16*>(p.v) + g.v;
  const Keep kc = keep_consts(p);

  float lse_r[2], delta_r[2], dq[NO][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) row_stats(p, g, row + 8 * h, lse_r[h], delta_r[h]);
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const int nk = key_tiles(p, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kWS) {
      __syncthreads();  // the previous chunks and slice are consumed
      copy_chunk<kTile>(Qs, qb + c0, p.ldq, p.Sq - q0, D - c0);
      copy_chunk<kTile>(dOs, dob + c0, g.ldo, p.Sq - q0, D - c0);
      copy_chunk<kTile>(Ks, kb + k0 * p.ldk + c0, p.ldk, p.Sk - k0, D - c0);
      copy_chunk<kTile>(Vs, vb + k0 * p.ldk + c0, p.ldk, p.Sk - k0, D - c0);
      if (c0 == sl.d0)
        copy_chunk_t<kTile>(Kt, kb + k0 * p.ldk + c0, p.ldk, p.Sk - k0,
                            sl.dn);
      __syncthreads();
      chunk_product(s, Qs, Ks, r0, gi, qi);
      chunk_product(dp, dOs, Vs, r0, gi, qi);
    }
    const Drop dr = tile_drop(p, kc, g.b, g.h, q0, k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + 8 * (e >> 1), c = k0 + n * 8 + 2 * qi + (e & 1);
        const float pr = expf(score(s[n][e], p, g.b, r, c) - lse_r[e >> 1]);
        const float ks = !p.use_drop ? 1.f : dr.kept(r, c) ? kc.inv : 0.f;
        s[n][e] = pr * (dp[n][e] * ks - delta_r[e >> 1]) * p.scale;   // dS
      }
    // this slice: dQ += dS K (over the keys)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t da[4];
      as_a(da, s, kk);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b[2];
        frag_b(b, Kt, LT, n * 8, kk * 16, gi, qi);
        mma(dq[n], da, b);
      }
    }
  }

  e16* dqb = static_cast<e16*>(p.dq) + g.q + sl.d0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (n * 8 < sl.dn)
        *reinterpret_cast<uint32_t*>(dqb + r * p.ldq + n * 8 + 2 * qi) =
            pack16(dq[n][2 * h], dq[n][2 * h + 1]);
  }
}

// ------------------------------------------- bf16: Hopper (TMA and wgmma)
using hopper::ex2;
using hopper::kBox;
using hopper::kBoxBytes;
using hopper::kLog2e;

constexpr int kRowsW = 64;        // query rows of a consumer warpgroup
constexpr int kKeysW = 128;       // keys of a forward K/V tile at D <= 128;
                                  // of a backward block (64 a consumer)
constexpr int kKeysN = 64;        // the same above D = 128
constexpr int kThreadsW = 384;    // producer + 2 consumer warpgroups
constexpr int kSlabBytes = 2 * kBoxBytes;   // 128 rows x 64 columns

// The call's tensor maps: q as a 2-D [B*Sq, ldq] array, k and v as
// [B*Sk, ldk] (a head's columns by `head_col`; over the fused projection
// the three maps are one), dO as [B*Sq, H*D] (columns h*D), 64 x 64
// boxes, 128-byte swizzle. Rows past a batch's end read the next batch's
// rows (their scores are replaced or their p is 0) and rows past the
// array read 0.
struct Maps {
  CUtensorMap q, k, v, dout;
};

// The additive bias as a [B|1, 1, Sk] key-padding row (`row` set: read
// from the row staged in shared memory) or a full [B|1, Sq, Sk] bias
// (read per element, `full` set).
struct BiasRows {
  const float* row;
  bool full;
};
__device__ __forceinline__ BiasRows bias_rows(const Params& p, int b) {
  BiasRows r{nullptr, false};
  if (p.bias == nullptr) return r;
  const int bb = p.bias_b == 1 ? 0 : b;
  if (p.bias_q == 1) {
    r.row = p.bias + (int64_t)bb * p.Sk;
  } else {
    r.row = p.bias + (int64_t)bb * p.Sq * p.Sk;  // row q at + q * Sk
    r.full = true;
  }
  return r;
}
// Element (q, c) of a full bias (c < Sk).
__device__ __forceinline__ float full_bias(const Params& p, const float* rows,
                                           int q, int c) {
  return __ldg(rows + (int64_t)min(q, p.Sq - 1) * p.Sk + c);
}

// 32 producer lanes stage the key-padding row's columns [k0, k0 + kKeys)
// (0 past Sk) in shared memory.
template <int kKeys>
__device__ __forceinline__ void stage_bias_row(float* dst, const float* row,
                                               int k0, int Sk, int lane) {
#pragma unroll
  for (int i = 0; i < kKeys / 32; ++i) {
    const int col = lane + 32 * i, c = k0 + col;
    dst[col] = c < Sk ? __ldg(row + c) : 0.f;
  }
}

// ---------------------------------------------------------------- forward
// Persistent grid: one block an SM walks 128-query tiles, longest causal
// rows first. A producer warp loads each tile's Q (double-buffered at D <=
// 128, single above) and streams its K and V tiles (`fwd_keys` keys) by
// TMA through a ring of `fwd_stages` stages, with the key-padding bias
// row of each; two consumer warpgroups of 64 query rows compute S =
// Q.K^T (wgmma from shared memory), the online softmax on the
// accumulator fragments, and O += P.V (P in registers, V through a
// transposed descriptor, N = D in one product). Shared memory: Q [Q
// buffers][2 halves][D/64 boxes], then per stage K and V [D/64
// slabs][keys][64 columns], each box as the TMA writes it.
template <int D>
__host__ __device__ constexpr int fwd_keys() {
  return D <= 128 ? kKeysW : kKeysN;
}
template <int D>
__host__ __device__ constexpr int fwd_qbufs() {
  return D <= 128 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int fwd_stages() {
  return D == 128 || D == 256 ? 2 : 3;
}
template <int D>
constexpr size_t fwd_wg_smem() {
  return 1024 + (size_t)(2 * fwd_qbufs<D>() +
                         2 * fwd_stages<D>() * (fwd_keys<D>() / kBox)) *
                    (D / kBox) * kBoxBytes;
}

struct FwdTile {
  int qt, h, b;
};
__device__ __forceinline__ FwdTile fwd_tile(int t, int nq, int H, int B) {
  const int j = t / (H * B), r = t % (H * B);
  return {nq - 1 - j, r % H, r / H};
}

// Key tiles of kKeys that the 128-query tile at q0 needs.
template <int kKeys>
__device__ __forceinline__ int fwd_key_tiles(const Params& p, int q0) {
  const int n = (p.Sk + kKeys - 1) / kKeys;
  if (!p.causal) return n;
  const int last = p.off + min(q0 + 2 * kRowsW, p.Sq) - 1;
  return last < 0 ? 0 : min(n, last / kKeys + 1);
}

// The forward's scores of one key tile in a consumer thread's
// fragments (rows row, row + 8; columns j*8 + 2qi + (e & 1)), and their
// row maxima: kPlain s = q.k * scale; kRowBias adds the staged
// key-padding row; kGeneral adds either bias and replaces a key past Sk
// or past the causal diagonal by -1e30.
constexpr int kPlain = 0, kRowBias = 1, kGeneral = 2;
template <int kMode, int NS>
__device__ __forceinline__ void fwd_scores(float (&sc)[NS][4],
                                           float (&mx)[2], const Params& p,
                                           const BiasRows& br,
                                           const float* bias_tile, int row,
                                           int k0, int qi) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * qi + (e & 1), ck = k0 + col;
      float v = sc[j][e] * p.scale;
      if (kMode == kRowBias) v += bias_tile[col];
      if (kMode == kGeneral) {
        const int r = row + 8 * (e >> 1);
        if (br.full) {
          if (ck < p.Sk) v += full_bias(p, br.row, r, ck);
        } else if (br.row != nullptr) {
          v += bias_tile[col];
        }
        if (ck >= p.Sk || (p.causal && p.off + r < ck)) v = kMasked;
      }
      sc[j][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
}

// The forward's p = exp(s - m) of one tile in place, summed raw into
// `sum`, then times keep/scale with dropout (a template parameter, like
// the score forms, so that no per-score branch remains).
template <bool kDrop, int NS>
__device__ __forceinline__ void fwd_probs(float (&sc)[NS][4],
                                          float (&sum)[2],
                                          const float (&m)[2], const Drop& dr,
                                          float inv_keep, int row, int k0,
                                          int qi) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pv = ex2((sc[j][e] - m[e >> 1]) * kLog2e);
      sum[e >> 1] += pv;
      if (kDrop)
        pv = dr.kept(row + 8 * (e >> 1), k0 + j * 8 + 2 * qi + (e & 1))
                 ? pv * inv_keep
                 : 0.f;
      sc[j][e] = pv;
    }
}

template <int D>
__global__ void __launch_bounds__(kThreadsW, 1)
fwd_wg_kernel(const __grid_constant__ Maps maps, const Params p) {
  using namespace hopper;
  constexpr int NB = D / kBox;          // boxes across a head's columns
  constexpr int ND = D / 8;             // 8-column n-tiles of O
  constexpr int kKeys = fwd_keys<D>();  // keys of a K/V tile
  constexpr int NS = kKeys / 8;         // 8-column n-tiles of S
  constexpr int kStages = fwd_stages<D>();
  constexpr int kQBufs = fwd_qbufs<D>();
  constexpr int kTileBytes = NB * kBoxBytes;          // 64 rows x D
  constexpr int kKSlab = kKeys * 128;                 // kKeys rows x 64
  constexpr int kKVBytes = NB * kKSlab;               // kKeys keys x D
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages], empty_bar[kStages];
  __shared__ __align__(8) uint64_t qfull_bar[kQBufs], qempty_bar[kQBufs];
  __shared__ float bias_s[kStages][kKeys];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;                    // [kQBufs tiles][2][NB]
  unsigned char* KVs = smem + 2 * kQBufs * kTileBytes;  // [stage][K|V][NB]

  const int nq = (p.Sq + 2 * kRowsW - 1) / (2 * kRowsW);
  const int tiles = nq * p.H * p.B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1 + 32);   // expect_tx + every producer lane
      mbar_init(&empty_bar[s], 2 * 4);   // one arrival a consumer warp
    }
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(&qfull_bar[i], 1);
      mbar_init(&qempty_bar[i], 2 * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int it = 0;                          // K/V tiles issued so far
      int n = 0;                           // query tiles of this block
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
        const FwdTile f = fwd_tile(t, nq, p.H, p.B);
        const BiasRows br = bias_rows(p, f.b);
        const int q0 = f.qt * 2 * kRowsW;
        const int nk = fwd_key_tiles<kKeys>(p, q0);
        const int qb = n % kQBufs;
        const int col = head_col(p, f.h, D);
        // the warp waits together; lane 0 issues the copies
        mbar_wait(&qempty_bar[qb], ((n / kQBufs) & 1) ^ 1);
        if (lane == 0) {
          const int active = min(2, (p.Sq - q0 + kRowsW - 1) / kRowsW);
          mbar_expect_tx(&qfull_bar[qb], active * kTileBytes);
          for (int c = 0; c < active; ++c)
            for (int j = 0; j < NB; ++j)
              tma_load_2d(Qs + ((qb * 2 + c) * NB + j) * kBoxBytes, &maps.q,
                          &qfull_bar[qb], col + p.qcol + j * kBox,
                          f.b * p.Sq + q0 + c * kRowsW);
        }
        __syncwarp();
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty_bar[s], ((it / kStages) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(&full_bar[s], 2 * kKVBytes);
            unsigned char* Ks = KVs + s * 2 * kKVBytes;
            unsigned char* Vs = Ks + kKVBytes;
            // each 64-column slab: kKeys / 64 boxes, one after the other
            for (int j = 0; j < NB; ++j)
              for (int r = 0; r < kKeys / kBox; ++r) {
                const int row = f.b * p.Sk + kt * kKeys + r * kBox;
                tma_load_2d(Ks + j * kKSlab + r * kBoxBytes, &maps.k,
                            &full_bar[s], col + p.kcol + j * kBox, row);
                tma_load_2d(Vs + j * kKSlab + r * kBoxBytes, &maps.v,
                            &full_bar[s], col + p.vcol + j * kBox, row);
              }
          }
          __syncwarp();
          if (br.row != nullptr && !br.full)
            stage_bias_row<kKeys>(bias_s[s], br.row, kt * kKeys, p.Sk,
                                  lane);
          mbar_arrive(&full_bar[s]);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<232>();
  const int c = wg - 1;                  // this warpgroup's 64 rows
  const int t_in = threadIdx.x - 128 * wg;
  const int lane = t_in & 31, gi = lane >> 2, qi = lane & 3;
  const int r0 = (t_in >> 5) * 16;       // this warp's rows in the 64
  const Keep kc = keep_consts(p);
  const int64_t ld = (int64_t)p.H * D;
  int it = 0, n = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
    const FwdTile f = fwd_tile(t, nq, p.H, p.B);
    const BiasRows br = bias_rows(p, f.b);
    const int bh = f.b * p.H + f.h;
    const int q0 = f.qt * 2 * kRowsW;
    const int nk = fwd_key_tiles<kKeys>(p, q0);
    const int my_q0 = q0 + c * kRowsW;
    const bool live = my_q0 < p.Sq;
    const int my_nk = live ? nk : 0;
    const int row = my_q0 + r0 + gi;     // this thread's rows: row, row + 8
    const int qb = n % kQBufs;
    const unsigned char* Qc = Qs + (qb * 2 + c) * kTileBytes;

    float o[ND][4], m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    if (live) mbar_wait(&qfull_bar[qb], (n / kQBufs) & 1);

    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full_bar[s], (it / kStages) & 1);
      if (kt < my_nk) {
        const unsigned char* Ks = KVs + s * 2 * kKVBytes;
        const unsigned char* Vs = Ks + kKVBytes;
        const int k0 = kt * kKeys;
        float sc[NS][4];
        // S = Q.K^T: 16-column steps of the head dim, 32 bytes apart
        // inside a box's swizzled 128-byte rows
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint64_t dq = desc_sw128(
              Qc + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
          const uint64_t dk =
              desc_sw128(Ks + (kk / 4) * kKSlab + (kk % 4) * 32, 16, 1024);
          if constexpr (kKeys == 64)
            wgmma_ss_n64<0>(sc, dq, dk, kk > 0);
          else
            wgmma_ss_n128(sc, dq, dk, kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        reg_fence(sc);
        // s = q.k * scale + bias; a key past Sk or past the causal
        // diagonal is replaced by -1e30. The general form (per-element
        // checks, a full bias) only where a tile needs it: predicated
        // instructions still issue, and per score they cost as much as
        // the rest of the softmax
        const bool cut = k0 + kKeys > p.Sk ||
                         (p.causal && p.off + my_q0 < k0 + kKeys - 1);
        float mx[2] = {kMasked, kMasked};
        if (cut || br.full)
          fwd_scores<kGeneral>(sc, mx, p, br, bias_s[s], row, k0, qi);
        else if (br.row != nullptr)
          fwd_scores<kRowBias>(sc, mx, p, br, bias_s[s], row, k0, qi);
        else
          fwd_scores<kPlain>(sc, mx, p, br, bias_s[s], row, k0, qi);
        // the exponentials as ex2 of (s - m) * log2(e): m stays in natural
        // units, so lse is m + log(l) as the reference forms it, even at
        // the -1e9 of a fully masked row
        float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m_new[h] = fmaxf(m[h], quad_max(mx[h]));
          alpha[h] = ex2((m[h] - m_new[h]) * kLog2e);
        }
        if (p.use_drop)
          fwd_probs<true>(sc, sum, m_new, tile_drop(p, kc, f.b, f.h, q0, k0),
                          kc.inv, row, k0, qi);
        else
          fwd_probs<false>(sc, sum, m_new, Drop{}, 1.f, row, k0, qi);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
          m[h] = m_new[h];
        }
#pragma unroll
        for (int j = 0; j < ND; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
        // O += P.V: 16 keys a step, V's rows 16 x 128 bytes apart; each
        // further 64 columns of the head lie one slab further
        uint32_t pa[NS / 2][4];
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) as_a(pa[kk], sc, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
          const uint64_t dv = desc_sw128(Vs + kk * 16 * 128, kKSlab, 1024);
          if constexpr (D == 64)
            wgmma_rs_n64(o, pa[kk], dv);
          else if constexpr (D == 128)
            wgmma_rs_n128(o, pa[kk], dv);
          else if constexpr (D == 192)
            wgmma_rs_n192(o, pa[kk], dv);
          else
            wgmma_rs_n256(o, pa[kk], dv);
        }
        wgmma_commit();
        wgmma_wait0();
        reg_fence(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[s]);
    }
    // this tile's Q is read: the producer may load the tile after next
    __syncwarp();
    if (lane == 0) mbar_arrive(&qempty_bar[qb]);
    if (!live) continue;

    e16* out = static_cast<e16*>(p.out) + (int64_t)f.b * p.Sq * ld +
                (int64_t)f.h * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= p.Sq) continue;
      const float lc = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<uint32_t*>(out + r * ld + j * 8 + 2 * qi) =
            pack16(o[j][2 * h] / lc, o[j][2 * h + 1] / lc);
      if (qi == 0) p.lse_out[(int64_t)bh * p.Sq + r] = m[h] + logf(lc);
    }
  }
}

// --------------------------------------------------------------- backward
// One pass over key blocks. A block owns (b, h, 128 keys); its producer
// warp loads the block's K and V once by TMA (with the key-padding bias
// row), then streams 64-row Q and dO tiles with their lse and delta rows
// through a ring of `bwd_stages` stages. Two consumer warpgroups own 64
// of the keys each and, per query tile, form S^T = K Q^T and dP^T = V dO^T
// (wgmma, K-major descriptors), P^T and dS^T once per score in registers
// (one hash, ex2), add dV += (P^T keep) dO and dK += dS^T Q (A in
// registers, B MN-major), write dS^T to shared memory and, after a
// barrier of the two, form dQ's 64 x D/2 share of this block, dS K over
// all 128 keys (both operands MN-major), which red.global adds into an
// f32 accumulator. Shared memory (every box as the TMA writes it): K, V
// [D/64 slabs][128 rows][64 columns]; per stage Q, dO [D/64][64][64];
// dS^T [2 buffers][128 keys][64 queries], swizzled the same way.
template <int D>
__host__ __device__ constexpr int bwd_stages() {
  return D == 128 ? 2 : 3;
}
template <int D>
constexpr size_t bwd_wg_smem() {
  return 1024 + (size_t)(4 * (D / kBox) + 2 * (D / kBox) * bwd_stages<D>() +
                         4) * kBoxBytes;
}

// The backward's P^T of one 64-query tile in a consumer thread's
// fragments (keys key[0], key[1]; queries q0 + j*8 + 2qi + (e & 1)): p =
// exp(s - lse) with s = q.k * scale plus the key's bias, or in the general
// form either bias and the -1e30 replacement. Returns the keep bits of
// the 32 scores (bit j*4 + e) with dropout (kDrop), else 0.
template <bool kGeneral, bool kDrop>
__device__ __forceinline__ uint32_t bwd_probs(
    float (&st)[8][4], const Params& p, const BiasRows& br,
    const float (&kbias)[2], const int (&key)[2], const float* lse_tile,
    const Drop& dr, int q0, int qi) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ql = j * 8 + 2 * qi + (e & 1), q = q0 + ql;
      const int kk = key[e >> 1];
      float v = st[j][e] * p.scale;
      if (kGeneral) {
        if (br.full) {
          if (kk < p.Sk) v += full_bias(p, br.row, q, kk);
        } else {
          v += kbias[e >> 1];
        }
        if (kk >= p.Sk || (p.causal && p.off + q < kk)) v = kMasked;
      } else {
        v += kbias[e >> 1];
      }
      st[j][e] = ex2((v - lse_tile[ql]) * kLog2e);
      if (kDrop && dr.kept(q, kk)) bits |= 1u << (j * 4 + e);
    }
  return bits;
}

// P^T keep and dS^T = P^T (dP^T keep - delta) scale in place, from P^T
// in `st`, dP^T in `dpt` and the keep bits of `bwd_probs`.
template <bool kDrop>
__device__ __forceinline__ void bwd_dscores(float (&st)[8][4],
                                            float (&dpt)[8][4],
                                            uint32_t keep_bits,
                                            float inv_keep,
                                            const float* delta_tile,
                                            float scale, int qi) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ks =
          !kDrop ? 1.f : ((keep_bits >> (j * 4 + e)) & 1u) ? inv_keep : 0.f;
      const float pr = st[j][e];
      st[j][e] = pr * ks;
      dpt[j][e] =
          pr * (dpt[j][e] * ks - delta_tile[j * 8 + 2 * qi + (e & 1)]) * scale;
    }
}

template <int D>
__global__ void __launch_bounds__(kThreadsW, 1)
bwd_wg_kernel(const __grid_constant__ Maps maps, const Params p) {
  using namespace hopper;
  constexpr int NB = D / kBox;
  constexpr int ND = D / 8;              // 8-column n-tiles of dK, dV
  constexpr int kStages = bwd_stages<D>();
  constexpr int kKVBytes = NB * kSlabBytes;       // 128 keys x D
  constexpr int kTileBytes = NB * kBoxBytes;      // 64 rows x D
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_bar, full_bar[kStages],
      empty_bar[kStages];
  __shared__ float lse_s[kStages][kRowsW], delta_s[kStages][kRowsW];
  __shared__ float bias_s[kKeysW];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + kKVBytes;
  unsigned char* ring = Vs + kKVBytes;            // [stage][Q | dO]
  unsigned char* dSs = ring + kStages * 2 * kTileBytes;   // [2][128][64]

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kKeysW;    // z slowest: causal's longest first
  const int bh = b * p.H + h;
  const int q_first = p.causal ? first_query(p, k0) / kRowsW * kRowsW : 0;
  const BiasRows br = bias_rows(p, b);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&kv_bar, 1 + 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1 + 32);   // expect_tx + every producer lane
      mbar_init(&empty_bar[s], 2 * 4);   // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int col = head_col(p, h, D);
      if (lane == 0) {
        mbar_expect_tx(&kv_bar, 2 * kKVBytes);
        for (int j = 0; j < NB; ++j)
          for (int r = 0; r < 2; ++r) {
            const int row = b * p.Sk + k0 + r * kBox;
            tma_load_2d(Ks + j * kSlabBytes + r * kBoxBytes, &maps.k, &kv_bar,
                        col + p.kcol + j * kBox, row);
            tma_load_2d(Vs + j * kSlabBytes + r * kBoxBytes, &maps.v, &kv_bar,
                        col + p.vcol + j * kBox, row);
          }
      }
      __syncwarp();
      if (br.row != nullptr && !br.full)
        stage_bias_row<kKeysW>(bias_s, br.row, k0, p.Sk, lane);
      mbar_arrive(&kv_bar);
      const float* lse_h = p.lse + (int64_t)bh * p.Sq;
      const float* delta_h = p.delta + (int64_t)bh * p.Sq;
      int i = 0;
      for (int q0 = q_first; q0 < p.Sq; q0 += kRowsW, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty_bar[s], ((i / kStages) & 1) ^ 1);
        if (lane == 0) {
          unsigned char* Qr = ring + s * 2 * kTileBytes;
          mbar_expect_tx(&full_bar[s], 2 * kTileBytes);
          for (int j = 0; j < NB; ++j) {
            tma_load_2d(Qr + j * kBoxBytes, &maps.q, &full_bar[s],
                        col + p.qcol + j * kBox, b * p.Sq + q0);
            tma_load_2d(Qr + kTileBytes + j * kBoxBytes, &maps.dout,
                        &full_bar[s], h * D + j * kBox, b * p.Sq + q0);
          }
        }
        __syncwarp();
        // rows past Sq: lse +inf and delta 0, so their p and dS are 0
#pragma unroll
        for (int r = lane; r < kRowsW; r += 32) {
          const bool in = q0 + r < p.Sq;
          lse_s[s][r] = in ? lse_h[q0 + r] : INFINITY;
          delta_s[s][r] = in ? delta_h[q0 + r] : 0.f;
        }
        mbar_arrive(&full_bar[s]);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<232>();
  const int c = wg - 1;                  // this warpgroup's 64 keys
  const int t_in = threadIdx.x - 128 * wg;
  const int lane = t_in & 31, gi = lane >> 2, qi = lane & 3;
  const int r0 = (t_in >> 5) * 16;       // this warp's rows in the 64
  const int kr = c * kRowsW + r0 + gi;   // this thread's keys in the block:
  const int key[2] = {k0 + kr, k0 + kr + 8};   // kr and kr + 8
  const Keep kc = keep_consts(p);
  const unsigned char* Kc = Ks + c * kBoxBytes;   // this group's 64 rows
  const unsigned char* Vc = Vs + c * kBoxBytes;   // of every slab
  // dQ's B operand: this group's D/2 columns of K, all 128 keys
  const unsigned char* Kq =
      D == 128 ? Ks + c * kSlabBytes : Ks + c * (D / 2) * 2;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  mbar_wait(&kv_bar, 0);
  float kbias[2] = {0.f, 0.f};
  if (br.row != nullptr && !br.full) {
    kbias[0] = bias_s[kr];
    kbias[1] = bias_s[kr + 8];
  }
  const bool cut_keys = k0 + kKeysW > p.Sk;

  int i = 0;
  for (int q0 = q_first; q0 < p.Sq; q0 += kRowsW, ++i) {
    const int s = i % kStages;
    const unsigned char* Qr = ring + s * 2 * kTileBytes;
    const unsigned char* dOr = Qr + kTileBytes;
    unsigned char* dSb = dSs + (i & 1) * kSlabBytes;
    mbar_wait(&full_bar[s], (i / kStages) & 1);

    // S^T = K Q^T, then dP^T = V dO^T: rows are keys, columns queries
    float st[8][4], dpt[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0>(
          st, desc_sw128(Kc + (kk / 4) * kSlabBytes + (kk % 4) * 32, 16, 1024),
          desc_sw128(Qr + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0>(
          dpt, desc_sw128(Vc + (kk / 4) * kSlabBytes + (kk % 4) * 32, 16, 1024),
          desc_sw128(dOr + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait1();
    reg_fence(st);

    // P^T while dP^T is in flight: p = exp(s - lse), and the keep bits
    // (the general form only where the tile needs it, as in the forward)
    const bool cut = cut_keys || (p.causal && p.off + q0 < k0 + kKeysW - 1);
    const Drop dr = tile_drop(p, kc, b, h, q0, k0);
    const float* lse_t = lse_s[s];
    uint32_t keep_bits;
    if (cut || br.full)
      keep_bits = p.use_drop
                      ? bwd_probs<true, true>(st, p, br, kbias, key, lse_t,
                                              dr, q0, qi)
                      : bwd_probs<true, false>(st, p, br, kbias, key, lse_t,
                                               dr, q0, qi);
    else
      keep_bits = p.use_drop
                      ? bwd_probs<false, true>(st, p, br, kbias, key, lse_t,
                                               dr, q0, qi)
                      : bwd_probs<false, false>(st, p, br, kbias, key, lse_t,
                                                dr, q0, qi);
    wgmma_wait0();
    reg_fence(dpt);
    // P^T keep and dS^T = P^T (dP^T keep - delta) scale, rounded to bf16
    // as the A operands of dV and dK
    if (p.use_drop)
      bwd_dscores<true>(st, dpt, keep_bits, kc.inv, delta_s[s], p.scale, qi);
    else
      bwd_dscores<false>(st, dpt, 0u, 1.f, delta_s[s], p.scale, qi);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      as_a(pa[kk], st, kk);
      as_a(da[kk], dpt, kk);
    }
    // dV += (P^T keep) dO, dK += dS^T Q: 16 queries a step, the B
    // operands' rows 16 x 128 bytes apart, D/64 slabs one box apart
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t ddo = desc_sw128(dOr + kk * 16 * 128, kBoxBytes, 1024);
      const uint64_t dq_ = desc_sw128(Qr + kk * 16 * 128, kBoxBytes, 1024);
      if constexpr (D == 64) {
        wgmma_rs_n64(dv, pa[kk], ddo);
        wgmma_rs_n64(dk, da[kk], dq_);
      } else {
        wgmma_rs_n128(dv, pa[kk], ddo);
        wgmma_rs_n128(dk, da[kk], dq_);
      }
    }
    wgmma_commit();
    // dS^T into shared memory ([key][query], 128-byte swizzle): the A
    // fragment's words are the rounded pairs (j = 2kk + (w >> 1), key
    // row kr + 8 (w & 1))
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int rk = kr + 8 * (w & 1), j = 2 * kk + (w >> 1);
        *reinterpret_cast<uint32_t*>(dSb + rk * 128 + ((j ^ (rk & 7)) << 4) +
                                     4 * qi) = da[kk][w];
      }
    fence_proxy_async();
    named_barrier(1, 256);               // both groups' dS^T are written
    // dQ[64 q x D/2] = dS K over the 128 keys: A (dS) is dS^T read
    // transposed, B this group's columns of K, MN-major
    float dq[D / 16][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeysW / 16; ++kk) {
      const uint64_t da_ = desc_sw128(dSb + kk * 16 * 128, kSlabBytes, 1024);
      const uint64_t db_ = desc_sw128(Kq + kk * 16 * 128, kSlabBytes, 1024);
      if constexpr (D == 64)
        wgmma_ss_n32<1>(dq, da_, db_, kk > 0);
      else
        wgmma_ss_n64<1>(dq, da_, db_, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(dq);
    reg_fence(dk);
    reg_fence(dv);
    reg_fence(pa);
    reg_fence(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[s]);   // Q, dO, lse, delta read
    // this block's share of dQ into the f32 accumulator [B, Sq, H, D]
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = q0 + r0 + gi + 8 * hh;
      if (q >= p.Sq) continue;
      float* acc = p.dq_acc + ((int64_t)(b * p.Sq + q) * p.H + h) * D +
                   c * (D / 2) + 2 * qi;
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        atomicAdd(reinterpret_cast<float2*>(acc + j * 8),
                  make_float2(dq[j][2 * hh], dq[j][2 * hh + 1]));
    }
  }

  // dK and dV at k's row stride and this head's columns
  const int64_t kv0 = (int64_t)b * p.Sk * p.ldk + head_col(p, h, D);
  e16* dkb = static_cast<e16*>(p.dk) + kv0 + p.kcol;
  e16* dvb = static_cast<e16*>(p.dv) + kv0 + p.vcol;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kc = key[hh];
    if (kc >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(dkb + kc * p.ldk + j * 8 + 2 * qi) =
          pack16(dk[j][2 * hh], dk[j][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dvb + kc * p.ldk + j * 8 + 2 * qi) =
          pack16(dv[j][2 * hh], dv[j][2 * hh + 1]);
    }
  }
}

// --------------------------------------------- backward above D = 128
// One pass over key blocks as `bwd_wg_kernel`, at D 192 and 256, where a
// 128-key block's K and V (128 KB at D = 256) and two 64 x D dK, dV
// accumulators a warpgroup (256 registers a thread) do not fit. A block
// owns (b, h, 64 keys); its producer warp loads the block's K and V once
// by TMA (with the key-padding bias row), then streams 64-row Q and dO
// tiles with their lse and delta rows through a ring of
// `bwd_wide_stages` stages. The two consumer warpgroups split the work by
// role over the same 64 keys:
// - group 0 forms S^T = K Q^T and P^T (one ex2, one hash a score), hands
//   P^T to group 1 through shared memory (f32, its sign the keep bit),
//   and adds dV += (P^T keep) dO over all D columns (A in registers);
// - group 1 forms dP^T = V dO^T, reads P^T, forms dS^T = P^T (dP^T keep
//   - delta) scale, writes it to shared memory (bf16, swizzled) and adds
//   dK += dS^T Q over all D columns;
// - after a barrier of the two, each forms 64-column chunks of dQ = dS K
//   over the 64 keys (chunks j = group, group + 2, ...; both operands
//   MN-major) and adds them into the f32 accumulator with red.global
//   (float2 atomicAdd), as `bwd_wg_kernel` does: dq's sums arrive in an
//   order that varies from run to run.
// Shared memory (every box as the TMA writes it): K, V [D/64 boxes][64
// keys][64 columns]; per stage Q, dO [D/64][64][64]; dS^T [64 keys][64
// queries] bf16, swizzled the same way; P^T [8][128 threads] float4, each
// thread's fragment. At D = 256: 64 + 2 x 64 + 8 + 16 KB = 216 KB.
template <int D>
__host__ __device__ constexpr int bwd_wide_stages() {
  return D == 192 ? 3 : 2;
}
constexpr int kPtBytes = kKeysN * kRowsW * 4;    // P^T, f32
template <int D>
constexpr size_t bwd_wide_smem() {
  return 1024 + (size_t)(2 * (D / kBox) + 2 * (D / kBox) * bwd_wide_stages<D>() +
                         1) * kBoxBytes + kPtBytes;
}

template <int D>
__global__ void __launch_bounds__(kThreadsW, 1)
bwd_wg_wide_kernel(const __grid_constant__ Maps maps, const Params p) {
  using namespace hopper;
  constexpr int NB = D / kBox;
  constexpr int ND = D / 8;              // 8-column n-tiles of dK, dV
  constexpr int kStages = bwd_wide_stages<D>();
  constexpr int kTileBytes = NB * kBoxBytes;      // 64 rows x D
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_bar, full_bar[kStages],
      empty_bar[kStages];
  __shared__ float lse_s[kStages][kRowsW], delta_s[kStages][kRowsW];
  __shared__ float bias_s[kKeysN];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + kTileBytes;
  unsigned char* ring = Vs + kTileBytes;          // [stage][Q | dO]
  unsigned char* dSs = ring + kStages * 2 * kTileBytes;   // [64][64] bf16
  float4* Pt = reinterpret_cast<float4*>(dSs + kBoxBytes);   // [8][128]

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kKeysN;    // z slowest: causal's longest first
  const int bh = b * p.H + h;
  const int q_first = p.causal ? first_query(p, k0) / kRowsW * kRowsW : 0;
  const BiasRows br = bias_rows(p, b);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&kv_bar, 1 + 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1 + 32);   // expect_tx + every producer lane
      mbar_init(&empty_bar[s], 2 * 4);   // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int col = head_col(p, h, D);
      if (lane == 0) {
        mbar_expect_tx(&kv_bar, 2 * kTileBytes);
        for (int j = 0; j < NB; ++j) {
          tma_load_2d(Ks + j * kBoxBytes, &maps.k, &kv_bar,
                      col + p.kcol + j * kBox, b * p.Sk + k0);
          tma_load_2d(Vs + j * kBoxBytes, &maps.v, &kv_bar,
                      col + p.vcol + j * kBox, b * p.Sk + k0);
        }
      }
      __syncwarp();
      if (br.row != nullptr && !br.full)
        stage_bias_row<kKeysN>(bias_s, br.row, k0, p.Sk, lane);
      mbar_arrive(&kv_bar);
      const float* lse_h = p.lse + (int64_t)bh * p.Sq;
      const float* delta_h = p.delta + (int64_t)bh * p.Sq;
      int i = 0;
      for (int q0 = q_first; q0 < p.Sq; q0 += kRowsW, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty_bar[s], ((i / kStages) & 1) ^ 1);
        if (lane == 0) {
          unsigned char* Qr = ring + s * 2 * kTileBytes;
          mbar_expect_tx(&full_bar[s], 2 * kTileBytes);
          for (int j = 0; j < NB; ++j) {
            tma_load_2d(Qr + j * kBoxBytes, &maps.q, &full_bar[s],
                        col + p.qcol + j * kBox, b * p.Sq + q0);
            tma_load_2d(Qr + kTileBytes + j * kBoxBytes, &maps.dout,
                        &full_bar[s], h * D + j * kBox, b * p.Sq + q0);
          }
        }
        __syncwarp();
        // rows past Sq: lse +inf and delta 0, so their p and dS are 0
#pragma unroll
        for (int r = lane; r < kRowsW; r += 32) {
          const bool in = q0 + r < p.Sq;
          lse_s[s][r] = in ? lse_h[q0 + r] : INFINITY;
          delta_s[s][r] = in ? delta_h[q0 + r] : 0.f;
        }
        mbar_arrive(&full_bar[s]);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<232>();
  const int c = wg - 1;                  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int t_in = threadIdx.x - 128 * wg;
  const int lane = t_in & 31, gi = lane >> 2, qi = lane & 3;
  const int r0 = (t_in >> 5) * 16;       // this warp's keys in the 64
  const int kr = r0 + gi;                // this thread's keys: kr, kr + 8
  const int key[2] = {k0 + kr, k0 + kr + 8};
  const Keep kc = keep_consts(p);
  // the first product's A operand: K (group 0) or V (group 1)
  const unsigned char* KVc = c == 0 ? Ks : Vs;

  float acc[ND][4];                      // dV (group 0) or dK (group 1)
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  mbar_wait(&kv_bar, 0);
  float kbias[2] = {0.f, 0.f};
  if (br.row != nullptr && !br.full) {
    kbias[0] = bias_s[kr];
    kbias[1] = bias_s[kr + 8];
  }
  const bool cut_keys = k0 + kKeysN > p.Sk;

  int i = 0;
  for (int q0 = q_first; q0 < p.Sq; q0 += kRowsW, ++i) {
    const int s = i % kStages;
    const unsigned char* Qr = ring + s * 2 * kTileBytes;
    const unsigned char* dOr = Qr + kTileBytes;
    mbar_wait(&full_bar[s], (i / kStages) & 1);

    // S^T = K Q^T (group 0) or dP^T = V dO^T (group 1): rows are keys,
    // columns queries
    const unsigned char* Bq = c == 0 ? Qr : dOr;
    float sc[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0>(
          sc, desc_sw128(KVc + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024),
          desc_sw128(Bq + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(sc);

    uint32_t fa[4][4];                   // P^T keep or dS^T, bf16 A operand
    if (c == 0) {
      // P^T = exp(s - lse) and the keep bits (the general form only where
      // the tile needs it, as in the forward)
      const bool cut =
          cut_keys || (p.causal && p.off + q0 < k0 + kKeysN - 1);
      const Drop dr = tile_drop(p, kc, b, h, q0, k0);
      const float* lse_t = lse_s[s];
      uint32_t bits;
      if (cut || br.full)
        bits = p.use_drop ? bwd_probs<true, true>(sc, p, br, kbias, key,
                                                  lse_t, dr, q0, qi)
                          : bwd_probs<true, false>(sc, p, br, kbias, key,
                                                   lse_t, dr, q0, qi);
      else
        bits = p.use_drop ? bwd_probs<false, true>(sc, p, br, kbias, key,
                                                   lse_t, dr, q0, qi)
                          : bwd_probs<false, false>(sc, p, br, kbias, key,
                                                    lse_t, dr, q0, qi);
      if (!p.use_drop) bits = ~0u;
      // P^T to group 1, a dropped score's sign flipped (p >= 0, so -0.0
      // still reads as dropped)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = ((bits >> (j * 4 + e)) & 1u) ? sc[j][e] : -sc[j][e];
        Pt[j * 128 + t_in] = make_float4(v[0], v[1], v[2], v[3]);
      }
      named_arrive(1, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = ((bits >> (j * 4 + e)) & 1u) ? sc[j][e] * kc.inv : 0.f;
    } else {
      named_barrier(1, 256);             // P^T is in place
      const float* delta_t = delta_s[s];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pv = Pt[j * 128 + t_in];
        const float pt[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ks = !p.use_drop ? 1.f
                           : (__float_as_uint(pt[e]) >> 31) ? 0.f
                                                            : kc.inv;
          sc[j][e] = fabsf(pt[e]) *
                     (sc[j][e] * ks - delta_t[j * 8 + 2 * qi + (e & 1)]) *
                     p.scale;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) as_a(fa[kk], sc, kk);
    if (c == 1) {
      // dS^T into shared memory ([key][query], 128-byte swizzle): the A
      // fragment's words are the rounded pairs (j = 2kk + (w >> 1), key
      // row kr + 8 (w & 1))
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int rk = kr + 8 * (w & 1), j = 2 * kk + (w >> 1);
          *reinterpret_cast<uint32_t*>(dSs + rk * 128 + ((j ^ (rk & 7)) << 4) +
                                       4 * qi) = fa[kk][w];
        }
      fence_proxy_async();
    }
    // dV += (P^T keep) dO (group 0), dK += dS^T Q (group 1): 16 queries a
    // step, the B operand's rows 16 x 128 bytes apart, its D/64 boxes
    // one box apart, N = D in one product
    const unsigned char* Bo = c == 0 ? dOr : Qr;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_sw128(Bo + kk * 16 * 128, kBoxBytes, 1024);
      if constexpr (D == 192)
        wgmma_rs_n192(acc, fa[kk], db);
      else
        wgmma_rs_n256(acc, fa[kk], db);
    }
    wgmma_commit();
    named_barrier(2, 256);               // dS^T is in place
    // dQ's 64-column chunks j = c, c + 2, ...: dS K over the 64 keys, A
    // (dS) dS^T read transposed, B box j of K, MN-major
#pragma unroll
    for (int j = c; j < NB; j += 2) {
      float dq[8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeysN / 16; ++kk)
        wgmma_ss_n64<1>(
            dq, desc_sw128(dSs + kk * 16 * 128, kBoxBytes, 1024),
            desc_sw128(Ks + j * kBoxBytes + kk * 16 * 128, kBoxBytes, 1024),
            kk > 0);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(dq);
      if (j == c) {
        reg_fence(acc);
        reg_fence(fa);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_bar[s]);  // Q, dO, lse, delta read
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = q0 + r0 + gi + 8 * hh;
        if (q >= p.Sq) continue;
        float* dst = p.dq_acc + ((int64_t)(b * p.Sq + q) * p.H + h) * D +
                     j * kBox + 2 * qi;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          atomicAdd(reinterpret_cast<float2*>(dst + n * 8),
                    make_float2(dq[n][2 * hh], dq[n][2 * hh + 1]));
      }
    }
  }

  // dV (group 0) or dK (group 1) at k's row stride and this head's columns
  const int64_t kv0 = (int64_t)b * p.Sk * p.ldk + head_col(p, h, D);
  e16* out = c == 0 ? static_cast<e16*>(p.dv) + kv0 + p.vcol
                     : static_cast<e16*>(p.dk) + kv0 + p.kcol;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kk = key[hh];
    if (kk >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(out + kk * p.ldk + j * 8 + 2 * qi) =
          pack16(acc[j][2 * hh], acc[j][2 * hh + 1]);
  }
}

// The post-pass: dq = the f32 accumulator [B, Sq, H, D] rounded to bf16,
// at q's row stride and head columns; a block a row, 4 values a thread.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_round_kernel(const Params p) {
  const int64_t row = blockIdx.x;            // b * Sq + q
  const float4* acc =
      reinterpret_cast<const float4*>(p.dq_acc + row * p.H * D);
  e16* dq = static_cast<e16*>(p.dq) + row * p.ldq + p.qcol;
  for (int i = threadIdx.x; i < p.H * (D / 4); i += kThreads) {
    const int h = i / (D / 4), c = (i % (D / 4)) * 4;
    const float4 v = acc[i];
    *reinterpret_cast<uint2*>(dq + head_col(p, h, D) + c) =
        make_uint2(pack16(v.x, v.y), pack16(v.z, v.w));
  }
}

// ------------------------------------------------------------- launches
// The call's tensor maps (dout unused by the forward): q, k and v as
// [B*S, ldq | ldk] (over the fused projection, each the whole of it).
cudaError_t make_maps(Maps* m, const Params& p, int D) {
  const int64_t ld = (int64_t)p.H * D;
  cudaError_t err;
  if ((err = hopper::tensor_map_2d(&m->q, p.q, (int64_t)p.B * p.Sq, p.ldq,
                                   p.ldq)) != cudaSuccess)
    return err;
  if ((err = hopper::tensor_map_2d(&m->k, p.k, (int64_t)p.B * p.Sk, p.ldk,
                                   p.ldk)) != cudaSuccess)
    return err;
  if ((err = hopper::tensor_map_2d(&m->v, p.v, (int64_t)p.B * p.Sk, p.ldk,
                                   p.ldk)) != cudaSuccess)
    return err;
  if (p.dout == nullptr) {
    m->dout = m->q;
    return cudaSuccess;
  }
  return hopper::tensor_map_2d(&m->dout, p.dout, (int64_t)p.B * p.Sq, ld, ld);
}

template <typename T, int D>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same<T, e16>::value) {
    Maps maps;
    if ((err = make_maps(&maps, p, D)) != cudaSuccess) return err;
    auto k = fwd_wg_kernel<D>;
    if ((err = allow_smem(k, fwd_wg_smem<D>())) != cudaSuccess) return err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    const int tiles = (p.Sq + 2 * kRowsW - 1) / (2 * kRowsW) * p.H * p.B;
    k<<<min(tiles, sms), kThreadsW, fwd_wg_smem<D>(), stream>>>(maps, p);
  } else {
    const dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
    auto k = fwd_kernel<D>;
    if ((err = allow_smem(k, fwd_smem<D>())) != cudaSuccess) return err;
    k<<<grid, kThreads, fwd_smem<D>(), stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same<T, e16>::value) {
    if ((err = launch_delta<e16, D>(static_cast<const e16*>(p.dout),
                                     static_cast<const e16*>(p.o), p.delta,
                                     p.B, p.Sq, p.H, stream, p.dq_acc,
                                     p.dlse)) != cudaSuccess)
      return err;
    Maps maps;
    if ((err = make_maps(&maps, p, D)) != cudaSuccess) return err;
    if constexpr (D <= 128) {
      auto k = bwd_wg_kernel<D>;
      if ((err = allow_smem(k, bwd_wg_smem<D>())) != cudaSuccess) return err;
      const dim3 grid(p.H, p.B, (p.Sk + kKeysW - 1) / kKeysW);
      k<<<grid, kThreadsW, bwd_wg_smem<D>(), stream>>>(maps, p);
    } else {
      auto k = bwd_wg_wide_kernel<D>;
      if ((err = allow_smem(k, bwd_wide_smem<D>())) != cudaSuccess)
        return err;
      const dim3 grid(p.H, p.B, (p.Sk + kKeysN - 1) / kKeysN);
      k<<<grid, kThreadsW, bwd_wide_smem<D>(), stream>>>(maps, p);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_dq_round_kernel<D>
        <<<(unsigned)((int64_t)p.B * p.Sq), kThreads, 0, stream>>>(p);
  } else {
    if ((err = launch_delta<T, D>(static_cast<const T*>(p.dout),
                                  static_cast<const T*>(p.o), p.delta, p.B,
                                  p.Sq, p.H, stream, nullptr, p.dlse)) !=
        cudaSuccess)
      return err;
    const dim3 grid_k((p.Sk + kTile - 1) / kTile, p.H, p.B);
    const dim3 grid_q((p.Sq + kTile - 1) / kTile, p.H, p.B);
    auto kv = dkdv_kernel<D>;
    auto kq = dq_kernel<D>;
    if ((err = allow_smem(kv, dkdv_smem<D>())) != cudaSuccess) return err;
    if ((err = allow_smem(kq, dq_smem<D>())) != cudaSuccess) return err;
    kv<<<grid_k, kThreads, dkdv_smem<D>(), stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    kq<<<grid_q, kThreads, dq_smem<D>(), stream>>>(p);
  }
  return cudaGetLastError();
}

// f32 heads above 128 and bf16 heads above 256 (D a multiple of 64): the
// sliced kernels (f32 on FMAs, bf16 on mma.sync); the backward a delta
// pre-pass, a dk/dv pass and a dq pass.
constexpr size_t kWideFwdSmem =
    (3 * kTile * kLW + kTile * kLS) * sizeof(float);
constexpr size_t kWideDkdvSmem =
    (4 * kTile * kLW + 2 * kTile * kLS) * sizeof(float);
constexpr size_t kWideDqSmem =
    (4 * kTile * kLW + kTile * kLS) * sizeof(float);

constexpr size_t kWideTcFwdSmem =
    (2 * kTile * kCP + kWS * (kTile + 8)) * sizeof(e16);
constexpr size_t kWideTcDkdvSmem =
    (2 * kTile * kCP + 2 * kBQ * kCP + 2 * kWS * (kBQ + 8)) * sizeof(e16) +
    2 * kBQ * sizeof(float);
constexpr size_t kWideTcDqSmem =
    (4 * kTile * kCP + kWS * (kTile + 8)) * sizeof(e16);

template <typename T>
cudaError_t launch_fwd_wide(const Params& p, int D, cudaStream_t stream) {
  const int slices = (D + kWS - 1) / kWS;
  const dim3 grid((p.Sq + kTile - 1) / kTile * slices, p.H, p.B);
  cudaError_t err;
  if constexpr (std::is_same<T, e16>::value) {
    auto k = fwd_wide_tc_kernel;
    if ((err = allow_smem(k, kWideTcFwdSmem)) != cudaSuccess) return err;
    k<<<grid, kTC, kWideTcFwdSmem, stream>>>(p, D);
  } else {
    auto k = fwd_wide_kernel;
    if ((err = allow_smem(k, kWideFwdSmem)) != cudaSuccess) return err;
    k<<<grid, kThreads, kWideFwdSmem, stream>>>(p, D);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_wide(const Params& p, int D, cudaStream_t stream) {
  cudaError_t err = launch_delta<T, 0>(
      static_cast<const T*>(p.dout), static_cast<const T*>(p.o), p.delta,
      p.B, p.Sq, p.H, stream, nullptr, p.dlse, D);
  if (err != cudaSuccess) return err;
  const int slices = (D + kWS - 1) / kWS;
  const dim3 grid_k((p.Sk + kTile - 1) / kTile * slices, p.H, p.B);
  const dim3 grid_q((p.Sq + kTile - 1) / kTile * slices, p.H, p.B);
  if constexpr (std::is_same<T, e16>::value) {
    auto kv = dkdv_wide_tc_kernel;
    auto kq = dq_wide_tc_kernel;
    if ((err = allow_smem(kv, kWideTcDkdvSmem)) != cudaSuccess) return err;
    if ((err = allow_smem(kq, kWideTcDqSmem)) != cudaSuccess) return err;
    kv<<<grid_k, kTC, kWideTcDkdvSmem, stream>>>(p, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    kq<<<grid_q, kTC, kWideTcDqSmem, stream>>>(p, D);
  } else {
    auto kv = dkdv_wide_kernel;
    auto kq = dq_wide_kernel;
    if ((err = allow_smem(kv, kWideDkdvSmem)) != cudaSuccess) return err;
    if ((err = allow_smem(kq, kWideDqSmem)) != cudaSuccess) return err;
    kv<<<grid_k, kThreads, kWideDkdvSmem, stream>>>(p, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    kq<<<grid_q, kThreads, kWideDqSmem, stream>>>(p, D);
  }
  return cudaGetLastError();
}

// Fills the shape fields and checks them; false on a shape the kernels do
// not take. The layout fields (strides, the head rule, head_ids) are set
// before.
bool set_shape(Params& p, int B, int Sq, int Sk, int H, int D, int bias_b,
               int bias_q, int causal, int use_drop, float keep, float scale,
               int bq, int bk) {
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H;
  p.bias_b = bias_b; p.bias_q = bias_q;
  p.causal = causal; p.off = Sk - Sq;
  p.use_drop = use_drop; p.keep = keep; p.scale = scale;
  p.bq = bq; p.bk = bk;
  const bool bias_ok = p.bias == nullptr ||
                       ((bias_b == 1 || bias_b == B) &&
                        (bias_q == 1 || bias_q == Sq));
  const bool blocks_ok = p.head_ids || (bq > 0 && bk > 0 &&
                                        bq % kKeysW == 0 && bk % kKeysW == 0);
  const bool drop_ok = !use_drop || (p.seed != nullptr && blocks_ok);
  const bool d_ok = D == 64 || D == 128 || (D > 128 && D % 64 == 0);
  return B >= 1 && H >= 1 && Sq >= 1 && Sk >= 1 && d_ok && p.group >= 1 &&
         bias_ok && drop_ok;
}

// The layout of separate [B, S, H, D] tensors: row stride H*D, head h at
// h*D.
void separate_heads(Params& p, int H, int D) {
  p.ldq = p.ldk = (int64_t)H * D;
  p.group = 1;
  p.gstride = D;
}

// The backward's dispatch on (dtype, D); bf16 up to D = 256 needs dq_acc.
// A -DPTT_F16 build takes float16 only (code 2); the default build float32
// (code 0) and bfloat16 (code 1).
int launch_bwd_of(const Params& p, int D, int dtype, cudaStream_t s) {
#ifndef PTT_F16
  if (D > 128 && dtype == 0) return (int)launch_bwd_wide<float>(p, D, s);
  if (dtype == 0 && D == 64) return (int)launch_bwd<float, 64>(p, s);
  if (dtype == 0 && D == 128) return (int)launch_bwd<float, 128>(p, s);
#endif
  if (dtype != kCode16) return (int)cudaErrorInvalidValue;
  if (D > 256) return (int)launch_bwd_wide<e16>(p, D, s);
  if (p.dq_acc == nullptr) return (int)cudaErrorInvalidValue;
  if (D == 64) return (int)launch_bwd<e16, 64>(p, s);
  if (D == 128) return (int)launch_bwd<e16, 128>(p, s);
  if (D == 192) return (int)launch_bwd<e16, 192>(p, s);
  if (D == 256) return (int)launch_bwd<e16, 256>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 in a -DPTT_F16 build
// (q, k, v, o share it). bias: f32
// [bias_b, bias_q, Sk] or null. seed: an int32 on the device, read only
// when use_drop != 0; bq and bk: the reference's block sizes, which place
// the dropout hash. keep = 1 - dropout_p and scale = 1/sqrt(D), both
// rounded to f32 by the caller. Returns the CUDA error of the launch
// (0 = launched). The caller checks dtypes, contiguity and 16-byte
// alignment.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* bias, const void* seed, void* out,
                             void* lse, int B, int Sq, int Sk, int H, int D,
                             int bias_b, int bias_q, int causal, int use_drop,
                             float keep, float scale, int bq, int bk,
                             int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.q = q; p.k = k; p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.seed = static_cast<const int32_t*>(seed);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  separate_heads(p, H, D);
  if (!set_shape(p, B, Sq, Sk, H, D, bias_b, bias_q, causal, use_drop, keep,
                 scale, bq, bk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifndef PTT_F16
  if (D > 128 && dtype == 0) return (int)launch_fwd_wide<float>(p, D, s);
  if (dtype == 0 && D == 64) return (int)launch_fwd<float, 64>(p, s);
  if (dtype == 0 && D == 128) return (int)launch_fwd<float, 128>(p, s);
#endif
  if (dtype != kCode16) return (int)cudaErrorInvalidValue;
  if (D > 256) return (int)launch_fwd_wide<e16>(p, D, s);
  if (D == 64) return (int)launch_fwd<e16, 64>(p, s);
  if (D == 128) return (int)launch_fwd<e16, 128>(p, s);
  if (D == 192) return (int)launch_fwd<e16, 192>(p, s);
  if (D == 256) return (int)launch_fwd<e16, 256>(p, s);
  return (int)cudaErrorInvalidValue;
}

// The backward, on one stream. bf16 at D 64, 128, 192 or 256: a pre-pass
// (delta, and dq_acc zeroed), the one-pass kernel, a post-pass rounding
// dq_acc into dq. f32 above 128 and bf16 above 256: the delta pre-pass, a
// dk/dv pass and a dq pass. Scratch allocated by the caller: delta f32
// [B, H, Sq]; dq_acc f32 [B, Sq, H, D] (required for bf16 up to D = 256,
// which is refused without it; may be null otherwise). dq, dk and dv are
// written in full. dlse: null, or the f32 [B, H, Sq] cotangent of the
// forward's lse (B4, `_flash_lse`'s backward), which the delta pre-pass
// folds in; with null every pass runs as before.
extern "C" int ptt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             const void* dlse, const void* bias,
                             const void* seed, void* delta, void* dq_acc,
                             void* dq, void* dk, void* dv,
                             int B, int Sq, int Sk, int H, int D, int bias_b,
                             int bias_q, int causal, int use_drop, float keep,
                             float scale, int bq, int bk, int dtype,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.dlse = static_cast<const float*>(dlse);
  p.delta = static_cast<float*>(delta);
  p.bias = static_cast<const float*>(bias);
  p.seed = static_cast<const int32_t*>(seed);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.dq_acc = static_cast<float*>(dq_acc);
  separate_heads(p, H, D);
  if (!set_shape(p, B, Sq, Sk, H, D, bias_b, bias_q, causal, use_drop, keep,
                 scale, bq, bk))
    return (int)cudaErrorInvalidValue;
  return launch_bwd_of(p, D, dtype, static_cast<cudaStream_t>(stream));
}

// The qkv kernels' backward (B1 pair-major, B5 which-major) on the fused
// projection qkv [B, S, 3*H*D] as it lies: the same kernels as
// `ptt_flash_bwd`, self-attention (Sq = Sk = S), no bias, the qkv
// kernels' dropout ids. Head h's q, k and v columns are (h / group) *
// gstride + (h % group) * D plus qcol, kcol and vcol, which the caller
// computes for its layout; dqkv [B, S, 3*H*D] is written in full in the
// same layout. o and dout are [B, S, H*D], lse [B, H, S]; delta and
// dq_acc as for `ptt_flash_bwd`.
extern "C" int ptt_flash_qkv_bwd(const void* qkv, const void* dout,
                                 const void* o, const void* lse,
                                 const void* seed, void* delta, void* dq_acc,
                                 void* dqkv, int B, int S, int H, int D,
                                 int group, int gstride, int qcol, int kcol,
                                 int vcol, int causal, int use_drop,
                                 float keep, float scale, int dtype,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.q = p.k = p.v = qkv;
  p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.seed = static_cast<const int32_t*>(seed);
  p.dq = p.dk = p.dv = dqkv;
  p.dq_acc = static_cast<float*>(dq_acc);
  p.ldq = p.ldk = (int64_t)3 * H * D;
  p.group = group; p.gstride = gstride;
  p.qcol = qcol; p.kcol = kcol; p.vcol = vcol;
  p.head_ids = 1;
  if (!set_shape(p, B, S, S, H, D, 1, 1, causal, use_drop, keep, scale, 0,
                 0))
    return (int)cudaErrorInvalidValue;
  return launch_bwd_of(p, D, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
