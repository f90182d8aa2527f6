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
// What they compute, as the TPU kernels do:
// - q [B,Sq,H,D], k and v [B,Sk,H,D], read through strides (row stride
//   H*D, head stride D; no [B*H,S,D] transpose). D is 64 or 128 (the
//   caller zero-pads a smaller D); any Sq, Sk >= 1.
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
// - Dropout: the keep/scale of score (q, c) of head bh = b*H + h is the
//   reference's interpret-mode hash (`_hash_keep_scale`, :101-116) with
//   block ids (bh, q / bq, c / bk) at tile-relative (q % bq, c % bk), where
//   bq and bk are the REFERENCE's block sizes (`_pick_block`, :1211), not
//   these kernels' tiles; the caller passes them. They are multiples of
//   128, so none of these kernels' 64- or 128-row tiles straddles one of
//   their blocks and the ids hold per tile. Computed per element from
//   global coordinates, so the masks agree bit for bit with the plain
//   version and with paddle_tpu's interpret mode. These kernels compare
//   the hash's top 24 bits with the integer threshold ceil(keep * 2^24)
//   (`keep_threshold`, the same mask without an int-to-float conversion).
//   (On the TPU itself the reference draws from the hardware PRNG, which
//   nothing reproduces.)
//
// Design. bf16 (the training path) runs on Hopper's warpgroup products
// fed by TMA (tensor maps over q, k, v and dO as 2-D [B*S, H*D] arrays,
// 64 x 64 boxes, 128-byte swizzle; rows that leak into the next batch are
// replaced past Sk or have p = 0 past Sq; rows past the array read 0):
// - forward (`fwd_wg_kernel`), flash_attention_qkv.cu's template: a
//   persistent grid of 128-query tiles, longest causal rows first; a
//   producer warp streams 128-key K/V tiles through a 2-3 stage ring with
//   full/empty mbarriers and stages the key-padding bias row of each tile
//   in shared memory; two consumer warpgroups of 64 rows run S = Q.K^T
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
// Bound on the H100, at BERT-large's training shape (B8 S512 H16 D64,
// bf16, a [B,1,1,S] key-padding mask with lengths in [384, 512), counting
// only the key rows some query sees, as chip_smoke.py does): the forward
// moves q, those k and v rows, the bias rows, o and lse (31.9 MB, 0.0095
// ms at 3.35 TB/s) for 4*D*H flops per visible pair (7.6 GFLOP, 0.0077
// ms at 989 TFLOP/s); the backward moves 65.5 MB (0.0195 ms) for 10*D*H
// flops per pair (19.0 GFLOP, 0.0192 ms): both bytes-bound. With dropout,
// the hash (about 12 integer operations a score) is a floor beside them:
// 33.5M scores a pass at 64 integer lanes an SM is about 0.027 ms, which
// the products can only overlap. What the design leaves: both consumer
// groups softmax at the same time (no ping-pong) and each waits for its
// own products, the backward's one block an SM, dQ's atomics and its
// pre- and post-pass, and key tiles that are wholly padding still
// computed (ROADMAP B2).
#include <cuda_bf16.h>
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
  const void* q;        // [B, Sq, H, D]
  const void* k;        // [B, Sk, H, D]
  const void* v;        // [B, Sk, H, D]
  const void* o;        // backward: the forward's output [B, Sq, H, D]
  const void* dout;     // backward: [B, Sq, H, D]
  const float* lse;     // backward: [B, H, Sq]
  float* delta;         // backward: [B, H, Sq], written by the pre-pass
  const float* bias;    // [bias_b, bias_q, Sk] or null
  const int32_t* seed;  // [1], read when use_drop
  void* out;            // forward: [B, Sq, H, D]
  float* lse_out;       // forward: [B, H, Sq]
  void* dq;             // backward outputs, shaped as q, k, v
  void* dk;
  void* dv;
  float* dq_acc;        // bf16 backward: f32 dq scratch [B, Sq, H, D]
  int B, Sq, Sk, H, bias_b, bias_q, causal, off, use_drop, bq, bk;
  float keep, scale;
};

// One (b, h) head: element offsets of (b, 0, h, 0) in the query-side
// tensors (q, o, dO, dq) and the key-side ones (k, v, dk, dv).
struct Head {
  int b, bh;
  int64_t ld, qoff, koff;
};

__device__ __forceinline__ Head head(const Params& p, int D) {
  Head g;
  const int h = blockIdx.y;
  g.b = blockIdx.z;
  g.bh = g.b * p.H + h;
  g.ld = (int64_t)p.H * D;
  g.qoff = (int64_t)g.b * p.Sq * g.ld + (int64_t)h * D;
  g.koff = (int64_t)g.b * p.Sk * g.ld + (int64_t)h * D;
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
// reference block that holds it and that block's origin; an element is
// kept where its hash's top 24 bits lie under the integer threshold
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
                                          int bh, int q0, int k0) {
  const int qb = q0 / p.bq, kb = k0 / p.bk;
  return {p.use_drop ? mix32(kc.seed, bh, qb, kb) : 0u, kc.thr, qb * p.bq,
          kb * p.bk};
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
  const float* qb = static_cast<const float*>(p.q) + g.qoff;
  const float* kb = static_cast<const float*>(p.k) + g.koff;
  const float* vb = static_cast<const float*>(p.v) + g.koff;
  const Keep kc = keep_consts(p);

  load_tile<D>(Qs, qb + q0 * g.ld, g.ld, p.Sq - q0);
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
    load_tile<D>(Ks, kb + k0 * g.ld, g.ld, p.Sk - k0);
    load_tile<D>(Vs, vb + k0 * g.ld, g.ld, p.Sk - k0);
    __syncthreads();
    float s[kTM][4];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_product<4, D, LD, 1, 1, LD>(s, Qs, Ks, ty, tx);
    const Drop dr = tile_drop(p, kc, g.bh, q0, k0);
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

  float* out = static_cast<float*>(p.out) + g.qoff;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j) out[r * g.ld + tx + 16 * j] = acc[i][j] / lc;
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
  const Drop dr = tile_drop(p, kc, g.bh, q0, k0);
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
  const float* qb = static_cast<const float*>(p.q) + g.qoff;
  const float* dob = static_cast<const float*>(p.dout) + g.qoff;
  const Keep kc = keep_consts(p);

  load_tile<D>(Ks, static_cast<const float*>(p.k) + g.koff + k0 * g.ld, g.ld,
               p.Sk - k0);
  load_tile<D>(Vs, static_cast<const float*>(p.v) + g.koff + k0 * g.ld, g.ld,
               p.Sk - k0);
  float dk[kTM][TD], dv[kTM][TD];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = first_query(p, k0) / kTile * kTile; q0 < p.Sq; q0 += kTile) {
    __syncthreads();  // the previous Q/dO/P/dS tiles are consumed
    load_tile<D>(Qs, qb + q0 * g.ld, g.ld, p.Sq - q0);
    load_tile<D>(dOs, dob + q0 * g.ld, g.ld, p.Sq - q0);
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

  float* dkb = static_cast<float*>(p.dk) + g.koff;
  float* dvb = static_cast<float*>(p.dv) + g.koff;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      dkb[r * g.ld + tx + 16 * j] = dk[i][j];
      dvb[r * g.ld + tx + 16 * j] = dv[i][j];
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
  const float* kb = static_cast<const float*>(p.k) + g.koff;
  const float* vb = static_cast<const float*>(p.v) + g.koff;
  const Keep kc = keep_consts(p);

  load_tile<D>(Qs, static_cast<const float*>(p.q) + g.qoff + q0 * g.ld, g.ld,
               p.Sq - q0);
  load_tile<D>(dOs, static_cast<const float*>(p.dout) + g.qoff + q0 * g.ld,
               g.ld, p.Sq - q0);
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
    load_tile<D>(Ks, kb + k0 * g.ld, g.ld, p.Sk - k0);
    load_tile<D>(Vs, vb + k0 * g.ld, g.ld, p.Sk - k0);
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

  float* dqb = static_cast<float*>(p.dq) + g.qoff;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) dqb[r * g.ld + tx + 16 * j] = dq[i][j];
  }
}

// ------------------------------------------- bf16: Hopper (TMA and wgmma)
using hopper::ex2;
using hopper::kBox;
using hopper::kBoxBytes;
using hopper::kLog2e;

constexpr int kRowsW = 64;        // query rows of a consumer warpgroup
constexpr int kKeysW = 128;       // keys of a forward K/V tile; of a
                                  // backward block (64 a consumer)
constexpr int kThreadsW = 384;    // producer + 2 consumer warpgroups
constexpr int kSlabBytes = 2 * kBoxBytes;   // 128 rows x 64 columns

// The call's tensor maps: q and dO as 2-D [B*Sq, H*D], k and v as
// [B*Sk, H*D] (the head's columns at h*D), 64 x 64 boxes, 128-byte
// swizzle. Rows past a batch's end read the next batch's rows (their
// scores are replaced or their p is 0) and rows past the array read 0.
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

// 32 producer lanes stage the key-padding row's columns [k0, k0 + 128)
// (0 past Sk) in shared memory.
__device__ __forceinline__ void stage_bias_row(float* dst, const float* row,
                                               int k0, int Sk, int lane) {
#pragma unroll
  for (int i = 0; i < kKeysW / 32; ++i) {
    const int col = lane + 32 * i, c = k0 + col;
    dst[col] = c < Sk ? __ldg(row + c) : 0.f;
  }
}

// ---------------------------------------------------------------- forward
// Persistent grid: one block an SM walks 128-query tiles, longest causal
// rows first. A producer warp loads each tile's Q (double-buffered) and
// streams its 128-key K and V tiles by TMA through a ring of
// `fwd_stages` stages, with the key-padding bias row of each; two
// consumer warpgroups of 64 query rows compute S = Q.K^T (wgmma from
// shared memory), the online softmax on the accumulator fragments, and
// O += P.V (P in registers, V through a transposed descriptor).
// Shared memory: Q [2 tiles][2 halves][D/64 boxes], then per stage K and
// V [D/64 slabs][128 rows][64 columns], each box as the TMA writes it.
template <int D>
__host__ __device__ constexpr int fwd_stages() {
  return D == 128 ? 2 : 3;
}
template <int D>
constexpr size_t fwd_wg_smem() {
  return 1024 + (size_t)(4 + 4 * fwd_stages<D>()) * (D / kBox) * kBoxBytes;
}

struct FwdTile {
  int qt, h, b;
};
__device__ __forceinline__ FwdTile fwd_tile(int t, int nq, int H, int B) {
  const int j = t / (H * B), r = t % (H * B);
  return {nq - 1 - j, r % H, r / H};
}

// Key tiles of 128 that the 128-query tile at q0 needs.
__device__ __forceinline__ int fwd_key_tiles(const Params& p, int q0) {
  const int n = (p.Sk + kKeysW - 1) / kKeysW;
  if (!p.causal) return n;
  const int last = p.off + min(q0 + 2 * kRowsW, p.Sq) - 1;
  return last < 0 ? 0 : min(n, last / kKeysW + 1);
}

// The forward's scores of one 128-key tile in a consumer thread's
// fragments (rows row, row + 8; columns j*8 + 2qi + (e & 1)), and their
// row maxima: kPlain s = q.k * scale; kRowBias adds the staged
// key-padding row; kGeneral adds either bias and replaces a key past Sk
// or past the causal diagonal by -1e30.
constexpr int kPlain = 0, kRowBias = 1, kGeneral = 2;
template <int kMode>
__device__ __forceinline__ void fwd_scores(float (&sc)[kKeysW / 8][4],
                                           float (&mx)[2], const Params& p,
                                           const BiasRows& br,
                                           const float* bias_tile, int row,
                                           int k0, int qi) {
#pragma unroll
  for (int j = 0; j < kKeysW / 8; ++j)
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
template <bool kDrop>
__device__ __forceinline__ void fwd_probs(float (&sc)[kKeysW / 8][4],
                                          float (&sum)[2],
                                          const float (&m)[2], const Drop& dr,
                                          float inv_keep, int row, int k0,
                                          int qi) {
#pragma unroll
  for (int j = 0; j < kKeysW / 8; ++j)
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
  constexpr int NS = kKeysW / 8;        // 8-column n-tiles of S
  constexpr int kStages = fwd_stages<D>();
  constexpr int kTileBytes = NB * kBoxBytes;          // 64 rows x D
  constexpr int kKVBytes = NB * kSlabBytes;           // 128 keys x D
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages], empty_bar[kStages];
  __shared__ __align__(8) uint64_t qfull_bar[2], qempty_bar[2];
  __shared__ float bias_s[kStages][kKeysW];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;                    // [2 tiles][2][NB]
  unsigned char* KVs = smem + 4 * kTileBytes;  // [stage][K|V][NB slabs]

  const int nq = (p.Sq + 2 * kRowsW - 1) / (2 * kRowsW);
  const int tiles = nq * p.H * p.B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1 + 32);   // expect_tx + every producer lane
      mbar_init(&empty_bar[s], 2 * 4);   // one arrival a consumer warp
    }
    for (int i = 0; i < 2; ++i) {
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
        const int nk = fwd_key_tiles(p, q0);
        const int qb = n & 1;
        // the warp waits together; lane 0 issues the copies
        mbar_wait(&qempty_bar[qb], ((n >> 1) & 1) ^ 1);
        if (lane == 0) {
          const int active = min(2, (p.Sq - q0 + kRowsW - 1) / kRowsW);
          mbar_expect_tx(&qfull_bar[qb], active * kTileBytes);
          for (int c = 0; c < active; ++c)
            for (int j = 0; j < NB; ++j)
              tma_load_2d(Qs + ((qb * 2 + c) * NB + j) * kBoxBytes, &maps.q,
                          &qfull_bar[qb], f.h * D + j * kBox,
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
            // each 64-column slab: two 64-row boxes, one after the other
            for (int j = 0; j < NB; ++j)
              for (int r = 0; r < 2; ++r) {
                const int row = f.b * p.Sk + kt * kKeysW + r * kBox;
                tma_load_2d(Ks + j * kSlabBytes + r * kBoxBytes, &maps.k,
                            &full_bar[s], f.h * D + j * kBox, row);
                tma_load_2d(Vs + j * kSlabBytes + r * kBoxBytes, &maps.v,
                            &full_bar[s], f.h * D + j * kBox, row);
              }
          }
          __syncwarp();
          if (br.row != nullptr && !br.full)
            stage_bias_row(bias_s[s], br.row, kt * kKeysW, p.Sk, lane);
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
    const int nk = fwd_key_tiles(p, q0);
    const int my_q0 = q0 + c * kRowsW;
    const bool live = my_q0 < p.Sq;
    const int my_nk = live ? nk : 0;
    const int row = my_q0 + r0 + gi;     // this thread's rows: row, row + 8
    const int qb = n & 1;
    const unsigned char* Qc = Qs + (qb * 2 + c) * kTileBytes;

    float o[ND][4], m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    if (live) mbar_wait(&qfull_bar[qb], (n >> 1) & 1);

    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full_bar[s], (it / kStages) & 1);
      if (kt < my_nk) {
        const unsigned char* Ks = KVs + s * 2 * kKVBytes;
        const unsigned char* Vs = Ks + kKVBytes;
        const int k0 = kt * kKeysW;
        float sc[NS][4];
        // S = Q.K^T: 16-column steps of the head dim, 32 bytes apart
        // inside a box's swizzled 128-byte rows
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
          wgmma_ss_n128(sc, desc_sw128(Qc + off, 16, 1024),
                        desc_sw128(Ks + (kk / 4) * kSlabBytes + (kk % 4) * 32,
                                   16, 1024),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        reg_fence(sc);
        // s = q.k * scale + bias; a key past Sk or past the causal
        // diagonal is replaced by -1e30. The general form (per-element
        // checks, a full bias) only where a tile needs it: predicated
        // instructions still issue, and per score they cost as much as
        // the rest of the softmax
        const bool cut = k0 + kKeysW > p.Sk ||
                         (p.causal && p.off + my_q0 < k0 + kKeysW - 1);
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
          fwd_probs<true>(sc, sum, m_new, tile_drop(p, kc, bh, q0, k0),
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
        // O += P.V: 16 keys a step, V's rows 16 x 128 bytes apart; the
        // second 64 columns of a 128-wide head lie one slab further
        uint32_t pa[NS / 2][4];
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) as_a(pa[kk], sc, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
          const uint64_t dv = desc_sw128(Vs + kk * 16 * 128, kSlabBytes, 1024);
          if constexpr (D == 64)
            wgmma_rs_n64(o, pa[kk], dv);
          else
            wgmma_rs_n128(o, pa[kk], dv);
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

    bf16* out = static_cast<bf16*>(p.out) + (int64_t)f.b * p.Sq * ld +
                (int64_t)f.h * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= p.Sq) continue;
      const float lc = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<uint32_t*>(out + r * ld + j * 8 + 2 * qi) =
            pack_bf16(o[j][2 * h] / lc, o[j][2 * h + 1] / lc);
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
      if (lane == 0) {
        mbar_expect_tx(&kv_bar, 2 * kKVBytes);
        for (int j = 0; j < NB; ++j)
          for (int r = 0; r < 2; ++r) {
            const int row = b * p.Sk + k0 + r * kBox;
            tma_load_2d(Ks + j * kSlabBytes + r * kBoxBytes, &maps.k, &kv_bar,
                        h * D + j * kBox, row);
            tma_load_2d(Vs + j * kSlabBytes + r * kBoxBytes, &maps.v, &kv_bar,
                        h * D + j * kBox, row);
          }
      }
      __syncwarp();
      if (br.row != nullptr && !br.full)
        stage_bias_row(bias_s, br.row, k0, p.Sk, lane);
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
                        h * D + j * kBox, b * p.Sq + q0);
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
    const Drop dr = tile_drop(p, kc, bh, q0, k0);
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

  const int64_t ld = (int64_t)p.H * D;
  bf16* dkb = static_cast<bf16*>(p.dk) + (int64_t)b * p.Sk * ld + h * D;
  bf16* dvb = static_cast<bf16*>(p.dv) + (int64_t)b * p.Sk * ld + h * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kc = key[hh];
    if (kc >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(dkb + kc * ld + j * 8 + 2 * qi) =
          pack_bf16(dk[j][2 * hh], dk[j][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dvb + kc * ld + j * 8 + 2 * qi) =
          pack_bf16(dv[j][2 * hh], dv[j][2 * hh + 1]);
    }
  }
}

// The post-pass: dq = the f32 accumulator rounded to bf16, 4 a thread.
__global__ void __launch_bounds__(kThreads)
bwd_dq_round_kernel(const float4* __restrict__ dq_acc,
                    uint2* __restrict__ dq, int64_t n4) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  const float4 v = dq_acc[i];
  dq[i] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// ------------------------------------------------------------- launches
// The call's tensor maps (dout unused by the forward).
cudaError_t make_maps(Maps* m, const Params& p, int D) {
  const int64_t ld = (int64_t)p.H * D;
  cudaError_t err;
  if ((err = hopper::tensor_map_2d(&m->q, p.q, (int64_t)p.B * p.Sq, ld, ld)) !=
      cudaSuccess)
    return err;
  if ((err = hopper::tensor_map_2d(&m->k, p.k, (int64_t)p.B * p.Sk, ld, ld)) !=
      cudaSuccess)
    return err;
  if ((err = hopper::tensor_map_2d(&m->v, p.v, (int64_t)p.B * p.Sk, ld, ld)) !=
      cudaSuccess)
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
  if constexpr (std::is_same<T, bf16>::value) {
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
  if constexpr (std::is_same<T, bf16>::value) {
    if ((err = launch_delta<bf16, D>(static_cast<const bf16*>(p.dout),
                                     static_cast<const bf16*>(p.o), p.delta,
                                     p.B, p.Sq, p.H, stream, p.dq_acc)) !=
        cudaSuccess)
      return err;
    Maps maps;
    if ((err = make_maps(&maps, p, D)) != cudaSuccess) return err;
    auto k = bwd_wg_kernel<D>;
    if ((err = allow_smem(k, bwd_wg_smem<D>())) != cudaSuccess) return err;
    const dim3 grid(p.H, p.B, (p.Sk + kKeysW - 1) / kKeysW);
    k<<<grid, kThreadsW, bwd_wg_smem<D>(), stream>>>(maps, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int64_t n4 = (int64_t)p.B * p.Sq * p.H * D / 4;
    bwd_dq_round_kernel<<<(unsigned)((n4 + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(p.dq_acc),
        static_cast<uint2*>(p.dq), n4);
  } else {
    if ((err = launch_delta<T, D>(static_cast<const T*>(p.dout),
                                  static_cast<const T*>(p.o), p.delta, p.B,
                                  p.Sq, p.H, stream)) != cudaSuccess)
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

// Fills the shape fields and checks them; false on a shape the kernels do
// not take.
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
  const bool drop_ok = !use_drop || (p.seed != nullptr && bq > 0 &&
                                     bk > 0 && bq % kKeysW == 0 &&
                                     bk % kKeysW == 0);
  return B >= 1 && H >= 1 && Sq >= 1 && Sk >= 1 && (D == 64 || D == 128) &&
         bias_ok && drop_ok;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o share it). bias: f32
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
  if (!set_shape(p, B, Sq, Sk, H, D, bias_b, bias_q, causal, use_drop, keep,
                 scale, bq, bk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)launch_fwd<float, 64>(p, s);
  if (dtype == 0 && D == 128) return (int)launch_fwd<float, 128>(p, s);
  if (dtype == 1 && D == 64) return (int)launch_fwd<bf16, 64>(p, s);
  if (dtype == 1 && D == 128) return (int)launch_fwd<bf16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}

// The backward, on one stream. bf16: a pre-pass (delta, and dq_acc
// zeroed), the one-pass kernel, a post-pass rounding dq_acc into dq. f32:
// the delta pre-pass, a dk/dv pass and a dq pass. Scratch allocated by the
// caller: delta f32 [B, H, Sq]; dq_acc f32 [B, Sq, H, D] (required for
// bf16, which is refused without it; may be null for f32). dq, dk and dv
// are written in full.
extern "C" int ptt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             const void* bias, const void* seed, void* delta,
                             void* dq_acc, void* dq, void* dk, void* dv,
                             int B, int Sq, int Sk, int H, int D, int bias_b,
                             int bias_q, int causal, int use_drop, float keep,
                             float scale, int bq, int bk, int dtype,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.bias = static_cast<const float*>(bias);
  p.seed = static_cast<const int32_t*>(seed);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.dq_acc = static_cast<float*>(dq_acc);
  if (!set_shape(p, B, Sq, Sk, H, D, bias_b, bias_q, causal, use_drop, keep,
                 scale, bq, bk))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && dq_acc == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)launch_bwd<float, 64>(p, s);
  if (dtype == 0 && D == 128) return (int)launch_bwd<float, 128>(p, s);
  if (dtype == 1 && D == 64) return (int)launch_bwd<bf16, 64>(p, s);
  if (dtype == 1 && D == 128) return (int)launch_bwd<bf16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
