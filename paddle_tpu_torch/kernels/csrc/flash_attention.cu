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
//   this kernel's tiles; the caller passes them. They are multiples of 128,
//   so none of this kernel's 64- or 32-row tiles straddles one of their
//   blocks and the ids hold per tile. Computed per element from global
//   coordinates in both passes, so the masks agree bit for bit with the
//   plain version and with paddle_tpu's interpret mode. (On the TPU itself
//   the reference draws from the hardware PRNG, which nothing reproduces.)
//
// Design, as flash_attention_qkv.cu's (shared pieces in
// flash_common.cuh): one block per (b, h, 64-query tile) runs an online
// softmax over 64-key tiles, skipping key tiles past the causal diagonal;
// the backward is a delta pre-pass, a dk/dv pass (block per 64-key tile,
// looping over the query rows that see it) and a dq pass (block per
// 64-query tile, looping over its key tiles), both recomputing P from lse.
// Rows past Sq and keys past Sk are loaded as zeros; padded rows are
// never written and get lse = +inf in the backward, so they add nothing.
// bf16 runs on the tensor cores (mma.sync m16n8k16, 4 warps of 16 rows);
// f32 runs on FMAs (the tensor cores have no exact f32 mode) and serves
// the agreement checks. The bias is read per element from global memory
// (one [Sk] row per batch for a key-padding mask, L1-resident).
//
// Bound on the H100, at BERT-large's training shape (B8 S512 H16 D64,
// bf16, a [B,1,1,S] key-padding mask with lengths in [384, 512), counting
// only the key rows some query sees, as chip_smoke.py does): the forward
// moves q, those k and v rows, the bias rows, o and lse (31.9 MB, 0.0095
// ms at 3.35 TB/s) for 4*D*H flops per visible pair (7.6 GFLOP, 0.0077
// ms at 989 TFLOP/s); the backward moves 65.5 MB (0.0195 ms) for 10*D*H
// flops per pair (19.0 GFLOP, 0.0192 ms): both bytes-bound, the backward
// barely. The design answers the products with the tensor cores
// and never writes the [S,S] scores out; what it leaves is latency and
// the work of padding: no copy/compute overlap (cp.async or TMA),
// mma.sync instead of wgmma, 4 warps per block, S and dP computed twice
// in the backward, and key tiles that are wholly padding still computed
// (ROADMAP B2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

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
  int B, Sq, Sk, H, bias_b, bias_q, causal, off, use_drop, bq, bk;
  float keep, scale;
};

// One (b, h) head: element offsets of (b, 0, h, 0) in the query-side
// tensors (q, o, dO, dq) and the key-side ones (k, v, dk, dv).
struct Head {
  int b, bh;
  int64_t ld, qoff, koff;
  uint32_t seed;
};

__device__ __forceinline__ Head head(const Params& p, int D) {
  Head g;
  const int h = blockIdx.y;
  g.b = blockIdx.z;
  g.bh = g.b * p.H + h;
  g.ld = (int64_t)p.H * D;
  g.qoff = (int64_t)g.b * p.Sq * g.ld + (int64_t)h * D;
  g.koff = (int64_t)g.b * p.Sk * g.ld + (int64_t)h * D;
  g.seed = p.use_drop ? (uint32_t)p.seed[0] : 0u;
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
// reference block that holds it and that block's origin.
struct TileDrop {
  uint32_t base;
  int r0, c0;
  __device__ __forceinline__ float at(const Params& p, int r, int c,
                                      float inv_keep) const {
    return keep_scale(base, (uint32_t)(r - r0), (uint32_t)(c - c0), p.keep,
                      inv_keep);
  }
};

__device__ __forceinline__ TileDrop tile_drop(const Params& p, const Head& g,
                                              int q0, int k0) {
  const int qb = q0 / p.bq, kb = k0 / p.bk;
  return {p.use_drop ? mix32(g.seed, g.bh, qb, kb) : 0u, qb * p.bq,
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
  const float inv_keep = 1.0f / p.keep;

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
    const TileDrop dr = tile_drop(p, g, q0, k0);
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
        if (p.use_drop) pv *= dr.at(p, q0 + r, k0 + c, inv_keep);
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
    const Head& g, int q0, int k0, float inv_keep, int ty, int tx) {
  const TileDrop dr = tile_drop(p, g, q0, k0);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float pr =
          expf(score(s[i][j], p, g.b, q0 + r, k0 + c) - lse_r[i]);
      const float ks = p.use_drop ? dr.at(p, q0 + r, k0 + c, inv_keep) : 1.f;
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
  const float inv_keep = 1.0f / p.keep;

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
    probs_and_dscores(s, dp, lse_r, delta_r, Ps, dSs, p, g, q0, k0, inv_keep,
                      ty, tx);
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
  const float inv_keep = 1.0f / p.keep;

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
    probs_and_dscores(s, dp, lse_r, delta_r, nullptr, dSs, p, g, q0, k0,
                      inv_keep, ty, tx);
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

// ------------------------------------------------- bf16: the tensor cores
template <int D>
__global__ void __launch_bounds__(kThreadsTC) fwd_tc_kernel(const Params p) {
  constexpr int LD = D + kPad, LT = kTile + kPad, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // [64][LD]
  bf16* Ks = Qs + kTile * LD;                        // [64][LD]
  bf16* Vt = Ks + kTile * LD;                        // [D][LT]

  const Head g = head(p, D);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int lane = threadIdx.x & 31, gi = lane >> 2, qi = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const bf16* kb = static_cast<const bf16*>(p.k) + g.koff;
  const bf16* vb = static_cast<const bf16*>(p.v) + g.koff;
  const float inv_keep = 1.0f / p.keep;

  copy_tile<D, kTile>(Qs, static_cast<const bf16*>(p.q) + g.qoff + q0 * g.ld,
                      g.ld, p.Sq - q0);
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) frag_a(qa[kk], Qs, LD, r0, kk * 16, gi, qi);
  float o[ND][4], m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const int row = q0 + r0 + gi;    // this thread's rows: row, row + 8
  const int nk = key_tiles(p, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous K/V tiles are consumed
    copy_tile<D, kTile>(Ks, kb + k0 * g.ld, g.ld, p.Sk - k0);
    copy_tile_t<D, kTile>(Vt, vb + k0 * g.ld, g.ld, p.Sk - k0);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b[2];
        frag_b(b, Ks, LD, n * 8, kk * 16, gi, qi);
        mma(s[n], qa[kk], b);
      }
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
    const TileDrop dr = tile_drop(p, g, q0, k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = expf(s[n][e] - m_new[e >> 1]);
        sum[e >> 1] += pv;
        if (p.use_drop)
          pv *= dr.at(p, row + 8 * (e >> 1), k0 + n * 8 + 2 * qi + (e & 1),
                      inv_keep);
        s[n][e] = pv;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
      m[h] = m_new[h];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      as_a(pa, s, kk);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b[2];
        frag_b(b, Vt, LT, n * 8, kk * 16, gi, qi);
        mma(o[n], pa, b);
      }
    }
  }

  bf16* out = static_cast<bf16*>(p.out) + g.qoff;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= p.Sq) continue;
    const float lc = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(out + r * g.ld + n * 8 + 2 * qi) =
          pack_bf16(o[n][2 * h] / lc, o[n][2 * h + 1] / lc);
    if (qi == 0) p.lse_out[(int64_t)g.bh * p.Sq + r] = m[h] + logf(lc);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC) dkdv_tc_kernel(const Params p) {
  constexpr int LD = D + kPad, LQ = kBQ + kPad, KD = D / 16, ND = D / 8,
                NQ = kBQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);     // [64][LD]
  bf16* Vs = Ks + kTile * LD;                        // [64][LD]
  bf16* Qs = Vs + kTile * LD;                        // [kBQ][LD]
  bf16* dOs = Qs + kBQ * LD;                         // [kBQ][LD]
  bf16* Qt = dOs + kBQ * LD;                         // [D][LQ]
  bf16* dOt = Qt + D * LQ;                           // [D][LQ]
  float* lse_s = reinterpret_cast<float*>(dOt + D * LQ);
  float* delta_s = lse_s + kBQ;

  const Head g = head(p, D);
  const int k0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, gi = lane >> 2, qi = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const bf16* qb = static_cast<const bf16*>(p.q) + g.qoff;
  const bf16* dob = static_cast<const bf16*>(p.dout) + g.qoff;
  const float inv_keep = 1.0f / p.keep;

  copy_tile<D, kTile>(Ks, static_cast<const bf16*>(p.k) + g.koff + k0 * g.ld,
                      g.ld, p.Sk - k0);
  copy_tile<D, kTile>(Vs, static_cast<const bf16*>(p.v) + g.koff + k0 * g.ld,
                      g.ld, p.Sk - k0);
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int key = k0 + r0 + gi;    // this thread's keys: key, key + 8
  for (int q0 = first_query(p, k0) / kBQ * kBQ; q0 < p.Sq; q0 += kBQ) {
    __syncthreads();  // the previous Q/dO tiles are consumed
    copy_tile<D, kBQ>(Qs, qb + q0 * g.ld, g.ld, p.Sq - q0);
    copy_tile_t<D, kBQ>(Qt, qb + q0 * g.ld, g.ld, p.Sq - q0);
    copy_tile<D, kBQ>(dOs, dob + q0 * g.ld, g.ld, p.Sq - q0);
    copy_tile_t<D, kBQ>(dOt, dob + q0 * g.ld, g.ld, p.Sq - q0);
    if (threadIdx.x < kBQ)
      row_stats(p, g, q0 + threadIdx.x, lse_s[threadIdx.x],
                delta_s[threadIdx.x]);
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ak[4], av[4];
      frag_a(ak, Ks, LD, r0, kk * 16, gi, qi);
      frag_a(av, Vs, LD, r0, kk * 16, gi, qi);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        uint32_t b[2];
        frag_b(b, Qs, LD, n * 8, kk * 16, gi, qi);
        mma(st[n], ak, b);
        frag_b(b, dOs, LD, n * 8, kk * 16, gi, qi);
        mma(dpt[n], av, b);
      }
    }
    const TileDrop dr = tile_drop(p, g, q0, k0);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = key + 8 * (e >> 1);
        const int ql = n * 8 + 2 * qi + (e & 1), q = q0 + ql;
        const float pr = expf(score(st[n][e], p, g.b, q, kc) - lse_s[ql]);
        const float ks = p.use_drop ? dr.at(p, q, kc, inv_keep) : 1.f;
        st[n][e] = pr * ks;                                          // P*keep
        dpt[n][e] = pr * (dpt[n][e] * ks - delta_s[ql]) * p.scale;   // dS
      }
    // dV += (P*keep)^T dO, dK += dS^T Q (contraction over the queries)
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      as_a(pa, st, kk);
      as_a(da, dpt, kk);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b[2];
        frag_b(b, dOt, LQ, n * 8, kk * 16, gi, qi);
        mma(dv[n], pa, b);
        frag_b(b, Qt, LQ, n * 8, kk * 16, gi, qi);
        mma(dk[n], da, b);
      }
    }
  }

  bf16* dkb = static_cast<bf16*>(p.dk) + g.koff;
  bf16* dvb = static_cast<bf16*>(p.dv) + g.koff;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = key + 8 * h;
    if (r >= p.Sk) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dkb + r * g.ld + n * 8 + 2 * qi) =
          pack_bf16(dk[n][2 * h], dk[n][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvb + r * g.ld + n * 8 + 2 * qi) =
          pack_bf16(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC) dq_tc_kernel(const Params p) {
  constexpr int LD = D + kPad, LT = kTile + kPad, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // [64][LD]
  bf16* dOs = Qs + kTile * LD;                       // [64][LD]
  bf16* Ks = dOs + kTile * LD;                       // [64][LD]
  bf16* Vs = Ks + kTile * LD;                        // [64][LD]
  bf16* Kt = Vs + kTile * LD;                        // [D][LT]

  const Head g = head(p, D);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int lane = threadIdx.x & 31, gi = lane >> 2, qi = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const bf16* kb = static_cast<const bf16*>(p.k) + g.koff;
  const bf16* vb = static_cast<const bf16*>(p.v) + g.koff;
  const float inv_keep = 1.0f / p.keep;

  copy_tile<D, kTile>(Qs, static_cast<const bf16*>(p.q) + g.qoff + q0 * g.ld,
                      g.ld, p.Sq - q0);
  copy_tile<D, kTile>(dOs,
                      static_cast<const bf16*>(p.dout) + g.qoff + q0 * g.ld,
                      g.ld, p.Sq - q0);
  const int row = q0 + r0 + gi;    // this thread's rows: row, row + 8
  float lse_r[2], delta_r[2], dq[ND][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) row_stats(p, g, row + 8 * h, lse_r[h], delta_r[h]);
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const int nk = key_tiles(p, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous K/V tiles are consumed
    copy_tile<D, kTile>(Ks, kb + k0 * g.ld, g.ld, p.Sk - k0);
    copy_tile<D, kTile>(Vs, vb + k0 * g.ld, g.ld, p.Sk - k0);
    copy_tile_t<D, kTile>(Kt, kb + k0 * g.ld, g.ld, p.Sk - k0);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ad[4];
      frag_a(aq, Qs, LD, r0, kk * 16, gi, qi);
      frag_a(ad, dOs, LD, r0, kk * 16, gi, qi);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b[2];
        frag_b(b, Ks, LD, n * 8, kk * 16, gi, qi);
        mma(s[n], aq, b);
        frag_b(b, Vs, LD, n * 8, kk * 16, gi, qi);
        mma(dp[n], ad, b);
      }
    }
    const TileDrop dr = tile_drop(p, g, q0, k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + 8 * (e >> 1), c = k0 + n * 8 + 2 * qi + (e & 1);
        const float pr = expf(score(s[n][e], p, g.b, r, c) - lse_r[e >> 1]);
        const float ks = p.use_drop ? dr.at(p, r, c, inv_keep) : 1.f;
        s[n][e] = pr * (dp[n][e] * ks - delta_r[e >> 1]) * p.scale;   // dS
      }
    // dQ += dS K (contraction over the keys)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t da[4];
      as_a(da, s, kk);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b[2];
        frag_b(b, Kt, LT, n * 8, kk * 16, gi, qi);
        mma(dq[n], da, b);
      }
    }
  }

  bf16* dqb = static_cast<bf16*>(p.dq) + g.qoff;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dqb + r * g.ld + n * 8 + 2 * qi) =
          pack_bf16(dq[n][2 * h], dq[n][2 * h + 1]);
  }
}

// ------------------------------------------------------------- launches
template <typename T, int D>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    auto k = fwd_tc_kernel<D>;
    if ((err = allow_smem(k, fwd_tc_smem<D>())) != cudaSuccess) return err;
    k<<<grid, kThreadsTC, fwd_tc_smem<D>(), stream>>>(p);
  } else {
    auto k = fwd_kernel<D>;
    if ((err = allow_smem(k, fwd_smem<D>())) != cudaSuccess) return err;
    k<<<grid, kThreads, fwd_smem<D>(), stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch_delta<T, D>(static_cast<const T*>(p.dout),
                                       static_cast<const T*>(p.o), p.delta,
                                       p.B, p.Sq, p.H, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid_k((p.Sk + kTile - 1) / kTile, p.H, p.B);
  const dim3 grid_q((p.Sq + kTile - 1) / kTile, p.H, p.B);
  if constexpr (std::is_same<T, bf16>::value) {
    auto kv = dkdv_tc_kernel<D>;
    auto kq = dq_tc_kernel<D>;
    if ((err = allow_smem(kv, dkdv_tc_smem<D>())) != cudaSuccess) return err;
    if ((err = allow_smem(kq, dq_tc_smem<D>())) != cudaSuccess) return err;
    kv<<<grid_k, kThreadsTC, dkdv_tc_smem<D>(), stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    kq<<<grid_q, kThreadsTC, dq_tc_smem<D>(), stream>>>(p);
  } else {
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
                                     bk > 0 && bq % kTile == 0 &&
                                     bk % kTile == 0);
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

// The backward: delta pre-pass, dk/dv pass, dq pass, on one stream.
// delta: f32 [B, H, Sq] scratch allocated by the caller. dq, dk and dv are
// written in full.
extern "C" int ptt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             const void* bias, const void* seed, void* delta,
                             void* dq, void* dk, void* dv, int B, int Sq,
                             int Sk, int H, int D, int bias_b, int bias_q,
                             int causal, int use_drop, float keep,
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
  if (!set_shape(p, B, Sq, Sk, H, D, bias_b, bias_q, causal, use_drop, keep,
                 scale, bq, bk))
    return (int)cudaErrorInvalidValue;
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
