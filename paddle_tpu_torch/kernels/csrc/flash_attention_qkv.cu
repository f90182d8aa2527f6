// qkv flash attention forward for Hopper (sm_90a), plain C interface, in
// the two column layouts of the fused projection.
//
// Replaces the forward TPU kernels of paddle_tpu/kernels/flash_attention.py:
// - B1, pair-major: :849 `_fwd_qkv_kernel` (launched by `_fwd_qkv`, :905);
// - B5, which-major: :1018 `_fwd_qkv3_kernel` (launched by `_fwd_qkv3`,
//   :1071).
// Their backwards (`_bwd_qkv` :936, `_bwd_qkv3` :1107) run in
// flash_attention.cu: the general kernels' one-pass backward, reading this
// projection through a row stride and a head-to-column rule that the
// wrapper fills (`ptt_flash_qkv_bwd`; `qkv_columns` in
// kernels/flash_attention.py). The two forwards compute the same thing
// and differ only in where a head's columns lie, so one set of kernels
// serves both with the layout as a template parameter (`Geometry`).
//
// What they compute, as the TPU kernels do (`_packed_head_attn` :821-837):
// the input is the fused projection qkv [B,S,3*H*D], read as it lies, in
// one of two packings:
// - PAIR-MAJOR (B1): pair p's q at columns 6Dp + [0,2D), k at
//   6Dp + [2D,4D), v at 6Dp + [4D,6D), head h of the pair at offset hD
//   inside each;
// - WHICH-MAJOR (B5): q of head h at columns hD, k at HD + hD, v at
//   2HD + hD (the reference reads these regions through three views of
//   one array).
// The row stride is 3HD in both. Scores are q.k * scale in f32
// (scale = 1/sqrt(D), passed in), causal-masked to -1e30 (not -inf). The
// forward writes o [B,S,H*D] in the input dtype and lse [B,H,S] in f32:
// l sums the RAW p, o = (p*keep).v / max(l, 1e-30), lse = m +
// log(max(l, 1e-30)), and p*keep is rounded to the input dtype before the
// product.
//
// Dropout: keep/scale is the reference's interpret-mode hash
// (`_hash_keep_scale`, :101-116) of (seed, (b, pair, head), global query
// row, global key column), computed per element from global coordinates
// and compared through the integer threshold (`keep_threshold`,
// flash_common.cuh), so the masks agree bit for bit with the plain version
// and with paddle_tpu's interpret mode. B5 hashes the same ids (:1031), so
// a head keeps the same elements in both layouts, and the backward in
// flash_attention.cu hashes them too (`head_ids`). (On the TPU itself the
// reference draws from the hardware PRNG, which nothing can reproduce.)
//
// How it differs from the TPU kernels: those hold a whole sequence per
// (b, pair) block in VMEM (s <= 2048). Here every block owns one query
// tile and streams K/V tiles through shared memory with an online softmax
// (running max and sum, accumulator rescaled), causal tiles past the
// diagonal skipped, the longest causal rows first. Two implementations:
// - bf16 (the training path): Hopper's warpgroup products fed by TMA
//   (`flash_fwd_wg_kernel`). A block of 128 queries has three
//   warpgroups: one producer warp issues TMA loads of the head's K and V
//   tiles of 128 keys (64 rows x 64 columns a box, 128-byte swizzle,
//   through one tensor map over qkv as a 2-D [B*S, 3HD] array, the
//   head's columns from `Geometry`, so both layouts share the map) into
//   a ring of 2 (D=128) or 3 (D=64) stages with full and empty
//   mbarriers; two consumer warpgroups of 64 rows each run S = Q.K^T as
//   wgmma m64n128k16 from shared memory, keep the
//   online softmax on the accumulator fragments (each warp's 16 rows in
//   the mma.sync C layout), and add P.V as wgmma with P in registers and
//   V read through a transposed descriptor: no transposed copy of V.
//   The scores are kept in log2 units (scale * log2(e) folded in), so
//   each exponential is one ex2. The grid is persistent (one block an
//   SM, tiles longest first, round robin) and Q is double-buffered, so
//   the producer loads the next tile while the consumers finish this
//   one. setmaxnreg hands the producer's registers to the consumers;
// - f32: the products on f32 FMAs from shared memory (padded rows so that
//   row and column reads hit distinct banks), 256 threads of 4 x (D/16)
//   outputs each: the tensor cores have no exact f32 mode.
//
// Bound on the H100: at the training shape (B8 S1024 H16 D128, causal,
// bf16) the forward moves 135 MB (qkv in, o and lse out; 0.040 ms at 3.35
// TB/s) for 4*B*H*S^2*D/2 = 34.4 GFLOP (0.035 ms at 989 TFLOP/s): memory
// and compute are close, and at S=2048 the products dominate. The design
// answers the products with the tensor cores, never writes the [S,S]
// scores out, and overlaps its loads with its products (TMA ring, warp
// specialisation). B5 at BERT-large's shape (B8 S512 H16 D64, full, bf16)
// moves 33.8 MB (qkv in, o and lse out; 0.0101 ms) for 4*B*H*S^2*D = 8.59
// GFLOP (0.0087 ms), so it is bound by its bytes. Each tile row of one
// head is 128 bytes (D=64 bf16) at a 6 KB row stride, read as 64-column
// TMA boxes, as B1's pair-major rows are: the layout costs nothing more.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

// Column layout of the fused projection qkv [B,S,3*H*D]. The backward's
// wrapper states the same rule as (group, stride, offsets)
// (`qkv_columns`), and the CPU tests hold that against the reference.
constexpr int kPairMajor = 0;    // B1: [pair: q|k|v] x H/2, each 2D wide
constexpr int kWhichMajor = 1;   // B5: [q|k|v] regions, each H*D wide

struct Geometry {
  int b, hg, pair, hh;
  int64_t ld3;       // row stride of qkv: 3*H*D
  int64_t ld;        // row stride of o: H*D
  int64_t qcol, kcol, vcol;   // this head's q, k and v columns
};

template <int D, int L>
__device__ __forceinline__ Geometry geometry(int H, int hg, int b) {
  Geometry g;
  g.hg = hg;
  g.b = b;
  g.pair = g.hg >> 1;
  g.hh = g.hg & 1;
  g.ld = (int64_t)H * D;
  g.ld3 = 3 * g.ld;
  if (L == kPairMajor) {
    g.qcol = (int64_t)g.pair * 6 * D + g.hh * D;
    g.kcol = g.qcol + 2 * D;
    g.vcol = g.qcol + 4 * D;
  } else {
    g.qcol = (int64_t)g.hg * D;
    g.kcol = g.ld + g.qcol;
    g.vcol = 2 * g.ld + g.qcol;
  }
  return g;
}

// The block's own head: (head, batch) = (blockIdx.y, blockIdx.z).
template <int D, int L>
__device__ __forceinline__ Geometry geometry(int H) {
  return geometry<D, L>(H, blockIdx.y, blockIdx.z);
}

template <int D, int L>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ qkv,
                 const int32_t* __restrict__ seed, float* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int causal,
                 int use_drop, float keep, float scale) {
  constexpr int LD = D + 1, TD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;

  const Geometry g = geometry<D, L>(H);
  const int nq = S / kTile;
  const int qt = nq - 1 - blockIdx.x;    // the longest causal rows first
  const int q0 = qt * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* base = qkv + (int64_t)g.b * S * g.ld3;
  const uint32_t hbase =
      use_drop ? mix32((uint32_t)seed[0], g.b, g.pair, g.hh) : 0u;
  const uint32_t thr = keep_threshold(keep);
  const float inv_keep = 1.0f / keep;

  load_tile<D>(Qs, base + (int64_t)q0 * g.ld3 + g.qcol, g.ld3, kTile);
  float m[kTM], l[kTM], acc[kTM][TD];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  const int nk = causal ? qt + 1 : nq;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous K/V/P tiles are consumed
    load_tile<D>(Ks, base + (int64_t)k0 * g.ld3 + g.kcol, g.ld3, kTile);
    load_tile<D>(Vs, base + (int64_t)k0 * g.ld3 + g.vcol, g.ld3, kTile);
    __syncthreads();
    float s[kTM][4];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_product<4, D, LD, 1, 1, LD>(s, Qs, Ks, ty, tx);
    const bool diag = causal && kt == qt;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty + 16 * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = (diag && c > r) ? kMasked : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p = expf(s[i][j] - m_new);
        sum += p;
        if (use_drop) p *= keep_scale(hbase, q0 + r, k0 + c, thr, inv_keep);
        Ps[r * kLS + c] = p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_product<TD, kTile, kLS, 1, LD, 1>(acc, Ps, Vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty + 16 * i;
    const float lc = fmaxf(l[i], 1e-30f);
    float* orow =
        out + ((int64_t)g.b * S + q0 + r) * g.ld + (int64_t)g.hg * D;
#pragma unroll
    for (int j = 0; j < TD; ++j) orow[tx + 16 * j] = acc[i][j] / lc;
    if (tx == 0)
      lse[((int64_t)g.b * H + g.hg) * S + q0 + r] = m[i] + logf(lc);
  }
}

// The bf16 forward on Hopper: a 128-query block of three warpgroups. A
// producer warp streams the head's 128-key K and V tiles by TMA into a
// ring of `fwd_wg_stages` stages; two consumer warpgroups, 64 query rows
// each, compute
// S = Q.K^T with wgmma from shared memory, keep the online softmax on the
// accumulator fragments, and add P.V with P in registers as the A operand
// and V read through a transposed (MN-major) descriptor.
//
// The grid is persistent: one block an SM walks 128-query tiles, longest
// causal rows first, and Q is double-buffered, so the producer loads the
// next tile's Q and K/V while the consumers finish this one.
//
// Shared memory: Q [2 tiles][2][D/64][64 rows][64 cols], then per stage
// K and V [D/64][128 rows][64 cols], every 64 x 64 box (8 KB) as the TMA
// writes it with the 128-byte swizzle, which the wgmma descriptors read
// back.
constexpr int kRowsW = 64;             // rows of a consumer warpgroup
constexpr int kKeysW = 128;            // keys of a K/V tile
constexpr int kThreadsW = 384;         // producer + 2 consumer warpgroups
using hopper::ex2;
using hopper::kBox;                    // TMA box: 64 rows x 64 bf16 columns
using hopper::kBoxBytes;
using hopper::kLn2;
using hopper::kLog2e;

// K/V ring stages: 2 of 64 KB at D=128, 3 of 32 KB at D=64
template <int D>
__host__ __device__ constexpr int fwd_wg_stages() {
  return D == 128 ? 2 : 3;
}
template <int D>
constexpr size_t fwd_wg_smem() {
  return 1024 + (size_t)(4 + 4 * fwd_wg_stages<D>()) * (D / kBox) *
                    kBoxBytes;
}

// One 128-query tile of the persistent grid: tiles are numbered longest
// causal rows first (all heads' last query tile, then the one before...)
struct FwdTile {
  int qt, hg, b;
};
__device__ __forceinline__ FwdTile fwd_tile(int t, int nq, int H, int B) {
  const int j = t / (H * B), r = t % (H * B);
  return {nq - 1 - j, r % H, r / H};
}

template <int D, int L>
__global__ void __launch_bounds__(kThreadsW, 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap qkv_map,
                    const int32_t* __restrict__ seed, bf16* __restrict__ out,
                    float* __restrict__ lse, int B, int S, int H, int causal,
                    int use_drop, float keep, float scale) {
  using namespace hopper;
  constexpr int NB = D / kBox;          // boxes across a head's columns
  constexpr int ND = D / 8;             // 8-column n-tiles of O
  constexpr int NS = kKeysW / 8;        // 8-column n-tiles of S
  constexpr int kStagesW = fwd_wg_stages<D>();
  constexpr int kTileBytes = NB * kBoxBytes;          // 64 rows x D
  constexpr int kSlabBytes = 2 * kBoxBytes;           // 128 keys x 64 cols
  constexpr int kKVBytes = NB * kSlabBytes;           // 128 keys x D
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStagesW], empty_bar[kStagesW];
  __shared__ __align__(8) uint64_t qfull_bar[2], qempty_bar[2];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;                         // [2 tiles][2][NB]
  unsigned char* KVs = smem + 4 * kTileBytes;  // [stage][K|V][NB slabs]

  const int nq = (S + 2 * kRowsW - 1) / (2 * kRowsW);
  const int tiles = nq * H * B;
  // key tiles; a last partial one (S % 128 == 64) masks its columns
  // past S
  const int nk_all = (S + kKeysW - 1) / kKeysW;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesW; ++s) {
      mbar_init(&full_bar[s], 1);
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
    if (threadIdx.x == 0) {
      int it = 0;                          // K/V tiles issued so far
      int n = 0;                           // query tiles of this block
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
        const FwdTile f = fwd_tile(t, nq, H, B);
        const Geometry g = geometry<D, L>(H, f.hg, f.b);
        const int q0 = f.qt * 2 * kRowsW, row0 = f.b * S;
        const int nk = causal ? f.qt + 1 : nk_all;
        const int active = min(2, (S - q0) / kRowsW);
        const int qb = n & 1;
        mbar_wait(&qempty_bar[qb], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&qfull_bar[qb], active * kTileBytes);
        for (int c = 0; c < active; ++c)
          for (int j = 0; j < NB; ++j)
            tma_load_2d(Qs + ((qb * 2 + c) * NB + j) * kBoxBytes, &qkv_map,
                        &qfull_bar[qb], (int)g.qcol + j * kBox,
                        row0 + q0 + c * kRowsW);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStagesW;
          mbar_wait(&empty_bar[s], ((it / kStagesW) & 1) ^ 1);
          mbar_expect_tx(&full_bar[s], 2 * kKVBytes);
          unsigned char* Ks = KVs + s * 2 * kKVBytes;
          unsigned char* Vs = Ks + kKVBytes;
          // each 64-column slab: two 64-row boxes, one after the other
          for (int j = 0; j < NB; ++j)
            for (int r = 0; r < 2; ++r) {
              const int row = row0 + kt * kKeysW + r * kBox;
              tma_load_2d(Ks + j * kSlabBytes + r * kBoxBytes, &qkv_map,
                          &full_bar[s], (int)g.kcol + j * kBox, row);
              tma_load_2d(Vs + j * kSlabBytes + r * kBoxBytes, &qkv_map,
                          &full_bar[s], (int)g.vcol + j * kBox, row);
            }
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
  const uint32_t thr = keep_threshold(keep);
  const float inv_keep = 1.0f / keep;
  const float scale_l2 = scale * kLog2e;
  const uint32_t seed0 = use_drop ? (uint32_t)seed[0] : 0u;
  int it = 0, n = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
    const FwdTile f = fwd_tile(t, nq, H, B);
    const Geometry g = geometry<D, L>(H, f.hg, f.b);
    const int q0 = f.qt * 2 * kRowsW;
    const int nk = causal ? f.qt + 1 : nk_all;
    const int my_q0 = q0 + c * kRowsW;
    const bool live = c < min(2, (S - q0) / kRowsW);
    const int my_nk = live ? nk : 0;
    const uint32_t hbase = use_drop ? mix32(seed0, g.b, g.pair, g.hh) : 0u;
    const int qb = n & 1;
    const unsigned char* Qc = Qs + (qb * 2 + c) * kTileBytes;

    float o[ND][4], m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    if (live) mbar_wait(&qfull_bar[qb], (n >> 1) & 1);

    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStagesW;
      mbar_wait(&full_bar[s], (it / kStagesW) & 1);
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
        // scores in log2 units (s * scale * log2(e)), so that each
        // exponential is one ex2; only the last tile is masked (causally,
        // and past S)
        float mx[2] = {kMasked, kMasked};
        if (kt == nk - 1 && (causal || k0 + kKeysW > S)) {
          const int lim_c = S - 1 - k0;          // last column in S
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = my_q0 + r0 + gi + 8 * (e >> 1) - k0;
              const int col = j * 8 + 2 * qi + (e & 1);
              const bool cut = col > lim_c || (causal && col > row);
              sc[j][e] = cut ? kMasked : sc[j][e] * scale_l2;
              mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
            }
        } else {
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[j][e] *= scale_l2;
              mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
            }
        }
        float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m_new[h] = fmaxf(m[h], quad_max(mx[h]));
          alpha[h] = ex2(m[h] - m_new[h]);
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(sc[j][e] - m_new[e >> 1]);
            sum[e >> 1] += p;
            if (use_drop)
              p *= keep_scale(hbase, my_q0 + r0 + gi + 8 * (e >> 1),
                              k0 + j * 8 + 2 * qi + (e & 1), thr, inv_keep);
            sc[j][e] = p;
          }
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
          const uint64_t dv =
              desc_sw128(Vs + kk * 16 * 128, kSlabBytes, 1024);
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

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = my_q0 + r0 + gi + 8 * h;
      const float lc = fmaxf(l[h], 1e-30f);
      bf16* orow = out + ((int64_t)g.b * S + row) * g.ld + (int64_t)g.hg * D;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * qi) =
            pack_bf16(o[j][2 * h] / lc, o[j][2 * h + 1] / lc);
      if (qi == 0)
        lse[((int64_t)g.b * H + g.hg) * S + row] = m[h] * kLn2 + logf(lc);
    }
  }
}

// The TMA map of the fused projection as a 2-D bf16 array [B*S, 3*H*D]
// (row stride 6HD bytes, a multiple of 16 for D in {64, 128}) in 64 x 64
// boxes with the 128-byte swizzle.
cudaError_t qkv_tensor_map(CUtensorMap* map, const void* qkv, int B, int S,
                           int H, int D) {
  return hopper::tensor_map_2d(map, qkv, (int64_t)B * S, (int64_t)3 * H * D,
                               (int64_t)3 * H * D);
}

template <typename T, int D, int L>
cudaError_t launch_fwd(const void* qkv, const void* seed, void* out, void* lse,
                       int B, int S, int H, int causal, int use_drop,
                       float keep, float scale, cudaStream_t stream) {
  const dim3 grid(S / kTile, H, B);
  const int32_t* sd = static_cast<const int32_t*>(seed);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    CUtensorMap map;
    if ((err = qkv_tensor_map(&map, qkv, B, S, H, D)) != cudaSuccess)
      return err;
    auto k = flash_fwd_wg_kernel<D, L>;
    if ((err = allow_smem(k, fwd_wg_smem<D>())) != cudaSuccess) return err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    const int tiles = (S + 2 * kRowsW - 1) / (2 * kRowsW) * H * B;
    k<<<min(tiles, sms), kThreadsW, fwd_wg_smem<D>(), stream>>>(
        map, sd, static_cast<bf16*>(out), l, B, S, H, causal, use_drop, keep,
        scale);
  } else {
    auto k = flash_fwd_kernel<D, L>;
    if ((err = allow_smem(k, fwd_smem<D>())) != cudaSuccess) return err;
    k<<<grid, kThreads, fwd_smem<D>(), stream>>>(
        static_cast<const T*>(qkv), sd, static_cast<T*>(out), l, S, H, causal,
        use_drop, keep, scale);
  }
  return cudaGetLastError();
}

bool valid_shape(int B, int S, int H, int D) {
  return B >= 1 && S >= kTile && S % kTile == 0 && H >= 2 && H % 2 == 0 &&
         (D == 64 || D == 128);
}

// The C entries of one layout: shape checks, then the (dtype, D) instance.
template <int L>
int fwd_entry(const void* qkv, const void* seed, void* out, void* lse, int B,
              int S, int H, int D, int causal, int use_drop, float keep,
              float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_shape(B, S, H, D) || (use_drop && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    err = launch_fwd<float, 64, L>(qkv, seed, out, lse, B, S, H, causal,
                                   use_drop, keep, scale, s);
  else if (dtype == 0 && D == 128)
    err = launch_fwd<float, 128, L>(qkv, seed, out, lse, B, S, H, causal,
                                    use_drop, keep, scale, s);
  else if (dtype == 1 && D == 64)
    err = launch_fwd<bf16, 64, L>(qkv, seed, out, lse, B, S, H, causal,
                                  use_drop, keep, scale, s);
  else if (dtype == 1 && D == 128)
    err = launch_fwd<bf16, 128, L>(qkv, seed, out, lse, B, S, H, causal,
                                   use_drop, keep, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (qkv, o and dqkv share it). seed: an
// int32 on the device, read only when use_drop != 0. keep = 1 - dropout_p
// and scale = 1/sqrt(D), both rounded to f32 by the caller. Returns the
// CUDA error of the launch (0 = launched). The caller checks shapes,
// dtypes, contiguity and 16-byte alignment. `qkv` entries take the
// pair-major projection (B1), `qkv3` entries the which-major one (B5).
extern "C" int ptt_flash_qkv_fwd(const void* qkv, const void* seed, void* out,
                                 void* lse, int B, int S, int H, int D,
                                 int causal, int use_drop, float keep,
                                 float scale, int dtype, int device,
                                 void* stream) {
  return fwd_entry<kPairMajor>(qkv, seed, out, lse, B, S, H, D, causal,
                               use_drop, keep, scale, dtype, device, stream);
}

extern "C" int ptt_flash_qkv3_fwd(const void* qkv, const void* seed,
                                  void* out, void* lse, int B, int S, int H,
                                  int D, int causal, int use_drop, float keep,
                                  float scale, int dtype, int device,
                                  void* stream) {
  return fwd_entry<kWhichMajor>(qkv, seed, out, lse, B, S, H, D, causal,
                                use_drop, keep, scale, dtype, device, stream);
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
