// Multi-tensor Adam / AdamW update for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the reference's update is XLA's fusion of
// paddle_tpu/optimizer/optimizers.py:55-100 (`_adam_core`, `Adam` and
// `AdamW._update_rule`) inside the compiled train step. Here one launch
// updates every tensor of a group that shares (param dtype, grad dtype,
// slot dtype, float32 master or not).
//
// What it computes, for each element, in float32 registers and in the
// reference's order (each __f*_rn below is one rounded operation, never
// contracted into an FMA, so the plain PyTorch version gives the same
// bits wherever the powers b^t agree):
// - g in the grad's dtype; with a global-norm clip, g = (g * scale)
//   rounded to the grad's dtype (`nn.clip`); then g cast to the param's
//   dtype (optimizer.py:240), or to float32 when a master is updated;
// - Adam: g = g + wd * p in g's dtype, wd first rounded to that dtype
//   (JAX's weak scalar), the product and the sum each rounded (`_l2`,
//   optimizers.py:20-21);
// - m = b1*m + (1-b1)*g, v = b2*v + (1-b2)*g^2 (slots read up to f32);
//   m^ = m / (1 - b1^t), v^ = v / (1 - b2^t) with t = step + 1 and the
//   powers in float32; upd = m^ / (sqrt(v^) + eps);
// - AdamW: p = p * (1 - lr*wd) (decoupled decay), then p = p - lr*upd;
// - lr is the entry's: the device lr times the entry's rate scale
//   (`ParamAttr(learning_rate=)`, optimizer.py:154), one float32
//   product, exactly lr where the scale is 1;
// - each result rounded once to its storage dtype; a master is updated
//   in float32 and its param written as the master rounded.
// lr, the step count and the optional found-inf flag and clip scale are
// read from device memory, so a captured step replays with the values of
// each call. On found-inf a block writes nothing; the caller advances the
// step count by the same flag (`optimizer.Optimizer.apply_gradients`).
//
// Design: the wrapper writes a table of 72-byte entries {p, g, m, v,
// master, numel, first chunk, wd, rate scale, aligned} to the device
// (`write_rows`, the rows passed as kernel arguments) once for a list of
// tensors and again only when an address changes. The tensors are cut
// into chunks of kChunk elements; block b walks chunks b, b + grid, ...,
// finds each chunk's tensor by a binary search over the entries' first
// chunks, and its threads move 8 elements at a time with 16-byte vector
// loads and stores (two a float32 operand), the last partial group of a
// tensor (and any tensor not 16-byte aligned) element by element.
//
// Bound on the H100: bytes. At gpt3-1.3b's parameter set in bf16 (p, g,
// m, v read; p, m, v written) it moves 14 bytes an element, 18.4 GB for
// 1.315e9 parameters, 5.5 ms at 3.35 TB/s; it does about 25 operations an
// element, far under the 67 TFLOP/s of float32. What the design leaves:
// two float32 divisions and a square root an element in IEEE rounding
// (slower than their approximations), and a chunk's tensor found anew for
// every chunk.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
constexpr int kThreads = 256;
constexpr int kVec = 8;                      // elements a thread moves
constexpr long long kChunk = 65536;          // elements a chunk
constexpr int kBlocksPerSm = 8;

struct Entry {                               // one int64 [9] table row
  void* p;
  const void* g;
  void* m;
  void* v;
  float* master;                             // null without a master
  long long numel;
  long long first_chunk;                     // chunks of earlier entries
  float wd;
  float lr_scale;                            // the entry's lr = lr * this
  long long aligned;                         // every pointer 16-byte aligned
};
static_assert(sizeof(Entry) == 72, "the wrapper writes 72-byte entries");

struct Args {
  const Entry* table;
  int n;
  long long chunks;
  const float* lr;
  const int* step;
  const int* found_inf;                      // null: no skip
  const float* clip;                         // null: no clip scale
  float b1, b2, omb1, omb2, eps;
  int adamw;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ f16 from_f<f16>(float x) {
  return __float2half_rn(x);
}

// x rounded through T and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[kVec]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const f16* p, float (&v)[kVec]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[kVec]) {
  uint4 x;
  uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = x;
}
__device__ __forceinline__ void store8(f16* p, const float (&v)[kVec]) {
  uint4 x;
  uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = x;
}

struct Scalars {
  float lr, bc1, bc2, clip, decay, wd;
  bool has_clip;
};

// The update of one element: p32 (the param, or its master) and the
// stored g, m, v (as floats) in; new p32, m, v out.
template <typename P, typename G, bool kMaster>
__device__ __forceinline__ void adam_one(const Args& a, const Scalars& s,
                                         float& p32, float g, float& m,
                                         float& v) {
  using GT = typename std::conditional<kMaster, float, P>::type;
  if (s.has_clip) g = round_to<G>(__fmul_rn(g, s.clip));
  g = round_to<GT>(g);
  if (!a.adamw && s.wd != 0.f) {
    const float l2 = round_to<GT>(__fmul_rn(round_to<GT>(s.wd),
                                            round_to<GT>(p32)));
    g = round_to<GT>(__fadd_rn(g, l2));
  }
  m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(a.omb2, __fmul_rn(g, g)));
  const float upd = __fdiv_rn(
      __fdiv_rn(m, s.bc1),
      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), a.eps));
  if (a.adamw && s.wd != 0.f) p32 = __fmul_rn(p32, s.decay);
  p32 = __fsub_rn(p32, __fmul_rn(s.lr, upd));
}

template <typename P, typename G, typename S, bool kMaster>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(const Args a) {
  if (a.found_inf != nullptr && *a.found_inf != 0) return;
  Scalars s;
  const float lr = *a.lr;
  const float t = static_cast<float>(*a.step + 1);
  s.bc1 = __fsub_rn(1.f, powf(a.b1, t));
  s.bc2 = __fsub_rn(1.f, powf(a.b2, t));
  s.has_clip = a.clip != nullptr;
  s.clip = s.has_clip ? *a.clip : 1.f;
  for (long long c = blockIdx.x; c < a.chunks; c += gridDim.x) {
    int lo = 0, hi = a.n - 1;                // last entry with first <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (a.table[mid].first_chunk <= c) lo = mid; else hi = mid - 1;
    }
    const Entry e = a.table[lo];
    s.wd = e.wd;
    s.lr = __fmul_rn(lr, e.lr_scale);
    s.decay = __fsub_rn(1.f, __fmul_rn(s.lr, e.wd));
    P* p = static_cast<P*>(e.p);
    const G* g = static_cast<const G*>(e.g);
    S* m = static_cast<S*>(e.m);
    S* v = static_cast<S*>(e.v);
    const long long begin = (c - e.first_chunk) * kChunk;
    const long long end = begin + kChunk < e.numel ? begin + kChunk
                                                   : e.numel;
    for (long long i = begin + threadIdx.x * kVec; i < end;
         i += kThreads * kVec) {
      if (e.aligned && i + kVec <= end) {
        float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
        if (kMaster) load8(e.master + i, pv); else load8(p + i, pv);
        load8(g + i, gv);
        load8(m + i, mv);
        load8(v + i, vv);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          adam_one<P, G, kMaster>(a, s, pv[j], gv[j], mv[j], vv[j]);
        if (kMaster) store8(e.master + i, pv);
        store8(p + i, pv);
        store8(m + i, mv);
        store8(v + i, vv);
      } else {
        const long long stop = i + kVec < end ? i + kVec : end;
        for (long long k = i; k < stop; ++k) {
          float pk = kMaster ? e.master[k] : to_f(p[k]);
          float mk = to_f(m[k]), vk = to_f(v[k]);
          adam_one<P, G, kMaster>(a, s, pk, to_f(g[k]), mk, vk);
          if (kMaster) e.master[k] = pk;
          p[k] = from_f<P>(pk);
          m[k] = from_f<S>(mk);
          v[k] = from_f<S>(vk);
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <typename P, typename G, typename S, bool kMaster>
int launch(const Args& a, cudaStream_t stream) {
  const long long most = static_cast<long long>(sm_count()) * kBlocksPerSm;
  const int grid = static_cast<int>(a.chunks < most ? a.chunks : most);
  adam_kernel<P, G, S, kMaster><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16. S16 is the 16-bit slot
// type (bfloat16, or float16 beside float16 params and grads).
template <typename P, typename G, typename S16 = bf16>
int dispatch_slots(const Args& a, int s_code, int master,
                   cudaStream_t stream) {
  if (s_code == 0)
    return master ? launch<P, G, float, true>(a, stream)
                  : launch<P, G, float, false>(a, stream);
  return master ? launch<P, G, S16, true>(a, stream)
                : launch<P, G, S16, false>(a, stream);
}

constexpr int kRowsPerWrite = 48;            // 3.4 KB of kernel argument

struct Rows {
  Entry row[kRowsPerWrite];
  int count;
};

__global__ void write_rows(Entry* dst, const Rows r) {
  const int i = static_cast<int>(threadIdx.x);
  if (i < r.count) dst[i] = r.row[i];
}

}  // namespace

extern "C" int ptt_multi_tensor_adam(
    const void* table, int n, long long chunks, int p_code, int g_code,
    int s_code, int master, const void* lr, const void* step,
    const void* found_inf, const void* clip, float b1, float b2, float omb1,
    float omb2, float eps, int adamw, void* stream) {
  if (n <= 0 || chunks <= 0) return 0;
  // float32 and bfloat16 mix freely; float16 params take float32 or
  // float16 grads and slots; a master goes with a 16-bit param
  const bool f16_group = p_code == 2 || g_code == 2 || s_code == 2;
  if (p_code < 0 || p_code > 2 || g_code < 0 || g_code > 2 || s_code < 0 ||
      s_code > 2 || (master && p_code == 0) ||
      (f16_group && (p_code != 2 || g_code == 1 || s_code == 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.table = static_cast<const Entry*>(table);
  a.n = n;
  a.chunks = chunks;
  a.lr = static_cast<const float*>(lr);
  a.step = static_cast<const int*>(step);
  a.found_inf = static_cast<const int*>(found_inf);
  a.clip = static_cast<const float*>(clip);
  a.b1 = b1;
  a.b2 = b2;
  a.omb1 = omb1;
  a.omb2 = omb2;
  a.eps = eps;
  a.adamw = adamw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_code == 2)
    return g_code == 0
               ? dispatch_slots<f16, float, f16>(a, s_code, master, s)
               : dispatch_slots<f16, f16, f16>(a, s_code, master, s);
  if (p_code == 0)
    return g_code == 0 ? dispatch_slots<float, float>(a, s_code, 0, s)
                       : dispatch_slots<float, bf16>(a, s_code, 0, s);
  return g_code == 0 ? dispatch_slots<bf16, float>(a, s_code, master, s)
                     : dispatch_slots<bf16, bf16>(a, s_code, master, s);
}

// The table's copy to the device, on the caller's stream, as kernels
// that take up to kRowsPerWrite rows as their argument: nothing reads
// host memory after the launch, so a captured graph holds only kernel
// nodes and the host rows may be freed at once.
extern "C" int ptt_mta_upload(void* dev, const void* host, int n,
                              void* stream) {
  const Entry* rows = static_cast<const Entry*>(host);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < n; first += kRowsPerWrite) {
    Rows r;
    r.count = n - first < kRowsPerWrite ? n - first : kRowsPerWrite;
    for (int i = 0; i < r.count; ++i) r.row[i] = rows[first + i];
    write_rows<<<1, kRowsPerWrite, 0, s>>>(static_cast<Entry*>(dev) + first,
                                           r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
