// Decode attention for Hopper (sm_90a): one query token per sequence
// against its KV cache, with an online softmax in f32 — the GQA form and
// the matrix-absorbed latent MLA form.
//
// Replaces: src/repro/kernels/decode_attention.py::gqa_decode (_gqa_kernel)
// and ::mla_decode (_mla_kernel), both TPU Pallas kernels. Contract: the
// plain versions repro_torch/kernels/ref.py::decode_attention_ref and
// mla_decode_attention_ref. Inputs are f32 or bf16; logits, softmax and
// the value sums are f32; the output is in the inputs' type.
//   GQA: s = q.k * scale (tanh-capped when softcap > 0), masked to -1e30,
//        context = softmax(s) . v, the G = H / Hkv query heads of a kv
//        head sharing its rows;
//   MLA: s = (q_abs.ckv + q_rope.krope) * scale, context = softmax(s) . ckv
//        (the latent context; every head shares each ckv/krope row).
// An all-invalid row gives the mean of v (of ckv), as the Pallas kernel and
// the oracle do: every logit is -1e30, so every weight is exp(0) = 1.
//
// What bounds it on an H100. GQA: bytes. At Qwen2-VL-7B (H = 28, Hkv = 4,
// D = 128) with B = 4 slots and C = 2048 cache rows in bf16, k and v are
// 16.8 MB against 3.35 TB/s, 5.0 us; the arithmetic (4 B*H*C*D = 59 MFLOP)
// is far below. MLA: operations. At MiniCPM3-4B (H = 40, R = 256, Dr = 32)
// the rows are 4.7 MB (1.4 us of bytes) but every row meets all 40 heads:
// 2 B*H*C*(R + Dr + R) = 0.36 GFLOP in f32 against 67 TFLOP/s, 5.3 us.
//
// Design. The TPU kernel walks the cache of one sequence in order and
// carries (m, l, acc) in scratch; here the blocks run in parallel, so the
// cache is split into chunks of `rows` rows and
//   1. k_partial: one block per (chunk, kv head, sequence) — for MLA, per
//      (chunk, sequence) with all H heads — stages the chunk's key rows
//      (and GQA's value rows) once in shared memory as f32 with 8- or
//      16-byte loads, computes every head's logits against them, and writes
//      per-chunk partials m = max, l = sum exp(s - m) and
//      acc = sum exp(s - m) v;
//   2. k_merge: one block per (head, sequence) merges the partials (M =
//      max m, the chunk weights e^(m - M) once into shared memory, L = sum
//      l e^(m - M), acc = sum acc e^(m - M) in chunk order) and writes
//      acc / max(L, 1e-30) — the same result from run to run.
// So each key/value byte is read from device memory once, whatever the
// number of heads sharing it; every global load is a vector load with
// kInflight of them in flight per thread. The queries sit transposed in
// shared memory
// ([column][head], heads padded to a multiple of 4), so one 16-byte
// broadcast load feeds 4 heads per key element; key rows have an odd
// stride, so a warp reading one column of 32 rows hits 32 banks. The
// products run on the f32 pipes, not the tensor cores (wgmma is later work).
// The ragged last chunk is masked here; C needs no padding.
// The C entry points return cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMergeThreads = 128;
constexpr int kInflight = 8;         // vector loads in flight per thread
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 227 * 1024;

// One operand: element e of row r of sequence b, head (or kv group) g at
// ptr[b*bs + g*gs + r*rs + e], for e < width. width 0: absent.
template <typename T>
struct Seg {
  const T* ptr;
  long long bs, gs, rs;
  int width;
};

__device__ __forceinline__ void store_as(float x, float* o) { *o = x; }
__device__ __forceinline__ void store_as(float x, __nv_bfloat16* o) {
  *o = __float2bfloat16(x);
}

// four consecutive elements in one load: 16 bytes of f32, 8 of bf16
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
  __device__ static void unpack(const float4& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
  __device__ static void unpack(const uint2& v, float* o) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
};

// rows [c0, c0+len) of segment s (sequence b, group g) → dst[r*stride +
// col0 + e] as f32; kInflight loads in flight per thread (a 64-row tile of
// 128 bf16 or f32 columns is one round)
template <typename T>
__device__ void load_tile(const Seg<T>& s, int b, int g, int c0, int len,
                          float* dst, int stride, int col0) {
  using V = typename Vec4<T>::type;
  const int per_row = s.width / 4, n = len * per_row;
  const T* base = s.ptr + b * s.bs + g * s.gs + c0 * s.rs;
  for (int i0 = threadIdx.x; i0 < n; i0 += kInflight * kThreads) {
    V buf[kInflight];
#pragma unroll
    for (int u = 0; u < kInflight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int r = i / per_row, c4 = i - r * per_row;
        buf[u] = *reinterpret_cast<const V*>(base + r * s.rs + 4 * c4);
      }
    }
#pragma unroll
    for (int u = 0; u < kInflight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int r = i / per_row, c4 = i - r * per_row;
        float f[4];
        Vec4<T>::unpack(buf[u], f);
        float* o = dst + r * stride + col0 + 4 * c4;
        o[0] = f[0]; o[1] = f[1]; o[2] = f[2]; o[3] = f[3];
      }
    }
  }
}

// the G query rows of heads g0.. of sequence b (segment q, row stride gs)
// → qT[(col0 + e) * Gp + j] as f32. Consecutive threads take consecutive
// heads, so the transposed stores hit consecutive banks.
template <typename T>
__device__ void load_queries(const Seg<T>& q, int b, int g0, int G,
                             float* qT, int Gp, int col0) {
  using V = typename Vec4<T>::type;
  const int n = G * (q.width / 4);
  const T* base = q.ptr + b * q.bs + g0 * q.gs;
  for (int i0 = threadIdx.x; i0 < n; i0 += kInflight * kThreads) {
    V buf[kInflight];
#pragma unroll
    for (int u = 0; u < kInflight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int c4 = i / G, j = i - c4 * G;
        buf[u] = *reinterpret_cast<const V*>(base + j * q.gs + 4 * c4);
      }
    }
#pragma unroll
    for (int u = 0; u < kInflight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int c4 = i / G, j = i - c4 * G;
        float f[4];
        Vec4<T>::unpack(buf[u], f);
        float* o = qT + (col0 + 4 * c4) * Gp + j;
        o[0] = f[0]; o[Gp] = f[1]; o[2 * Gp] = f[2]; o[3 * Gp] = f[3];
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Layout {        // shared-memory carve-up of k_partial, in floats
  int Gp, Dk, ks, Dv, q_off, k_off, v_off, p_off, total;
};

__host__ __device__ inline Layout layout(int G, int D1, int D2, int Dv,
                                         bool own_v, int rows) {
  Layout L;
  L.Gp = (G + 3) / 4 * 4;
  L.Dk = D1 + D2;
  L.ks = L.Dk | 1;                   // odd: a column of rows is conflict-free
  L.Dv = Dv;
  L.q_off = 0;                       // qT [Dk][Gp]
  L.k_off = L.Dk * L.Gp;             // kt [rows][ks]
  L.v_off = L.k_off + rows * L.ks;   // vt [rows][Dv] (GQA only)
  L.p_off = L.v_off + (own_v ? rows * Dv : 0);   // pT [rows][Gp]
  L.p_off = (L.p_off + 3) / 4 * 4;   // 16-byte aligned for float4 reads
  L.total = L.p_off + rows * L.Gp;
  return L;
}

// ---- pass 1: per (chunk, kv group, sequence) partials ----
// q1/q2 are indexed by head h = g0 + j (j < G): ptr + b*bs + h*gs + e.
template <typename T>
__global__ void __launch_bounds__(kThreads)
k_partial(Seg<T> q1, Seg<T> q2, Seg<T> k1, Seg<T> k2, Seg<T> v,
          const uint8_t* __restrict__ valid, int C, int G, int rows,
          float scale, float softcap, float* __restrict__ part_m,
          float* __restrict__ part_l, float* __restrict__ part_acc) {
  extern __shared__ __align__(16) float sm[];
  const int chunk = blockIdx.x, kg = blockIdx.y, b = blockIdx.z;
  const int nch = gridDim.x, H = gridDim.y * G, g0 = kg * G;
  const int c0 = chunk * rows, len = min(rows, C - c0);
  const bool own_v = v.width > 0;
  const int D1 = k1.width, D2 = k2.width;
  const Layout L = layout(G, D1, D2, own_v ? v.width : D1, own_v, rows);
  float* qT = sm + L.q_off;
  float* kt = sm + L.k_off;
  float* vt = sm + L.v_off;
  float* pT = sm + L.p_off;

  // queries, transposed into qT[c][j] with vector loads in flight; the pad
  // heads' columns are zero
  for (int i = threadIdx.x; i < L.Dk * (L.Gp - G); i += kThreads) {
    const int c = i / (L.Gp - G);
    qT[c * L.Gp + G + (i - c * (L.Gp - G))] = 0.f;
  }
  load_queries(q1, b, g0, G, qT, L.Gp, 0);
  if (D2) load_queries(q2, b, g0, G, qT, L.Gp, D1);
  load_tile(k1, b, kg, c0, len, kt, L.ks, 0);
  if (D2) load_tile(k2, b, kg, c0, len, kt, L.ks, D1);
  if (own_v) load_tile(v, b, kg, c0, len, vt, L.Dv, 0);
  __syncthreads();

  // logits: item (head quad hq, row r); a warp shares hq, so the query
  // load is a broadcast
  const int nhq = L.Gp / 4;
  const uint8_t* vrow = valid + static_cast<size_t>(b) * C + c0;
  for (int i = threadIdx.x; i < len * nhq; i += kThreads) {
    const int hq = i / len, r = i - hq * len;
    const float* krow = kt + r * L.ks;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int c = 0; c < L.Dk; ++c) {
      const float kv = krow[c];
      const float4 q4 = *reinterpret_cast<const float4*>(qT + c * L.Gp +
                                                         4 * hq);
      a0 = fmaf(q4.x, kv, a0);
      a1 = fmaf(q4.y, kv, a1);
      a2 = fmaf(q4.z, kv, a2);
      a3 = fmaf(q4.w, kv, a3);
    }
    const bool ok = vrow[r] != 0;
    float a[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float s = a[u] * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      pT[r * L.Gp + 4 * hq + u] = ok ? s : kNegInf;
    }
  }
  __syncthreads();

  // per head: the chunk's max and sum-exp; the logits become weights
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < G; j += kThreads / 32) {
    float m = kNegInf;
    for (int r = lane; r < len; r += 32) m = fmaxf(m, pT[r * L.Gp + j]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = lane; r < len; r += 32) {
      const float p = expf(pT[r * L.Gp + j] - m);
      pT[r * L.Gp + j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      const size_t row = (static_cast<size_t>(b) * H + g0 + j) * nch + chunk;
      part_m[row] = m;
      part_l[row] = l;
    }
  }
  __syncthreads();

  // weighted values: item (head quad hq, column d); MLA's values are the
  // ckv columns of the key tile
  const float* vs = own_v ? vt : kt;
  const int vstride = own_v ? L.Dv : L.ks;
  for (int i = threadIdx.x; i < L.Dv * nhq; i += kThreads) {
    const int hq = i / L.Dv, d = i - hq * L.Dv;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int r = 0; r < len; ++r) {
      const float vv = vs[r * vstride + d];
      const float4 p4 = *reinterpret_cast<const float4*>(pT + r * L.Gp +
                                                         4 * hq);
      a0 = fmaf(p4.x, vv, a0);
      a1 = fmaf(p4.y, vv, a1);
      a2 = fmaf(p4.z, vv, a2);
      a3 = fmaf(p4.w, vv, a3);
    }
    const float a[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * hq + u;
      if (j < G)
        part_acc[((static_cast<size_t>(b) * H + g0 + j) * nch + chunk) *
                     L.Dv + d] = a[u];
    }
  }
}

// block-wide reduction of one value per thread (fixed order: the same
// result from run to run)
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  x = kMax ? warp_max(x) : warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < kMergeThreads / 32; ++w)
    x = kMax ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// ---- pass 2: merge the chunks of each (head, sequence) in chunk order ----
// The chunk weights e^(m - M) are computed once into shared memory, so the
// value loop's loads are independent of each other.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
k_merge(int nch, int Dv, const float* __restrict__ part_m,
        const float* __restrict__ part_l, const float* __restrict__ part_acc,
        T* __restrict__ out) {
  extern __shared__ float w[];                 // [nch]
  __shared__ float red[kMergeThreads / 32];
  const size_t row = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const float* pm = part_m + row * nch;
  const float* pl = part_l + row * nch;
  const float* pa = part_acc + row * nch * Dv;
  float M = kNegInf;
  for (int c = threadIdx.x; c < nch; c += kMergeThreads) M = fmaxf(M, pm[c]);
  M = block_reduce<true>(M, red);
  float L = 0.f;
  for (int c = threadIdx.x; c < nch; c += kMergeThreads) {
    w[c] = expf(pm[c] - M);
    L += pl[c] * w[c];
  }
  L = block_reduce<false>(L, red);             // also orders the w[] writes
  const float denom = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < Dv; d += kMergeThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int c = 0; c < nch; ++c)
      a += pa[static_cast<size_t>(c) * Dv + d] * w[c];
    store_as(a / denom, out + row * Dv + d);
  }
}

template <typename T>
int launch(Seg<T> q1, Seg<T> q2, Seg<T> k1, Seg<T> k2, Seg<T> v,
           const uint8_t* valid, int B, int groups, int G, int C, int rows,
           float scale, float softcap, float* part_m, float* part_l,
           float* part_acc, T* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool own_v = v.width > 0;
  const int Dv = own_v ? v.width : k1.width;
  const Layout L = layout(G, k1.width, k2.width, Dv, own_v, rows);
  const size_t smem = sizeof(float) * static_cast<size_t>(L.total);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(k_partial<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return e;
  const int nch = (C + rows - 1) / rows;
  k_partial<T><<<dim3(nch, groups, B), kThreads, smem, st>>>(
      q1, q2, k1, k2, v, valid, C, G, rows, scale, softcap, part_m, part_l,
      part_acc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (sizeof(float) * static_cast<size_t>(nch) > 48 * 1024)
    return cudaErrorInvalidValue;
  k_merge<T><<<dim3(groups * G, B), kMergeThreads, sizeof(float) * nch, st>>>(
      nch, Dv, part_m, part_l, part_acc, out);
  return cudaGetLastError();
}

template <typename T>
int gqa(const T* q, const T* k, const T* v, const uint8_t* valid, int B,
        int C, int H, int Hkv, int D, int rows, float scale, float softcap,
        float* part_m, float* part_l, float* part_acc, T* out,
        void* stream) {
  const long long kv_b = static_cast<long long>(C) * Hkv * D;
  const Seg<T> q1{q, static_cast<long long>(H) * D, D, 0, D};
  const Seg<T> none{nullptr, 0, 0, 0, 0};
  const Seg<T> k1{k, kv_b, D, static_cast<long long>(Hkv) * D, D};
  const Seg<T> v1{v, kv_b, D, static_cast<long long>(Hkv) * D, D};
  return launch<T>(q1, none, k1, none, v1, valid, B, Hkv, H / Hkv, C, rows,
                   scale, softcap, part_m, part_l, part_acc, out, stream);
}

template <typename T>
int mla(const T* q_abs, const T* q_rope, const T* ckv, const T* krope,
        const uint8_t* valid, int B, int C, int H, int R, int Dr, int rows,
        float scale, float* part_m, float* part_l, float* part_acc, T* out,
        void* stream) {
  const Seg<T> q1{q_abs, static_cast<long long>(H) * R, R, 0, R};
  const Seg<T> q2{q_rope, static_cast<long long>(H) * Dr, Dr, 0, Dr};
  const Seg<T> k1{ckv, static_cast<long long>(C) * R, 0, R, R};
  const Seg<T> k2{krope, static_cast<long long>(C) * Dr, 0, Dr, Dr};
  const Seg<T> none{nullptr, 0, 0, 0, 0};
  return launch<T>(q1, q2, k1, k2, none, valid, B, 1, H, C, rows, scale,
                   0.f, part_m, part_l, part_acc, out, stream);
}

}  // namespace

#define DECODE_ENTRIES(SUFFIX, T)                                             \
  extern "C" int gqa_decode_##SUFFIX(                                         \
      const T* q, const T* k, const T* v, const uint8_t* valid, int B, int C, \
      int H, int Hkv, int D, int rows, float scale, float softcap,            \
      float* part_m, float* part_l, float* part_acc, T* out, void* stream) {  \
    return gqa<T>(q, k, v, valid, B, C, H, Hkv, D, rows, scale, softcap,     \
                  part_m, part_l, part_acc, out, stream);                     \
  }                                                                           \
  extern "C" int mla_decode_##SUFFIX(                                         \
      const T* q_abs, const T* q_rope, const T* ckv, const T* krope,          \
      const uint8_t* valid, int B, int C, int H, int R, int Dr, int rows,     \
      float scale, float* part_m, float* part_l, float* part_acc, T* out,     \
      void* stream) {                                                         \
    return mla<T>(q_abs, q_rope, ckv, krope, valid, B, C, H, R, Dr, rows,    \
                  scale, part_m, part_l, part_acc, out, stream);              \
  }

DECODE_ENTRIES(f32, float)
DECODE_ENTRIES(bf16, __nv_bfloat16)
