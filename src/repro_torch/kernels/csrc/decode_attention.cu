// Decode attention for Hopper (sm_90a): one query token per sequence
// against its KV cache, with an online softmax in f32 — the GQA form and
// the matrix-absorbed latent MLA form.
//
// Replaces: src/repro/kernels/decode_attention.py::gqa_decode (_gqa_kernel)
// and ::mla_decode (_mla_kernel), both TPU Pallas kernels; MLA in bf16 at
// the shapes mla_decode.cu takes runs there instead. Contract: the
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
// 16.8 MB against 3.35 TB/s, 5.0 us; the rows a masked softmax needs are
// fewer (the serving slots hold about half their rows). The arithmetic
// (4 B*H*C*D = 59 MFLOP) is far below. MLA: operations. At MiniCPM3-4B
// (H = 40, R = 256, Dr = 32) the rows are 4.7 MB (1.4 us of bytes) but
// every row meets all 40 heads: the f32 value product 2 B*H*C*R = 0.17
// GFLOP against 67 TFLOP/s.
//
// Two designs, one per route:
//
// * GQA in bf16 — k_gqa_split, then k_merge over the splits. The grid is
//   (split, kv head, sequence); the host picks the split count so that
//   there are about two blocks per SM, and each block walks a contiguous
//   range of 64-row tiles with (m, l, acc) in registers — the TPU kernel's
//   sequential grid walk, inside the block. Before any copy, the block
//   reads its rows' mask bytes and lists the tiles with a valid row; only
//   those are read (exact: once a row is valid, a masked row's weight is
//   exp(-1e30 - m) = 0 in f32). A block whose range holds no valid row
//   reads the sequence's whole mask: if any row is valid it writes an
//   empty partial (m = -1e30, l = 0, acc = 0: weight 0 in the merge), and
//   if none is (the all-invalid sequence) it walks every tile of its range
//   as masked rows, so the merge gives the mean of v. The tiles stay bf16
//   in a ring of kStages stages in shared memory, filled with cp.async (16
//   bytes a thread, zero-filled past C), so tiles t+1 and t+2 are in
//   flight while tile t is computed. Each of the 4 warps owns 16 rows of a
//   tile: q.k^T is mma.m16n8k16 (the kv head's G <= 16 query heads,
//   zero-padded to 16, as M; the rows as N; D as K; fragments by ldmatrix
//   from rows padded by 16 bytes, so no ldmatrix has a bank conflict);
//   scale, softcap and mask act on the f32 accumulator; p.v keeps f32
//   weights as two bf16 mmas, p = hi + lo (relative error ~2^-17), with V
//   by ldmatrix.trans. The 4 warps' (m, l, acc) merge in shared memory at
//   the end. k_merge is launched as a programmatic dependent (Hopper's
//   PDL): its blocks are placed while k_gqa_split runs and wait on the
//   grid's end, so its launch does not follow the split kernel's end.
// * GQA in f32, GQA in bf16 where k_gqa_split does not apply (more than
//   16 query heads per kv head, or D not a multiple of 16 up to 256), and
//   MLA in f32 or where k_mla does not apply (mla_decode.cu) — k_partial,
//   then k_merge over chunks (under PDL too): one block per (chunk of
//   `rows` rows, kv head, sequence) — for MLA, per (chunk, sequence) with
//   all H heads — stages the chunk's key rows (and GQA's value rows) once
//   in shared memory as f32 with 8- or 16-byte loads (one element a load
//   where a width is not a multiple of 4),
//   computes every head's logits against them on the f32 pipes, and writes
//   per-chunk partials m = max, l = sum exp(s - m), acc = sum exp(s - m) v.
//   The queries sit transposed in shared memory ([column][head], heads
//   padded to a multiple of 4), so one 16-byte broadcast load feeds 4
//   heads per key element; key rows have an odd stride, so a warp reading
//   one column of 32 rows hits 32 banks.
// k_merge (decode_common.cuh, with the cp.async, ldmatrix and mma helpers
// mla_decode.cu shares): one block per (head, sequence) merges the
// partials in order and writes acc / max(L, 1e-30) — the same result from
// run to run.
// The ragged last tile or chunk is masked here; C needs no padding.
// The C entry points return cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using dec::kMaxSmem;
using dec::kMergeThreads;
using dec::kNegInf;
using dec::store_as;
using dec::warp_max;
using dec::warp_sum;

constexpr int kThreads = 256;
constexpr int kInflight = 8;         // vector loads in flight per thread

// One operand: element e of row r of sequence b, head (or kv group) g at
// ptr[b*bs + g*gs + r*rs + e], for e < width. width 0: absent.
template <typename T>
struct Seg {
  const T* ptr;
  long long bs, gs, rs;
  int width;
};

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

// one element per load, for rows whose width, stride or base rules out
// four-element vectors (a width that is not a multiple of 4)
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
struct Vec1 {
  using type = T;
  __device__ static void unpack(const T& v, float* o) { o[0] = to_float(v); }
};

// kV consecutive elements in one load (4 or 1)
template <typename T, int kV>
struct Vec;
template <typename T>
struct Vec<T, 4> : Vec4<T> {};
template <typename T>
struct Vec<T, 1> : Vec1<T> {};

// rows [c0, c0+len) of segment s (sequence b, group g) → dst[r*stride +
// col0 + e] as f32, kV elements a load; kInflight loads in flight per
// thread (a 64-row tile of 128 bf16 or f32 columns is one round at kV = 4)
template <int kV, typename T>
__device__ void load_tile(const Seg<T>& s, int b, int g, int c0, int len,
                          float* dst, int stride, int col0) {
  using V = typename Vec<T, kV>::type;
  const int per_row = s.width / kV, n = len * per_row;
  const T* base = s.ptr + b * s.bs + g * s.gs + c0 * s.rs;
  for (int i0 = threadIdx.x; i0 < n; i0 += kInflight * kThreads) {
    V buf[kInflight];
#pragma unroll
    for (int u = 0; u < kInflight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int r = i / per_row, cv = i - r * per_row;
        buf[u] = *reinterpret_cast<const V*>(base + r * s.rs + kV * cv);
      }
    }
#pragma unroll
    for (int u = 0; u < kInflight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int r = i / per_row, cv = i - r * per_row;
        float f[kV];
        Vec<T, kV>::unpack(buf[u], f);
        float* o = dst + r * stride + col0 + kV * cv;
#pragma unroll
        for (int e = 0; e < kV; ++e) o[e] = f[e];
      }
    }
  }
}

// the G query rows of heads g0.. of sequence b (segment q, row stride gs)
// → qT[(col0 + e) * Gp + j] as f32, kV elements a load. Consecutive
// threads take consecutive heads, so the transposed stores hit
// consecutive banks.
template <int kV, typename T>
__device__ void load_queries(const Seg<T>& q, int b, int g0, int G,
                             float* qT, int Gp, int col0) {
  using V = typename Vec<T, kV>::type;
  const int n = G * (q.width / kV);
  const T* base = q.ptr + b * q.bs + g0 * q.gs;
  for (int i0 = threadIdx.x; i0 < n; i0 += kInflight * kThreads) {
    V buf[kInflight];
#pragma unroll
    for (int u = 0; u < kInflight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int cv = i / G, j = i - cv * G;
        buf[u] = *reinterpret_cast<const V*>(base + j * q.gs + kV * cv);
      }
    }
#pragma unroll
    for (int u = 0; u < kInflight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int cv = i / G, j = i - cv * G;
        float f[kV];
        Vec<T, kV>::unpack(buf[u], f);
        float* o = qT + (col0 + kV * cv) * Gp + j;
#pragma unroll
        for (int e = 0; e < kV; ++e) o[e * Gp] = f[e];
      }
    }
  }
}

// whether a segment can be read in four-element vectors: its width and
// strides are multiples of 4 and its base is aligned to 4 elements
template <typename T>
bool vec4_ok(const Seg<T>& s) {
  return s.width == 0 ||
         (s.width % 4 == 0 && s.bs % 4 == 0 && s.gs % 4 == 0 &&
          s.rs % 4 == 0 &&
          reinterpret_cast<uintptr_t>(s.ptr) % (4 * sizeof(T)) == 0);
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

// ---- pass 1: per (chunk, kv group, head block, sequence) partials ----
// A kv group's G query heads are taken Gb at a time (blockIdx.y = kv
// group * head blocks + head block), so that any G fits shared memory.
// q1/q2 are indexed by head h = g0 + j (j < Gh): ptr + b*bs + h*gs + e.
// kV: elements per global load (4, or 1 for widths not a multiple of 4).
template <typename T, int kV>
__global__ void __launch_bounds__(kThreads)
k_partial(Seg<T> q1, Seg<T> q2, Seg<T> k1, Seg<T> k2, Seg<T> v,
          const uint8_t* __restrict__ valid, int C, int G, int Gb, int rows,
          float scale, float softcap, float* __restrict__ part_m,
          float* __restrict__ part_l, float* __restrict__ part_acc) {
  extern __shared__ __align__(16) float sm[];
  // the merge may launch once every block of this grid runs
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int nsub = (G + Gb - 1) / Gb;
  const int chunk = blockIdx.x, kg = blockIdx.y / nsub, b = blockIdx.z;
  const int sub = blockIdx.y - kg * nsub;
  const int nch = gridDim.x, H = gridDim.y / nsub * G;
  const int g0 = kg * G + sub * Gb, Gh = min(Gb, G - sub * Gb);
  const int c0 = chunk * rows, len = min(rows, C - c0);
  const bool own_v = v.width > 0;
  const int D1 = k1.width, D2 = k2.width;
  const Layout L = layout(Gb, D1, D2, own_v ? v.width : D1, own_v, rows);
  float* qT = sm + L.q_off;
  float* kt = sm + L.k_off;
  float* vt = sm + L.v_off;
  float* pT = sm + L.p_off;

  // queries, transposed into qT[c][j] with vector loads in flight; the pad
  // heads' columns are zero
  for (int i = threadIdx.x; i < L.Dk * (L.Gp - Gh); i += kThreads) {
    const int c = i / (L.Gp - Gh);
    qT[c * L.Gp + Gh + (i - c * (L.Gp - Gh))] = 0.f;
  }
  load_queries<kV>(q1, b, g0, Gh, qT, L.Gp, 0);
  if (D2) load_queries<kV>(q2, b, g0, Gh, qT, L.Gp, D1);
  load_tile<kV>(k1, b, kg, c0, len, kt, L.ks, 0);
  if (D2) load_tile<kV>(k2, b, kg, c0, len, kt, L.ks, D1);
  if (own_v) load_tile<kV>(v, b, kg, c0, len, vt, L.Dv, 0);
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
  for (int j = warp; j < Gh; j += kThreads / 32) {
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
      if (j < Gh)
        part_acc[((static_cast<size_t>(b) * H + g0 + j) * nch + chunk) *
                     L.Dv + d] = a[u];
    }
  }
}

template <typename T>
int launch(Seg<T> q1, Seg<T> q2, Seg<T> k1, Seg<T> k2, Seg<T> v,
           const uint8_t* valid, int B, int groups, int G, int Gb, int C,
           int rows,
           float scale, float softcap, float* part_m, float* part_l,
           float* part_acc, T* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool own_v = v.width > 0;
  const int Dv = own_v ? v.width : k1.width;
  if (Gb < 1 || Gb > G || rows < 1) return cudaErrorInvalidValue;
  const Layout L = layout(Gb, k1.width, k2.width, Dv, own_v, rows);
  const size_t smem = sizeof(float) * static_cast<size_t>(L.total);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int nch = (C + rows - 1) / rows;
  auto run = [&](auto kernel) {
    cudaError_t e;
    if (smem > 48 * 1024 &&
        (e = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
      return e;
    kernel<<<dim3(nch, groups * ((G + Gb - 1) / Gb), B), kThreads, smem,
             st>>>(q1, q2, k1, k2, v, valid, C, G, Gb, rows, scale, softcap,
                   part_m, part_l, part_acc);
    return cudaGetLastError();
  };
  const bool vec = vec4_ok(q1) && vec4_ok(q2) && vec4_ok(k1) &&
                   vec4_ok(k2) && vec4_ok(v);
  cudaError_t e = vec ? run(k_partial<T, 4>) : run(k_partial<T, 1>);
  if (e != cudaSuccess) return e;
  return dec::launch_merge<T>(groups * G, B, nch, Dv, part_m, part_l,
                              part_acc, out, st);
}

template <typename T>
int gqa(const T* q, const T* k, const T* v, const uint8_t* valid, int B,
        int C, int H, int Hkv, int D, int heads, int rows, float scale,
        float softcap, float* part_m, float* part_l, float* part_acc, T* out,
        void* stream) {
  if (Hkv < 1 || H % Hkv) return cudaErrorInvalidValue;
  const long long kv_b = static_cast<long long>(C) * Hkv * D;
  const Seg<T> q1{q, static_cast<long long>(H) * D, D, 0, D};
  const Seg<T> none{nullptr, 0, 0, 0, 0};
  const Seg<T> k1{k, kv_b, D, static_cast<long long>(Hkv) * D, D};
  const Seg<T> v1{v, kv_b, D, static_cast<long long>(Hkv) * D, D};
  return launch<T>(q1, none, k1, none, v1, valid, B, Hkv, H / Hkv, heads, C,
                   rows, scale, softcap, part_m, part_l, part_acc, out,
                   stream);
}

template <typename T>
int mla(const T* q_abs, const T* q_rope, const T* ckv, const T* krope,
        const uint8_t* valid, int B, int C, int H, int R, int Dr, int heads,
        int rows, float scale, float* part_m, float* part_l, float* part_acc,
        T* out, void* stream) {
  const Seg<T> q1{q_abs, static_cast<long long>(H) * R, R, 0, R};
  const Seg<T> q2{q_rope, static_cast<long long>(H) * Dr, Dr, 0, Dr};
  const Seg<T> k1{ckv, static_cast<long long>(C) * R, 0, R, R};
  const Seg<T> k2{krope, static_cast<long long>(C) * Dr, 0, Dr, Dr};
  const Seg<T> none{nullptr, 0, 0, 0, 0};
  return launch<T>(q1, q2, k1, k2, none, valid, B, 1, H, heads, C, rows,
                   scale, 0.f, part_m, part_l, part_acc, out, stream);
}

// ---- GQA in bf16: split-KV over 64-row tiles, products on the tensor cores

namespace split {

using bf16 = __nv_bfloat16;
using dec::cp_async16;
using dec::cp_commit;
using dec::cp_wait;
using dec::ldsm_x4;
using dec::ldsm_x4_t;
using dec::minus_inf;
using dec::mma;
using dec::split_pair;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // cache rows per tile, 16 per warp
constexpr int kStages = 3;           // tiles in the cp.async ring
constexpr int kHeads = 16;           // mma's M: a kv head's query heads

struct Args {
  const bf16* q;              // (B, H, D)
  const bf16* k;              // (B, C, Hkv, D)
  const bf16* v;
  const uint8_t* valid;       // row c of sequence b at valid[b*mask_bs + c]
  long long mask_bs;
  int C, H, Hkv, G, tiles_per_split;
  float scale, softcap;
  float* part_m;              // [B][H][splits]
  float* part_l;
  float* part_acc;            // [B][H][splits][D]
};

// dynamic shared memory: q, the K and V rings, the tile list and flags
__host__ __device__ constexpr size_t smem_bytes(int D, int tiles) {
  return 2 * static_cast<size_t>(D + 8) * (kHeads + 2 * kStages * kRows) +
         5 * static_cast<size_t>(tiles);
}

template <int kD>
__global__ void __launch_bounds__(kThreads) k_gqa_split(const Args a) {
  constexpr int kS = kD + 8;     // row stride: an odd number of 16 B units
  constexpr int kTile = kRows * kS;
  constexpr int kChunks = kD / 8;            // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kHeads][kS]
  bf16* ks = qs + kHeads * kS;               // [kStages][kRows][kS]
  bf16* vs = ks + kStages * kTile;
  int* list = reinterpret_cast<int*>(vs + kStages * kTile);
  uint8_t* live = reinterpret_cast<uint8_t*>(list + a.tiles_per_split);
  __shared__ int n_live;

  // the merge may launch once every block of this grid runs
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int split = blockIdx.x, kg = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x, g0 = kg * a.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = split * a.tiles_per_split;
  const int nt = min(a.tiles_per_split, (a.C + kRows - 1) / kRows - t0);
  const uint8_t* vm = a.valid + b * a.mask_bs;

  // 1. the tiles of the range that hold a valid row, in order
  for (int i = warp; i < nt; i += kWarps) {
    const int r = (t0 + i) * kRows + 2 * lane;
    const bool any = (r < a.C && vm[r]) || (r + 1 < a.C && vm[r + 1]);
    const bool t = __any_sync(0xffffffffu, any);
    if (lane == 0) live[i] = t;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int i0 = 0; i0 < nt; i0 += 32) {
      const bool f = i0 + lane < nt && live[i0 + lane];
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) list[n + __popc(bal & ((1u << lane) - 1))] = t0 + i0 + lane;
      n += __popc(bal);
    }
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  int n = n_live;
  if (n == 0) {
    // no valid row here: an empty partial (weight 0 in the merge), unless
    // no row of the sequence is valid — then every row of the range counts
    // (the mean of v). The sequence's mask with 8 loads in flight a thread.
    int any = 0;
    for (int r0 = tid; r0 < a.C; r0 += 8 * kThreads) {
      uint8_t x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        x[u] = r0 + u * kThreads < a.C ? vm[r0 + u * kThreads] : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) any |= x[u];
    }
    if (__syncthreads_or(any)) {
      for (int i = tid; i < a.G * kD; i += kThreads) {
        const int j = i / kD;
        const size_t row =
            (static_cast<size_t>(b) * a.H + g0 + j) * nsplit + split;
        a.part_acc[row * kD + i - j * kD] = 0.f;
        if (i == j * kD) {
          a.part_m[row] = kNegInf;
          a.part_l[row] = 0.f;
        }
      }
      return;
    }
    for (int i = tid; i < nt; i += kThreads) list[i] = t0 + i;
    __syncthreads();
    n = nt;
  }

  // 2. the queries (rows G.. zero) join the first tile's copy group
  const bf16* qb = a.q + (static_cast<size_t>(b) * a.H + g0) * kD;
  for (int i = tid; i < kHeads * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool in = r < a.G;
    cp_async16(qs + r * kS + 8 * c, in ? qb + r * kD + 8 * c : a.q, in);
  }
  auto load = [&](int stage, int tile) {
    bf16* kd = ks + stage * kTile;
    bf16* vd = vs + stage * kTile;
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      const int row = tile * kRows + r;
      const bool in = row < a.C;
      const size_t off =
          ((static_cast<size_t>(b) * a.C + (in ? row : 0)) * a.Hkv + kg) *
              kD + 8 * c;
      cp_async16(kd + r * kS + 8 * c, a.k + off, in);
      cp_async16(vd + r * kS + 8 * c, a.v + off, in);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s, list[s]);
    cp_commit();
  }

  // 3. the walk: (m, l) of rows g and g + 8 of the heads, acc[j] holds
  //    columns 8j + 2t, +1
  const int g = lane >> 2, t4 = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, its row
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int i = 0; i < n; ++i) {
    cp_wait<kStages - 2>();
    __syncthreads();       // tile i is in; every warp is done with i - 1
    if (i + kStages - 1 < n)
      load((i + kStages - 1) % kStages, list[i + kStages - 1]);
    cp_commit();
    const int tile = list[i];
    const bf16* kt = ks + (i % kStages) * kTile + warp * 16 * kS;
    const bf16* vt = vs + (i % kStages) * kTile + warp * 16 * kS;

    // s = q . k^T over the warp's 16 rows, as two 8-row n-tiles
    float sc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldsm_x4(qa, qs + ((mat & 1) * 8 + mr) * kS + 16 * kk + (mat >> 1) * 8);
      ldsm_x4(kb, kt + ((mat >> 1) * 8 + mr) * kS + 16 * kk + (mat & 1) * 8);
      mma(sc[0], qa, kb[0], kb[1]);
      mma(sc[1], qa, kb[2], kb[3]);
    }
    // scale, cap and mask in f32; rows past C weigh exactly 0
    float mx[2] = {minus_inf(), minus_inf()};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = tile * kRows + warp * 16 + 8 * j + 2 * t4 + (e & 1);
        float s = sc[j][e] * a.scale;
        if (a.softcap > 0.f && g + 4 * (e & 2) < a.G)   // a real head
          s = a.softcap * tanhf(s / a.softcap);
        s = row >= a.C ? minus_inf() : (vm[row] ? s : kNegInf);
        sc[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);   // m >= -1e30: never inf - inf
      corr[h] = expf(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - m[e >> 1]);
        rs[e >> 1] += sc[j][e];
      }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    // p . v with f32 p = hi + lo: the score fragments are the A fragments
    uint32_t ph[4], pl[4];
    split_pair(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_pair(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_pair(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_pair(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int np = 0; np < kD / 16; ++np) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vt + ((mat & 1) * 8 + mr) * kS + 16 * np + (mat >> 1) * 8);
      mma(acc[2 * np], ph, vb[0], vb[1]);
      mma(acc[2 * np], pl, vb[0], vb[1]);
      mma(acc[2 * np + 1], ph, vb[2], vb[3]);
      mma(acc[2 * np + 1], pl, vb[2], vb[3]);
    }
  }

  // 4. merge the 4 warps in shared memory (the ring is free), in warp order
  cp_wait<0>();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  constexpr int kA = kD + 8;                 // acc row stride, in floats
  float* wm = reinterpret_cast<float*>(ks);  // [kWarps][kHeads]
  float* wl = wm + kWarps * kHeads;
  float* wa = wl + kWarps * kHeads;          // [kWarps][kHeads][kA]
  const int r0 = warp * kHeads + g;
  if (t4 == 0) {
    wm[r0] = m[0];
    wm[r0 + 8] = m[1];
    wl[r0] = l[0];
    wl[r0 + 8] = l[1];
  }
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    *reinterpret_cast<float2*>(wa + r0 * kA + 8 * j + 2 * t4) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(wa + (r0 + 8) * kA + 8 * j + 2 * t4) =
        make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  for (int i = tid; i < a.G * kD; i += kThreads) {
    const int j = i / kD, d = i - j * kD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kHeads + j]);
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(wm[w * kHeads + j] - M);
      A += wa[(w * kHeads + j) * kA + d] * e;
      L += wl[w * kHeads + j] * e;
    }
    const size_t row =
        (static_cast<size_t>(b) * a.H + g0 + j) * nsplit + split;
    a.part_acc[row * kD + d] = A;
    if (d == 0) {
      a.part_m[row] = M;
      a.part_l[row] = L;
    }
  }
}

template <int kD>
int launch(const Args& a, int B, int splits, bf16* out, cudaStream_t st) {
  const size_t smem = smem_bytes(kD, a.tiles_per_split);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(k_gqa_split<kD>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return e;
  k_gqa_split<kD><<<dim3(splits, a.Hkv, B), kThreads, smem, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return dec::launch_merge<bf16>(a.H, B, splits, kD, a.part_m, a.part_l,
                                a.part_acc, out, st);
}

int gqa(const Args& a, int B, int D, int splits, bf16* out, void* stream) {
  const int ntiles = (a.C + kRows - 1) / kRows;
  if (a.C < 1 || a.G < 1 || a.G > kHeads || a.H != a.Hkv * a.G ||
      splits < 1 || a.tiles_per_split < 1 ||
      static_cast<long long>(splits) * a.tiles_per_split < ntiles ||
      (splits - 1) * a.tiles_per_split >= ntiles)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define GQA_SPLIT_CASE(d) \
  case d:                 \
    return launch<d>(a, B, splits, out, st);
    GQA_SPLIT_CASE(16) GQA_SPLIT_CASE(32) GQA_SPLIT_CASE(48)
    GQA_SPLIT_CASE(64) GQA_SPLIT_CASE(80) GQA_SPLIT_CASE(96)
    GQA_SPLIT_CASE(112) GQA_SPLIT_CASE(128) GQA_SPLIT_CASE(144)
    GQA_SPLIT_CASE(160) GQA_SPLIT_CASE(176) GQA_SPLIT_CASE(192)
    GQA_SPLIT_CASE(208) GQA_SPLIT_CASE(224) GQA_SPLIT_CASE(240)
    GQA_SPLIT_CASE(256)
#undef GQA_SPLIT_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace split

}  // namespace

// GQA: k_partial in f32, and in bf16 for the shapes k_gqa_split does not
// take; k_gqa_split in bf16; MLA: k_partial
#define GQA_ENTRY(SUFFIX, T)                                                 \
  extern "C" int gqa_decode_##SUFFIX(                                         \
      const T* q, const T* k, const T* v, const uint8_t* valid, int B, int C, \
      int H, int Hkv, int D, int heads, int rows, float scale, float softcap, \
      float* part_m, float* part_l, float* part_acc, T* out, void* stream) {  \
    return gqa<T>(q, k, v, valid, B, C, H, Hkv, D, heads, rows, scale,       \
                  softcap, part_m, part_l, part_acc, out, stream);            \
  }

GQA_ENTRY(f32, float)
GQA_ENTRY(bf16, __nv_bfloat16)

extern "C" int gqa_split_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, const uint8_t* valid,
                              long long mask_bs, int B, int C, int H, int Hkv,
                              int D, int splits, int tiles_per_split,
                              float scale, float softcap, float* part_m,
                              float* part_l, float* part_acc,
                              __nv_bfloat16* out, void* stream) {
  if (Hkv < 1 || H % Hkv) return cudaErrorInvalidValue;
  const split::Args a{q,     k,       v,      valid,  mask_bs,        C,
                      H,     Hkv,     H / Hkv, tiles_per_split, scale, softcap,
                      part_m, part_l, part_acc};
  return split::gqa(a, B, D, splits, out, stream);
}

#define MLA_ENTRY(SUFFIX, T)                                                 \
  extern "C" int mla_decode_##SUFFIX(                                         \
      const T* q_abs, const T* q_rope, const T* ckv, const T* krope,          \
      const uint8_t* valid, int B, int C, int H, int R, int Dr, int heads,    \
      int rows, float scale, float* part_m, float* part_l, float* part_acc,   \
      T* out, void* stream) {                                                 \
    return mla<T>(q_abs, q_rope, ckv, krope, valid, B, C, H, R, Dr, heads,   \
                  rows, scale, part_m, part_l, part_acc, out, stream);        \
  }

MLA_ENTRY(f32, float)
MLA_ENTRY(bf16, __nv_bfloat16)
