// Shared building blocks of the cosine-scan kernels (fused_retrieve.cu,
// similarity_scan.cu, similarity_scan_2d.cu): the pass that scores the
// rows of a session stack for groups of 8 queries (score_chunk), the
// per-chunk softmax statistics and their fixed-order merge. The stack and
// fused kernels score rows and take statistics through these same
// functions, so a dense scan and a fused scan of the same inputs give the
// same score, m and l bits; the 2-D kernel takes its statistics the same
// way.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr int kBlk = 256;         // rows per chunk == DRAW_BLK
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQG = 8;            // queries per block
constexpr int kRows = 4;          // rows a warp scores at once (a group)
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 227 * 1024;   // a block's shared memory

static_assert(kQG == kWarps, "one warp per query in the epilogues");
static_assert(kRows * kQG == 32, "a group's sums spread one per lane");

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int8_t> { using type = char4; };

// d rounded up to a multiple of 4: the row stride of the staged queries
__host__ __device__ constexpr int padded(int d) { return (d + 3) & ~3; }

// Whether rows of d elements from base can be read in 4-element vectors:
// d % 4 == 0 and the base aligned to one vector (16 bytes of f32, 4 of
// int8). Else the rows are read one element at a time.
template <typename T>
bool vec4_ok(const T* base, int d) {
  return d % 4 == 0 &&
         reinterpret_cast<uintptr_t>(base) % (4 * sizeof(T)) == 0;
}

// Shared memory of a score_chunk block: the 8 queries at a row stride of
// padded(d) in f32, then, where the rows are staged, each warp's ring of
// `stages` groups of kRows rows.
inline size_t scan_smem(int d, int elt, int stages) {
  return sizeof(float) * kQG * static_cast<size_t>(padded(d)) +
         static_cast<size_t>(stages) * kWarps * kRows * d * elt;
}

// Ring stages of the pass over rows of d elements of elt bytes: 3 where
// they fit a block's shared memory, else 2, else 0 (rows read from
// device memory straight into registers). Staging needs every row to
// start on 16 bytes: the index base aligned, d * elt a multiple of 16.
inline int scan_stages(int d, int elt, bool aligned) {
  if (!aligned || (static_cast<size_t>(d) * elt) % 16 != 0) return 0;
  for (int st = 3; st >= 2; --st)
    if (scan_smem(d, elt, st) <= kMaxSmem) return st;
  return 0;
}

// int8 rows on the tensor cores (score_chunk_mma): the queries as f16
// fragments, two terms each, scaled by 2^10 before the split.
constexpr int kTile = 16;       // rows of an mma tile
constexpr int kQScale = 1024;

// Shared memory of a score_chunk_mma block: the queries' fragments (two
// terms, d / 16 column blocks, 8 bytes a lane) and their 8 scales.
inline size_t mma_smem(int d) {
  return static_cast<size_t>(2) * (d / 16) * 32 * 8 + sizeof(float) * kQG;
}

// Whether int8 rows of d elements from a base aligned (or not) to 16
// bytes take the tensor cores: d a multiple of 64 (a lane loads 16 bytes
// of each 64 columns), the base aligned, mma_smem within a block's.
inline bool mma_ok(int d, int elt, bool aligned) {
  return elt == 1 && aligned && d % 64 == 0 && mma_smem(d) <= kMaxSmem;
}

__device__ __forceinline__ float4 as_f4(float4 v) { return v; }
// Four int8 as floats, exactly: each byte, offset by 128, as the low bits
// of 2^23 (one byte permute), less 2^23 + 128 — fewer issue slots than
// four integer-to-float conversions, whose pipe runs at a quarter rate.
__device__ __forceinline__ float4 as_f4(char4 v) {
  const unsigned w = *reinterpret_cast<const unsigned*>(&v) ^ 0x80808080u;
  const float o = 8388736.f;                  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440)) - o,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7441)) - o,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7442)) - o,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7443)) - o);
}

// Elements 4v .. 4v+3 of a row as floats: one vector load (kV = 4), or
// four element loads with the columns at or past d read as 0 (kV = 1).
// Both give the same four floats, so the sums over them have the same
// order on both paths. Plain loads: a kernel launched under PDL must not
// read ahead of its griddepcontrol.wait.
template <int kV, typename T>
__device__ __forceinline__ float4 load4(const T* row, int v, int d) {
  if constexpr (kV == 4) {
    return as_f4(reinterpret_cast<const typename Vec4<T>::type*>(row)[v]);
  } else {
    const int c = 4 * v;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = c + e < d ? static_cast<float>(row[c + e]) : 0.f;
    return make_float4(x[0], x[1], x[2], x[3]);
  }
}

// acc + a . b as four chained fused multiply-adds
__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sums each of N values (a power of two) over the warp and spreads the
// totals over the lanes: lane L ends with values L * N/32 .. (L+1) * N/32
// - 1 in v[0 .. N/32) where N >= 32, else with value L / (32/N) in v[0].
// Every value takes warp_sum's tree (xor 16, 8, 4, 2, 1, own value first),
// so the same bits, in N - 1 shuffles (N >= 32) instead of 5 N.
template <int N, int kOff = 16>
__device__ __forceinline__ void warp_sum_spread(float (&v)[N]) {
  if constexpr (kOff > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool hi = (threadIdx.x & kOff) != 0;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = hi ? v[j] : v[j + H];
        const float keep = hi ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
      }
      warp_sum_spread<H, kOff / 2>(reinterpret_cast<float(&)[H]>(v));
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], kOff);
      warp_sum_spread<1, kOff / 2>(v);
    }
  }
}

// The cosine of kRows rows against the 8 queries in qs (unit vectors at a
// row stride of padded(d), normalised as score_chunk does): lane L returns
// the score of row L / 8 for
// query L % 8. Each lane sums its columns (float4 blocks lane, lane + 32,
// ...) in a chain of fused multiply-adds, the row's sum of squares the
// same way; warp_sum_spread adds the lanes (32 sums in 31 shuffles, the 4
// sums of squares in 6); the row is scaled by rsqrt(sum x^2 + 1e-12), so
// int8 scales cancel. Every kernel that scores rows takes this order.
template <int kV, typename T>
__device__ __forceinline__ float group_scores(const T* const (&rows)[kRows],
                                              const float* qs, int d) {
  const int lane = threadIdx.x & 31, d4 = padded(d) >> 2;
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  float acc[kRows * kQG] = {};       // [row][query]
  float ss[kRows] = {};
#pragma unroll 2
  for (int v = lane; v < d4; v += 32) {
    float4 e[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      e[r] = load4<kV>(rows[r], v, d);
      ss[r] = fma4(e[r], e[r], ss[r]);
    }
#pragma unroll
    for (int qi = 0; qi < kQG; ++qi) {
      const float4 q = q4[qi * d4 + v];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r * kQG + qi] = fma4(q, e[r], acc[r * kQG + qi]);
    }
  }
  warp_sum_spread(acc);
  warp_sum_spread(ss);
  return acc[0] * rsqrtf(ss[0] + 1e-12f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared without waiting; bytes < 16 zero-fill the
// rest (the "memory" clobbers keep the compiler from moving shared-memory
// reads across a ring's steps)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// A stacked scan's operands. Plain pointers throughout: the kernels run
// under PDL, and read-only (const __restrict__) operands may be loaded
// ahead of griddepcontrol.wait.
struct Scan {
  const float* query;      // (S, Q, d) f32, as given
  const void* index;       // (S, N, d) f32 or int8
  const uint8_t* valid;    // (S, N)
  float* scores;           // (S, Q, N): every row's (stack) or the valid
                           // rows' (fused) cosines
  int S, Q, N, d;
};

// The cosines of chunk blockIdx.x (kBlk rows) of session blockIdx.y for
// queries 8 blockIdx.z .. + 7, straight from registers into a.scores.
// Warp w scores rows [32 w, 32 w + 32) of the chunk, kRows at a time.
// kSkip (the fused scan): a masked row is never read and its score never
// written, and a chunk with no valid row reads nothing but its mask;
// else every row is scored. kStages > 0: each warp streams its own rows
// through its own ring of kStages groups by 16-byte cp.async copies, so
// warps never wait on each other; kStages == 0: rows straight from device
// memory, kV elements a load (a masked row's load goes to a valid row of
// its group, which the caches hold).
template <typename T, int kV, int kStages, bool kSkip>
__device__ __forceinline__ void score_chunk(const Scan& a, float* qs,
                                            unsigned char* ring) {
  constexpr int kWarpRows = kBlk / kWarps;     // 32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.y, q0 = blockIdx.z * kQG;
  const int c0 = blockIdx.x * kBlk, len = min(kBlk, a.N - c0);
  const int nq = min(kQG, a.Q - q0), dq = padded(a.d);
  const bool on = tid < len &&
                  (!kSkip || a.valid[static_cast<size_t>(s) * a.N + c0 +
                                     tid] != 0);
  // bit j: row 32 warp + j of the chunk is scored
  const unsigned mask = __ballot_sync(0xffffffffu, on);
  if (kSkip && !__syncthreads_or(on)) return;
  const T* xs = static_cast<const T*>(a.index) +
                (static_cast<size_t>(s) * a.N + c0 + kWarpRows * warp) * a.d;
  const size_t rowb = static_cast<size_t>(a.d) * sizeof(T);
  const int ng = (max(0, min(kWarpRows, len - kWarpRows * warp)) + kRows -
                  1) / kRows;
  unsigned char* wring =
      ring + static_cast<size_t>(warp) * kStages * kRows * rowb;
  auto slot = [&](int g) {
    return wring + (g % (kStages > 0 ? kStages : 1)) * kRows * rowb;
  };
  // group g's scored rows → its ring slot, a row per rowb
  auto copy = [&](int g) {
    unsigned char* dst = slot(g);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (mask >> (kRows * g + r) & 1u) {
        const char* src = reinterpret_cast<const char*>(
            xs + static_cast<size_t>(kRows * g + r) * a.d);
        for (int c = lane; c < static_cast<int>(rowb / 16); c += 32)
          cp_async16(dst + r * rowb + 16 * c, src + 16 * c);
      }
  };
  if constexpr (kStages > 0) {
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < ng) copy(st);
      cp_commit();
    }
  }
  // the queries, while the first groups are in flight (zeros past d and
  // past the session's queries), then scaled by rsqrt(sum q^2 + 1e-12),
  // a warp a query
  for (int i = tid; i < kQG * dq; i += kThreads) {
    const int k = i / dq, c = i - k * dq;
    qs[i] = (k < nq && c < a.d)
                ? a.query[(static_cast<size_t>(s) * a.Q + q0 + k) * a.d + c]
                : 0.f;
  }
  __syncthreads();
  {
    float* q = qs + warp * dq;
    float ss = 0.f;
    for (int c = lane; c < dq; c += 32) ss = fmaf(q[c], q[c], ss);
    const float inv = rsqrtf(warp_sum(ss) + 1e-12f);
    for (int c = lane; c < dq; c += 32) q[c] *= inv;
  }
  __syncthreads();
  const int r = lane >> 3, qi = lane & 7;   // the lane's sum after spreading
  float* out = a.scores + (static_cast<size_t>(s) * a.Q + q0 + qi) * a.N +
               c0 + kWarpRows * warp + r;
  for (int g = 0; g < ng; ++g) {
    if constexpr (kStages > 0) {
      cp_wait<kStages - 2>();
      __syncwarp();    // group g is in; every lane is done with g - 1
      if (g + kStages - 1 < ng) copy(g + kStages - 1);
      cp_commit();
    }
    const unsigned gm = mask >> (kRows * g) & ((1u << kRows) - 1);
    if (gm == 0) continue;               // the warp's whole group is off
    const T* rows[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      if constexpr (kStages > 0)
        rows[rr] = reinterpret_cast<const T*>(slot(g) + rr * rowb);
      else
        rows[rr] = xs + static_cast<size_t>(
                            kRows * g + (gm >> rr & 1u ? rr : __ffs(gm) - 1)) *
                            a.d;
    }
    const float sc = group_scores<kV>(rows, qs, a.d);
    if ((gm >> r & 1u) && qi < nq) out[kRows * g] = sc;
  }
}

// acc += a . b on the tensor cores: m16n8k16, f16 operands, f32 sums
__device__ __forceinline__ void mma_f16(float (&c)[4], unsigned a0,
                                        unsigned a1, unsigned a2, unsigned a3,
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two int8 of a word (bytes sel's) as an f16 pair, exactly: each byte,
// offset by 128, as the low bits of 1024 (one byte permute), less 1152.
__device__ __forceinline__ unsigned i8x2_f16x2(unsigned w, unsigned sel) {
  const unsigned h = __byte_perm(w ^ 0x80808080u, 0x64646464u, sel);
  const __half2 v = __hsub2(*reinterpret_cast<const __half2*>(&h),
                            __floats2half2_rn(1152.f, 1152.f));
  return *reinterpret_cast<const unsigned*>(&v);
}

// score_chunk for int8 rows on the tensor cores (mma_ok): warp w scores
// rows [32 w, 32 w + 32) of the chunk as two tiles of 16 rows x 8
// queries, mma.sync m16n8k16 with f16 operands and f32 sums. A row's int8
// values are exact in f16; each unit query, scaled by 2^10, is split into
// two f16 terms (hi + lo: 22 bits), so every product is exact and a sum
// carries f32 rounding only; the sums are scaled back by 2^-10, exactly.
// Rows go from device memory straight into the fragments: lane (g, t) =
// (lane / 4, lane % 4) loads 16 bytes of rows g and g + 8 from each block
// of 64 columns (columns 16 t .. 16 t + 15, four lanes a row: 64 bytes
// together), which serve as its 4 columns of each of the block's four
// 16-column mma steps; the queries' fragments take the same columns, so
// the k order is permuted alike on both sides. A masked row (kSkip) is
// never loaded and its score never written. Row norms are exact integer
// sums (dp4a).
template <bool kSkip>
__device__ __forceinline__ void score_chunk_mma(const Scan& a,
                                                unsigned char* smem) {
  constexpr int kWarpRows = kBlk / kWarps;     // 32: two tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.y, q0 = blockIdx.z * kQG;
  const int c0 = blockIdx.x * kBlk, len = min(kBlk, a.N - c0);
  const int nq = min(kQG, a.Q - q0), d = a.d, ks = d / 16;
  const bool on = tid < len &&
                  (!kSkip || a.valid[static_cast<size_t>(s) * a.N + c0 +
                                     tid] != 0);
  const unsigned mask = __ballot_sync(0xffffffffu, on);
  if (kSkip && !__syncthreads_or(on)) return;
  uint2* frag = reinterpret_cast<uint2*>(smem);   // [2][ks][32]
  float* qinv = reinterpret_cast<float*>(frag + 2 * ks * 32);
  // the queries' fragments: each query's norm by a warp, then lane L =
  // (g, t) of 16-column step b = 4 B + k holds query g's columns
  // 64 B + 16 t + 4 k .. + 3, scaled by 2^10 / norm, as an f16 hi term and
  // the f16 rest
  const float* qg = a.query + (static_cast<size_t>(s) * a.Q + q0) * d;
  {
    float ss = 0.f;
    if (warp < nq)
      for (int c = lane; c < d; c += 32)
        ss = fmaf(qg[warp * d + c], qg[warp * d + c], ss);
    ss = warp_sum(ss);
    if (lane == 0) qinv[warp] = kQScale * rsqrtf(ss + 1e-12f);
  }
  __syncthreads();
  for (int e = tid; e < ks * 32; e += kThreads) {
    const int b = e >> 5, g = (e & 31) >> 2, t = e & 3;
    unsigned hi[2] = {0u, 0u}, lo[2] = {0u, 0u};
    if (g < nq) {
      const float* q = qg + g * d + 64 * (b >> 2) + 16 * t + 4 * (b & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x0 = q[2 * h] * qinv[g], x1 = q[2 * h + 1] * qinv[g];
        const __half2 hh = __floats2half2_rn(x0, x1);
        const __half2 ll = __floats2half2_rn(x0 - __low2float(hh),
                                             x1 - __high2float(hh));
        hi[h] = *reinterpret_cast<const unsigned*>(&hh);
        lo[h] = *reinterpret_cast<const unsigned*>(&ll);
      }
    }
    frag[e] = make_uint2(hi[0], hi[1]);
    frag[ks * 32 + e] = make_uint2(lo[0], lo[1]);
  }
  __syncthreads();
  const int g = lane >> 2, t = lane & 3;
  const int8_t* xs = static_cast<const int8_t*>(a.index) +
                     (static_cast<size_t>(s) * a.N + c0 + kWarpRows * warp) *
                         d;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const unsigned tm = mask >> (kTile * j) & 0xffffu;
    if (tm == 0) continue;                 // the warp's whole tile is off
    const bool v0 = tm >> g & 1u, v8 = tm >> (g + 8) & 1u;
    const uint4* r0 = reinterpret_cast<const uint4*>(
                          xs + static_cast<size_t>(kTile * j + g) * d) + t;
    const uint4* r8 = r0 + 8 * d / 16;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    int ss0 = 0, ss8 = 0;
#pragma unroll 4
    for (int B = 0; B < d / 64; ++B) {
      const uint4 x0 = v0 ? r0[4 * B] : make_uint4(0u, 0u, 0u, 0u);
      const uint4 x8 = v8 ? r8[4 * B] : make_uint4(0u, 0u, 0u, 0u);
      const unsigned w0[4] = {x0.x, x0.y, x0.z, x0.w};
      const unsigned w8[4] = {x8.x, x8.y, x8.z, x8.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ss0 = __dp4a(static_cast<int>(w0[k]), static_cast<int>(w0[k]), ss0);
        ss8 = __dp4a(static_cast<int>(w8[k]), static_cast<int>(w8[k]), ss8);
        const unsigned a0 = i8x2_f16x2(w0[k], 0x4140);
        const unsigned a2 = i8x2_f16x2(w0[k], 0x4342);
        const unsigned a1 = i8x2_f16x2(w8[k], 0x4140);
        const unsigned a3 = i8x2_f16x2(w8[k], 0x4342);
        const uint2 bh = frag[(4 * B + k) * 32 + lane];
        const uint2 bl = frag[(ks + 4 * B + k) * 32 + lane];
        mma_f16(c, a0, a1, a2, a3, bh.x, bh.y);
        mma_f16(c, a0, a1, a2, a3, bl.x, bl.y);
      }
    }
    // a row's sum of squares over its 4 lanes: exact integers
    ss0 += __shfl_xor_sync(0xffffffffu, ss0, 1);
    ss0 += __shfl_xor_sync(0xffffffffu, ss0, 2);
    ss8 += __shfl_xor_sync(0xffffffffu, ss8, 1);
    ss8 += __shfl_xor_sync(0xffffffffu, ss8, 2);
    const float inv[2] = {rsqrtf(static_cast<float>(ss0) + 1e-12f),
                          rsqrtf(static_cast<float>(ss8) + 1e-12f)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = g + 8 * (e >> 1), qi = 2 * t + (e & 1);
      if ((tm >> rr & 1u) && qi < nq)
        a.scores[(static_cast<size_t>(s) * a.Q + q0 + qi) * a.N + c0 +
                 kWarpRows * warp + kTile * j + rr] =
            c[e] * (1.f / kQScale) * inv[e >> 1];
    }
  }
}

// The logit of a masked score: s / tau, or -1e30 for a masked lane.
__device__ __forceinline__ float logit_of(float sv, float tau) {
  return sv > -1e29f ? sv / tau : kNegInf;
}

// Max logit and sum-exp of one warp's len <= kBlk lanes of masked scores
// (lane-strided, then a warp reduction): the per-chunk partials every scan
// kernel writes, in one order. score(u) is the masked score of lane
// (threadIdx.x % 32) + 32 u; a lane reads its kBlk / 32 scores first.
template <typename F>
__device__ __forceinline__ void row_stats(F score, int len, float tau,
                                          float& m, float& l) {
  constexpr int kPer = kBlk / 32;
  const int lane = threadIdx.x & 31;
  float x[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    x[u] = lane + 32 * u < len ? logit_of(score(u), tau) : 0.f;
  m = kNegInf;
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (lane + 32 * u < len) m = fmaxf(m, x[u]);
  m = warp_max(m);
  l = 0.f;
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (lane + 32 * u < len) l += expf(x[u] - m);
  l = warp_sum(l);
}

// A row's scores a slab at a time in the statistics kernels, one block
// per (session, query): a slab is kSlab chunks, warp w holds chunks
// w, w + kWarps, ... of it, lane L lanes L, L + 32, ... of each.
constexpr int kSlab = 32;
constexpr int kPer = kSlab / kWarps;     // a warp's chunks of a slab
constexpr int kLanes = kBlk / 32;        // a lane's lanes of a chunk
// What a statistics block reserves of shared memory: more than half an
// SM's, so that the blocks placed early under PDL, while the score pass
// still runs, take an SM each instead of crowding onto the few it leaves
// free.
constexpr size_t kStatsReserve = 120 * 1024;

// This thread's masked scores of slab k0 of a row: x[c][u] is lane
// (k0 + warp + kWarps c) kBlk + lane + 32 u: sc there where its valid byte
// is set, else -1e30; -inf past the row (absent, not masked). Both loads
// go out together (sc is read even where it is not written).
__device__ __forceinline__ void slab_scores(const float* sc,
                                            const uint8_t* vs, int N, int k0,
                                            float (&x)[kPer][kLanes]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kPer; ++c)
#pragma unroll
    for (int u = 0; u < kLanes; ++u) {
      const int i = (k0 + warp + kWarps * c) * kBlk + lane + 32 * u;
      if (i < N) {
        const float v = sc[i];
        x[c][u] = vs[i] ? v : kNegInf;
      } else {
        x[c][u] = -INFINITY;
      }
    }
}

// Each chunk's (m, l) of slab k0 from slab_scores' x, in row_stats' lane
// order, into pm[j], pl[j] (j the chunk of the row).
__device__ __forceinline__ void slab_partials(const float (&x)[kPer][kLanes],
                                              int N, int k0, float tau,
                                              float* pm, float* pl) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {   // unrolled: the chunks interleave
    const int j = k0 + warp + kWarps * c;
    if (j * kBlk < N) {
      const int len = min(kBlk, N - j * kBlk);
      bool off = true;
#pragma unroll
      for (int u = 0; u < kLanes; ++u) off = off && !(x[c][u] > kNegInf);
      float m = kNegInf, l = static_cast<float>(len);
      // a chunk with no valid lane: row_stats' own bits (every logit
      // -1e30, each exp(0) = 1), without its arithmetic
      if (!__all_sync(0xffffffffu, off))
        row_stats([&](int u) { return x[c][u]; }, len, tau, m, l);
      if ((threadIdx.x & 31) == 0) {
        pm[j] = m;
        pl[j] = l;
      }
    }
  }
}

// M and L of one (session, query) lane, merged from the per-chunk
// partials in chunk order — every caller gets the same bits: M the max,
// L the chain L = fma(l_k, exp(m_k - M), L) over k = 0, 1, .... Plain
// pointers: PDL dependents call it.
__device__ __forceinline__ void merged_stats(const float* part_m,
                                             const float* part_l, size_t row,
                                             int nch, float& M, float& L) {
  M = kNegInf;
#pragma unroll 8
  for (int k = 0; k < nch; ++k) M = fmaxf(M, part_m[row * nch + k]);
  L = 0.f;
#pragma unroll 8
  for (int k = 0; k < nch; ++k)
    L = fmaf(part_l[row * nch + k], expf(part_m[row * nch + k] - M), L);
}

// merged_stats by a whole warp, its bits: the loads and exponentials
// spread over the lanes, the chain in chunk order on every lane from
// shuffled terms; every lane returns M and L.
__device__ __forceinline__ void merged_stats_warp(const float* part_m,
                                                  const float* part_l,
                                                  size_t row, int nch,
                                                  float& M, float& L) {
  const int lane = threadIdx.x & 31;
  const float* pm = part_m + row * nch;
  const float* pl = part_l + row * nch;
  M = kNegInf;
  for (int k = lane; k < nch; k += 32) M = fmaxf(M, pm[k]);
  M = warp_max(M);
  L = 0.f;
  for (int k0 = 0; k0 < nch; k0 += 32) {
    const int k = k0 + lane;
    const float w = k < nch ? pl[k] : 0.f;
    const float e = k < nch ? expf(pm[k] - M) : 0.f;
    const int n = min(32, nch - k0);
#pragma unroll 8
    for (int j = 0; j < n; ++j)
      L = fmaf(__shfl_sync(0xffffffffu, w, j),
               __shfl_sync(0xffffffffu, e, j), L);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// `kernel` on `grid` as a programmatic dependent of the kernel before it
// on the stream (Hopper's PDL): it is placed while that kernel runs and
// must read nothing before its griddepcontrol.wait.
template <typename K, typename A>
cudaError_t launch_pdl(K kernel, dim3 grid, size_t smem, cudaStream_t st,
                       const A& args, int threads = kThreads) {
  cudaError_t e;
  if ((e = allow_smem(kernel, smem)) != cudaSuccess) return e;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, kernel, args)) != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace scan
