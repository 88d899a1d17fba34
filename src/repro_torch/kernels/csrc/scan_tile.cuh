// Shared building blocks of the cosine-scan kernels (fused_retrieve.cu,
// similarity_scan.cu): the 256-row x 8-query tile that reads each index
// row once for all 8 queries, the per-tile softmax statistics and their
// fixed-order merge. Both kernels compute scores and statistics through
// these same functions, so a dense scan and a fused scan of the same
// inputs give the same score, m and l bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr int kBlk = 256;         // rows per tile == DRAW_BLK
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQG = 8;            // queries per tile (== kWarps)
constexpr int kRows = 4;          // rows per warp step
constexpr float kNegInf = -1e30f;

static_assert(kQG == kWarps, "one warp per query in the epilogues");

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int8_t> { using type = char4; };

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Load the tile's (up to) 8 unit queries of session s into shared memory
// (zeros for padding queries).
__device__ __forceinline__ void load_queries(const float* __restrict__ qn,
                                             float* qs, int Q, int d, int s,
                                             int q0) {
  for (int i = threadIdx.x; i < kQG * d; i += kThreads) {
    const int qi = i / d, c = i - qi * d;
    qs[i] = (q0 + qi < Q)
                ? qn[(static_cast<size_t>(s) * Q + q0 + qi) * d + c]
                : 0.f;
  }
}

// Cosine scores of the tile's rows for its 8 queries, rows L2-normalised
// in register (rsqrt(sum x^2 + 1e-12), so int8 scales cancel):
// sv[qi * kBlk + i] = cos for i < len. With kMask, rows whose valid byte
// is 0 get -1e30 instead.
template <bool kMask, typename T>
__device__ void tile_scores(const T* __restrict__ xs,
                            const uint8_t* __restrict__ vs,
                            const float* qs, float* sv, int d, int c0,
                            int len) {
  using V = typename Vec4<T>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d4 = d >> 2;
  const float4* qv = reinterpret_cast<const float4*>(qs);
  for (int base = warp * kRows; base < len; base += kWarps * kRows) {
    float acc[kRows][kQG];
    float ss[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ss[r] = 0.f;
#pragma unroll
      for (int qi = 0; qi < kQG; ++qi) acc[r][qi] = 0.f;
    }
    const V* rv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = c0 + min(base + r, len - 1);   // clamp: no OOB read
      rv[r] = reinterpret_cast<const V*>(xs + static_cast<size_t>(row) * d);
    }
    for (int v = lane; v < d4; v += 32) {
      float4 x[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        V e = __ldg(rv[r] + v);
        x[r] = make_float4(static_cast<float>(e.x), static_cast<float>(e.y),
                           static_cast<float>(e.z), static_cast<float>(e.w));
        ss[r] += x[r].x * x[r].x + x[r].y * x[r].y + x[r].z * x[r].z +
                 x[r].w * x[r].w;
      }
#pragma unroll
      for (int qi = 0; qi < kQG; ++qi) {
        const float4 q = qv[qi * d4 + v];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r][qi] += q.x * x[r].x + q.y * x[r].y + q.z * x[r].z +
                        q.w * x[r].w;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ss[r] = warp_sum(ss[r]);
#pragma unroll
      for (int qi = 0; qi < kQG; ++qi) acc[r][qi] = warp_sum(acc[r][qi]);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = base + r;
        if (i < len) {
          const bool ok = !kMask || vs[c0 + i] != 0;
          const float rs = rsqrtf(ss[r] + 1e-12f);
#pragma unroll
          for (int qi = 0; qi < kQG; ++qi)
            sv[qi * kBlk + i] = ok ? acc[r][qi] * rs : kNegInf;
        }
      }
    }
  }
}

// The logit of a masked score: s / tau, or -1e30 for a masked lane.
__device__ __forceinline__ float logit_of(float sv, float tau) {
  return sv > -1e29f ? sv / tau : kNegInf;
}

// Max logit and sum-exp of one tile row for warp qi over len lanes of
// masked scores (lane-strided, then a warp reduction): the per-chunk
// partials every scan kernel writes.
__device__ __forceinline__ void tile_stats(const float* sv, int len,
                                           float tau, float& m, float& l) {
  const int lane = threadIdx.x & 31, qi = threadIdx.x >> 5;
  m = kNegInf;
  for (int i = lane; i < len; i += 32)
    m = fmaxf(m, logit_of(sv[qi * kBlk + i], tau));
  m = warp_max(m);
  l = 0.f;
  for (int i = lane; i < len; i += 32)
    l += expf(logit_of(sv[qi * kBlk + i], tau) - m);
  l = warp_sum(l);
}

// M and L of one (session, query) lane, merged from the per-chunk
// partials in chunk order — every caller gets the same bits.
__device__ __forceinline__ void merged_stats(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    size_t row, int nch, float& M, float& L) {
  M = kNegInf;
  for (int k = 0; k < nch; ++k) M = fmaxf(M, part_m[row * nch + k]);
  L = 0.f;
  for (int k = 0; k < nch; ++k)
    L += part_l[row * nch + k] * expf(part_m[row * nch + k] - M);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace scan
