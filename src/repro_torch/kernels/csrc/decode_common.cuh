// Shared building blocks of the decode-attention kernels
// (decode_attention.cu: k_partial, k_gqa_split; mla_decode.cu: k_mla):
// 16-byte cp.async copies, ldmatrix (plain and .trans), the bf16
// mma.m16n8k16 with f32 sums, the split of an f32 pair into bf16 hi + lo,
// and k_merge, the second pass that merges per-split (or per-chunk)
// softmax partials in order, launched under PDL.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dec {

using bf16 = __nv_bfloat16;
constexpr int kMergeThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ void store_as(float x, float* o) { *o = x; }
__device__ __forceinline__ void store_as(float x, bf16* o) {
  *o = __float2bfloat16(x);
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

__device__ __forceinline__ float minus_inf() {
  return __uint_as_float(0xff800000u);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared without waiting; zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and gets (row i / 4, columns 2 (i % 4) and 2 (i % 4) + 1) of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8) += a (16x16, row major) . b (16x8, column major); bf16 in, f32
// sums. Lane (g = lane / 4, t = lane % 4) holds c at rows g, g + 8 and
// columns 2t, 2t + 1.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as two bf16 pairs, hi + lo = (x, y) to a relative 2^-17
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---- the second pass: merge the partials of each (head, sequence) ----
// Partials of row = sequence * gridDim.x + head, part k of nch: m, l at
// [row * nch + k], acc at [(row * nch + k) * Dv + d]. Each thread takes M =
// max m, L = sum l e^(m - M) and acc = sum acc e^(m - M) over the parts in
// order itself (the parts' m and l are the same few addresses for the
// whole block), and writes acc / max(L, 1e-30) — the same result from run
// to run. The m, l and the sums of the thread's first two columns of the
// first kPre parts are loaded at once, before any of them is used, so the
// merge waits for one round trip to memory, not three. kDependent:
// launched as a programmatic dependent of the kernel that writes the
// partials, so its launch overlaps that kernel; it waits here for that
// grid's end. The partials are not __restrict__: that would let their
// loads be read-only (non-coherent) ones, which may be moved above the
// wait while the kernel before is still writing them.
template <typename T, bool kDependent>
__global__ void __launch_bounds__(kMergeThreads)
k_merge(int nch, int Dv, const float* part_m, const float* part_l,
        const float* part_acc, T* out) {
  constexpr int kPre = 32;
  if (kDependent) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t row = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const float* pm = part_m + row * nch;
  const float* pl = part_l + row * nch;
  const float* pa = part_acc + row * nch * Dv;
  const int d0 = threadIdx.x, d1 = d0 + kMergeThreads;
  float m[kPre], l[kPre], x0[kPre], x1[kPre];
#pragma unroll
  for (int c = 0; c < kPre; ++c) {       // parts past nch weigh nothing
    const bool in = c < nch;
    m[c] = in ? pm[c] : kNegInf;
    l[c] = in ? pl[c] : 0.f;
    x0[c] = in && d0 < Dv ? pa[static_cast<size_t>(c) * Dv + d0] : 0.f;
    x1[c] = in && d1 < Dv ? pa[static_cast<size_t>(c) * Dv + d1] : 0.f;
  }
  float M = kNegInf;
#pragma unroll
  for (int c = 0; c < kPre; ++c) M = fmaxf(M, m[c]);
  for (int c = kPre; c < nch; ++c) M = fmaxf(M, pm[c]);
  float L = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int c = 0; c < kPre; ++c) {
    const float w = expf(m[c] - M);
    L += l[c] * w;
    a0 += x0[c] * w;
    a1 += x1[c] * w;
  }
  for (int c = kPre; c < nch; ++c) {
    const float w = expf(pm[c] - M);
    L += pl[c] * w;
    if (d0 < Dv) a0 += pa[static_cast<size_t>(c) * Dv + d0] * w;
    if (d1 < Dv) a1 += pa[static_cast<size_t>(c) * Dv + d1] * w;
  }
  const float denom = fmaxf(L, 1e-30f);
  T* o = out + row * Dv;
  if (d0 < Dv) store_as(a0 / denom, o + d0);
  if (d1 < Dv) store_as(a1 / denom, o + d1);
  for (int d = d1 + kMergeThreads; d < Dv; d += kMergeThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int c = 0; c < nch; ++c)
      a += pa[static_cast<size_t>(c) * Dv + d] * expf(pm[c] - M);
    store_as(a / denom, o + d);
  }
}

// k_merge over (heads, sequences) as a programmatic dependent of the
// kernel just launched on st (which must execute
// griddepcontrol.launch_dependents, or the launch waits for its end)
template <typename T>
cudaError_t launch_merge(int heads, int B, int nch, int Dv,
                         const float* part_m, const float* part_l,
                         const float* part_acc, T* out, cudaStream_t st) {
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads, B);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, k_merge<T, true>, nch, Dv, part_m,
                                     part_l, part_acc, out);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace dec
