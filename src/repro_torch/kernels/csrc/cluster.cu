// Incremental clustering of one scene partition (paper §IV-B2) for Hopper
// (sm_90a): the partition's T frame vectors (T, d) f32, in order. The first
// frame seeds cluster 0; each later frame joins the nearest running-mean
// centroid if its L2 distance sqrt(sum((mean - v)^2) + 1e-12) is within the
// threshold, else seeds a new cluster; past K clusters it joins the nearest
// regardless. A cluster's index frame is its member nearest its final
// centroid (first minimum).
//
// Replaces: no pallas_call. The reference clusters with a lax.scan
// (src/repro/core/clustering.py::cluster_partition), which the port ran as
// a host loop of about 25 tensor ops a frame. Contract: the plain version
// repro_torch/kernels/ref.py::cluster_partition_ref. Kept from it: the mean
// is sum / max(count, 1) by IEEE division (the port builds without fast
// math), the threshold compares in f32, the argmin takes the first minimum
// (NaN as the least, as torch.argmin does), and the overflow rule
// make_new = (!near_ok && n < K) || n == 0. Only the order of the f32 sum
// over d differs.
//
// What bounds it on an H100: the serial chain of T steps, one block-wide
// reduction of K distances each, not bytes (T * d * 4 = 0.57 MB for 61
// frames of 2,352 is 0.17 us at 3.35 TB/s).
//
// Design. One block walks the frames in order. Dimension j of every
// cluster belongs to thread j % threads for the whole loop, so the running
// means (route smem: in shared memory; route global: in the
// centroid output, where L2 holds them) and sums (device memory, one row
// read and written a frame) need no barrier of their own. A frame's step:
// (1) the next frame's elements are staged by the same owners with 4-byte
// cp.async into a 2-frame ring (route smem; route global reads the frame
// from device memory); (2) each thread sums (mean - v)^2 of its dimensions
// for up to kChunk clusters in registers, its warp adds them by shuffles
// and writes one partial a cluster to shared memory; (3) one barrier; (4)
// every warp adds the partials of every warp in the same order and takes
// the same argmin by shuffles, so all threads reach the same decision with
// no second barrier (the partials are double-buffered by the parity of the
// reduction); (5) the owners update the chosen row's sums and mean, and
// lane 0 of each warp its warp's copy of the counts. More than kChunk
// clusters take one reduction a chunk of kChunk. After the loop each warp
// takes frames in turn, computes its squared distance to its cluster's
// centroid, and an atomicMin on (distance bits, frame) a cluster gives the
// first nearest member. Outputs: the centroids and counts (rows past n
// zero) and one int32 buffer [n, assignments (T), index frames (K)], which
// the host reads back once. The kernel is a programmatic dependent (PDL):
// it waits on the grid before it (griddepcontrol.wait) before it touches
// device memory. The C entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;              // clusters a block reduction, at most
constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmem = 227 * 1024;

struct Cluster {
  const float* vecs;           // (T, d)
  int T, d, K;
  float thr;
  float* cent;                 // (K, d) out; route global: the running means
  float* counts;               // (K,) out
  float* sums;                 // (K, d) scratch
  float* wcnt;                 // (warps, K) scratch, route global
  unsigned long long* keys;    // (K,) scratch, route global
  int* out;                    // (1 + T + K,) out: n, assignments, index frames
};

// a block's shared memory: the partials, double-buffered ([2][warps][kChunk]
// floats), and on chip also the means (K * d), the frame ring (2 * d), each
// warp's counts (warps * K) and the index frames' keys (K, 8-byte aligned)
__host__ __device__ inline size_t part_floats(int threads) {
  return static_cast<size_t>(2) * (threads / 32) * kChunk;
}

__host__ __device__ inline size_t smem_bytes(int d, int K, int threads,
                                             bool on_chip) {
  size_t b = 4 * part_floats(threads);
  if (!on_chip) return b;
  b += 4 * (static_cast<size_t>(K) * d + 2 * static_cast<size_t>(d) +
            static_cast<size_t>(threads / 32) * K);
  return (b + 7) / 8 * 8 + 8 * static_cast<size_t>(K);
}

__device__ __forceinline__ void stage(float* dst, const float* src, int d) {
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + j));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src + j)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest has landed (this thread's copies)
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// sum_j (mean[c0 + kk][j] - v[j])^2 over this thread's dimensions for kk <
// nk <= KB, added over the warp; lane kk writes cluster c0 + kk's partial
template <int KB>
__device__ __forceinline__ void distances(const float* means, const float* v,
                                          int d, int c0, int nk, float* dst) {
  float acc[KB];
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) acc[kk] = 0.f;
  const float* m0 = means + static_cast<size_t>(c0) * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float x = v[j];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      if (kk < nk) {
        const float df = m0[static_cast<size_t>(kk) * d + j] - x;
        acc[kk] = fmaf(df, df, acc[kk]);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < KB; ++kk)
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc[kk] += __shfl_xor_sync(0xffffffffu, acc[kk], off);
  const int lane = threadIdx.x & 31;
  float mine = acc[0];
#pragma unroll
  for (int kk = 1; kk < KB; ++kk)
    if (lane == kk) mine = acc[kk];
  if (lane < KB) dst[lane] = mine;
}

// a distance's order: NaN least, as torch.argmin takes it, then by value
// (non-negative floats order as their bits); a masked lane is last
__device__ __forceinline__ unsigned order_key(float dist) {
  return isnan(dist) ? 0u : __float_as_uint(dist) + 1u;
}

template <bool kOnChip>
__global__ void __launch_bounds__(kMaxThreads) k_cluster(const Cluster a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int T = a.T, d = a.d, K = a.K;
  float* part = reinterpret_cast<float*>(smem);
  float* means = a.cent;
  float* ring = nullptr;
  float* wcnt = a.wcnt;
  unsigned long long* keys = a.keys;
  if constexpr (kOnChip) {
    means = part + part_floats(blockDim.x);
    ring = means + static_cast<size_t>(K) * d;
    wcnt = ring + 2 * static_cast<size_t>(d);
    const size_t kofs =
        (smem_bytes(d, K, blockDim.x, true) - 8 * static_cast<size_t>(K));
    keys = reinterpret_cast<unsigned long long*>(smem + kofs);
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int k = threadIdx.x; k < K; k += blockDim.x) keys[k] = ~0ull;
  if constexpr (kOnChip) stage(ring, a.vecs, d);

  int n = 0;         // clusters so far: the same in every thread
  int step = 0;      // block reductions so far: the partials' parity
  for (int i = 0; i < T; ++i) {
    const float* v = a.vecs + static_cast<size_t>(i) * d;
    if constexpr (kOnChip) {
      if (i + 1 < T)
        stage(ring + static_cast<size_t>((i + 1) & 1) * d, v + d, d);
      else
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      wait_staged();
      v = ring + static_cast<size_t>(i & 1) * d;
    }
    unsigned best = 0xffffffffu;
    int bestk = 0;
    for (int c0 = 0; c0 < n; c0 += kChunk, ++step) {
      const int nk = min(kChunk, n - c0);
      float* pp = part + static_cast<size_t>(step & 1) * nw * kChunk;
      if (nk <= 4)
        distances<4>(means, v, d, c0, nk, pp + warp * kChunk);
      else if (nk <= 8)
        distances<8>(means, v, d, c0, nk, pp + warp * kChunk);
      else
        distances<kChunk>(means, v, d, c0, nk, pp + warp * kChunk);
      __syncthreads();
      // every warp: lane kk adds cluster c0 + kk's partials in warp order
      unsigned key = 0xffffffffu;
      int kidx = c0 + lane;
      if (lane < nk) {
        float s = 0.f;
        for (int w = 0; w < nw; ++w) s += pp[w * kChunk + lane];
        key = order_key(sqrtf(s + 1e-12f));
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const unsigned ok = __shfl_xor_sync(0xffffffffu, key, off);
        const int oi = __shfl_xor_sync(0xffffffffu, kidx, off);
        if (ok < key || (ok == key && oi < kidx)) {
          key = ok;
          kidx = oi;
        }
      }
      if (key < best) {          // an earlier chunk keeps a tie
        best = key;
        bestk = kidx;
      }
    }
    const bool near_ok =
        n > 0 && best != 0u && __uint_as_float(best - 1u) <= a.thr;
    const bool make_new = (!near_ok && n < K) || n == 0;
    const int cid = make_new ? n : bestk;
    float* wc = wcnt + static_cast<size_t>(warp) * K + cid;
    const float cnt = make_new ? 1.f : *wc + 1.f;
    __syncwarp();
    if (lane == 0) *wc = cnt;
    float* srow = a.sums + static_cast<size_t>(cid) * d;
    float* mrow = means + static_cast<size_t>(cid) * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      const float s = make_new ? __fadd_rn(0.f, v[j]) : srow[j] + v[j];
      srow[j] = s;
      mrow[j] = s / cnt;
    }
    if (threadIdx.x == 0) a.out[1 + i] = cid;
    n += make_new;
  }
  __syncthreads();                 // every owner's last mean is written

  // index frames: each warp takes frames in turn
  for (int t = warp; t < T; t += nw) {
    const int c = a.out[1 + t];
    const float* x = a.vecs + static_cast<size_t>(t) * d;
    const float* m = means + static_cast<size_t>(c) * d;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float df = x[j] - m[j];
      s = fmaf(df, df, s);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0)
      atomicMin(&keys[c], (static_cast<unsigned long long>(__float_as_uint(s))
                           << 32) | static_cast<unsigned>(t));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    a.out[1 + T + k] = k < n ? static_cast<int>(keys[k] & 0xffffffffull) : 0;
    a.counts[k] = k < n ? wcnt[k] : 0.f;          // warp 0's counts
  }
  if (threadIdx.x == 0) a.out[0] = n;
  for (int k = 0; k < K; ++k) {
    float* crow = a.cent + static_cast<size_t>(k) * d;
    const float* mrow = means + static_cast<size_t>(k) * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x)
      crow[j] = k < n ? mrow[j] : 0.f;
  }
}

}  // namespace

// a block's shared memory in bytes, against which the host's mirror
// (cluster.cluster_smem_bytes) is checked
extern "C" long long cluster_smem_bytes(int d, int K, int threads,
                                        int on_chip) {
  return static_cast<long long>(smem_bytes(d, K, threads, on_chip != 0));
}

// vecs: (T, d) f32. threads: a multiple of 32 in [32, 1024]. on_chip: the
// means, frame ring, counts and keys in shared memory (smem_bytes at most
// 227 KB); else wcnt (warps * K floats) and keys (K 8-byte words) are
// device scratch and the means live in cent. sums: (K, d) scratch.
extern "C" int cluster_f32(const float* vecs, int T, int d, int K, float thr,
                           int threads, int on_chip, float* cent,
                           float* counts, float* sums, float* wcnt,
                           void* keys, int* out, void* stream) {
  const size_t smem = smem_bytes(d, K, threads, on_chip != 0);
  if (T < 1 || d < 1 || K < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || smem > kMaxSmem ||
      (!on_chip && (wcnt == nullptr || keys == nullptr)) ||
      reinterpret_cast<uintptr_t>(keys) % 8 != 0)
    return cudaErrorInvalidValue;
  const Cluster a{vecs, T, d, K, thr, cent, counts, sums, wcnt,
                  static_cast<unsigned long long*>(keys), out};
  void (*kernel)(Cluster) = on_chip ? k_cluster<true> : k_cluster<false>;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return e;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, kernel, a)) != cudaSuccess) return e;
  return cudaGetLastError();
}
