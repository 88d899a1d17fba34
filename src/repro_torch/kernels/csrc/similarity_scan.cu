// Dense cosine scan for Hopper (sm_90a): the (S, Q, N) cosine scores of
// every query of a group against its session's index rows, plus the
// softmax statistics m = max and l = sum-exp of the masked logits s / tau
// per (session, query).
//
// Replaces: src/repro/kernels/similarity.py::similarity_scan_stack
// (_sim_stack_kernel, lines 181-269), a TPU Pallas kernel. Contract: the
// plain version repro_torch/kernels/ref.py::similarity_scan_stack_ref. Two
// choices differ from the Pallas kernel on purpose: N is not padded, so an
// all-invalid session gives m = -1e30, l = N (probs 1/N, as the jnp
// oracle's softmax); and m, l come from the same per-256-row partials and
// fixed-order merge as the fused scan (scan_tile.cuh), so the dense path's
// probabilities are the fused path's bits.
//
// What bounds it on an H100: bytes. The index rows must be read and the
// scores written; at S=16, Q=8, N=8192, d=768 that is 402.7 MB of f32
// rows (100.7 MB in int8) plus 4.2 MB of scores against 3.35 TB/s, about
// 0.12 ms (0.03 ms). The arithmetic, 2*S*Q*N*d ~ 1.6 GFLOP, is far below
// the fp32 line.
//
// Design. k_scan, one block per (256-row chunk, session, group of 8
// queries; scan::score_chunk): each row is read once for all 8 queries —
// masked rows too, since every lane's cosine is returned — each warp
// streaming its own rows through its own cp.async ring and scoring 4 rows
// x 8 queries at a time, in the fused scan's order (the same score bits),
// the scores leaving straight from registers. k_stats, under PDL, one
// block per (session, query): each chunk's (m, l) over the masked scores,
// read back from L2, then their merge in chunk order (scan::slab_partials,
// scan::merged_stats_warp, as the fused scan takes them). For a group of
// at most 8 queries per session (the smoke shape) each row is read once;
// larger groups re-read a chunk's rows once per 8 queries, mostly from
// L2. Any d and any index base, as the fused scan (scan::scan_stages).
// The C entry points return cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tile.cuh"

namespace {

using scan::kBlk;
using scan::kQG;
using scan::kThreads;

// ---- 1. the scores of every row ----
template <typename T, int kV, int kStages>
__global__ void __launch_bounds__(kThreads, 2) k_scan(const scan::Scan a) {
  extern __shared__ __align__(16) unsigned char smem[];
  scan::pdl_wait();
  scan::pdl_launch_dependents();
  if constexpr (kV == 16) {         // int8 rows on the tensor cores
    scan::score_chunk_mma<false>(a, smem);
  } else {
    float* qs = reinterpret_cast<float*>(smem);
    scan::score_chunk<T, kV, kStages, false>(
        a, qs, reinterpret_cast<unsigned char*>(qs + kQG * scan::padded(a.d)));
  }
}

// ---- 2. m and l of each (session, query) ----
// Plain pointers: it runs under PDL.
struct Stats {
  float* sims;             // (S, Q, N)
  uint8_t* valid;          // (S, N)
  float* part_m;           // (S, Q, nch)
  float* part_l;
  float* m;                // (S, Q)
  float* l;
  int Q, N, nch;
  float tau;
};

__global__ void __launch_bounds__(kThreads) k_stats(const Stats a) {
  scan::pdl_wait();
  scan::pdl_launch_dependents();
  const size_t row = static_cast<size_t>(blockIdx.y) * a.Q + blockIdx.x;
  float x[scan::kPer][scan::kLanes];
  for (int k0 = 0; k0 < a.nch; k0 += scan::kSlab) {
    scan::slab_scores(a.sims + row * a.N,
                      a.valid + static_cast<size_t>(blockIdx.y) * a.N, a.N,
                      k0, x);
    scan::slab_partials(x, a.N, k0, a.tau, a.part_m + row * a.nch,
                        a.part_l + row * a.nch);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float M, L;
    scan::merged_stats_warp(a.part_m, a.part_l, row, a.nch, M, L);
    if (threadIdx.x == 0) {
      a.m[row] = M;
      a.l[row] = L;
    }
  }
}

template <typename T>
int launch(const float* query, const T* index, const uint8_t* valid, int S,
           int Q, int N, int d, float tau, float* part_m, float* part_l,
           float* sims, float* m, float* l, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const scan::Scan a{query, index, valid, sims, S, Q, N, d};
  const bool aligned = reinterpret_cast<uintptr_t>(index) % 16 == 0;
  const bool mma = scan::mma_ok(d, sizeof(T), aligned);
  const int stages = scan::scan_stages(d, sizeof(T), aligned);
  const size_t smem =
      mma ? scan::mma_smem(d) : scan::scan_smem(d, sizeof(T), stages);
  if (smem > scan::kMaxSmem || S < 1 || Q < 1 || N < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((N + kBlk - 1) / kBlk, S, (Q + kQG - 1) / kQG);
  cudaError_t e = cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 1)
    if (mma) e = scan::launch_pdl(k_scan<T, 16, 0>, grid, smem, st, a);
  if (!mma)
    e = stages == 3 ? scan::launch_pdl(k_scan<T, 4, 3>, grid, smem, st, a)
      : stages == 2 ? scan::launch_pdl(k_scan<T, 4, 2>, grid, smem, st, a)
      : scan::vec4_ok(index, d)
          ? scan::launch_pdl(k_scan<T, 4, 0>, grid, smem, st, a)
          : scan::launch_pdl(k_scan<T, 1, 0>, grid, smem, st, a);
  if (e != cudaSuccess) return e;
  const Stats f{sims, const_cast<uint8_t*>(valid), part_m, part_l, m, l, Q,
                N, (N + kBlk - 1) / kBlk, tau};
  return scan::launch_pdl(k_stats, dim3(Q, S), scan::kStatsReserve, st, f);
}

}  // namespace

#define SCAN_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const float* query, const T* index,                     \
                      const uint8_t* valid,                                   \
                      int S, int Q, int N, int d, float tau, float* part_m,  \
                      float* part_l, float* sims, float* m, float* l,         \
                      void* stream) {                                         \
    return launch<T>(query, index, valid, S, Q, N, d, tau, part_m, part_l,    \
                     sims, m, l, stream);                                     \
  }

SCAN_ENTRY(similarity_scan_f32, float)
SCAN_ENTRY(similarity_scan_i8, int8_t)
