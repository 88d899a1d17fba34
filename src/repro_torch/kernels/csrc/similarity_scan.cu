// Dense cosine scan for Hopper (sm_90a): the (S, Q, N) cosine scores of
// every query of a group against its session's index rows, plus the
// softmax statistics m = max and l = sum-exp of the masked logits s / tau
// per (session, query).
//
// Replaces: src/repro/kernels/similarity.py::similarity_scan_stack
// (_sim_stack_kernel, lines 181-269) and its 2-D form similarity_scan
// (_sim_kernel, lines 90-173), both TPU Pallas kernels. Contract: the
// plain versions repro_torch/kernels/ref.py::similarity_scan_stack_ref
// and similarity_scan_ref. Two choices differ from the Pallas kernel on
// purpose: N is not padded, so an all-invalid session gives m = -1e30,
// l = N (probs 1/N, as the jnp oracle's softmax); and m, l come from the
// same per-256-row partials and fixed-order merge as the fused scan
// (scan_tile.cuh), so the dense path's probabilities are the fused
// path's bits.
//
// What bounds it on an H100: bytes. The index rows must be read and the
// scores written; at S=16, Q=8, N=8192, d=768 that is 402.7 MB of f32
// rows (100.7 MB in int8) plus 4.2 MB of scores against 3.35 TB/s, about
// 0.12 ms (0.03 ms). The arithmetic, 2*S*Q*N*d ~ 1.6 GFLOP, is far below
// the fp32 line.
//
// Design. One block per (256-row chunk, session, group of 8 queries)
// reads each of its rows once for all 8 queries (scan::tile_scores: rows
// normalised in register, so int8 scales cancel), writes the chunk's
// scores with coalesced stores, and writes per-chunk (m, l) partials;
// a second, small kernel merges the partials of each (session, query) in
// chunk order. For a group of at most 8 queries per session (the smoke
// shape) each row is read once; larger groups re-read a chunk's rows
// once per 8 queries, mostly from L2. No tensor cores yet.
// The C entry points return cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tile.cuh"

namespace {

using scan::kBlk;
using scan::kQG;
using scan::kThreads;

// ---- pass 1: scores of the tile, and its (m, l) partials ----
template <typename T>
__global__ void __launch_bounds__(kThreads)
k_scan(const float* __restrict__ qn, const T* __restrict__ index,
       const uint8_t* __restrict__ valid, int Q, int N, int d, int Qp,
       int nch, float tau, float* __restrict__ sims,
       float* __restrict__ part_m, float* __restrict__ part_l) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* sv = qs + kQG * d;        // raw scores, then masked scores
  const int chunk = blockIdx.x, s = blockIdx.y, q0 = blockIdx.z * kQG;
  const int c0 = chunk * kBlk, len = min(kBlk, N - c0);
  const int nq = min(kQG, Q - q0);
  const uint8_t* vs = valid + static_cast<size_t>(s) * N;
  scan::load_queries(qn, qs, Q, d, s, q0);
  __syncthreads();
  scan::tile_scores<false>(index + static_cast<size_t>(s) * N * d, vs, qs,
                           sv, d, c0, len);
  __syncthreads();
  // the raw scores of every lane leave the block, row by row
  for (int qi = 0; qi < nq; ++qi) {
    float* out = sims + (static_cast<size_t>(s) * Q + q0 + qi) * N + c0;
    for (int i = threadIdx.x; i < len; i += kThreads)
      out[i] = sv[qi * kBlk + i];
  }
  __syncthreads();
  // then the statistics see masked lanes as -1e30, as the fused scan's do
  for (int i = threadIdx.x; i < kQG * len; i += kThreads) {
    const int qi = i / len, c = i - qi * len;
    if (vs[c0 + c] == 0) sv[qi * kBlk + c] = scan::kNegInf;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, qi = threadIdx.x >> 5;
  float m, l;
  scan::tile_stats(sv, len, tau, m, l);
  if (lane == 0) {
    const size_t row = static_cast<size_t>(s) * Qp + q0 + qi;
    part_m[row * nch + chunk] = m;
    part_l[row * nch + chunk] = l;
  }
}

// ---- pass 2: m and l of each (session, query), merged in chunk order ----
__global__ void k_fold(int S, int Q, int Qp, int nch,
                       const float* __restrict__ part_m,
                       const float* __restrict__ part_l,
                       float* __restrict__ m_out, float* __restrict__ l_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * Q) return;
  const int s = i / Q, q = i - s * Q;
  float M, L;
  scan::merged_stats(part_m, part_l, static_cast<size_t>(s) * Qp + q, nch,
                     M, L);
  m_out[i] = M;
  l_out[i] = L;
}

template <typename T>
int launch(const float* qn, const T* index, const uint8_t* valid, int S,
           int Q, int N, int d, float tau, float* part_m, float* part_l,
           float* sims, float* m, float* l, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (Q + kQG - 1) / kQG;
  const int nch = (N + kBlk - 1) / kBlk;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kQG) * d +
                                       static_cast<size_t>(kQG) * kBlk);
  cudaError_t e;
  if ((e = scan::allow_smem(k_scan<T>, smem)) != cudaSuccess) return e;
  k_scan<T><<<dim3(nch, S, groups), kThreads, smem, st>>>(
      qn, index, valid, Q, N, d, groups * kQG, nch, tau, sims, part_m,
      part_l);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k_fold<<<(S * Q + 127) / 128, 128, 0, st>>>(S, Q, groups * kQG, nch,
                                              part_m, part_l, m, l);
  return cudaGetLastError();
}

}  // namespace

#define SCAN_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const float* qn, const T* index, const uint8_t* valid, \
                      int S, int Q, int N, int d, float tau, float* part_m,  \
                      float* part_l, float* sims, float* m, float* l,         \
                      void* stream) {                                         \
    return launch<T>(qn, index, valid, S, Q, N, d, tau, part_m, part_l,      \
                     sims, m, l, stream);                                     \
  }

SCAN_ENTRY(similarity_scan_f32, float)
SCAN_ENTRY(similarity_scan_i8, int8_t)
