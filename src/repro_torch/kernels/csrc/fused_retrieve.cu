// Fused retrieval scan for Hopper (sm_90a): one launch answers a whole
// execution group — softmax statistics, inverse-CDF draw counts, the
// crossing-lane probability of every draw, the top-K and p_last — with no
// (S, Q, N) score tensor ever written to device memory.
//
// Replaces: src/repro/kernels/similarity.py::fused_retrieve_scan_stack
// (_fused_stack_kernel, the TPU Pallas kernel). Contract: the plain
// version repro_torch/kernels/ref.py::fused_retrieve_stack_ref.
//
// What bounds it on an H100: bytes. Each session's N x d index rows (f32
// or int8) must be read; at S=16, N=8192, d=768 that is 402.7 MB in f32
// (100.7 MB in int8) against 3.35 TB/s, ~0.12 ms (~0.03 ms). The
// arithmetic, 2*S*Q*N*d ~ 1.6 GFLOP, is far below the fp32 line.
//
// Design. The TPU kernel walks one session's blocks in order and carries
// the softmax stats, the CDF carry and the top-K in scratch; on a GPU the
// blocks of one session run in parallel, so the walk becomes four short
// kernels over (chunk, session, query-group) tiles of DRAW_BLK = 256 rows
// x 8 queries. A tile reads its rows once for all 8 queries (the index
// is the only large operand), 4 rows per warp step so each query vector
// loaded from shared memory serves 4 rows:
//   1. stats:  per tile and query, the max logit and sum-exp (partials);
//   2. chunk:  p = exp(logit - M) / max(L, 1e-30) with M, L merged from
//              the partials in a fixed order; the chunk's in-chunk
//              prefix sum (total) and its top-K;
//   3. fold:   per (session, query), the chunk offsets (a sequential
//              left fold of the totals), the merged top-K, m and l;
//   4. draws:  p and the in-chunk prefix again (bit-identical to pass 2),
//              cdf = prefix + offset, then #{cdf <= t} per target (warp
//              ballots, shared then global integer atomics: exact sums
//              in any order), drawn_p at the unique crossing lane
//              (prev <= t < cdf) and p_last.
// The CDF order is the port's canonical one (draws.py): inside a chunk
// ONE thread walks the lanes sequentially in fp32, and the chunk offsets
// are a sequential fp32 fold, so the plain version reproduces it. Top-K
// order is (value desc, lane asc): ties go to the lowest lane and masked
// lanes carry -1e30, exactly lax.top_k over the masked scores. The index
// is read three times (passes 1, 2, 4); nothing O(S*Q*N) is stored.
// The tile scores, the per-chunk stats and their merge come from
// scan_tile.cuh, shared with the dense scan (similarity_scan.cu). Any d:
// the three passes that read the index take float4/char4 loads where
// scan::vec4_ok allows them, else one element a load, as the dense scan
// chooses, so both give the same m and l bits.
// The C entry points return cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tile.cuh"

namespace {

using scan::kBlk;
using scan::kNegInf;
using scan::kQG;
using scan::kThreads;
using scan::logit_of;
using scan::merged_stats;

// (value desc, lane asc): is (v, i) ahead of (w, j)?
__device__ __forceinline__ bool ahead(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(0xffffffffu, v, o);
    int j = __shfl_xor_sync(0xffffffffu, i, o);
    if (ahead(w, j, v, i)) {
      v = w;
      i = j;
    }
  }
}

struct Geometry {
  int S, Q, N, d, T, K, nch, Qp;
  float tau;
};

// The tile's masked scores: scan::tile_scores over session s's rows,
// kV index elements a load.
template <int kV, typename T>
__device__ __forceinline__ void masked_scores(
    const float* __restrict__ qn, const T* __restrict__ index,
    const uint8_t* __restrict__ valid, const Geometry& g, float* qs,
    float* sv, int s, int q0, int c0, int len) {
  scan::load_queries(qn, qs, g.Q, g.d, s, q0);
  __syncthreads();
  scan::tile_scores<true, kV>(index + static_cast<size_t>(s) * g.N * g.d,
                          valid + static_cast<size_t>(s) * g.N, qs, sv, g.d,
                          c0, len);
}

// ---- pass 1: per-chunk max / sum-exp partials ----
template <typename T, int kV>
__global__ void __launch_bounds__(kThreads)
k_stats(const float* __restrict__ qn, const T* __restrict__ index,
        const uint8_t* __restrict__ valid, Geometry g,
        float* __restrict__ part_m, float* __restrict__ part_l) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* sv = qs + kQG * scan::padded(g.d);
  const int chunk = blockIdx.x, s = blockIdx.y, q0 = blockIdx.z * kQG;
  const int c0 = chunk * kBlk, len = min(kBlk, g.N - c0);
  masked_scores<kV>(qn, index, valid, g, qs, sv, s, q0, c0, len);
  __syncthreads();
  const int lane = threadIdx.x & 31, qi = threadIdx.x >> 5;
  float m, l;
  scan::tile_stats(sv, len, g.tau, m, l);
  if (lane == 0) {
    const size_t row = static_cast<size_t>(s) * g.Qp + q0 + qi;
    part_m[row * g.nch + chunk] = m;
    part_l[row * g.nch + chunk] = l;
  }
}

// p of the tile for query qi (warp qi), into ps; returns nothing.
__device__ void tile_probs(const float* sv, float* ps, int len, float M,
                           float L, float tau) {
  const int lane = threadIdx.x & 31, qi = threadIdx.x >> 5;
  const float Ls = fmaxf(L, 1e-30f);
  for (int i = lane; i < len; i += 32)
    ps[qi * kBlk + i] = expf(logit_of(sv[qi * kBlk + i], tau) - M) / Ls;
}

// ---- pass 2: chunk totals (in-chunk prefix) and per-chunk top-K ----
template <typename T, int kV>
__global__ void __launch_bounds__(kThreads)
k_chunk(const float* __restrict__ qn, const T* __restrict__ index,
        const uint8_t* __restrict__ valid, Geometry g,
        const float* __restrict__ part_m, const float* __restrict__ part_l,
        float* __restrict__ totals, float* __restrict__ ptv,
        int* __restrict__ pti) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* sv = qs + kQG * scan::padded(g.d);
  float* ps = sv + kQG * kBlk;
  const int chunk = blockIdx.x, s = blockIdx.y, q0 = blockIdx.z * kQG;
  const int c0 = chunk * kBlk, len = min(kBlk, g.N - c0);
  masked_scores<kV>(qn, index, valid, g, qs, sv, s, q0, c0, len);
  __syncthreads();
  const int lane = threadIdx.x & 31, qi = threadIdx.x >> 5;
  const size_t row = static_cast<size_t>(s) * g.Qp + q0 + qi;
  float M, L;
  merged_stats(part_m, part_l, row, g.nch, M, L);
  tile_probs(sv, ps, len, M, L, g.tau);
  __syncwarp();
  if (lane == 0) {                 // the canonical in-chunk walk
    float cc = 0.f;
    for (int i = 0; i < len; ++i) cc += ps[qi * kBlk + i];
    totals[row * g.nch + chunk] = cc;
  }
  // the chunk's top-K: K rounds of a warp arg-best; lane owns i = lane+32j
  unsigned taken = 0;
  for (int k = 0; k < g.K; ++k) {
    float v = -INFINITY;
    int idx = 0x7fffffff;
    int own = -1;
    for (int j = 0; j < kBlk / 32; ++j) {
      const int i = lane + 32 * j;
      if (i < len && !(taken >> j & 1u) &&
          ahead(sv[qi * kBlk + i], c0 + i, v, idx)) {
        v = sv[qi * kBlk + i];
        idx = c0 + i;
        own = j;
      }
    }
    const int mine = idx;
    warp_best(v, idx);
    if (own >= 0 && mine == idx) taken |= 1u << own;
    if (lane == 0) {
      const size_t o = (row * g.nch + chunk) * g.K + k;
      ptv[o] = v;
      pti[o] = idx;
    }
  }
}

// ---- pass 3: chunk offsets, merged top-K, m and l per (s, q) ----
__global__ void k_fold(Geometry g, const float* __restrict__ part_m,
                       const float* __restrict__ part_l,
                       const float* __restrict__ totals,
                       const float* __restrict__ ptv,
                       int* __restrict__ pti, float* __restrict__ offs,
                       float* __restrict__ tv_out, int* __restrict__ ti_out,
                       float* __restrict__ m_out, float* __restrict__ l_out) {
  const int q = blockIdx.x, s = blockIdx.y, lane = threadIdx.x;
  const size_t row = static_cast<size_t>(s) * g.Qp + q;
  const size_t out = static_cast<size_t>(s) * g.Q + q;
  if (lane == 0) {
    float M, L;
    merged_stats(part_m, part_l, row, g.nch, M, L);
    m_out[out] = M;
    l_out[out] = L;
    float acc = 0.f;               // sequential left fold of the totals
    for (int k = 0; k < g.nch; ++k) {
      offs[row * g.nch + k] = acc;
      acc = acc + totals[row * g.nch + k];
    }
  }
  const int nc = g.nch * g.K;
  const float* cv = ptv + row * nc;
  int* ci = pti + row * nc;        // consumed candidates are set to -1
  for (int k = 0; k < g.K; ++k) {
    float v = -INFINITY;
    int idx = 0x7fffffff;
    int slot = -1;
    for (int c = lane; c < nc; c += 32) {
      if (ci[c] >= 0 && ahead(cv[c], ci[c], v, idx)) {
        v = cv[c];
        idx = ci[c];
        slot = c;
      }
    }
    const int mine = idx;
    warp_best(v, idx);
    __syncwarp();
    // consume the winner (its owner marks it, only the owner writes)
    if (slot >= 0 && mine == idx) ci[slot] = -1;
    __syncwarp();
    if (lane == 0) {
      tv_out[out * g.K + k] = v;
      ti_out[out * g.K + k] = idx;
    }
  }
}

// ---- pass 4: canonical CDF, draw counts, drawn_p, p_last ----
template <typename T, int kV>
__global__ void __launch_bounds__(kThreads)
k_draws(const float* __restrict__ qn, const T* __restrict__ index,
        const uint8_t* __restrict__ valid, const float* __restrict__ targets,
        Geometry g, const float* __restrict__ part_m,
        const float* __restrict__ part_l, const float* __restrict__ offs,
        int* __restrict__ cnt_out, float* __restrict__ dp_out,
        float* __restrict__ plast_out) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* sv = qs + kQG * scan::padded(g.d);      // scores, then the CDF
  float* ps = sv + kQG * kBlk;
  float* ts = ps + kQG * kBlk;     // kQG * T targets
  int* cnt = reinterpret_cast<int*>(ts + kQG * g.T);
  const int chunk = blockIdx.x, s = blockIdx.y, q0 = blockIdx.z * kQG;
  const int c0 = chunk * kBlk, len = min(kBlk, g.N - c0);
  const int nq = min(kQG, g.Q - q0);
  for (int i = threadIdx.x; i < kQG * g.T; i += kThreads) {
    const int qi = i / g.T, t = i - qi * g.T;
    ts[i] = qi < nq
                ? targets[(static_cast<size_t>(s) * g.Q + q0 + qi) * g.T + t]
                : 0.f;
    cnt[i] = 0;
  }
  masked_scores<kV>(qn, index, valid, g, qs, sv, s, q0, c0, len);
  __syncthreads();
  const int tid = threadIdx.x, lane = tid & 31, qi = tid >> 5;
  const size_t row = static_cast<size_t>(s) * g.Qp + q0 + qi;
  float M, L;
  merged_stats(part_m, part_l, row, g.nch, M, L);
  tile_probs(sv, ps, len, M, L, g.tau);
  __syncwarp();
  const float off = offs[row * g.nch + chunk];
  if (lane == 0) {                 // bit-identical to pass 2's walk
    float cc = 0.f;
    for (int i = 0; i < len; ++i) {
      cc += ps[qi * kBlk + i];
      sv[qi * kBlk + i] = cc + off;
    }
  }
  if (qi < nq && c0 <= g.N - 1 && g.N - 1 < c0 + len && lane == 0)
    plast_out[static_cast<size_t>(s) * g.Q + q0 + qi] =
        ps[qi * kBlk + (g.N - 1 - c0)];
  __syncthreads();
  const bool in = tid < len;
  for (int q = 0; q < nq; ++q) {
    const size_t qrow = static_cast<size_t>(s) * g.Qp + q0 + q;
    const float carry = offs[qrow * g.nch + chunk];
    const float cdf_i = in ? sv[q * kBlk + tid] : 0.f;
    const float prev = tid == 0 ? carry : (in ? sv[q * kBlk + tid - 1] : 0.f);
    const size_t orow = static_cast<size_t>(s) * g.Q + q0 + q;
    for (int t = 0; t < g.T; ++t) {
      const float tv = ts[q * g.T + t];
      const bool le = in && cdf_i <= tv;
      const unsigned b = __ballot_sync(0xffffffffu, le);
      if (lane == 0 && b) atomicAdd(&cnt[q * g.T + t], __popc(b));
      if (in && !le && prev <= tv)          // the unique crossing lane
        dp_out[orow * g.T + t] = ps[q * kBlk + tid];
    }
  }
  __syncthreads();
  for (int i = tid; i < nq * g.T; i += kThreads) {
    const int q = i / g.T, t = i - q * g.T;
    if (cnt[i])
      atomicAdd(&cnt_out[(static_cast<size_t>(s) * g.Q + q0 + q) * g.T + t],
                cnt[i]);
  }
}

size_t bytes_tile(int d, int nbuf, int T) {
  return sizeof(float) * (static_cast<size_t>(kQG) * scan::padded(d) +
                          static_cast<size_t>(nbuf) * kQG * kBlk +
                          static_cast<size_t>(kQG) * T) +
         sizeof(int) * static_cast<size_t>(kQG) * T;
}

template <typename T, int kV>
int launch_kv(const float* qn, const T* index, const uint8_t* valid,
              const float* targets, const Geometry& g, float* part_m,
              float* part_l, float* totals, float* offs, float* ptv,
              int* pti, int* cnt, float* dp, float* plast, float* tv,
              int* ti, float* m, float* l, cudaStream_t st) {
  const dim3 grid(g.nch, g.S, g.Qp / kQG);
  const size_t b1 = bytes_tile(g.d, 1, 0), b2 = bytes_tile(g.d, 2, 0),
               b4 = bytes_tile(g.d, 2, g.T);
  if (b4 > scan::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = scan::allow_smem(k_stats<T, kV>, b1)) != cudaSuccess) return e;
  if ((e = scan::allow_smem(k_chunk<T, kV>, b2)) != cudaSuccess) return e;
  if ((e = scan::allow_smem(k_draws<T, kV>, b4)) != cudaSuccess) return e;
  k_stats<T, kV><<<grid, kThreads, b1, st>>>(qn, index, valid, g, part_m,
                                              part_l);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k_chunk<T, kV><<<grid, kThreads, b2, st>>>(qn, index, valid, g, part_m,
                                              part_l, totals, ptv, pti);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k_fold<<<dim3(g.Q, g.S), 32, 0, st>>>(g, part_m, part_l, totals, ptv, pti,
                                         offs, tv, ti, m, l);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k_draws<T, kV><<<grid, kThreads, b4, st>>>(qn, index, valid, targets, g,
                                              part_m, part_l, offs, cnt, dp,
                                              plast);
  return cudaGetLastError();
}

template <typename T>
int launch(const float* qn, const T* index, const uint8_t* valid,
           const float* targets, int S, int Q, int N, int d, int nt, int K,
           float tau, float* part_m, float* part_l, float* totals,
           float* offs, float* ptv, int* pti, int* cnt, float* dp,
           float* plast, float* tv, int* ti, float* m, float* l,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (Q + kQG - 1) / kQG;
  const Geometry g{S, Q, N, d, nt, K, (N + kBlk - 1) / kBlk, groups * kQG,
                   tau};
  auto run = scan::vec4_ok(index, d) ? &launch_kv<T, 4> : &launch_kv<T, 1>;
  return run(qn, index, valid, targets, g, part_m, part_l, totals, offs,
             ptv, pti, cnt, dp, plast, tv, ti, m, l, st);
}

}  // namespace

#define FUSED_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const float* qn, const T* index, const uint8_t* valid, \
                      const float* targets, int S, int Q, int N, int d,       \
                      int nt, int K, float tau, float* part_m,               \
                      float* part_l, float* totals, float* offs, float* ptv,  \
                      int* pti, int* cnt, float* dp, float* plast, float* tv, \
                      int* ti, float* m, float* l, void* stream) {            \
    return launch<T>(qn, index, valid, targets, S, Q, N, d, nt, K, tau,      \
                     part_m, part_l, totals, offs, ptv, pti, cnt, dp, plast,  \
                     tv, ti, m, l, stream);                                   \
  }

FUSED_ENTRY(fused_retrieve_f32, float)
FUSED_ENTRY(fused_retrieve_i8, int8_t)
