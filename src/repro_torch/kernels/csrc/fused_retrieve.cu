// Fused retrieval scan for Hopper (sm_90a): one launch answers a whole
// execution group — softmax statistics, inverse-CDF draw counts, the
// crossing-lane probability of every draw, the top-K, p_last and p_max.
//
// Replaces: src/repro/kernels/similarity.py::fused_retrieve_scan_stack
// (_fused_stack_kernel, the TPU Pallas kernel). Contract: the plain
// version repro_torch/kernels/ref.py::fused_retrieve_stack_ref.
//
// What bounds it on an H100: bytes. The valid index rows must be read
// (f32 or int8); at S=16, N=8192, d=768 with every row valid that is
// 402.7 MB in f32 (100.7 MB in int8) against 3.35 TB/s, ~0.12 ms (~0.03
// ms), and a masked row need not be read at all. The arithmetic,
// 2*S*Q*N*d ~ 1.6 GFLOP, is far below the fp32 line.
//
// Design. Two kernels, the second a programmatic dependent (PDL) of the
// first, each waiting on griddepcontrol.wait before it reads anything:
//   1. k_scores, one block per (256-row chunk, session, group of 8
//      queries; scan::score_chunk): each valid row is read once for all 8
//      queries and a masked one never (a chunk with no valid row reads
//      only its mask); each warp streams its own rows through its own
//      cp.async ring and scores 4 rows x 8 queries at a time
//      (scan::group_scores). The valid rows' scores leave straight from
//      registers for a workspace of S*Q*N f32 (4.2 MB at the shape above:
//      L2-sized, never returned).
//   2. k_finish, one block per (session, query), reads only the workspace
//      and the mask, never the index, a slab of up to 32 chunks at a time
//      (a row of one slab keeps its scores in registers throughout): each
//      chunk's (m, l) in the dense scan's order, M and L merged in chunk
//      order; p of every lane in shared memory; the slab's top-K by K
//      rounds of a block arg-best; one thread per chunk walks its lanes
//      sequentially (the in-chunk prefix, in place of p); one thread folds
//      the chunk totals left to right; then each target finds its count
//      by search: the CDF is non-decreasing across the row (p >= 0, fp32
//      rounding is monotone, and a chunk's last value offset + total is
//      the fold's next offset bit for bit), so #{cdf <= t} is the first
//      chunk whose end exceeds t, then the first lane in it whose value
//      does (a binary search). drawn_p is p at that lane; a target at or
//      beyond the total mass counts N with drawn_p 0. A row of several
//      slabs merges their top-K last.
// The CDF order is the port's canonical one (draws.py): a sequential fp32
// walk inside each chunk, a sequential fp32 fold of the chunk totals, so
// the plain version reproduces it. Top-K order is (value desc, lane asc):
// ties go to the lowest lane and masked lanes carry -1e30, exactly
// lax.top_k over the masked scores. Rows are scored, and (m, l) taken, by
// the same functions as the dense scan (similarity_scan.cu), so both give
// the same m and l bits; any d and any index base (scan::scan_stages:
// staged where rows start on 16 bytes, else float4/char4 loads where
// scan::vec4_ok, else one element a load).
// The C entry points return cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tile.cuh"

namespace {

using scan::kBlk;
using scan::kLanes;
using scan::kNegInf;
using scan::kPer;
using scan::kQG;
using scan::kSlab;
using scan::kThreads;
using scan::kWarps;

constexpr int kPad = kBlk + 1;     // a chunk's stride in P: no bank clash
// k_finish's shared memory: the slab's p, its offsets and totals, and
// each warp's best of a top-K round
constexpr size_t kFinishSmem =
    sizeof(float) * (kSlab * kPad + 2 * kSlab + 1 + 2 * kWarps);
static_assert(kFinishSmem <= scan::kStatsReserve, "k_finish's slab");
static_assert(kPer * kLanes == 32, "a thread's slab lanes fit a bit mask");

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

// The best (value desc, lane asc) of v[0 .. 2 W) into v[0], l[0]: a tree
// of depth log2(2 W), every index a constant (the arrays stay in
// registers).
template <int W>
__device__ __forceinline__ void tree_best(float* v, int* l) {
  if constexpr (W > 0) {
#pragma unroll
    for (int b = 0; b < W; ++b)
      if (ahead(v[b + W], l[b + W], v[b], l[b])) {
        v[b] = v[b + W];
        l[b] = l[b + W];
      }
    tree_best<W / 2>(v, l);
  }
}

// p of a lane from its masked score, M and max(L, 1e-30)
__device__ __forceinline__ float prob_of(float sv, float M, float Ls,
                                         float tau) {
  return expf(scan::logit_of(sv, tau) - M) / Ls;
}

// ---- 1. the valid rows' scores ----
template <typename T, int kV, int kStages>
__global__ void __launch_bounds__(kThreads, 2) k_scores(const scan::Scan a) {
  extern __shared__ __align__(16) unsigned char smem[];
  scan::pdl_wait();
  scan::pdl_launch_dependents();
  if constexpr (kV == 16) {         // int8 rows on the tensor cores
    scan::score_chunk_mma<true>(a, smem);
  } else {
    float* qs = reinterpret_cast<float*>(smem);
    scan::score_chunk<T, kV, kStages, true>(
        a, qs, reinterpret_cast<unsigned char*>(qs + kQG * scan::padded(a.d)));
  }
}

// k_finish's operands. Plain pointers: it runs under PDL, and read-only
// (const __restrict__) operands may be loaded ahead of its wait.
struct Finish {
  float* ws;               // (S, Q, N) the valid rows' scores
  uint8_t* valid;          // (S, N)
  float* part_m;           // (S, Q, nch) each chunk's (m, l)
  float* part_l;
  float* targets;          // (S, Q, T)
  float* ptv;              // (S, Q, nslab, K) each slab's top-K
  int* pti;
  int* cnt;                // (S, Q, T)
  float* dp;
  float* plast;            // (S, Q)
  float* tv;               // (S, Q, K)
  int* ti;
  float* m;                // (S, Q)
  float* l;
  float* pmax;
  int Q, N, T, K, nch;
  float tau;
};

// ---- 2. from the workspace: m, l, p_max, counts, drawn_p, p_last, top-K
__global__ void __launch_bounds__(kThreads) k_finish(const Finish a) {
  extern __shared__ float P[];        // [kSlab][kPad]: p, then the prefix
  float* offs = P + kSlab * kPad;     // the slab's chunk offsets, its end
  float* tot = offs + kSlab + 1;
  float* wv = tot + kSlab;            // each warp's best of a round
  int* wi = reinterpret_cast<int*>(wv + kWarps);
  scan::pdl_wait();
  scan::pdl_launch_dependents();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nslab = (a.nch + kSlab - 1) / kSlab;
  const size_t row = static_cast<size_t>(blockIdx.y) * a.Q + blockIdx.x;
  const float* sc = a.ws + row * a.N;
  const uint8_t* vs = a.valid + static_cast<size_t>(blockIdx.y) * a.N;
  const float* tg = a.targets + row * a.T;
  auto score = [&](int i) { return vs[i] ? sc[i] : kNegInf; };
  // each chunk's (m, l), then M and L merged in chunk order; a row of one
  // slab keeps its scores in registers for what follows
  float x[kPer][kLanes];
  for (int k0 = 0; k0 < a.nch; k0 += kSlab) {
    scan::slab_scores(sc, vs, a.N, k0, x);
    scan::slab_partials(x, a.N, k0, a.tau, a.part_m + row * a.nch,
                        a.part_l + row * a.nch);
  }
  __syncthreads();
  float M, L;
  scan::merged_stats(a.part_m, a.part_l, row, a.nch, M, L);
  const float Ls = fmaxf(L, 1e-30f);
  if (tid == 0) {
    a.m[row] = M;
    a.l[row] = L;
    a.pmax[row] = 1.f / Ls;        // the max-probability lane: exp(0) / L
    a.plast[row] = prob_of(score(a.N - 1), M, Ls, a.tau);
  }
  float carry = 0.f;                 // thread 0's fold, slab to slab
  for (int k0 = 0; k0 < a.nch; k0 += kSlab) {
    const int nk = min(kSlab, a.nch - k0);
    if (nslab > 1) scan::slab_scores(sc, vs, a.N, k0, x);
    // p of every lane of the slab
    unsigned done = 0;               // lanes taken by the top-K, or absent
#pragma unroll
    for (int c = 0; c < kPer; ++c)
#pragma unroll
      for (int u = 0; u < kLanes; ++u) {
        const int j = warp + kWarps * c, i = lane + 32 * u;
        if (x[c][u] == -INFINITY)
          done |= 1u << (c * kLanes + u);
        else      // a masked lane's p is exp(-1e30 - M) / Ls = 0 exactly
          P[j * kPad + i] = x[c][u] == kNegInf && M > kNegInf
                                ? 0.f
                                : prob_of(x[c][u], M, Ls, a.tau);
      }
    // the slab's top-K: K rounds of a block arg-best over each thread's
    // best untaken lane, which only the thread whose lane was taken finds
    // anew (a tree of depth 5 over its 32, not a chain)
    auto lane_of = [&](int b) {
      return (k0 + warp + kWarps * (b / kLanes)) * kBlk + lane +
             32 * (b % kLanes);
    };
    auto own_best = [&](float& v, int& idx) {
      float tv[kPer * kLanes];
      int tl[kPer * kLanes];
#pragma unroll
      for (int b = 0; b < kPer * kLanes; ++b) {
        const bool off = done >> b & 1u;
        tv[b] = off ? -INFINITY : x[b / kLanes][b % kLanes];
        tl[b] = off ? 0x7fffffff : lane_of(b);
      }
      tree_best<kPer * kLanes / 2>(tv, tl);
      v = tv[0];
      idx = tl[0];
    };
    float bv;
    int bl;
    own_best(bv, bl);
    for (int k = 0; k < a.K; ++k) {
      float v = bv;
      int idx = bl;
      warp_best(v, idx);
      if (lane == 0) {
        wv[warp] = v;
        wi[warp] = idx;
      }
      __syncthreads();
      v = wv[0];
      idx = wi[0];
      for (int w = 1; w < kWarps; ++w)
        if (ahead(wv[w], wi[w], v, idx)) {
          v = wv[w];
          idx = wi[w];
        }
      if (bl == idx) {                 // the owner takes it, finds anew
#pragma unroll
        for (int b = 0; b < kPer * kLanes; ++b)
          if (lane_of(b) == idx) done |= 1u << b;
        own_best(bv, bl);
      }
      if (tid == 0) {
        const size_t o = nslab > 1
                             ? (row * nslab + k0 / kSlab) * a.K + k
                             : row * a.K + k;
        (nslab > 1 ? a.ptv : a.tv)[o] = v;
        (nslab > 1 ? a.pti : a.ti)[o] = idx;
      }
      __syncthreads();               // wv, wi are the next round's
    }
    if (tid < nk) {                  // the canonical in-chunk walk
      const int len = min(kBlk, a.N - (k0 + tid) * kBlk);
      float* pc = P + tid * kPad;
      float cc = 0.f;
#pragma unroll 8
      for (int i = 0; i < len; ++i) {
        cc += pc[i];
        pc[i] = cc;
      }
      tot[tid] = cc;
    }
    __syncthreads();
    if (tid == 0) {                  // the sequential left fold
      for (int j = 0; j < nk; ++j) {
        offs[j] = carry;
        carry = carry + tot[j];
      }
      offs[nk] = carry;
    }
    __syncthreads();
    // the targets whose crossing lies in this slab: at or past its start
    // (any, in the first slab) and not at or past its end
    const float lo = offs[0], hi = offs[nk];
    for (int t = tid; t < a.T; t += kThreads) {
      const float y = tg[t];
      if ((k0 > 0 && !(y >= lo)) || y >= hi) continue;
      int j = 0;                     // the first chunk whose end exceeds y
      while (j + 1 < nk && offs[j + 1] <= y) ++j;
      const int len = min(kBlk, a.N - (k0 + j) * kBlk);
      const float off = offs[j];
      const float* pc = P + j * kPad;
      int b = 0, e = len;            // the first lane whose cdf exceeds y
      while (b < e) {
        const int mid = (b + e) >> 1;
        if (pc[mid] + off <= y)
          b = mid + 1;
        else
          e = mid;
      }
      const int c = (k0 + j) * kBlk + b;
      a.cnt[row * a.T + t] = c;
      a.dp[row * a.T + t] = c < a.N ? prob_of(score(c), M, Ls, a.tau) : 0.f;
    }
    __syncthreads();                 // P and offs are the next slab's
  }
  // targets at or beyond the total mass: every lane counts
  const float total = offs[a.nch - (nslab - 1) * kSlab];
  for (int t = tid; t < a.T; t += kThreads)
    if (tg[t] >= total) {
      a.cnt[row * a.T + t] = a.N;
      a.dp[row * a.T + t] = 0.f;
    }
  if (nslab == 1 || warp != 0) return;
  // the row's top-K from the slabs' (consumed candidates set to -1)
  const int nc = nslab * a.K;
  const float* cv = a.ptv + row * nc;
  int* ci = a.pti + row * nc;
  for (int k = 0; k < a.K; ++k) {
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
    if (slot >= 0 && mine == idx) ci[slot] = -1;
    __syncwarp();
    if (lane == 0) {
      a.tv[row * a.K + k] = v;
      a.ti[row * a.K + k] = idx;
    }
  }
}

template <typename T>
int launch(const float* query, const T* index, const uint8_t* valid,
           const float* targets, int S, int Q, int N, int d, int nt, int K,
           float tau, float* ws, float* part_m, float* part_l, float* ptv,
           int* pti, int* cnt, float* dp, float* plast, float* tv, int* ti,
           float* m, float* l, float* pmax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const scan::Scan a{query, index, valid, ws, S, Q, N, d};
  const bool aligned = reinterpret_cast<uintptr_t>(index) % 16 == 0;
  const bool mma = scan::mma_ok(d, sizeof(T), aligned);
  const int stages = scan::scan_stages(d, sizeof(T), aligned);
  const size_t smem =
      mma ? scan::mma_smem(d) : scan::scan_smem(d, sizeof(T), stages);
  if (smem > scan::kMaxSmem || S < 1 || Q < 1 || N < 1 || nt < 1 || K < 1 ||
      K > N)
    return cudaErrorInvalidValue;
  const dim3 grid((N + kBlk - 1) / kBlk, S, (Q + kQG - 1) / kQG);
  cudaError_t e = cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 1)
    if (mma) e = scan::launch_pdl(k_scores<T, 16, 0>, grid, smem, st, a);
  if (!mma)
    e = stages == 3 ? scan::launch_pdl(k_scores<T, 4, 3>, grid, smem, st, a)
      : stages == 2 ? scan::launch_pdl(k_scores<T, 4, 2>, grid, smem, st, a)
      : scan::vec4_ok(index, d)
          ? scan::launch_pdl(k_scores<T, 4, 0>, grid, smem, st, a)
          : scan::launch_pdl(k_scores<T, 1, 0>, grid, smem, st, a);
  if (e != cudaSuccess) return e;
  const Finish f{ws, const_cast<uint8_t*>(valid), part_m, part_l,
                 const_cast<float*>(targets), ptv, pti, cnt, dp, plast, tv,
                 ti, m, l, pmax, Q, N, nt, K, (N + kBlk - 1) / kBlk, tau};
  return scan::launch_pdl(k_finish, dim3(Q, S), scan::kStatsReserve, st, f);
}

}  // namespace

#define FUSED_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const float* query, const T* index,                     \
                      const uint8_t* valid,                                   \
                      const float* targets, int S, int Q, int N, int d,       \
                      int nt, int K, float tau, float* ws, float* part_m,    \
                      float* part_l, float* ptv, int* pti, int* cnt,          \
                      float* dp, float* plast, float* tv, int* ti, float* m,  \
                      float* l, float* pmax, void* stream) {                  \
    return launch<T>(query, index, valid, targets, S, Q, N, d, nt, K, tau, ws,\
                     part_m, part_l, ptv, pti, cnt, dp, plast, tv, ti, m, l,  \
                     pmax, stream);                                           \
  }

FUSED_ENTRY(fused_retrieve_f32, float)
FUSED_ENTRY(fused_retrieve_i8, int8_t)

// The score pass's plan, for the host's mirror (similarity.scan_plan):
// for rows of d elements of elt bytes from an index base aligned (or not)
// to 16 bytes, whether they take the tensor cores, else the ring stages,
// and a block's shared memory in bytes.
extern "C" int fused_retrieve_mma(int d, int elt, int aligned) {
  return scan::mma_ok(d, elt, aligned != 0);
}

extern "C" int fused_retrieve_stages(int d, int elt, int aligned) {
  return scan::scan_stages(d, elt, aligned != 0);
}

extern "C" long long fused_retrieve_smem(int d, int elt, int aligned) {
  return static_cast<long long>(
      scan::mma_ok(d, elt, aligned != 0)
          ? scan::mma_smem(d)
          : scan::scan_smem(d, elt, scan::scan_stages(d, elt, aligned != 0)));
}
