// Dense cosine scan, 2-D form, for Hopper (sm_90a): the (Q, N) cosine
// scores of Q queries against one memory's N index rows, plus the softmax
// statistics m = max and l = sum-exp of the masked logits s / tau per
// query.
//
// Replaces: src/repro/kernels/similarity.py::similarity_scan (_sim_kernel,
// lines 90-173), a TPU Pallas kernel. Contract: the plain version
// repro_torch/kernels/ref.py::similarity_scan_ref. Queries and rows are
// normalised by rsqrt(sum x^2 + 1e-12) (the queries here, as the
// reference's wrapper does before its kernel; int8 row scales cancel); N
// is not padded, so an all-invalid index gives m = -1e30, l = N (the jnp
// oracle's probabilities 1/N).
//
// What bounds it on an H100: bytes. At Q = 8, N = 8192, d = 768 in f32 the
// rows are 25.2 MB and the scores 0.26 MB against 3.35 TB/s, 7.6 us; the
// arithmetic, 2*Q*N*d = 0.1 GFLOP, is 1.5 us at the f32 rate.
//
// Design. k_scan2d: the rows are cut into tiles of 32 rows (fewer where
// the queries or very wide rows leave no room); block b walks the
// contiguous tiles [b*per, (b+1)*per), and the host takes `per` so that
// the blocks fill every SM once (scan2d_plan in similarity.py: at the
// smoke shape 128 blocks of 2 tiles, one an SM). A tile's rows are
// contiguous in memory, so a tile is one byte range, streamed into a ring
// of 2 or 3 stages in shared memory by 16-byte cp.async copies
// (zero-filled past the end; any d and any element alignment): at the
// smoke shape both of a block's tiles are in flight from its start, 192
// KB an SM. The block's queries (up to `qg`, all of them unless shared
// memory runs out) arrive in their own copy group and are normalised in
// shared memory while the tiles are in flight. Eight warps share a tile:
// warp (h, g) scores rows 8g..8g+7 against 8 queries over half h of d
// (lanes striding over float4 or char4 columns where d % 4 == 0 and the
// rows are so aligned, else one element a load), so each query element
// read from shared memory serves 8 rows; sums are spread over the lanes
// (warp_sum_spread: 63 shuffles for 64 sums) and the halves meet in
// shared memory, added in a fixed order. Every row is read from device
// memory once for any Q. Scores are staged per tile and written with
// coalesced stores while the next tile is computed.
// k_stats2d: one block per query reads back its written scores and the
// mask, a warp per 256-row chunk, takes each chunk's (m, l) in
// scan::row_stats' lane order and merges them in chunk
// order (scan::merged_stats): the same bits from run to run. Its blocks
// reserve enough shared memory to take an SM each.
// Both kernels are programmatic dependents (Hopper's PDL): each is placed
// while the kernel before it on the stream runs and waits on that grid's
// end (griddepcontrol.wait) before it reads or writes device memory, so
// its launch is off the critical path. A statistics pass after the last
// block, by atomic tickets, took longer on the card (PERF.md).
// The C entry point returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tile.cuh"

namespace {

constexpr int kRowGroups = 4;                     // warps along the rows
constexpr int kWarps = 2 * kRowGroups;            // and two halves of d
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kTileMax = kRowGroups * kRowsPerWarp;   // rows of a full tile
constexpr int kQG = 8;                            // queries per pass
constexpr int kStatThreads = 1024;   // k_stats2d: a warp per 256-row chunk
// k_stats2d's shared memory at least: more than half an SM's, so that its
// blocks, placed early under PDL, do not crowd onto the SMs the scan
// leaves free
constexpr size_t kStatSmem = 120 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

using scan::as_f4;
using scan::cp_async16;
using scan::cp_commit;
using scan::cp_wait;
using scan::fma4;

// shared memory of a block: the queries [qp][dq], the staged scores
// [2][qp][kTileMax] and the second half's partials [kRowGroups][3][32] in
// f32, then the ring of kStages tile byte ranges
__host__ __device__ inline size_t stage_bytes(int tile, int d, int elt) {
  return (static_cast<size_t>(tile) * d * elt + 16 + 15) / 16 * 16;
}

__host__ __device__ inline int padded_queries(int qg) {
  return (qg + kQG - 1) / kQG * kQG;
}

__host__ __device__ inline size_t smem_bytes(int tile, int stages, int qg,
                                             int d, int elt) {
  const size_t qp = padded_queries(qg), dq = (d + 3) / 4 * 4;
  return 4 * (qp * dq + 2 * qp * kTileMax + kRowGroups * 3 * 32) +
         stages * stage_bytes(tile, d, elt);
}

struct Scan {
  const float* query;         // (Q, d) f32, raw
  const void* index;          // (N, d) f32 or int8
  const uint8_t* valid;       // (N,)
  int Q, N, d, tile, stages, qg, per;
  float tau;
  float* sims;                // (Q, N)
  float* m;                   // (Q,)
  float* l;
};

// ---- pass 1: the scores, tile by tile through the ring ----
template <typename T, bool kVec, int kStages>
__global__ void __launch_bounds__(kThreads) k_scan2d(const Scan a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // placed while the kernel before it on the stream may still run: nothing
  // is read or written before that grid's end; then the statistics kernel
  // may be placed
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  using V = typename scan::Vec4<T>::type;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = a.d, dq = (d + 3) / 4 * 4, qp = padded_queries(a.qg);
  const int q0 = blockIdx.y * a.qg, nq = min(a.qg, a.Q - q0);
  float* qs = reinterpret_cast<float*>(smem);            // [qp][dq]
  float* sv = qs + static_cast<size_t>(qp) * dq;          // [2][qp][kTileMax]
  float* xh = sv + 2 * qp * kTileMax;                    // [kRowGroups][3][32]
  unsigned char* ring = reinterpret_cast<unsigned char*>(xh + kRowGroups * 96);
  const size_t rowb = static_cast<size_t>(d) * sizeof(T);
  const size_t stage = stage_bytes(a.tile, d, sizeof(T));
  const int ntiles = (a.N + a.tile - 1) / a.tile;
  const int t0 = blockIdx.x * a.per, nt = min(a.per, ntiles - t0);
  const char* gbase = static_cast<const char*>(a.index);
  const char* gend = gbase + static_cast<size_t>(a.N) * rowb;

  // tile t's rows are the bytes [b0, b1): copied from the 16-byte boundary
  // at or below b0, so row r sits at ring + stage*s + (b0 % 16) + r * rowb
  auto tile_start = [&](int t) {
    return gbase + static_cast<size_t>(t) * a.tile * rowb;
  };
  auto load = [&](int s, int t) {
    const char* b0 = tile_start(t);
    const char* b1 = b0 + a.tile * rowb < gend ? b0 + a.tile * rowb : gend;
    const char* a0 = reinterpret_cast<const char*>(
        reinterpret_cast<uintptr_t>(b0) & ~static_cast<uintptr_t>(15));
    const int nchunk = static_cast<int>((b1 - a0 + 15) >> 4);
    unsigned char* dst = ring + s * stage;
    for (int c = tid; c < nchunk; c += kThreads) {
      const char* src = a0 + 16 * c;
      cp_async16(dst + 16 * c, src, b1 - src < 16 ? static_cast<int>(b1 - src)
                                                  : 16);
    }
  };
  // the raw queries join the first tile's copy group where their rows
  // are 16-byte units (d % 4 == 0, an aligned base); else plain loads.
  // Pad rows and columns are zero.
  const float* qg0 = a.query + static_cast<size_t>(q0) * d;
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(a.query) % 16 == 0) {
    for (int c = tid; c < nq * d / 4; c += kThreads)
      cp_async16(qs + 4 * c, qg0 + 4 * c, 16);
    for (int i = nq * dq + tid; i < qp * dq; i += kThreads) qs[i] = 0.f;
  } else {
    for (int i = tid; i < qp * dq; i += kThreads) {
      const int j = i / dq, c = i - j * dq;
      qs[i] = (j < nq && c < d) ? qg0[static_cast<size_t>(j) * d + c] : 0.f;
    }
  }
  cp_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load(s, t0 + s);
    cp_commit();
  }
  // while the tiles are in flight, each warp scales whole query rows by
  // rsqrt(sum q^2 + 1e-12)
  cp_wait<kStages - 1>();
  __syncthreads();
  for (int j = warp; j < nq; j += kWarps) {
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) ss += qs[j * dq + c] * qs[j * dq + c];
    const float inv = rsqrtf(scan::warp_sum(ss) + 1e-12f);
    for (int c = lane; c < d; c += 32) qs[j * dq + c] *= inv;
  }

  // tile i's staged scores → sims, 16 consecutive rows a query
  auto write_scores = [&](int i) {
    const int row0 = (t0 + i) * a.tile, len = min(a.tile, a.N - row0);
    const float* src = sv + (i & 1) * qp * kTileMax;
    for (int e = tid; e < nq * kTileMax; e += kThreads) {
      const int qi = e / kTileMax, r = e - qi * kTileMax;
      if (r < len)
        a.sims[static_cast<size_t>(q0 + qi) * a.N + row0 + r] =
            src[qi * kTileMax + r];
    }
  };

  for (int i = 0; i < nt; ++i) {
    cp_wait<kStages - 2>();
    __syncthreads();   // tile i is in; tile i - 1 is computed everywhere
    if (i + kStages - 1 < nt) load((i + kStages - 1) % kStages,
                                   t0 + i + kStages - 1);
    cp_commit();
    if (i > 0) write_scores(i - 1);
    const int row0 = (t0 + i) * a.tile, len = min(a.tile, a.N - row0);
    // warp = (half h of d, row group): 8 rows, every query, half the
    // columns (32-float4 blocks h, h + 2, ...); the halves meet in xh
    const int h = warp / kRowGroups, rg = warp - h * kRowGroups;
    const int r0 = rg * kRowsPerWarp;
    const bool active = r0 < len;
    const int off = static_cast<int>(
        reinterpret_cast<uintptr_t>(tile_start(t0 + i)) & 15);
    const unsigned char* base = ring + (i % kStages) * stage + off;
    const T* x[kRowsPerWarp];       // rows past the tile repeat its last
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      x[r] = reinterpret_cast<const T*>(base + min(r0 + r, len - 1) * rowb);
    float* out = sv + (i & 1) * qp * kTileMax;
    float* mine = xh + rg * 96;
    // lane L scores row r0 + L / 4 (its rsqrt in rs after the first pass)
    float rs = 0.f;
    for (int g0 = 0; g0 < qp; g0 += kQG) {
      float acc[kRowsPerWarp * kQG] = {};     // [row][query]
      float ss[kRowsPerWarp] = {};
      if (active && kVec) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + g0 * dq);
        for (int v = lane + 32 * h; v < d / 4; v += 64) {
          float4 e[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            e[r] = as_f4(reinterpret_cast<const V*>(x[r])[v]);
            if (g0 == 0) ss[r] = fma4(e[r], e[r], ss[r]);
          }
#pragma unroll
          for (int qi = 0; qi < kQG; ++qi) {
            const float4 q = q4[qi * (dq / 4) + v];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r)
              acc[r * kQG + qi] = fma4(q, e[r], acc[r * kQG + qi]);
          }
        }
      } else if (active) {
        for (int c = lane + 32 * h; c < d; c += 64) {
          float e[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            e[r] = static_cast<float>(x[r][c]);
            if (g0 == 0) ss[r] = fmaf(e[r], e[r], ss[r]);
          }
#pragma unroll
          for (int qi = 0; qi < kQG; ++qi) {
            const float q = qs[(g0 + qi) * dq + c];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r)
              acc[r * kQG + qi] = fmaf(q, e[r], acc[r * kQG + qi]);
          }
        }
      }
      if (g0 == 0) scan::warp_sum_spread(ss);  // lane L: row L / 4
      scan::warp_sum_spread(acc);        // lane L: values 2L, 2L + 1
      if (h == 1) {
        mine[lane] = acc[0];
        mine[32 + lane] = acc[1];
        mine[64 + lane] = ss[0];
      }
      __syncthreads();
      if (h == 0 && active) {
        if (g0 == 0) rs = rsqrtf(ss[0] + mine[64 + lane] + 1e-12f);
        const int r = lane >> 2, qi = 2 * (lane & 3);
        out[(g0 + qi) * kTileMax + r0 + r] = (acc[0] + mine[lane]) * rs;
        out[(g0 + qi + 1) * kTileMax + r0 + r] =
            (acc[1] + mine[32 + lane]) * rs;
      }
      if (g0 + kQG < qp) __syncthreads();   // xh is rewritten next pass
    }
  }
  __syncthreads();
  if (nt > 0) write_scores(nt - 1);
}

// ---- pass 2: (m, l) of query blockIdx.x, after the scan grid's end ----
__global__ void __launch_bounds__(kStatThreads) k_stats2d(const Scan a) {
  extern __shared__ float part[];       // [2][nch]: m, then l, per chunk
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // a programmatic dependent after it (the next scan) may be placed
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = (a.N + scan::kBlk - 1) / scan::kBlk;
  const float* row = a.sims + static_cast<size_t>(blockIdx.x) * a.N;
  for (int k = warp; k < nch; k += kStatThreads / 32) {
    const int c0 = k * scan::kBlk, len = min(scan::kBlk, a.N - c0);
    // the lane's scores and mask bytes, all loads in flight together
    // before any division (whose slow path is a call the compiler does
    // not move loads across)
    constexpr int kPer = scan::kBlk / 32;
    float x[kPer];
    uint8_t ok[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = c0 + lane + 32 * u;
      x[u] = i < a.N ? __ldcg(row + i) : 0.f;
      ok[u] = i < a.N ? a.valid[i] : 0;
    }
    float m, l;
    scan::row_stats([&](int u) { return ok[u] ? x[u] : scan::kNegInf; },
                    len, a.tau, m, l);
    if (lane == 0) {
      part[k] = m;
      part[nch + k] = l;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float M, L;
    scan::merged_stats(part, part + nch, 0, nch, M, L);
    a.m[blockIdx.x] = M;
    a.l[blockIdx.x] = L;
  }
}

template <typename T>
int launch(const Scan& a, cudaStream_t st) {
  const int ntiles = (a.N + a.tile - 1) / a.tile;
  const size_t smem = smem_bytes(a.tile, a.stages, a.qg, a.d, sizeof(T));
  const size_t stat_smem =
      2 * sizeof(float) * ((a.N + scan::kBlk - 1) / scan::kBlk);
  if (a.Q < 1 || a.N < 1 || a.d < 1 || a.tile < 1 || a.tile > kTileMax ||
      a.qg < 1 || a.qg > a.Q || a.per < 1 || smem > kMaxSmem ||
      (a.stages != 2 && a.stages != 3) || stat_smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const dim3 grid((ntiles + a.per - 1) / a.per, (a.Q + a.qg - 1) / a.qg);
  const bool vec = a.d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.index) % (4 * sizeof(T)) == 0;
  auto run = [&](auto kernel) {
    return scan::launch_pdl(kernel, grid, smem, st, a, kThreads);
  };
  const cudaError_t e = a.stages == 3
                            ? (vec ? run(k_scan2d<T, true, 3>)
                                   : run(k_scan2d<T, false, 3>))
                            : (vec ? run(k_scan2d<T, true, 2>)
                                   : run(k_scan2d<T, false, 2>));
  if (e != cudaSuccess) return e;
  return scan::launch_pdl(k_stats2d, dim3(a.Q),
                         stat_smem > kStatSmem ? stat_smem : kStatSmem, st,
                         a, kStatThreads);
}

}  // namespace

#define SCAN2D_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const float* query, const T* index,                     \
                      const uint8_t* valid, int Q, int N, int d, int tile,     \
                      int stages, int qg, int per, float tau, float* sims,    \
                      float* m, float* l, void* stream) {                     \
    const Scan a{query, index, valid, Q, N, d, tile, stages, qg, per, tau,   \
                 sims, m, l};                                                 \
    return launch<T>(a, static_cast<cudaStream_t>(stream));                  \
  }

SCAN2D_ENTRY(similarity_scan_2d_f32, float)
SCAN2D_ENTRY(similarity_scan_2d_i8, int8_t)
