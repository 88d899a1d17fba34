// MLA decode attention in bf16 for Hopper (sm_90a): one query token per
// sequence against its latent cache, in the matrix-absorbed form, with the
// products on the tensor cores.
//
// Replaces: src/repro/kernels/decode_attention.py::mla_decode (_mla_kernel,
// the TPU Pallas kernel) on the route decode_attention.mla_route names:
// bf16, R and Dr multiples of 16 with 16 <= R <= 512 and 16 <= Dr <= 64,
// any number of heads H. f32 and every other shape keep k_partial
// (decode_attention.cu). Contract: the plain version
// repro_torch/kernels/ref.py::mla_decode_attention_ref:
//   s = (q_abs . ckv + q_rope . krope) * scale, masked to -1e30,
//   context = softmax(s) . ckv  (the latent context, (B, 1, H, R)),
// logits, softmax and the value sums in f32, the output in bf16. An
// all-invalid sequence gives the mean of ckv, as the oracle does (every
// logit is -1e30, so every weight is exp(0) = 1).
//
// What bounds it on an H100: operations, then bytes. Every cache row meets
// every head, so at MiniCPM3-4B (H = 40, R = 256, Dr = 32, B = 4 slots of
// C = 2048) the rows a masked softmax needs (5,597 of 8,192 at the smoke
// run's masks) are 3.2 MB of bf16 (0.96 us at 3.35 TB/s), while the value
// product with f32 weights is 2 H n R = 0.11 GFLOP (1.7 us at the f32 rate).
//
// Design:
// * The latent cache is read once per sequence: a block holds hg heads of
//   its sequence, all H where their f32 value sums fit the registers (hg
//   a multiple of 16 up to 64, hg * R <= 16,384: at most 64 sums a
//   thread; 48 for MiniCPM3-4B's 40, 16 for DeepSeek-V2-Lite; DeepSeek-
//   V3's 128 heads of R = 512 take four blocks of 32, each reading the
//   rows). The grid is (split, head group, sequence); split s walks a
//   contiguous range of 64-row tiles (decode_attention.mla_split_plan:
//   one block an SM, so 32 splits of one tile at MiniCPM3-4B's 4 x 2048
//   rows, measured faster than 4, 8 and 16), and writes one hg x R
//   partial.
// * Mask first. Before any copy, the block reads its rows' mask bytes and
//   lists the tiles that hold a valid row; only those are read (exact:
//   once a row is valid, a masked row weighs exp(-1e30 - m) = 0). A block
//   with no valid row reads the sequence's whole mask: if any row is valid
//   it writes an empty partial (m = -1e30, l = 0, acc = 0: weight 0 in
//   the merge), and if none is it walks every tile of its range as masked
//   rows (the mean of ckv). With out == nullptr (partials for another
//   merge: a latent cache sharded by its sequence runs this kernel on each
//   rank's rows, and merge_partials_* takes every rank's partials) such a
//   block writes the empty partial at once, reading neither the rest of
//   the mask nor any ckv/krope row: a shard holds no more than its rows.
// * A cp.async ring of 2 or 3 stages of bf16 tiles, 64 rows x (R + Dr),
//   the ckv and krope columns side by side in one row, zero-filled past C.
//   The ckv columns of the same tile are the values: no second read.
// * s = q . [ckv, krope]^T as mma.m16n8k16 (heads as M, rows as N, R + Dr
//   as K), the queries staged once a block in bf16. The 8 warps take 16
//   rows and one half of K each; the two halves' f32 sums meet in shared
//   memory in a fixed order, where scale and mask act on them.
// * The softmax of the tile: four threads per head, 16 rows each; the
//   running max and sum stay in shared memory, and p goes there as three
//   bf16 terms, p = hi + mid + lo to a relative 2^-27, beside each head's
//   rescaling factor. (Two terms leave 2^-18: where a head's output is a
//   small sum of cancelling rows, as with a few valid rows, that is more
//   than one bf16 ulp of the output.)
// * p . ckv as mma.m16n8k16 (heads as M, R as N, the tile's rows as K):
//   the R columns are split across the warps in pairs of 8-column n-tiles,
//   so each warp holds hg x (R / 8) f32 sums in registers (48 at
//   MiniCPM3-4B); ckv by ldmatrix.trans from the ring.
// * Row strides are padded by 16 bytes (an odd number of 16-byte units),
//   so no ldmatrix has a bank conflict.
// * k_merge (decode_common.cuh) merges the splits of each (head, sequence)
//   in order, launched as a programmatic dependent of this kernel; it
//   loads every split's m, l and sums at once, so it waits for memory
//   once.
// The C entry point returns cudaGetLastError() after the launches; with
// out == nullptr it stops after k_mla and leaves the partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using dec::bf16;
using dec::cp_async16;
using dec::cp_commit;
using dec::cp_wait;
using dec::kMaxSmem;
using dec::kNegInf;
using dec::ldsm_x4;
using dec::ldsm_x4_t;
using dec::minus_inf;
using dec::mma;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;            // cache rows per tile
constexpr int kSst = kRows + 8;      // row stride of the f32 scores
constexpr int kPst = kRows + 8;      // row stride of p (bf16): 9 x 16 B

struct Args {
  const bf16* q_abs;          // (B, H, R)
  const bf16* q_rope;         // (B, H, Dr)
  const bf16* ckv;            // (B, C, R)
  const bf16* krope;          // (B, C, Dr)
  const uint8_t* valid;       // row c of sequence b at valid[b*mask_bs + c]
  long long mask_bs;
  int C, H, R, Dr, stages, tiles_per_split;
  float scale;
  float* part_m;              // [B][H][splits]
  float* part_l;
  float* part_acc;            // [B][H][splits][R]
  int empty_parts;            // no merge here: an empty range stays empty
};

// shared-memory carve-up in bytes (decode_attention.mla_smem_bytes
// mirrors it): the queries, the ring, the scores, p's three bf16 terms,
// each head's m, l and rescaling factor, the tile list and its flags
struct Layout {
  size_t q, ring, s, p, stat, list, live, total;
};

__host__ __device__ inline Layout layout(int hg, int R, int Dr, int stages,
                                         int tiles) {
  const size_t ks = R + Dr + 8;                   // bf16 row stride
  Layout L;
  L.q = 0;                                        // [hg][ks] bf16
  L.ring = L.q + 2 * hg * ks;                     // [stages][kRows][ks]
  L.s = L.ring + 2 * static_cast<size_t>(stages) * kRows * ks;
  L.p = L.s + 4 * hg * kSst;                      // [hg][kSst] f32
  L.stat = L.p + 3 * 2 * hg * kPst;               // [3][hg][kPst] bf16
  L.list = L.stat + 4 * 3 * hg;                   // [3][hg] f32, then
  //                                                 [tiles] int
  L.live = L.list + 4 * static_cast<size_t>(tiles);
  L.total = L.live + tiles;
  return L;
}

// kMT: m-tiles of 16 heads a block (hg = 16 kMT); kNP: the most 16-column
// pairs of R a warp holds (R <= 128 kNP)
template <int kMT, int kNP>
__global__ void __launch_bounds__(kThreads, 1) k_mla(const Args a) {
  constexpr int kHg = 16 * kMT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.R, K = a.R + a.Dr, ks = K + 8, kc = K / 8;
  const Layout L = layout(kHg, R, a.Dr, a.stages, a.tiles_per_split);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);  // hi, mid, lo
  float* ms = reinterpret_cast<float*>(smem + L.stat);
  float* ls = ms + kHg;
  float* corr = ls + kHg;
  int* list = reinterpret_cast<int*>(smem + L.list);
  uint8_t* live = smem + L.live;
  __shared__ int n_live;

  // the merge may launch once every block of this grid runs
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int split = blockIdx.x, b = blockIdx.z, nsplit = gridDim.x;
  const int h0 = blockIdx.y * kHg, nh = min(kHg, a.H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = split * a.tiles_per_split;
  const int nt = min(a.tiles_per_split, (a.C + kRows - 1) / kRows - t0);
  const uint8_t* vm = a.valid + b * a.mask_bs;
  auto prow = [&](int j) {       // partial row of head j of the block
    return (static_cast<size_t>(b) * a.H + h0 + j) * nsplit + split;
  };

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
    // no valid row here: an empty partial, unless no row of the sequence
    // is valid and the merge is this launch's own — then every row of the
    // range counts (the mean of ckv)
    int any = a.empty_parts;
    for (int r0 = tid; !a.empty_parts && r0 < a.C; r0 += 8 * kThreads) {
      uint8_t x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        x[u] = r0 + u * kThreads < a.C ? vm[r0 + u * kThreads] : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) any |= x[u];
    }
    if (__syncthreads_or(any)) {
      for (int i = tid; i < nh * R; i += kThreads) {
        const int j = i / R;
        a.part_acc[prow(j) * R + i - j * R] = 0.f;
        if (i == j * R) {
          a.part_m[prow(j)] = kNegInf;
          a.part_l[prow(j)] = 0.f;
        }
      }
      return;
    }
    for (int i = tid; i < nt; i += kThreads) list[i] = t0 + i;
    __syncthreads();
    n = nt;
  }

  // 2. the queries (heads nh.. zero) join the first tile's copy group;
  //    each head's running max and sum start empty
  for (int i = tid; i < kHg * kc; i += kThreads) {
    const int j = i / kc, c = 8 * (i - j * kc);
    const bool in = j < nh;
    const size_t hrow = static_cast<size_t>(b) * a.H + h0 + (in ? j : 0);
    const bf16* src = c < R ? a.q_abs + hrow * R + c
                            : a.q_rope + hrow * a.Dr + (c - R);
    cp_async16(qs + j * ks + c, src, in);
  }
  for (int j = tid; j < kHg; j += kThreads) {
    ms[j] = kNegInf;
    ls[j] = 0.f;
    corr[j] = 0.f;
  }
  const int tile_elems = kRows * ks;
  auto load = [&](int stage, int tile) {
    bf16* dst = ring + stage * tile_elems;
    for (int i = tid; i < kRows * kc; i += kThreads) {
      const int r = i / kc, c = 8 * (i - r * kc);
      const int row = tile * kRows + r;
      const bool in = row < a.C;
      const size_t crow = static_cast<size_t>(b) * a.C + (in ? row : 0);
      const bf16* src = c < R ? a.ckv + crow * R + c
                              : a.krope + crow * a.Dr + (c - R);
      cp_async16(dst + r * ks + c, src, in);
    }
  };
  const int stages = a.stages;
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n) load(s, list[s]);
    cp_commit();
  }

  // 3. the walk. Scores: warp = (rows 16 rg.., K half kh); values: the
  //    warp's column pairs warp + 8 u of R
  const int g = lane >> 2, t4 = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, its row
  const int rg = warp & 3, kh = warp >> 2;
  const int nk = K / 16, k_mid = (nk + 1) / 2;
  const int k_lo = kh ? k_mid : 0, k_hi = kh ? nk : k_mid;
  const int npairs = R / 16;
  float acc[kMT][2 * kNP][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * kNP; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  for (int i = 0; i < n; ++i) {
    if (stages == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();       // tile i is in; every warp is done with i - 1
    if (i + stages - 1 < n)
      load((i + stages - 1) % stages, list[i + stages - 1]);
    cp_commit();
    const int tile = list[i];
    const bf16* kt = ring + (i % stages) * tile_elems;
    // the mask of the fragment's rows (0: valid), read before the products
    float fill[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = tile * kRows + 16 * rg + 8 * j + 2 * t4 + e;
        fill[j][e] = row >= a.C ? minus_inf() : (vm[row] ? 0.f : kNegInf);
      }

    // s = q . [ckv, krope]^T over rows 16 rg.. and K steps [k_lo, k_hi)
    float sc[kMT][2][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        sc[mt][j][0] = sc[mt][j][1] = sc[mt][j][2] = sc[mt][j][3] = 0.f;
#pragma unroll 2
    for (int kk = k_lo; kk < k_hi; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, kt + (16 * rg + (mat >> 1) * 8 + mr) * ks + 16 * kk +
                      (mat & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t qa[4];
        ldsm_x4(qa, qs + (16 * mt + (mat & 1) * 8 + mr) * ks + 16 * kk +
                        (mat >> 1) * 8);
        mma(sc[mt][0], qa, kb[0], kb[1]);
        mma(sc[mt][1], qa, kb[2], kb[3]);
      }
    }
    // the second half's sums go through shared memory; the first half
    // adds them (in that order), scales and masks: rows past C weigh 0
    if (kh == 1) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float* o = ss + (16 * mt + g) * kSst + 16 * rg + 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(o) = make_float2(sc[mt][j][0],
                                                      sc[mt][j][1]);
          *reinterpret_cast<float2*>(o + 8 * kSst) =
              make_float2(sc[mt][j][2], sc[mt][j][3]);
        }
    }
    __syncthreads();
    if (kh == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float2* o = reinterpret_cast<float2*>(
                ss + (16 * mt + g + 8 * hh) * kSst + 16 * rg + 8 * j +
                2 * t4);
            const float2 x = *o;
            const float s0 = (sc[mt][j][2 * hh] + x.x) * a.scale;
            const float s1 = (sc[mt][j][2 * hh + 1] + x.y) * a.scale;
            *o = make_float2(fill[j][0] == 0.f ? s0 : fill[j][0],
                             fill[j][1] == 0.f ? s1 : fill[j][1]);
          }
    }
    __syncthreads();

    // the tile's softmax, four threads a head (rows q, q + 4, ..): p as
    // three bf16 terms, the factor that rescales the head's sums, and its
    // running max and sum. Pad heads (zero queries) too: every warp is
    // whole, and their rows of p stay finite.
    if (tid < 4 * kHg) {
      const int j = tid >> 2, q = tid & 3;
      const float* srow = ss + j * kSst + q;
      float x[kRows / 4], mx = minus_inf();
#pragma unroll
      for (int u = 0; u < kRows / 4; ++u) {
        x[u] = srow[4 * u];
        mx = fmaxf(mx, x[u]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mo = ms[j];
      const float mn = fmaxf(mo, mx);                   // >= -1e30
      float psum = 0.f;
      bf16* prow_s = ps + j * kPst + q;
#pragma unroll
      for (int u = 0; u < kRows / 4; ++u) {
        const float p = expf(x[u] - mn);
        psum += p;
        const bf16 hi = __float2bfloat16(p);
        const float r1 = p - __bfloat162float(hi);
        const bf16 mid = __float2bfloat16(r1);
        prow_s[4 * u] = hi;
        prow_s[kHg * kPst + 4 * u] = mid;
        prow_s[2 * kHg * kPst + 4 * u] =
            __float2bfloat16(r1 - __bfloat162float(mid));
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      __syncwarp();
      if (q == 0) {
        const float c = expf(mo - mn);
        corr[j] = c;
        ms[j] = mn;
        ls[j] = ls[j] * c + psum;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . ckv over the warp's column pairs
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float c0 = corr[16 * mt + g], c1 = corr[16 * mt + g + 8];
#pragma unroll
      for (int j = 0; j < 2 * kNP; ++j) {
        acc[mt][j][0] *= c0;
        acc[mt][j][1] *= c0;
        acc[mt][j][2] *= c1;
        acc[mt][j][3] *= c1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t pa[3][kMT][4];          // hi, mid, lo
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          ldsm_x4(pa[t][mt], ps + (t * kHg + 16 * mt + (mat & 1) * 8 + mr) *
                                      kPst + 16 * kk + (mat >> 1) * 8);
#pragma unroll
      for (int u = 0; u < kNP; ++u) {
        const int np = warp + kWarps * u;
        if (np < npairs) {
          uint32_t vb[4];
          ldsm_x4_t(vb, kt + (16 * kk + (mat & 1) * 8 + mr) * ks + 16 * np +
                            (mat >> 1) * 8);
#pragma unroll
          for (int t = 0; t < 3; ++t)
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              mma(acc[mt][2 * u], pa[t][mt], vb[0], vb[1]);
              mma(acc[mt][2 * u + 1], pa[t][mt], vb[2], vb[3]);
            }
        }
      }
    }
  }
  cp_wait<0>();

  // 4. the block's partial: each head's m, l and f32 sums
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = 16 * mt + g + 8 * hh;
      if (j < nh) {
        float* o = a.part_acc + prow(j) * R;
#pragma unroll
        for (int u = 0; u < kNP; ++u) {
          const int np = warp + kWarps * u;
          if (np < npairs)
#pragma unroll
            for (int half = 0; half < 2; ++half)
              *reinterpret_cast<float2*>(o + 16 * np + 8 * half + 2 * t4) =
                  make_float2(acc[mt][2 * u + half][2 * hh],
                              acc[mt][2 * u + half][2 * hh + 1]);
        }
      }
    }
  if (tid < nh) {
    a.part_m[prow(tid)] = ms[tid];
    a.part_l[prow(tid)] = ls[tid];
  }
}

template <int kMT, int kNP>
int launch(const Args& a, int B, int groups, int splits, bf16* out,
           cudaStream_t st) {
  const size_t smem =
      layout(16 * kMT, a.R, a.Dr, a.stages, a.tiles_per_split).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(k_mla<kMT, kNP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return e;
  k_mla<kMT, kNP><<<dim3(splits, groups, B), kThreads, smem, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess || out == nullptr) return e;
  return dec::launch_merge<bf16>(a.H, B, splits, a.R, a.part_m, a.part_l,
                                 a.part_acc, out, st);
}

}  // namespace

// a block's shared memory in bytes, against which the host's mirror
// (decode_attention.mla_smem_bytes) is checked
extern "C" long long mla_smem_bytes(int hg, int R, int Dr, int stages,
                                    int tiles) {
  return static_cast<long long>(layout(hg, R, Dr, stages, tiles).total);
}

// hg: heads a block (a multiple of 16, at most 64); the host's plan gives
// it with the split count, the tiles a split walks and the ring's stages.
// out == nullptr: the partials alone (no k_merge)
extern "C" int mla_split_bf16(const bf16* q_abs, const bf16* q_rope,
                              const bf16* ckv, const bf16* krope,
                              const uint8_t* valid, long long mask_bs, int B,
                              int C, int H, int R, int Dr, int hg, int stages,
                              int splits, int tiles_per_split, float scale,
                              float* part_m, float* part_l, float* part_acc,
                              bf16* out, void* stream) {
  const int ntiles = (C + kRows - 1) / kRows;
  const int np = R <= 128 ? 1 : R <= 256 ? 2 : 4, mt = hg / 16;
  if (C < 1 || H < 1 || R % 16 || Dr % 16 || R < 16 || R > 512 || Dr < 16 ||
      Dr > 64 || hg % 16 || mt < 1 || mt * np > 8 || mt > 4 ||
      (stages != 2 && stages != 3) || splits < 1 || tiles_per_split < 1 ||
      static_cast<long long>(splits) * tiles_per_split < ntiles ||
      (splits - 1) * tiles_per_split >= ntiles)
    return cudaErrorInvalidValue;
  const Args a{q_abs, q_rope, ckv,   krope,  valid,           mask_bs,
               C,     H,      R,     Dr,     stages,          tiles_per_split,
               scale, part_m, part_l, part_acc, out == nullptr};
  const int groups = (H + hg - 1) / hg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (8 * mt + np) {
#define MLA_CASE(m, p) \
  case 8 * m + p:      \
    return launch<m, p>(a, B, groups, splits, out, st);
    MLA_CASE(1, 1) MLA_CASE(2, 1) MLA_CASE(3, 1) MLA_CASE(4, 1)
    MLA_CASE(1, 2) MLA_CASE(2, 2) MLA_CASE(3, 2) MLA_CASE(4, 2)
    MLA_CASE(1, 4) MLA_CASE(2, 4)
#undef MLA_CASE
  }
  return cudaErrorInvalidValue;
}
