// Marginal Gotoh M/D/I Viterbi fill with packed backpointers, or score-only:
// each pair's columns cut into strips, one strip a lane, swept row by row
// with a skew in place of a barrier.
//
// Replaces the TPU kernels coati_tpu/kernels/wavefront_pallas.py:330
// wavefront_pallas (mode="viterbi", want_bp=True) and :704
// wavefront_pallas_stacked. Both meet one contract pair by pair, and so does
// this kernel: the f32 M/D/I cells of coati_tpu/align/wavefront.py
// wavefront_impl, the backpointer byte of every cell of the pair's
// (la+k) x (lb+k) matrix, and the terminal-adjusted corner scores. The
// one-hot emission and the diagonal stacking of the TPU kernels exist for
// the TPU's slow gathers and lane width and are not carried over.
//
// The body is shared by two sources: wavefront_fill.cu builds it for the
// whole matrix (the main path's fill and the score-only body), and
// wavefront_fill_long.cu for the long path's two passes over rows (kCkpt,
// below).
//
// Score-only (entry point coati_wavefront_fill_score) replaces
// wavefront_pallas with want_bp=False for k <= 8: the same body, compiled
// with kBp = false, keeps no stack and stores only the corners; its state is
// the lanes' registers, the warp rings and, when stripes leave a block, the
// edge buffer, O(NA) a block boundary. A larger k takes the sweep
// (csrc/wavefront_segment.cu coati_wavefront_score).
//
// What bounds it on an H100: the dependence of a cell on (i-1, j-1),
// (i-k, j) and (i, j-k). A sweep by anti-diagonals pays one block barrier a
// diagonal (about 1 us at 256 threads, 2,111 of them for a 1,056-slot pair),
// idles threads where diagonals are short and keeps the ring of diagonals in
// shared memory. This kernel has none of that:
//
// - Strips and skew. A pair's columns are cut into stripes of 32 W columns,
//   a stripe a warp, and each stripe into 32 strips of W columns, a strip a
//   lane. Lane l walks its strip row by row, one row behind lane l - 1; warp
//   w runs behind warp w - 1 as far as the rows it waits for. Every cell's
//   predecessors are then either the lane's own or those its left
//   neighbour finished a step before, so no barrier is needed.
// - Registers. The lane keeps the last K rows of its W columns (M, D, I) in
//   registers: they give (i-k, j) and, inside the strip, (i-1, j-1) and
//   (i, j-k). K = k is a template argument, so the row slots are fixed
//   registers once the row loop is unrolled by K (row t of lane l in slot
//   t % K, t = i + l).
// - Lane to lane. The left strip's last k columns of the current row (M, I)
//   and its last column's D come by __shfl_up_sync; the same values of the
//   row before give (i-1, j0-1).
// - Warp to warp. Lane 31 of warp w - 1 writes those 2k+1 floats of each row
//   into a ring of kRingRows rows in shared memory and counts them in a
//   progress counter every kBatch rows. Warp w takes them kBatch rows at a
//   time into registers (lane q < kBatch holds row tb + q; lane 0 reads its
//   row from there by __shfl_sync), fetching the next batch while it uses
//   one, kAhead rows ahead of lane 0, and counts what it took, which the
//   producer reads before it overwrites a slot. So a warp polls a counter
//   once every kBatch rows, not every row, for a skew of kAhead more rows a
//   warp.
// - Stripes beyond the block. When a pair has more stripes than its warps
//   (warps_per_pair x blocks_per_pair), the warps loop over them in passes.
//   The stripe edge that leaves a block (its last warp's), for a later pass
//   or for the next block of the pair, goes to a per-pair scratch in device
//   memory, edge [B, blocks_per_pair, NA + k, 2k + 1], one entry a row, with
//   a release counter in device memory every kBatch rows. A row's
//   entry is overwritten only by the same stripe boundary one pass later,
//   after its reader has taken it (the reader's row precedes it in the
//   dependence chain). Several blocks a pair wait on each other, so such a
//   launch is cooperative.
// - Emission. The descendant's codes of a strip are held per lane in
//   registers, the ancestor's code of the row read once a row (the lanes of
//   a warp read consecutive rows: one transaction), the table in shared
//   memory when it fits, else from device memory; the W emissions of a
//   lane's next row are loaded while it computes this one.
// - Backpointers in row layout, bp [B, NA + k, Cp] with cell (i, j) at
//   [p, i, j] and Cp = NB + k rounded up to 16: a lane stores its row's W
//   bytes in one 4, 8 or 16-byte store; a 32-byte sector of a row is
//   written by neighbouring lanes in neighbouring steps, so the L2 merges it
//   before it leaves. The stack is (NA + k) x Cp bytes a pair, about half the
//   diagonal layout's (NA + NB + 2k - 1) x (NB + k).
//
// What is left is the cells' own work, about 40 instructions a cell, and a
// skew of 32 rows a warp at the ends of each pass.
//
// Numerics: bit-equal to the XLA:CPU reference. Every cell goes through
// common.cuh's cell_compute, shared with the sweep kernels; the traversal
// does not change a value, since a cell depends only on its predecessors.
//
// The long path (kCkpt = 1; align/longseq.py), for a pair whose stack
// passes the device's budget, in place of the TPU's segments of diagonals
// (coati_tpu/kernels/wavefront_pallas.py:909 wavefront_pallas_segment):
//
// - Pass 1, score-only (kBp = false): the same sweep, and each lane also
//   stores its W columns of M, D and I of the k rows above every band
//   boundary r0 = b x band_rows, b = 1 .. n_ckpt, as it passes them: ckpt
//   [n_ckpt, B, k, 3, Cp] f32, rows r0 - k .. r0 - 1 of band b at [b - 1,
//   p, 0 .. k-1] (band 0 starts at the top boundary and has none). float4
//   stores, one a lane and 4 columns, a few rows in every band_rows.
// - Pass 2, with backpointers (kBp = true): rows [row0, row0 + band_rows)
//   only, bp [B, band_rows, Cp] with cell (i, j) at [p, i - row0, j]. Each
//   lane starts every stripe from the checkpoint in place of the top
//   boundary: its k register rows (row r0 - k + q in slot (lane + q) % k,
//   where the row loop would have left it), its own edge of row r0 - 1 and
//   its left neighbour's. Row indices stay absolute, so the margins, the
//   emissions and every cell are computed as in the whole sweep; the edge
//   buffer holds the band's rows. Only the cells a band computes read the
//   checkpoint, and only a pair with rows in the band runs.
//
// kCkpt is an int, not a bool, so that the device trace names pass 1 with
// the score-only body ("false, 1") and pass 2 with the fill ("true, 1").
//
// Layout: aseq [B, NA] int32 (< rows), bseq [B, NB] int32 (< 16), lens [B]
// int32, table [table_len / 15, 15] f32, gap_consts [4] f32 = (ng, gs, go,
// ge). bp as above (null when score-only); only the cells of each pair's true (la+k) x (lb+k)
// matrix are defined (the bytes of a strip past the pair's last column, up
// to Cp, are written with what those columns computed). corners [3, B]
// terminal-adjusted. edge and gprog ([B, blocks_per_pair] int32 zeros) are
// needed only when a pair's stripes leave a block, else null.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

using coati::kLowest;

constexpr int kRingRows = 64;  // rows of a warp boundary's ring
// rows of a stripe edge a reader takes at once, and a writer counts at once
constexpr int kBatch = 8;
constexpr int kAhead = 2 * kBatch;  // rows a reader waits for beyond its own
constexpr long long kStallCycles = 2000000000LL;  // about a second

// Threads a block may have for strips of W columns at gap length K: about
// 6 K W + 2 W + 60 registers a thread (K = 1, W = 8 takes 127), within
// 65,536 / threads. kernels/wavefront_fill.py max_threads repeats it.
constexpr int max_threads(int K, int W) {
  return 6 * K * W + 2 * W + 60 <= 64    ? 1024
         : 6 * K * W + 2 * W + 60 <= 128 ? 512
                                         : 256;
}

struct FillArgs {
  const int32_t *aseq, *bseq, *lens_a, *lens_b;
  const float *table, *gap;
  uint8_t* bp;  // null when score-only
  float* corners;
  float* edge;  // [B, blocks_per_pair, NA + k, 2k + 1], or null
  int* gprog;   // [B, blocks_per_pair] zeros, or null
  int B, NA, NB, Cp, table_len, table_shared;
  int warps_per_pair, pairs_per_block, blocks_per_pair;
  // kCkpt: the checkpoint (pass 1 writes [n_ckpt, B, K, 3, Cp], pass 2
  // reads one band's [B, K, 3, Cp]; null for the band at row 0), the band
  // height, and pass 2's first row
  float* ckpt;
  int band_rows, n_ckpt, row0;
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Spins until the shared counter reaches target; returns what it read.
__device__ __forceinline__ int wait_shared(const volatile int* flag, int target) {
  int now = *flag;
  const long long t0 = clock64();
  while (now < target) {
    if (clock64() - t0 > kStallCycles) __trap();
    now = *flag;
  }
  __threadfence_block();
  return now;
}

// Spins until the device-memory counter reaches target; `seen` is the value
// read before. Traps when it has not moved for about a second.
__device__ __forceinline__ int wait_global(const int* flag, int target, int seen) {
  long long t0 = clock64();
  while (seen < target) {
    const int now = load_acquire(flag);
    if (now != seen) {
      seen = now;
      t0 = clock64();
    } else if (clock64() - t0 > kStallCycles) {
      __trap();
    }
  }
  return seen;
}

// A row's W backpointer bytes, in one store.
template <int W>
__device__ __forceinline__ void store_codes(uint8_t* dst, const uint32_t (&w)[W / 4]) {
  if constexpr (W == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  } else if constexpr (W == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// kBp: store the backpointers (bp), else the corners only. kCkpt = 1: the
// long path's pass 1 (kBp = false) or pass 2 (kBp = true).
template <int K, int W, bool kBp, int kCkpt = 0>
__global__ void __launch_bounds__(max_threads(K, W))
    strip_fill_kernel(const FillArgs x) {
  static_assert(K >= 1 && W >= K && W % 4 == 0, "strips of W >= K columns");
  static_assert(kCkpt == 0 || kCkpt == 1, "kCkpt is 0 or 1");
  constexpr bool kBand = kBp && kCkpt;    // pass 2: one band of rows
  constexpr bool kStore = !kBp && kCkpt;  // pass 1: store the checkpoints
  constexpr int E = 2 * K + 1;  // a row's edge: M, I of the last K columns, D of the last
  extern __shared__ float smem[];
  const int NW = x.warps_per_pair;
  const int NBK = x.blocks_per_pair;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / NW, w = warp % NW;
  const int blk = blockIdx.x % NBK;
  const int p = (blockIdx.x / NBK) * x.pairs_per_block + group;
  const int n_warps = blockDim.x >> 5;

  const float* __restrict__ tab = x.table;
  float* rings = smem;
  if (x.table_shared) {
    for (int q = threadIdx.x; q < x.table_len; q += blockDim.x) smem[q] = x.table[q];
    tab = smem;
    rings = smem + ((x.table_len + 3) & ~3);
  }
  // rings [warps][kRingRows][E]; counters of rows published and taken
  volatile int* sprog = reinterpret_cast<int*>(rings + (size_t)n_warps * kRingRows * E);
  volatile int* scons = sprog + n_warps;
  if (threadIdx.x < n_warps) {
    sprog[threadIdx.x] = 0;
    scons[threadIdx.x] = 0;
  }
  __syncthreads();
  if (p >= x.B) return;

  const coati::Gap g = coati::load_gap(x.gap, K);
  const int rows = x.lens_a[p] + K;  // true matrix: 0 <= i < rows
  const int cols = x.lens_b[p] + K;  //              0 <= j < cols
  const int lb = x.lens_b[p];
  // this launch's rows: r0 .. r0 + nrows - 1 (the whole matrix, or a band);
  // the loop runs on relative rows ir = i - r0, the cells on absolute ones
  const int r0 = kBand ? x.row0 : 0;
  const int nrows = kBand ? min(rows, r0 + x.band_rows) - r0 : rows;
  if (kBand && nrows <= 0) return;  // a pair that ends above the band
  const int32_t* a = x.aseq + (size_t)p * x.NA;
  const int32_t* b = x.bseq + (size_t)p * x.NB;
  const int R_all = kBand ? x.band_rows : x.NA + K;  // rows of an edge buffer and of bp
  float* ring_in = rings + (size_t)(warp - 1) * kRingRows * E;  // from warp w - 1
  float* ring_out = rings + (size_t)warp * kRingRows * E;       // to warp w + 1
  float* edge_out = x.edge ? x.edge + ((size_t)p * NBK + blk) * R_all * E : nullptr;
  const int src_blk = blk == 0 ? NBK - 1 : blk - 1;  // block of stripe s - 1
  const float* edge_in = x.edge ? x.edge + ((size_t)p * NBK + src_blk) * R_all * E : nullptr;
  int* gprog_out = x.gprog ? x.gprog + (size_t)p * NBK + blk : nullptr;
  const int* gprog_in = x.gprog ? x.gprog + (size_t)p * NBK + src_blk : nullptr;

  const int SW = 32 * W;  // columns of a stripe
  const int nstripes = (cols + SW - 1) / SW;
  const int U = NBK * NW;  // workers of the pair
  int gseen = 0;  // the left block's counter as last read (lane 0)
  int pseen = 0;  // the left warp's counter as last read (lane 0)
  int cseen = 0;  // the right warp's count of rows taken as last read (lane 31)

  for (int s = blk * NW + w, ps = 0; s < nstripes; s += U, ++ps) {
    const int base = ps * nrows;  // rows of the earlier passes: counters run on
    const int j_base = s * SW + lane * W;
    // this stripe's left edge comes from warp w - 1 (shared ring) or from a
    // block's last warp (edge buffer); its right edge goes to warp w + 1 or
    // to the edge buffer, if there is a stripe to its right
    const bool from_ring = s > 0 && w > 0;
    const bool has_left = s > 0;
    const int src_base = (blk == 0 ? ps - 1 : ps) * nrows;
    const bool to_ring = s + 1 < nstripes && w + 1 < NW;
    const bool to_edge = s + 1 < nstripes && w + 1 == NW;

    int bc[W];  // the strip's descendant codes, 15 (no emission) off the pair
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const int jb = j_base + c - K;
      bc[c] = (jb >= 0 && jb < lb) ? __ldg(b + jb) : 15;
    }
    float rM[K][W], rD[K][W], rI[K][W];  // row t of the lane in slot t % K
#pragma unroll
    for (int q = 0; q < K; ++q)
#pragma unroll
      for (int c = 0; c < W; ++c) rM[q][c] = rD[q][c] = rI[q][c] = kLowest;
    float lM[K], lI[K], lD = kLowest;  // the left strip's edge of this row
    float eM[K], eI[K], eD = kLowest;  // this strip's edge of the last row
    // the left stripe's edges, kBatch rows at a time: lane q < kBatch holds
    // row tb + q of the current batch (c*) and of the next one (n*)
    float cM[K], cI[K], cD = kLowest, nM[K], nI[K], nD = kLowest;
#pragma unroll
    for (int q = 0; q < K; ++q)
      lM[q] = lI[q] = eM[q] = eI[q] = cM[q] = cI[q] = nM[q] = nI[q] = kLowest;
    if constexpr (kBand) {
      if (r0 > 0) {
        // the rows above the band from the checkpoint [K][3][Cp] of the
        // pair: row r0 - K + q in slot (lane + q) % K, as the row loop
        // would have left it; this lane's edge of row r0 - 1 and its left
        // neighbour's, as the steps before would have left them
        const float* ck = x.ckpt + (size_t)p * K * 3 * x.Cp;
        auto at = [&](int q, int st, int j) {
          return j >= 0 && j < x.Cp ? __ldg(ck + ((size_t)q * 3 + st) * x.Cp + j) : kLowest;
        };
#pragma unroll
        for (int sl = 0; sl < K; ++sl) {
          const int q = (sl - lane % K + K) % K;
#pragma unroll
          for (int c = 0; c < W; ++c) {
            rM[sl][c] = at(q, 0, j_base + c);
            rD[sl][c] = at(q, 1, j_base + c);
            rI[sl][c] = at(q, 2, j_base + c);
          }
        }
#pragma unroll
        for (int q = 0; q < K; ++q) {
          lM[q] = at(K - 1, 0, j_base - K + q);
          lI[q] = at(K - 1, 2, j_base - K + q);
          eM[q] = at(K - 1, 0, j_base + W - K + q);
          eI[q] = at(K - 1, 2, j_base + W - K + q);
        }
        lD = at(K - 1, 1, j_base - 1);
        eD = at(K - 1, 1, j_base + W - 1);
      }
    }

    // rows [0, n) of the left stripe's edge are there (lane 0 waits)
    auto wait_rows = [&](int n) {
      if (lane == 0) {
        if (from_ring) {
          if (pseen < base + n) pseen = wait_shared(sprog + warp - 1, base + n);
        } else if (gseen < src_base + n) {
          gseen = wait_global(gprog_in, src_base + n, gseen);
        }
      }
      __syncwarp();
    };
    // rows rb .. rb + kBatch - 1 into n*
    auto load_batch = [&](int rb) {
      const int row = rb + lane;
      if (lane < kBatch && row < nrows) {
        if (from_ring) {
          const volatile float* src = ring_in + (size_t)((base + row) % kRingRows) * E;
#pragma unroll
          for (int q = 0; q < K; ++q) {
            nM[q] = src[q];
            nI[q] = src[K + q];
          }
          nD = src[2 * K];
        } else {
          const float* src = edge_in + (size_t)row * E;
#pragma unroll
          for (int q = 0; q < K; ++q) {
            nM[q] = __ldcg(src + q);
            nI[q] = __ldcg(src + K + q);
          }
          nD = __ldcg(src + 2 * K);
        }
      }
    };
    if (has_left) {
      wait_rows(min(kBatch, nrows));
      load_batch(0);
    }
    // the emissions of the next row a lane computes, loaded a step ahead
    float sub[W];
    auto load_sub = [&](int row) {
      const int arow = row >= K && row < rows ? __ldg(a + row - K) * 15 : -1;
#pragma unroll
      for (int c = 0; c < W; ++c)
        sub[c] = (arow >= 0 && j_base + c >= K && bc[c] < 15) ? tab[arow + bc[c]] : 0.0f;
    };
    load_sub(r0);  // every lane's first row
    // kStore: row i is checkpoint row ck_q of band ck_b when (i + K) = ck_b x
    // band_rows + ck_q, ck_q < K (then ck_b >= 1, since i >= 0; its slot is
    // ck_b - 1); a lane's rows come one after another, so the two advance
    // with them
    int ck_q = kStore ? K % x.band_rows : 0, ck_b = kStore ? K / x.band_rows : 0;

    const int n_steps = nrows + 31;
    for (int t0 = 0; t0 < n_steps; t0 += K) {
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const int t = t0 + r;
        const int ir = t - lane;  // this lane's row, relative and absolute
        const int i = r0 + ir;
        const bool live = ir >= 0 && ir < nrows;
        if (has_left && (t & (kBatch - 1)) == 0 && t < nrows) {
          // the next batch becomes the current one; its rows' ring slots are
          // free once it is in registers; the batch after is fetched while
          // this one is used, kAhead rows ahead of lane 0
#pragma unroll
          for (int q = 0; q < K; ++q) {
            cM[q] = nM[q];
            cI[q] = nI[q];
          }
          cD = nD;
          __syncwarp();
          if (from_ring && lane == 0) {
            __threadfence_block();
            scons[warp] = base + min(t + kBatch, nrows);
          }
          if (t + kBatch < nrows) {
            wait_rows(min(t + kAhead, nrows));
            load_batch(t + kBatch);
          }
        }
        // (i-1, j_base-1): the left strip's last column of the row before
        const float pM = lM[K - 1], pI = lI[K - 1], pD = lD;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          lM[q] = __shfl_up_sync(0xffffffffu, eM[q], 1);
          lI[q] = __shfl_up_sync(0xffffffffu, eI[q], 1);
        }
        lD = __shfl_up_sync(0xffffffffu, eD, 1);
        if (has_left) {  // lane 0 takes row t of the left stripe's edge
          const int src_lane = t & (kBatch - 1);
#pragma unroll
          for (int q = 0; q < K; ++q) {
            const float m = __shfl_sync(0xffffffffu, cM[q], src_lane);
            const float v = __shfl_sync(0xffffffffu, cI[q], src_lane);
            if (lane == 0) {
              lM[q] = m;
              lI[q] = v;
            }
          }
          const float d = __shfl_sync(0xffffffffu, cD, src_lane);
          if (lane == 0) lD = d;
        }
        if (live) {
          float cur_sub[W];
#pragma unroll
          for (int c = 0; c < W; ++c) cur_sub[c] = sub[c];
          load_sub(i + 1);
          uint32_t words[W / 4];
#pragma unroll
          for (int q = 0; q < W / 4; ++q) words[q] = 0;
          // the row's cells; kRowBody: i >= K, so every cell c >= K (j >= K
          // too) has all its predecessors inside the matrix, and the row is
          // one straight run of code
          auto cells = [&](auto row_body) {
            constexpr bool kRowBody = decltype(row_body)::value;
            float oM = pM, oD = pD, oI = pI;  // (i-1, j-1) of the next column, K = 1
#pragma unroll
            for (int c = 0; c < W; ++c) {
              const int j = j_base + c;
              float dM, dD, dI;  // (i-1, j-1)
              if (c == 0) {
                dM = pM; dD = pD; dI = pI;
              } else if (K == 1) {
                dM = oM; dD = oD; dI = oI;
              } else {
                dM = rM[(r + K - 1) % K][c - 1];
                dD = rD[(r + K - 1) % K][c - 1];
                dI = rI[(r + K - 1) % K][c - 1];
              }
              const float kM = rM[r][c], kD = rD[r][c], kI = rI[r][c];  // (i-k, j)
              const float sM = c >= K ? rM[r][c >= K ? c - K : 0] : lM[c < K ? c : 0];
              const float sI = c >= K ? rI[r][c >= K ? c - K : 0] : lI[c < K ? c : 0];
              float M, D, I;
              uint8_t code;
              if (kRowBody && c >= K) {
                code = coati::cell_compute<false, true>(
                    i, j, K, dM, dD, dI, kM, kD, kI, sM, sI, cur_sub[c], g, M, D, I);
              } else {
                code = coati::cell_compute<false, false>(
                    i, j, K, dM, dD, dI, kM, kD, kI, sM, sI, cur_sub[c], g, M, D, I);
              }
              if (K == 1) {
                oM = kM; oD = kD; oI = kI;
              }
              rM[r][c] = M;
              rD[r][c] = D;
              rI[r][c] = I;
              if constexpr (kBp)
                words[c / 4] |= (uint32_t)code << (8 * (c % 4));
              else
                (void)code;
            }
          };
          if (i >= K)
            cells(std::true_type{});
          else
            cells(std::false_type{});
          if (!kBand && i == rows - 1) {  // the corner, if this strip holds it
            const int corner_c = cols - 1 - j_base;
#pragma unroll
            for (int c = 0; c < W; ++c) {
              if (c == corner_c) {
                x.corners[p] = __fadd_rn(__fadd_rn(rM[r][c], g.ng), g.ng);
                x.corners[x.B + p] = __fadd_rn(rD[r][c], g.gs);
                x.corners[2 * x.B + p] = __fadd_rn(__fadd_rn(rI[r][c], g.gs), g.ng);
              }
            }
          }
          if constexpr (kBp) {
            if (j_base < cols)
              store_codes<W>(x.bp + ((size_t)p * R_all + ir) * x.Cp + j_base, words);
          }
          if constexpr (kStore) {
            if (ck_q < K && ck_b <= x.n_ckpt) {
              float* dst = x.ckpt + (((size_t)(ck_b - 1) * x.B + p) * K + ck_q) * 3 * x.Cp + j_base;
#pragma unroll
              for (int c = 0; c < W; c += 4) {
                if (j_base + c < x.Cp) {  // Cp and j_base are multiples of 4
                  *reinterpret_cast<float4*>(dst + c) =
                      make_float4(rM[r][c], rM[r][c + 1], rM[r][c + 2], rM[r][c + 3]);
                  *reinterpret_cast<float4*>(dst + x.Cp + c) =
                      make_float4(rD[r][c], rD[r][c + 1], rD[r][c + 2], rD[r][c + 3]);
                  *reinterpret_cast<float4*>(dst + 2 * x.Cp + c) =
                      make_float4(rI[r][c], rI[r][c + 1], rI[r][c + 2], rI[r][c + 3]);
                }
              }
            }
            if (++ck_q == x.band_rows) {
              ck_q = 0;
              ++ck_b;
            }
          }
#pragma unroll
          for (int q = 0; q < K; ++q) {
            eM[q] = rM[r][W - K + q];
            eI[q] = rI[r][W - K + q];
          }
          eD = rD[r][W - 1];
          if (lane == 31 && to_ring) {
            const int gi = base + ir;
            if (cseen < gi - kRingRows + 1)
              cseen = wait_shared(scons + warp + 1, gi - kRingRows + 1);
            volatile float* dst = ring_out + (size_t)(gi % kRingRows) * E;
#pragma unroll
            for (int q = 0; q < K; ++q) {
              dst[q] = eM[q];
              dst[K + q] = eI[q];
            }
            dst[2 * K] = eD;
            if ((ir + 1) % kBatch == 0 || ir == nrows - 1) {  // readers take batches
              __threadfence_block();
              sprog[warp] = gi + 1;
            }
          } else if (lane == 31 && to_edge) {
            float* dst = edge_out + (size_t)ir * E;
#pragma unroll
            for (int q = 0; q < K; ++q) {
              __stcg(dst + q, eM[q]);
              __stcg(dst + K + q, eI[q]);
            }
            __stcg(dst + 2 * K, eD);
            if ((ir + 1) % kBatch == 0 || ir == nrows - 1)
              store_release(gprog_out, base + ir + 1);
          }
        }
      }
    }
  }
}

template <int K, int W, bool kBp, int kCkpt>
int launch(const FillArgs& x, int threads, cudaStream_t stream) {
  if (threads > max_threads(K, W)) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)strip_fill_kernel<K, W, kBp, kCkpt>;
  const int n_warps = threads / 32;
  const size_t smem =
      (x.table_shared ? (size_t)((x.table_len + 3) & ~3) * sizeof(float) : 0) +
      (size_t)n_warps * kRingRows * (2 * K + 1) * sizeof(float) +
      2 * (size_t)n_warps * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_groups = (x.B + x.pairs_per_block - 1) / x.pairs_per_block;
  const dim3 grid(n_groups * x.blocks_per_pair);
  if (x.blocks_per_pair > 1) {  // blocks of a pair wait on each other
    void* args[] = {const_cast<FillArgs*>(&x)};
    const cudaError_t e = cudaLaunchCooperativeKernel(kernel, grid, dim3(threads),
                                                      args, smem, stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  strip_fill_kernel<K, W, kBp, kCkpt><<<grid, threads, smem, stream>>>(x);
  return (int)cudaGetLastError();
}

// The (k, W) pairs the kernel is built for; kernels/wavefront_fill.py
// STRIP_WIDTHS (with bp) and SCORE_WIDTHS (score-only) repeat them, for the
// whole matrix and for the long path's passes alike. The score-only body is
// built for the widths its shape rule picks: 4, 8 and 16 at k = 1, one
// width above.
template <int K, bool kBp, int kCkpt>
int launch_w(const FillArgs& x, int W, int threads, cudaStream_t s) {
  switch (W) {
    case 4:
      if constexpr (K <= 4) return launch<K, 4, kBp, kCkpt>(x, threads, s);
      break;
    case 8:
      if constexpr (kBp ? (K <= 2 || K >= 5) : (K == 1 || K >= 5))
        return launch<K, 8, kBp, kCkpt>(x, threads, s);
      break;
    case 16:
      if constexpr (kBp ? K <= 2 : K == 1) return launch<K, 16, kBp, kCkpt>(x, threads, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kBp, int kCkpt>
int fill_entry(const FillArgs& x, int k, int W, void* stream) {
  if (x.B == 0) return 0;
  const int threads = 32 * x.warps_per_pair * x.pairs_per_block;
  if (x.warps_per_pair < 1 || x.pairs_per_block < 1 || x.blocks_per_pair < 1 ||
      threads > 1024 || ((kBp || kCkpt) && (x.Cp % 16 != 0 || x.Cp < x.NB + k)) ||
      x.table_len < 1 || (x.blocks_per_pair > 1 && x.pairs_per_block != 1) ||
      ((x.edge == nullptr) != (x.gprog == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (kCkpt && (x.band_rows < k ||
                (!kBp && (x.n_ckpt < 0 || (x.n_ckpt > 0 && x.ckpt == nullptr))) ||
                (kBp && (x.row0 < 0 || (x.row0 > 0 && x.ckpt == nullptr)))))
    return (int)cudaErrorInvalidValue;
  // a pair's stripes must stay within its warps unless the edge buffer is given
  const int stripes = (x.NB + k + 32 * W - 1) / (32 * W);
  if (x.edge == nullptr && (x.blocks_per_pair > 1 || stripes > x.warps_per_pair))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_w<1, kBp, kCkpt>(x, W, threads, s);
    case 2: return launch_w<2, kBp, kCkpt>(x, W, threads, s);
    case 3: return launch_w<3, kBp, kCkpt>(x, W, threads, s);
    case 4: return launch_w<4, kBp, kCkpt>(x, W, threads, s);
    case 5: return launch_w<5, kBp, kCkpt>(x, W, threads, s);
    case 6: return launch_w<6, kBp, kCkpt>(x, W, threads, s);
    case 7: return launch_w<7, kBp, kCkpt>(x, W, threads, s);
    case 8: return launch_w<8, kBp, kCkpt>(x, W, threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
