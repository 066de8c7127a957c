// Traceback walk of the triplet (codon-context) pair-HMM over S codon blocks,
// top to bottom, with the (i, j, state) of every pair carried in and out.
//
// Replaces coati_tpu/kernels/triplet_pallas.py triplet_walk_pallas (body
// _make_walk_kernel) and the scan coati_tpu/triplet_wavefront.py
// _triplet_walk_seg_xla it stands in for. A pair enters a block at its top
// boundary: its descendant-codon lane is read from the forward's argmax
// lanes at (state, j); the block's rows are computed again for that one lane
// from the boundary below; then six phases (insertion run, down-step, three
// times) move the pair to the block's base. Row 6 t + phase of `ops` holds
// op | count << 2 for block t; rows with count 0 are skipped by the decoder,
// and are written with the reference's values all the same.
//
// What bounds it on an H100: latency, and on wide rows the instructions of
// a pass. A pair's blocks are sequential; the bytes (12 B of boundary a
// column computed again) and the ~47 operations a column are far off. The
// body before this one spent, a block, a loop of 512-column tiles of nine
// block barriers each, nine rows stored to a device scratch and read back
// by thread 0, and an insertion run's exit found by stepping left one
// dependent device read a column. This body:
//
// - One block a pair; each thread holds R adjacent columns in registers, a
//   pass R x T columns. A row's prefix maximum is a serial maximum over the
//   thread's own columns, a warp's scan by shuffles, then one barrier: the
//   warps' totals in shared memory (two buffers taken in turn), each warp
//   taking the maximum of those before it in one redux.sync (f32 maxima as
//   order-preserving ints). The same barrier hands each warp's last column
//   (M, D, and what its I is built from) to the next warp. Rows wider than
//   a pass loop over passes, carrying the maxima in registers and the last
//   column in shared memory.
// - Only what the walk reads is computed and kept. A down-step's next state
//   depends only on the (row, column) it reads, so each owner stores a 2-bit
//   code for either state it may step from, of row 2, row 1 and the boundary
//   below (phases 1, 3, 5). An insertion run's exit is a scanned index, as
//   the Pallas kernel's run_exit_cols: U[c] = the last u <= c where the
//   literal f32 test (M[u] + go) > (I[u] + ge) holds, else -1; inside a warp
//   from ballots, across warps and passes through the next row's barrier.
//   So a run's exit is one read, max(U[j - 1], 0). The third row is read
//   only by the run of phase 0, so it is computed only for a block entered
//   in state I. The last exit row of a pass (U2, or U3 when entered in I)
//   goes through the next pass's first barrier. So a pass takes two
//   barriers (three entered in I), and a block one more.
// - The codes and exit indices live in shared memory (15 B a column) over a
//   window of Wc columns up to j, the whole row where it fits (walk_shape);
//   columns left of the window go to a device scratch, read only after a run
//   that leaves the window. The next block's lane is read at this block's
//   base: warp 0 loads the three argmax rows of that boundary over the 64
//   columns up to j into shared memory during the recompute; a walk that
//   ends left of them reads the device. Thread 0 walks the six phases with
//   one shared read each.
// - The next block's first pass (its boundary, up to this block's j) is
//   loaded into registers a block ahead, the next pass of this block a pass
//   ahead.
// - The band route, for wide rows (walk_shape): a pair's passes spread over
//   a thread block cluster of up to 8 blocks, one pass a block. After each
//   row's scan the bands exchange their totals and their last column
//   through distributed shared memory across a cluster barrier (Band); the
//   last exit row's block totals alone, its bands' bases added by the
//   walker as it reads. The block whose band holds j walks, reading another
//   band's window remotely after a run that leaves its own, and puts the
//   next state into every block. A block costs four or five cluster
//   barriers, so the route wins only where a row takes more than four
//   passes on one block.
//
// A cell read is max(value, NEG), as the reference's one-hot select with
// fill NEG gives; every add keeps the reference's grouping; ties are strict
// >. A pair that has not started or has finished costs six stores a block.
// Compile with -fmad=false.

#include <cooperative_groups.h>

#include "triplet_common.cuh"

namespace {

using namespace coati_triplet;
namespace cg = cooperative_groups;

constexpr int kCost = 61 * 64;   // the entry-cost table, f32
constexpr int kXch = 6;          // a warp's slots in a scan buffer: 2 totals, 4 edge values
constexpr int kLaneWin = 64;     // columns of the next block's lanes loaded ahead
constexpr int kMaxBands = 8;     // blocks a pair at most: a portable cluster
// f32 slots before the window: the cost table, match_emit (20, padded), two
// scan buffers, the pass carry (2 passes x 2 rows x 3 values, padded), two
// band exchange slots (kXch values, padded to 8)
constexpr int kFixed = kCost + 32 + 2 * kMaxWarps * kXch + 16 + 2 * 8;
// a window column: the exit indices of rows 1-3 (int32) and the step codes
// of row 1, row 2 and the boundary (a byte each)
constexpr int kColBytes = 3 * 4 + 3;
// the scratch's rows a pair (int32): the three code rows, the three exit rows
constexpr int kScratchRows = 6;

__host__ __device__ constexpr size_t smem_bytes(int Wc) {
  return (size_t)kFixed * 4 + (size_t)Wc * kColBytes + 3 * kLaneWin;
}

__device__ __forceinline__ int amax_pref(float a, float b, float c) {
  const int code = b > a ? 1 : 0;
  return c > fmaxf(a, b) ? 2 : code;
}

// One thread's R columns of a boundary and of the sequences.
template <int R>
struct Cols {
  float M[R], D[R], I[R], off[R];
  float lM, lD, lI;  // the boundary one column left of the first
  int d[R];          // the descendant code left of each column; -1 at column 0
};

template <int R>
__device__ __forceinline__ void load_cols(Cols<R>& x, const float* bnd, size_t plane,
                                          const float* off_row, const int32_t* des_row,
                                          int c0, int jmax) {
  x.lM = x.lD = x.lI = kNeg;
  if (c0 >= 1 && c0 - 1 <= jmax) {
    x.lM = bnd[c0 - 1];
    x.lD = bnd[plane + c0 - 1];
    x.lI = bnd[2 * plane + c0 - 1];
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int c = c0 + q;
    if (c <= jmax) {
      x.M[q] = bnd[c];
      x.D[q] = bnd[plane + c];
      x.I[q] = bnd[2 * plane + c];
      x.off[q] = off_row[c];
      x.d[q] = c >= 1 ? des_row[c - 1] : -1;
    } else {
      x.M[q] = x.D[q] = x.I[q] = kNeg;
      x.off[q] = 0.0f;
      x.d[q] = -1;
    }
  }
}

// M and D of one row at this thread's columns from the row below (bM, bD,
// bI here, lM, lD, lI one column left of the first). kLast: the third row,
// which carries the lane's entry cost: core3 + (cost + e3), dmax3 + cost.
template <int R, bool kLast>
__device__ __forceinline__ void row_md(const Gap& g, int c0, const float (&bM)[R],
                                       const float (&bD)[R], const float (&bI)[R],
                                       float lM, float lD, float lI, const int (&d)[R],
                                       const float* emit_x, float cost_s, float (&M)[R],
                                       float (&D)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const float sM = q == 0 ? lM : bM[q - 1];
    const float sD = q == 0 ? lD : bD[q - 1];
    const float sI = q == 0 ? lI : bI[q - 1];
    const float e = d[q] >= 0 ? emit_x[d[q]] : 0.0f;
    const float core = shiftmax3(g, c0 + q, sM, sD, sI);
    const float dm = dmax3(g, bM[q], bD[q], bI[q]);
    if (kLast) {
      M[q] = __fadd_rn(core, __fadd_rn(cost_s, e));
      D[q] = __fadd_rn(dm, cost_s);
    } else {
      M[q] = __fadd_rn(core, e);
      D[q] = dm;
    }
  }
}

// f32 maxima as int maxima: an order-preserving key (an involution), so
// that a warp takes a maximum in one redux.sync; exact, as any tree is.
__device__ __forceinline__ int fkey(float x) {
  const int v = __float_as_int(x);
  return v ^ ((v >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float fkey_inv(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// Block-wide exclusive maximum of the threads' totals in one barrier: of
// f32 `tot` (excl: the maximum of run and every earlier thread's total;
// run takes every thread in) and of int `utot` (ubase, urun alike). With
// kEdge, lane 31 hands its last column's M, D, the maximum of M - off over
// the warp's columns left of it and off + (go - ge) to the next warp, whose
// threads return that column's M, D, the maximum its I is built from (the
// columns left of it, run included) and off + (go - ge) in edge[4]. buf
// holds kMaxWarps * kXch floats and serves every other scan.
template <bool kEdge>
__device__ __forceinline__ void block_scan(float tot, float& run, float& excl, int utot,
                                           int& urun, int& ubase, float* buf, float ex_last,
                                           float M_last, float D_last, float K_last,
                                           float (&edge)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float ninf = -INFINITY;
  float x = tot;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float y = __shfl_up_sync(kFull, x, s);
    if (lane >= s) x = fmaxf(x, y);
  }
  const float y = __shfl_up_sync(kFull, x, 1);
  const float wex = lane > 0 ? y : ninf;
  float* mine = buf + warp * kXch;
  if (lane == 31) {
    mine[0] = x;
    mine[1] = __int_as_float(utot);
    if (kEdge) {
      mine[2] = M_last;
      mine[3] = D_last;
      mine[4] = fmaxf(wex, ex_last);
      mine[5] = K_last;
    }
  }
  __syncthreads();
  const float* src = buf + lane * kXch;
  const int key = lane < nwarps ? fkey(src[0]) : fkey(ninf);
  const int none = fkey(ninf);
  const float base = fkey_inv(__reduce_max_sync(kFull, lane < warp ? key : none));
  const float all = fkey_inv(__reduce_max_sync(kFull, key));
  excl = fmaxf(fmaxf(run, base), wex);
  if (kEdge && warp > 0) {
    const float prev = fkey_inv(__reduce_max_sync(kFull, lane + 1 < warp ? key : none));
    const float* left = buf + (warp - 1) * kXch;
    edge[0] = left[2];
    edge[1] = left[3];
    edge[2] = fmaxf(fmaxf(run, prev), left[4]);
    edge[3] = left[5];
  }
  run = fmaxf(run, all);
  const int u = lane < nwarps ? __float_as_int(src[1]) : -1;
  ubase = max(urun, __reduce_max_sync(kFull, lane < warp ? u : -1));
  urun = max(urun, __reduce_max_sync(kFull, u));
}

// The band route: a pair's columns cut into bands of one pass, one block a
// band, the C blocks of a pair a thread block cluster. After a row's scan
// in each block, the block's last thread puts the band's totals and its last
// column (as block_scan's hand-over) into an exchange slot; after the
// cluster barrier every block takes the maxima of the bands before it and
// its left column from distributed shared memory. C = 1: one block a pair.
struct Band {
  int C, rank;  // blocks a pair, this block's place among them
  float* slot;  // two exchange slots of 8 floats, taken in turn
  int n;        // exchanges made
};

// After a block's scan: the band base of the f32 and the int maxima (bases
// of the bands before this one: base, folded into excl; ubase) and, with
// kEdge, the left column of a band's first (edge). mine[] is this block's
// slot: the block totals, its last column's M, D, P and K.
template <bool kEdge>
__device__ __forceinline__ void band_exchange(Band& band, float tot, int utot, float M_last,
                                              float D_last, float P_last, float K_last,
                                              float& excl, float& base, int& ubase,
                                              float (&edge)[3]) {
  cg::cluster_group cluster = cg::this_cluster();
  float* mine = band.slot + (band.n++ & 1) * 8;
  if (threadIdx.x == blockDim.x - 1) {
    mine[0] = tot;
    mine[1] = __int_as_float(utot);
    mine[2] = M_last;
    mine[3] = D_last;
    mine[4] = P_last;
    mine[5] = K_last;
  }
  cluster.sync();
  const int lane = threadIdx.x & 31;
  const float ninf = -INFINITY;
  const int none = fkey(ninf);
  const float* theirs = lane < band.C ? cluster.map_shared_rank(mine, lane) : nullptr;
  const int key = theirs ? fkey(theirs[0]) : none;
  const int u = theirs ? __float_as_int(theirs[1]) : -1;
  base = fkey_inv(__reduce_max_sync(kFull, lane < band.rank ? key : none));
  excl = fmaxf(excl, base);
  ubase = max(ubase, __reduce_max_sync(kFull, lane < band.rank ? u : -1));
  if (kEdge && band.rank > 0) {
    const float prev = fkey_inv(__reduce_max_sync(kFull, lane + 1 < band.rank ? key : none));
    const float* left = cluster.map_shared_rank(mine, band.rank - 1);
    edge[0] = left[2];
    edge[1] = left[3];
    edge[2] = __fadd_rn(fmaxf(prev, left[4]), left[5]);
  }
}

// A block-wide exclusive maximum of int thread totals alone, one barrier.
__device__ __forceinline__ void block_max(int utot, int& urun, int& ubase, float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) buf[warp * kXch + 1] = __int_as_float(utot);
  __syncthreads();
  const int u = lane < nwarps ? __float_as_int(buf[lane * kXch + 1]) : -1;
  ubase = max(urun, __reduce_max_sync(kFull, lane < warp ? u : -1));
  urun = max(urun, __reduce_max_sync(kFull, u));
}

// A row's run-exit indices inside a warp: flag[q] says whether this
// thread's column c0 + q passes the literal f32 test (M + go) > (I + ge).
// U[q] becomes the last such column of the warp at or left of c0 + q (-1
// for none); returns the warp's last (every lane alike). Ballots, no scan.
template <int R>
__device__ __forceinline__ int warp_exits(const bool (&flag)[R], int c0, int (&U)[R]) {
  const int lane = threadIdx.x & 31;
  const int wbase = c0 - lane * R;  // the warp's first column
  unsigned bits[R], any = 0;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    bits[q] = __ballot_sync(kFull, flag[q]);
    any |= bits[q];
  }
  // the last flagged column of lane l (any bit of l set in `any`)
  auto last_of = [&](int l) {
    int q2 = 0;
#pragma unroll
    for (int q = 1; q < R; ++q)
      if ((bits[q] >> l) & 1u) q2 = q;
    return wbase + l * R + q2;
  };
  const unsigned before = any & ((1u << lane) - 1u);  // lanes left of this one
  int acc = before ? last_of(31 - __clz(before)) : -1;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (flag[q]) acc = c0 + q;
    U[q] = acc;
  }
  return any ? last_of(31 - __clz(any)) : -1;
}

// Puts this thread's R exit indices: columns c >= lo of the window at
// wrow[c - lo], columns left of it at srow[c]; none beyond j. c0 - lo is a
// multiple of min(R, 4) and wrow 16-byte aligned, so a thread wholly inside
// the window stores in 8- or 16-byte pieces.
template <int R>
__device__ __forceinline__ void put(int* wrow, int* srow, const int (&v)[R], int c0, int j,
                                    int lo) {
  if constexpr (R >= 2) {
    if (c0 >= lo && c0 + R - 1 <= j) {
      int* dst = wrow + (c0 - lo);
      if constexpr (R == 2) {
        *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
      } else {
#pragma unroll
        for (int q = 0; q < R; q += 4)
          *reinterpret_cast<int4*>(dst + q) = make_int4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int c = c0 + q;
    if (c <= j) {
      if (c >= lo)
        wrow[c - lo] = v[q];
      else
        srow[c] = v[q];
    }
  }
}

// Puts this thread's R step codes: bytes in the window, int32 left of it.
template <int R>
__device__ __forceinline__ void put_codes(uint8_t* wrow, int32_t* srow, const int (&v)[R],
                                          int c0, int j, int lo) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int c = c0 + q;
    if (c <= j) {
      if (c >= lo)
        wrow[c - lo] = (uint8_t)v[q];
      else
        srow[c] = v[q];
    }
  }
}

// The down-step code of a cell: the next state from M (bits 0-1) and from D
// (bits 2-3), each cell value read as max(value, NEG).
__device__ __forceinline__ int step_code(const Gap& g, float M, float D, float I) {
  M = fmaxf(M, kNeg);
  D = fmaxf(D, kNeg);
  I = fmaxf(I, kNeg);
  const int from_m = amax_pref(__fadd_rn(M, g.ng_ng), __fadd_rn(D, g.gs), __fadd_rn(I, g.gs_ng));
  const int from_d = amax_pref(__fadd_rn(M, g.ng_go), __fadd_rn(D, g.ge), __fadd_rn(I, g.gs_go));
  return from_m | (from_d << 2);
}

template <int R>
__device__ __forceinline__ void step_codes(const Gap& g, const float (&M)[R],
                                           const float (&D)[R], const float (&I)[R],
                                           int (&code)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) code[q] = step_code(g, M[q], D[q], I[q]);
}

// Whether each of this thread's columns passes a run's exit test, the
// literal f32 (M + go) > (I + ge).
template <int R>
__device__ __forceinline__ void exit_flags(const Gap& g, const float (&M)[R],
                                           const float (&I)[R], bool (&flag)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) flag[q] = __fadd_rn(M[q], g.go) > __fadd_rn(I[q], g.ge);
}

// One row of a pass: M and D from the row below (pM, pD, pI, and lM, lD,
// lI one column left of this thread's first), the scan of M - off for I,
// and an int total carried through the same barrier (a row's warp-local
// run-exit index: ubase, runU as block_scan's). With kEdge, lM,
// lD, lI become this row's column left of the thread's first (from the lane
// before, the warp before, or the pass before: cy_in; the block's last
// thread leaves its own in cy_out).
template <int R, bool kLast, bool kEdge>
__device__ __forceinline__ void row_step(
    const Gap& g, int c0, int k, const float (&pM)[R], const float (&pD)[R],
    const float (&pI)[R], float& lM, float& lD, float& lI, const int (&d)[R],
    const float (&off)[R], const float* emit_x, float cost_s, float& runI, int utot,
    int& runU, int& ubase, float* buf, const float* cy_in, float* cy_out, Band& band,
    float (&M)[R], float (&D)[R], float (&I)[R]) {
  row_md<R, kLast>(g, c0, pM, pD, pI, lM, lD, lI, d, emit_x, cost_s, M, D);
  float ex[R], edge[4], excl;
  float acc = -INFINITY;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    ex[q] = acc;
    acc = fmaxf(acc, __fsub_rn(M[q], off[q]));
  }
  const float K_last = __fadd_rn(off[R - 1], g.go_ge);
  block_scan<kEdge>(acc, runI, excl, utot, runU, ubase, buf, ex[R - 1], M[R - 1],
                    D[R - 1], K_last, edge);
  float bedge[3], base = -INFINITY;
  if (band.C > 1)  // runI and runU are the block's totals: a band is one pass
    band_exchange<kEdge>(band, runI, runU, M[R - 1], D[R - 1], fmaxf(excl, ex[R - 1]), K_last,
                         excl, base, ubase, bedge);
#pragma unroll
  for (int q = 0; q < R; ++q) I[q] = ins_value(g, c0 + q, fmaxf(excl, ex[q]), off[q]);
  if (kEdge) {
    const int lane = threadIdx.x & 31;
    const float sM = __shfl_up_sync(kFull, M[R - 1], 1);
    const float sD = __shfl_up_sync(kFull, D[R - 1], 1);
    const float sI = __shfl_up_sync(kFull, I[R - 1], 1);
    if (lane > 0) {
      lM = sM;
      lD = sD;
      lI = sI;
    } else if (threadIdx.x > 0) {  // the warp before's, the bands before included
      lM = edge[0];
      lD = edge[1];
      lI = __fadd_rn(fmaxf(edge[2], base), edge[3]);
    } else if (band.C > 1 && band.rank > 0) {  // the band before's last column
      lM = bedge[0];
      lD = bedge[1];
      lI = bedge[2];
    } else if (k > 0) {
      lM = cy_in[0];
      lD = cy_in[1];
      lI = cy_in[2];
    } else {  // column 0 has no column to its left
      lM = lD = lI = kNeg;
    }
    if (threadIdx.x == blockDim.x - 1) {
      cy_out[0] = M[R - 1];
      cy_out[1] = D[R - 1];
      cy_out[2] = I[R - 1];
    }
  }
}

// A row's run-exit indices inside the warp (U) and the warp's last.
template <int R>
__device__ __forceinline__ int row_exits(const Gap& g, int c0, const float (&M)[R],
                                         const float (&I)[R], int (&U)[R]) {
  bool flag[R];
  exit_flags<R>(g, M, I, flag);
  return warp_exits<R>(flag, c0, U);
}

template <int R>
__device__ __forceinline__ void add_base(int (&U)[R], int ubase) {
#pragma unroll
  for (int q = 0; q < R; ++q) U[q] = max(U[q], ubase);
}

// The lane of a block whose walk enters at (j, st), and its entry cost.
struct Bind {
  int lane;
  float cost;
};

template <int R>
__global__ void __launch_bounds__(R >= 8 ? kMaxThreads / 2 : kMaxThreads)
    triplet_walk_kernel(const float* __restrict__ grid, const uint8_t* __restrict__ amax,
                        const int32_t* __restrict__ anc_seg, const int32_t* __restrict__ des,
                        const float* __restrict__ ins_off, const float* __restrict__ logP64,
                        const float* __restrict__ match_emit, const float* __restrict__ gc,
                        int32_t* __restrict__ state, int32_t* __restrict__ ops,
                        int32_t* scratch, long long* stamps, int B, int m, int S, int t_lo,
                        int Wc, int C) {
  extern __shared__ __align__(16) float wsm[];
  float* cost_tab = wsm;
  float* emit = cost_tab + kCost;
  float* xbuf = emit + 32;
  float* carry = xbuf + 2 * kMaxWarps * kXch;  // [pass & 1][row 1, 2][M D I]
  float* xband = carry + 16;                   // [2][8]: the band exchange
  int* winU = reinterpret_cast<int*>(xband + 16);              // [3][Wc]: U1 U2 U3
  uint8_t* winC = reinterpret_cast<uint8_t*>(winU + 3 * Wc);  // [3][Wc]: row 1, row 2, boundary
  uint8_t* winA = winC + 3 * Wc;                               // [3][kLaneWin]
  __shared__ int s_state[2][3];  // by block parity: (i, j, st) entering it
  __shared__ Bind s_bind[2];

  const int b = blockIdx.x / C, rank = blockIdx.x % C;  // the cluster's blocks are consecutive
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane_id = tid & 31;
  const int Cc = m + 1;
  const int RT = R * T;
  const int cb = C > 1 ? rank * RT : 0;  // the band's first column
  Band band{C, rank, xband, 0};
  // every block of the pair: the cluster barrier, which orders shared memory
  // written across it; one block a pair: __syncthreads
  auto sync_pair = [&]() {
    if (C > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };
  // a shared address of this block in block q of the pair
  auto in_block = [&](auto* p, int q) {
    return q == rank ? p : cg::this_cluster().map_shared_rank(p, q);
  };
  const Gap g = load_gap(gc);
  const size_t plane = (size_t)B * Cc;
  const size_t pair = (size_t)b * Cc;
  const float* off_row = ins_off + pair;
  const int32_t* des_row = des + (size_t)b * m;
  // the scratch's rows: codes of row 1, row 2, the boundary; U1, U2, U3
  int32_t* scr = scratch != nullptr ? scratch + (size_t)b * kScratchRows * Cc : nullptr;
  auto srow = [&](int row) { return scr != nullptr ? scr + (size_t)row * Cc : nullptr; };
  const float ninf = -INFINITY;

  for (int q = tid; q < kCost; q += T) cost_tab[q] = logP64[q];
  if (tid < 20) emit[tid] = match_emit[tid];

  auto active = [&](int t, int i, int j) { return i > 3 * (t_lo + t) && (i > 0 || j > 0); };
  // the state entering block t, into this block or (the walker) every block of the pair
  auto publish = [&](int t, int i, int j, int st, bool all) {
    for (int q = all ? 0 : rank; q < (all ? C : rank + 1); ++q) {
      int* dst = in_block(&s_state[t & 1][0], q);
      dst[0] = i;
      dst[1] = j;
      dst[2] = st;
    }
  };
  // the entry costs from `tab`: logP64 itself before the table is in shared memory
  auto bind = [&](int t, int lane, int cod, const float* tab, bool all) {
    const Bind v{lane, lane < 64 ? fmaxf(tab[cod * 64 + lane], kNeg) : kNeg};
    for (int q = all ? 0 : rank; q < (all ? C : rank + 1); ++q) *in_block(&s_bind[t & 1], q) = v;
  };
  auto lane_in_device = [&](int t, int j, int st) {
    const int s3 = st == 0 ? 0 : (st == 1 ? 1 : 2);
    return (int)amax[((size_t)t * 3 + s3) * plane + pair + j];
  };

  int i = 0, j = 0, st = 0;  // thread 0's walk state
  int neg_code = 0;          // the code of the column left of column 0: every value NEG
  if (tid == 0) {  // each block of the pair alike
    i = state[b];
    j = state[B + b];
    st = state[2 * B + b];
    neg_code = step_code(g, kNeg, kNeg, kNeg);
    publish(S - 1, i, j, st, false);
    if (active(S - 1, i, j))
      bind(S - 1, lane_in_device(S - 1, j, st), anc_seg[(size_t)b * S + S - 1], logP64, false);
  }

  Cols<R> pre;  // the next block's first pass, loaded a block ahead
  bool pre_ok = false;

  for (int t = S - 1; t >= 0; --t) {
    sync_pair();  // the block's state and bind are published; the windows are free
    const int bi = s_state[t & 1][0], bj = s_state[t & 1][1], bst = s_state[t & 1][2];
    if (tid == 0) {
      i = bi;
      j = bj;
      st = bst;
    }
    int32_t* out = ops + (size_t)6 * (t_lo + t) * B + b;  // row ph at out[ph * B]
    const float* bnd = grid + (size_t)t * 3 * plane + pair;  // M at bnd, D, I a plane on
    if (!active(t, bi, bj)) {
      // not started or finished: nothing moves, the rows carry count 0
      if (rank == 0 && tid < 6) out[(size_t)tid * B] = (tid & 1) ? bst : 2;
      if (tid == 0) {  // each block of the pair alike
        publish(t - 1, i, j, st, false);
        if (t > 0 && active(t - 1, i, j))
          bind(t - 1, lane_in_device(t - 1, j, st), anc_seg[(size_t)b * S + t - 1], cost_tab,
               false);
      }
      pre_ok = false;
      continue;
    }
    // the block whose band holds j walks
    const int walker = C > 1 ? min(bj / RT, C - 1) : 0;
    // optional: thread 0's clock at the block's start, the end of its first
    // row, the end of its passes (these three the first block of the pair's),
    // the walk's start and end
    long long* stamp = stamps != nullptr && tid == 0 ? stamps + ((size_t)b * S + t) * 5 : nullptr;
    long long* stamp0 = rank == 0 ? stamp : nullptr;
    if (stamp0) stamp0[0] = clock64();
    const Bind bd = s_bind[t & 1];
    const float* e1 = emit + ((bd.lane >> 4) & 3) * 5;
    const float* e2 = emit + ((bd.lane >> 2) & 3) * 5;
    const float* e3 = emit + (bd.lane & 3) * 5;
    const bool row3 = bst == 2;  // only the run of phase 0 reads the third row
    const int ncol = bj + 1;
    // the window's first column: on the band route the band's (a band is a
    // pass and fits the window), else the whole row where it fits
    const int lo = C > 1 ? cb : (ncol <= Wc ? 0 : ((ncol - Wc + 3) & ~3));
    const int npass = C > 1 ? 1 : (bj + RT) / RT;
    const int cod_next = tid == 0 && t > 0 ? anc_seg[(size_t)b * S + t - 1] : 0;

    Cols<R> x;  // this pass's columns
    if (pre_ok)
      x = pre;
    else
      load_cols(x, bnd, plane, off_row, des_row, cb + tid * R, bj);
    pre_ok = t > 0;
    if (pre_ok) load_cols(pre, bnd - 3 * plane, plane, off_row, des_row, cb + tid * R, bj);
    // the walker's warp 0: the next block's lanes at the kLaneWin columns up
    // to j (at distance lane and lane + 32 from j), for its bind
    int la[2][3];
    if (rank == walker && tid < 32 && t > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = bj - lane_id - 32 * h;
#pragma unroll
        for (int s = 0; s < 3; ++s)
          la[h][s] = c >= 0 ? amax[((size_t)(t - 1) * 3 + s) * plane + pair + c] : 0;
      }
    }

    float runI[3] = {ninf, ninf, ninf};
    // the exit rows' runs; the last row's (U3 entered in I, else U2) waits in
    // `pend` for the next pass's first barrier, or a barrier of its own
    int runU1 = -1, runU2 = -1, runP = -1, ub = -1;
    int pend[R], pend_tot = -1;
    const int pend_row = row3 ? 2 : 1;
    int scans = 0;
    auto buf = [&]() { return xbuf + (scans++ & 1) * kMaxWarps * kXch; };
    for (int k = 0; k < npass; ++k) {
      const int c0 = cb + k * RT + tid * R;
      Cols<R> nx;  // the next pass's, loaded a pass ahead
      if (k + 1 < npass) load_cols(nx, bnd, plane, off_row, des_row, c0 + RT, bj);
      const float* cy_in = carry + ((k + 1) & 1) * 6;
      float* cy_out = carry + (k & 1) * 6;
      float lM = x.lM, lD = x.lD, lI = x.lI;

      int code[R], U[R];
      step_codes<R>(g, x.M, x.D, x.I, code);  // read by phase 5
      put_codes<R>(winC + 2 * Wc, srow(2), code, c0, bj, lo);
      float M1[R], D1[R], I1[R], M2[R], D2[R], I2[R];
      // row 1, and the pass before's pending exit row through its barrier
      row_step<R, false, true>(g, c0, k, x.M, x.D, x.I, lM, lD, lI, x.d, x.off, e1, 0.0f,
                               runI[0], pend_tot, runP, ub, buf(), cy_in, cy_out, band, M1,
                               D1, I1);
      if (k > 0) {
        add_base<R>(pend, ub);
        put<R>(winU + pend_row * Wc, srow(3 + pend_row), pend, c0 - RT, bj, lo);
      }
      if (stamp0 && k == 0) stamp0[1] = clock64();
      step_codes<R>(g, M1, D1, I1, code);  // read by phase 3
      put_codes<R>(winC, srow(0), code, c0, bj, lo);
      // row 2, and row 1's exits (U1, read by phase 4)
      const int u1 = row_exits<R>(g, c0, M1, I1, U);
      row_step<R, false, true>(g, c0, k, M1, D1, I1, lM, lD, lI, x.d, x.off, e2, 0.0f,
                               runI[1], u1, runU1, ub, buf(), cy_in + 3, cy_out + 3, band, M2,
                               D2, I2);
      add_base<R>(U, ub);
      put<R>(winU, srow(3), U, c0, bj, lo);
      step_codes<R>(g, M2, D2, I2, code);  // read by phase 1
      put_codes<R>(winC + Wc, srow(1), code, c0, bj, lo);
      if (row3) {  // the third row (M1, D1, I1 are dead: their registers hold it)
        const int u2 = row_exits<R>(g, c0, M2, I2, U);  // U2, read by phase 2
        row_step<R, true, false>(g, c0, k, M2, D2, I2, lM, lD, lI, x.d, x.off, e3, bd.cost,
                                 runI[2], u2, runU2, ub, buf(), nullptr, nullptr, band, M1, D1,
                                 I1);
        add_base<R>(U, ub);
        put<R>(winU + Wc, srow(4), U, c0, bj, lo);
        pend_tot = row_exits<R>(g, c0, M1, I1, pend);  // U3, read by phase 0
      } else {
        pend_tot = row_exits<R>(g, c0, M2, I2, pend);  // U2, read by phase 2
      }
      x = nx;
    }
    block_max(pend_tot, runP, ub, buf());  // the last pass's pending exit row
    add_base<R>(pend, ub);  // on the band route without the bands before: see exit_at
    put<R>(winU + pend_row * Wc, srow(3 + pend_row), pend, cb + (npass - 1) * RT + tid * R, bj,
           lo);
    if (stamp0) stamp0[2] = clock64();
    if (rank == walker && tid < 32 && t > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int s = 0; s < 3; ++s) winA[s * kLaneWin + lane_id + 32 * h] = (uint8_t)la[h][s];
    }
    // the windows are written. On the band route the pending row's block
    // totals go into the exchange slot, and its cluster barrier is the last:
    // the walker adds each band's base to what it reads of that row.
    const float* pend_slot = band.slot + (band.n & 1) * 8;
    if (C > 1) {
      float* mine = band.slot + (band.n++ & 1) * 8;
      if (tid == T - 1) mine[1] = __int_as_float(runP);
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }

    if (tid == 0 && rank == walker) {
      if (stamp) stamp[3] = clock64();
      // a column's window: on the band route its band's block's, else this
      // block's from lo, the scratch left of it
      auto code_at = [&](int r, int col) {  // r: 0 row 1, 1 row 2, 2 the boundary
        if (col < 0) return neg_code;
        if (C > 1) {
          const int q = col / RT;
          return (int)in_block(winC, q)[r * Wc + col - q * RT];
        }
        return col >= lo ? (int)winC[r * Wc + col - lo] : scr[(size_t)r * Cc + col];
      };
      auto exit_at = [&](int r, int col) {  // max(U_r[col], 0); 0 left of column 0
        if (col < 0) return 0;
        if (C > 1) {
          const int q = col / RT;
          int u = in_block(winU, q)[r * Wc + col - q * RT];
          for (int p = 0; r == pend_row && p < q; ++p)  // the pending row: the bands before
            u = max(u, __float_as_int(in_block(pend_slot, p)[1]));
          return max(u, 0);
        }
        return max(col >= lo ? winU[r * Wc + col - lo] : scr[(size_t)(3 + r) * Cc + col], 0);
      };
      const int base_i = 3 * (t_lo + t);
#pragma unroll
      for (int ph = 0; ph < 6; ++ph) {
        const bool act = i > base_i && (i > 0 || j > 0);
        if ((ph & 1) == 0) {  // the insertion run at row 3 - ph / 2
          int cnt = 0;
          if (act && st == 2) {
            const int u = exit_at(2 - ph / 2, j - 1);
            cnt = j - u;
            j = u;
            st = 0;
          }
          out[(size_t)ph * B] = 2 | (cnt << 2);
        } else {  // one M or D down-step: row 2, row 1, then the boundary
          const int pj = j - (st == 0 ? 1 : 0);
          out[(size_t)ph * B] = st | ((act ? 1 : 0) << 2);
          if (act) {
            const int code = code_at(ph == 1 ? 1 : (ph == 3 ? 0 : 2), pj);
            i -= 1;
            j = pj;
            st = st == 0 ? (code & 3) : (code >> 2);
          }
        }
      }
      publish(t - 1, i, j, st, true);
      if (t > 0 && active(t - 1, i, j)) {
        const int l = bj - j;  // j only moves left
        const int s3 = st == 0 ? 0 : (st == 1 ? 1 : 2);
        bind(t - 1, l < kLaneWin ? (int)winA[s3 * kLaneWin + l] : lane_in_device(t - 1, j, st),
             cod_next, cost_tab, true);
      }
      if (stamp) stamp[4] = clock64();
    }
  }
  sync_pair();  // the state after block 0, published at parity 1
  if (tid == 0 && rank == 0) {
    state[b] = s_state[1][0];
    state[B + b] = s_state[1][1];
    state[2 * B + b] = s_state[1][2];
  }
}

template <int R>
int launch(void** args, int B, int threads, int Wc, int C, cudaStream_t stream) {
  const void* kernel = (const void*)triplet_walk_kernel<R>;
  const size_t smem = smem_bytes(Wc);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (C == 1) {
    e = cudaLaunchKernel(kernel, dim3(B), dim3(threads), args, smem, stream);
  } else {  // a cluster of C blocks a pair
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * C);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelExC(&cfg, kernel, args);
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a block takes at a window of Wc columns;
// kernels/triplet_walk.py repeats the layout (walk_smem_bytes).
extern "C" int coati_triplet_walk_smem_bytes(int Wc) { return (int)smem_bytes(Wc); }

// The most dynamic shared memory a block of the current device may take
// beside the kernel's static shared memory.
extern "C" int coati_triplet_walk_smem_limit() {
  int dev = 0, n = 0;
  cudaFuncAttributes a;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&a, (const void*)triplet_walk_kernel<1>) != cudaSuccess)
    return -1;
  return n - (int)a.sharedSizeBytes;
}

// grid [>= S, 3, B, m + 1] f32: boundary t_lo + t at row t, the base of
// block t; amax [S, 3, B, m + 1] uint8: the lanes at boundary t_lo + t + 1,
// its top; anc_seg [B, S]; state [3, B] int32 (i, j, st), updated in place;
// ops [6 * n_cod, B] int32, rows 6 t_lo .. 6 (t_lo + S) - 1 written. cols
// (R: 1, 2, 4, 8) columns a thread, threads a block (a multiple of 32, at
// most 512, 256 at R = 8), a window of Wc columns (a multiple of 4); scratch
// [B, 6, m + 1] int32 unless Wc >= m + 1, else null. bands: blocks a pair,
// 1, or up to 8 as a cluster, each band one pass (bands x cols x threads >=
// m + 1, Wc >= cols x threads, no scratch). stamps, optional: [B, S, 5]
// int64 clocks of each active block (see the kernel).
extern "C" int coati_triplet_walk(
    const void* grid, const void* amax, const void* anc_seg, const void* des,
    const void* ins_off, const void* logP64, const void* match_emit,
    const void* gc, void* state, void* ops, void* scratch, void* stamps, int B, int m,
    int S, int t_lo, int cols, int threads, int Wc, int bands, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (!block_ok(threads) || (cols >= 8 && threads > kMaxThreads / 2) || Wc < 4 || Wc % 4 ||
      bands < 1 || bands > kMaxBands ||
      (bands == 1 && Wc < m + 1 && scratch == nullptr) ||
      (bands > 1 && ((long long)bands * cols * threads < m + 1 || Wc < cols * threads)))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&grid, &amax, &anc_seg, &des,  &ins_off, &logP64, &match_emit, &gc, &state,
                  &ops,  &scratch, &stamps, &B, &m, &S, &t_lo, &Wc, &bands};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 1: return launch<1>(args, B, threads, Wc, bands, st);
    case 2: return launch<2>(args, B, threads, Wc, bands, st);
    case 4: return launch<4>(args, B, threads, Wc, bands, st);
    case 8: return launch<8>(args, B, threads, Wc, bands, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
