// Shared helpers of the triplet (codon-context pair-HMM) kernels: the gap
// composites, the two row operators, and the two block-wide primitives a row
// sweep needs with one column a thread: the prefix maximum along the row and
// the value of the column to the left. Both carry across tiles, so a row of
// any width goes through one block a tile of blockDim.x columns at a time.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace coati_triplet {

constexpr float kNeg = -1.0e30f;  // the reference's NEG: "unreachable"
constexpr int kMaxThreads = 512;  // the most threads a block is launched with
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Gap constants and their sums, each sum formed once in f32 as the reference
// forms it (coati_tpu/kernels/triplet_pallas.py:74-78).
struct Gap {
  float gs, go, ge, ng_ng, gs_ng, ng_go, gs_go, go_ge;
};

__device__ __forceinline__ Gap load_gap(const float* __restrict__ gc) {
  const float ng = gc[0];
  Gap g;
  g.gs = gc[1];
  g.go = gc[2];
  g.ge = gc[3];
  g.ng_ng = __fadd_rn(ng, ng);
  g.gs_ng = __fadd_rn(g.gs, ng);
  g.ng_go = __fadd_rn(ng, g.go);
  g.gs_go = __fadd_rn(g.gs, g.go);
  g.go_ge = __fsub_rn(g.go, g.ge);
  return g;
}

__device__ __forceinline__ float max3(float a, float b, float c) {
  return fmaxf(fmaxf(a, b), c);
}

// Match core at column j from the row below's values at column j - 1.
__device__ __forceinline__ float shiftmax3(const Gap& g, int j, float sM,
                                           float sD, float sI) {
  return j < 1 ? kNeg
               : max3(__fadd_rn(sM, g.ng_ng), __fadd_rn(sD, g.gs),
                      __fadd_rn(sI, g.gs_ng));
}

__device__ __forceinline__ float dmax3(const Gap& g, float M, float D, float I) {
  return max3(__fadd_rn(M, g.ng_go), __fadd_rn(D, g.ge), __fadd_rn(I, g.gs_go));
}

// The in-row insertion value at column j from the exclusive prefix maximum
// of M - off: run + (off + (go - ge)), the reference's grouping; NEG at 0.
__device__ __forceinline__ float ins_value(const Gap& g, int j, float excl,
                                           float off) {
  return j < 1 ? kNeg : __fadd_rn(excl, __fadd_rn(off, g.go_ge));
}

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return a > b ? a : b; }

// Exclusive prefix maximum over the block's columns, N rows at once.
// In: v[a] this thread's value, run[a] the maximum over every column of the
// earlier tiles (`identity` before the first). Out: v[a] the maximum over
// all columns left of this thread's, earlier tiles included (`identity` for
// the very first column); run[a] takes this tile in. Maxima are exact, so
// any tree gives the sequential scan's bits. sh holds N * kMaxWarps values;
// the caller puts a __syncthreads between two uses of it.
template <typename T, int N>
__device__ __forceinline__ void scan_excl_max(T (&v)[N], T (&run)[N], T* sh,
                                              T identity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T incl[N];
#pragma unroll
  for (int a = 0; a < N; ++a) {
    T x = v[a];
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const T y = __shfl_up_sync(kFull, x, s);
      if (lane >= s) x = vmax(x, y);
    }
    incl[a] = x;
    if (lane == 31) sh[a * kMaxWarps + warp] = x;
  }
  __syncthreads();
  for (int a = warp; a < N; a += nwarps) {  // a warp scans one row's totals
    T x = lane < nwarps ? sh[a * kMaxWarps + lane] : identity;
#pragma unroll
    for (int s = 1; s < kMaxWarps; s <<= 1) {
      const T y = __shfl_up_sync(kFull, x, s);
      if (lane >= s) x = vmax(x, y);
    }
    if (lane < nwarps) sh[a * kMaxWarps + lane] = x;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < N; ++a) {
    T base = run[a];
    if (warp > 0) base = vmax(base, sh[a * kMaxWarps + warp - 1]);
    const T left = __shfl_up_sync(kFull, incl[a], 1);
    v[a] = lane > 0 ? vmax(left, base) : base;
    run[a] = vmax(run[a], sh[a * kMaxWarps + nwarps - 1]);
  }
}

// Each thread's left neighbour's values of three groups of rows (NA + NB +
// NC floats): a shuffle inside a warp, through `edge` at a warp's first lane,
// from `prev_tile` (the last column of the tile before) for the block's
// first thread; the block's last thread leaves its own in `next_tile`. edge
// holds kMaxWarps * (NA + NB + NC) floats, the tile buffers NA + NB + NC.
// One __syncthreads inside; a scan's barriers lie between two uses.
template <int NA, int NB, int NC>
__device__ __forceinline__ void shift_left(
    const float (&a)[NA], const float (&b)[NB], const float (&c)[NC],
    float (&sa)[NA], float (&sb)[NB], float (&sc)[NC], float* edge,
    const float* prev_tile, float* next_tile) {
  constexpr int N = NA + NB + NC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int q = 0; q < NA; ++q) sa[q] = __shfl_up_sync(kFull, a[q], 1);
#pragma unroll
  for (int q = 0; q < NB; ++q) sb[q] = __shfl_up_sync(kFull, b[q], 1);
#pragma unroll
  for (int q = 0; q < NC; ++q) sc[q] = __shfl_up_sync(kFull, c[q], 1);
  if (lane == 31) {
    float* dst = warp == nwarps - 1 ? next_tile : edge + (warp + 1) * N;
#pragma unroll
    for (int q = 0; q < NA; ++q) dst[q] = a[q];
#pragma unroll
    for (int q = 0; q < NB; ++q) dst[NA + q] = b[q];
#pragma unroll
    for (int q = 0; q < NC; ++q) dst[NA + NB + q] = c[q];
  }
  __syncthreads();
  if (lane == 0) {
    const float* src = warp == 0 ? prev_tile : edge + warp * N;
#pragma unroll
    for (int q = 0; q < NA; ++q) sa[q] = src[q];
#pragma unroll
    for (int q = 0; q < NB; ++q) sb[q] = src[NA + q];
#pragma unroll
    for (int q = 0; q < NC; ++q) sc[q] = src[NA + NB + q];
  }
}

// Whether a block of `threads` threads can be launched: whole warps, at most
// kMaxThreads (the shared buffers and the register bound are sized for it).
inline bool block_ok(int threads) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace coati_triplet
