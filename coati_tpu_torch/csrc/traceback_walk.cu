// Backward traceback walk over packed backpointers, one thread per pair:
// over a whole backpointer stack, or segment by segment for long pairs.
//
// Replaces the device walk coati_tpu/align/wavefront.py:271
// traceback_ops_impl in its while-loop form (:388-417), and the segment
// walk coati_tpu/align/longseq.py:57 _walk_segment. Those walks are plain
// XLA in the JAX package, not Pallas; in plain torch ops they would be some
// la+lb dependent steps of a dozen launches each, so they are kernels here.
// The hole-emitting diagonal scan of the JAX version (:321-386) exists
// because TPU gathers are slow and is not carried over.
//
// What bounds it on an H100: the chain of dependent one-byte loads from the
// backpointer stack in device memory, one per step, about max(la, lb) + gaps
// steps per pair. Each thread keeps its (i, j, state) in registers, so the
// step is one load and a few integer ops; the op stores of a warp at one step
// are contiguous bytes. Latency is hidden only across pairs, by running one
// thread per pair over the whole chunk.
//
// Layout: bp [B, Dtot, C] uint8 as written by wavefront_fill.cu; corners
// cM/cD/cI [B] f32 (terminal-adjusted); ops [max_steps, B] int8, op codes
// 0=match 1=delete 2=insert in backward order from the corner and -1 after
// the walk's end; score [B] f32 = max(cM, max(cD, cI)).
//
// Segment form: state [4, B] int32 holds each pair's (i, j, st, s) between
// launches, s the number of ops written so far. The first launch of a walk
// (the topmost segment) is given the terminal-adjusted corners adj [3, B]
// instead: it starts every pair at its corner with no op written and writes
// score [B]. bp [B, T, C] holds diagonals [d0, d0 + T) as written by
// wavefront_segment.cu. A pair walks while its cell's diagonal
// i + j is at least d0, then parks until the launch for the segment below;
// its ops go to ops[s], each pair counting its own s (the reference counts
// one s for the group and writes -1 for parked pairs; the op sequences with
// the -1 dropped are the same). The caller fills ops with -1 beforehand.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using coati::argmax_mdi;

__global__ void traceback_walk_kernel(
    const uint8_t* __restrict__ bp, const float* __restrict__ cM,
    const float* __restrict__ cD, const float* __restrict__ cI,
    const int32_t* __restrict__ lens_a, const int32_t* __restrict__ lens_b,
    int8_t* __restrict__ ops, float* __restrict__ score, int B, int Dtot,
    int C, int k, int max_steps) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const float m = cM[p], d = cD[p], x = cI[p];
  unsigned st = argmax_mdi(m, d, x);
  score[p] = fmaxf(m, fmaxf(d, x));
  int i = lens_a[p] + k - 1;
  int j = lens_b[p] + k - 1;
  const uint8_t* bpp = bp + (size_t)p * Dtot * C;
  int s = 0;
  // the walk stops at (k-1, k-1); i, j < 0 only on a malformed bp stack
  for (; s < max_steps && (i > k - 1 || j > k - 1) && i >= 0 && j >= 0; ++s) {
    const unsigned code = bpp[(size_t)(i + j) * C + j];
    ops[(size_t)s * B + p] = (int8_t)st;
    if (st == 0) {
      i -= 1;
      j -= 1;
    } else if (st == 1) {
      i -= k;
    } else {
      j -= k;
    }
    st = (code >> (2 * st)) & 3u;
  }
  for (; s < max_steps; ++s) ops[(size_t)s * B + p] = -1;
}

__global__ void traceback_walk_segment_kernel(
    const uint8_t* __restrict__ bp, const float* __restrict__ adj,
    const int32_t* __restrict__ lens_a, const int32_t* __restrict__ lens_b,
    float* __restrict__ score, int32_t* __restrict__ state,
    int8_t* __restrict__ ops, int B, int T, int C, int k, int d0,
    int max_steps) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  int i, j, s;
  unsigned st;
  if (adj != nullptr) {  // first launch of the walk: start at the corner
    const float m = adj[p], d = adj[B + p], x = adj[2 * B + p];
    score[p] = fmaxf(m, fmaxf(d, x));
    i = lens_a[p] + k - 1;
    j = lens_b[p] + k - 1;
    st = argmax_mdi(m, d, x);
    s = 0;
  } else {
    i = state[p];
    j = state[B + p];
    st = (unsigned)state[2 * B + p];
    s = state[3 * B + p];
  }
  const uint8_t* bpp = bp + (size_t)p * T * C;
  // i + j - d0 < T while the segments are walked last to first; a cell
  // above the segment, or i, j < 0, comes only from a malformed bp stack
  while (s < max_steps && (i > k - 1 || j > k - 1) && i >= 0 && j >= 0 &&
         i + j >= d0 && i + j - d0 < T) {
    const unsigned code = bpp[(size_t)(i + j - d0) * C + j];
    ops[(size_t)s * B + p] = (int8_t)st;
    if (st == 0) {
      i -= 1;
      j -= 1;
    } else if (st == 1) {
      i -= k;
    } else {
      j -= k;
    }
    st = (code >> (2 * st)) & 3u;
    ++s;
  }
  state[p] = i;
  state[B + p] = j;
  state[2 * B + p] = (int32_t)st;
  state[3 * B + p] = s;
}

}  // namespace

extern "C" int coati_traceback_walk(
    const void* bp, const void* cM, const void* cD, const void* cI,
    const void* lens_a, const void* lens_b, void* ops, void* score, int B,
    int Dtot, int C, int k, int max_steps, void* stream) {
  if (B == 0) return 0;
  const int threads = 128;
  traceback_walk_kernel<<<(B + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bp), static_cast<const float*>(cM),
      static_cast<const float*>(cD), static_cast<const float*>(cI),
      static_cast<const int32_t*>(lens_a), static_cast<const int32_t*>(lens_b),
      static_cast<int8_t*>(ops), static_cast<float*>(score), B, Dtot, C, k,
      max_steps);
  return (int)cudaGetLastError();
}

// adj, lens_a, lens_b and score are all given on a walk's first launch and
// all null on the later ones.
extern "C" int coati_traceback_walk_segment(
    const void* bp, const void* adj, const void* lens_a, const void* lens_b,
    void* score, void* state, void* ops, int B, int T, int C, int k, int d0,
    int max_steps, void* stream) {
  if (B == 0) return 0;
  const int threads = 128;
  traceback_walk_segment_kernel<<<(B + threads - 1) / threads, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bp), static_cast<const float*>(adj),
      static_cast<const int32_t*>(lens_a), static_cast<const int32_t*>(lens_b),
      static_cast<float*>(score), static_cast<int32_t*>(state),
      static_cast<int8_t*>(ops), B, T, C, k, d0, max_steps);
  return (int)cudaGetLastError();
}
