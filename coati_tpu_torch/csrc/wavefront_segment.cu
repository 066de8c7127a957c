// Marginal Gotoh M/D/I Viterbi over a run of anti-diagonals from a carried
// ring, one or several thread blocks per pair: the segment kernel of the
// long-pair path, the score-only kernel, and the Forward kernel of the
// sampling path.
//
// Replaces the TPU kernels coati_tpu/kernels/wavefront_pallas.py:909
// wavefront_pallas_segment (with segment_consts :841 and segment_corners
// :991) and :330 wavefront_pallas with want_bp=False. What they compute is
// what coati_tpu/align/longseq.py _segment computes: diagonals
// [d0, d0 + T) of every pair from the ring of the last K = max(k, 2)
// diagonals and the raw corners captured so far, the ring and corners
// leaving the segment, and with bp the backpointer byte of every cell of
// those diagonals. Score-only Viterbi is the same sweep with d0 = 0, T =
// all diagonals, an empty ring in and nothing but the adjusted corners out,
// so it is one more entry point of this kernel. The TPU kernels' lane
// folding, one-hot emission window and its carried copy, code_cols and du
// exist for the TPU's lanes and slow gathers and are not carried over: the
// emission is a direct gather from the table, so the carry is ring +
// corners only.
//
// It also replaces :330 wavefront_pallas with mode="forward" (kernel body
// :69, plus2 = _lse :115, the diagonals streamed out at :265-269): the
// log-semiring Forward is the same sweep with lse for max, d0 = 0, every
// diagonal, and every cell's M, D, I written out instead of a backpointer,
// a third entry point. It writes the row layout the sample walk reads, mdi
// [B, NA+k, C, 3] f32 with cell (i, j) at [p, i, j]: 12 bytes a cell, half
// of what the reference's [Dtot, C] planes take. Along a diagonal those
// stores are a row apart, so each 12-byte store is a sector of its own;
// beside the barrier after every diagonal that does not show (see PERF.md).
//
// What bounds it on an H100: the serial chain of diagonals of one pair, a
// barrier each. A long pair's diagonal holds tens of thousands of cells, and
// one SM does about a cell a cycle, so the sweep of a pair is spread over
// several thread blocks (blocks_per_pair, chosen by the wrapper so that a
// group fills the SMs once): the blocks stride over the diagonal together,
// the working ring (K + 1 diagonals x 3 states x C f32) lives in a per-pair
// global scratch that stays in L2 (1.2 MB a pair at 32,000 slots, k = 1) and
// is read past L1, and the blocks of a pair meet at a counter in device
// memory after every diagonal. The launch is cooperative, so the blocks are
// on the card together or the launch fails; a barrier that waits a second
// traps. With one block a pair (short pairs, wide groups) the barrier is
// __syncthreads and the ring lives in shared memory when it fits. With bp
// the only traffic that scales with the matrix is the 1 byte per cell
// store, contiguous along a diagonal.
//
// Numerics: common.cuh's cell_update, bit-equal to the XLA:CPU reference;
// the margins use the global indices i and j, whatever segment they fall in.
//
// Layout: aseq [B, NA] int32, bseq [B, NB] int32, lens [B] int32, table
// [rows, 15] f32, gap_consts [4] f32. The carry is the reference's:
// ring [K, 3, B, C] f32 with ring[q] = diagonal d0 - 1 - q, raw corners
// [3, B]. ring_in / corners_in may be null (all LOWEST), ring_out /
// corners_out null (not wanted). adj [3, B] receives the terminal-adjusted
// corners. bp [B, T, C] uint8: cell (i, j) at [p, i + j - d0, j]. Only the
// cells of a pair's true (la+k) x (lb+k) matrix are computed or written to
// bp; in ring_out every other slot is LOWEST. A pair whose corner lies
// below d0 is left as it came in.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using coati::kLowest;
using coati::ring_load;
using coati::ring_slot;

struct SweepArgs {
  const int32_t *aseq, *bseq, *lens_a, *lens_b;
  const float *table, *gap, *ring_in, *corners_in;
  float *ring_out, *corners_out, *adj, *scratch;
  uint8_t* bp;
  float* mdi;  // Forward: every cell's M, D, I, [B, NA+k, C, 3]
  unsigned* sync;  // [B] zeros: the pairs' barrier counters (blocks_per_pair > 1)
  int B, NA, NB, k, d0, T, blocks_per_pair;
};

constexpr long long kBarrierTimeoutCycles = 2000000000LL;  // about a second

// All threads of the blocks that share `counter` meet here; `target` is the
// count after every one of them has arrived. Writes made before it are
// visible to ld.global.cg reads made after it.
__device__ __forceinline__ void pair_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    const long long t0 = clock64();
    while (*(volatile unsigned*)counter < target)
      if (clock64() - t0 > kBarrierTimeoutCycles) __trap();
    __threadfence();
  }
  __syncthreads();
}

// What a sweep writes for every cell: nothing, the backpointer byte, or in
// the log semiring the cell's M, D, I.
enum Out { kNone = 0, kBp = 1, kMdi = 2 };

// kMulti: blocks_per_pair blocks sweep each pair (ring in global memory).
template <bool kRingShared, Out kOut, bool kMulti>
__global__ void __launch_bounds__(1024) wavefront_sweep_kernel(const SweepArgs x) {
  extern __shared__ float smem[];
  const int p = kMulti ? blockIdx.x / x.blocks_per_pair : blockIdx.x;
  // this thread's place among the threads that sweep pair p, and their number
  const int tid = kMulti ? (blockIdx.x % x.blocks_per_pair) * blockDim.x + threadIdx.x
                         : threadIdx.x;
  const int nthr = kMulti ? x.blocks_per_pair * blockDim.x : blockDim.x;
  const int B = x.B, k = x.k, d0 = x.d0, T = x.T;
  const int C = x.NB + k;
  const int K = k > 2 ? k : 2;
  const int nring = K + 1;
  const size_t plane = (size_t)3 * C;  // M, D, I planes of one diagonal
  float* ring = kRingShared ? smem : x.scratch + (size_t)p * nring * plane;
  unsigned arrived = 0;
  auto barrier = [&]() {
    if (kMulti)
      pair_barrier(x.sync + p, arrived += x.blocks_per_pair);
    else
      __syncthreads();
  };

  // the carried diagonals d0-1 .. d0-K go to their slots of the working ring
  for (int q = 0; q < K; ++q) {
    float* dst = ring + ring_slot(d0 - 1 - q, nring) * plane;
    for (int s = 0; s < 3; ++s) {
      const float* src =
          x.ring_in ? x.ring_in + (((size_t)q * 3 + s) * B + p) * C : nullptr;
      for (int j = tid; j < C; j += nthr)
        dst[(size_t)s * C + j] = src ? src[j] : kLowest;
    }
  }
  barrier();

  const coati::Gap g = coati::load_gap(x.gap, k);
  const int rows = x.lens_a[p] + k;  // true matrix: 0 <= i < rows
  const int cols = x.lens_b[p] + k;  //              0 <= j < cols
  const int32_t* a = x.aseq + (size_t)p * x.NA;
  const int32_t* b = x.bseq + (size_t)p * x.NB;
  const float* table = x.table;
  float* adj = x.adj;
  const int d_last = rows + cols - 2;  // the corner's diagonal
  const int d_end = min(d0 + T - 1, d_last);
  uint8_t* bpp = kOut == kBp ? x.bp + (size_t)p * T * C : nullptr;
  float* mdip =
      kOut == kMdi ? x.mdi + (size_t)p * (x.NA + k) * C * 3 : nullptr;

  if (tid == 0 && !(d0 <= d_last && d_last <= d_end)) {
    // no corner in this segment: the raw corners pass through
    const float cm = x.corners_in ? x.corners_in[p] : kLowest;
    const float cd = x.corners_in ? x.corners_in[B + p] : kLowest;
    const float ci = x.corners_in ? x.corners_in[2 * B + p] : kLowest;
    if (x.corners_out) {
      x.corners_out[p] = cm;
      x.corners_out[B + p] = cd;
      x.corners_out[2 * B + p] = ci;
    }
    adj[p] = __fadd_rn(__fadd_rn(cm, g.ng), g.ng);
    adj[B + p] = __fadd_rn(cd, g.gs);
    adj[2 * B + p] = __fadd_rn(__fadd_rn(ci, g.gs), g.ng);
  }

  for (int d = d0; d <= d_end; ++d) {
    float* cur = ring + ring_slot(d, nring) * plane;
    const float* r2 = ring + ring_slot(d - 2, nring) * plane;
    const float* rk = ring + ring_slot(d - k, nring) * plane;
    const int j_lo = max(0, d - (rows - 1));
    const int j_hi = min(d, cols - 1);
    for (int j = j_lo + tid; j <= j_hi; j += nthr) {
      const int i = d - j;
      float M, D, I;
      const uint8_t code = coati::cell_update<kMulti, kOut == kMdi>(
          i, j, k, C, r2, rk, a, b, table, g, M, D, I);
      cur[j] = M;
      cur[C + j] = D;
      cur[2 * C + j] = I;
      if (kOut == kBp) bpp[(size_t)(d - d0) * C + j] = code;
      if (kOut == kMdi) {
        float* cell = mdip + ((size_t)i * C + j) * 3;
        cell[0] = M;
        cell[1] = D;
        cell[2] = I;
      }

      if (d == d_last) {  // the corner is the last diagonal's only cell
        if (x.corners_out) {
          x.corners_out[p] = M;
          x.corners_out[B + p] = D;
          x.corners_out[2 * B + p] = I;
        }
        adj[p] = __fadd_rn(__fadd_rn(M, g.ng), g.ng);
        adj[B + p] = __fadd_rn(D, g.gs);
        adj[2 * B + p] = __fadd_rn(__fadd_rn(I, g.gs), g.ng);
      }
    }
    barrier();
  }

  if (x.ring_out) {
    for (int q = 0; q < K; ++q) {
      const int dq = d0 + T - 1 - q;
      const float* src = ring + ring_slot(dq, nring) * plane;
      const bool live = dq >= 0 && dq <= d_last;
      const int j_lo = live ? max(0, dq - (rows - 1)) : 1;
      const int j_hi = live ? min(dq, cols - 1) : 0;
      for (int s = 0; s < 3; ++s) {
        float* dst = x.ring_out + (((size_t)q * 3 + s) * B + p) * C;
        for (int j = tid; j < C; j += nthr)
          dst[j] = (j >= j_lo && j <= j_hi)
                       ? ring_load<kMulti>(src + (size_t)s * C + j)
                       : kLowest;
      }
    }
  }
}

template <bool kRingShared, Out kOut, bool kMulti>
int launch(const SweepArgs& x, int threads, cudaStream_t stream) {
  auto kernel = wavefront_sweep_kernel<kRingShared, kOut, kMulti>;
  const int K = x.k > 2 ? x.k : 2;
  const size_t smem =
      kRingShared ? (size_t)(K + 1) * 3 * (x.NB + x.k) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (kMulti) {
    // cooperative: every block is on the card at once, or the launch fails
    void* args[] = {const_cast<SweepArgs*>(&x)};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (void*)kernel, dim3(x.B * x.blocks_per_pair), dim3(threads), args, smem,
        stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  kernel<<<x.B, threads, smem, stream>>>(x);
  return (int)cudaGetLastError();
}

template <Out kOut>
int dispatch(const SweepArgs& x, bool ring_shared, int threads, void* stream) {
  if (x.B == 0 || x.T <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (x.blocks_per_pair > 1) {
    if (ring_shared || x.sync == nullptr) return (int)cudaErrorInvalidValue;
    return launch<false, kOut, true>(x, threads, s);
  }
  return ring_shared ? launch<true, kOut, false>(x, threads, s)
                     : launch<false, kOut, false>(x, threads, s);
}

}  // namespace

// Diagonals [d0, d0 + T) from the carry (ring_in, corners_in) to the carry
// (ring_out, corners_out), adjusted corners to adj, and with want_bp the
// segment's backpointers to bp.
extern "C" int coati_wavefront_segment(
    const void* aseq, const void* bseq, const void* lens_a, const void* lens_b,
    const void* table, const void* gap_consts, const void* ring_in,
    const void* corners_in, void* ring_out, void* corners_out, void* adj,
    void* ring_scratch, void* bp, void* sync, int B, int NA, int NB, int k,
    int d0, int T, int ring_shared, int want_bp, int blocks_per_pair,
    int threads, void* stream) {
  const SweepArgs x = {
      static_cast<const int32_t*>(aseq),    static_cast<const int32_t*>(bseq),
      static_cast<const int32_t*>(lens_a),  static_cast<const int32_t*>(lens_b),
      static_cast<const float*>(table),     static_cast<const float*>(gap_consts),
      static_cast<const float*>(ring_in),   static_cast<const float*>(corners_in),
      static_cast<float*>(ring_out),        static_cast<float*>(corners_out),
      static_cast<float*>(adj),             static_cast<float*>(ring_scratch),
      static_cast<uint8_t*>(bp),            nullptr,
      static_cast<unsigned*>(sync),
      B, NA, NB, k, d0, T, blocks_per_pair};
  return want_bp ? dispatch<kBp>(x, ring_shared != 0, threads, stream)
                 : dispatch<kNone>(x, ring_shared != 0, threads, stream);
}

// Score-only Viterbi: every diagonal from an empty ring, adjusted corners
// [3, B] to adj, nothing else leaves the chip.
extern "C" int coati_wavefront_score(
    const void* aseq, const void* bseq, const void* lens_a, const void* lens_b,
    const void* table, const void* gap_consts, void* adj, void* ring_scratch,
    void* sync, int B, int NA, int NB, int k, int ring_shared,
    int blocks_per_pair, int threads, void* stream) {
  const SweepArgs x = {
      static_cast<const int32_t*>(aseq),   static_cast<const int32_t*>(bseq),
      static_cast<const int32_t*>(lens_a), static_cast<const int32_t*>(lens_b),
      static_cast<const float*>(table),    static_cast<const float*>(gap_consts),
      nullptr, nullptr, nullptr, nullptr,
      static_cast<float*>(adj),            static_cast<float*>(ring_scratch),
      nullptr, nullptr,                    static_cast<unsigned*>(sync),
      B, NA, NB, k, 0, NA + NB + 2 * k - 1, blocks_per_pair};
  return dispatch<kNone>(x, ring_shared != 0, threads, stream);
}

// Log-semiring Forward: every diagonal from an empty ring, every cell's M, D,
// I of each pair's true (la+k) x (lb+k) rectangle, margins included, to mdi
// [B, NA+k, NB+k, 3] (cells outside a pair's rectangle are not written), the
// adjusted corners [3, B] to adj.
extern "C" int coati_wavefront_forward(
    const void* aseq, const void* bseq, const void* lens_a, const void* lens_b,
    const void* table, const void* gap_consts, void* adj, void* ring_scratch,
    void* sync, void* mdi, int B, int NA, int NB, int k, int ring_shared,
    int blocks_per_pair, int threads, void* stream) {
  const SweepArgs x = {
      static_cast<const int32_t*>(aseq),   static_cast<const int32_t*>(bseq),
      static_cast<const int32_t*>(lens_a), static_cast<const int32_t*>(lens_b),
      static_cast<const float*>(table),    static_cast<const float*>(gap_consts),
      nullptr, nullptr, nullptr, nullptr,
      static_cast<float*>(adj),            static_cast<float*>(ring_scratch),
      nullptr, static_cast<float*>(mdi),   static_cast<unsigned*>(sync),
      B, NA, NB, k, 0, NA + NB + 2 * k - 1, blocks_per_pair};
  return dispatch<kMdi>(x, ring_shared != 0, threads, stream);
}
