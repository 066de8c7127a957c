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
// stores are a row apart, so each 12-byte store is a sector of its own
// (what that costs beside the diagonal chain: PERF.md).
//
// What bounds it on an H100: the serial chain of diagonals of one pair. A
// long pair's diagonal holds tens of thousands of cells, and one SM does
// about a cell a cycle, so above 4,096 slots a pair is spread over several
// thread blocks (blocks_per_pair, chosen by the wrapper so that a group fills
// the SMs once). What is left is the in-block time of one diagonal: a chain
// of cell latency (ring reads, five maxima or lse) plus one block barrier.
//
// Band route (several blocks a pair). A cell (i, j) reads columns j - 1 and
// j - k of earlier diagonals only, never a column right of its own, so the
// pair's columns are cut into bands, block b owning [b W, (b+1) W) on every
// diagonal. The block keeps its band's ring, (K + 1) diagonals x 3 states x
// (k + W) f32, in shared memory, the first k columns a halo from the left
// neighbour, and the table beside it: no cell reads device memory for a
// predecessor. After each diagonal the block publishes its last k columns
// (3k f32) into a ring of F diagonals per band boundary in device memory,
// halo [B, bands - 1, F, 3, k], and then makes a release store of its
// progress counter next[p][b], the first diagonal it has not finished (and
// published). F > K + 2 keeps the two waits below from closing a cycle.
// Warp 0, which computes the band's leftmost cells, the only ones that read
// the halo, waits with an acquire load on the left neighbour's counter and
// copies the slices into the ring's halo columns; the other warps start the
// diagonal without waiting. (A producer warp that fetched the slices ahead
// into a shared FIFO and made the release stores was timed against this and
// did not pay: PERF.md.) The publishing thread waits on the right
// neighbour's counter only before it would overwrite a slice not yet read.
// So a block waits on its left neighbour alone, which in the steady state is
// ahead already: the blocks form a pipeline with a one-time skew of about
// bands x (hop + one diagonal), and one __syncthreads a diagonal. A band
// with no cell in the launch publishes INT_MAX at once; so does a band
// after its last cell. The launch is cooperative (a block spins on its
// neighbour, which must be on the card). Every counter starts at d0, and a
// band waiting for its first cell passes its left neighbour's counter on as
// its own (up to that first diagonal), so every counter moves as soon as
// band 0 does, however far right a band starts: a wait traps when the
// awaited counter has not moved for about a second, at any C.
//
// Barrier route (kept where the band route cannot take a launch: a band's
// ring over shared memory, about 6,150 columns a band at k = 1, or k > 32):
// the blocks of a pair stride over the whole diagonal together, the working
// ring (K + 1 diagonals x 3 states x C f32) lives in a per-pair global
// scratch that stays in L2 and is read past L1, and the blocks of a pair meet
// at a counter in device memory after every diagonal.
//
// With one block a pair (short pairs, wide groups) the barrier is
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
// below d0 is left as it came in. Scratch by route: ring_scratch [B, K+1, 3,
// C] f32 (one block, ring in global memory; barrier route), sync [B] zeros
// (barrier route), halo [B, bands-1, F, 3, k] f32 and next [B, bands] int32
// zeros (band route).

#include <cuda_runtime.h>

#include <climits>

#include "common.cuh"

namespace {

using coati::kLowest;
using coati::ring_load;
using coati::ring_slot;

// How a launch sweeps its pairs; kernels/wavefront_segment.py ROUTES.
enum Route { kOneGlobal = 0, kOneShared = 1, kBarrier = 2, kBands = 3 };

struct SweepArgs {
  const int32_t *aseq, *bseq, *lens_a, *lens_b;
  const float *table, *gap, *ring_in, *corners_in;
  float *ring_out, *corners_out, *adj, *scratch;
  uint8_t* bp;
  float* mdi;      // Forward: every cell's M, D, I, [B, NA+k, C, 3]
  unsigned* sync;  // barrier route: [B] zeros, the pairs' barrier counters
  float* halo;     // band route: [B, bands-1, F, 3, k], each band's last k columns
  int* next;       // band route: [B, bands] zeros, the first diagonal a band has not published
  long long* stamps;  // band route, optional: [B * bands, 3] ns at entry, first cell, exit
  int B, NA, NB, k, d0, T, blocks_per_pair;
  int band_width, halo_slots, table_len;  // band route
};

constexpr long long kStallCycles = 2000000000LL;  // about a second

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
      if (clock64() - t0 > kStallCycles) __trap();
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Spins until *flag >= target and returns what it read last; `seen` is the
// value read before. With `echo`, every new value read, up to `cap`, is
// published there too: a band waiting for its first cell passes its left
// neighbour's progress on to its right. A wait may be long (the last band of
// a 160 knt sweep waits some 160,000 diagonals for its first cell), but the
// flag it reads keeps moving, so it traps when the flag has not moved for
// about a second.
__device__ __noinline__ int wait_for(const int* flag, int target, int seen,
                                     int* echo = nullptr, int cap = 0) {
  long long t0 = clock64();
  while (seen < target) {
    const int now = load_acquire(flag);
    if (now != seen) {
      seen = now;
      t0 = clock64();
      if (echo) store_release(echo, min(now, cap));
    } else if (clock64() - t0 > kStallCycles) {
      __trap();
    }
  }
  return seen;
}

// What a sweep writes for every cell: nothing, the backpointer byte, or in
// the log semiring the cell's M, D, I.
enum Out { kNone = 0, kBp = 1, kMdi = 2 };

// The raw corners of pair p pass through a segment without its corner.
__device__ void pass_corners(const SweepArgs& x, int p, const coati::Gap& g) {
  const int B = x.B;
  const float cm = x.corners_in ? x.corners_in[p] : kLowest;
  const float cd = x.corners_in ? x.corners_in[B + p] : kLowest;
  const float ci = x.corners_in ? x.corners_in[2 * B + p] : kLowest;
  if (x.corners_out) {
    x.corners_out[p] = cm;
    x.corners_out[B + p] = cd;
    x.corners_out[2 * B + p] = ci;
  }
  x.adj[p] = __fadd_rn(__fadd_rn(cm, g.ng), g.ng);
  x.adj[B + p] = __fadd_rn(cd, g.gs);
  x.adj[2 * B + p] = __fadd_rn(__fadd_rn(ci, g.gs), g.ng);
}

// Cell (i, j) of diagonal d leaves the sweep: its bp byte or its M, D, I,
// and at the corner the raw and adjusted corners.
template <Out kOut>
__device__ __forceinline__ void emit(const SweepArgs& x, int p, int C, int d,
                                     int i, int j, bool corner, uint8_t code,
                                     float M, float D, float I,
                                     const coati::Gap& g) {
  if (kOut == kBp) x.bp[((size_t)p * x.T + (d - x.d0)) * C + j] = code;
  if (kOut == kMdi) {
    float* cell = x.mdi + (((size_t)p * (x.NA + x.k) + i) * C + j) * 3;
    cell[0] = M;
    cell[1] = D;
    cell[2] = I;
  }
  if (corner) {  // the corner is the last diagonal's only cell
    const int B = x.B;
    if (x.corners_out) {
      x.corners_out[p] = M;
      x.corners_out[B + p] = D;
      x.corners_out[2 * B + p] = I;
    }
    x.adj[p] = __fadd_rn(__fadd_rn(M, g.ng), g.ng);
    x.adj[B + p] = __fadd_rn(D, g.gs);
    x.adj[2 * B + p] = __fadd_rn(__fadd_rn(I, g.gs), g.ng);
  }
}

// One block a pair (ring in shared or global memory), or the barrier route
// (kMulti: blocks_per_pair blocks stride over each diagonal, ring in global
// memory).
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
  const int d_last = rows + cols - 2;  // the corner's diagonal
  const int d_end = min(d0 + T - 1, d_last);
  if (tid == 0 && !(d0 <= d_last && d_last <= d_end)) pass_corners(x, p, g);

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
          i, j, k, C, 0, r2, rk, a, b, x.table, g, M, D, I);
      cur[j] = M;
      cur[C + j] = D;
      cur[2 * C + j] = I;
      emit<kOut>(x, p, C, d, i, j, d == d_last, code, M, D, I, g);
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

// The band route: block `band` of pair p sweeps columns [j0, j1) with its
// ring and the table in shared memory and meets its neighbours only through
// the halo ring and the progress counters (header comment).
template <Out kOut>
__global__ void __launch_bounds__(1024) wavefront_band_kernel(const SweepArgs x) {
  extern __shared__ float smem[];
  const int bands = x.blocks_per_pair;
  const int p = blockIdx.x / bands;
  const int band = blockIdx.x % bands;
  const int tid = threadIdx.x, nthr = blockDim.x;
  long long* stamp = x.stamps ? x.stamps + (size_t)3 * blockIdx.x : nullptr;
  if (stamp && tid == 0) stamp[0] = globaltimer();
  const int B = x.B, k = x.k, d0 = x.d0, T = x.T, F = x.halo_slots;
  const int C = x.NB + k;
  const int K = k > 2 ? k : 2;
  const int nring = K + 1;
  const int j0 = band * x.band_width;
  const int j1 = min(C, j0 + x.band_width);
  const int off = j0 - k;              // slot 0 of a plane is column j0 - k
  const int S = k + x.band_width;      // slots of a plane
  const size_t plane = (size_t)3 * S;  // M, D, I planes of one diagonal
  const int per = 3 * k;               // floats of one slice
  float* ring = smem;
  float* tab = smem + nring * plane;
  for (int q = tid; q < x.table_len; q += nthr) tab[q] = x.table[q];
  // the carried diagonals d0-1 .. d0-K, halo columns included
  for (int q = 0; q < K; ++q) {
    float* dst = ring + ring_slot(d0 - 1 - q, nring) * plane;
    for (int s = 0; s < 3; ++s) {
      const float* src =
          x.ring_in ? x.ring_in + (((size_t)q * 3 + s) * B + p) * C : nullptr;
      for (int c = tid; c < j1 - off; c += nthr)
        dst[(size_t)s * S + c] = (src && off + c >= 0) ? src[off + c] : kLowest;
    }
  }

  const coati::Gap g = coati::load_gap(x.gap, k);
  const int rows = x.lens_a[p] + k;  // true matrix: 0 <= i < rows
  const int cols = x.lens_b[p] + k;  //              0 <= j < cols
  const int32_t* a = x.aseq + (size_t)p * x.NA;
  const int32_t* b = x.bseq + (size_t)p * x.NB;
  const int d_last = rows + cols - 2;  // the corner's diagonal
  const int d_end = min(d0 + T - 1, d_last);
  if (band == 0 && tid == 0 && !(d0 <= d_last && d_last <= d_end))
    pass_corners(x, p, g);

  // the diagonals of this launch on which the band holds cells of the pair
  const int d_first = max(d0, j0);
  const int d_stop = j0 < cols ? min(d_end, j1 - 1 + rows - 1) : d_first - 1;
  const bool busy = d_first <= d_stop;
  int* mine = x.next + (size_t)p * bands + band;
  const int* left = band > 0 ? mine - 1 : nullptr;
  const int* right = band + 1 < bands ? mine + 1 : nullptr;
  const size_t halo_len = (size_t)F * per;  // floats of one boundary's ring
  const float* halo_in =
      left ? x.halo + ((size_t)p * (bands - 1) + band - 1) * halo_len : nullptr;
  float* halo_out =
      right ? x.halo + ((size_t)p * (bands - 1) + band) * halo_len : nullptr;
  const int publisher = (nthr - 1) & ~31;  // lane 0 of the last warp
  // a band with no cell here lets its neighbours run free; a busy one reads
  // no slice before d0 - K, which is what its counter promises
  if (tid == publisher) store_release(mine, busy ? d0 : INT_MAX);
  __syncthreads();

  int left_seen = 0, right_seen = 0;
  int copied = d0 - 1;  // the last halo diagonal in the ring
  for (int d = d_first; d <= d_stop; ++d) {
    float* cur = ring + ring_slot(d, nring) * plane;
    const float* r2 = ring + ring_slot(d - 2, nring) * plane;
    const float* rk = ring + ring_slot(d - k, nring) * plane;
    if (halo_in && tid < 32) {
      // only cells j < j0 + k read the halo, and they are warp 0's: it takes
      // the slices of the diagonals up to d - 1 it does not hold yet
      const int e_lo = max(max(copied + 1, d - K), d0);
      if (e_lo < d) {
        // before its first cell the band's counter echoes its left
        // neighbour's: nothing before d_first is read from its slices
        if (tid == 0)
          left_seen = wait_for(left, d, left_seen,
                               d == d_first ? mine : nullptr, d_first);
        __syncwarp();
        for (int q = tid; q < (d - e_lo) * per; q += 32) {
          const int e = e_lo + q / per, r = q % per;  // r = state * k + column
          ring[ring_slot(e, nring) * plane + (size_t)(r / k) * S + r % k] =
              __ldcg(halo_in + (size_t)(e % F) * per + r);
        }
        __syncwarp();
        copied = d - 1;
      }
    }
    if (stamp && tid == 0 && d == d_first) stamp[1] = globaltimer();
    const int lo = max(max(0, d - (rows - 1)), j0);
    const int hi = min(min(d, cols - 1), j1 - 1);
    for (int j = lo + tid; j <= hi; j += nthr) {
      const int i = d - j;
      float M, D, I;
      const uint8_t code = coati::cell_update<false, kOut == kMdi>(
          i, j, k, S, off, r2, rk, a, b, tab, g, M, D, I);
      const int c = j - off;
      cur[c] = M;
      cur[S + c] = D;
      cur[2 * S + c] = I;
      emit<kOut>(x, p, C, d, i, j, d == d_last, code, M, D, I, g);
    }
    __syncthreads();
    if (tid == publisher) {
      if (halo_out) {
        // slot d % F held diagonal d - F: the right neighbour may still copy
        // a diagonal from K before its counter
        const int need = d - F + K + 1;
        if (right_seen < need) right_seen = wait_for(right, need, right_seen);
        float* dst = halo_out + (size_t)(d % F) * per;
        for (int s = 0; s < 3; ++s)
          for (int c = 0; c < k; ++c)
            dst[s * k + c] = cur[(size_t)s * S + (j1 - j0) + c];
      }
      // the last band publishes no slice, but its counter tells its left
      // neighbour which slots it may overwrite
      store_release(mine, d + 1);
    }
  }
  if (tid == publisher && busy) store_release(mine, INT_MAX);
  if (stamp && tid == 0) stamp[2] = globaltimer();

  if (x.ring_out) {
    for (int q = 0; q < K; ++q) {
      const int dq = d0 + T - 1 - q;
      const float* src = ring + ring_slot(dq, nring) * plane;
      const bool live = dq >= 0 && dq <= d_last;
      const int j_lo = live ? max(0, dq - (rows - 1)) : 1;
      const int j_hi = live ? min(dq, cols - 1) : 0;
      for (int s = 0; s < 3; ++s) {
        float* dst = x.ring_out + (((size_t)q * 3 + s) * B + p) * C;
        for (int j = j0 + tid; j < j1; j += nthr)
          dst[j] = (j >= j_lo && j <= j_hi) ? src[(size_t)s * S + j - off] : kLowest;
      }
    }
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// cooperative: every block is on the card at once, or the launch fails
int launch_cooperative(const void* kernel, const SweepArgs& x, int threads,
                       size_t smem, cudaStream_t stream) {
  void* args[] = {const_cast<SweepArgs*>(&x)};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(x.B * x.blocks_per_pair), dim3(threads), args, smem, stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <bool kRingShared, Out kOut, bool kMulti>
int launch(const SweepArgs& x, int threads, cudaStream_t stream) {
  const void* kernel = (const void*)wavefront_sweep_kernel<kRingShared, kOut, kMulti>;
  const int K = x.k > 2 ? x.k : 2;
  const size_t smem =
      kRingShared ? (size_t)(K + 1) * 3 * (x.NB + x.k) * sizeof(float) : 0;
  if (const int e = set_smem(kernel, smem)) return e;
  if (kMulti) return launch_cooperative(kernel, x, threads, smem, stream);
  wavefront_sweep_kernel<kRingShared, kOut, kMulti><<<x.B, threads, smem, stream>>>(x);
  return (int)cudaGetLastError();
}

template <Out kOut>
int launch_bands(const SweepArgs& x, int threads, cudaStream_t stream) {
  const int K = x.k > 2 ? x.k : 2;
  const int C = x.NB + x.k;
  const int W = x.band_width, n = x.blocks_per_pair;
  // the bands tile [0, C), each at least k + 32 columns so that only warp 0
  // reads the halo and a slice is published before it is needed; the halo
  // ring outlasts the K diagonals a reader may still copy and two diagonals
  // of counters that lag
  if (n < 2 || x.halo == nullptr || x.next == nullptr || x.k > 32 ||
      W < x.k + 32 || (size_t)(n - 1) * W >= (size_t)C || (size_t)n * W < (size_t)C ||
      C - (n - 1) * W < x.k + 32 || x.halo_slots <= K + 2 ||
      x.table_len < 1 || threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)wavefront_band_kernel<kOut>;
  const size_t smem =
      ((size_t)(K + 1) * 3 * (x.k + W) + x.table_len) * sizeof(float);
  if (const int e = set_smem(kernel, smem)) return e;
  return launch_cooperative(kernel, x, threads, smem, stream);
}

template <Out kOut>
int dispatch(const SweepArgs& x, int route, int threads, void* stream) {
  if (x.B == 0 || x.T <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool one = x.blocks_per_pair == 1;
  switch (route) {
    case kOneGlobal:
      if (!one || x.scratch == nullptr) return (int)cudaErrorInvalidValue;
      return launch<false, kOut, false>(x, threads, s);
    case kOneShared:
      if (!one) return (int)cudaErrorInvalidValue;
      return launch<true, kOut, false>(x, threads, s);
    case kBarrier:
      if (one || x.sync == nullptr || x.scratch == nullptr)
        return (int)cudaErrorInvalidValue;
      return launch<false, kOut, true>(x, threads, s);
    case kBands:
      return launch_bands<kOut>(x, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Diagonals [d0, d0 + T) from the carry (ring_in, corners_in) to the carry
// (ring_out, corners_out), adjusted corners to adj, and with want_bp the
// segment's backpointers to bp.
extern "C" int coati_wavefront_segment(
    const void* aseq, const void* bseq, const void* lens_a, const void* lens_b,
    const void* table, const void* gap_consts, const void* ring_in,
    const void* corners_in, void* ring_out, void* corners_out, void* adj,
    void* ring_scratch, void* bp, void* sync, void* halo, void* next,
    void* stamps, int B,
    int NA, int NB, int k, int d0, int T, int route, int want_bp,
    int blocks_per_pair, int band_width, int halo_slots, int table_len,
    int threads, void* stream) {
  const SweepArgs x = {
      static_cast<const int32_t*>(aseq),    static_cast<const int32_t*>(bseq),
      static_cast<const int32_t*>(lens_a),  static_cast<const int32_t*>(lens_b),
      static_cast<const float*>(table),     static_cast<const float*>(gap_consts),
      static_cast<const float*>(ring_in),   static_cast<const float*>(corners_in),
      static_cast<float*>(ring_out),        static_cast<float*>(corners_out),
      static_cast<float*>(adj),             static_cast<float*>(ring_scratch),
      static_cast<uint8_t*>(bp),            nullptr,
      static_cast<unsigned*>(sync),         static_cast<float*>(halo),
      static_cast<int*>(next),              static_cast<long long*>(stamps),
      B, NA, NB, k, d0, T, blocks_per_pair,
      band_width, halo_slots, table_len};
  return want_bp ? dispatch<kBp>(x, route, threads, stream)
                 : dispatch<kNone>(x, route, threads, stream);
}

// Score-only Viterbi: every diagonal from an empty ring, adjusted corners
// [3, B] to adj, nothing else leaves the chip.
extern "C" int coati_wavefront_score(
    const void* aseq, const void* bseq, const void* lens_a, const void* lens_b,
    const void* table, const void* gap_consts, void* adj, void* ring_scratch,
    void* sync, void* halo, void* next, void* stamps, int B, int NA, int NB,
    int k, int route,
    int blocks_per_pair, int band_width, int halo_slots, int table_len,
    int threads, void* stream) {
  const SweepArgs x = {
      static_cast<const int32_t*>(aseq),   static_cast<const int32_t*>(bseq),
      static_cast<const int32_t*>(lens_a), static_cast<const int32_t*>(lens_b),
      static_cast<const float*>(table),    static_cast<const float*>(gap_consts),
      nullptr, nullptr, nullptr, nullptr,
      static_cast<float*>(adj),            static_cast<float*>(ring_scratch),
      nullptr, nullptr,                    static_cast<unsigned*>(sync),
      static_cast<float*>(halo),           static_cast<int*>(next),
      static_cast<long long*>(stamps),
      B, NA, NB, k, 0, NA + NB + 2 * k - 1, blocks_per_pair,
      band_width, halo_slots, table_len};
  return dispatch<kNone>(x, route, threads, stream);
}

// Log-semiring Forward: every diagonal from an empty ring, every cell's M, D,
// I of each pair's true (la+k) x (lb+k) rectangle, margins included, to mdi
// [B, NA+k, NB+k, 3] (cells outside a pair's rectangle are not written), the
// adjusted corners [3, B] to adj.
extern "C" int coati_wavefront_forward(
    const void* aseq, const void* bseq, const void* lens_a, const void* lens_b,
    const void* table, const void* gap_consts, void* adj, void* ring_scratch,
    void* sync, void* halo, void* next, void* stamps, void* mdi, int B, int NA,
    int NB, int k,
    int route, int blocks_per_pair, int band_width, int halo_slots,
    int table_len, int threads, void* stream) {
  const SweepArgs x = {
      static_cast<const int32_t*>(aseq),   static_cast<const int32_t*>(bseq),
      static_cast<const int32_t*>(lens_a), static_cast<const int32_t*>(lens_b),
      static_cast<const float*>(table),    static_cast<const float*>(gap_consts),
      nullptr, nullptr, nullptr, nullptr,
      static_cast<float*>(adj),            static_cast<float*>(ring_scratch),
      nullptr, static_cast<float*>(mdi),   static_cast<unsigned*>(sync),
      static_cast<float*>(halo),           static_cast<int*>(next),
      static_cast<long long*>(stamps),
      B, NA, NB, k, 0, NA + NB + 2 * k - 1, blocks_per_pair,
      band_width, halo_slots, table_len};
  return dispatch<kMdi>(x, route, threads, stream);
}
