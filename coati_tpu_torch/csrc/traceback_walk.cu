// Backward traceback walk over packed backpointers, a warp a pair with the
// backpointers read through windows in shared memory: over a whole stack in
// row layout, band by band of rows for long pairs (k <= 8), or segment by
// segment (diagonal layout) for long pairs above k = 8.
//
// Replaces the device walk coati_tpu/align/wavefront.py:271
// traceback_ops_impl in its while-loop form (:388-417), and the segment
// walk coati_tpu/align/longseq.py:57 _walk_segment. Those walks are plain
// XLA in the JAX package, not Pallas; in plain torch ops they would be some
// la+lb dependent steps of a dozen launches each, so they are kernels here.
// The hole-emitting diagonal scan of the JAX version (:321-386) exists
// because TPU gathers are slow and is not carried over.
//
// What bounds it on an H100: the chain of dependent one-byte loads, one a
// step, about max(la, lb) + gaps steps a pair. A stack of 64 pairs of
// 1,056 slots is some 70 MB in row layout, more than the L2 holds, so a load
// from the stack itself is a device-memory round trip (~0.5 us) a step. In
// a segment of diagonals a match step moves 2C bytes back (64 KB at 32,000
// slots), so there too every step would be a new sector.
//
// Whole-stack walk (traceback_walk_kernel): a warp walks one pair. A step
// lowers i by 1 or k, or j by 1 or k, so the S steps after (i, j) stay in
// rows [i - kS, i] x columns [j - kS, j]. The warp copies the window of H =
// 2kS rows and columns above and left of an anchor into shared memory with
// cp.async (16-byte copies, the lanes side by side along a row); lane 0
// walks S steps in it at shared-memory latency and stages their op codes,
// which the warp then stores together. Two windows a warp: at the start of
// each round of S steps the warp anchors the next window at the walk's
// position and fetches it while lane 0 walks on in the current one, which
// still holds the 2S steps after its own anchor; the fetch has S steps of
// the walk to arrive in.
//
// Band walk (traceback_walk_kernel<true>): the same walk over one band of
// rows of the long path's pass 2 (csrc/wavefront_fill_long.cu), bp [B, R,
// Cp] holding rows [r0, r0 + R), with the segment form's state and start
// (below). A pair walks while its row is in the band; the windows are
// clipped at the band's first row. A step of k rows may leave the band: the
// band below is filled before it is walked. This is the segment walk's
// contract on the fill's row layout, so a long pair at k <= 8 never runs
// the sweep.
//
// Segment walk (traceback_walk_segment_kernel): the same rounds and windows
// over a segment in diagonal layout, rows being diagonals. Its rows are C
// bytes, not a multiple of 16, so each window row is copied from the
// 16-byte boundary at or below its first cell's address and read at that
// offset (SegWindow).
//
// Layout: bp [B, NA + k, Cp] uint8 as written by wavefront_fill.cu (cell
// (i, j) at [p, i, j], Cp a multiple of 16); corners cM/cD/cI [B] f32
// (terminal-adjusted); ops [max_steps, B] int8, op codes 0=match 1=delete
// 2=insert in backward order from the corner and -1 after the walk's end;
// score [B] f32 = max(cM, max(cD, cI)).
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

// One window: rows [r0, ia] x columns [c0, c0 + nch * 16) of pair p's
// stack, anchored at (ia, ja), clipped at 0; row q at win + q * wb.
struct Window {
  int r0, c0;
};

__device__ __forceinline__ Window fetch_window(const uint8_t* bpp, int Cp,
                                               int ia, int ja, int H, int wb,
                                               uint8_t* win, int lane) {
  Window v;
  v.r0 = max(ia - H, 0);
  v.c0 = max(ja - H, 0) & ~15;
  const int nch = ((ja & ~15) + 16 - v.c0) >> 4;  // 16-byte chunks of a row, <= 32
  const int per = 32 / nch;                        // rows the warp copies at once
  const int rows = ia - v.r0 + 1;
  const unsigned base = (unsigned)__cvta_generic_to_shared(win);
  const int c = lane % nch;
  for (int r = lane / nch; lane < per * nch && r < rows; r += per) {
    const uint8_t* src = bpp + (size_t)(v.r0 + r) * Cp + v.c0 + 16 * c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     base + (unsigned)(r * wb + 16 * c)),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  return v;
}

__device__ __forceinline__ void window_arrived() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncwarp();
}

// Shared memory a warp: two windows of (H + 1) rows of wb bytes, and S op
// codes. kernels/traceback_walk.py window_bytes repeats it. kBand: the band
// walk; its first launch is given cM, cD, cI, the later ones null, and
// state carries each pair's (i, j, st, s) between launches.
template <bool kBand>
__global__ void traceback_walk_kernel(
    const uint8_t* __restrict__ bp, const float* __restrict__ cM,
    const float* __restrict__ cD, const float* __restrict__ cI,
    const int32_t* __restrict__ lens_a, const int32_t* __restrict__ lens_b,
    int8_t* __restrict__ ops, float* __restrict__ score,
    int32_t* __restrict__ state, int B, int R, int Cp, int k, int max_steps,
    int S, int band_row0) {
  extern __shared__ __align__(16) uint8_t wsmem[];
  const int H = 2 * k * S;
  const int wb = ((H + 31) + 15) & ~15;  // bytes of a window row
  const int win_bytes = (H + 1) * wb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= B) return;
  // this warp's windows at wsmem[mine], wsmem[mine + win_bytes], its staged
  // ops after them: offsets into wsmem, so that reads are shared-memory loads
  const int mine = warp * (2 * win_bytes + ((S + 15) & ~15));
  const int staged = mine + 2 * win_bytes;
  const uint8_t* bpp = bp + (size_t)p * R * Cp;
  const int r0 = kBand ? band_row0 : 0;  // the stack's first row

  int i, j, s;
  unsigned st;
  if (!kBand || cM != nullptr) {  // start at the corner
    const float m = cM[p], d = cD[p], x = cI[p];
    st = argmax_mdi(m, d, x);
    if (lane == 0) score[p] = fmaxf(m, fmaxf(d, x));
    i = lens_a[p] + k - 1;
    j = lens_b[p] + k - 1;
    s = 0;
  } else {
    i = state[p];
    j = state[B + p];
    st = (unsigned)state[2 * B + p];
    s = state[3 * B + p];
  }
  // the walk stops at (k-1, k-1), and a band's walk below its first row;
  // i, j < 0 (or i past the band) only on a malformed bp stack or state
  auto inside = [&]() {
    return (i > k - 1 || j > k - 1) && i >= r0 && j >= 0 && (!kBand || i - r0 < R);
  };
  bool done = !(s < max_steps && inside());
  Window cur = {0, 0};
  if (!done) {
    cur = fetch_window(bpp, Cp, i - r0, j, H, wb, wsmem + mine, lane);
    window_arrived();
  }
  for (int round = 0; !done; ++round) {
    // from the second round on, the next window is fetched at the walk's
    // position while lane 0 walks on in the current one
    Window next = cur;
    if (round > 0)
      next = fetch_window(bpp, Cp, i - r0, j, H, wb,
                          wsmem + mine + (round & 1) * win_bytes, lane);
    const int w = mine + ((round > 0 ? round - 1 : 0) & 1) * win_bytes;
    int n = 0;
    if (lane == 0) {
      // cell (i, j) at wsmem[org + (i - r0) * wb + j]
      const int org = w - cur.r0 * wb - cur.c0;
      const int lim = min(S, max_steps - s);
      for (; n < lim; ++n) {
        if (!inside()) {
          done = true;
          break;
        }
        const unsigned code = wsmem[org + (i - r0) * wb + j];
        wsmem[staged + n] = (uint8_t)st;
        i -= st == 0 ? 1 : (st == 1 ? k : 0);
        j -= st == 0 ? 1 : (st == 1 ? 0 : k);
        st = (code >> (2 * st)) & 3u;
      }
      if (!(s + n < max_steps && inside())) done = true;
    }
    __syncwarp();
    n = __shfl_sync(0xffffffffu, n, 0);
    i = __shfl_sync(0xffffffffu, i, 0);
    j = __shfl_sync(0xffffffffu, j, 0);
    st = __shfl_sync(0xffffffffu, st, 0);
    done = __shfl_sync(0xffffffffu, (int)done, 0) != 0;
    for (int q = lane; q < n; q += 32)
      ops[(size_t)(s + q) * B + p] = (int8_t)wsmem[staged + q];
    s += n;
    if (round > 0) {
      window_arrived();  // also: every lane has read `staged`
      cur = next;
    } else {
      __syncwarp();
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  if constexpr (kBand) {  // the caller filled ops with -1
    if (lane == 0) {
      state[p] = i;
      state[B + p] = j;
      state[2 * B + p] = (int32_t)st;
      state[3 * B + p] = s;
    }
  } else {
    for (int q = s + lane; q < max_steps; q += 32) ops[(size_t)q * B + p] = -1;
  }
}

// One window of a segment: diagonals [t0, ta] x columns [c0, ja] of pair
// p's bp_seg, anchored at (ta, ja) (ta = i + j - d0), clipped at 0. Row r is
// copied from the 16-byte boundary at or below the address of cell
// (t0 + r, c0), so it starts at byte off(r) = (a0 + r * C) mod 16 of
// win + r * wb, a0 the offset of cell (t0, c0)'s address.
struct SegWindow {
  int t0, c0, a0;
};

__device__ __forceinline__ SegWindow fetch_seg_window(
    const uint8_t* bpp, int C, int ta, int ja, int Hd, int Hc, int wb,
    uint8_t* win, int lane) {
  SegWindow v;
  v.t0 = max(ta - Hd, 0);
  v.c0 = max(ja - Hc, 0);
  const uint8_t* first = bpp + (size_t)v.t0 * C + v.c0;
  v.a0 = (int)(reinterpret_cast<uintptr_t>(first) & 15);
  const int span = ja - v.c0 + 1;     // bytes a row holds
  const int nch = (span + 30) >> 4;   // 16-byte chunks a row may need, <= 32
  const int per = 32 / nch;           // rows the warp copies at once
  const int rows = ta - v.t0 + 1;
  const int cm = C & 15;
  const unsigned base = (unsigned)__cvta_generic_to_shared(win);
  const int c = lane % nch;
  for (int r = lane / nch; lane < per * nch && r < rows; r += per) {
    const int off = (v.a0 + r * cm) & 15;
    if (16 * c < off + span) {  // chunk c holds bytes of this row
      const uint8_t* src = first + (size_t)r * C - off + 16 * c;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       base + (unsigned)(r * wb + 16 * c)),
                   "l"(src)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  return v;
}

// A warp walks one pair. A step lowers the diagonal d = i + j by 2 and j by
// 1 (match) or d by k and j by 0 or k (gaps), so the 2S steps after (d, j)
// stay in diagonals [d - Hd, d] x columns [j - Hc, j], Hd = 2 max(2, k) S,
// Hc = 2 k S: the windows and rounds of traceback_walk_kernel, in diagonal
// layout. Shared memory a warp: two windows of (Hd + 1) rows of wb bytes,
// and S op codes; kernels/traceback_walk.py segment_window_bytes repeats it.
__global__ void traceback_walk_segment_kernel(
    const uint8_t* __restrict__ bp, const float* __restrict__ adj,
    const int32_t* __restrict__ lens_a, const int32_t* __restrict__ lens_b,
    float* __restrict__ score, int32_t* __restrict__ state,
    int8_t* __restrict__ ops, int B, int T, int C, int k, int d0,
    int max_steps, int S) {
  extern __shared__ __align__(16) uint8_t wsmem[];
  const int Hd = 2 * max(k, 2) * S;
  const int Hc = 2 * k * S;
  const int wb = (Hc + 31) & ~15;  // bytes of a window row: offset + Hc + 1
  const int win_bytes = (Hd + 1) * wb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= B) return;
  const int mine = warp * (2 * win_bytes + ((S + 15) & ~15));
  const int staged = mine + 2 * win_bytes;
  const int cm = C & 15;
  const uint8_t* bpp = bp + (size_t)p * T * C;

  int i, j, s;
  unsigned st;
  if (adj != nullptr) {  // first launch of the walk: start at the corner
    const float m = adj[p], d = adj[B + p], x = adj[2 * B + p];
    if (lane == 0) score[p] = fmaxf(m, fmaxf(d, x));
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
  // the walk goes on while its cell is inside the matrix and this segment;
  // i + j - d0 >= T, or i, j < 0, comes only from a malformed bp stack
  auto going = [&](int n) {
    return s + n < max_steps && (i > k - 1 || j > k - 1) && i >= 0 && j >= 0 &&
           i + j >= d0 && i + j - d0 < T;
  };
  bool done = !going(0);
  SegWindow cur = {0, 0, 0};
  if (!done) {
    cur = fetch_seg_window(bpp, C, i + j - d0, j, Hd, Hc, wb, wsmem + mine, lane);
    window_arrived();
  }
  for (int round = 0; !done; ++round) {
    // from the second round on, the next window is fetched at the walk's
    // position while lane 0 walks on in the current one
    SegWindow next = cur;
    if (round > 0)
      next = fetch_seg_window(bpp, C, i + j - d0, j, Hd, Hc, wb,
                              wsmem + mine + (round & 1) * win_bytes, lane);
    const int w = mine + ((round > 0 ? round - 1 : 0) & 1) * win_bytes;
    int n = 0;
    if (lane == 0) {
      const int lim = min(S, max_steps - s);
      // the walk moves by t = i + j - d0 and j; a step lowers i and j by at
      // most k and t by at most max(2, k), so the first `sure` steps stay
      // inside the matrix and the segment and need no test
      int t = i + j - d0;
      const int sure = min(lim, min(min(i, j) / k, t / max(k, 2) + 1));
      const int org = w - cur.c0;  // cell (t0 + u, j) at org + u * wb + off(u) + j
      auto step = [&]() {
        const int u = t - cur.t0;
        const unsigned code = wsmem[org + u * wb + ((cur.a0 + u * cm) & 15) + j];
        wsmem[staged + n] = (uint8_t)st;
        t -= st == 0 ? 2 : k;
        j -= st == 0 ? 1 : (st == 1 ? 0 : k);
        st = (code >> (2 * st)) & 3u;
      };
#pragma unroll 4
      for (; n < sure; ++n) step();
      for (; n < lim; ++n) {
        i = t + d0 - j;
        if (!going(n)) break;
        step();
      }
      i = t + d0 - j;
      done = !going(n);
    }
    __syncwarp();
    n = __shfl_sync(0xffffffffu, n, 0);
    i = __shfl_sync(0xffffffffu, i, 0);
    j = __shfl_sync(0xffffffffu, j, 0);
    st = __shfl_sync(0xffffffffu, st, 0);
    done = __shfl_sync(0xffffffffu, (int)done, 0) != 0;
    for (int q = lane; q < n; q += 32)
      ops[(size_t)(s + q) * B + p] = (int8_t)wsmem[staged + q];
    s += n;
    if (round > 0) {
      window_arrived();  // also: every lane has read `staged`
      cur = next;
    } else {
      __syncwarp();
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  if (lane == 0) {
    state[p] = i;
    state[B + p] = j;
    state[2 * B + p] = (int32_t)st;
    state[3 * B + p] = s;
  }
}

}  // namespace

extern "C" int coati_traceback_walk(
    const void* bp, const void* cM, const void* cD, const void* cI,
    const void* lens_a, const void* lens_b, void* ops, void* score, int B,
    int R, int Cp, int k, int max_steps, int S, int warps, void* stream) {
  if (B == 0) return 0;
  const int H = 2 * k * S;
  const int wb = ((H + 31) + 15) & ~15;
  // a window row is at most 32 copies of 16 bytes (fetch_window)
  if (S < 1 || warps < 1 || warps > 32 || Cp % 16 != 0 || wb > 32 * 16)
    return (int)cudaErrorInvalidValue;
  const size_t per_warp = 2 * (size_t)(H + 1) * wb + ((S + 15) & ~15);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        traceback_walk_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  traceback_walk_kernel<false><<<(B + warps - 1) / warps, 32 * warps, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bp), static_cast<const float*>(cM),
      static_cast<const float*>(cD), static_cast<const float*>(cI),
      static_cast<const int32_t*>(lens_a), static_cast<const int32_t*>(lens_b),
      static_cast<int8_t*>(ops), static_cast<float*>(score), nullptr, B, R, Cp,
      k, max_steps, S, 0);
  return (int)cudaGetLastError();
}

// One band of rows [row0, row0 + R) of the long path, bp [B, R, Cp]. adj
// ([3, B] terminal-adjusted corners), lens_a, lens_b and score are all given
// on a walk's first launch and all null on the later ones.
extern "C" int coati_traceback_walk_band(
    const void* bp, const void* adj, const void* lens_a, const void* lens_b,
    void* score, void* state, void* ops, int B, int R, int Cp, int k,
    int row0, int max_steps, int S, int warps, void* stream) {
  if (B == 0) return 0;
  const int H = 2 * k * S;
  const int wb = ((H + 31) + 15) & ~15;
  if (S < 1 || warps < 1 || warps > 32 || Cp % 16 != 0 || wb > 32 * 16 ||
      row0 < 0 || R < 1 || (adj == nullptr) != (score == nullptr) ||
      (adj != nullptr && (lens_a == nullptr || lens_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t per_warp = 2 * (size_t)(H + 1) * wb + ((S + 15) & ~15);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        traceback_walk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float* a = static_cast<const float*>(adj);
  traceback_walk_kernel<true><<<(B + warps - 1) / warps, 32 * warps, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bp), a, a ? a + B : nullptr,
      a ? a + 2 * B : nullptr, static_cast<const int32_t*>(lens_a),
      static_cast<const int32_t*>(lens_b), static_cast<int8_t*>(ops),
      static_cast<float*>(score), static_cast<int32_t*>(state), B, R, Cp, k,
      max_steps, S, row0);
  return (int)cudaGetLastError();
}

// adj, lens_a, lens_b and score are all given on a walk's first launch and
// all null on the later ones.
extern "C" int coati_traceback_walk_segment(
    const void* bp, const void* adj, const void* lens_a, const void* lens_b,
    void* score, void* state, void* ops, int B, int T, int C, int k, int d0,
    int max_steps, int S, int warps, void* stream) {
  if (B == 0) return 0;
  const int Hd = 2 * (k > 2 ? k : 2) * S;
  const int wb = (2 * k * S + 31) & ~15;
  // a window row is at most 32 copies of 16 bytes (fetch_seg_window)
  if (S < 1 || warps < 1 || warps > 32 || wb > 32 * 16)
    return (int)cudaErrorInvalidValue;
  const size_t per_warp = 2 * (size_t)(Hd + 1) * wb + ((S + 15) & ~15);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        traceback_walk_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  traceback_walk_segment_kernel<<<(B + warps - 1) / warps, 32 * warps, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bp), static_cast<const float*>(adj),
      static_cast<const int32_t*>(lens_a), static_cast<const int32_t*>(lens_b),
      static_cast<float*>(score), static_cast<int32_t*>(state),
      static_cast<int8_t*>(ops), B, T, C, k, d0, max_steps, S);
  return (int)cudaGetLastError();
}
