// Traceback walk of the triplet (codon-context) pair-HMM over S codon blocks,
// top to bottom, with the (i, j, state) of every pair carried in and out.
//
// Replaces coati_tpu/kernels/triplet_pallas.py triplet_walk_pallas (body
// _make_walk_kernel) and the scan coati_tpu/triplet_wavefront.py
// _triplet_walk_seg_xla it stands in for. A pair enters a block at its top
// boundary: its descendant-codon lane is read from the forward's argmax
// lanes at (state, j); the block's three rows are computed again for that one
// lane from the boundary below; then six phases (insertion run, down-step,
// three times) move the pair to the block's base. Row 6 t + phase of `ops`
// holds op | count << 2 for block t; rows with count 0 are skipped by the
// decoder, and are written with the reference's values all the same.
//
// One block a pair. The recompute needs only columns 0..j of the three rows:
// one column a thread, a tile at a time, three prefix maxima and two shifts
// a tile (triplet_common.cuh), the nine row values stored to a per-pair
// scratch in device memory. Thread 0 then walks the six phases with direct
// reads: a cell read is max(value, NEG), as the reference's one-hot select
// with fill NEG gives; an insertion run's exit is the last column u <= j - 1
// with (M[u] + go) > (I[u] + ge), the literal f32 test, found by stepping
// left, and 0 when there is none (the select's fill). A pair that has not
// started or has finished costs six stores a block.
//
// What bounds it on an H100: latency. A pair's blocks are sequential, each a
// dozen barriers of the recompute and some twenty dependent reads of thread
// 0; the bytes (12 B of boundary and 3 B of lanes a column of each block's
// row below the pair) and the ~40 operations a recomputed cell are far off.
// Compile with -fmad=false.

#include "triplet_common.cuh"

namespace {

using namespace coati_triplet;

__device__ __forceinline__ int amax_pref(float a, float b, float c) {
  const int code = b > a ? 1 : 0;
  return c > fmaxf(a, b) ? 2 : code;
}

// A cell read as the reference's one-hot select with fill NEG sees it.
__device__ __forceinline__ float cell(const float* row, int col) {
  return col < 0 ? kNeg : fmaxf(row[col], kNeg);
}

__global__ void __launch_bounds__(kMaxThreads) triplet_walk_kernel(
    const float* __restrict__ grid, const uint8_t* __restrict__ amax,
    const int32_t* __restrict__ anc_seg, const int32_t* __restrict__ des,
    const float* __restrict__ ins_off, const float* __restrict__ logP64,
    const float* __restrict__ match_emit, const float* __restrict__ gc,
    int32_t* __restrict__ state, int32_t* __restrict__ ops, float* scratch,
    int B, int m, int S, int t_lo) {
  __shared__ int s_state[3];
  __shared__ float sh_f[kMaxWarps];
  __shared__ float edge[kMaxWarps * 3];
  __shared__ float tile1[2][3];
  __shared__ float tile2[2][3];

  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int Cc = m + 1;
  const Gap g = load_gap(gc);
  const size_t plane = (size_t)B * Cc;
  const size_t pair = (size_t)b * Cc;
  float* rows = scratch + (size_t)b * 9 * Cc;  // M1 D1 I1 M2 D2 I2 M3 D3 I3
  const float ninf = -INFINITY;

  if (tid == 0) {
    s_state[0] = state[b];
    s_state[1] = state[B + b];
    s_state[2] = state[2 * B + b];
  }
  __syncthreads();

  for (int t = S - 1; t >= 0; --t) {
    int i = s_state[0], j = s_state[1], st = s_state[2];
    const int base_i = 3 * (t_lo + t);
    int32_t* out = ops + (size_t)6 * (t_lo + t) * B + b;  // row ph at out[ph * B]
    if (!(i > base_i && (i > 0 || j > 0))) {
      // not started or finished: nothing moves, the rows carry count 0
      if (tid < 6) out[(size_t)tid * B] = (tid & 1) ? st : 2;
      continue;
    }
    const float* bnd = grid + (size_t)t * 3 * plane + pair;  // M at bnd, D, I a plane on
    const int s3 = st == 0 ? 0 : (st == 1 ? 1 : 2);
    const int lane = amax[((size_t)t * 3 + s3) * plane + pair + j];
    const int cod = anc_seg[(size_t)b * S + t];
    const float cost_s = lane < 64 ? fmaxf(logP64[cod * 64 + lane], kNeg) : kNeg;
    const int x1 = (lane >> 4) & 3, x2 = (lane >> 2) & 3, x3 = lane & 3;

    // the block's rows for this lane, columns 0..j
    const int ncol = j + 1;
    const int ntiles = (ncol + T - 1) / T;
    float run1[1] = {ninf}, run2[1] = {ninf}, run3[1] = {ninf};
    for (int k = 0; k < ntiles; ++k) {
      const int c = k * T + tid;
      const bool valid = c < ncol;
      float e1 = 0.0f, e2 = 0.0f, e3 = 0.0f, off = 0.0f;
      float Mr = kNeg, Dr = kNeg, Ir = kNeg, sMr = kNeg, sDr = kNeg, sIr = kNeg;
      if (valid) {
        off = ins_off[pair + c];
        Mr = bnd[c];
        Dr = bnd[plane + c];
        Ir = bnd[2 * plane + c];
        if (c >= 1) {
          const int d = des[(size_t)b * m + c - 1];
          e1 = match_emit[x1 * 5 + d];
          e2 = match_emit[x2 * 5 + d];
          e3 = match_emit[x3 * 5 + d];
          sMr = bnd[c - 1];
          sDr = bnd[plane + c - 1];
          sIr = bnd[2 * plane + c - 1];
        }
      }
      float M1[1], D1[1], I1[1], sM[1], sD[1], sI[1];
      M1[0] = __fadd_rn(shiftmax3(g, c, sMr, sDr, sIr), e1);
      D1[0] = dmax3(g, Mr, Dr, Ir);
      I1[0] = __fsub_rn(M1[0], off);
      scan_excl_max<float, 1>(I1, run1, sh_f, ninf);
      I1[0] = ins_value(g, c, I1[0], off);
      shift_left<1, 1, 1>(M1, D1, I1, sM, sD, sI, edge, tile1[k & 1],
                          tile1[(k + 1) & 1]);

      float M2[1], D2[1], I2[1];
      M2[0] = __fadd_rn(shiftmax3(g, c, sM[0], sD[0], sI[0]), e2);
      D2[0] = dmax3(g, M1[0], D1[0], I1[0]);
      I2[0] = __fsub_rn(M2[0], off);
      scan_excl_max<float, 1>(I2, run2, sh_f, ninf);
      I2[0] = ins_value(g, c, I2[0], off);
      shift_left<1, 1, 1>(M2, D2, I2, sM, sD, sI, edge, tile2[k & 1],
                          tile2[(k + 1) & 1]);

      // phase 3 carries the lane's entry cost: core3 + (cost + e3)
      const float M3 = __fadd_rn(shiftmax3(g, c, sM[0], sD[0], sI[0]),
                                 __fadd_rn(cost_s, e3));
      const float D3 = __fadd_rn(dmax3(g, M2[0], D2[0], I2[0]), cost_s);
      float I3[1] = {__fsub_rn(M3, off)};
      scan_excl_max<float, 1>(I3, run3, sh_f, ninf);
      I3[0] = ins_value(g, c, I3[0], off);
      if (valid) {
        rows[c] = M1[0];
        rows[Cc + c] = D1[0];
        rows[2 * Cc + c] = I1[0];
        rows[3 * Cc + c] = M2[0];
        rows[4 * Cc + c] = D2[0];
        rows[5 * Cc + c] = I2[0];
        rows[6 * Cc + c] = M3;
        rows[7 * Cc + c] = D3;
        rows[8 * Cc + c] = I3[0];
      }
      __syncthreads();  // the rows are written; the shared buffers are free
    }

    if (tid == 0) {
      for (int ph = 0; ph < 6; ++ph) {
        const bool act = i > base_i && (i > 0 || j > 0);
        if ((ph & 1) == 0) {  // the insertion run at row 3 - ph / 2
          const int r = 2 - ph / 2;
          const float* Mrow = rows + (size_t)(3 * r) * Cc;
          const float* Irow = rows + (size_t)(3 * r + 2) * Cc;
          const bool run_here = act && st == 2;
          int cnt = 0;
          if (run_here) {
            int u = j - 1;
            while (u >= 0 &&
                   !(__fadd_rn(Mrow[u], g.go) > __fadd_rn(Irow[u], g.ge)))
              --u;
            if (u < 0) u = 0;
            cnt = j - u;
            j = u;
            st = 0;
          }
          out[(size_t)ph * B] = 2 | (cnt << 2);
        } else {  // one M or D down-step, reading the row below
          const int rb = 1 - ph / 2;
          const int pj = j - (st == 0 ? 1 : 0);
          out[(size_t)ph * B] = st | ((act ? 1 : 0) << 2);
          if (act) {
            float mv, dv, iv;
            if (ph < 5) {
              mv = cell(rows + (size_t)(3 * rb) * Cc, pj);
              dv = cell(rows + (size_t)(3 * rb + 1) * Cc, pj);
              iv = cell(rows + (size_t)(3 * rb + 2) * Cc, pj);
            } else {  // the crossing: the boundary below the block
              mv = cell(bnd, pj);
              dv = cell(bnd + plane, pj);
              iv = cell(bnd + 2 * plane, pj);
            }
            const int nxt =
                st == 0 ? amax_pref(__fadd_rn(mv, g.ng_ng), __fadd_rn(dv, g.gs),
                                    __fadd_rn(iv, g.gs_ng))
                        : amax_pref(__fadd_rn(mv, g.ng_go), __fadd_rn(dv, g.ge),
                                    __fadd_rn(iv, g.gs_go));
            i -= 1;
            j = pj;
            st = nxt;
          }
        }
      }
      s_state[0] = i;
      s_state[1] = j;
      s_state[2] = st;
    }
    __syncthreads();
  }
  if (tid == 0) {
    state[b] = s_state[0];
    state[B + b] = s_state[1];
    state[2 * B + b] = s_state[2];
  }
}

}  // namespace

// grid [>= S, 3, B, m + 1] f32: boundary t_lo + t at row t, the base of
// block t; amax [S, 3, B, m + 1] uint8: the lanes at boundary t_lo + t + 1,
// its top; anc_seg [B, S]; state [3, B] int32 (i, j, st), updated in place;
// ops [6 * n_cod, B] int32, rows 6 t_lo .. 6 (t_lo + S) - 1 written; scratch
// [B, 9, m + 1] f32.
extern "C" int coati_triplet_walk(
    const void* grid, const void* amax, const void* anc_seg, const void* des,
    const void* ins_off, const void* logP64, const void* match_emit,
    const void* gc, void* state, void* ops, void* scratch, int B, int m, int S,
    int t_lo, int threads, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (!block_ok(threads)) return (int)cudaErrorInvalidValue;
  triplet_walk_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), static_cast<const uint8_t*>(amax),
      static_cast<const int32_t*>(anc_seg), static_cast<const int32_t*>(des),
      static_cast<const float*>(ins_off), static_cast<const float*>(logP64),
      static_cast<const float*>(match_emit), static_cast<const float*>(gc),
      static_cast<int32_t*>(state), static_cast<int32_t*>(ops),
      static_cast<float*>(scratch), B, m, S, t_lo);
  return (int)cudaGetLastError();
}
