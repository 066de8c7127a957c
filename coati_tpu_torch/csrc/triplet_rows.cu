// Forward rows of the triplet (codon-context) pair-HMM: S codon steps of the
// max-plus row sweep from a carried collapsed boundary.
//
// Replaces coati_tpu/kernels/triplet_pallas.py triplet_rows_pallas (body
// _make_kernel) and the scan coati_tpu/triplet_wavefront.py
// _triplet_rows_carry it stands in for. Per codon step the 61 descendant-codon
// lanes are factored into 4 phase-1, 16 phase-2 and 16 phase-3 row variants;
// the in-row insertion is an exclusive prefix maximum; the step ends in the
// collapsed boundary rows (M, D, I) and, per state, the first-maximal lane.
//
// One block a pair, one column a thread, a tile of blockDim.x columns at a
// time. Within one codon step a column depends only on columns to its left
// (the prefix maxima and the j - 1 shifts), so a tile runs through all three
// phases before the next begins, with the 22 running maxima in registers and
// the last column's 45 values handed on in shared memory: rows of any width
// need no scratch for the row variants. A step reads the boundary below it
// and writes the one above, both in device memory: the grid itself when it is
// kept, two alternating boundaries of scratch when only the carry is wanted.
// Only the pair's own steps and columns are computed.
//
// What bounds it on an H100: a step is a chain of eight block-wide scans and
// shifts (some dozen barriers a tile), and the steps of a pair are sequential,
// so it is a latency chain: B blocks, each busy with barriers, far from both
// the 15 B a cell it stores and the ~500 f32 operations a cell it does.
//
// Every add keeps the reference's grouping (triplet_pallas.py:74-83, :129-145)
// and every argmax its first-maximum rule (strict > from the first candidate
// up), so rows and lanes are the reference's bits. Compile with -fmad=false.

#include "triplet_common.cuh"

namespace {

using namespace coati_triplet;

// kMaxThreads bounds the registers a thread may take: 128 at 512 threads.
__global__ void __launch_bounds__(kMaxThreads) triplet_rows_kernel(
    const int32_t* __restrict__ anc_cods, const int32_t* __restrict__ des,
    const float* __restrict__ ins_off, const int32_t* __restrict__ steps,
    const int32_t* __restrict__ lens_m, const float* __restrict__ logP64,
    const float* __restrict__ match_emit, const float* __restrict__ gc,
    const float* carry_in, float* grid, uint8_t* amax, float* carry_out,
    float* scratch, int B, int m, int S) {
  __shared__ float cost[64];
  __shared__ float KD[16];
  __shared__ int KDpay[16];
  __shared__ float sh_f[16 * kMaxWarps];
  __shared__ int sh_i[kMaxWarps];
  __shared__ float edge[kMaxWarps * 36];
  __shared__ float tile1[2][9];
  __shared__ float tile2[2][36];

  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int Cc = m + 1;
  const int Cb = lens_m[b] + 1;  // the pair's own columns
  const int nsteps = min(max(steps[b], 0), S);
  const int ntiles = (Cb + T - 1) / T;
  const Gap g = load_gap(gc);
  const size_t plane = (size_t)B * Cc;  // one state of one boundary
  const size_t pair = (size_t)b * Cc;
  const float ninf = -INFINITY;

  const float* prev = carry_in;  // the boundary below the step
  for (int t = 0; t < nsteps; ++t) {
    float* cur = grid != nullptr ? grid + (size_t)t * 3 * plane
                                 : scratch + (size_t)(t & 1) * 3 * plane;
    const int cod = anc_cods[(size_t)b * S + t];
    for (int q = tid; q < 64; q += T) cost[q] = logP64[cod * 64 + q];
    __syncthreads();
    // the deletion lanes' entry cost: first-maximal x3 of each group; read
    // in phase 3, behind the barriers of the scans before it
    for (int q = tid; q < 16; q += T) {
      float kd = cost[4 * q];
      int pay = 0;
      for (int x3 = 1; x3 < 4; ++x3) {
        const float c = cost[4 * q + x3];
        if (c > kd) {
          kd = c;
          pay = x3;
        }
      }
      KD[q] = kd;
      KDpay[q] = pay;
    }

    float run1[4], run2[16], runW[1] = {ninf};
    int runC[1] = {-1};
#pragma unroll
    for (int x = 0; x < 4; ++x) run1[x] = ninf;
#pragma unroll
    for (int q = 0; q < 16; ++q) run2[q] = ninf;

    for (int k = 0; k < ntiles; ++k) {
      const int j = k * T + tid;
      const bool valid = j < Cb;
      float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float off = 0.0f;
      float Mc = kNeg, Dc = kNeg, Ic = kNeg, sMc = kNeg, sDc = kNeg, sIc = kNeg;
      if (valid) {
        off = ins_off[pair + j];
        Mc = prev[pair + j];
        Dc = prev[plane + pair + j];
        Ic = prev[2 * plane + pair + j];
        if (j >= 1) {
          const int d = des[(size_t)b * m + j - 1];
#pragma unroll
          for (int x = 0; x < 4; ++x) e[x] = match_emit[x * 5 + d];
          sMc = prev[pair + j - 1];
          sDc = prev[plane + pair + j - 1];
          sIc = prev[2 * plane + pair + j - 1];
        }
      }

      // phase 1: 4 variants by x1
      const float core1 = shiftmax3(g, j, sMc, sDc, sIc);
      float M1[4], I1[4], D1[1];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        M1[x] = __fadd_rn(core1, e[x]);
        I1[x] = __fsub_rn(M1[x], off);
      }
      D1[0] = dmax3(g, Mc, Dc, Ic);
      scan_excl_max<float, 4>(I1, run1, sh_f, ninf);
#pragma unroll
      for (int x = 0; x < 4; ++x) I1[x] = ins_value(g, j, I1[x], off);
      float sM1[4], sD1[1], sI1[4];
      shift_left<4, 1, 4>(M1, D1, I1, sM1, sD1, sI1, edge, tile1[k & 1],
                          tile1[(k + 1) & 1]);

      // phase 2: 16 variants by (x1, x2)
      float M2[16], I2[16], D2[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float core2 = shiftmax3(g, j, sM1[x], sD1[0], sI1[x]);
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          M2[4 * x + y] = __fadd_rn(core2, e[y]);
          I2[4 * x + y] = __fsub_rn(M2[4 * x + y], off);
        }
        D2[x] = dmax3(g, M1[x], D1[0], I1[x]);
      }
      scan_excl_max<float, 16>(I2, run2, sh_f, ninf);
#pragma unroll
      for (int q = 0; q < 16; ++q) I2[q] = ins_value(g, j, I2[q], off);
      float sM2[16], sD2[4], sI2[16];
      shift_left<16, 4, 16>(M2, D2, I2, sM2, sD2, sI2, edge, tile2[k & 1],
                            tile2[(k + 1) & 1]);

      // phase 3: the 16 cores, the entry cost folded in as the first-maximal
      // x3 of cost + e; then the collapse over the 16 groups
      float Mbest = 0.0f, Dbest = 0.0f, Wbest = 0.0f;
      int laneM = 0, laneD = 0, laneW = 0;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float core3 = shiftmax3(g, j, sM2[q], sD2[q >> 2], sI2[q]);
        const float D3 = dmax3(g, M2[q], D2[q >> 2], I2[q]);
        float kk = __fadd_rn(cost[4 * q], e[0]);
        int pay = 0;
#pragma unroll
        for (int x3 = 1; x3 < 4; ++x3) {
          const float v = __fadd_rn(cost[4 * q + x3], e[x3]);
          if (v > kk) {
            kk = v;
            pay = x3;
          }
        }
        const float Ml = __fadd_rn(core3, kk);
        const float Dl = __fadd_rn(D3, KD[q]);
        const float W = __fsub_rn(Ml, off);
        if (q == 0 || Ml > Mbest) {
          Mbest = Ml;
          laneM = 4 * q + pay;
        }
        if (q == 0 || Dl > Dbest) {
          Dbest = Dl;
          laneD = 4 * q + KDpay[q];
        }
        if (q == 0 || W > Wbest) {
          Wbest = W;
          laneW = 4 * q + pay;
        }
      }
      float excl[1] = {Wbest};
      scan_excl_max<float, 1>(excl, runW, sh_f, ninf);
      const float Inew = ins_value(g, j, excl[0], off);
      // the I lane: the earliest column that reaches the running maximum
      int code[1] = {Wbest > excl[0] ? j * 64 + laneW : -1};
      scan_excl_max<int, 1>(code, runC, sh_i, -1);
      if (valid) {
        cur[pair + j] = Mbest;
        cur[plane + pair + j] = Dbest;
        cur[2 * plane + pair + j] = Inew;
        if (amax != nullptr) {
          uint8_t* am = amax + (size_t)t * 3 * plane + pair + j;
          am[0] = (uint8_t)laneM;
          am[plane] = (uint8_t)laneD;
          // & 63 is the floor modulus, also of a negative
          am[2 * plane] = (uint8_t)(j < 1 ? 0 : (code[0] & 63));
        }
      }
      __syncthreads();  // the row is written; the shared buffers are free
    }
    prev = cur;
  }
  if (carry_out != nullptr) {
    for (int j = tid; j < Cb; j += T) {
      carry_out[pair + j] = prev[pair + j];
      carry_out[plane + pair + j] = prev[plane + pair + j];
      carry_out[2 * plane + pair + j] = prev[2 * plane + pair + j];
    }
  }
}

}  // namespace

// grid and amax are both given (the rows are kept) or both null (then scratch
// [2, 3, B, m + 1] is given and only carry_out is written).
extern "C" int coati_triplet_rows(
    const void* anc_cods, const void* des, const void* ins_off,
    const void* steps, const void* lens_m, const void* logP64,
    const void* match_emit, const void* gc, const void* carry_in, void* grid,
    void* amax, void* carry_out, void* scratch, int B, int m, int S,
    int threads, void* stream) {
  if (B == 0) return 0;
  if (!block_ok(threads)) return (int)cudaErrorInvalidValue;
  triplet_rows_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(anc_cods), static_cast<const int32_t*>(des),
      static_cast<const float*>(ins_off), static_cast<const int32_t*>(steps),
      static_cast<const int32_t*>(lens_m), static_cast<const float*>(logP64),
      static_cast<const float*>(match_emit), static_cast<const float*>(gc),
      static_cast<const float*>(carry_in), static_cast<float*>(grid),
      static_cast<uint8_t*>(amax), static_cast<float*>(carry_out),
      static_cast<float*>(scratch), B, m, S);
  return (int)cudaGetLastError();
}
