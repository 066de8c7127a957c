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
// One column a thread, a tile of blockDim.x columns at a time. Within one
// codon step a column depends only on columns to its left (the prefix maxima
// and the j - 1 shifts), so a tile runs through all three phases before the
// next begins, with the 22 running maxima in registers and the last column's
// 45 values handed on in shared memory: rows of any width need no scratch
// for the row variants. A step reads the boundary below it and writes the one
// above, both in device memory: the grid itself when it is kept, two
// alternating boundaries of scratch when only the carry is wanted. Only the
// pair's own steps and columns are computed.
//
// Bands. A pair's columns are cut into bands of whole tiles, one block a
// band (one band a pair is one block a pair). Everything a band's first tile
// takes from the columns to its left at step t is a record of 70 values: the
// 22 running maxima, the left column's 45 phase values, and the M, D, I of
// the boundary below at that column. A band publishes its record of step t
// into a ring of F records a band boundary in device memory, then makes a
// release store of its progress counter (steps done). Band b starts step t
// once an acquire load of band b - 1's counter shows t + 1, and copies the
// record into shared memory; it overwrites the slot of step t - F only once
// band b + 1's counter shows that step done (back-pressure). So the bands run
// the codon steps as a pipeline, each one step behind its left neighbour,
// and a band never reads another band's columns of the boundary: in the
// scratch form its left neighbour may already be writing the step after into
// the same scratch row. The launch is cooperative (a band spins on its
// neighbours, which must be on the card); a wait traps when the counter it
// reads has not moved for about a second.
//
// The 16 match-lane entry costs, first-max over x3 of cost[4q + x3] + e[x3],
// depend only on the step and the column's descendant nucleotide (e is 0 at
// column 0): a table of 6 classes x 16 groups built once a step.
//
// What bounds it on an H100: a tile is a chain of block-wide scans and
// shifts (a dozen barriers) and some 400 f32 operations a column, and a
// pair's steps are sequential; one band a pair leaves a lone wide pair on one
// SM. Bands put a pair's tiles on several SMs at once, each about one step
// and a hand-over behind its left neighbour.
//
// Every add keeps the reference's grouping (triplet_pallas.py:74-83, :129-145)
// and every argmax its first-maximum rule (strict > from the first candidate
// up), so rows and lanes are the reference's bits. Compile with -fmad=false.

#include <climits>

#include "triplet_common.cuh"

namespace {

using namespace coati_triplet;

// A band's record of one step, in f32 slots: run1 [4], run2 [16], runW,
// runC (int bits), the last column's phase-1 values (M1 [4], D1, I1 [4]) and
// phase-2 values (M2 [16], D2 [4], I2 [16]), and the boundary below at that
// column (M, D, I). kernels/triplet_rows.py RECORD repeats the size.
constexpr int kRun1 = 0, kRun2 = 4, kRunW = 20, kRunC = 21, kTile1 = 22,
              kTile2 = 31, kHalo = 67, kRecordUsed = 70, kRecord = 72;
constexpr int kClasses = 6;  // descendant code 0-4 at j >= 1; column 0
constexpr long long kStallCycles = 2000000000LL;  // about a second

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Spins until *flag >= target; `seen` is the value read before. Traps when
// the flag has not moved for about a second.
__device__ __noinline__ int wait_for(const int* flag, int target, int seen) {
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

// kMaxThreads bounds the registers a thread may take: 128 at 512 threads.
__global__ void __launch_bounds__(kMaxThreads) triplet_rows_kernel(
    const int32_t* __restrict__ anc_cods, const int32_t* __restrict__ des,
    const float* __restrict__ ins_off, const int32_t* __restrict__ steps,
    const int32_t* __restrict__ lens_m, const float* __restrict__ logP64,
    const float* __restrict__ match_emit, const float* __restrict__ gc,
    const float* carry_in, float* grid, uint8_t* amax, float* carry_out,
    float* scratch, float* records, int* progress, int B, int m, int S,
    int bands, int band_width, int slots) {
  __shared__ float cost[64];
  __shared__ float KD[16];
  __shared__ int KDpay[16];
  __shared__ float KK[kClasses * 16];  // first-max x3 of cost + e
  __shared__ int KKlane[kClasses * 16];  // and its lane 4q + x3
  __shared__ float sh_f[16 * kMaxWarps];
  __shared__ int sh_i[kMaxWarps];
  __shared__ float edge[kMaxWarps * 36];
  __shared__ float tile1[2][9];
  __shared__ float tile2[2][36];
  __shared__ float left[kRecord];  // the left band's record of this step

  const int b = blockIdx.x / bands, band = blockIdx.x % bands;
  const int tid = threadIdx.x, T = blockDim.x;
  const int Cc = m + 1;
  const int Cb = lens_m[b] + 1;  // the pair's own columns
  const int j0 = band * band_width;
  if (j0 >= Cb) return;  // no column of this pair
  const int j1 = min(j0 + band_width, Cb);
  const bool from_left = band > 0;
  const bool to_right = j1 < Cb;  // a band of this pair lies to the right
  const int nsteps = min(max(steps[b], 0), S);
  const int ntiles = (j1 - j0 + T - 1) / T;
  const Gap g = load_gap(gc);
  const size_t plane = (size_t)B * Cc;  // one state of one boundary
  const size_t pair = (size_t)b * Cc;
  const float ninf = -INFINITY;
  int* mine = progress != nullptr ? progress + (size_t)b * bands + band : nullptr;
  const size_t ring = (size_t)slots * kRecord;  // floats of one boundary's ring
  const float* rec_in =
      from_left ? records + ((size_t)b * (bands - 1) + band - 1) * ring : nullptr;
  float* rec_out = to_right ? records + ((size_t)b * (bands - 1) + band) * ring : nullptr;
  int left_seen = 0, right_seen = 0;

  const float* prev = carry_in;  // the boundary below the step
  for (int t = 0; t < nsteps; ++t) {
    float* cur = grid != nullptr ? grid + (size_t)t * 3 * plane
                                 : scratch + (size_t)(t & 1) * 3 * plane;
    const int cod = anc_cods[(size_t)b * S + t];
    if (from_left && tid == 0) left_seen = wait_for(mine - 1, t + 1, left_seen);
    for (int q = tid; q < 64; q += T) cost[q] = logP64[cod * 64 + q];
    __syncthreads();
    if (from_left)
      for (int q = tid; q < kRecordUsed; q += T)
        left[q] = __ldcg(rec_in + (size_t)(t % slots) * kRecord + q);
    // the entry costs, read in phase 3, behind the barriers of the scans
    // before it: the deletion lanes' first-maximal x3 of each group, and
    // the match lanes' of cost + e for each class of column
    for (int x = tid; x < 16 + kClasses * 16; x += T) {
      const int q = x & 15, d = (x >> 4) - 1;  // d -1: the deletion lanes; else a class
      float kd = 0.0f;
      int pay = 0;
      for (int x3 = 0; x3 < 4; ++x3) {
        const float e = d < 0 || d == kClasses - 1 ? 0.0f : match_emit[x3 * 5 + d];
        const float c = d < 0 ? cost[4 * q + x3] : __fadd_rn(cost[4 * q + x3], e);
        if (x3 == 0 || c > kd) {
          kd = c;
          pay = x3;
        }
      }
      if (d < 0) {
        KD[q] = kd;
        KDpay[q] = pay;
      } else {
        KK[d * 16 + q] = kd;
        KKlane[d * 16 + q] = 4 * q + pay;
      }
    }

    float run1[4], run2[16], runW[1] = {ninf};
    int runC[1] = {-1};
#pragma unroll
    for (int x = 0; x < 4; ++x) run1[x] = ninf;
#pragma unroll
    for (int q = 0; q < 16; ++q) run2[q] = ninf;
    if (from_left) {
      __syncthreads();  // the record is in shared memory
#pragma unroll
      for (int x = 0; x < 4; ++x) run1[x] = left[kRun1 + x];
#pragma unroll
      for (int q = 0; q < 16; ++q) run2[q] = left[kRun2 + q];
      runW[0] = left[kRunW];
      runC[0] = __float_as_int(left[kRunC]);
    }

    for (int k = 0; k < ntiles; ++k) {
      const int j = j0 + k * T + tid;
      const bool valid = j < j1;
      float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int cls = kClasses - 1;  // column 0, or no column of the pair
      float off = 0.0f;
      float Mc = kNeg, Dc = kNeg, Ic = kNeg, sMc = kNeg, sDc = kNeg, sIc = kNeg;
      if (valid) {
        off = ins_off[pair + j];
        Mc = prev[pair + j];
        Dc = prev[plane + pair + j];
        Ic = prev[2 * plane + pair + j];
        if (j >= 1) {
          cls = des[(size_t)b * m + j - 1];
#pragma unroll
          for (int x = 0; x < 4; ++x) e[x] = match_emit[x * 5 + cls];
          if (j == j0) {  // the left band's column, from its record
            sMc = left[kHalo];
            sDc = left[kHalo + 1];
            sIc = left[kHalo + 2];
          } else {
            sMc = prev[pair + j - 1];
            sDc = prev[plane + pair + j - 1];
            sIc = prev[2 * plane + pair + j - 1];
          }
        }
      }
      // the column left of the tile: the band's own last, or the record
      const bool first = k == 0 && from_left;

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
      shift_left<4, 1, 4>(M1, D1, I1, sM1, sD1, sI1, edge,
                          first ? left + kTile1 : tile1[k & 1], tile1[(k + 1) & 1]);

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
      shift_left<16, 4, 16>(M2, D2, I2, sM2, sD2, sI2, edge,
                            first ? left + kTile2 : tile2[k & 1], tile2[(k + 1) & 1]);

      // phase 3: the 16 cores, the entry cost folded in as the first-maximal
      // x3 of cost + e; then the collapse over the 16 groups
      float Mbest = 0.0f, Dbest = 0.0f, Wbest = 0.0f;
      int laneM = 0, laneD = 0, laneW = 0;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float core3 = shiftmax3(g, j, sM2[q], sD2[q >> 2], sI2[q]);
        const float D3 = dmax3(g, M2[q], D2[q >> 2], I2[q]);
        const float kk = KK[cls * 16 + q];
        const int lane = KKlane[cls * 16 + q];
        const float Ml = __fadd_rn(core3, kk);
        const float Dl = __fadd_rn(D3, KD[q]);
        const float W = __fsub_rn(Ml, off);
        if (q == 0 || Ml > Mbest) {
          Mbest = Ml;
          laneM = lane;
        }
        if (q == 0 || Dl > Dbest) {
          Dbest = Dl;
          laneD = 4 * q + KDpay[q];
        }
        if (q == 0 || W > Wbest) {
          Wbest = W;
          laneW = lane;
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
    if (mine != nullptr && tid == T - 1) {
      // the band's last thread holds its last column (bands but the pair's
      // last are whole tiles): it hands the step on to the right
      if (to_right) {
        // slot t % slots held step t - slots: the right band must have done it
        if (right_seen < t - slots + 1)
          right_seen = wait_for(mine + 1, t - slots + 1, right_seen);
        float* dst = rec_out + (size_t)(t % slots) * kRecord;
#pragma unroll
        for (int x = 0; x < 4; ++x) dst[kRun1 + x] = run1[x];
#pragma unroll
        for (int q = 0; q < 16; ++q) dst[kRun2 + q] = run2[q];
        dst[kRunW] = runW[0];
        dst[kRunC] = __int_as_float(runC[0]);
        const float* t1 = tile1[ntiles & 1];
        const float* t2 = tile2[ntiles & 1];
        for (int x = 0; x < 9; ++x) dst[kTile1 + x] = t1[x];
        for (int x = 0; x < 36; ++x) dst[kTile2 + x] = t2[x];
        dst[kHalo] = prev[pair + j1 - 1];
        dst[kHalo + 1] = prev[plane + pair + j1 - 1];
        dst[kHalo + 2] = prev[2 * plane + pair + j1 - 1];
        __threadfence();
      }
      // the pair's last band publishes no record, but its counter tells its
      // left neighbour which slots it may overwrite
      store_release(mine, t + 1);
    }
    prev = cur;
  }
  if (carry_out != nullptr) {
    for (int j = j0 + tid; j < j1; j += T) {
      carry_out[pair + j] = prev[pair + j];
      carry_out[plane + pair + j] = prev[plane + pair + j];
      carry_out[2 * plane + pair + j] = prev[2 * plane + pair + j];
    }
  }
}

int launch(void** args, int B, int threads, int bands, cudaStream_t stream) {
  const void* kernel = (const void*)triplet_rows_kernel;
  const cudaError_t e =
      bands == 1 ? cudaLaunchKernel(kernel, dim3(B), dim3(threads), args, 0, stream)
                 : cudaLaunchCooperativeKernel(kernel, dim3(B * bands), dim3(threads),
                                               args, 0, stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// grid and amax are both given (the rows are kept) or both null (then scratch
// [2, 3, B, m + 1] is given and only carry_out is written). bands of
// band_width columns a pair (a multiple of threads, covering m + 1); with
// several, records [B, bands - 1, slots, 72] f32 and progress [B, bands]
// zeros.
extern "C" int coati_triplet_rows(
    const void* anc_cods, const void* des, const void* ins_off,
    const void* steps, const void* lens_m, const void* logP64,
    const void* match_emit, const void* gc, const void* carry_in, void* grid,
    void* amax, void* carry_out, void* scratch, void* records, void* progress,
    int B, int m, int S, int threads, int bands, int band_width, int slots,
    void* stream) {
  if (B == 0) return 0;
  if (!block_ok(threads) || bands < 1 || band_width < 1 ||
      (long long)bands * band_width < m + 1 ||
      (bands > 1 && (band_width % threads != 0 || slots < 1 ||
                     records == nullptr || progress == nullptr)))
    return (int)cudaErrorInvalidValue;
  float* rec = static_cast<float*>(records);
  int* prog = bands > 1 ? static_cast<int*>(progress) : nullptr;
  void* args[] = {&anc_cods, &des,     &ins_off,   &steps, &lens_m, &logP64,
                  &match_emit, &gc,    &carry_in,  &grid,  &amax,   &carry_out,
                  &scratch,  &rec,     &prog,      &B,     &m,      &S,
                  &bands,    &band_width, &slots};
  return launch(args, B, threads, bands, static_cast<cudaStream_t>(stream));
}

// Blocks of `threads` threads an SM can hold at once (what a cooperative
// launch may have: this times the SMs).
extern "C" int coati_triplet_rows_blocks_per_sm(int threads) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, triplet_rows_kernel, threads, 0) != cudaSuccess)
    return -1;
  return n;
}
