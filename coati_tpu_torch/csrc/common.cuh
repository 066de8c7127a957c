// Shared helpers of the marginal pair-HMM kernels: the semiring zero, the
// state preference, the log semiring's sum, and the one cell update that the
// fill, segment, score and Forward kernels all run (cell_compute; the sweep
// reads its predecessors from a ring of diagonals with cell_update, the fill
// keeps them in registers).
#pragma once

#include <cfloat>
#include <cstdint>

namespace coati {

// numeric_limits<float>::lowest(): the semiring zero. Adding the small
// negative constants of the recurrence to it rounds back to it, so it never
// reaches -inf.
constexpr float kLowest = -FLT_MAX;

// Reference max_mdi preference (coati_tpu/align/wavefront.py:64): M unless D
// is strictly greater, I only if strictly greater than both. Codes 0/1/2.
__device__ __forceinline__ unsigned argmax_mdi(float m, float d, float i) {
  const unsigned code = (d > m) ? 1u : 0u;
  return (i > fmaxf(m, d)) ? 2u : code;
}

// The log semiring's sum: f32 logSumExp in the reference's piecewise form
// (coati_tpu/align/wavefront.py:56-66, _lse), the -16 threshold kept. expf
// and log1pf differ from XLA:CPU's and torch's in the last place, so what
// is built from it is held to a tolerance, not to bit-equality.
__device__ __forceinline__ float lse(float a, float b) {
  const float mx = fmaxf(a, b);
  const float y = -fabsf(__fsub_rn(a, b));
  const float t = (y <= -16.0f) ? expf(y) : log1pf(expf(fminf(y, 0.0f)));
  return __fadd_rn(mx, t);
}

// The semiring's sum: max (tropical, Viterbi) or lse (log, Forward).
template <bool kLog>
__device__ __forceinline__ float plus2(float a, float b) {
  return kLog ? lse(a, b) : fmaxf(a, b);
}

// Gap constants (ng, gs, go, ge) and the products the recurrence uses.
struct Gap {
  float ng, gs, go, ge, gek1, gek, ngo;
};

__device__ __forceinline__ Gap load_gap(const float* __restrict__ g, int k) {
  Gap c;
  c.ng = g[0];
  c.gs = g[1];
  c.go = g[2];
  c.ge = g[3];
  c.gek1 = __fmul_rn(c.ge, (float)(k - 1));
  c.gek = __fmul_rn(c.ge, (float)k);
  c.ngo = __fadd_rn(c.ng, c.go);
  return c;
}

// Slot of diagonal d in a ring of nring diagonals (d may be negative).
__device__ __forceinline__ int ring_slot(int d, int nring) {
  const int r = d % nring;
  return r < 0 ? r + nring : r;
}

template <bool kCg>
__device__ __forceinline__ float ring_load(const float* p) {
  return kCg ? __ldcg(p) : *p;
}

// Cell (i, j) of one pair's matrix from its predecessors' values as read:
// (i-1, j-1) p2M/p2D/p2I, (i-k, j) pkM/pkD/pkI, (i, j-k) pkMs/pkIs, and the
// emission sub = table[a[i-k], b[j-k]] (0 for the gap code; read only when
// i, j >= k). Predecessors left of or above the matrix take LOWEST here,
// whatever was read, as the reference's shifted-in slots do. Writes M, D, I
// and returns the packed backpointer byte. Every add is the reference's, in
// its order (coati_tpu/align/wavefront.py:182-195); the semiring's sums
// (max, or with kLog lse) nest as plus2(plus2(a, b), c); the backpointers use
// the comparands of :218-220; the two margin formulas are one explicitly
// rounded FMA each, as XLA:CPU computes them (:154, :160). Compile with
// -fmad=false. The backpointer byte is of use only in the tropical semiring.
// kBody: the caller knows i, j >= k (every predecessor inside the matrix),
// so the masks and the margins are left out; the values are the same.
template <bool kLog = false, bool kBody = false>
__device__ __forceinline__ uint8_t cell_compute(
    int i, int j, int k, float p2M, float p2D, float p2I, float pkM,
    float pkD, float pkI, float pkMs, float pkIs, float sub, const Gap& g,
    float& M, float& D, float& I) {
  const bool diag = kBody || (i >= 1 && j >= 1);  // (i-1, j-1)
  const bool up = kBody || i >= k;                 // (i-k, j)
  const bool left = kBody || j >= k;               // (i, j-k)
  p2M = diag ? p2M : kLowest;
  p2D = diag ? p2D : kLowest;
  p2I = diag ? p2I : kLowest;
  pkM = up ? pkM : kLowest;
  pkD = up ? pkD : kLowest;
  pkI = up ? pkI : kLowest;
  pkMs = left ? pkMs : kLowest;
  pkIs = left ? pkIs : kLowest;

  // partial sums shared by the recurrence and the backpointer comparands
  const float m2m0 = __fadd_rn(__fadd_rn(p2M, g.ng), g.ng);
  const float d2m0 = __fadd_rn(p2D, g.gs);
  const float i2m0 = __fadd_rn(__fadd_rn(p2I, g.gs), g.ng);
  const float m2d0 = __fadd_rn(__fadd_rn(pkM, g.ng), g.go);
  const float i2d0 = __fadd_rn(__fadd_rn(pkI, g.gs), g.go);
  const float m2i0 = __fadd_rn(pkMs, g.go);

  if (up && left) {
    M = plus2<kLog>(plus2<kLog>(__fadd_rn(m2m0, sub), __fadd_rn(d2m0, sub)),
                    __fadd_rn(i2m0, sub));
    D = plus2<kLog>(plus2<kLog>(__fadd_rn(m2d0, g.gek1), __fadd_rn(pkD, g.gek)),
                    __fadd_rn(i2d0, g.gek1));
    I = plus2<kLog>(__fadd_rn(m2i0, g.gek1), __fadd_rn(pkIs, g.gek));
  } else {  // margins (wavefront.py:141-161)
    M = (i == k - 1 && j == k - 1) ? 0.0f : kLowest;
    D = (j == k - 1 && i >= 2 * k - 1 && (i - (k - 1)) % k == 0)
            ? __fmaf_rn(g.ge, (float)i - 1.0f, g.ngo)
            : kLowest;
    I = (i == k - 1 && j >= 2 * k - 1 && (j - (k - 1)) % k == 0)
            ? __fmaf_rn(g.ge, (float)j - 1.0f, g.go)
            : kLowest;
  }
  const unsigned bm = argmax_mdi(m2m0, d2m0, i2m0);
  const unsigned bd = argmax_mdi(m2d0, __fadd_rn(pkD, g.ge), i2d0);
  const unsigned bi = (m2i0 > __fadd_rn(pkIs, g.ge)) ? 0u : 2u;
  return (uint8_t)(bm | (bd << 2) | (bi << 4));
}

// Cell (i, j) of one pair's matrix, on diagonal d = i + j, from the ring
// planes of diagonals d-2 (r2) and d-k (rk), each M, D, I planes of S slots
// with column j at slot j - off (a whole diagonal: S = C, off = 0; one band
// of columns [j0, j1) and its k halo columns: S = k + j1 - j0, off = j0 - k).
// i and j are the pair's global indices whatever the planes hold. a and b
// are the pair's sequences, tab the [rows, 15] table. Reads only the
// predecessors inside the matrix and then is cell_compute.
// kCg: read the ring past L1 (ld.global.cg), for a ring that blocks on other
// SMs write.
template <bool kCg = false, bool kLog = false>
__device__ __forceinline__ uint8_t cell_update(
    int i, int j, int k, int S, int off, const float* r2, const float* rk,
    const int32_t* __restrict__ a, const int32_t* __restrict__ b,
    const float* tab, const Gap& g, float& M, float& D, float& I) {
  const bool diag = i >= 1 && j >= 1;  // (i-1, j-1)
  const bool up = i >= k;              // (i-k, j)
  const bool left = j >= k;            // (i, j-k)
  const int c = j - off;               // j's slot in the planes
  const float p2M = diag ? ring_load<kCg>(r2 + c - 1) : kLowest;
  const float p2D = diag ? ring_load<kCg>(r2 + S + c - 1) : kLowest;
  const float p2I = diag ? ring_load<kCg>(r2 + 2 * S + c - 1) : kLowest;
  const float pkM = up ? ring_load<kCg>(rk + c) : kLowest;
  const float pkD = up ? ring_load<kCg>(rk + S + c) : kLowest;
  const float pkI = up ? ring_load<kCg>(rk + 2 * S + c) : kLowest;
  const float pkMs = left ? ring_load<kCg>(rk + c - k) : kLowest;
  const float pkIs = left ? ring_load<kCg>(rk + 2 * S + c - k) : kLowest;
  float sub = 0.0f;
  if (up && left) {
    // code 15 ('-') has no column: the reference's one-hot sum gives 0
    const int code = b[j - k];
    sub = code < 15 ? tab[a[i - k] * 15 + code] : 0.0f;
  }
  return cell_compute<kLog>(i, j, k, p2M, p2D, p2I, pkM, pkD, pkI, pkMs,
                            pkIs, sub, g, M, D, I);
}

}  // namespace coati
