// N stochastic tracebacks over one pair's Forward matrices, one thread a
// sample.
//
// Replaces coati_tpu/align/sample_device.py:39 _sample_paths (plain XLA: one
// lax.scan over walk steps, all samples a step): the corner draw, then up to
// (R - k) + (Cc - k) steps, each rebuilding in f32 the candidate edges into
// the current cell's state from the stored M, D, I of its predecessor
// (:103-123), drawing the predecessor's state by inverse CDF (draw, :74-82)
// from a uniform the caller supplies, and emitting the op code of the state
// it leaves. Only the op codes and a score a sample leave the chip.
//
// What bounds it on an H100: latency. A walk is a chain of ~na + nb
// dependent steps, each two scattered 12-byte reads (the cell and the one
// predecessor its state asks for; the reference gathers all four cells and
// selects) and three expf and a logf. A few hundred to a few thousand
// samples fill a fraction of the card's threads, so neither bytes nor
// operations come near their peaks. Samples of one pair start at the same
// corner and stay close for a while, so their reads share lines in L2.
//
// Numerics: every add is the reference's, in its order; expf and logf differ
// from XLA:CPU's and torch's in the last place, so a path can differ from the
// plain version's only where p * scale falls within that of em or em + ed.
// Compile with -fmad=false.
//
// Layout: mdi [R, Cc, 3] f32, cell (i, j)'s M, D, I at [i, j] (the Forward
// kernel's, one pair), the terminal-adjusted corner written at [R-1, Cc-1];
// enc_a [R-k] int32, enc_b [Cc-k] int32, table [rows, 15] f32, gap_consts
// [4] f32; uniforms [n_steps + 1, N] f32: row 0 the corner draw, row t + 1
// step t; ops [n_steps, N] int8, filled with -1 by the caller: walk order,
// 0 = match, 1 = delete, 2 = insert; scores [N] f32.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using coati::kLowest;

struct Mdi {
  float m, d, i;
};

__device__ __forceinline__ Mdi load_cell(const float* __restrict__ mdi, int Cc,
                                         int i, int j) {
  // a walk that has lost its way (a state of probability 0) stays in bounds
  const float* c = mdi + ((size_t)max(i, 0) * Cc + max(j, 0)) * 3;
  return {c[0], c[1], c[2]};
}

// Inverse-CDF draw among three log weights: the state picked and its log
// probability (sample_device.py:74-82).
__device__ __forceinline__ int draw(float logm, float logd, float logi, float p,
                                    float& ds) {
  const float em = expf(logm);
  const float ed = expf(logd);
  const float ei = expf(logi);
  const float emd = __fadd_rn(em, ed);
  const float scale = __fadd_rn(emd, ei);
  const float ps = __fmul_rn(p, scale);
  const int pick = ps < em ? 0 : (ps < emd ? 1 : 2);
  const float chosen = pick == 0 ? logm : (pick == 1 ? logd : logi);
  ds = __fsub_rn(chosen, logf(scale));
  return pick;
}

__global__ void sample_walk_kernel(
    const float* __restrict__ mdi, const int32_t* __restrict__ enc_a,
    const int32_t* __restrict__ enc_b, const float* __restrict__ table,
    const float* __restrict__ gap, const float* __restrict__ uniforms,
    int8_t* __restrict__ ops, float* __restrict__ scores, int R, int Cc, int k,
    int N, int n_steps) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const coati::Gap g = coati::load_gap(gap, k);
  const float ngng = __fadd_rn(g.ng, g.ng);
  const float gsng = __fadd_rn(g.gs, g.ng);
  const float gso = __fadd_rn(g.gs, g.go);

  int i = R - 1, j = Cc - 1;
  const Mdi corner = load_cell(mdi, Cc, i, j);
  const float w0 = fmaxf(fmaxf(corner.m, corner.d), corner.i);
  float score;
  int pick = draw(__fsub_rn(corner.m, w0), __fsub_rn(corner.d, w0),
                  __fsub_rn(corner.i, w0), uniforms[n], score);

  for (int t = 0; t < n_steps; ++t) {
    if (!(i > k - 1 || j > k - 1)) break;  // at the origin: ops stay -1
    const bool body = i >= k && j >= k;
    const Mdi c = load_cell(mdi, Cc, i, j);
    float w, logm, logd, logi;
    if (pick == 0) {  // into M from (i-1, j-1)
      const Mdi v = load_cell(mdi, Cc, i - 1, j - 1);
      const int code = enc_b[max(j - k, 0)];
      const float sub = code < 15 ? table[enc_a[max(i - k, 0)] * 15 + code] : 0.0f;
      w = c.m;
      logm = body ? __fadd_rn(__fadd_rn(v.m, ngng), sub) : kLowest;
      logd = body ? __fadd_rn(__fadd_rn(v.d, g.gs), sub) : kLowest;
      logi = body ? __fadd_rn(__fadd_rn(v.i, gsng), sub) : kLowest;
    } else if (pick == 1) {  // into D from (i-k, j); on the margin D copies
      const Mdi v = load_cell(mdi, Cc, i - k, j);
      w = c.d;
      logm = body ? __fadd_rn(__fadd_rn(v.m, g.ngo), g.gek1) : kLowest;
      logd = body ? __fadd_rn(v.d, g.gek) : c.d;
      logi = body ? __fadd_rn(__fadd_rn(v.i, gso), g.gek1) : kLowest;
    } else {  // into I from (i, j-k); D never precedes I
      const Mdi v = load_cell(mdi, Cc, i, j - k);
      w = c.i;
      logm = body ? __fadd_rn(__fadd_rn(v.m, g.go), g.gek1) : kLowest;
      logd = kLowest;
      logi = body ? __fadd_rn(v.i, g.gek) : c.i;
    }
    float ds;
    const int nxt =
        draw(__fsub_rn(logm, w), __fsub_rn(logd, w), __fsub_rn(logi, w),
             uniforms[(size_t)(t + 1) * N + n], ds);
    ops[(size_t)t * N + n] = (int8_t)pick;
    i -= pick == 0 ? 1 : (pick == 1 ? k : 0);
    j -= pick == 0 ? 1 : (pick == 2 ? k : 0);
    score = __fadd_rn(score, ds);
    pick = nxt;
  }
  scores[n] = score;
}

}  // namespace

extern "C" int coati_sample_walk(const void* mdi, const void* enc_a,
                                 const void* enc_b, const void* table,
                                 const void* gap_consts, const void* uniforms,
                                 void* ops, void* scores, int R, int Cc, int k,
                                 int N, int n_steps, void* stream) {
  if (N == 0) return 0;
  // 64 threads a block: a few thousand samples spread over many SMs
  const int threads = 64;
  sample_walk_kernel<<<(N + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mdi), static_cast<const int32_t*>(enc_a),
      static_cast<const int32_t*>(enc_b), static_cast<const float*>(table),
      static_cast<const float*>(gap_consts),
      static_cast<const float*>(uniforms), static_cast<int8_t*>(ops),
      static_cast<float*>(scores), R, Cc, k, N, n_steps);
  return (int)cudaGetLastError();
}
