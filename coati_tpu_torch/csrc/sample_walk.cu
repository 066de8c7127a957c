// N stochastic tracebacks over one pair's Forward matrices: a warp a sample,
// its steps taken in windows of the matrices copied into shared memory (or,
// where a window does not fit, one thread a sample reading device memory at
// every step: the body before windows).
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
// dependent steps. Read from device memory, each step is a round trip for
// the one predecessor its state asks for (~0.5 us; the reference gathers all
// four cells and selects). A step lowers i by 1 or k, or j by 1 or k, so the
// S steps after (i, j) read only rows i - kS .. i and columns j - kS .. j
// (and k more, with the reads one step ahead below).
// The window route (sample_window_kernel) has the sample's warp copy that
// window of M, D, I (12 bytes a cell, a row contiguous, so 16-byte cp.async
// side by side along a row), the S uniforms of those steps and the codes of
// the window's rows and columns into shared memory in one round trip; lane 0
// then takes the S steps at shared-memory latency, and the warp stores the S
// op codes together. One round trip and S steps a window.
//
// A step on one lane is bound by the instructions its warp issues, in order
// (on an H100 a walk takes ~300 ns a step with the emission read from device
// memory and the window rows at their source offsets, ~180 with neither,
// PERF.md), so the step is kept short: the reached cell's M, D, I stay in
// registers (the predecessor one step loads is the next step's cell); a
// step loads the three predecessors, the match emission and the uniform the
// next step may need while it draws, from rows laid at one pitch (a cell's
// address is one multiply-add) and a table in shared memory; the step's
// selections are select instructions, not branches; and the log of the
// draw's scale, which only the score needs, is taken by the lanes at the
// round's end, one step each, and added to the score in step order.
//
// Numerics: the arithmetic of a step (step_draw) is one function, which both
// routes call: every add is the reference's, in its order; expf and logf
// differ from XLA:CPU's and torch's in the last place, so a path can differ
// from the plain version's only where p * scale falls within that of em or
// em + ed. Compile with -fmad=false.
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

// The gap constants and the three sums the candidate edges use.
struct Consts {
  coati::Gap g;
  float ngng, gsng, gso;
};

__device__ __forceinline__ Consts load_consts(const float* gap, int k) {
  Consts q;
  q.g = coati::load_gap(gap, k);
  q.ngng = __fadd_rn(q.g.ng, q.g.ng);
  q.gsng = __fadd_rn(q.g.gs, q.g.ng);
  q.gso = __fadd_rn(q.g.gs, q.g.go);
  return q;
}

// Inverse-CDF draw among three log weights (sample_device.py:74-82): the
// state picked; its log probability is chosen - log(scale), which the window
// route takes off the walk's chain (log_prob).
__device__ __forceinline__ int draw(float logm, float logd, float logi, float p,
                                    float& chosen, float& scale) {
  const float em = expf(logm);
  const float ed = expf(logd);
  const float ei = expf(logi);
  const float emd = __fadd_rn(em, ed);
  scale = __fadd_rn(emd, ei);
  const float ps = __fmul_rn(p, scale);
  const int pick = ps < em ? 0 : (ps < emd ? 1 : 2);
  chosen = pick == 0 ? logm : (pick == 1 ? logd : logi);
  return pick;
}

__device__ __forceinline__ float log_prob(float chosen, float scale) {
  return __fsub_rn(chosen, logf(scale));
}

// p ? a : b as one select instruction: both a and b are formed first, so the
// compiler cannot turn the choice into a branch, which would cut a step into
// blocks that its scheduler cannot overlap.
__device__ __forceinline__ float select(bool p, float a, float b) {
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\tselp.f32 %0, %1, %2, q;\n\t}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((int)p));
  return r;
}

// One step from cell c in state `pick`: the state drawn for its predecessor,
// and what that state's log probability is made of. vm, vd, vi are the
// predecessors into M (i-1, j-1), D (i-k, j) and I (i, j-k); sub the match
// emission at c. body: i, j >= k; on the margin D and I copy. Every state's
// candidate edges are formed (they do not wait for `pick`) and then those of
// c's state taken, so a step's chain is the selection and the draw.
__device__ __forceinline__ int step_draw(const Consts& q, int pick, bool body,
                                         const Mdi& c, const Mdi& vm, const Mdi& vd,
                                         const Mdi& vi, float sub, float u,
                                         float& chosen, float& scale) {
  // into M from (i-1, j-1)
  const float mm = select(body, __fadd_rn(__fadd_rn(vm.m, q.ngng), sub), kLowest);
  const float dm = select(body, __fadd_rn(__fadd_rn(vm.d, q.g.gs), sub), kLowest);
  const float im = select(body, __fadd_rn(__fadd_rn(vm.i, q.gsng), sub), kLowest);
  // into D from (i-k, j); on the margin D copies
  const float md = select(body, __fadd_rn(__fadd_rn(vd.m, q.g.ngo), q.g.gek1), kLowest);
  const float dd = select(body, __fadd_rn(vd.d, q.g.gek), c.d);
  const float id = select(body, __fadd_rn(__fadd_rn(vd.i, q.gso), q.g.gek1), kLowest);
  // into I from (i, j-k); D never precedes I
  const float mi = select(body, __fadd_rn(__fadd_rn(vi.m, q.g.go), q.g.gek1), kLowest);
  const float ii = select(body, __fadd_rn(vi.i, q.g.gek), c.i);
  const float w = pick == 0 ? c.m : (pick == 1 ? c.d : c.i);
  const float logm = pick == 0 ? mm : (pick == 1 ? md : mi);
  const float logd = pick == 0 ? dm : (pick == 1 ? dd : kLowest);
  const float logi = pick == 0 ? im : (pick == 1 ? id : ii);
  return draw(__fsub_rn(logm, w), __fsub_rn(logd, w), __fsub_rn(logi, w), u,
              chosen, scale);
}

// The thread route: one thread a sample, the cell and its predecessor read
// from device memory every step. It takes the gap lengths whose window does
// not fit a row of 32 chunks (k over 20), and is the body before windows.
__device__ __forceinline__ Mdi load_cell(const float* __restrict__ mdi, int Cc,
                                         int i, int j) {
  // a walk that has lost its way (a state of probability 0) stays in bounds
  const float* c = mdi + ((size_t)max(i, 0) * Cc + max(j, 0)) * 3;
  return {c[0], c[1], c[2]};
}

__global__ void sample_thread_kernel(
    const float* __restrict__ mdi, const int32_t* __restrict__ enc_a,
    const int32_t* __restrict__ enc_b, const float* __restrict__ table,
    const float* __restrict__ gap, const float* __restrict__ uniforms,
    int8_t* __restrict__ ops, float* __restrict__ scores, int R, int Cc, int k,
    int N, int n_steps) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const Consts q = load_consts(gap, k);
  int i = R - 1, j = Cc - 1;
  Mdi c = load_cell(mdi, Cc, i, j);
  const float w0 = fmaxf(fmaxf(c.m, c.d), c.i);
  float chosen, scale;
  int pick = draw(__fsub_rn(c.m, w0), __fsub_rn(c.d, w0), __fsub_rn(c.i, w0),
                  uniforms[n], chosen, scale);
  float score = log_prob(chosen, scale);
  for (int t = 0; t < n_steps; ++t) {
    if (!(i > k - 1 || j > k - 1)) break;  // at the origin: ops stay -1
    const bool body = i >= k && j >= k;
    c = load_cell(mdi, Cc, i, j);
    const int pi = pick == 1 ? i - k : (pick == 0 ? i - 1 : i);
    const int pj = pick == 2 ? j - k : (pick == 0 ? j - 1 : j);
    const Mdi v = load_cell(mdi, Cc, pi, pj);
    float sub = 0.0f;
    if (pick == 0) {
      const int code = enc_b[max(j - k, 0)];
      sub = code < 15 ? table[enc_a[max(i - k, 0)] * 15 + code] : 0.0f;
    }
    const int nxt = step_draw(q, pick, body, c, v, v, v, sub,
                              uniforms[(size_t)(t + 1) * N + n], chosen, scale);
    ops[(size_t)t * N + n] = (int8_t)pick;
    i = pi;
    j = pj;
    score = __fadd_rn(score, log_prob(chosen, scale));
    pick = nxt;
  }
  scores[n] = score;
}

// Shared memory of the window route at window height H = k(S + 1): the
// table, then for each warp its window and after it S + 1 uniforms (a step
// loads the next one's; the last is never used), the S steps' chosen log
// weights and scales, the codes of the window's H + 1 rows (times 15) and
// H + 1 columns, and S staged op codes. A window row is H + 1 cells of 12
// bytes; the rows of the matrices start at any multiple of 4 bytes, so each
// is copied in 16-byte chunks from the 16-byte boundary at or below its first
// cell, to a place that puts that cell at window byte K + r * P (K = 16 + the
// offset of the window's first cell, P = window_pitch(H) + 12 Cc mod 16):
// every cell (r, c) then lies at K + r * P + 12 c. kernels/sample_walk.py
// repeats these sizes to pick shapes and checks them against
// coati_sample_walk_smem_bytes before it launches.
__host__ __device__ __forceinline__ int window_row_bytes(int H) {
  // the chunks a row may span, from an offset of up to 12
  return (12 * (H + 2) + 15) & ~15;
}

__host__ __device__ __forceinline__ int window_pitch(int H) {
  // a row's chunks end within 12 (H + 1) + 31 bytes of K + r * P, the next
  // row's begin at least 4 past K + (r + 1) P - 16
  return (12 * (H + 1) + 27 + 15) & ~15;
}

__host__ __device__ __forceinline__ int window_bytes(int H) {
  return (H + 1) * (window_pitch(H) + 12) + 32;
}

__host__ __device__ __forceinline__ int warp_bytes(int H, int S) {
  return (window_bytes(H) + 4 * (S + 1) + 8 * S + 8 * (H + 1) + S + 15) & ~15;
}

__host__ __device__ __forceinline__ int table_bytes(int table_len) {
  return (4 * table_len + 15) & ~15;
}

__global__ void sample_window_kernel(
    const float* __restrict__ mdi, const int32_t* __restrict__ enc_a,
    const int32_t* __restrict__ enc_b, const float* __restrict__ table,
    const float* __restrict__ gap, const float* __restrict__ uniforms,
    int8_t* __restrict__ ops, float* __restrict__ scores, int R, int Cc, int k,
    int N, int n_steps, int S, int table_len) {
  extern __shared__ __align__(16) uint8_t wsmem[];
  float* tab = reinterpret_cast<float*>(wsmem);
  for (int x = threadIdx.x; x < table_len; x += blockDim.x) tab[x] = table[x];
  __syncthreads();
  // S steps lower i and j by at most kS, and each loads what the step after
  // it may read, k further
  const int H = k * (S + 1);
  const int row_step = (Cc * 12) & 15;  // a row's address moves this much mod 16
  const int P = window_pitch(H) + row_step;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;
  // this warp's buffers, as offsets into wsmem so that reads are shared loads
  const int win = table_bytes(table_len) + warp * warp_bytes(H, S);
  float* uni = reinterpret_cast<float*>(wsmem + win + window_bytes(H));
  float* chosen = uni + S + 1;
  float* scale = chosen + S;
  int32_t* code_a = reinterpret_cast<int32_t*>(scale + S);
  int32_t* code_b = code_a + (H + 1);
  int8_t* staged = reinterpret_cast<int8_t*>(code_b + (H + 1));
  const unsigned base = (unsigned)__cvta_generic_to_shared(wsmem + win);
  const int la = R - k, lb = Cc - k;
  const int nch = window_row_bytes(H) >> 4;  // 16-byte chunks a row may span
  const int per = 32 / nch;                  // rows the warp copies at once
  const Consts q = load_consts(gap, k);

  int i = R - 1, j = Cc - 1;
  int t = 0;  // steps taken, ops written
  int pick = 0;
  float score = 0.0f;  // lane 0's
  Mdi c = {0.0f, 0.0f, 0.0f};
  bool done = false;
  for (bool first = true; !done; first = false) {
    // the window: rows r0 .. ia, columns c0 .. ja, anchored where the walk
    // stands (a walk that lost its way may stand left of or above the matrix)
    const int ia = max(i, 0), ja = max(j, 0);
    const int r0 = max(ia - H, 0), c0 = max(ja - H, 0);
    const int rows = ia - r0 + 1, cols = ja - c0 + 1;
    const int span = 12 * cols;
    const char* top = reinterpret_cast<const char*>(mdi + ((size_t)r0 * Cc + c0) * 3);
    const int a0 = (int)(reinterpret_cast<uintptr_t>(top) & 15);
    const int K = 16 + a0;  // window byte of cell (r0, c0)
    const int ch = lane % nch;
    for (int r = lane / nch; lane < per * nch && r < rows; r += per) {
      const int off = (a0 + r * row_step) & 15;  // row r starts at this byte
      if (16 * ch < off + span) {  // chunk ch holds bytes of the row
        const char* src = top + (size_t)r * Cc * 12 - off + 16 * ch;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         base + (unsigned)(K + r * P - off + 16 * ch)),
                     "l"(src)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    const int lim = min(S, n_steps - t);
    if (lane < lim) uni[lane] = uniforms[(size_t)(t + 1 + lane) * N + n];
    for (int x = lane; x < rows; x += 32)
      code_a[x] = 15 * (la > 0 ? enc_a[max(r0 + x - k, 0)] : 0);
    for (int x = lane; x < cols; x += 32)
      code_b[x] = lb > 0 ? enc_b[max(c0 + x - k, 0)] : 0;
    const float u0 = first ? uniforms[n] : 0.0f;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncwarp();

    int m = 0;
    if (lane == 0) {
      // cell (ii, jj), clamped into the matrix as load_cell clamps it
      const int cells = win + K - r0 * P - 12 * c0;
      auto cell = [&](int ii, int jj) -> Mdi {
        const float* p =
            reinterpret_cast<const float*>(wsmem + cells + max(ii, 0) * P + 12 * max(jj, 0));
        return {p[0], p[1], p[2]};
      };
      // what a step at (ii, jj) may read: its three predecessors and its
      // match emission, loaded a step ahead, while the step before draws
      Mdi v0, v1, v2;
      float sub = 0.0f;
      auto ahead = [&](int ii, int jj) {
        v0 = cell(ii - 1, jj - 1);
        v1 = cell(ii - k, jj);
        v2 = cell(ii, jj - k);
        const int ca = code_a[max(ii, 0) - r0];
        const int cb = code_b[max(jj, 0) - c0];
        // code 15 ('-') has no column: read in bounds, then not taken
        sub = select(cb < 15, tab[ca + min(cb, 14)], 0.0f);
      };
      if (first) {
        c = cell(i, j);
        const float w0 = fmaxf(fmaxf(c.m, c.d), c.i);
        float ch, sc;
        pick = draw(__fsub_rn(c.m, w0), __fsub_rn(c.d, w0), __fsub_rn(c.i, w0), u0,
                    ch, sc);
        score = log_prob(ch, sc);
      }
      ahead(i, j);
      float u = uni[0];
#pragma unroll 2
      for (; m < lim; ++m) {
        if (!(i > k - 1 || j > k - 1)) break;  // at the origin: ops stay -1
        const bool body = i >= k && j >= k;
        const Mdi vm = v0, vd = v1, vi = v2;
        const float e = sub, um = u;
        const int pi = pick == 1 ? i - k : (pick == 0 ? i - 1 : i);
        const int pj = pick == 2 ? j - k : (pick == 0 ? j - 1 : j);
        ahead(pi, pj);  // the next step's reads: the window reaches k more
        u = uni[m + 1];  // uni holds S + 1: the last is never used
        staged[m] = (int8_t)pick;
        const Mdi v = pick == 0 ? vm : (pick == 1 ? vd : vi);
        pick = step_draw(q, pick, body, c, vm, vd, vi, e, um, chosen[m], scale[m]);
        i = pi;
        j = pj;
        c = v;
      }
      done = !(t + m < n_steps && (i > k - 1 || j > k - 1));
    }
    __syncwarp();
    m = __shfl_sync(0xffffffffu, m, 0);
    i = __shfl_sync(0xffffffffu, i, 0);
    j = __shfl_sync(0xffffffffu, j, 0);
    done = __shfl_sync(0xffffffffu, (int)done, 0) != 0;
    // the steps' log probabilities, a lane each, added to lane 0's score in
    // step order
    const float ds = lane < m ? log_prob(chosen[lane], scale[lane]) : 0.0f;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const float d = __shfl_sync(0xffffffffu, ds, x);
      if (x < m) score = __fadd_rn(score, d);
    }
    for (int x = lane; x < m; x += 32) ops[(size_t)(t + x) * N + n] = staged[x];
    t += m;
    __syncwarp();  // staged, uniforms and codes are read before the next fetch
  }
  if (lane == 0) scores[n] = score;
}

}  // namespace

// Dynamic shared memory a block of the window route takes at gap length k,
// windows of S steps, `warps` samples a block and a table of table_len
// floats; -1 where the route does not take that shape: a lane stages one
// uniform of a window's S steps, and a window row spans at most 32 chunks of
// 16 bytes, one a lane.
extern "C" int coati_sample_walk_smem_bytes(int k, int S, int warps, int table_len) {
  if (k < 1 || S < 1 || S > 32 || warps < 1 || warps > 32 || table_len < 15 ||
      window_row_bytes(k * (S + 1)) > 32 * 16)
    return -1;
  return table_bytes(table_len) + warps * warp_bytes(k * (S + 1), S);
}

// S = 0: one thread a sample (blocks of 64 threads); S >= 1: a warp a sample,
// `warps` samples a block, windows of S steps, the table (table_len floats)
// in shared memory.
extern "C" int coati_sample_walk(const void* mdi, const void* enc_a,
                                 const void* enc_b, const void* table,
                                 const void* gap_consts, const void* uniforms,
                                 void* ops, void* scores, int R, int Cc, int k,
                                 int N, int n_steps, int S, int warps,
                                 int table_len, void* stream) {
  if (N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mdi);
  const int32_t* a = static_cast<const int32_t*>(enc_a);
  const int32_t* b = static_cast<const int32_t*>(enc_b);
  const float* tab = static_cast<const float*>(table);
  const float* g = static_cast<const float*>(gap_consts);
  const float* u = static_cast<const float*>(uniforms);
  int8_t* o = static_cast<int8_t*>(ops);
  float* sc = static_cast<float*>(scores);
  if (S == 0) {
    const int threads = 64;
    sample_thread_kernel<<<(N + threads - 1) / threads, threads, 0, st>>>(
        m, a, b, tab, g, u, o, sc, R, Cc, k, N, n_steps);
    return (int)cudaGetLastError();
  }
  const int smem = coati_sample_walk_smem_bytes(k, S, warps, table_len);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sample_window_kernel<<<(N + warps - 1) / warps, 32 * warps, smem, st>>>(
      m, a, b, tab, g, u, o, sc, R, Cc, k, N, n_steps, S, table_len);
  return (int)cudaGetLastError();
}
