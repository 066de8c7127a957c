// Marginal Gotoh M/D/I Viterbi fill with packed backpointers, one thread
// block per pair.
//
// Replaces the TPU kernels coati_tpu/kernels/wavefront_pallas.py:330
// wavefront_pallas (mode="viterbi", want_bp=True) and :704
// wavefront_pallas_stacked. Both meet one contract pair by pair, and so does
// this kernel: the f32 M/D/I cells of coati_tpu/align/wavefront.py
// wavefront_impl, the backpointer byte of every cell of the pair's
// (la+k) x (lb+k) matrix, and the terminal-adjusted corner scores. The
// one-hot emission and the diagonal stacking of the TPU kernels exist for
// the TPU's slow gathers and lane width and are not carried over.
//
// What bounds it on an H100: the serial chain of la+lb+2k-1 anti-diagonals
// per pair (each depends on the two before it, so one __syncthreads each)
// and the 1 byte per cell backpointer store to device memory, the only
// traffic that scales with the matrix. The design keeps everything else on
// chip: threads stride over the slots of a diagonal, the ring of the last
// max(k,2)+1 diagonals x 3 states lives in shared memory when it fits (else
// in a per-pair global scratch, which is L2-resident at these sizes), and
// the emission is a direct gather from the table, held in shared memory when
// it fits. The backpointer stores of a diagonal are contiguous bytes. Many
// pairs per launch keep the SMs busy while each block waits at its barrier.
//
// Numerics: bit-equal to the XLA:CPU reference. The cell update is
// common.cuh's cell_update, shared with the segment and score kernels.
//
// Layout: aseq [B, NA] int32 (< rows), bseq [B, NB] int32 (< 16), lens [B] int32, table
// [table_len / 15, 15] f32, gap_consts [4] f32 = (ng, gs, go, ge).
// bp [B, Dtot, C] uint8 with C = NB + k, Dtot = NA + NB + 2k - 1: cell (i, j)
// at [p, i + j, j]; only the pair's true matrix is written. corners [3, B].

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

template <bool kRingShared, bool kTableShared>
__global__ void wavefront_fill_kernel(
    const int32_t* __restrict__ aseq, const int32_t* __restrict__ bseq,
    const int32_t* __restrict__ lens_a, const int32_t* __restrict__ lens_b,
    const float* __restrict__ table, const float* __restrict__ gap_consts,
    float* ring_scratch, uint8_t* __restrict__ bp,
    float* __restrict__ corners, int B, int NA, int NB, int k,
    int table_len) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const int C = NB + k;
  const int Dtot = NA + NB + 2 * k - 1;
  const int nring = (k > 2 ? k : 2) + 1;
  const int plane = 3 * C;  // M, D, I planes of one diagonal
  float* ring = kRingShared ? smem : ring_scratch + (size_t)p * nring * plane;
  const float* tab = table;
  if (kTableShared) {
    float* t = kRingShared ? smem + nring * plane : smem;
    for (int q = threadIdx.x; q < table_len; q += blockDim.x) t[q] = table[q];
    tab = t;
    __syncthreads();
  }

  const coati::Gap g = coati::load_gap(gap_consts, k);
  const int rows = lens_a[p] + k;  // true matrix: 0 <= i < rows
  const int cols = lens_b[p] + k;  //              0 <= j < cols
  const int32_t* a = aseq + (size_t)p * NA;
  const int32_t* b = bseq + (size_t)p * NB;
  uint8_t* bpp = bp + (size_t)p * Dtot * C;
  const int d_last = rows + cols - 2;  // the corner's diagonal

  for (int d = 0; d <= d_last; ++d) {
    float* cur = ring + (d % nring) * plane;
    const float* r2 = ring + ((d + nring - 2) % nring) * plane;  // d - 2
    const float* rk = ring + ((d + nring - k) % nring) * plane;  // d - k
    const int j_lo = max(0, d - (rows - 1));
    const int j_hi = min(d, cols - 1);
    for (int j = j_lo + threadIdx.x; j <= j_hi; j += blockDim.x) {
      const int i = d - j;
      float M, D, I;
      const uint8_t code =
          coati::cell_update(i, j, k, C, 0, r2, rk, a, b, tab, g, M, D, I);
      cur[j] = M;
      cur[C + j] = D;
      cur[2 * C + j] = I;
      bpp[(size_t)d * C + j] = code;

      if (d == d_last) {  // the corner is the last diagonal's only cell
        corners[p] = __fadd_rn(__fadd_rn(M, g.ng), g.ng);
        corners[B + p] = __fadd_rn(D, g.gs);
        corners[2 * B + p] = __fadd_rn(__fadd_rn(I, g.gs), g.ng);
      }
    }
    __syncthreads();
  }
}

template <bool kRingShared, bool kTableShared>
int launch(size_t smem, int threads, cudaStream_t stream,
           const int32_t* aseq, const int32_t* bseq, const int32_t* lens_a,
           const int32_t* lens_b, const float* table, const float* gap,
           float* ring, uint8_t* bp, float* corners, int B, int NA, int NB,
           int k, int table_len) {
  auto kernel = wavefront_fill_kernel<kRingShared, kTableShared>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, threads, smem, stream>>>(aseq, bseq, lens_a, lens_b, table, gap,
                                       ring, bp, corners, B, NA, NB, k,
                                       table_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int coati_wavefront_fill(
    const void* aseq, const void* bseq, const void* lens_a, const void* lens_b,
    const void* table, const void* gap_consts, void* ring_scratch, void* bp,
    void* corners, int B, int NA, int NB, int k, int table_len,
    int ring_shared, int table_shared, int threads, void* stream) {
  if (B == 0) return 0;
  const int nring = (k > 2 ? k : 2) + 1;
  size_t smem = 0;
  if (ring_shared) smem += (size_t)nring * 3 * (NB + k) * sizeof(float);
  if (table_shared) smem += (size_t)table_len * sizeof(float);
  auto* a = static_cast<const int32_t*>(aseq);
  auto* b = static_cast<const int32_t*>(bseq);
  auto* la = static_cast<const int32_t*>(lens_a);
  auto* lb = static_cast<const int32_t*>(lens_b);
  auto* t = static_cast<const float*>(table);
  auto* g = static_cast<const float*>(gap_consts);
  auto* r = static_cast<float*>(ring_scratch);
  auto* o = static_cast<uint8_t*>(bp);
  auto* c = static_cast<float*>(corners);
  auto s = static_cast<cudaStream_t>(stream);
  if (ring_shared && table_shared)
    return launch<true, true>(smem, threads, s, a, b, la, lb, t, g, r, o, c,
                              B, NA, NB, k, table_len);
  if (ring_shared)
    return launch<true, false>(smem, threads, s, a, b, la, lb, t, g, r, o, c,
                               B, NA, NB, k, table_len);
  if (table_shared)
    return launch<false, true>(smem, threads, s, a, b, la, lb, t, g, r, o, c,
                               B, NA, NB, k, table_len);
  return launch<false, false>(smem, threads, s, a, b, la, lb, t, g, r, o, c,
                              B, NA, NB, k, table_len);
}
