// Entry points of the strip body (strip_fill.cuh, which says how it works)
// over each pair's whole matrix: the Viterbi fill with backpointers in row
// layout (coati_wavefront_fill), counterpart of
// coati_tpu/kernels/wavefront_pallas.py:330 wavefront_pallas (viterbi,
// want_bp=True) and :704 wavefront_pallas_stacked, and the score-only body
// (coati_wavefront_fill_score), counterpart of wavefront_pallas with
// want_bp=False for k <= 8. The long path's passes are
// wavefront_fill_long.cu's.

#include "strip_fill.cuh"

extern "C" int coati_wavefront_fill(
    const void* aseq, const void* bseq, const void* lens_a, const void* lens_b,
    const void* table, const void* gap_consts, void* bp, void* corners,
    void* edge, void* gprog, int B, int NA, int NB, int k, int Cp,
    int table_len, int table_shared, int W, int warps_per_pair,
    int pairs_per_block, int blocks_per_pair, void* stream) {
  const FillArgs x = {
      static_cast<const int32_t*>(aseq),   static_cast<const int32_t*>(bseq),
      static_cast<const int32_t*>(lens_a), static_cast<const int32_t*>(lens_b),
      static_cast<const float*>(table),    static_cast<const float*>(gap_consts),
      static_cast<uint8_t*>(bp),           static_cast<float*>(corners),
      static_cast<float*>(edge),           static_cast<int*>(gprog),
      B, NA, NB, Cp, table_len, table_shared,
      warps_per_pair, pairs_per_block, blocks_per_pair};
  if (B > 0 && bp == nullptr) return (int)cudaErrorInvalidValue;
  return fill_entry<true, 0>(x, k, W, stream);
}

// Score-only: the terminal-adjusted corners [3, B], no backpointers.
extern "C" int coati_wavefront_fill_score(
    const void* aseq, const void* bseq, const void* lens_a, const void* lens_b,
    const void* table, const void* gap_consts, void* corners, void* edge,
    void* gprog, int B, int NA, int NB, int k, int table_len,
    int table_shared, int W, int warps_per_pair, int pairs_per_block,
    int blocks_per_pair, void* stream) {
  const FillArgs x = {
      static_cast<const int32_t*>(aseq),   static_cast<const int32_t*>(bseq),
      static_cast<const int32_t*>(lens_a), static_cast<const int32_t*>(lens_b),
      static_cast<const float*>(table),    static_cast<const float*>(gap_consts),
      nullptr,                             static_cast<float*>(corners),
      static_cast<float*>(edge),           static_cast<int*>(gprog),
      B, NA, NB, 0, table_len, table_shared,
      warps_per_pair, pairs_per_block, blocks_per_pair};
  return fill_entry<false, 0>(x, k, W, stream);
}
