// Entry points of the strip body (strip_fill.cuh) for the long path
// (align/longseq.py), in place of the TPU's segments of diagonals,
// coati_tpu/kernels/wavefront_pallas.py:909 wavefront_pallas_segment, for
// k <= 8:
//
// - coati_wavefront_fill_ckpt, pass 1: the score-only sweep of the whole
//   matrix, which also stores the k rows of M, D and I above every band
//   boundary but the top one (ckpt [n_ckpt, B, k, 3, Cp] f32, band b at
//   b - 1) and the corners;
// - coati_wavefront_fill_band, pass 2: the sweep with backpointers over one
//   band of rows [row0, row0 + band_rows), started from that band's
//   checkpoint rows (ckpt [B, k, 3, Cp]; none for row0 = 0), bp [B,
//   band_rows, Cp] in row layout.
//
// What bounds them on an H100 is the strip body's: a chain of rows, a step
// a row, and the skew of every stripe (a warp) behind its left neighbour.
// Pass 1 pays the skew once for the whole matrix; pass 2 once a band, so a
// band's launch wants few stripes (wide strips) and every stripe its own
// warp (kernels/wavefront_fill.py band_shape). Built apart from the main
// path's entry points so that both build at once.

#include "strip_fill.cuh"

extern "C" int coati_wavefront_fill_ckpt(
    const void* aseq, const void* bseq, const void* lens_a, const void* lens_b,
    const void* table, const void* gap_consts, void* corners, void* ckpt,
    void* edge, void* gprog, int B, int NA, int NB, int k, int Cp,
    int band_rows, int n_ckpt, int table_len, int table_shared, int W,
    int warps_per_pair, int pairs_per_block, int blocks_per_pair, void* stream) {
  const FillArgs x = {
      static_cast<const int32_t*>(aseq),   static_cast<const int32_t*>(bseq),
      static_cast<const int32_t*>(lens_a), static_cast<const int32_t*>(lens_b),
      static_cast<const float*>(table),    static_cast<const float*>(gap_consts),
      nullptr,                             static_cast<float*>(corners),
      static_cast<float*>(edge),           static_cast<int*>(gprog),
      B, NA, NB, Cp, table_len, table_shared,
      warps_per_pair, pairs_per_block, blocks_per_pair,
      static_cast<float*>(ckpt), band_rows, n_ckpt, 0};
  return fill_entry<false, 1>(x, k, W, stream);
}

extern "C" int coati_wavefront_fill_band(
    const void* aseq, const void* bseq, const void* lens_a, const void* lens_b,
    const void* table, const void* gap_consts, const void* ckpt, void* bp,
    void* edge, void* gprog, int B, int NA, int NB, int k, int Cp, int row0,
    int band_rows, int table_len, int table_shared, int W,
    int warps_per_pair, int pairs_per_block, int blocks_per_pair, void* stream) {
  const FillArgs x = {
      static_cast<const int32_t*>(aseq),   static_cast<const int32_t*>(bseq),
      static_cast<const int32_t*>(lens_a), static_cast<const int32_t*>(lens_b),
      static_cast<const float*>(table),    static_cast<const float*>(gap_consts),
      static_cast<uint8_t*>(bp),           nullptr,
      static_cast<float*>(edge),           static_cast<int*>(gprog),
      B, NA, NB, Cp, table_len, table_shared,
      warps_per_pair, pairs_per_block, blocks_per_pair,
      const_cast<float*>(static_cast<const float*>(ckpt)), band_rows, 0, row0};
  if (B > 0 && bp == nullptr) return (int)cudaErrorInvalidValue;
  return fill_entry<true, 1>(x, k, W, stream);
}
