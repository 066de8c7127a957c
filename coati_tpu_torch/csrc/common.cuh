// Shared helpers of the marginal Viterbi kernels.
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

}  // namespace coati
