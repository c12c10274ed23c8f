// The saturating float -> integer store that the FIR and both graph
// kernels share, as the reference's astype and the plain versions'
// `cast_output` store: NaN to 0, saturated at the type's range, else
// truncated toward zero. The clamp is explicit: a C++ cast of a float
// outside the integer's range is undefined. float(hi) is hi itself below
// 2^24 and 2^31 for int32; every float under it truncates into the range.
#pragma once

#include <type_traits>

template <class I>
__device__ __forceinline__ I saturate(float v) {
  static_assert(std::is_integral<I>::value && sizeof(I) <= 4,
                "saturate stores an integer of at most 32 bits");
  constexpr bool kSigned = std::is_signed<I>::value;
  constexpr long long hi = kSigned ? (1LL << (8 * sizeof(I) - 1)) - 1
                                   : (1LL << (8 * sizeof(I))) - 1;
  constexpr long long lo = kSigned ? -hi - 1 : 0;
  if (v != v) return I(0);
  if (v >= static_cast<float>(hi)) return static_cast<I>(hi);
  if (v <= static_cast<float>(lo)) return static_cast<I>(lo);
  return static_cast<I>(v);
}
