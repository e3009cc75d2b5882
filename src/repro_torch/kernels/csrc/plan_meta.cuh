// Decoding of a DevicePlan's per-element metadata (kernels/sell_spmv.py:
// build_device_plan), shared by the SELL kernels and the row gather.
//
//   packed   (n_windows, window) int32      (warp << 16) | offset
//   unpacked (n_windows, 2, window) int32   lane 0 warp, lane 1 offset
#pragma once

#include <stdint.h>

namespace plan {

// (warp, offset) of element e of window w. The packed word is decoded as an
// unsigned value: warp ids >= 2^15 set the int32 sign bit, and the shift
// must be logical.
template <bool PACKED>
__device__ __forceinline__ void decode(const int32_t* __restrict__ meta,
                                       long long w, int window, int e,
                                       int& warp, int& offset) {
  if (PACKED) {
    const uint32_t m = static_cast<uint32_t>(meta[w * window + e]);
    warp = static_cast<int>(m >> 16);
    offset = static_cast<int>(m & 0xFFFFu);
  } else {
    const int32_t* base = meta + w * 2 * window;
    warp = base[e];
    offset = base[window + e];
  }
}

}  // namespace plan
