// Helpers shared by the packed XNOR kernels (xnor_matmul.cu, xnor_conv.cu).
//
// Bit layout (src/repro_torch/core/bitpack.py): bit i of a packed int32
// word holds element i of its 32-element group, LSB first, 1 = +1, 0 = -1.
#pragma once

#include <cstdint>

namespace repro {

// Unpack the low 16 bits of `bits` into 16 int8 values (+1 / -1) at `dst`
// (16-byte aligned), or write 16 zeros when `valid` is false: a zero
// operand adds nothing to a dot product, which is how the WMMA kernels mask
// reduction words past the end of K.
__device__ __forceinline__ void unpack_pm1_16(uint32_t bits, bool valid,
                                              int8_t* dst) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t v = 0u;
    if (valid) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t bit = (bits >> (4 * j + b)) & 1u;
        v |= (bit ? 0x01u : 0xFFu) << (8 * b);
      }
    }
    d[j] = v;
  }
}

// Eq. 8 epilogue shared by all four kernels: agree-count y -> int32 count,
// or -> int8 bit (y >= c) XOR flip when thresholds are given (c != null).
__device__ __forceinline__ void store_output(void* out, size_t idx, int y,
                                             const float* c,
                                             const uint8_t* flip, int ch) {
  if (c != nullptr) {
    const bool ge = static_cast<float>(y) >= c[ch];
    static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(ge != (flip[ch] != 0));
  } else {
    static_cast<int32_t*>(out)[idx] = y;
  }
}

}  // namespace repro
