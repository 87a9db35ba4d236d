// MMA issue-rate probe for Hopper (sm_90a). Not a kernel of any path: it
// measures which tensor-core form the packed XNOR kernels should use
// (csrc/xnor_matmul.cu K2, csrc/xnor_conv.cu K4) and is run by
// chip_smoke.py through kernels/mma_probe.py::rates.
//
// Each warp runs `iters` rounds of CHAINS independent mma.sync
// accumulator chains on register operands, so the loop is bound by the
// MMA issue rate and nothing else. Forms:
//   0  m16n8k256 .b1 .xor.popc    (32768 bit-MACs per MMA)
//   1  m16n8k256 .b1 .and.popc    (32768)
//   2  m16n8k32 .s8, +-1 bytes    (4096)
//   3  form 2 with both operands unpacked from packed words in registers
//      each round, as K5 mxu does (a shift, an AND and a multiply-add per
//      register: 6 registers per MMA)
#include <cstdint>
#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

constexpr int PROBE_THREADS = 256;
constexpr int CHAINS = 4;

__device__ __forceinline__ void mma_b1_xor(int (&acc)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&acc)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bits 0, 8, 16 and 24 of x as four int8 +1 / -1 (K5 mxu's unpack).
__device__ __forceinline__ uint32_t pm1_bytes(uint32_t x) {
  return (x & 0x01010101u) * 0xFFFFFF02u + 0xFFFFFFFFu;
}

template <int FORM>
__global__ void __launch_bounds__(PROBE_THREADS)
mma_probe_kernel(int iters, int* sink) {
  const int t = threadIdx.x % 4;
  const uint32_t x = 2654435761u * (threadIdx.x + 1) + blockIdx.x;
  const uint32_t a[4] = {x, x * 3u, x * 5u, x * 7u};
  const uint32_t b0 = x * 11u, b1 = x * 13u;
  int acc[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ch = 0; ch < CHAINS; ++ch) {
      if constexpr (FORM == 0) {
        mma_b1_xor(acc[ch], a, b0, b1);
      } else if constexpr (FORM == 1) {
        repro::mma_and_popc(acc[ch], a, b0, b1);
      } else if constexpr (FORM == 2) {
        mma_s8(acc[ch], a, b0, b1);
      } else {
        const uint32_t w0 = a[0] + it + ch, w1 = a[1] + it + ch;
        const uint32_t v = b0 + it + ch;
        const uint32_t f[4] = {pm1_bytes(w0 >> t), pm1_bytes(w1 >> t),
                               pm1_bytes(w0 >> (t + 4)),
                               pm1_bytes(w1 >> (t + 4))};
        mma_s8(acc[ch], f, pm1_bytes(v >> t), pm1_bytes(v >> (t + 4)));
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int ch = 0; ch < CHAINS; ++ch)
    s += acc[ch][0] + acc[ch][1] + acc[ch][2] + acc[ch][3];
  if (s == 0x7fffffff) sink[0] = s;     // keeps the chains live
}

}  // namespace

extern "C" {

// One launch of `blocks` blocks of PROBE_THREADS threads running form
// `form` (0..3) for `iters` rounds of CHAINS MMAs per warp; returns
// cudaGetLastError().
int mma_rate_probe(int form, int blocks, int iters, void* sink,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(sink);
  switch (form) {
    case 0: mma_probe_kernel<0><<<blocks, PROBE_THREADS, 0, s>>>(iters, out); break;
    case 1: mma_probe_kernel<1><<<blocks, PROBE_THREADS, 0, s>>>(iters, out); break;
    case 2: mma_probe_kernel<2><<<blocks, PROBE_THREADS, 0, s>>>(iters, out); break;
    case 3: mma_probe_kernel<3><<<blocks, PROBE_THREADS, 0, s>>>(iters, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
