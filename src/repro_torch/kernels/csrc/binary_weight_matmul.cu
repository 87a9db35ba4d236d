// Weight-only binary matmul for Hopper (sm_90a): kernel K6.
//
// Contract:
//   a     (M, Kw*32) real activations, float32 or bfloat16, zero past the
//         true K (the wrapper pads), row-major;
//   w     (N, Kw) int32 packed weights, bit i of word j = element j*32 + i,
//         1 = +1, 0 = -1 (src/repro_torch/core/bitpack.py);
//   scale (N,) float32 or null;
//   y[m][n] = sum_e bf16(a[m][e]) * (+1 | -1), summed in float32,
//   out = y * scale[n] when scale is given, stored in a's dtype (round to
//   nearest even).
// Each activation is rounded to bf16 first, as the TPU kernel feeds bf16 to
// its MXU. Multiplying by +1/-1 is exact, so for +-1 (or small integer)
// activations every partial sum is an integer below 2^24 and the result is
// exact in any summation order; for real activations it differs from the
// plain version (kernels/ref.py::binary_weight_matmul_ref) by the order of
// the float32 sums only.
//
// Replaces src/repro/kernels/xnor_matmul.py::binary_weight_matmul
//   (_bw_matmul_kernel), which unpacks K-chunks of the weights to +-1 bf16
//   in VMEM for a 128x128 MXU tile.
// Bound on the H100: on the XNOR LM's path M is 4 (one decode step over 4
//   slots) to 128 (prefill), K is 128 or 256 and N 128 or 256, so a call
//   moves a few tens of KB and does at most 8 M multiply-adds. Launch
//   latency bounds it first, then the bytes of the packed weights; a
//   wgmma tile of 64 rows would be mostly empty at M = 4.
// Design: CUDA cores, no unpack buffer. One block per (BW_TM rows,
//   BW_TN columns) output tile. The block stages its activation rows,
//   already rounded to bf16, in shared memory BW_KW words (x32 elements) at
//   a time. Each warp owns BW_NW output columns. The 32 lanes split the 32
//   bits of every packed word (lane b takes element 32*j + b), so all lanes
//   work at any K >= 32 and their shared-memory reads are consecutive
//   (conflict-free). A warp loads up to 32 weight words of a column in one
//   coalesced read and broadcasts word j with __shfl_sync. A weight bit of 0
//   flips the sign bit of the activation (exact). The 32 lane partial sums
//   are reduced by a xor butterfly of shuffles, a fixed order, and lane 0
//   stores.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BW_TM = 8;                  // output rows per block
constexpr int BW_WARPS = 4;               // warps per block
constexpr int BW_NW = 4;                  // output columns per warp
constexpr int BW_TN = BW_WARPS * BW_NW;   // output columns per block
constexpr int BW_KW = 32;                 // packed words staged per step

__device__ __forceinline__ float load_act(const float* p) {
  return __bfloat162float(__float2bfloat16_rn(*p));
}
__device__ __forceinline__ float load_act(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(BW_WARPS * 32)
binary_weight_matmul_kernel(const T* __restrict__ a,
                            const int32_t* __restrict__ w,
                            const float* __restrict__ scale,
                            T* __restrict__ out, int M, int N, int Kw) {
  __shared__ float a_s[BW_TM][BW_KW * 32];   // 32 KB
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BW_TM;
  const int n0 = blockIdx.y * BW_TN + warp * BW_NW;
  const size_t row = static_cast<size_t>(Kw) * 32;
  float acc[BW_NW][BW_TM];
#pragma unroll
  for (int c = 0; c < BW_NW; ++c)
#pragma unroll
    for (int r = 0; r < BW_TM; ++r) acc[c][r] = 0.f;

  for (int k0 = 0; k0 < Kw; k0 += BW_KW) {
    const int kwn = min(BW_KW, Kw - k0);
    const int ke = kwn * 32;
    for (int i = tid; i < BW_TM * ke; i += BW_WARPS * 32) {
      const int r = i / ke, e = i % ke;
      a_s[r][e] = m0 + r < M
          ? load_act(a + static_cast<size_t>(m0 + r) * row + k0 * 32 + e)
          : 0.f;
    }
    uint32_t wv[BW_NW];
#pragma unroll
    for (int c = 0; c < BW_NW; ++c) {
      const int n = n0 + c;
      wv[c] = n < N && lane < kwn
          ? static_cast<uint32_t>(w[static_cast<size_t>(n) * Kw + k0 + lane])
          : 0u;
    }
    __syncthreads();
    for (int j = 0; j < kwn; ++j) {
      float av[BW_TM];
#pragma unroll
      for (int r = 0; r < BW_TM; ++r) av[r] = a_s[r][j * 32 + lane];
#pragma unroll
      for (int c = 0; c < BW_NW; ++c) {
        const uint32_t word = __shfl_sync(0xffffffffu, wv[c], j);
        const uint32_t neg = (~(word >> lane) & 1u) << 31;   // bit 0: -a
#pragma unroll
        for (int r = 0; r < BW_TM; ++r)
          acc[c][r] += __uint_as_float(__float_as_uint(av[r]) ^ neg);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < BW_NW; ++c) {
    const int n = n0 + c;
#pragma unroll
    for (int r = 0; r < BW_TM; ++r) {
      float v = acc[c][r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int m = m0 + r;
      if (lane == 0 && m < M && n < N)
        store_out(out + static_cast<size_t>(m) * N + n,
                  scale != nullptr ? v * scale[n] : v);
    }
  }
}

}  // namespace

extern "C" {

// Enqueues one K6 launch on `stream`; returns cudaGetLastError() (0 on
// success). `a_bf16` != 0: a and out are bfloat16, else float32.
int binary_weight_matmul(const void* a, const void* w, const void* scale,
                         void* out, int M, int N, int Kw, int a_bf16,
                         void* stream) {
  const dim3 grid((M + BW_TM - 1) / BW_TM, (N + BW_TN - 1) / BW_TN);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* wp = static_cast<const int32_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  if (a_bf16) {
    binary_weight_matmul_kernel<__nv_bfloat16><<<grid, BW_WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), wp, sp,
        static_cast<__nv_bfloat16*>(out), M, N, Kw);
  } else {
    binary_weight_matmul_kernel<float><<<grid, BW_WARPS * 32, 0, s>>>(
        static_cast<const float*>(a), wp, sp, static_cast<float*>(out), M, N,
        Kw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
