// Weight-only binary matmul for Hopper (sm_90a): kernel K6.
//
// Contract:
//   a     (M, Kw*32) real activations, float32 or bfloat16, zero past the
//         true K (the wrapper pads), row-major, 16-byte aligned;
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
// Bound on the H100: on the XNOR LM's decode path M is 4 (one step over 4
//   slots), K 128 or 256 and N 128 or 256, so a call moves a few KB and
//   does at most 128 K multiply-adds: latency, not work. The launch and one
//   warp's chain of dependent steps are what the call costs.
// Design: a decode-shaped GEMV on the CUDA cores with no shared memory and
//   no block barrier. One warp per BW_NW = 4 output columns and a row tile
//   of MT = 1, 2 or 4 rows (the launcher takes the smallest that holds M,
//   so no rows are wasted at M <= 4; a larger M is ceil(M / 4) row tiles in
//   the grid). Blocks are one warp, so N = 128 launches 32 blocks, and each
//   warp makes one pass over K. The lanes split K: lane l takes elements
//   4 l .. 4 l + 3 of each 128-element step, read straight from device
//   memory into registers (one 16-byte load of float32, 8 bytes of bf16,
//   per row) with the 4 weight bits it needs from the word that holds them
//   (8 lanes share one word; the activations, 1-2 KB, are re-read from L2
//   by every warp). A weight bit of 0 flips the sign bit of the activation
//   (exact). The MT x 4 partial sums of a lane are reduced over the 32
//   lanes by a fixed butterfly of shuffles that halves the values a lane
//   holds at every step (reduce-scatter: 2 * MT x 4 - 1 shuffles, not 5
//   per value), so each sum ends in 32 / (MT x 4) lanes and one of them
//   stores it. kernels/xnor_matmul.py::bw_plan mirrors the grid.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BW_NW = 4;          // output columns per warp (and per block)
constexpr int BW_KV = 4;          // K elements per lane per 128-element step
constexpr unsigned FULL = 0xffffffffu;

// Elements 4 l .. 4 l + 3 of a row, rounded to bf16, as float32.
__device__ __forceinline__ void load4(const float* p, float (&x)[BW_KV]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = __bfloat162float(__float2bfloat16_rn(v.x));
  x[1] = __bfloat162float(__float2bfloat16_rn(v.y));
  x[2] = __bfloat162float(__float2bfloat16_rn(v.z));
  x[3] = __bfloat162float(__float2bfloat16_rn(v.w));
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[BW_KV]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Sum each of the V values over the warp's 32 lanes. At the step with lane
// offset o a lane keeps half of its values (the upper half where bit o of
// its lane is set) and adds its partner's copy of that half; once one value
// is left the remaining steps add it. Value i ends in the lanes whose bits
// 4, 3, ... spell i (see bw_owner), a fixed order of float additions.
template <int V>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[V],
                                                     int lane) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int o = 16 >> s;
    if ((V >> s) >= 2) {
      const int half = (V >> s) / 2;
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], o);
    }
  }
  return v[0];
}

// The value index that warp_reduce_scatter<V> leaves in `lane`.
template <int V>
__device__ __forceinline__ int bw_owner(int lane) {
  int idx = 0;
#pragma unroll
  for (int s = 0; (V >> s) >= 2; ++s)
    idx += ((lane >> (4 - s)) & 1) * ((V >> s) / 2);
  return idx;
}

template <typename T, int MT>
__global__ void __launch_bounds__(32)
binary_weight_matmul_kernel(const T* __restrict__ a,
                            const int32_t* __restrict__ w,
                            const float* __restrict__ scale,
                            T* __restrict__ out, int M, int N, int Kw) {
  const int lane = threadIdx.x;
  const int n0 = blockIdx.x * BW_NW, m0 = blockIdx.y * MT;
  const size_t lda = static_cast<size_t>(Kw) * 32;
  const int sh = (lane % 8) * BW_KV;          // this lane's bits of a word
  float acc[MT * BW_NW];
#pragma unroll
  for (int i = 0; i < MT * BW_NW; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < Kw; k0 += 4) {        // 4 words = 128 elements
    const int word = k0 + lane / 8;
    if (word >= Kw) break;                    // a ragged last step
    float x[MT][BW_KV];
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (m0 + r < M) {
        load4(a + (m0 + r) * lda + word * 32 + sh, x[r]);
      } else {
#pragma unroll
        for (int i = 0; i < BW_KV; ++i) x[r][i] = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < BW_NW; ++c) {
      const uint32_t wv =
          n0 + c < N ? static_cast<uint32_t>(
                           __ldg(w + static_cast<size_t>(n0 + c) * Kw + word))
                     : 0u;
#pragma unroll
      for (int i = 0; i < BW_KV; ++i) {
        const uint32_t neg = (~(wv >> (sh + i)) & 1u) << 31;  // bit 0: -a
#pragma unroll
        for (int r = 0; r < MT; ++r)
          acc[r * BW_NW + c] +=
              __uint_as_float(__float_as_uint(x[r][i]) ^ neg);
      }
    }
  }

  const float v = warp_reduce_scatter<MT * BW_NW>(acc, lane);
  if (lane % (32 / (MT * BW_NW)) == 0) {
    const int idx = bw_owner<MT * BW_NW>(lane);
    const int m = m0 + idx / BW_NW, n = n0 + idx % BW_NW;
    if (m < M && n < N)
      store_out(out + static_cast<size_t>(m) * N + n,
                scale != nullptr ? v * scale[n] : v);
  }
}

template <typename T>
int launch_bw(const T* a, const int32_t* w, const float* scale, T* out,
              int M, int N, int Kw, cudaStream_t s) {
  const int mt = M <= 1 ? 1 : M == 2 ? 2 : 4;  // row tile: the least >= M
  const dim3 grid((N + BW_NW - 1) / BW_NW, (M + mt - 1) / mt);
  if (mt == 1)
    binary_weight_matmul_kernel<T, 1><<<grid, 32, 0, s>>>(a, w, scale, out,
                                                          M, N, Kw);
  else if (mt == 2)
    binary_weight_matmul_kernel<T, 2><<<grid, 32, 0, s>>>(a, w, scale, out,
                                                          M, N, Kw);
  else
    binary_weight_matmul_kernel<T, 4><<<grid, 32, 0, s>>>(a, w, scale, out,
                                                          M, N, Kw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Enqueues one K6 launch on `stream`; returns cudaGetLastError() (0 on
// success). `a_bf16` != 0: a and out are bfloat16, else float32.
int binary_weight_matmul(const void* a, const void* w, const void* scale,
                         void* out, int M, int N, int Kw, int a_bf16,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* wp = static_cast<const int32_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  if (a_bf16)
    return launch_bw(static_cast<const __nv_bfloat16*>(a), wp, sp,
                     static_cast<__nv_bfloat16*>(out), M, N, Kw, s);
  return launch_bw(static_cast<const float*>(a), wp, sp,
                   static_cast<float*>(out), M, N, Kw, s);
}

}  // extern "C"
