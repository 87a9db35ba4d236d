// Packed XNOR matmul for Hopper (sm_90a): kernels K1 (vpu) and K2 (mxu).
//
// Contract (paper eq. 5 / eq. 8), shared by both kernels:
//   a (M, Kw) int32 packed activations, w (N, Kw) int32 packed weights,
//   y[m][n] = sum_j popc(~(a[m][j] ^ w[n][j])) - n_pad,  n_pad = Kw*32 - k,
//   out = int32 y, or int8 (y >= c[n]) XOR flip[n] when c != null.
// Ragged M, N and Kw are masked inside the kernels; nothing is pre-padded.
//
// K1 replaces src/repro/kernels/xnor_matmul.py::xnor_matmul_vpu
//   (_xnor_vpu_kernel). Bound on the H100: the __popc issue rate (16 per
//   clock per SM) once M is large (im2col convs); at the FC shapes of the
//   served batch (M = slots) the weight bytes and the launch itself.
//   Design: one thread per output; a block stages an 8-row activation tile
//   and a 32-row weight tile, 32 words deep, in shared memory, so each word
//   read from device memory feeds 8 or 32 XNOR+popcounts. The weight tile
//   row stride is 33 words, so the 32 lanes of a warp (32 weight rows, one
//   activation row broadcast) read 32 different banks.
//
// K2 replaces src/repro/kernels/xnor_matmul.py::xnor_matmul_mxu
//   (_xnor_mxu_kernel). Bound on the H100: the int8 tensor-core rate for
//   large M; the unpack of bits to int8 bytes in shared memory (32 bytes
//   written per word) costs more than the MMAs at these sizes. Design:
//   words are unpacked to +1/-1 int8 in shared memory, 16-element k-slabs
//   stored contiguously so every WMMA tile pointer is 256-bit aligned, and
//   nvcuda::wmma 16x16x16 int8 MMAs accumulate in int32 — exact at every k
//   (the TPU kernel's bf16/f32 form is exact only for k <= 2^24). Words past
//   Kw unpack to 0, which adds nothing to the dot.
#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

#include "bits.cuh"

namespace {

using namespace nvcuda;

constexpr int K1_TM = 8;    // output rows per block (threadIdx.y)
constexpr int K1_TN = 32;   // output cols per block (threadIdx.x)
constexpr int K1_KC = 32;   // packed words staged per step

__global__ void __launch_bounds__(K1_TM * K1_TN)
xnor_matmul_vpu_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ w,
                       const float* __restrict__ c,
                       const uint8_t* __restrict__ flip,
                       void* __restrict__ out, int M, int N, int Kw,
                       int n_pad) {
  __shared__ uint32_t a_s[K1_TM][K1_KC];
  __shared__ uint32_t w_s[K1_TN][K1_KC + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * K1_TN + tx;
  const int m0 = blockIdx.x * K1_TM, n0 = blockIdx.y * K1_TN;
  int acc = 0;
  for (int k0 = 0; k0 < Kw; k0 += K1_KC) {
    const int kn = min(K1_KC, Kw - k0);
    for (int i = tid; i < K1_TM * K1_KC; i += K1_TM * K1_TN) {
      const int r = i / K1_KC, kk = i % K1_KC;
      a_s[r][kk] = (m0 + r < M && kk < kn)
          ? static_cast<uint32_t>(a[static_cast<size_t>(m0 + r) * Kw + k0 + kk])
          : 0u;
    }
    for (int i = tid; i < K1_TN * K1_KC; i += K1_TM * K1_TN) {
      const int r = i / K1_KC, kk = i % K1_KC;
      w_s[r][kk] = (n0 + r < N && kk < kn)
          ? static_cast<uint32_t>(w[static_cast<size_t>(n0 + r) * Kw + k0 + kk])
          : 0u;
    }
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) acc += __popc(~(a_s[ty][kk] ^ w_s[tx][kk]));
    __syncthreads();
  }
  const int m = m0 + ty, n = n0 + tx;
  if (m < M && n < N)
    repro::store_output(out, static_cast<size_t>(m) * N + n, acc - n_pad, c,
                        flip, n);
}

constexpr int K2_BM = 32;            // block tile rows: 2 warps of 16
constexpr int K2_BN = 32;            // block tile cols: 2 warps of 16
constexpr int K2_KC = 4;             // packed words per step (128 k)
constexpr int K2_SLABS = 2 * K2_KC;  // 16-element k-slabs per step

__global__ void __launch_bounds__(128)
xnor_matmul_mxu_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ w,
                       const float* __restrict__ c,
                       const uint8_t* __restrict__ flip,
                       void* __restrict__ out, int M, int N, int Kw,
                       int n_pad) {
  __shared__ __align__(128) int8_t a_s[K2_SLABS][K2_BM][16];
  __shared__ __align__(128) int8_t w_s[K2_SLABS][K2_BN][16];
  __shared__ __align__(128) int32_t c_s[4][16][16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.x * K2_BM, n0 = blockIdx.y * K2_BN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
  wmma::fill_fragment(acc, 0);
  for (int k0 = 0; k0 < Kw; k0 += K2_KC) {
    {  // 128 threads: one activation word and one weight word each
      const int r = tid / K2_KC, kk = tid % K2_KC;
      const bool kin = k0 + kk < Kw;
      const bool ain = kin && m0 + r < M;
      const bool win = kin && n0 + r < N;
      const uint32_t av = ain
          ? static_cast<uint32_t>(a[static_cast<size_t>(m0 + r) * Kw + k0 + kk])
          : 0u;
      const uint32_t wv = win
          ? static_cast<uint32_t>(w[static_cast<size_t>(n0 + r) * Kw + k0 + kk])
          : 0u;
      repro::unpack_pm1_16(av, ain, &a_s[2 * kk][r][0]);
      repro::unpack_pm1_16(av >> 16, ain, &a_s[2 * kk + 1][r][0]);
      repro::unpack_pm1_16(wv, win, &w_s[2 * kk][r][0]);
      repro::unpack_pm1_16(wv >> 16, win, &w_s[2 * kk + 1][r][0]);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < K2_SLABS; ++s) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, &a_s[s][wm * 16][0], 16);
      wmma::load_matrix_sync(fb, &w_s[s][wn * 16][0], 16);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(&c_s[warp][0][0], acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int kp = Kw * 32;  // +1/-1 positions summed: agree = (kp + dot) / 2
  for (int e = lane; e < 256; e += 32) {
    const int r = e / 16, cc = e % 16;
    const int m = m0 + wm * 16 + r, n = n0 + wn * 16 + cc;
    if (m < M && n < N)
      repro::store_output(out, static_cast<size_t>(m) * N + n,
                          (kp + c_s[warp][r][cc]) / 2 - n_pad, c, flip, n);
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success). `c`/`flip` null: int32 counts out.
int xnor_matmul_vpu(const void* a, const void* w, const void* c,
                    const void* flip, void* out, int M, int N, int Kw,
                    int n_pad, void* stream) {
  const dim3 grid((M + K1_TM - 1) / K1_TM, (N + K1_TN - 1) / K1_TN);
  const dim3 block(K1_TN, K1_TM);
  xnor_matmul_vpu_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(w),
      static_cast<const float*>(c), static_cast<const uint8_t*>(flip), out, M,
      N, Kw, n_pad);
  return static_cast<int>(cudaGetLastError());
}

int xnor_matmul_mxu(const void* a, const void* w, const void* c,
                    const void* flip, void* out, int M, int N, int Kw,
                    int n_pad, void* stream) {
  const dim3 grid((M + K2_BM - 1) / K2_BM, (N + K2_BN - 1) / K2_BN);
  xnor_matmul_mxu_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(w),
      static_cast<const float*>(c), static_cast<const uint8_t*>(flip), out, M,
      N, Kw, n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
