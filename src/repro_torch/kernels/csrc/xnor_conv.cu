// Direct (im2col-free) binary 2-D convolution for Hopper (sm_90a):
// kernels K3 (vpu) and K4 (mxu).
//
// Contract, shared by both kernels:
//   a (N, H, W, Cw) int32 channel-packed NHWC activations (unpadded),
//   w (O, L) int32 per-position packed filters, L = fh*fw*Cw in (dy, dx, cw)
//     order (src/repro_torch/kernels/xnor_conv.py::pack_conv_weights),
//   y[n][oh][ow][o] = sum over (dy, dx, cw) of popc(~(x ^ w)) - n_pad,
//     x = a[n][oh*s - ph + dy][ow*s - pw + dx][cw], or the zero word (all
//     bits -1) outside the image; n_pad = L*32 - k,
//   out (N, Ho, Wo, O) = int32 y, or int8 (y >= c[o]) XOR flip[o].
// Any stride; ragged Ho, Wo and O are masked inside the kernels.
//
// K3 replaces src/repro/kernels/xnor_conv.py::xnor_conv2d_vpu
//   (_xnor_conv_vpu_kernel, _gather_patches, _epilogue). Bound on the H100:
//   the __popc issue rate (16 per clock per SM); every packed input word is
//   reused fh*fw*O times. Design: one block per (image, 8x8 output tile,
//   32 output channels). The block stages the tile's packed halo span,
//   ((8-1)*s+fh) x ((8-1)*s+fw) x Cw words, with zero words outside the
//   image (no padded copy in device memory), and the 32 filter rows in
//   shared memory. Lane = output channel, warp = output row of the tile:
//   halo reads are warp-wide broadcasts and filter rows sit at an odd word
//   stride, so neither read conflicts on a bank. Each thread keeps 8
//   agree-counts in registers.
//
// K4 replaces src/repro/kernels/xnor_conv.py::xnor_conv2d_mxu
//   (_xnor_conv_mxu_kernel). Bound on the H100: the int8 tensor-core rate
//   in principle; at these sizes the gather and the unpack of bits to int8
//   bytes in shared memory. Design: the block's 64 output pixels are the
//   rows of an implicit patch matrix; each step gathers 4 patch words per
//   row (zero words outside the image), unpacks them and the matching
//   filter words to +1/-1 int8 in 16-element k-slabs, and 8 warps run
//   nvcuda::wmma 16x16x16 int8 MMAs with int32 accumulators (exact at any
//   k). Words past L unpack to 0 and add nothing.
#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

#include "bits.cuh"

namespace {

using namespace nvcuda;

constexpr int TH = 8;   // output rows per block tile
constexpr int TW = 8;   // output cols per block tile
constexpr int BO = 32;  // output channels per block tile

constexpr int K3_THREADS = 256;        // 8 warps: warp = tile row, lane = o
constexpr int K3_PIX = TH * TW / 8;    // output pixels per thread

__global__ void __launch_bounds__(K3_THREADS)
xnor_conv2d_vpu_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ w,
                       const float* __restrict__ c,
                       const uint8_t* __restrict__ flip,
                       void* __restrict__ out, int H, int W, int Cw, int O,
                       int fh, int fw, int stride, int ph, int pw, int Ho,
                       int Wo, int n_pad, int tiles_w) {
  extern __shared__ uint32_t smem[];
  const int L = fh * fw * Cw;
  const int ls = L | 1;  // odd word stride between filter rows
  const int sw = (TW - 1) * stride + fw;
  const int sh = (TH - 1) * stride + fh;
  uint32_t* w_s = smem;            // [BO][ls]
  uint32_t* x_s = smem + BO * ls;  // [sh][sw][Cw]
  const int n = blockIdx.z;
  const int oh0 = (blockIdx.x / tiles_w) * TH;
  const int ow0 = (blockIdx.x % tiles_w) * TW;
  const int o0 = blockIdx.y * BO;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < BO * L; i += K3_THREADS) {
    const int r = i / L, l = i % L;
    w_s[r * ls + l] = (o0 + r < O)
        ? static_cast<uint32_t>(w[static_cast<size_t>(o0 + r) * L + l])
        : 0u;
  }
  const int ih0 = oh0 * stride - ph, iw0 = ow0 * stride - pw;
  for (int i = tid; i < sh * sw * Cw; i += K3_THREADS) {
    const int cw = i % Cw, x = (i / Cw) % sw, y = i / (Cw * sw);
    const int ih = ih0 + y, iw = iw0 + x;
    x_s[i] = (ih >= 0 && ih < H && iw >= 0 && iw < W)
        ? static_cast<uint32_t>(
              a[((static_cast<size_t>(n) * H + ih) * W + iw) * Cw + cw])
        : 0u;
  }
  __syncthreads();

  int acc[K3_PIX];
#pragma unroll
  for (int j = 0; j < K3_PIX; ++j) acc[j] = 0;
  const uint32_t* wrow = w_s + lane * ls;
  const int py = warp;  // this warp's output row within the tile
  for (int dy = 0; dy < fh; ++dy) {
    for (int dx = 0; dx < fw; ++dx) {
      const uint32_t* xrow = x_s + ((py * stride + dy) * sw + dx) * Cw;
      const uint32_t* wpos = wrow + (dy * fw + dx) * Cw;
      for (int cw = 0; cw < Cw; ++cw) {
        const uint32_t wv = wpos[cw];
#pragma unroll
        for (int j = 0; j < K3_PIX; ++j)
          acc[j] += __popc(~(xrow[j * stride * Cw + cw] ^ wv));
      }
    }
  }
  const int o = o0 + lane, oh = oh0 + py;
  if (o >= O || oh >= Ho) return;
#pragma unroll
  for (int j = 0; j < K3_PIX; ++j) {
    const int ow = ow0 + j;
    if (ow < Wo)
      repro::store_output(
          out, ((static_cast<size_t>(n) * Ho + oh) * Wo + ow) * O + o,
          acc[j] - n_pad, c, flip, o);
  }
}

constexpr int K4_THREADS = 256;     // 8 warps: 4 (pixel rows) x 2 (channels)
constexpr int K4_KC = 4;            // patch words per step (128 k)
constexpr int K4_SLABS = 2 * K4_KC;
constexpr int K4_ROWS = TH * TW;    // 64 patch rows (output pixels)

__global__ void __launch_bounds__(K4_THREADS)
xnor_conv2d_mxu_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ w,
                       const float* __restrict__ c,
                       const uint8_t* __restrict__ flip,
                       void* __restrict__ out, int H, int W, int Cw, int O,
                       int fh, int fw, int stride, int ph, int pw, int Ho,
                       int Wo, int n_pad, int tiles_w) {
  __shared__ __align__(128) int8_t a_s[K4_SLABS][K4_ROWS][16];
  __shared__ __align__(128) int8_t w_s[K4_SLABS][BO][16];
  __shared__ __align__(128) int32_t c_s[8][16][16];
  const int L = fh * fw * Cw;
  const int n = blockIdx.z;
  const int oh0 = (blockIdx.x / tiles_w) * TH;
  const int ow0 = (blockIdx.x % tiles_w) * TW;
  const int o0 = blockIdx.y * BO;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
  wmma::fill_fragment(acc, 0);

  for (int l0 = 0; l0 < L; l0 += K4_KC) {
    {  // 64 rows x 4 words: one patch word per thread
      const int p = tid / K4_KC, kk = tid % K4_KC, l = l0 + kk;
      const bool valid = l < L;
      uint32_t v = 0u;  // outside the image: the zero word, all bits -1
      if (valid) {
        const int cw = l % Cw, dx = (l / Cw) % fw, dy = l / (Cw * fw);
        const int ih = (oh0 + p / TW) * stride - ph + dy;
        const int iw = (ow0 + p % TW) * stride - pw + dx;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W)
          v = static_cast<uint32_t>(
              a[((static_cast<size_t>(n) * H + ih) * W + iw) * Cw + cw]);
      }
      repro::unpack_pm1_16(v, valid, &a_s[2 * kk][p][0]);
      repro::unpack_pm1_16(v >> 16, valid, &a_s[2 * kk + 1][p][0]);
    }
    if (tid < BO * K4_KC) {  // 32 filter rows x 4 words
      const int r = tid / K4_KC, kk = tid % K4_KC, l = l0 + kk;
      const bool valid = l < L && o0 + r < O;
      const uint32_t v = valid
          ? static_cast<uint32_t>(w[static_cast<size_t>(o0 + r) * L + l])
          : 0u;
      repro::unpack_pm1_16(v, valid, &w_s[2 * kk][r][0]);
      repro::unpack_pm1_16(v >> 16, valid, &w_s[2 * kk + 1][r][0]);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < K4_SLABS; ++s) {
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
  const int kp = L * 32;  // +1/-1 positions summed: agree = (kp + dot) / 2
  for (int e = lane; e < 256; e += 32) {
    const int r = e / 16, cc = e % 16;
    const int p = wm * 16 + r, o = o0 + wn * 16 + cc;
    const int oh = oh0 + p / TW, ow = ow0 + p % TW;
    if (oh < Ho && ow < Wo && o < O)
      repro::store_output(
          out, ((static_cast<size_t>(n) * Ho + oh) * Wo + ow) * O + o,
          (kp + c_s[warp][r][cc]) / 2 - n_pad, c, flip, o);
  }
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success). `c`/`flip` null: int32 counts out.
int xnor_conv2d_vpu(const void* a, const void* w, const void* c,
                    const void* flip, void* out, int N, int H, int W, int Cw,
                    int O, int fh, int fw, int stride, int ph, int pw, int Ho,
                    int Wo, int n_pad, void* stream) {
  const int tiles_w = (Wo + TW - 1) / TW, tiles_h = (Ho + TH - 1) / TH;
  const int L = fh * fw * Cw;
  const size_t words = static_cast<size_t>(BO) * (L | 1) +
      static_cast<size_t>((TH - 1) * stride + fh) * ((TW - 1) * stride + fw) * Cw;
  const size_t smem = words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        xnor_conv2d_vpu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(tiles_h * tiles_w, (O + BO - 1) / BO, N);
  xnor_conv2d_vpu_kernel<<<grid, K3_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(w),
      static_cast<const float*>(c), static_cast<const uint8_t*>(flip), out, H,
      W, Cw, O, fh, fw, stride, ph, pw, Ho, Wo, n_pad, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

int xnor_conv2d_mxu(const void* a, const void* w, const void* c,
                    const void* flip, void* out, int N, int H, int W, int Cw,
                    int O, int fh, int fw, int stride, int ph, int pw, int Ho,
                    int Wo, int n_pad, void* stream) {
  const int tiles_w = (Wo + TW - 1) / TW, tiles_h = (Ho + TH - 1) / TH;
  const dim3 grid(tiles_h * tiles_w, (O + BO - 1) / BO, N);
  xnor_conv2d_mxu_kernel<<<grid, K4_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(w),
      static_cast<const float*>(c), static_cast<const uint8_t*>(flip), out, H,
      W, Cw, O, fh, fw, stride, ph, pw, Ho, Wo, n_pad, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
