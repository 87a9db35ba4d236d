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
//   (_xnor_conv_mxu_kernel). Bound on the H100: at the Table 2 shapes and
//   the served batch, the launch and the latency of staging a block's
//   operands; the products (2.4 G bit-MACs over CONV-2..6 at batch 4) take
//   well under a microsecond at the 1-bit MMA rate. Design: output
//   channels (O) on the 16 rows of the MMA and output positions on its 8
//   columns (one n8 tile = 8 positions of one output row), products by
//   mma.sync m16n8k256 .b1 .and.popc on the packed words as they lie in
//   shared memory (one MMA per 8 patch words; csrc/xnor_matmul.cu gives
//   the probe rates that chose this form), y = 32 L - popc(patch) -
//   popc(filter) + 2 popc(patch AND filter) - n_pad, the popcounts taken
//   by the same MMA against all-ones operands, in the accumulators'
//   layout. A block stages its filter rows (o0..o0+bo) by 16-byte
//   cp.async and the tile's packed halo span by 4-byte cp.async, zero
//   words outside the image (the halo of K3); rows and halo pixels sit at
//   word strides that keep each fragment load on 32 banks. A table maps
//   each patch word to its halo offset; words past L read as zero on both
//   sides. One barrier, then the 4 warps take (m16 tile, up to 4 n8 tiles)
//   units, with L split over warps where units are fewer than warps. Each
//   warp's share meets the others' in shared memory, where the epilogue
//   reads the tile with O innermost and writes 4 channels a thread
//   (thresholds loaded into registers at the start). conv_plan
//   (kernels/xnor_conv.py::mxu_plan mirrors it) shrinks channels, then
//   tile rows, until the blocks fill a wave of the 132 SMs (CONV-5/6 at
//   batch 4: 256 blocks, not 64), and streams the filter words in passes
//   where a block would not fit.
#include <cstdint>
#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

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

constexpr int K4_THREADS = 128;    // 4 warps
constexpr int K4_WARPS = K4_THREADS / 32;
constexpr int K4_NT = 4;           // most n8 tiles (output rows) per warp unit
constexpr int WAVE = 132;          // blocks that fill the H100's SMs once

// A block: th output rows x TW columns x bo channels of one image; the
// filter words stream through shared memory lc at a time (lc = L rounded
// up to 8 where it fits); halo sh x sw pixels at a stride of P words.
struct ConvPlan {
  int th, bo, lc, sh, sw, P, ks;
  size_t smem;
};

int pow2_at_least(int x, int lo, int hi) {
  int p = lo;
  while (p < x && p < hi) p *= 2;
  return p;
}

size_t conv_smem_words(const ConvPlan& p, int L) {
  const int tp = p.th * TW, l8 = (L + 7) / 8 * 8;
  return static_cast<size_t>(p.bo) * (p.lc + 4) +
         static_cast<size_t>(p.sh) * p.sw * p.P + l8 +
         static_cast<size_t>(tp) * (p.bo + 4);
}

// Largest tile first; halve bo to 32, then th, then bo to 16 until the
// blocks make a wave; then halve lc, then th, then bo until the block
// fits. Returns false when even th = 1, bo = 16, lc = 8 does not fit.
bool conv_plan(int N, int Cw, int O, int fh, int fw, int stride, int Ho,
               int Wo, ConvPlan* out) {
  ConvPlan p;
  const int L = fh * fw * Cw;
  p.bo = pow2_at_least(O, 16, 64);
  p.th = pow2_at_least(Ho, 1, TH);
  const auto blocks = [&] {
    return static_cast<long long>(N) * ((Ho + p.th - 1) / p.th) *
           ((Wo + TW - 1) / TW) * ((O + p.bo - 1) / p.bo);
  };
  while (blocks() < WAVE) {
    if (p.bo > 32) p.bo /= 2;
    else if (p.th > 1) p.th /= 2;
    else if (p.bo > 16) p.bo /= 2;
    else break;
  }
  // pixel stride: Cw, or the least P >= Cw with stride * P = 4 mod 8, so
  // the 8 positions of an n8 tile start 4 banks apart
  p.P = Cw;
  for (int q = Cw; q < Cw + 8; ++q) {
    if (stride * q % 8 == 4) {
      p.P = q;
      break;
    }
  }
  p.lc = (L + 7) / 8 * 8;
  for (;;) {
    p.sh = (p.th - 1) * stride + fh;
    p.sw = (TW - 1) * stride + fw;
    p.smem = sizeof(uint32_t) * conv_smem_words(p, L);
    if (p.smem <= repro::SMEM_LIMIT) break;
    if (p.lc > 8) p.lc = (p.lc / 2 + 7) / 8 * 8;
    else if (p.th > 1) p.th /= 2;
    else if (p.bo > 16) p.bo /= 2;
    else return false;
  }
  // warps per (m16 tile, K4_NT n8 tiles) unit: a power of two that
  // splits L where units are fewer than warps
  const int units = p.bo / 16 * ((p.th + K4_NT - 1) / K4_NT);
  p.ks = 1;
  while (2 * p.ks * units <= K4_WARPS && 2 * p.ks <= (L + 7) / 8) p.ks *= 2;
  *out = p;
  return true;
}

struct ConvArgs {
  int H, W, Cw, O, fh, fw, stride, ph, pw, Ho, Wo, n_pad;
  int tiles_w, tiles_h;
  ConvPlan p;
};

// Stage filter words [l0, l0 + lc) of rows o0 .. o0+bo-1 (zero rows past
// O, zero words past L up to the 8-word step) at a row stride of lc + 4.
__device__ __forceinline__ void stage_pass(const int32_t* __restrict__ w,
                                           int O, int L, int o0, int bo,
                                           int l0, int lc, uint32_t* w_s) {
  const int l1 = min(l0 + lc, L), end = min(l0 + lc, (L + 7) / 8 * 8);
  repro::stage_words(
      bo, l0, l1, end - l1, repro::rows_vec(w, L, l0, l1, lc + 4),
      [&](int r) {
        return o0 + r < O ? w + static_cast<size_t>(o0 + r) * L : nullptr;
      },
      w_s, lc + 4, K4_THREADS);
  repro::cp_async_commit();
}

__global__ void __launch_bounds__(K4_THREADS)
xnor_conv2d_mxu_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ w,
                       const float* __restrict__ c,
                       const uint8_t* __restrict__ flip,
                       void* __restrict__ out, ConvArgs g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const ConvPlan& p = g.p;
  const int L = g.fh * g.fw * g.Cw, steps = (L + 7) / 8;
  const int tp = p.th * TW, ws = p.lc + 4, rs = p.bo + 4;
  uint32_t* w_s = smem;                         // [bo][lc + 4]
  int* red = reinterpret_cast<int*>(w_s + p.bo * ws);   // [tp][bo + 4]
  int* off = red + tp * rs;                     // [8 steps]
  uint32_t* x_s = reinterpret_cast<uint32_t*>(off + 8 * steps);  // [sh][sw][P]
  // grid: (spatial tile, channel tile, image); bo, th and ks are powers of
  // two, so the decode below shifts instead of dividing
  const int n = blockIdx.z, o0 = blockIdx.y * p.bo;
  const int oh0 = (blockIdx.x / g.tiles_w) * p.th;
  const int ow0 = (blockIdx.x % g.tiles_w) * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t = lane % 4;
  const int lmt = repro::ilog2(p.bo) - 4;
  const int lunits = lmt + (p.th > K4_NT ? repro::ilog2(p.th / K4_NT) : 0);
  const int lks = repro::ilog2(p.ks), units = 1 << lunits;

  // the first filter pass in flight while the halo is staged
  stage_pass(w, g.O, L, o0, p.bo, 0, p.lc, w_s);
  // this thread's 4 epilogue channels (K4_THREADS % (bo / 4) == 0) and
  // their thresholds, loaded while the block computes
  const int lvg = repro::ilog2(p.bo) - 2, e4 = 4 * (threadIdx.x & ((1 << lvg) - 1));
  float c4[4] = {};
  bool f4[4] = {};
  if (c != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (o0 + e4 + i < g.O) {
        c4[i] = c[o0 + e4 + i];
        f4[i] = flip[o0 + e4 + i] != 0;
      }
    }
  }
  // the halo by 4-byte cp.async, zero words outside the image
  const int ih0 = oh0 * g.stride - g.ph, iw0 = ow0 * g.stride - g.pw;
  for (repro::Walk3 i(p.sw, g.Cw, K4_THREADS); i.r < p.sh; i.next()) {
    const int ih = ih0 + i.r, iw = iw0 + i.b;
    uint32_t* d = x_s + (i.r * p.sw + i.b) * p.P + i.c;
    if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
      repro::cp_async4(
          d, a + ((static_cast<size_t>(n) * g.H + ih) * g.W + iw) * g.Cw + i.c);
    else
      *d = 0u;
  }
  repro::cp_async_commit();
  for (repro::Walk3 l(g.fw, g.Cw, K4_THREADS);; l.next()) {  // (dy, dx, cw)
    const int i = (l.r * g.fw + l.b) * g.Cw + l.c;
    if (i >= 8 * steps) break;
    off[i] = i < L ? (l.r * p.sw + l.b) * p.P + l.c : -1;
  }
  if (p.ks > 1)                                 // split L meets by atomics
    for (int i = threadIdx.x; i < tp * rs; i += K4_THREADS) red[i] = 0;
  repro::cp_async_wait_all();
  __syncthreads();

  for (int l0 = 0; l0 < L; l0 += p.lc) {
    if (l0 > 0) {
      __syncthreads();                          // the last pass is done
      stage_pass(w, g.O, L, o0, p.bo, l0, p.lc, w_s);
      repro::cp_async_wait_all();
      __syncthreads();
    }
    const int q_lo = l0 / 8, np = min(p.lc / 8, steps - q_lo);
    for (int item = warp; item < units << lks; item += K4_WARPS) {
      const int unit = item & (units - 1), sl = item >> lunits;
      const int mi = unit & ((1 << lmt) - 1), j0 = K4_NT * (unit >> lmt);
      int base[K4_NT];
#pragma unroll
      for (int j = 0; j < K4_NT; ++j)     // column gq of n-tile j0 + j
        base[j] = (min(j0 + j, p.th - 1) * g.stride * p.sw +
                   gq * g.stride) * p.P;
      int acc[K4_NT][4] = {}, pa[K4_NT][4] = {}, pw[4] = {};
      const uint32_t ones[4] = {~0u, ~0u, ~0u, ~0u};
      const uint32_t* f0 = w_s + (16 * mi + gq) * ws + t;
      const uint32_t* f1 = f0 + 8 * ws;
      for (int q = (sl * np) >> lks; q < ((sl + 1) * np) >> lks; ++q) {
        const uint32_t fa[4] = {f0[8 * q], f1[8 * q], f0[8 * q + 4],
                                f1[8 * q + 4]};
        repro::mma_and_popc(pw, fa, ~0u, ~0u);     // popc(filter rows)
        const int e0 = off[8 * (q_lo + q) + t];
        const int e1 = off[8 * (q_lo + q) + t + 4];
#pragma unroll
        for (int j = 0; j < K4_NT; ++j) {
          if (j0 + j < p.th) {
            const uint32_t b0 = e0 >= 0 ? x_s[base[j] + e0] : 0u;
            const uint32_t b1 = e1 >= 0 ? x_s[base[j] + e1] : 0u;
            repro::mma_and_popc(pa[j], ones, b0, b1);  // popc(patch)
            repro::mma_and_popc(acc[j], fa, b0, b1);
          }
        }
      }
      // this warp's share over its words, 2 popc(x AND w) - popc(x) -
      // popc(w), into red[position][channel]
#pragma unroll
      for (int j = 0; j < K4_NT; ++j) {
        if (j0 + j < p.th) {
          int v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = 2 * acc[j][i] - pa[j][i] - pw[i];
          int* r = red + (8 * (j0 + j) + 2 * t) * rs + 16 * mi + gq;
          int* rr[4] = {r, r + rs, r + 8, r + rs + 8};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (lks > 0 || l0 > 0) atomicAdd(rr[i], v[i]);
            else *rr[i] = v[i];
          }
        }
      }
    }
  }
  __syncthreads();
  // 4 channels a thread: one 4-byte (bits) or 16-byte (counts) store
  // where O % 4 == 0, else per channel
  const int kp = 32 * L - g.n_pad;
  if (o0 + e4 >= g.O) return;
  const bool vec =
      g.O % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int q = threadIdx.x >> lvg; q < tp; q += K4_THREADS >> lvg) {
    const int oh = oh0 + q / TW, ow = ow0 + q % TW;
    if (oh >= g.Ho || ow >= g.Wo) continue;
    const int4 r = *reinterpret_cast<const int4*>(red + q * rs + e4);
    const int y[4] = {kp + r.x, kp + r.y, kp + r.z, kp + r.w};
    const size_t idx =
        ((static_cast<size_t>(n) * g.Ho + oh) * g.Wo + ow) * g.O + o0 + e4;
    if (c != nullptr) {
      int8_t* o8 = static_cast<int8_t*>(out) + idx;
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        word |= static_cast<uint32_t>((static_cast<float>(y[i]) >= c4[i]) !=
                                      f4[i]) << (8 * i);
      if (vec) {
        *reinterpret_cast<uint32_t*>(o8) = word;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (o0 + e4 + i < g.O)
            o8[i] = static_cast<int8_t>((word >> (8 * i)) & 1u);
      }
    } else {
      int32_t* o32 = static_cast<int32_t*>(out) + idx;
      if (vec) {
        *reinterpret_cast<int4*>(o32) = make_int4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (o0 + e4 + i < g.O) o32[i] = y[i];
      }
    }
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
  ConvArgs g;
  if (!conv_plan(N, Cw, O, fh, fw, stride, Ho, Wo, &g.p))
    return static_cast<int>(cudaErrorInvalidValue);
  g.H = H; g.W = W; g.Cw = Cw; g.O = O; g.fh = fh; g.fw = fw;
  g.stride = stride; g.ph = ph; g.pw = pw; g.Ho = Ho; g.Wo = Wo;
  g.n_pad = n_pad;
  g.tiles_w = (Wo + TW - 1) / TW;
  g.tiles_h = (Ho + g.p.th - 1) / g.p.th;
  const long long tiles = static_cast<long long>(g.tiles_h) * g.tiles_w;
  const int o_tiles = (O + g.p.bo - 1) / g.p.bo;
  if (tiles > 0x7fffffffLL || o_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro::launch_cluster(
      xnor_conv2d_mxu_kernel, dim3(static_cast<unsigned>(tiles), o_tiles, N),
      dim3(1), K4_THREADS, g.p.smem, stream, a, w, c, flip, out, g);
}

}  // extern "C"
