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
//   the CUDA cores' integer pipes over the XOR-popcounts (CONV-2..6 at batch
//   4: 75.5 M words; per 16-byte unit the carry-save core issues 8 LOP3 and 1
//   IADD3 at 64 a clock per SM and 2 POPC at 16, so the ALU pipe is the
//   busier, about 10.2 us at 1980 MHz) and, per block, the latency of staging
//   its operands. Design: a block of 4 warps takes th x 8 output positions and
//   32 output channels of one image; lane = output channel (filter row), and
//   each thread register-blocks VP = 4 positions of a tile row, so one 16-byte
//   load of its filter row serves 4 positions and one broadcast 16-byte load
//   of a patch 4 words. The XOR words go through the carry-save core of
//   csrc/bits.cuh (xor_popc: two full adders per 16-byte unit, 2 popcounts
//   instead of 4; agree = 32 L - sum popc(x XOR w) - n_pad, no NOT). The 32
//   filter rows arrive by the TMA unit on an mbarrier: one bulk copy where L =
//   4 mod 8 (rows as they lie), else one per row from warp 0's lanes into rows
//   at L + 4 words, so the 8 rows a quarter-warp reads lie in 8 different
//   16-byte bank groups; the halo, ((th-1)*s+fh) x (7*s+fw) x Cw words, by
//   16-byte cp.async (warp = halo row, lane = pixel) with zero words outside
//   the image, both in flight while the block loads its thresholds. vpu_plan
//   (kernels/xnor_conv.py::vpu_plan mirrors it) halves th from 8 until the
//   blocks make a wave of the 132 SMs (CONV-3/4 at th = 4, CONV-5/6 at th = 2:
//   256 blocks each at batch 4, not 128 and 64), then until the block fits.
//   The grid is (tiles, channel groups, images), the tile index split into row
//   and column by a multiply and shift computed on the host; no block divides.
//   The Table 2 geometries (3 x 3, stride 1, Cw 4, 8 and 16) are template
//   constants; strided, ragged and 4-byte (Cw % 4 != 0) shapes run the same
//   kernel with them read at run time. The wrapper copies an operand that does
//   not start on 16 bytes, so 16-byte units need only Cw % 4 == 0. Where a
//   block has at most 2 warp units (th = 1), L is split over its warps and the
//   sums meet by shared-memory atomics (run_units in csrc/bits.cuh).
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

REPRO_PHASE_TABLE(k3_phases)  // benchmarks/torch_vpu_phases.py k3

namespace {

constexpr int TH = 8;   // output rows per block tile (at most)
constexpr int TW = 8;   // output cols per block tile
constexpr int WAVE = 132;          // blocks that fill the H100's SMs once

constexpr int K3_THREADS = 128;    // 4 warps
constexpr int K3_WARPS = K3_THREADS / 32;
constexpr int K3_BO = 32;          // output channels per block: lane = channel
constexpr int VP = 4;              // output positions per thread

int pow2_at_least(int x, int lo, int hi) {
  int p = lo;
  while (p < x && p < hi) p *= 2;
  return p;
}

// K3's static shared memory: split-L partial sums, one int per (lane,
// position) of at most K3_WARPS / 2 warp units, and the filter rows'
// mbarrier.
struct K3Static {
  int red[K3_WARPS / 2 * 32 * VP];
  uint64_t bar;
};

// K3's launch, computed on the host: tile height th, filter row stride ls
// (words), dynamic shared memory, and the multiply-shift that splits a
// tile index into row and column.
struct VpuConv {
  int H, W, Cw, O, fh, fw, stride, ph, pw, Ho, Wo, n_pad;
  int th, tiles_w, tiles_h, ls;
  size_t smem;
  repro::FastDiv tiles;
};

// Word stride of a staged filter row of L words: 16-byte units (Cw % 4 ==
// 0), L where L = 4 mod 8 (one bulk copy for all rows), else L + 4, so the
// 8 rows a quarter-warp reads start in 8 different 16-byte bank groups;
// 4-byte words: odd, so 32 rows lie in 32 banks.
int k3_stride(int L, int V) {
  return V == 4 ? (L % 8 == 4 ? L : L + 4) : (L | 1);
}

// th from min(TH, Ho rounded up to a power of two), halved until the blocks
// make a wave, then until the block fits. Returns false when th = 1 does
// not fit.
bool vpu_plan(int N, int Cw, int O, int fh, int fw, int stride, int Ho,
              int Wo, VpuConv* g) {
  const int L = fh * fw * Cw, V = Cw % 4 == 0 ? 4 : 1;
  g->ls = k3_stride(L, V);
  g->tiles_w = (Wo + TW - 1) / TW;
  const long long per_tile_row = static_cast<long long>(N) * g->tiles_w *
                                 ((O + K3_BO - 1) / K3_BO);
  int th = pow2_at_least(Ho, 1, TH);
  while (th > 1 && per_tile_row * ((Ho + th - 1) / th) < WAVE) th /= 2;
  for (;; th /= 2) {
    const int sh = (th - 1) * stride + fh, sw = (TW - 1) * stride + fw;
    g->smem = sizeof(uint32_t) * (static_cast<size_t>(K3_BO) * g->ls +
                                  static_cast<size_t>(sh) * sw * Cw);
    if (g->smem + sizeof(K3Static) <= repro::SMEM_LIMIT) break;
    if (th == 1) return false;
  }
  g->th = th;
  g->tiles_h = (Ho + th - 1) / th;
  g->tiles = repro::make_fastdiv(g->tiles_w);
  return true;
}

// CW, F, S > 0 fix Cw, the filter (F x F) and the stride at compile time
// (the Table 2 convs); 0 reads them from g. V: words per shared-memory
// load, 4 where Cw % 4 == 0, else 1.
template <int CW, int F, int S, int V>
__global__ void __launch_bounds__(K3_THREADS, 4)
xnor_conv2d_vpu_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ w,
                       const float* __restrict__ c,
                       const uint8_t* __restrict__ flip,
                       void* __restrict__ out, VpuConv g) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ K3Static st;
  REPRO_PHASE(k3_phases, 0);  // started
  const int cw = CW > 0 ? CW : g.Cw;
  const int fh = F > 0 ? F : g.fh, fw = F > 0 ? F : g.fw;
  const int s = S > 0 ? S : g.stride;
  const int L = fh * fw * cw, ls = g.ls;
  const int sh = (g.th - 1) * s + fh, sw = (TW - 1) * s + fw;
  uint32_t* w_s = smem;                        // [K3_BO][ls]
  uint32_t* x_s = smem + K3_BO * ls;           // [sh][sw][cw]
  // grid: (tile, channel group, image); the tile's row by a multiply-shift
  const int ty = static_cast<int>(repro::fastdiv(blockIdx.x, g.tiles));
  const int oh0 = ty * g.th;
  const int ow0 = (static_cast<int>(blockIdx.x) - ty * g.tiles_w) * TW;
  const int o0 = blockIdx.y * K3_BO, n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = min(K3_BO, g.O - o0);

  // the block's filter rows: by the TMA unit where they are 16-byte units
  // (one bulk copy where ls == L, else one a row, issued by warp 0's
  // lanes), else by 4-byte cp.async (warp = row, lane = word); the wrapper
  // hands over operands that start on 16 bytes
  const int32_t* wsrc = w + static_cast<size_t>(o0) * L;
  if constexpr (V == 4) {
    if (warp == 0) {
      if (lane == 0) {
        repro::mbar_init(&st.bar);
        repro::mbar_expect_tx(&st.bar, rows * L * 4);
      }
      __syncwarp();
      if (ls == L) {
        if (lane == 0) repro::bulk_copy(w_s, wsrc, rows * L * 4, &st.bar);
      } else {
        for (int r = lane; r < rows; r += 32)
          repro::bulk_copy(w_s + r * ls, wsrc + r * L, L * 4, &st.bar);
      }
    }
  } else {
    for (int r = warp; r < rows; r += K3_WARPS)
      for (int k = lane; k < L; k += 32)
        repro::cp_async4(w_s + r * ls + k, wsrc + r * L + k);
  }
  // the halo by cp.async (warp = halo row, lane = pixel; 16-byte copies
  // where V == 4), zero words outside the image
  const int ih0 = oh0 * s - g.ph, iw0 = ow0 * s - g.pw;
  for (int y = warp; y < sh; y += K3_WARPS) {
    const int ih = ih0 + y;
    for (int x = lane; x < sw; x += 32) {
      const int iw = iw0 + x;
      uint32_t* d = x_s + (y * sw + x) * cw;
      if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) {
        const int32_t* src =
            a + ((static_cast<size_t>(n) * g.H + ih) * g.W + iw) * cw;
        if constexpr (V == 4) {
          for (int k = 0; k < cw; k += 4) repro::cp_async16(d + k, src + k);
        } else {
          for (int k = 0; k < cw; ++k) repro::cp_async4(d + k, src + k);
        }
      } else {
        for (int k = 0; k < cw; ++k) d[k] = 0u;
      }
    }
  }
  repro::cp_async_commit();
  REPRO_PHASE(k3_phases, 1);  // copies issued
  // this lane's channel and its threshold, loaded while the copies fly
  const int o = o0 + lane;
  const bool live = o < g.O;
  const bool thr = c != nullptr && live;
  const float c_o = thr ? c[o] : 0.f;
  const bool f_o = thr && flip[o] != 0;
  for (int i = threadIdx.x; i < K3_WARPS / 2 * 32 * VP; i += K3_THREADS)
    st.red[i] = 0;
  repro::cp_async_wait_all();
  __syncthreads();
  if constexpr (V == 4) repro::mbar_wait(&st.bar, 0);  // what the TMA wrote
  REPRO_PHASE(k3_phases, 2);  // operands landed

  // warp units: 32 channels x VP positions of one tile row (position p =
  // py * TW + px; TW is a power of two, so p / TW and p % TW shift)
  const int kp = 32 * L - g.n_pad;
  auto base = [&](int p) { return ((p / TW) * s * sw + (p % TW) * s) * cw; };
  auto epi = [&](int, int pb, const int (&dis)[VP]) {
    const int oh = oh0 + pb * VP / TW, ow = ow0 + pb * VP % TW;
    if (!live || oh >= g.Ho) return;
    const size_t idx =
        ((static_cast<size_t>(n) * g.Ho + oh) * g.Wo + ow) * g.O + o;
#pragma unroll
    for (int j = 0; j < VP; ++j) {
      if (ow + j >= g.Wo) break;
      const int y = kp - dis[j];
      const size_t at = idx + static_cast<size_t>(j) * g.O;
      if (c != nullptr)
        static_cast<int8_t*>(out)[at] =
            static_cast<int8_t>((static_cast<float>(y) >= c_o) != f_o);
      else
        static_cast<int32_t*>(out)[at] = y;
    }
  };
  repro::run_units<K3_WARPS, VP, V, (F > 0 && CW > 0 ? F * CW / V : 0)>(
      1, g.th * TW / VP, w_s, ls, x_s, sw * cw, fw * cw / V, L / V, base,
      epi, st.red);
#ifdef REPRO_PHASES
  __syncthreads();
#endif
  REPRO_PHASE(k3_phases, 3);  // every warp done
}

constexpr int K4_THREADS = 128;    // 4 warps
constexpr int K4_WARPS = K4_THREADS / 32;
constexpr int K4_NT = 4;           // most n8 tiles (output rows) per warp unit

// A block: th output rows x TW columns x bo channels of one image; the
// filter words stream through shared memory lc at a time (lc = L rounded
// up to 8 where it fits); halo sh x sw pixels at a stride of P words.
struct ConvPlan {
  int th, bo, lc, sh, sw, P, ks;
  size_t smem;
};

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
  VpuConv g;
  if (!vpu_plan(N, Cw, O, fh, fw, stride, Ho, Wo, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  g.H = H; g.W = W; g.Cw = Cw; g.O = O; g.fh = fh; g.fw = fw;
  g.stride = stride; g.ph = ph; g.pw = pw; g.Ho = Ho; g.Wo = Wo;
  g.n_pad = n_pad;
  const long long tiles = static_cast<long long>(g.tiles_h) * g.tiles_w;
  const int o_groups = (O + K3_BO - 1) / K3_BO;
  if (tiles > 0x7fffffffLL || o_groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the Table 2 convs at compile time, the rest through the same kernel
  // with its geometry read at run time
  const bool t2 = fh == 3 && fw == 3 && stride == 1;
  const auto kernel =
      t2 && Cw == 4      ? xnor_conv2d_vpu_kernel<4, 3, 1, 4>
      : t2 && Cw == 8    ? xnor_conv2d_vpu_kernel<8, 3, 1, 4>
      : t2 && Cw == 16   ? xnor_conv2d_vpu_kernel<16, 3, 1, 4>
      : Cw % 4 == 0      ? xnor_conv2d_vpu_kernel<0, 0, 0, 4>
                         : xnor_conv2d_vpu_kernel<0, 0, 0, 1>;
  return repro::launch_cluster(
      kernel, dim3(static_cast<unsigned>(tiles), o_groups, N), dim3(1),
      K3_THREADS, g.smem, stream, a, w, c, flip, out, g);
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
