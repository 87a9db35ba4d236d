// Fused pair of binary 2-D convolutions for Hopper (sm_90a): kernel K5,
// variants vpu and mxu.
//
// Contract, shared by both variants (src/repro_torch/kernels/ref.py::
// xnor_conv2d_pair_ref is the plain version):
//   a  (N, H, W, CwA) int32 channel-packed NHWC input bits (unpadded),
//   wa (OA, LA) int32 per-position packed A filters, LA = fha*fwa*CwA,
//   wb (OB, LB) int32 per-position packed B filters, LB = fhb*fwb*OA/32,
//   ca/fa (OA,), cb/fb (OB,): eq. 8 thresholds (float32) and flips (bool),
//   out (N, H/pf, W/pf, OB) int8 bits:
//     bits_A = (convA(a) >= ca) XOR fa      (stride 1, SAME, odd filters)
//     bits_B = (convB(bits_A) >= cb) XOR fb
//     out    = bits_B, or its 2x2 pool when pf == 2: max where fb == 0,
//              min where fb == 1 (pooling commutes with the monotone
//              threshold).
//   Input words outside the image are zero words (all bits -1); so are
//   A-output positions outside the map when conv B reads them (the halo
//   mask), which is the SAME padding of an unfused conv B.
//   OA % 32 == 0 (the A bits are re-packed into OA/32 words per pixel,
//   LSB-first, the bitpack.pack_bits order). Ragged tile grids (H/pf not a
//   multiple of th) and ragged OB are masked inside the kernels.
//
// Replaces src/repro/kernels/xnor_conv_fused.py::xnor_conv2d_pair_vpu and
//   ::xnor_conv2d_pair_mxu (_fused_pair_kernel, _conv_counts, _gather_span).
//   Bound on the H100: the __popc issue rate (vpu) or the int8 tensor-core
//   rate (mxu) over the bit-MACs of both convs; the pair reads its packed
//   input and filters once and writes only the final bits, so bytes are
//   small. What the fusion saves is the A-output bit map's round trip
//   through device memory, its pack_bits pass and one launch.
//
// Design: one block per (image, th x tw tile of the pair's output). The
//   block stages the input words of its halo, (pf*th+fhb+fha-2) x
//   (pf*tw+fwb+fwa-2) x CwA, in shared memory, with zero words outside the
//   image (no padded copy in device memory). It computes conv A over the
//   A-output halo (pf*th+fhb-1) x (pf*tw+fwb-1), the positions conv B's tile
//   reads, applies eq. 8 and the halo mask, and re-packs the bits into
//   words in shared memory: lane = channel, so one __ballot_sync builds a
//   channel word. Conv B then reads that bit map from shared memory, and
//   its epilogue thresholds and pools in registers. Halo positions are
//   recomputed by neighbouring blocks (recompute-at-consumer), never
//   stored. The filters of CONV-5/6 (147 KB for A, 295 KB for B) do not fit
//   in one block's 227 KB, so they stream through in output-channel chunks:
//   vpu stages 128 filter rows at a time in shared memory at an odd word
//   stride (conflict-free reads, lane = row); mxu reads 32 rows x 4 words
//   per k-step from global memory (L2) and unpacks them, as K4 does.
//   vpu: each thread keeps PB agree-counts in registers per filter word.
//   mxu: 64 patch rows (gathered from shared memory) x 32 channels per
//   chunk, +1/-1 int8 in 16-element k-slabs, 8 warps of nvcuda::wmma
//   16x16x16 int8 MMAs with int32 accumulators (exact at any k).
//   The grid has only N x tiles blocks (4-256 at batch 4 on the Table 2
//   pairs, by tile); a thread-block-cluster design that splits OA/OB across
//   blocks and shares the A bit map through distributed shared memory is
//   the next step (ROADMAP, K5 perf item).
#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

#include "bits.cuh"

namespace {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// vpu
constexpr int CHUNK = 128;  // filter rows staged in shared memory per pass
constexpr int PBA = 8;      // conv A positions per thread per pass
constexpr int PBB = 4;      // conv B positions per thread per pass

// mxu
constexpr int KC = 4;         // patch words per k-step (128 k)
constexpr int SLABS = 2 * KC; // 16-element k-slabs per step
constexpr int MROWS = 64;     // patch rows per chunk (4 warps x 16)
constexpr int NCOLS = 32;     // channels per chunk (2 warps x 16)

struct Geom {
  int H, W, CwA, OA, OB;
  int fha, fwa, fhb, fwb;
  int HO, WO;     // output extent, H / pf and W / pf
  int th, tw;     // output tile
  int tiles_w;
  int npad_a, npad_b;
};

// Per-block tile geometry derived from Geom and blockIdx.
struct Tile {
  int ha, wa;    // A-output halo extent (positions conv B reads)
  int rx, cx;    // input halo extent (positions conv A reads)
  int oy0, ox0;  // first output pixel of the tile
  int ay0, ax0;  // map coordinates of A-halo position (0, 0)
  int OAw;       // words per A-output pixel
};

template <int PF>
__device__ __forceinline__ Tile make_tile(const Geom& g) {
  Tile t;
  t.ha = PF * g.th + g.fhb - 1;
  t.wa = PF * g.tw + g.fwb - 1;
  t.rx = t.ha + g.fha - 1;
  t.cx = t.wa + g.fwa - 1;
  t.oy0 = (blockIdx.x / g.tiles_w) * g.th;
  t.ox0 = (blockIdx.x % g.tiles_w) * g.tw;
  t.ay0 = t.oy0 * PF - g.fhb / 2;
  t.ax0 = t.ox0 * PF - g.fwb / 2;
  t.OAw = g.OA / 32;
  return t;
}

// Stage the block's input halo: x_s[y][x][cw], zero words outside the image.
__device__ __forceinline__ void stage_input(const int32_t* __restrict__ a,
                                            const Geom& g, const Tile& t,
                                            int n, uint32_t* x_s) {
  const int iy0 = t.ay0 - g.fha / 2, ix0 = t.ax0 - g.fwa / 2;
  for (int i = threadIdx.x; i < t.rx * t.cx * g.CwA; i += THREADS) {
    const int cw = i % g.CwA, x = (i / g.CwA) % t.cx, y = i / (g.CwA * t.cx);
    const int iy = iy0 + y, ix = ix0 + x;
    x_s[i] = (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
        ? static_cast<uint32_t>(
              a[((static_cast<size_t>(n) * g.H + iy) * g.W + ix) * g.CwA + cw])
        : 0u;
  }
}

// Is A-halo position (ay, ax) inside the real A-output map?
__device__ __forceinline__ bool in_map(const Geom& g, const Tile& t, int ay,
                                       int ax) {
  const int gy = t.ay0 + ay, gx = t.ax0 + ax;
  return gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
}

// Eq. 8 on one agree-count.
__device__ __forceinline__ bool nb_bit(int y, float c, bool flip) {
  return (static_cast<float>(y) >= c) != flip;
}

// Stage filter rows o0 .. o0+rows-1 of w (O x L) at word stride ls; rows up
// to the next multiple of 32 are zero-filled (masked lanes read them).
__device__ __forceinline__ void stage_filters(const int32_t* __restrict__ w,
                                              int O, int L, int ls, int o0,
                                              int rows32, uint32_t* w_s) {
  for (int i = threadIdx.x; i < rows32 * L; i += THREADS) {
    const int r = i / L, l = i % L;
    w_s[r * ls + l] = (o0 + r < O)
        ? static_cast<uint32_t>(w[static_cast<size_t>(o0 + r) * L + l])
        : 0u;
  }
}

// ---------------------------------------------------------------- vpu ----

template <int PF>
__global__ void __launch_bounds__(THREADS)
pair_vpu_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ wa,
                const float* __restrict__ ca, const uint8_t* __restrict__ fa,
                const int32_t* __restrict__ wb, const float* __restrict__ cb,
                const uint8_t* __restrict__ fb, int8_t* __restrict__ out,
                Geom g) {
  extern __shared__ uint32_t smem[];
  const Tile t = make_tile<PF>(g);
  const int n = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* x_s = smem;                              // [rx][cx][CwA]
  uint32_t* a_s = x_s + t.rx * t.cx * g.CwA;         // [ha][wa][OAw]
  uint32_t* w_s = a_s + t.ha * t.wa * t.OAw;         // [CHUNK][L | 1]
  stage_input(a, g, t, n, x_s);

  // conv A over the A-output halo -> eq. 8 -> halo mask -> packed words
  const int LA = g.fha * g.fwa * g.CwA, lsa = LA | 1;
  const int PA = t.ha * t.wa;
  for (int o0 = 0; o0 < g.OA; o0 += CHUNK) {
    const int rows = min(CHUNK, g.OA - o0);          // a multiple of 32
    __syncthreads();                                 // w_s free, x_s ready
    stage_filters(wa, g.OA, LA, lsa, o0, rows, w_s);
    __syncthreads();
    const int groups = rows / 32, batches = (PA + PBA - 1) / PBA;
    for (int it = warp; it < groups * batches; it += WARPS) {
      const int grp = it % groups, p0 = (it / groups) * PBA;
      int base[PBA], acc[PBA];
#pragma unroll
      for (int j = 0; j < PBA; ++j) {
        const int p = p0 + j < PA ? p0 + j : 0;
        base[j] = ((p / t.wa) * t.cx + p % t.wa) * g.CwA;
        acc[j] = 0;
      }
      const uint32_t* wrow = w_s + (grp * 32 + lane) * lsa;
      for (int dy = 0; dy < g.fha; ++dy)
        for (int dx = 0; dx < g.fwa; ++dx) {
          const uint32_t* xpos = x_s + (dy * t.cx + dx) * g.CwA;
          const uint32_t* wpos = wrow + (dy * g.fwa + dx) * g.CwA;
          for (int cw = 0; cw < g.CwA; ++cw) {
            const uint32_t wv = wpos[cw];
#pragma unroll
            for (int j = 0; j < PBA; ++j)
              acc[j] += __popc(~(xpos[base[j] + cw] ^ wv));
          }
        }
      const int o = o0 + grp * 32 + lane;
      const float c = ca[o];
      const bool flip = fa[o] != 0;
#pragma unroll
      for (int j = 0; j < PBA; ++j) {
        const int p = p0 + j;                        // uniform in the warp
        if (p < PA) {
          const bool bit = in_map(g, t, p / t.wa, p % t.wa) &&
                           nb_bit(acc[j] - g.npad_a, c, flip);
          const unsigned word = __ballot_sync(FULL, bit);
          if (lane == 0) a_s[p * t.OAw + o0 / 32 + grp] = word;
        }
      }
    }
  }

  // conv B over the tile's (pooled) outputs, reading the bit map in a_s
  constexpr int QB = PBB / (PF * PF);                // pooled outputs / pass
  const int LB = g.fhb * g.fwb * t.OAw, lsb = LB | 1;
  const int Q = g.th * g.tw;
  for (int o0 = 0; o0 < g.OB; o0 += CHUNK) {
    const int rows32 = (min(CHUNK, g.OB - o0) + 31) / 32 * 32;
    __syncthreads();                                 // a_s complete, w_s free
    stage_filters(wb, g.OB, LB, lsb, o0, rows32, w_s);
    __syncthreads();
    const int groups = rows32 / 32, batches = (Q + QB - 1) / QB;
    for (int it = warp; it < groups * batches; it += WARPS) {
      const int grp = it % groups, q0 = (it / groups) * QB;
      int base[PBB], acc[PBB];
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) {
        const int q = q0 + qi < Q ? q0 + qi : 0;
        const int qy = q / g.tw, qx = q % g.tw;
#pragma unroll
        for (int s = 0; s < PF * PF; ++s) {
          const int by = qy * PF + s / PF, bx = qx * PF + s % PF;
          base[qi * PF * PF + s] = (by * t.wa + bx) * t.OAw;
          acc[qi * PF * PF + s] = 0;
        }
      }
      const uint32_t* wrow = w_s + (grp * 32 + lane) * lsb;
      for (int dy = 0; dy < g.fhb; ++dy)
        for (int dx = 0; dx < g.fwb; ++dx) {
          const uint32_t* apos = a_s + (dy * t.wa + dx) * t.OAw;
          const uint32_t* wpos = wrow + (dy * g.fwb + dx) * t.OAw;
          for (int cw = 0; cw < t.OAw; ++cw) {
            const uint32_t wv = wpos[cw];
#pragma unroll
            for (int j = 0; j < PBB; ++j)
              acc[j] += __popc(~(apos[base[j] + cw] ^ wv));
          }
        }
      const int o = o0 + grp * 32 + lane;
      if (o >= g.OB) continue;
      const float c = cb[o];
      const bool flip = fb[o] != 0;
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) {
        const int q = q0 + qi;
        const int oy = t.oy0 + q / g.tw, ox = t.ox0 + q % g.tw;
        if (q >= Q || oy >= g.HO || ox >= g.WO) continue;
        bool any = false, all = true;
#pragma unroll
        for (int s = 0; s < PF * PF; ++s) {
          const bool bit = nb_bit(acc[qi * PF * PF + s] - g.npad_b, c, flip);
          any |= bit;
          all &= bit;
        }
        out[((static_cast<size_t>(n) * g.HO + oy) * g.WO + ox) * g.OB + o] =
            static_cast<int8_t>(flip ? all : any);
      }
    }
  }
}

// ---------------------------------------------------------------- mxu ----

struct __align__(128) MmaSmem {
  int8_t a[SLABS][MROWS][16];
  int8_t w[SLABS][NCOLS][16];
  int32_t c[WARPS][16][16];
};

// One (MROWS patch rows) x (NCOLS filter rows o0..) chunk of a conv as an
// implicit +-1 int8 matrix product, left in sm.c[warp] (16 x 16 int32 dot
// products per warp: rows 16 * (warp / 2), channels 16 * (warp % 2)).
// Thread tid gathers patch row tid / KC, whose reception field starts at
// word `base` of `src` (a [..][src_w][Cw] word map in shared memory), or
// -1 for a masked row; a masked row and words past L unpack to 0 and add
// nothing to the dot.
__device__ __forceinline__ void mma_chunk(const uint32_t* src, int base,
                                          int src_w, int Cw, int fw,
                                          const int32_t* __restrict__ w,
                                          int O, int o0, int L, MmaSmem& sm) {
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int p = tid / KC, kk = tid % KC;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
  wmma::fill_fragment(acc, 0);
  for (int l0 = 0; l0 < L; l0 += KC) {
    {
      const int l = l0 + kk;
      const bool valid = l < L && base >= 0;
      uint32_t v = 0u;
      if (valid) {
        const int cw = l % Cw, dx = (l / Cw) % fw, dy = l / (Cw * fw);
        v = src[base + (dy * src_w + dx) * Cw + cw];
      }
      repro::unpack_pm1_16(v, valid, &sm.a[2 * kk][p][0]);
      repro::unpack_pm1_16(v >> 16, valid, &sm.a[2 * kk + 1][p][0]);
    }
    if (tid < NCOLS * KC) {
      const int r = tid / KC, k2 = tid % KC, l = l0 + k2;
      const bool valid = l < L && o0 + r < O;
      const uint32_t v = valid
          ? static_cast<uint32_t>(w[static_cast<size_t>(o0 + r) * L + l])
          : 0u;
      repro::unpack_pm1_16(v, valid, &sm.w[2 * k2][r][0]);
      repro::unpack_pm1_16(v >> 16, valid, &sm.w[2 * k2 + 1][r][0]);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < SLABS; ++s) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, &sm.a[s][wm * 16][0], 16);
      wmma::load_matrix_sync(fb, &sm.w[s][wn * 16][0], 16);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(&sm.c[warp][0][0], acc, 16, wmma::mem_row_major);
  __syncthreads();
}

// Dot product of chunk row r with chunk channel cc, from sm.c.
__device__ __forceinline__ int chunk_dot(const MmaSmem& sm, int r, int cc) {
  return sm.c[(r / 16) * 2 + cc / 16][r % 16][cc % 16];
}

template <int PF>
__global__ void __launch_bounds__(THREADS)
pair_mxu_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ wa,
                const float* __restrict__ ca, const uint8_t* __restrict__ fa,
                const int32_t* __restrict__ wb, const float* __restrict__ cb,
                const uint8_t* __restrict__ fb, int8_t* __restrict__ out,
                Geom g) {
  extern __shared__ uint32_t smem[];
  __shared__ MmaSmem sm;
  const Tile t = make_tile<PF>(g);
  const int n = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  uint32_t* x_s = smem;                              // [rx][cx][CwA]
  uint32_t* a_s = x_s + t.rx * t.cx * g.CwA;         // [ha][wa][OAw]
  stage_input(a, g, t, n, x_s);
  __syncthreads();

  // conv A: rows = A-halo positions, 64 at a time; columns = OA, 32 at a
  // time (one packed word of the bit map per position and chunk)
  const int LA = g.fha * g.fwa * g.CwA, kpa = LA * 32;
  const int PA = t.ha * t.wa;
  for (int pc0 = 0; pc0 < PA; pc0 += MROWS) {
    const int p = pc0 + tid / KC;
    const int base = p < PA ? ((p / t.wa) * t.cx + p % t.wa) * g.CwA : -1;
    for (int o0 = 0; o0 < g.OA; o0 += NCOLS) {
      mma_chunk(x_s, base, t.cx, g.CwA, g.fwa, wa, g.OA, o0, LA, sm);
      const int o = o0 + lane;
      const float c = ca[o];
      const bool flip = fa[o] != 0;
      for (int r = warp; r < MROWS; r += WARPS) {
        const int pp = pc0 + r;                      // uniform in the warp
        if (pp < PA) {
          const int y = (kpa + chunk_dot(sm, r, lane)) / 2 - g.npad_a;
          const bool bit = in_map(g, t, pp / t.wa, pp % t.wa) &&
                           nb_bit(y, c, flip);
          const unsigned word = __ballot_sync(FULL, bit);
          if (lane == 0) a_s[pp * t.OAw + o0 / 32] = word;
        }
      }
      __syncthreads();                               // sm.c free again
    }
  }

  // conv B: rows = B positions ordered (pooled output q, window slot s),
  // so each 64-row chunk holds whole 2x2 windows; columns = OB, 32 at a time
  const int LB = g.fhb * g.fwb * t.OAw, kpb = LB * 32;
  const int Q = g.th * g.tw, RB = Q * PF * PF;
  for (int rc0 = 0; rc0 < RB; rc0 += MROWS) {
    const int rr = rc0 + tid / KC;
    int base = -1;
    if (rr < RB) {
      const int q = rr / (PF * PF), s = rr % (PF * PF);
      const int by = (q / g.tw) * PF + s / PF, bx = (q % g.tw) * PF + s % PF;
      base = (by * t.wa + bx) * t.OAw;
    }
    for (int o0 = 0; o0 < g.OB; o0 += NCOLS) {
      mma_chunk(a_s, base, t.wa, t.OAw, g.fwb, wb, g.OB, o0, LB, sm);
      for (int e = tid; e < (MROWS / (PF * PF)) * NCOLS; e += THREADS) {
        const int qi = e / NCOLS, cc = e % NCOLS;
        const int q = rc0 / (PF * PF) + qi, o = o0 + cc;
        const int oy = t.oy0 + q / g.tw, ox = t.ox0 + q % g.tw;
        if (q >= Q || o >= g.OB || oy >= g.HO || ox >= g.WO) continue;
        const float c = cb[o];
        const bool flip = fb[o] != 0;
        bool any = false, all = true;
#pragma unroll
        for (int s = 0; s < PF * PF; ++s) {
          const int y = (kpb + chunk_dot(sm, qi * PF * PF + s, cc)) / 2 -
                        g.npad_b;
          const bool bit = nb_bit(y, c, flip);
          any |= bit;
          all &= bit;
        }
        out[((static_cast<size_t>(n) * g.HO + oy) * g.WO + ox) * g.OB + o] =
            static_cast<int8_t>(flip ? all : any);
      }
      __syncthreads();                               // sm.c free again
    }
  }
}

// Shared-memory words of a block's input halo and A bit map; mirrored by
// src/repro_torch/kernels/xnor_conv_fused.py::halo_scratch.
size_t map_words(const Geom& g, int pf) {
  const size_t ha = pf * g.th + g.fhb - 1, wa = pf * g.tw + g.fwb - 1;
  return (ha + g.fha - 1) * (wa + g.fwa - 1) * g.CwA + ha * wa * (g.OA / 32);
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, size_t static_smem, const Geom& g,
           int N, const void* a, const void* wa, const void* ca,
           const void* fa, const void* wb, const void* cb, const void* fb,
           void* out, void* stream) {
  if (smem + static_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles_h = (g.HO + g.th - 1) / g.th;
  const dim3 grid(tiles_h * g.tiles_w, N);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(wa),
      static_cast<const float*>(ca), static_cast<const uint8_t*>(fa),
      static_cast<const int32_t*>(wb), static_cast<const float*>(cb),
      static_cast<const uint8_t*>(fb), static_cast<int8_t*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

Geom make_geom(int H, int W, int CwA, int OA, int OB, int fha, int fwa,
               int fhb, int fwb, int pf, int th, int tw, int npad_a,
               int npad_b) {
  Geom g;
  g.H = H; g.W = W; g.CwA = CwA; g.OA = OA; g.OB = OB;
  g.fha = fha; g.fwa = fwa; g.fhb = fhb; g.fwb = fwb;
  g.HO = H / pf; g.WO = W / pf; g.th = th; g.tw = tw;
  g.tiles_w = (g.WO + tw - 1) / tw;
  g.npad_a = npad_a; g.npad_b = npad_b;
  return g;
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success). pf is 2 (pooled output) or 1.
int xnor_conv2d_pair_vpu(const void* a, const void* wa, const void* ca,
                         const void* fa, const void* wb, const void* cb,
                         const void* fb, void* out, int N, int H, int W,
                         int CwA, int OA, int OB, int fha, int fwa, int fhb,
                         int fwb, int pf, int th, int tw, int npad_a,
                         int npad_b, void* stream) {
  const Geom g = make_geom(H, W, CwA, OA, OB, fha, fwa, fhb, fwb, pf, th, tw,
                           npad_a, npad_b);
  const int LA = fha * fwa * CwA, LB = fhb * fwb * (OA / 32);
  const size_t smem =
      (map_words(g, pf) + static_cast<size_t>(CHUNK) * ((LA > LB ? LA : LB) | 1)) *
      sizeof(uint32_t);
  return pf == 2
      ? launch(pair_vpu_kernel<2>, smem, 0, g, N, a, wa, ca, fa, wb, cb, fb,
               out, stream)
      : launch(pair_vpu_kernel<1>, smem, 0, g, N, a, wa, ca, fa, wb, cb, fb,
               out, stream);
}

int xnor_conv2d_pair_mxu(const void* a, const void* wa, const void* ca,
                         const void* fa, const void* wb, const void* cb,
                         const void* fb, void* out, int N, int H, int W,
                         int CwA, int OA, int OB, int fha, int fwa, int fhb,
                         int fwb, int pf, int th, int tw, int npad_a,
                         int npad_b, void* stream) {
  const Geom g = make_geom(H, W, CwA, OA, OB, fha, fwa, fhb, fwb, pf, th, tw,
                           npad_a, npad_b);
  const size_t smem = map_words(g, pf) * sizeof(uint32_t);
  return pf == 2
      ? launch(pair_mxu_kernel<2>, smem, sizeof(MmaSmem), g, N, a, wa, ca,
               fa, wb, cb, fb, out, stream)
      : launch(pair_mxu_kernel<1>, smem, sizeof(MmaSmem), g, N, a, wa, ca,
               fa, wb, cb, fb, out, stream);
}

}  // extern "C"
