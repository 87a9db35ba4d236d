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
// Design, both variants: a block computes one th x tw tile of the pair's
//   output. It stages the input words of its halo, (pf*th+fhb+fha-2) x
//   (pf*tw+fwb+fwa-2) x CwA, in shared memory, with zero words outside the
//   image (no padded copy in device memory), computes conv A over the
//   A-output halo (pf*th+fhb-1) x (pf*tw+fwb-1), the positions conv B's
//   tile reads, applies eq. 8 and the halo mask, and re-packs the bits
//   into channel words of a bit map in shared memory. Conv B reads that
//   map, and its epilogue thresholds and pools in registers. Halo
//   positions are recomputed by neighbouring tiles, never stored.
// vpu: one block per (image, tile). Filter rows stream through shared
//   memory 128 at a time at an odd word stride (conflict-free reads, lane =
//   row); each thread keeps PBA / PBB agree-counts in registers per filter
//   word; one __ballot_sync builds a channel word of the map.
// mxu: a thread-block cluster of C blocks per (image, tile), C the largest
//   divisor of OA/32 that is at most 8 (portable; 8 at both Table 2 pairs,
//   so 8x the blocks of one per tile). Rank r computes conv A for OA/C
//   channels over the whole A halo into its own words of the bit map;
//   after a cluster barrier it copies the peers' words from their shared
//   memory (DSMEM), so conv A is never recomputed across the cluster, and
//   computes conv B for its ceil-split share of OB (ragged shares masked).
//   A second, split cluster barrier keeps every map alive until the last
//   peer has read it. Both products run as mma.sync m16n8k32 s8 with
//   filter rows on M and positions on N (conv B's 4 positions at CONV-5/6
//   fill half an n8 tile, not 4 of 64 rows), int32 accumulators (exact at
//   any k). The rank's filter rows, up to MR = 64 per pass (32 or 16 where
//   64 do not fit the block; larger shares stream through in further
//   passes), arrive by one TMA bulk copy per conv counted on an mbarrier
//   (4-byte cp.async where rows are not whole 16-byte units): conv A's at
//   block start, conv B's once conv A's has landed, so it loads while conv
//   A runs (18 + 36 KB at CONV-5/6). A lane unpacks the bits it needs of
//   each packed filter and patch word straight into its +-1 int8 fragments
//   (a shift, an AND and a multiply-add per register): one word is one k32
//   step, with no unpack pass through shared memory and no barrier per
//   step. A warp computes one m16 tile against two n8 tiles where a pass
//   has more than one, sharing the filter fragments; with fewer tiles than
//   warps, K is split across warps and the partial sums meet by
//   shared-memory atomics. What holds it is the integer work of the
//   unpack (the MMAs are a small share) and, per block, the latency of
//   staging and of the two cluster barriers. halo_scratch in
//   kernels/xnor_conv_fused.py mirrors the shared memory and mxu_split the
//   cluster and channel split.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// vpu
constexpr int CHUNK = 128;  // filter rows staged in shared memory per pass
constexpr int PBA = 8;      // conv A positions per thread per pass
constexpr int PBB = 4;      // conv B positions per thread per pass

// mxu
constexpr int MR = 64;          // most filter rows staged per pass
// The mxu kernel's static shared memory: split-K partial sums (one m16n8
// int32 tile per warp: K is split only when a pass has at most WARPS / 2
// units of at most 2 tiles) and the mbarriers of the two filter slices.
struct MxuStatic {
  int red[WARPS * 128];
  uint64_t bar[2];
};
constexpr size_t MXU_STATIC = sizeof(MxuStatic);

struct Geom {
  int H, W, CwA, OA, OB;
  int fha, fwa, fhb, fwb;
  int HO, WO;     // output extent, H / pf and W / pf
  int th, tw;     // output tile
  int tiles_w;
  int npad_a, npad_b;
};

// Per-block tile geometry derived from Geom and the block's tile index.
struct Tile {
  int ha, wa;    // A-output halo extent (positions conv B reads)
  int rx, cx;    // input halo extent (positions conv A reads)
  int oy0, ox0;  // first output pixel of the tile
  int ay0, ax0;  // map coordinates of A-halo position (0, 0)
  int OAw;       // words per A-output pixel
};

template <int PF>
__device__ __forceinline__ Tile make_tile(const Geom& g, int tile) {
  Tile t;
  t.ha = PF * g.th + g.fhb - 1;
  t.wa = PF * g.tw + g.fwb - 1;
  t.rx = t.ha + g.fha - 1;
  t.cx = t.wa + g.fwa - 1;
  t.oy0 = (tile / g.tiles_w) * g.th;
  t.ox0 = (tile % g.tiles_w) * g.tw;
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
  const Tile t = make_tile<PF>(g, blockIdx.x);
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

using repro::cluster_arrive;
using repro::cluster_wait;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait_all;
using repro::smem_u32;

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of bar has completed; trap after
// 60 s (a copy that never lands), which leaves the CUDA context unusable.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > 60000000000ull) {
      __trap();
    }
  }
}

// `bytes` (a multiple of 16) from global to shared memory by the TMA unit,
// counted on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                  "r"(smem_u32(bar))
               : "memory");
}

// Bits 0, 8, 16 and 24 of x as four int8 +1 / -1 (bit 1 = +1) in bytes
// 0..3: one AND and one multiply-add, -(254 m) - 1 = ~(m * 0xFE).
__device__ __forceinline__ uint32_t pm1_bytes(uint32_t x) {
  return (x & 0x01010101u) * 0xFFFFFF02u + 0xFFFFFFFFu;
}

// D = A B + D, m16n8k32, int8 operands, int32 accumulators. Fragments
// (lane = 4 g + t): a[0] row g, a[1] row g + 8, k 4t..4t+3; a[2], a[3] the
// same rows at k 16+4t..; b0 k 4t.., b1 k 16+4t.., column g; acc[0..1] row
// g, columns 2t and 2t + 1; acc[2..3] row g + 8.
__device__ __forceinline__ void mma_s8(int (&acc)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes that stage_rows(.., rows, bulk, bar, ..) will count on bar: thread
// 0 announces them before a block barrier that precedes the copies.
__device__ __forceinline__ void expect_rows(bool bulk, uint64_t* bar,
                                            int rows, int L) {
  if (bulk && threadIdx.x == 0) mbar_expect_tx(bar, rows * L * 4);
}

// Start staging filter rows r0 .. r0+rows-1 of w (O x L words, contiguous)
// into w_s, as they lie. bulk (L % 4 == 0, w 16-byte aligned): thread 0
// issues one TMA bulk copy, counted on bar (expect_rows announced the
// bytes), and the caller waits on bar; else every thread issues 4-byte
// cp.async and commits one group, and the caller waits for that group.
// Rows up to the next multiple of 16 are zeroed by plain stores (a ragged
// m16 tile reads them; its results are dropped).
__device__ __forceinline__ void stage_rows(const int32_t* __restrict__ w,
                                           int L, int r0, int rows, bool bulk,
                                           uint64_t* bar, uint32_t* w_s) {
  const int32_t* src = w + static_cast<size_t>(r0) * L;
  if (bulk) {
    if (threadIdx.x == 0 && rows > 0) bulk_copy(w_s, src, rows * L * 4, bar);
  } else {
    for (int i = threadIdx.x; i < rows * L; i += THREADS)
      cp_async4(w_s + i, src + i);
    cp_async_commit();
  }
  for (int i = rows * L + threadIdx.x; i < (rows + 15) / 16 * 16 * L;
       i += THREADS)
    w_s[i] = 0u;
}

template <int V>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
    w[0] = *p;
  }
}

// NT m16 x n8 tiles side by side over k-units u0 .. u1-1 of V words each
// (V = 4: one 16-byte load per operand and unit): filter rows m0 .. m0+15
// of f_s (L words each) against the patches of 8 NT positions. Lane
// (g, t) gathers the patch of column g of n-tile j, which starts at word
// base[j] of src (a word map with rows of src_w positions of cw_n words;
// fw taps per filter row), and unpacks the filter and patch words straight
// into +-1 fragments: a word is one k32 step, and lane t takes bits t + 8i
// into k 4t + i and bits t + 4 + 8i into k 16 + 4t + i of both operands (a
// permutation of k that leaves the dot product as it is), a shift, an AND
// and a multiply-add per register. The filter fragments serve all NT
// n-tiles. No shared-memory round trip, no barrier.
template <int V, int NT>
__device__ __forceinline__ void mma_tiles(const uint32_t* f_s, int L, int m0,
                                          const uint32_t* src,
                                          const int (&base)[NT], int src_w,
                                          int cw_n, int fw, int u0, int u1,
                                          int (&acc)[NT][4]) {
  const int lane = threadIdx.x % 32, t = lane % 4, t4 = t + 4;
  const uint32_t* r0 = f_s + (m0 + lane / 4) * L + u0 * V;
  const uint32_t* r1 = r0 + 8 * L;
  const int nu = cw_n / V;                           // units per tap
  int cu = u0 % nu, dx = (u0 / nu) % fw;
  int off = ((u0 / nu / fw) * src_w + dx) * cw_n + cu * V;
  for (int u = u0; u < u1; ++u) {
    uint32_t w0[V], w1[V], v[NT][V];
    load_words<V>(r0, w0);
    load_words<V>(r1, w1);
#pragma unroll
    for (int j = 0; j < NT; ++j) load_words<V>(src + base[j] + off, v[j]);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const uint32_t a[4] = {pm1_bytes(w0[i] >> t), pm1_bytes(w1[i] >> t),
                             pm1_bytes(w0[i] >> t4), pm1_bytes(w1[i] >> t4)};
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_s8(acc[j], a, pm1_bytes(v[j][i] >> t), pm1_bytes(v[j][i] >> t4));
    }
    r0 += V;
    r1 += V;
    off += V;
    if (++cu == nu) {                                // next tap
      cu = 0;
      if (++dx == fw) {
        dx = 0;
        off += (src_w - fw) * cw_n;
      }
    }
  }
}

// The m16 x n8 tiles (mt x nt) of one pass over the block's warps, NT
// n-tiles per warp unit, in 16-byte k-units where cw_n and src allow it.
// With fewer units than warps, K is split into ks slices whose partial sums
// meet in red (shared-memory atomics). base(col) gives the patch start of
// column col; epi(mi, nj, acc) receives each tile's whole dot products in
// the accumulator layout of mma_s8, in all 32 lanes.
template <int V, int NT, class Base, class Epi>
__device__ __forceinline__ void run_tiles_v(int mt, int nt, int L,
                                            const uint32_t* f_s,
                                            const uint32_t* src, int src_w,
                                            int cw_n, int fw, Base base,
                                            Epi epi, int* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ng = (nt + NT - 1) / NT, units = mt * ng, ku = L / V;
  const int ks = units >= WARPS ? 1 : min(WARPS / units, ku);
  for (int w = warp; w < units * ks; w += WARPS) {
    const int unit = w % units, s = w / units;
    const int mi = unit % mt, n0 = NT * (unit / mt);
    int acc[NT][4] = {};
    int bases[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) bases[j] = base(8 * (n0 + j) + lane / 4);
    mma_tiles<V, NT>(f_s, L, 16 * mi, src, bases, src_w, cw_n, fw,
                     ku * s / ks, ku * (s + 1) / ks, acc);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (ks == 1) {
        if (n0 + j < nt) epi(mi, n0 + j, acc[j]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          atomicAdd(&red[(unit * NT + j) * 128 + lane * 4 + i], acc[j][i]);
      }
    }
  }
  if (ks > 1) {
    __syncthreads();
    for (int tile = warp; tile < units * NT; tile += WARPS) {
      int acc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i] = red[tile * 128 + lane * 4 + i];
        red[tile * 128 + lane * 4 + i] = 0;        // clean for the next pass
      }
      const int unit = tile / NT, nj = NT * (unit / mt) + tile % NT;
      if (nj < nt) epi(unit % mt, nj, acc);
    }
  }
}

template <class Base, class Epi>
__device__ __forceinline__ void run_tiles(int mt, int nt, int L,
                                          const uint32_t* f_s,
                                          const uint32_t* src, int src_w,
                                          int cw_n, int fw, Base base, Epi epi,
                                          int* red) {
  const bool vec =
      cw_n % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec && nt > 1)
    run_tiles_v<4, 2>(mt, nt, L, f_s, src, src_w, cw_n, fw, base, epi, red);
  else if (vec)
    run_tiles_v<4, 1>(mt, nt, L, f_s, src, src_w, cw_n, fw, base, epi, red);
  else
    run_tiles_v<1, 1>(mt, nt, L, f_s, src, src_w, cw_n, fw, base, epi, red);
}

// Cluster rank r of csize blocks per (image, tile): conv A for OA channels
// [r OA/csize, (r+1) OA/csize) over the whole A halo into its words of the
// bit map; after a cluster barrier it copies the peers' words from their
// shared memory (DSMEM), then conv B for OB channels [ceil(r OB/csize),
// ceil((r+1) OB/csize)). mr: filter rows per pass; bulk: stage the filters
// by TMA bulk copies (see stage_rows).
template <int PF>
__global__ void __launch_bounds__(THREADS, 4)
pair_mxu_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ wa,
                const float* __restrict__ ca, const uint8_t* __restrict__ fa,
                const int32_t* __restrict__ wb, const float* __restrict__ cb,
                const uint8_t* __restrict__ fb, int8_t* __restrict__ out,
                Geom g, int csize, int mr, int bulk) {
  extern __shared__ __align__(16) uint32_t smem_mxu[];
  __shared__ MxuStatic st;
  int* red = st.red;
  uint64_t* bar = st.bar;                            // filters of A, of B
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const Tile t = make_tile<PF>(g, blockIdx.x / csize);
  const int n = blockIdx.y;
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int oa_per = g.OA / csize, oa0 = rank * oa_per;
  const int ob0 = (rank * g.OB + csize - 1) / csize;
  const int ob1 = ((rank + 1) * g.OB + csize - 1) / csize;
  const int LA = g.fha * g.fwa * g.CwA, LB = g.fhb * g.fwb * t.OAw;
  constexpr int PP = PF * PF;
  const int PA = t.ha * t.wa, Q = g.th * g.tw, RB = Q * PP;
  const int ra = min(mr, oa_per), rb = min(mr, ob1 - ob0);
  uint32_t* fa_s = smem_mxu;                          // [ra][LA]
  uint32_t* fb_s = fa_s + ra * LA;                    // [mr][LB]
  uint32_t* x_s = fb_s + mr * LB;                     // [rx][cx][CwA]
  uint32_t* a_s = x_s + t.rx * t.cx * g.CwA;          // [ha][wa][OAw]
  uint16_t* a16 = reinterpret_cast<uint16_t*>(a_s);   // half-words, LSB first
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  expect_rows(bulk, &bar[0], ra, LA);
  __syncthreads();
  // conv A's filter slice in flight while the input halo is staged; conv
  // B's follows once A's has landed, and loads while conv A runs
  stage_rows(wa, LA, oa0, ra, bulk, &bar[0], fa_s);
  stage_input(a, g, t, n, x_s);
  for (int i = threadIdx.x; i < WARPS * 128; i += THREADS) red[i] = 0;
  uint32_t parity[2] = {0, 0};
  auto wait_rows = [&](int i) {
    if (bulk) {
      mbar_wait(&bar[i], parity[i]);
      parity[i] ^= 1;
    } else {
      cp_async_wait_all();
    }
  };

  // conv A: rows = this rank's OA channels, columns = A-halo positions
  const int kpa = LA * 32;
  auto base_a = [&](int p) {
    p = p < PA ? p : 0;
    return ((p / t.wa) * t.cx + p % t.wa) * g.CwA;
  };
  for (int r0 = 0; r0 < oa_per; r0 += mr) {
    const int rows = min(mr, oa_per - r0);
    if (r0 > 0) {
      expect_rows(bulk, &bar[0], rows, LA);
      __syncthreads();                               // fa_s free
      stage_rows(wa, LA, oa0 + r0, rows, bulk, &bar[0], fa_s);
    }
    wait_rows(0);
    if (r0 == 0) expect_rows(bulk, &bar[1], rb, LB);
    __syncthreads();
    if (r0 == 0) stage_rows(wb, LB, ob0, rb, bulk, &bar[1], fb_s);
    const int ch0 = oa0 + r0;
    // eq. 8 and the halo mask per bit; the 16 bits of a position in one
    // m16 tile are OR-reduced over the 8 lanes that hold them and stored
    // as one half-word of the bit map
    auto epi_a = [&](int mi, int nj, const int (&acc)[4]) {
      const int o = ch0 + 16 * mi + gq;
      const float c0 = ca[o], c1 = ca[o + 8];
      const bool f0 = fa[o] != 0, f1 = fa[o + 8] != 0;
      unsigned h[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = 8 * nj + 2 * tq + j;
        const bool live = p < PA && in_map(g, t, p / t.wa, p % t.wa);
        const bool b0 =
            live && nb_bit((kpa + acc[j]) / 2 - g.npad_a, c0, f0);
        const bool b1 =
            live && nb_bit((kpa + acc[2 + j]) / 2 - g.npad_a, c1, f1);
        h[j] = (static_cast<unsigned>(b0) << gq) |
               (static_cast<unsigned>(b1) << (gq + 8));
        h[j] |= __shfl_xor_sync(FULL, h[j], 4);
        h[j] |= __shfl_xor_sync(FULL, h[j], 8);
        h[j] |= __shfl_xor_sync(FULL, h[j], 16);
      }
      if (gq == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = 8 * nj + 2 * tq + j;
          if (p < PA)
            a16[p * 2 * t.OAw + (ch0 + 16 * mi) / 16] =
                static_cast<uint16_t>(h[j]);
        }
      }
    };
    run_tiles(rows / 16, (PA + 7) / 8, LA, fa_s, x_s, t.cx, g.CwA,
              g.fwa, base_a, epi_a, red);
  }

  // share the bit map: every rank's words, read from its shared memory
  cluster.sync();
  const int own = t.OAw / csize, span = PA * own;    // words per rank
  for (int i = threadIdx.x; i < (csize - 1) * span; i += THREADS) {
    const int peer = (rank + 1 + i / span) % csize, j = i % span;
    const int w = (j / own) * t.OAw + peer * own + j % own;
    a_s[w] = cluster.map_shared_rank(a_s, peer)[w];
  }
  wait_rows(1);                                      // wb's first rows
  __syncthreads();
  cluster_arrive();

  // conv B: rows = this rank's OB channels, columns = B positions ordered
  // (pooled output q, window slot s), so a 2x2 window is 4 adjacent columns
  const int kpb = LB * 32;
  auto base_b = [&](int rr) {
    rr = rr < RB ? rr : 0;
    const int q = rr / PP, s = rr % PP;
    return (((q / g.tw) * PF + s / PF) * t.wa + (q % g.tw) * PF + s % PF) *
           t.OAw;
  };
  auto store = [&](int q, int o, bool bit) {
    const int oy = t.oy0 + q / g.tw, ox = t.ox0 + q % g.tw;
    if (o < ob1 && q < Q && oy < g.HO && ox < g.WO)
      out[((static_cast<size_t>(n) * g.HO + oy) * g.WO + ox) * g.OB + o] =
          static_cast<int8_t>(bit);
  };
  for (int r0 = ob0; r0 < ob1; r0 += mr) {
    const int rows = min(mr, ob1 - r0);
    if (r0 > ob0) {
      expect_rows(bulk, &bar[1], rows, LB);
      __syncthreads();                               // fb_s free
      stage_rows(wb, LB, r0, rows, bulk, &bar[1], fb_s);
      wait_rows(1);
      __syncthreads();
    }
    auto epi_b = [&](int mi, int nj, const int (&acc)[4]) {
      const int o = r0 + 16 * mi + gq;
      const bool v0 = o < ob1, v1 = o + 8 < ob1;
      const float c0 = v0 ? cb[o] : 0.f, c1 = v1 ? cb[o + 8] : 0.f;
      const bool f0 = v0 && fb[o] != 0, f1 = v1 && fb[o + 8] != 0;
      const int col = 8 * nj + 2 * tq;
      bool b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        b[0][j] = nb_bit((kpb + acc[j]) / 2 - g.npad_b, c0, f0);
        b[1][j] = nb_bit((kpb + acc[2 + j]) / 2 - g.npad_b, c1, f1);
      }
      if (PF == 2) {
        // this lane holds slots 0-1 or 2-3 of window col / 4, lane ^ 1
        // the others: any (max) where flip is 0, all (min) where it is 1
        const unsigned m = (b[0][0] | b[0][1]) | (b[0][0] & b[0][1]) << 1 |
                           (b[1][0] | b[1][1]) << 2 |
                           (b[1][0] & b[1][1]) << 3;
        const unsigned other = __shfl_xor_sync(FULL, m, 1);
        const unsigned any = m | other, all = m & other;
        if ((tq & 1) == 0) {
          store(col / 4, o, f0 ? (all >> 1) & 1 : any & 1);
          store(col / 4, o + 8, f1 ? (all >> 3) & 1 : (any >> 2) & 1);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          store(col + j, o, b[0][j]);
          store(col + j, o + 8, b[1][j]);
        }
      }
    };
    run_tiles((rows + 15) / 16, (RB + 7) / 8, LB, fb_s, a_s, t.wa,
              t.OAw, g.fwb, base_b, epi_b, red);
  }
  cluster_wait();
}

// Shared-memory words of a block's input halo and A bit map; mirrored by
// src/repro_torch/kernels/xnor_conv_fused.py::halo_scratch.
size_t map_words(const Geom& g, int pf) {
  const size_t ha = pf * g.th + g.fhb - 1, wa = pf * g.tw + g.fwb - 1;
  return (ha + g.fha - 1) * (wa + g.fwa - 1) * g.CwA + ha * wa * (g.OA / 32);
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Geom& g, int N, const void* a,
           const void* wa, const void* ca, const void* fa, const void* wb,
           const void* cb, const void* fb, void* out, void* stream) {
  if (smem > 48 * 1024) {
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

// Largest divisor of OA/32 that is at most MAX_CLUSTER: the mxu cluster
// size (kernels/xnor_conv_fused.py::mxu_split mirrors it).
int cluster_size(int OA) {
  int c = repro::MAX_CLUSTER;
  while ((OA / 32) % c) --c;
  return c;
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
      ? launch(pair_vpu_kernel<2>, smem, g, N, a, wa, ca, fa, wb, cb, fb, out,
               stream)
      : launch(pair_vpu_kernel<1>, smem, g, N, a, wa, ca, fa, wb, cb, fb, out,
               stream);
}

int xnor_conv2d_pair_mxu(const void* a, const void* wa, const void* ca,
                         const void* fa, const void* wb, const void* cb,
                         const void* fb, void* out, int N, int H, int W,
                         int CwA, int OA, int OB, int fha, int fwa, int fhb,
                         int fwb, int pf, int th, int tw, int npad_a,
                         int npad_b, void* stream) {
  const Geom g = make_geom(H, W, CwA, OA, OB, fha, fwa, fhb, fwb, pf, th, tw,
                           npad_a, npad_b);
  const int csize = cluster_size(OA);
  const int LA = fha * fwa * CwA, LB = fhb * fwb * (OA / 32);
  // filter rows per pass: MR, halved (to 16 at least) until the block fits
  int mr = MR;
  size_t smem = 0;
  for (;; mr /= 2) {
    const int ra = OA / csize < mr ? OA / csize : mr;
    smem = (map_words(g, pf) + static_cast<size_t>(ra) * LA +
            static_cast<size_t>(mr) * LB) * sizeof(uint32_t);
    if (mr == 16 || smem + MXU_STATIC <= repro::SMEM_LIMIT) break;
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int bulk = LA % 4 == 0 && LB % 4 == 0 && aligned(wa) && aligned(wb);
  const dim3 grid((g.HO + th - 1) / th * g.tiles_w * csize, N);
  return repro::launch_cluster(
      pf == 2 ? pair_mxu_kernel<2> : pair_mxu_kernel<1>, grid, dim3(csize),
      THREADS, smem, stream, a, wa, ca, fa, wb, cb, fb, out, g, csize, mr,
      bulk);
}

}  // extern "C"
