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
// Design, both variants: a thread-block cluster of C blocks per (image,
//   th x tw output tile), C the largest divisor of OA/32 that is at most 8
//   (portable; 8 at both Table 2 pairs, so 8x the blocks of one per tile:
//   1,024 and 512 at batch 4). Each block stages the input words of the
//   halo, (pf*th+fhb+fha-2) x (pf*tw+fwb+fwa-2) x CwA, in shared memory,
//   with zero words outside the image (no padded copy in device memory).
//   Rank r computes conv A for its OA/C channels over the whole A-output
//   halo (pf*th+fhb-1) x (pf*tw+fwb-1), the positions conv B's tile reads,
//   applies eq. 8 and the halo mask, and packs the bits into its channel
//   words of the bit map; the ranks share the map through distributed
//   shared memory (DSMEM), so conv A is never recomputed across the
//   cluster. Rank r then computes conv B for its ceil-split share of OB
//   (ragged shares masked), and its epilogue thresholds and pools in
//   registers. Halo positions are recomputed by neighbouring tiles, never
//   stored. A cluster shape the card cannot schedule makes the launch fail.
// vpu: XNOR + __popc on the CUDA cores (agree = 32 L - sum popc(x XOR w),
//   no NOT). Lane = filter row; each thread register-blocks VP = 4
//   positions, so one 16-byte load of its filter row serves 4 positions and
//   one broadcast 16-byte load of a patch 4 words (V = 4 words a load where
//   CwA and OA/32 are multiples of 4, else 1). The four XOR words of a
//   position pass through two carry-save full adders into a running word,
//   so a 16-byte unit costs 2 popcounts instead of 4. The rank's filter
//   rows of each conv, 32 or 64 at the Table 2 pairs, arrive by one TMA
//   bulk copy on an mbarrier (rows as they lie, V = 4), conv B's while conv
//   A runs; the halo by cp.async. Where rows are not whole 16-byte units,
//   every copy is cp.async and rows lie at an odd stride; shares beyond VR
//   = 64 rows stream in further passes. The grid is (tile columns x C, tile
//   rows, images), the cluster split comes from the host, and position
//   tables are built once per block by warp = row, lane = column: no block
//   divides (a runtime division is a chain of some twenty instructions). A
//   warp unit is 32 rows x 4 positions; with at most 4 units, K is split
//   over warps and the sums meet by shared-memory atomics. A __ballot_sync
//   packs a channel word of the A map, and lanes 0 .. C-1 store it into the
//   map of every rank (DSMEM) after a first, split cluster barrier (every
//   peer has started) and before a second (every map complete), after
//   which no block touches a peer's memory. The filters (3 x 3), CwA (4, 8)
//   and OA/32 (8, 16) of the Table 2 pairs are template constants; other
//   geometries run the same kernel with them read at run time. 64
//   registers, so 4 blocks fit an SM. What holds it (phase timestamps on
//   the card, PERF.md) is each block's latency at 3 to 4 blocks an SM: its
//   first 2 us go to start-up and issuing copies, and the cluster barrier
//   takes about 1 us of the 9 to 12.
// mxu: rank r computes its words of the bit map into its own shared
//   memory; after a cluster barrier it copies the peers' words from theirs
//   (DSMEM). A second, split cluster barrier keeps every map alive until
//   the last peer has read it. Both products run as mma.sync m16n8k32 s8
//   with filter rows on M and positions on N (conv B's 4 positions at CONV-5/6
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

REPRO_PHASE_TABLE(vpu_phases)  // benchmarks/torch_vpu_phases.py k5

namespace {

namespace cg = cooperative_groups;
using repro::cluster_arrive;
using repro::cluster_wait;
using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait_all;
using repro::cp_async_wait_group;
using repro::bulk_copy;
using repro::load_words;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_u32;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// vpu
constexpr int VP = 4;       // positions per thread: its register block
constexpr int VR = 64;      // most filter rows staged per pass
// The vpu kernel's static shared memory: split-K partial sums, one int per
// (lane, position) of at most WARPS / 2 warp units (K is split only when a
// pass has at most that many units), and the mbarriers of the two TMA
// stages (conv A's filter rows, conv B's rows).
struct VpuStatic {
  int red[WARPS / 2 * 32 * VP];
  uint64_t bar[2];
};
constexpr size_t VPU_STATIC = sizeof(VpuStatic);
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
  int tiles_w, tiles_h;
  int npad_a, npad_b;
  // the cluster: csize blocks, OA / csize conv A channels each, and rank
  // r's conv B channels [ob_split[r], ob_split[r + 1]) (computed on the
  // host, so that no block divides by csize)
  int csize, oa_per;
  int ob_split[repro::MAX_CLUSTER + 1];
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
__device__ __forceinline__ Tile make_tile(const Geom& g, int ty, int tx) {
  Tile t;
  t.ha = PF * g.th + g.fhb - 1;
  t.wa = PF * g.tw + g.fwb - 1;
  t.rx = t.ha + g.fha - 1;
  t.cx = t.wa + g.fwa - 1;
  t.oy0 = ty * g.th;
  t.ox0 = tx * g.tw;
  t.ay0 = t.oy0 * PF - g.fhb / 2;
  t.ax0 = t.ox0 * PF - g.fwb / 2;
  t.OAw = g.OA / 32;
  return t;
}

// Start copying the vpu block's input halo into x_s[y][x][cw] by cp.async
// (16 bytes a copy where CwA and a allow it), zero words outside the image:
// warp = halo row, lane = position, so no index is divided. The caller
// commits and waits.
__device__ __forceinline__ void stage_halo(const int32_t* __restrict__ a,
                                           const Geom& g, const Tile& t,
                                           int n, uint32_t* x_s) {
  const bool vec =
      g.CwA % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int iy0 = t.ay0 - g.fha / 2, ix0 = t.ax0 - g.fwa / 2;
  for (int y = warp; y < t.rx; y += WARPS) {
    const int iy = iy0 + y;
    for (int x = lane; x < t.cx; x += 32) {
      const int ix = ix0 + x;
      uint32_t* d = x_s + (y * t.cx + x) * g.CwA;
      if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
        const int32_t* src =
            a + ((static_cast<size_t>(n) * g.H + iy) * g.W + ix) * g.CwA;
        if (vec) {
          for (int k = 0; k < g.CwA; k += 4) cp_async16(d + k, src + k);
        } else {
          for (int k = 0; k < g.CwA; ++k) cp_async4(d + k, src + k);
        }
      } else {
        for (int k = 0; k < g.CwA; ++k) d[k] = 0u;
      }
    }
  }
}

// The mxu kernel's input halo: x_s[y][x][cw], zero words outside the image,
// by plain loads and stores.
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

// ---------------------------------------------------------------- vpu ----

// Word stride of a staged filter row of L words: V = 4 (16-byte loads, L a
// multiple of 4), L itself, so a conv's rows arrive by one TMA bulk copy
// (at L = 72 or 144 the 8 rows a quarter-warp reads share 16-byte bank
// groups two or four ways, which costs less than staging rows one by one:
// PERF.md); V = 1, odd, so 32 rows lie in 32 banks.
__host__ __device__ constexpr int vpu_stride(int L, int V) {
  return V == 4 ? L : (L | 1);
}

__host__ __device__ constexpr int round_vp(int x) {
  return (x + VP - 1) / VP * VP;
}

// Start copying filter rows r0 .. r0+rows-1 of w (O x L words) into w_s at
// word stride ls, by 16-byte cp.async where the rows allow it (warp = row,
// lane = unit of the row).
__device__ __forceinline__ void stage_vpu_rows(const int32_t* __restrict__ w,
                                               int L, int r0, int rows,
                                               int ls, uint32_t* w_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vec = repro::rows_vec(w, L, 0, L, ls);
  for (int r = warp; r < rows; r += WARPS) {
    const int32_t* src = w + static_cast<size_t>(r0 + r) * L;
    uint32_t* dst = w_s + r * ls;
    if (vec) {
      for (int k = 4 * lane; k < L; k += 128) cp_async16(dst + k, src + k);
    } else {
      for (int k = lane; k < L; k += 32) cp_async4(dst + k, src + k);
    }
  }
}

// Cluster rank r of csize blocks per (image, tile): conv A for OA channels
// [r OA/csize, (r+1) OA/csize) over the whole A halo, each channel word of
// the bit map written into the map of every rank (DSMEM); after a cluster
// barrier, conv B for OB channels [ceil(r OB/csize), ceil((r+1) OB/csize))
// from its own map. The grid is (tile columns x csize, tile rows, images);
// the cluster split comes from the host (g.oa_per, g.ob_split), so no
// block divides. mr: filter rows staged per pass. F, CW, OW > 0 fix the
// filters (both F x F), CwA and OA/32 at compile time (the Table 2 pairs);
// 0 reads them from g. V: words per shared-memory load (4 where CwA and
// OA/32 are multiples of 4). 64 registers, so 4 blocks fit an SM.
template <int PF, int F, int CW, int OW, int V>
__global__ void __launch_bounds__(THREADS, 4)
pair_vpu_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ wa,
                const float* __restrict__ ca, const uint8_t* __restrict__ fa,
                const int32_t* __restrict__ wb, const float* __restrict__ cb,
                const uint8_t* __restrict__ fb, int8_t* __restrict__ out,
                Geom g, int mr) {
  extern __shared__ __align__(16) uint32_t smem_vpu[];
  __shared__ VpuStatic st;
  // barrier phase 0, split: this block has started (no memory to order)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  REPRO_PHASE(vpu_phases, 0);  // started
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  unsigned tx;                           // the cluster's tile column
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(tx));
  const Tile t = make_tile<PF>(g, blockIdx.y, static_cast<int>(tx));
  const int n = blockIdx.z, tid = threadIdx.x, warp = tid / 32;
  const int lane = tid % 32, csize = g.csize;
  const int fha = F > 0 ? F : g.fha, fwa = F > 0 ? F : g.fwa;
  const int fhb = F > 0 ? F : g.fhb, fwb = F > 0 ? F : g.fwb;
  const int cwa = CW > 0 ? CW : g.CwA, oaw = OW > 0 ? OW : t.OAw;
  const int oa_per = g.oa_per, oa0 = rank * oa_per;
  int ob0 = 0, ob1 = 0;
#pragma unroll
  for (int r = 0; r < repro::MAX_CLUSTER; ++r) {
    if (r == rank) {
      ob0 = g.ob_split[r];
      ob1 = g.ob_split[r + 1];
    }
  }
  const int LA = fha * fwa * cwa, LB = fhb * fwb * oaw;
  const int lsa = vpu_stride(LA, V), lsb = vpu_stride(LB, V);
  constexpr int PP = PF * PF, QB = VP / PP;
  const int PA = t.ha * t.wa, Q = g.th * g.tw, RB = Q * PP;
  uint32_t* x_s = smem_vpu;                           // [rx][cx][CwA]
  uint32_t* a_s = x_s + t.rx * t.cx * cwa;            // [ha][wa][OAw]
  uint32_t* fa_s = a_s + PA * oaw;                    // [min(mr, OA/C)][lsa]
  uint32_t* fb_s = fa_s + min(mr, oa_per) * lsa;      // [mr][lsb]
  int* pos_a = reinterpret_cast<int*>(fb_s + mr * lsb);   // x_s offset << 1
                                                          // | in the map
  int* pos_b = pos_a + round_vp(PA);                  // a_s offset
  int* out_q = pos_b + round_vp(RB);                  // (oy WO + ox) OB, or -1

  // conv A's first filter rows on one mbarrier (or with the input halo in
  // one cp.async group), conv B's first rows on a second (group), which
  // land while conv A runs. Where the rows are 16-byte aligned and whole
  // 16-byte units, the TMA unit copies each conv's rows in one bulk copy;
  // else cp.async. The halo comes by cp.async (one TMA copy a halo row
  // costs more).
  const int ra = min(mr, oa_per), rb = max(0, min(mr, ob1 - ob0));
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool bulk = V == 4 && aligned(wa) && aligned(wb);
  if (bulk && tid == 0) {
    mbar_init(&st.bar[0]);
    mbar_init(&st.bar[1]);
    mbar_expect_tx(&st.bar[0], ra * LA * 4);
    mbar_expect_tx(&st.bar[1], rb * LB * 4);
    bulk_copy(fa_s, wa + static_cast<size_t>(oa0) * LA, ra * LA * 4,
              &st.bar[0]);
    if (rb > 0)
      bulk_copy(fb_s, wb + static_cast<size_t>(ob0) * LB, rb * LB * 4,
                &st.bar[1]);
  }
  if (!bulk) stage_vpu_rows(wa, LA, oa0, ra, lsa, fa_s);
  stage_halo(a, g, t, n, x_s);
  cp_async_commit();
  if (!bulk) stage_vpu_rows(wb, LB, ob0, rb, lsb, fb_s);
  cp_async_commit();
  REPRO_PHASE(vpu_phases, 1);  // copies issued
  // position tables (warp = row, lane = column), so that nothing divides
  for (int y = warp; y < t.ha; y += WARPS)
    for (int x = lane; x < t.wa; x += 32)
      pos_a[y * t.wa + x] = ((y * t.cx + x) * cwa) << 1 | in_map(g, t, y, x);
  for (int qy = warp; qy < g.th; qy += WARPS) {
    for (int i = lane; i < g.tw * PP; i += 32) {
      const int qx = i / PP, sl = i % PP;              // PP: 4 or 1
      pos_b[(qy * g.tw + qx) * PP + sl] =
          ((qy * PF + sl / PF) * t.wa + qx * PF + sl % PF) * oaw;
    }
    for (int qx = lane; qx < g.tw; qx += 32) {
      const int oy = t.oy0 + qy, ox = t.ox0 + qx;
      out_q[qy * g.tw + qx] =
          oy < g.HO && ox < g.WO ? (oy * g.WO + ox) * g.OB : -1;
    }
  }
  if (tid < round_vp(PA) - PA) pos_a[PA + tid] = 0;
  if (tid < round_vp(RB) - RB) pos_b[RB + tid] = 0;
  if (tid < round_vp(Q) - Q) out_q[Q + tid] = -1;
  for (int i = tid; i < WARPS / 2 * 32 * VP; i += THREADS) st.red[i] = 0;
  REPRO_PHASE(vpu_phases, 2);  // tables built
  cp_async_wait_group<1>();
  __syncthreads();
  if (bulk) mbar_wait(&st.bar[0], 0);    // acquires what the TMA wrote
  cluster_wait();                        // every peer's map may be written
  REPRO_PHASE(vpu_phases, 3);  // conv A's data landed

  // conv A: rows = this rank's OA channels, positions = the A halo; eq. 8
  // and the halo mask per bit, one __ballot_sync per channel word
  const int kA = 32 * LA - g.npad_a;                  // agree = kA - dis
  for (int r0 = 0; r0 < oa_per; r0 += mr) {
    const int rows = min(mr, oa_per - r0);
    if (r0 > 0) {
      __syncthreads();                               // fa_s free
      stage_vpu_rows(wa, LA, oa0 + r0, rows, lsa, fa_s);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    const int ch0 = oa0 + r0;
    auto base_a = [&](int p) { return pos_a[p] >> 1; };
    auto epi_a = [&](int grp, int pb, const int (&dis)[VP]) {
      const int o = ch0 + 32 * grp + lane;
      const float c = ca[o];
      const bool flip = fa[o] != 0;
      uint32_t* word = a_s + (o >> 5);
#pragma unroll
      for (int j = 0; j < VP; ++j) {
        const int p = pb * VP + j;                   // uniform in the warp
        if (p < PA) {
          const bool bit = (pos_a[p] & 1) && nb_bit(kA - dis[j], c, flip);
          const unsigned bits = __ballot_sync(FULL, bit);
          if (lane < csize)
            *cluster.map_shared_rank(word + p * oaw, lane) = bits;
        }
      }
    };
    repro::run_units<WARPS, VP, V, (F > 0 && CW > 0 ? F * CW / V : 0)>(
        rows / 32, round_vp(PA) / VP, fa_s, lsa, x_s, t.cx * cwa,
        fwa * cwa / V, LA / V, base_a, epi_a, st.red);
  }
  REPRO_PHASE(vpu_phases, 4);  // conv A done
  if (bulk) mbar_wait(&st.bar[1], 0);    // conv B's first rows
  cp_async_wait_all();
  cluster.sync();                        // phase 1: every map is complete
  REPRO_PHASE(vpu_phases, 5);  // the bit map shared

  // conv B: rows = this rank's OB channels, positions = (pooled output q,
  // window slot s), VP of them per unit: one window (PF = 2) or VP outputs
  const int kB = 32 * LB - g.npad_b;
  int8_t* out_n = out + static_cast<size_t>(n) * g.HO * g.WO * g.OB;
  for (int r0 = ob0; r0 < ob1; r0 += mr) {
    const int rows = min(mr, ob1 - r0);
    if (r0 > ob0) {
      __syncthreads();                               // fb_s free
      stage_vpu_rows(wb, LB, r0, rows, lsb, fb_s);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    auto base_b = [&](int rr) { return pos_b[rr]; };
    auto epi_b = [&](int grp, int qb, const int (&dis)[VP]) {
      const int o = r0 + 32 * grp + lane;
      const bool live = o < ob1;
      const float c = live ? cb[o] : 0.f;
      const bool flip = live && fb[o] != 0;
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) {
        // 2x2 pool: any (max) where flip is 0, all (min) where it is 1
        bool any = false, all = true;
#pragma unroll
        for (int s = 0; s < PP; ++s) {
          const bool bit = nb_bit(kB - dis[qi * PP + s], c, flip);
          any |= bit;
          all &= bit;
        }
        const int oq = out_q[qb * QB + qi];
        if (live && oq >= 0)
          out_n[oq + o] = static_cast<int8_t>(flip ? all : any);
      }
    };
    repro::run_units<WARPS, VP, V, (F > 0 && OW > 0 ? F * OW / V : 0)>(
        (rows + 31) / 32, round_vp(RB) / VP, fb_s, lsb, a_s, t.wa * oaw,
        fwb * oaw / V, LB / V, base_b, epi_b, st.red);
  }
  REPRO_PHASE(vpu_phases, 6);  // conv B done
}

// ---------------------------------------------------------------- mxu ----


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
  const int tile = blockIdx.x / csize;
  const Tile t = make_tile<PF>(g, tile / g.tiles_w, tile % g.tiles_w);
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

// Shared-memory words of a vpu block: halo and map, conv A's first
// min(mr, OA/C) filter rows at stride vpu_stride(LA), mr conv B rows at
// vpu_stride(LB), and the position tables; mirrored by
// src/repro_torch/kernels/xnor_conv_fused.py::halo_scratch.
size_t vpu_words(const Geom& g, int pf, int mr, int V) {
  const int LA = g.fha * g.fwa * g.CwA, LB = g.fhb * g.fwb * (g.OA / 32);
  const int ra = mr < g.oa_per ? mr : g.oa_per;
  const int pa = (pf * g.th + g.fhb - 1) * (pf * g.tw + g.fwb - 1);
  const int q = g.th * g.tw;
  return map_words(g, pf) + static_cast<size_t>(ra) * vpu_stride(LA, V) +
         static_cast<size_t>(mr) * vpu_stride(LB, V) + round_vp(pa) +
         round_vp(q * pf * pf) + round_vp(q);
}

// Largest divisor of OA/32 that is at most MAX_CLUSTER: the cluster size
// of both variants (kernels/xnor_conv_fused.py::mxu_split mirrors it).
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
  g.tiles_h = (g.HO + th - 1) / th;
  g.npad_a = npad_a; g.npad_b = npad_b;
  g.csize = cluster_size(OA);
  g.oa_per = OA / g.csize;
  for (int r = 0; r <= repro::MAX_CLUSTER; ++r)
    g.ob_split[r] = r <= g.csize ? (r * OB + g.csize - 1) / g.csize : OB;
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
  const int oaw = OA / 32;
  const int V = CwA % 4 == 0 && oaw % 4 == 0 ? 4 : 1;
  // filter rows per pass: VR, halved (to 32 at least) until the block fits
  int mr = VR;
  size_t smem = 0;
  for (;; mr /= 2) {
    smem = vpu_words(g, pf, mr, V) * sizeof(uint32_t);
    if (mr == 32 || smem + VPU_STATIC <= repro::SMEM_LIMIT) break;
  }
  // the Table 2 pairs CONV-3/4 and CONV-5/6 at compile time, the rest
  // through the same kernel with its geometry read at run time
  const bool f3 = pf == 2 && fha == 3 && fwa == 3 && fhb == 3 && fwb == 3;
  const auto kernel =
      f3 && CwA == 4 && oaw == 8     ? pair_vpu_kernel<2, 3, 4, 8, 4>
      : f3 && CwA == 8 && oaw == 16  ? pair_vpu_kernel<2, 3, 8, 16, 4>
      : pf == 2 && V == 4            ? pair_vpu_kernel<2, 0, 0, 0, 4>
      : pf == 2                      ? pair_vpu_kernel<2, 0, 0, 0, 1>
      : V == 4                       ? pair_vpu_kernel<1, 0, 0, 0, 4>
                                     : pair_vpu_kernel<1, 0, 0, 0, 1>;
  const dim3 grid(g.tiles_w * g.csize, g.tiles_h, N);
  return repro::launch_cluster(kernel, grid, dim3(g.csize), THREADS, smem,
                               stream, a, wa, ca, fa, wb, cb, fb, out, g, mr);
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
