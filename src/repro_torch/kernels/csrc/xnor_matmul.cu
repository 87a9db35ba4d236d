// Packed XNOR matmul for Hopper (sm_90a): kernels K1 (vpu) and K2 (mxu).
//
// Contract (paper eq. 5 / eq. 8), shared by both kernels:
//   a (M, Kw) int32 packed activations, w (N, Kw) int32 packed weights,
//   y[m][n] = sum_j popc(~(a[m][j] ^ w[n][j])) - n_pad,  n_pad = Kw*32 - k,
//   out = int32 y, or int8 (y >= c[n]) XOR flip[n] when c != null.
// Ragged M, N and Kw are masked inside the kernels; nothing is pre-padded.
//
// K1 replaces src/repro/kernels/xnor_matmul.py::xnor_matmul_vpu
//   (_xnor_vpu_kernel). XNOR + __popc on the CUDA cores in two regimes,
//   chosen on the host by vpu_plan (kernels/xnor_matmul.py::vpu_plan
//   mirrors it) from (M, N, Kw) alone; the wrapper copies an operand that
//   does not start on 16 bytes, so 16-byte units need only Kw % 4 == 0:
//   - decode-shaped, M <= K1_GEMV_M (FC-1..3 at the served batch, the XNOR
//     LM's "xnor" decode step): bound by the launch and one round trip for
//     the weights (FC-1: 1 MB, 0.3 us at the HBM rate). A GEMV with no
//     shared memory and no block barrier: 4 warps a block, each lane reads
//     its share of K (16-byte units where Kw % 4 == 0, else words) of one
//     weight row and of MT = 1, 2 or 4 activation rows straight from device
//     memory into registers, a group of 2^lg lanes per weight row (2^lg the
//     least power of two >= the row's units, at most 32, so short rows
//     leave no lane idle: Kw = 4 puts 32 rows in a warp), the units through
//     the carry-save core of csrc/bits.cuh, the group's sums added by an
//     xor butterfly of shuffles, eq. 8 fused. FC-1 launches 256 blocks.
//   - tiled, larger M (the im2col convs): bound by the integer pipes over
//     the XOR-popcounts. K3's core with activation rows in place of
//     positions: a block of 4 warps takes 32 weight rows (lane = row) x bm
//     activation rows (64, halved to 16 until the blocks make a wave),
//     each thread VP = 4 activation rows in registers, so a 16-byte load of
//     its weight row serves 4 rows and a broadcast 16-byte load of an
//     activation row 4 words; the carry-save core halves the popcounts.
//     Both operands' rows arrive by the TMA unit, one bulk copy a row
//     issued by warp 0's lanes, into rows at a stride of 4 mod 8 words, K
//     at most K1_PASS words a pass; sums stay in registers across passes.
//
// K2 replaces src/repro/kernels/xnor_matmul.py::xnor_matmul_mxu
//   (_xnor_mxu_kernel). Bound on the H100: at the served batch (M = slots,
//   FC-1..3) the launch and one round trip to device memory for the
//   weights (1.2 MB); at the im2col shapes (M up to 4096) the same, the
//   products being well under a microsecond of tensor-core work.
//   Design: output channels (N) on the 16 rows of the MMA, activation rows
//   (M) on its 8 columns, so M = 4 fills half of one n8 tile. The products
//   are mma.sync m16n8k256 .b1 .and.popc on the packed words as they lie:
//   one MMA covers 8 words, with no unpack; y = 32 Kw - popc(a) - popc(w)
//   + 2 popc(a AND w) - n_pad, the popcounts taken by the same MMA against
//   all-ones operands. The form was chosen by the rate probe
//   (csrc/mma_probe.cu, printed by chip_smoke.py; NVIDIA H100 80GB HBM3,
//   700.00 W, SM clock 1980 MHz): .and.popc 5.01e15 bit-MAC/s, .xor.popc
//   7.87e14 (a sixth of the AND form's instruction rate on sm_90a),
//   m16n8k32 s8 on +-1 bytes 6.27e14, s8 with both operands unpacked in
//   registers 1.21e14. A block stages its rows of both operands over its
//   words of K in one cp.async pass (16-byte copies, rows at a stride of 4
//   mod 8 words so the fragment loads hit 32 banks), waits once, and its 4
//   warps split the block's m16 tiles and K; partial sums meet in shared
//   memory. Where tiles are too few for a wave of blocks (132), K is split
//   further over a thread-block cluster of up to 8 blocks, which add their
//   shares into rank 0's tile through distributed shared memory; after one
//   cluster barrier rank 0 applies the constant and the eq. 8 epilogue and
//   writes its tile with N innermost. Integer sums are exact in any order, so the
//   split is bit-exact. mm_plan (kernels/xnor_matmul.py::mxu_plan mirrors
//   it) picks the tile, the split and the shared memory from (M, N, Kw).
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int K1_THREADS = 128;    // 4 warps, both regimes
constexpr int K1_WARPS = K1_THREADS / 32;
constexpr int K1_GEMV_M = 16;      // the GEMV serves M up to this
constexpr int K1_BN = 32;          // tiled: weight rows per block (lane = row)
constexpr int K1_VP = 4;           // tiled: activation rows per thread
constexpr int K1_BM = 64;          // tiled: most activation rows per block
constexpr int K1_PASS = 256;       // tiled: most words of K staged per pass
constexpr int WAVE = 132;          // blocks that fill the H100's SMs once
constexpr unsigned FULL = 0xffffffffu;

template <int V>
__device__ __forceinline__ void ldg_words(const int32_t* p, uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
    w[0] = static_cast<uint32_t>(__ldg(p));
  }
}

// Decode-shaped K1: a lane of group (lane >> lg) reads units j0, j0 + 2^lg,
// ... of weight row n and of activation rows m0 .. m0+MT-1 (units of V
// words: 16 bytes where V = 4), keeps each row's carry-save state in
// registers, and the group adds its sums by a butterfly of shuffles; lane
// j0 of the group stores the rows r with r mod 2^lg == j0.
template <int MT, int V>
__global__ void __launch_bounds__(K1_THREADS)
xnor_gemv_kernel(const int32_t* __restrict__ a,
                 const int32_t* __restrict__ w,
                 const float* __restrict__ c,
                 const uint8_t* __restrict__ flip,
                 void* __restrict__ out, int M, int N, int Kw, int n_pad,
                 int lg) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = lane & ((1 << lg) - 1);
  const int n = ((blockIdx.x * K1_WARPS + warp) << (5 - lg)) + (lane >> lg);
  const int m0 = blockIdx.y * MT;
  const bool live = n < N;
  const bool thr = c != nullptr && live;
  const float c_n = thr ? c[n] : 0.f;
  const bool f_n = thr && flip[n] != 0;
  const int32_t* wr = w + static_cast<size_t>(live ? n : N - 1) * Kw;
  const int32_t* ar[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r)
    ar[r] = a + static_cast<size_t>(min(m0 + r, M - 1)) * Kw;
  const int units = V == 4 ? Kw >> 2 : Kw;
  uint32_t ones[MT];
  int twos[MT], dis[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    ones[r] = 0u;
    twos[r] = dis[r] = 0;
  }
#pragma unroll 2
  for (int u = j0; u < units; u += 1 << lg) {
    uint32_t wv[V];
    ldg_words<V>(wr + u * V, wv);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      uint32_t x[V];
      ldg_words<V>(ar[r] + u * V, x);
      if constexpr (V == 4)
        repro::csa_unit(x[0] ^ wv[0], x[1] ^ wv[1], x[2] ^ wv[2],
                        x[3] ^ wv[3], ones[r], twos[r]);
      else
        dis[r] += __popc(x[0] ^ wv[0]);
    }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    dis[r] += __popc(ones[r]) + 2 * twos[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < (1 << lg)) dis[r] += __shfl_xor_sync(FULL, dis[r], o);
  }
  if (!live) return;
  const int kp = 32 * Kw - n_pad;
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    if ((r & ((1 << lg) - 1)) != j0 || m0 + r >= M) continue;
    const size_t idx = static_cast<size_t>(m0 + r) * N + n;
    const int y = kp - dis[r];
    if (c != nullptr)
      static_cast<int8_t*>(out)[idx] =
          static_cast<int8_t>((static_cast<float>(y) >= c_n) != f_n);
    else
      static_cast<int32_t*>(out)[idx] = y;
  }
}

// Tiled K1: block (m tile, n tile) of bm activation rows x K1_BN weight
// rows; warp unit pb = K1_VP activation rows x 32 weight rows, units warp,
// warp + 4, ... (bm / 16 of them a warp). Per pass, kn <= kc words of K of
// both operands' rows are staged at stride ls: by one TMA bulk copy a row
// on an mbarrier where V = 4 (the wrapper hands over operands that start
// on 16 bytes), else by 4-byte cp.async.
template <int V>
__global__ void __launch_bounds__(K1_THREADS, 4)
xnor_matmul_vpu_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ w,
                       const float* __restrict__ c,
                       const uint8_t* __restrict__ flip,
                       void* __restrict__ out, int M, int N, int Kw,
                       int n_pad, int bm, int kc, int ls) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint64_t bar;
  uint32_t* w_s = smem;                     // [K1_BN][ls]
  uint32_t* a_s = smem + K1_BN * ls;        // [bm][ls]
  const int m0 = blockIdx.x * bm, n0 = blockIdx.y * K1_BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrows = min(K1_BN, N - n0), arows = min(bm, M - m0);
  const int units = bm / K1_VP;             // warp units of the block
  const int n = n0 + lane;
  const bool live = n < N;
  const bool thr = c != nullptr && live;
  const float c_n = thr ? c[n] : 0.f;
  const bool f_n = thr && flip[n] != 0;
  int dis[K1_BM / K1_VP / K1_WARPS][K1_VP] = {};
  int pass = 0;
  for (int k0 = 0; k0 < Kw; k0 += kc, ++pass) {
    const int kn = min(kc, Kw - k0);
    if (k0 > 0) __syncthreads();            // every warp is done with it
    if constexpr (V == 4) {
      if (warp == 0) {
        if (lane == 0) {
          if (k0 == 0) repro::mbar_init(&bar);
          repro::mbar_expect_tx(&bar, (wrows + arows) * kn * 4);
        }
        __syncwarp();
        for (int r = lane; r < wrows + arows; r += 32) {
          const bool isw = r < wrows;
          const int32_t* src =
              isw ? w + static_cast<size_t>(n0 + r) * Kw + k0
                  : a + static_cast<size_t>(m0 + r - wrows) * Kw + k0;
          repro::bulk_copy(isw ? w_s + r * ls : a_s + (r - wrows) * ls, src,
                           kn * 4, &bar);
        }
      }
    } else {
      for (int r = warp; r < wrows + arows; r += K1_WARPS) {
        const bool isw = r < wrows;
        const int32_t* src =
            isw ? w + static_cast<size_t>(n0 + r) * Kw + k0
                : a + static_cast<size_t>(m0 + r - wrows) * Kw + k0;
        uint32_t* dst = isw ? w_s + r * ls : a_s + (r - wrows) * ls;
        for (int k = lane; k < kn; k += 32) repro::cp_async4(dst + k, src + k);
      }
      repro::cp_async_commit();
      repro::cp_async_wait_all();
    }
    __syncthreads();
    if constexpr (V == 4) repro::mbar_wait(&bar, pass & 1);
    const int nv = kn / V;
#pragma unroll
    for (int t = 0; t < K1_BM / K1_VP / K1_WARPS; ++t) {
      const int pb = warp + K1_WARPS * t;
      if (pb < units) {
        int base[K1_VP];
#pragma unroll
        for (int j = 0; j < K1_VP; ++j) base[j] = (pb * K1_VP + j) * ls;
        repro::xor_popc<V, 0, K1_VP>(w_s + lane * ls, a_s, base, 0, nv, 0,
                                     nv, dis[t]);
      }
    }
  }
  if (!live) return;
  const int kp = 32 * Kw - n_pad;
#pragma unroll
  for (int t = 0; t < K1_BM / K1_VP / K1_WARPS; ++t) {
    const int pb = warp + K1_WARPS * t;
#pragma unroll
    for (int j = 0; j < K1_VP; ++j) {
      const int m = m0 + pb * K1_VP + j;
      if (pb >= units || m >= M) continue;
      const size_t idx = static_cast<size_t>(m) * N + n;
      const int y = kp - dis[t][j];
      if (c != nullptr)
        static_cast<int8_t*>(out)[idx] =
            static_cast<int8_t>((static_cast<float>(y) >= c_n) != f_n);
      else
        static_cast<int32_t*>(out)[idx] = y;
    }
  }
}

// K1's launch for (M, N, Kw), computed on the host. GEMV (gemv != 0): row
// tile mt, lanes per weight row 2^lg, grid (weight-row blocks, row tiles);
// tiled: bm activation rows, kc words of K a pass at row stride ls, grid
// (m tiles, n tiles), smem bytes of dynamic shared memory.
struct K1Plan {
  int gemv, V, mt, lg, bm, kc, ls;
  dim3 grid;
  size_t smem;
};

K1Plan k1_plan(int M, int N, int Kw) {
  K1Plan p = {};
  p.V = Kw % 4 == 0 ? 4 : 1;
  p.gemv = M <= K1_GEMV_M;
  if (p.gemv) {
    p.mt = M <= 1 ? 1 : M == 2 ? 2 : 4;
    const int units = p.V == 4 ? Kw / 4 : Kw;
    while ((1 << p.lg) < units && p.lg < 5) ++p.lg;
    const int rows_per_block = K1_WARPS << (5 - p.lg);
    p.grid = dim3((N + rows_per_block - 1) / rows_per_block,
                  (M + p.mt - 1) / p.mt);
    return p;
  }
  const long long nt = (N + K1_BN - 1) / K1_BN;
  p.bm = K1_BM;
  while (p.bm > 16 && nt * ((M + p.bm - 1) / p.bm) < WAVE) p.bm /= 2;
  p.kc = Kw < K1_PASS ? Kw : K1_PASS;
  p.ls = p.V == 4 ? (p.kc % 8 == 4 ? p.kc : p.kc + 4) : (p.kc | 1);
  p.grid = dim3((M + p.bm - 1) / p.bm, static_cast<unsigned>(nt));
  p.smem = sizeof(uint32_t) * static_cast<size_t>(K1_BN + p.bm) * p.ls;
  return p;
}

constexpr int K2_THREADS = 128;               // 4 warps
constexpr int K2_WARPS = K2_THREADS / 32;
constexpr int K2_PASS = 256;   // most words of K staged per pass

// A block's tile: bn output channels (16 per m16 tile, at most 64) x bm
// activation rows (8 per n8 tile, at most 64) over one cluster rank's
// share of the 8-word steps of K, cs ranks; pass = words staged at once.
struct MmPlan {
  int bn, bm, cs, pass;
  size_t smem;
};

int pow2_at_least(int x, int lo, int hi) {
  int p = lo;
  while (p < x && p < hi) p *= 2;
  return p;
}

// Largest tiles first; halve bn, then bm, until the tiles make a wave;
// then double the cluster (at most 8, at least one 8-word step per rank)
// until the blocks do.
MmPlan mm_plan(int M, int N, int Kw) {
  MmPlan p;
  p.bm = pow2_at_least(M, 8, 64);
  p.bn = pow2_at_least(N, 16, 64);
  const auto tiles = [&] {
    return static_cast<long long>((N + p.bn - 1) / p.bn) *
           ((M + p.bm - 1) / p.bm);
  };
  while (tiles() < WAVE && (p.bn > 16 || p.bm > 8)) {
    if (p.bn > 16) p.bn /= 2; else p.bm /= 2;
  }
  const int steps = (Kw + 7) / 8;
  p.cs = 1;
  while (p.cs < repro::MAX_CLUSTER && 2 * p.cs <= steps &&
         tiles() * p.cs < WAVE)
    p.cs *= 2;
  const int rank_words = (steps + p.cs - 1) / p.cs * 8;
  p.pass = rank_words < K2_PASS ? rank_words : K2_PASS;
  p.smem = sizeof(uint32_t) *
           (static_cast<size_t>(p.bn + p.bm) * (p.pass + 4) +
            static_cast<size_t>(p.bm) * (p.bn + 4));
  return p;
}

// CL: a cluster of cs > 1 blocks splits K; without one (cs = 1) the
// block's barriers are block barriers and its tile stays its own.
template <bool CL>
__global__ void __launch_bounds__(K2_THREADS)
xnor_matmul_mxu_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ w,
                       const float* __restrict__ c,
                       const uint8_t* __restrict__ flip,
                       void* __restrict__ out, int M, int N, int Kw,
                       int n_pad, int bn, int bm, int cs, int pass,
                       int n_on_x) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int stride = pass + 4;            // words per staged row, 4 mod 8
  uint32_t* w_s = smem;                   // [bn][stride]
  uint32_t* a_s = w_s + bn * stride;      // [bm][stride]
  int* red = reinterpret_cast<int*>(a_s + bm * stride);  // [bm][bn + 4]
  const int rs = bn + 4;
  // bn, bm and cs are powers of two: shifts, no divisions
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lcs = repro::ilog2(cs), lbn = repro::ilog2(bn);
  // grid (n tiles x cs, m tiles), clusters along x, or (m, n) tiles
  const int n0 = (n_on_x ? blockIdx.x >> lcs : blockIdx.y) * bn;
  const int m0 = (n_on_x ? blockIdx.y : blockIdx.x) * bm;
  const int steps = (Kw + 7) / 8;
  const int s_lo = (rank * steps) >> lcs, s_hi = ((rank + 1) * steps) >> lcs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lmt = lbn - 4, lksw = repro::ilog2(K2_WARPS) - lmt;
  const int mi = warp & ((1 << lmt) - 1), slice = warp >> lmt, nb = bm / 8;
  // rank 0's epilogue channel of this thread (K2_THREADS % bn == 0), its
  // threshold loaded while the block computes
  const int en = threadIdx.x & (bn - 1);
  for (int i = threadIdx.x; i < bm * rs; i += K2_THREADS) red[i] = 0;
  if (CL) repro::cluster_arrive();        // red zeroed: peers may add to it
  const bool thr = c != nullptr && n0 + en < N;
  const float c_en = thr ? c[n0 + en] : 0.f;
  const bool f_en = thr && flip[n0 + en] != 0;
  int acc[8][4] = {}, pa[8][4] = {}, pw[4] = {};
  const uint32_t ones[4] = {~0u, ~0u, ~0u, ~0u};
  for (int p0 = s_lo; p0 < s_hi; p0 += pass / 8) {
    const int p1 = min(p0 + pass / 8, s_hi);
    const int k0 = 8 * p0, k1 = min(8 * p1, Kw), zpad = 8 * p1 - k1;
    if (p0 > s_lo) __syncthreads();       // the last pass is done with it
    // the bn rows of w, then the bm rows of a, in one walk (a_s follows
    // w_s at the same stride)
    repro::stage_words(
        bn + bm, k0, k1, zpad,
        repro::rows_vec(w, Kw, k0, k1, stride) &&
            repro::rows_vec(a, Kw, k0, k1, stride),
        [&](int r) -> const int32_t* {
          if (r < bn)
            return n0 + r < N ? w + static_cast<size_t>(n0 + r) * Kw : nullptr;
          return m0 + r - bn < M ? a + static_cast<size_t>(m0 + r - bn) * Kw
                                 : nullptr;
        },
        w_s, stride, K2_THREADS);
    repro::cp_async_commit();
    repro::cp_async_wait_all();
    __syncthreads();
    const int np = p1 - p0;
    const uint32_t* f0 = w_s + (16 * mi + g) * stride + t;
    const uint32_t* f1 = f0 + 8 * stride;
    const uint32_t* b = a_s + g * stride + t;
    for (int q = (slice * np) >> lksw; q < ((slice + 1) * np) >> lksw; ++q) {
      const uint32_t fa[4] = {f0[8 * q], f1[8 * q], f0[8 * q + 4],
                              f1[8 * q + 4]};
      repro::mma_and_popc(pw, fa, ~0u, ~0u);       // popc(w rows)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nb) {
          const uint32_t* col = b + 8 * j * stride + 8 * q;
          repro::mma_and_popc(acc[j], fa, col[0], col[4]);
          repro::mma_and_popc(pa[j], ones, col[0], col[4]);  // popc(a)
        }
      }
    }
  }
  if (CL) repro::cluster_wait();          // rank 0's red is zeroed
  int* dst = CL ? cluster.map_shared_rank(red, 0) : red;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nb) {
      // this warp's share over its words: 2 popc(a AND w) - popc(a) -
      // popc(w)
      int* r = dst + (8 * j + 2 * t) * rs + 16 * mi + g;
      atomicAdd(r, 2 * acc[j][0] - pa[j][0] - pw[0]);
      atomicAdd(r + rs, 2 * acc[j][1] - pa[j][1] - pw[1]);
      atomicAdd(r + 8, 2 * acc[j][2] - pa[j][2] - pw[2]);
      atomicAdd(r + rs + 8, 2 * acc[j][3] - pa[j][3] - pw[3]);
    }
  }
  if (CL) cluster.sync(); else __syncthreads();  // every share is in
  if (rank != 0 || n0 + en >= N) return;
  const int kp = 32 * Kw - n_pad;
  for (int m = threadIdx.x >> lbn; m < bm && m0 + m < M;
       m += K2_THREADS >> lbn) {
    const int y = kp + red[m * rs + en];
    const size_t idx = static_cast<size_t>(m0 + m) * N + n0 + en;
    if (c != nullptr)
      static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(
          (static_cast<float>(y) >= c_en) != f_en);
    else
      static_cast<int32_t*>(out)[idx] = y;
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
  const K1Plan p = k1_plan(M, N, Kw);
  if (p.grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ap = static_cast<const int32_t*>(a);
  const int32_t* wp = static_cast<const int32_t*>(w);
  const float* cp = static_cast<const float*>(c);
  const uint8_t* fp = static_cast<const uint8_t*>(flip);
  if (!p.gemv)
    return repro::launch_cluster(p.V == 4 ? xnor_matmul_vpu_kernel<4>
                                          : xnor_matmul_vpu_kernel<1>,
                                 p.grid, dim3(1), K1_THREADS, p.smem, stream,
                                 ap, wp, cp, fp, out, M, N, Kw, n_pad, p.bm,
                                 p.kc, p.ls);
  const auto kernel =
      p.V == 4 ? (p.mt == 1   ? xnor_gemv_kernel<1, 4>
                  : p.mt == 2 ? xnor_gemv_kernel<2, 4>
                              : xnor_gemv_kernel<4, 4>)
               : (p.mt == 1   ? xnor_gemv_kernel<1, 1>
                  : p.mt == 2 ? xnor_gemv_kernel<2, 1>
                              : xnor_gemv_kernel<4, 1>);
  kernel<<<p.grid, K1_THREADS, 0, s>>>(ap, wp, cp, fp, out, M, N, Kw, n_pad,
                                       p.lg);
  return static_cast<int>(cudaGetLastError());
}

int xnor_matmul_mxu(const void* a, const void* w, const void* c,
                    const void* flip, void* out, int M, int N, int Kw,
                    int n_pad, void* stream) {
  const MmPlan p = mm_plan(M, N, Kw);
  // n tiles (x cs) on x where a cluster splits K (tiles are few then) or
  // where they outnumber y's limit; else m tiles on x (up to 2^31 - 1)
  const int nt = (N + p.bn - 1) / p.bn, mt = (M + p.bm - 1) / p.bm;
  const int n_on_x = p.cs > 1 || nt > 65535;
  const dim3 grid = n_on_x ? dim3(nt * p.cs, mt) : dim3(mt, nt);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return repro::launch_cluster(p.cs > 1 ? xnor_matmul_mxu_kernel<true>
                                          : xnor_matmul_mxu_kernel<false>,
                               grid, dim3(p.cs),
                               K2_THREADS, p.smem, stream, a, w, c, flip, out,
                               M, N, Kw, n_pad, p.bn, p.bm, p.cs, p.pass,
                               n_on_x);
}

}  // extern "C"
