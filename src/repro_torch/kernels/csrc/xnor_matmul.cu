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

constexpr int K2_THREADS = 128;               // 4 warps
constexpr int K2_WARPS = K2_THREADS / 32;
constexpr int K2_PASS = 256;   // most words of K staged per pass
constexpr int WAVE = 132;      // blocks that fill the H100's SMs once

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
