// Causal / non-causal GQA flash attention on Hopper's tensor cores
// (sm_90a): kernel K7, variant "tc" (bf16; query/key width HDQK, value
// width HDV, (HDQK, HDV) in {(64, 64), (128, 128), (192, 128)}).
//
// Contract, as csrc/flash_attention.cu's header states it, with the value
// width apart from the query/key width (MLA's heads):
//   q   (B, Hq, S, HDQK) bfloat16, any strides with the last dimension
//       contiguous and the others multiples of 8 elements (a head-major
//       view x.transpose(1, 2) of a (B, S, H, hd) tensor is taken as is);
//   k   (B, Hkv, S, HDQK), v (B, Hkv, S, HDV) bfloat16, the same stride
//       rule, Hq % Hkv == 0: query head h reads kv head h / (Hq / Hkv),
//       without a copy;
//   out (B, Hq, S, HDV) bfloat16 at the strides the caller gives;
//   out[q] = sum_k softmax_k(scale * q . k) v[k] over the keys k < S and,
//   when causal, k <= q, with scale = HDQK^-0.5. Keys are masked at the
//   true S: no padded key ever joins the softmax.
// Arithmetic: scores in float32 on the tensor cores; an online softmax
// keeps a running max m and a rescaled sum l per row; p is rounded to bf16
// (round to nearest even) before the PV product while l sums the
// unrounded float32 p; float32 accumulation; out = acc / max(l, 1e-30),
// stored in bf16. Two changes of order against csrc/flash_attention.cu
// (both within the tolerances of tests/test_torch_flash.py, whose
// emulation of this order shows it): (1) the scale multiplies the float32
// QK^T accumulator, not q before the product (a bf16 q * scale would add
// a rounding); (2) the softmax runs in base 2 with log2(e) folded into the
// scale on the host: with c = scale * log2(e), m = max over the keys so
// far of (max s) * c and p = exp2(fma(s, c, -m)) (ex2.approx.ftz: a p
// below 2^-126 is 0).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
//   (_flash_kernel) for bf16 at those widths (the reference pads MLA's v to
//   q's width; here v is read at its own); float32 and every other width
//   keep the CUDA-core variant (kernels/flash_attention.py::pick_variant).
// Bound on the H100: at (B, Hq, Hkv, hd) = (1, 32, 8, 128), S = 4096,
//   causal, the 1.4e11 FLOP take 0.139 ms at the 989 TFLOP/s bf16
//   tensor-core rate and the 84 MB of q, k, v and out 0.025 ms at
//   3.35 TB/s; MLA's (1, 16, 16, 192 / 128) at S = 4096 is 1.1e11 FLOP,
//   0.111 ms: operations bound both, so both products run as wgmma.
// Design: one block of three warpgroups per (b * Hq + h, 128 query rows),
//   on a grid of (B * Hq, query tiles) with the heaviest (latest) query
//   tiles first. Warpgroups 0 and 1 consume 64 query rows each; one thread
//   of warpgroup 2 produces: it loads the block's Q tile once and the
//   128-key K and V tiles through a ring of `stages` buffers, all by TMA
//   (4-D tensor maps over (width, S, H, B) with the caller's strides,
//   128-byte swizzle, rows past S filled with zeros). K and V of a buffer
//   each have a "full" mbarrier (TMA transaction bytes) and an "empty" one:
//   every consumer warp frees K once its QK^T product is in and V once its
//   PV product is (one lane arrives for the warp), so the next K load starts
//   a whole tile before the V beside it is free. Per KV tile t a consumer
//   warpgroup queues S = Q K^T (m64n128k16 wgmma from shared memory, HDQK /
//   16 k-slices) and, behind it, O += P V of tile t - 1 (m64n{HDV}k16 wgmma,
//   A = p in registers, V read MN-major through the transpose bit); once S
//   is in, it masks (only the diagonal tile and a ragged last tile carry a
//   mask) and runs the online softmax in the accumulator registers (a row
//   lives in one quad of lanes) while that PV product runs, then rescales O
//   and packs p to bf16 pairs in registers: the m64 float32 accumulator of S
//   is laid out as the A fragment of the PV product, so p never touches
//   shared memory. 128-key tiles halve the per-tile work that does not scale
//   with the keys (barrier waits, row reductions, the rescale of O) against
//   64-key ones. Staging is bf16; the ring is as deep as the 227
//   KB of a block allow, at most 3 (tc_stages): at (128, 128) Q takes
//   32 KB and each of 3 stages 64 KB, 230,504 bytes in all; at (192, 128)
//   Q takes 48 KB and each of 2 stages 80 KB, 214,088 bytes
//   (tests/test_torch_flash.py recounts them from this file). The
//   causal loop stops at each warpgroup's own diagonal tile. One block
//   holds an SM: its 384 threads start at 168 registers, which fill the
//   SM's 65,536, and setmaxnreg moves them to the consumers (240 each; the
//   producer keeps 24) for S, p and O in registers (64 + 32 + HDV / 2 per
//   thread). A barrier wait that has not completed after 60 s traps
//   instead of hanging the card (a deadlock; no legitimate wait comes near
//   that); the trap leaves the process's CUDA context unusable.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TC_BM = 128;          // query rows per block (2 warpgroups)
constexpr int TC_BN = 128;          // keys per KV tile
constexpr int TC_MAX_STAGES = 3;    // K/V ring depth where it fits
constexpr int TC_THREADS = 384;     // 2 consumer warpgroups + 1 producer
constexpr int TC_ROW_BYTES = 128;   // one 64-column bf16 swizzle atom row
constexpr int TC_SMEM_LIMIT = 232448;   // H100: opt-in shared memory a block

// Shared-memory bytes of one block with a ring of `stages`: 1 KB of
// alignment slack, the Q tile, the K/V ring and 1 + 4 * stages mbarriers
// (Q; full and empty of each K and each V buffer).
__host__ __device__ constexpr int tc_smem_bytes(int hdqk, int hdv,
                                                int stages) {
  return 1024 + TC_BM * hdqk * 2 + stages * TC_BN * (hdqk + hdv) * 2
         + 8 * (1 + 4 * stages);
}
// The ring's depth at (hdqk, hdv): TC_MAX_STAGES where that fits a block,
// else one less (the Q tile and K grow with hdqk; 3 stages at 192 / 128
// would take 295,992 bytes).
__host__ __device__ constexpr int tc_stages(int hdqk, int hdv) {
  return tc_smem_bytes(hdqk, hdv, TC_MAX_STAGES) <= TC_SMEM_LIMIT
             ? TC_MAX_STAGES : TC_MAX_STAGES - 1;
}
static_assert(tc_stages(64, 64) == 3 && tc_stages(128, 128) == 3
              && tc_stages(192, 128) == 2, "ring depths changed");

// The (HDQK, HDV) instantiations, the one list that the entry point's shape
// check and dispatch expand (kernels/flash_attention.py::TC_SHAPES names
// the same pairs).
#define TC_SHAPES(X) X(64, 64) X(128, 128) X(192, 128)
#define TC_FITS(HDQK, HDV)                                                \
  static_assert(tc_smem_bytes(HDQK, HDV, tc_stages(HDQK, HDV))           \
                    <= TC_SMEM_LIMIT, "tiles exceed 227 KB");
TC_SHAPES(TC_FITS)
#undef TC_FITS

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier --------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 60000000000ull) {
      __trap();
    }
  }
}

// ---- TMA ---------------------------------------------------------------
// One box of the 4-D map (hd, S, H, B) at coordinates (c0, c1, c2, c3)
// into shared memory at `dst`; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units. Tiles start on 1024-byte
// boundaries, so the swizzle phase (base offset) is 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this thread are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (+)= A B over one k16 slice, A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A B over one k16 slice, A (bf16 pairs) in registers, B in shared
// memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B over one k16 slice, A (bf16 pairs) in registers, B in shared
// memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Keys of KV tiles [0, n) that the query rows [row0, row0 + 64) read.
__device__ __forceinline__ int tiles_for(int row0, int S, int causal) {
  const int all = (S + TC_BN - 1) / TC_BN;
  return causal ? min(all, (row0 + 64 + TC_BN - 1) / TC_BN) : all;
}

// S = Q K^T of one tile: HDQK / 16 k-slices, 32 bytes apart inside a
// 64-column swizzle atom, the atoms TC_BM (Q) or TC_BN (K) rows apart.
template <int HDQK>
__device__ __forceinline__ void issue_qk(float (&sc)[TC_BN / 2],
                                         uint32_t q_wg, uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < HDQK / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss_n128(
        sc, make_desc(q_wg + (kk >> 2) * TC_BM * TC_ROW_BYTES + off, 16, 1024),
        make_desc(k_s + (kk >> 2) * TC_BN * TC_ROW_BYTES + off, 16, 1024),
        kk > 0);
  }
}

// O += P V of one tile. V is (key, d) row-major, i.e. MN-major for this
// product: a k-slice is 16 keys (2048 bytes), the 64-column atoms of d lie
// TC_BN rows apart (leading byte offset), 8-key groups 1024 bytes apart
// (stride byte offset).
template <int HDV>
__device__ __forceinline__ void issue_pv(float (&o)[HDV / 2],
                                         const uint32_t (&pa)[TC_BN / 16][4],
                                         uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < TC_BN / 16; ++kk) {
    const uint64_t dv = make_desc(v_s + kk * 16 * TC_ROW_BYTES,
                                  TC_BN * TC_ROW_BYTES, 1024);
    if constexpr (HDV == 64) {
      wgmma_rs_n64(o, pa[kk], dv);
    } else {
      wgmma_rs_n128(o, pa[kk], dv);
    }
  }
}

// p to bf16 as the A fragment of k-slice kk: the accumulator's columns
// 16 kk .. 16 kk + 15 (registers 8 kk .. 8 kk + 7).
__device__ __forceinline__ void pack_p(const float (&sc)[TC_BN / 2],
                                       uint32_t (&pa)[TC_BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < TC_BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online-softmax state of a thread's two rows: row a = ra in registers
// 4 j + 0, 1 of the S fragment, row b = ra + 8 in 4 j + 2, 3; a row's TC_BN
// scores lie in the four lanes of one quad. m is in base 2 (scaled).
struct Rows {
  int ra, quad;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float corr_a = 1.f, corr_b = 1.f;

  // Raw scores of the keys k0 .. k0 + TC_BN - 1 in, float32 p out; l sums
  // this lane's p (the quad adds its lanes at the end). Every visited tile
  // keeps a key for every row (key 0 in tile 0, key row0 in the diagonal
  // tile), so the new max is finite.
  __device__ __forceinline__ void softmax(float (&sc)[TC_BN / 2], int k0,
                                          bool masked, int S, int causal,
                                          float scale_log2) {
    if (masked) {
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * quad + (e & 1);
          const int row = ra + (e >> 1) * 8;
          if (col >= S || (causal && col > row)) sc[4 * j + e] = -INFINITY;
        }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    // the scale is positive, so max(s) * scale is the max of s * scale
    const float mn_a = fmaxf(m_a, mx_a * scale_log2);
    const float mn_b = fmaxf(m_b, mx_b * scale_log2);
    corr_a = exp2_approx(m_a - mn_a);
    corr_b = exp2_approx(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j) {
      sc[4 * j] = exp2_approx(fmaf(sc[4 * j], scale_log2, -mn_a));
      sc[4 * j + 1] = exp2_approx(fmaf(sc[4 * j + 1], scale_log2, -mn_a));
      sc[4 * j + 2] = exp2_approx(fmaf(sc[4 * j + 2], scale_log2, -mn_b));
      sc[4 * j + 3] = exp2_approx(fmaf(sc[4 * j + 3], scale_log2, -mn_b));
      sum_a += sc[4 * j] + sc[4 * j + 1];
      sum_b += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
  }
};

template <int HDQK, int HDV>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ out, long long osb,
                          long long osh, long long oss, int S, int Hq,
                          int group, int causal, float scale_log2) {
  constexpr int STAGES = tc_stages(HDQK, HDV);
  constexpr int NCQ = HDQK / 64;                 // 64-column swizzle atoms
  constexpr int NCV = HDV / 64;
  constexpr int Q_BYTES = TC_BM * HDQK * 2;
  constexpr int K_BYTES = TC_BN * HDQK * 2;      // one K tile
  constexpr int V_BYTES = TC_BN * HDV * 2;       // one V tile
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                     // [NCQ][TC_BM][64]
  // [STAGES][K [NCQ][TC_BN][64], V [NCV][TC_BN][64]]
  const uint32_t kv_s = base + Q_BYTES;
  const uint32_t bars = kv_s + STAGES * (K_BYTES + V_BYTES);
  const uint32_t q_full = bars;
  // mbarrier i of buffer s: bars + 8 (1 + i * STAGES + s), i = 0 K full,
  // 1 V full, 2 K empty, 3 V empty
  auto bar = [&](int i, int s) { return bars + 8 * (1 + i * STAGES + s); };

  const int bh = blockIdx.x;                     // b * Hq + h
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / group;
  const int q0 = (static_cast<int>(gridDim.y) - 1
                  - static_cast<int>(blockIdx.y)) * TC_BM;
  const bool two = q0 + 64 < S;                  // warpgroup 1 has rows < S
  const int n_kt = tiles_for(two ? q0 + 64 : q0, S, causal);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), 1);
      mbar_init(bar(2, s), two ? 8 : 4);         // one lane a consumer warp
      mbar_init(bar(3, s), two ? 8 : 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer: one thread issues every TMA load; the warpgroup
    // hands its registers to the consumers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 256) {
      mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
      for (int c = 0; c < NCQ; ++c)
        tma_load_4d(q_s + c * TC_BM * TC_ROW_BYTES, &tq, q_full, 64 * c, q0,
                    h, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % STAGES;
        const uint32_t parity = ((t / STAGES) - 1) & 1;
        const uint32_t k_dst = kv_s + s * (K_BYTES + V_BYTES);
        const uint32_t v_dst = k_dst + K_BYTES;
        if (t >= STAGES) mbar_wait(bar(2, s), parity);
        mbar_expect_tx(bar(0, s), K_BYTES);
#pragma unroll
        for (int c = 0; c < NCQ; ++c)
          tma_load_4d(k_dst + c * TC_BN * TC_ROW_BYTES, &tk, bar(0, s),
                      64 * c, t * TC_BN, kvh, b);
        if (t >= STAGES) mbar_wait(bar(3, s), parity);
        mbar_expect_tx(bar(1, s), V_BYTES);
#pragma unroll
        for (int c = 0; c < NCV; ++c)
          tma_load_4d(v_dst + c * TC_BN * TC_ROW_BYTES, &tv, bar(1, s),
                      64 * c, t * TC_BN, kvh, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows row0 .. row0 + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = tid >> 7;
    const int row0 = q0 + 64 * wg;
    if (row0 >= S) return;
    const int n_w = tiles_for(row0, S, causal);
    const int lane = tid & 31;
    Rows st;
    st.quad = lane & 3;
    st.ra = row0 + 16 * ((tid >> 5) & 3) + (lane >> 2);   // and ra + 8
    float o[HDV / 2];
    float sc[TC_BN / 2];    // S of the newest tile, then its float32 p
    uint32_t pa[TC_BN / 16][4];   // bf16 p of the tile whose PV is queued
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < TC_BN / 2; ++i) sc[i] = 0.f;
    const uint32_t q_wg = q_s + wg * 64 * TC_ROW_BYTES;
    auto k_tile = [&](int t) {
      return kv_s + (t % STAGES) * (K_BYTES + V_BYTES);
    };
    auto parity = [&](int t) { return static_cast<uint32_t>(t / STAGES) & 1; };
    // a warp frees a buffer once its wgmma reads of it are done: one lane
    // arrives for the warp
    auto release = [&](uint32_t b) {
      __syncwarp();
      if (lane == 0) mbar_arrive(b);
    };
    auto masked = [&](int t) {    // only the diagonal and a ragged tile
      const int k0 = t * TC_BN;
      return k0 + TC_BN > S || (causal && k0 + TC_BN - 1 > row0);
    };
    mbar_wait(q_full, 0);

    // tile 0: S, then its softmax (O is still 0, so no rescale)
    mbar_wait(bar(0, 0), 0);
    fence_regs(sc);
    wgmma_fence();
    issue_qk<HDQK>(sc, q_wg, k_tile(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    release(bar(2, 0));
    st.softmax(sc, 0, masked(0), S, causal, scale_log2);
    pack_p(sc, pa);

    // steady state: S of tile t runs beside PV of tile t - 1; the softmax
    // of tile t overlaps that PV, then O is rescaled once the PV is done
    for (int t = 1; t < n_w; ++t) {
      mbar_wait(bar(0, t % STAGES), parity(t));
      mbar_wait(bar(1, (t - 1) % STAGES), parity(t - 1));
      fence_regs(sc);
      fence_regs(o);
      wgmma_fence();
      issue_qk<HDQK>(sc, q_wg, k_tile(t));
      wgmma_commit();
      issue_pv<HDV>(o, pa, k_tile(t - 1) + K_BYTES);
      wgmma_commit();
      wgmma_wait<1>();                      // S of tile t is ready
      fence_regs(sc);
      release(bar(2, t % STAGES));          // K of tile t is free
      st.softmax(sc, t * TC_BN, masked(t), S, causal, scale_log2);
      wgmma_wait<0>();                      // PV of tile t - 1 is done
      fence_regs(o);
      release(bar(3, (t - 1) % STAGES));    // V of tile t - 1 is free
#pragma unroll
      for (int j = 0; j < HDV / 8; ++j) {
        o[4 * j] *= st.corr_a;
        o[4 * j + 1] *= st.corr_a;
        o[4 * j + 2] *= st.corr_b;
        o[4 * j + 3] *= st.corr_b;
      }
      pack_p(sc, pa);
    }
    mbar_wait(bar(1, (n_w - 1) % STAGES), parity(n_w - 1));
    fence_regs(o);
    wgmma_fence();
    issue_pv<HDV>(o, pa, k_tile(n_w - 1) + K_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    release(bar(3, (n_w - 1) % STAGES));

    // epilogue: l over the quad, out = acc / max(l, 1e-30) in bf16
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      st.l_a += __shfl_xor_sync(0xffffffffu, st.l_a, off);
      st.l_b += __shfl_xor_sync(0xffffffffu, st.l_b, off);
    }
    const float den_a = fmaxf(st.l_a, 1e-30f), den_b = fmaxf(st.l_b, 1e-30f);
    const int ra = st.ra;
    __nv_bfloat16* dst = out + b * osb + h * osh + 2 * st.quad;
    if (ra < S) {
      __nv_bfloat16* row = dst + ra * oss;
#pragma unroll
      for (int j = 0; j < HDV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(o[4 * j] / den_a, o[4 * j + 1] / den_a);
    }
    if (ra + 8 < S) {
      __nv_bfloat16* row = dst + (ra + 8) * oss;
#pragma unroll
      for (int j = 0; j < HDV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2] / den_b, o[4 * j + 3] / den_b);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query so that the library links without -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 4-D map over (hd, S, H, B) with element strides (1, ss, sh, sb), boxes of
// 64 columns x `rows` rows, 128-byte swizzle, zeros outside the tensor.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int hd,
              int S, int H, int B, long long sb, long long sh, long long ss,
              int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDQK, int HDV>
int launch_tc(const CUtensorMap& mq, const CUtensorMap& mk,
              const CUtensorMap& mv, void* out, long long osb, long long osh,
              long long oss, int B, int Hq, int Hkv, int S, int causal,
              float scale_log2, cudaStream_t stream) {
  const int smem = tc_smem_bytes(HDQK, HDV, tc_stages(HDQK, HDV));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<HDQK, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid(B * Hq, (S + TC_BM - 1) / TC_BM);
  flash_attention_tc_kernel<HDQK, HDV><<<grid, TC_THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), osb, osh, oss, S, Hq,
      Hq / Hkv, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Enqueues one K7 "tc" launch on `stream`; returns the CUDA error code (0
// on success; cudaErrorInvalidValue for a (hd, hd_v) other than (64, 64),
// (128, 128) or (192, 128), or a tensor map the driver refuses,
// cudaErrorNotSupported without the driver's cuTensorMapEncodeTiled). q
// and k are (.., hd), v and out (.., hd_v), all bfloat16 with element
// strides (batch, head, row) and a contiguous last dimension; `scale` is
// hd^-0.5. The wrapper (kernels/flash_attention.py) checks shapes, strides
// (multiples of 8 elements), 16-byte alignment and the grid's limits.
int flash_attention_tc(const void* q, const void* k, const void* v,
                       void* out, int B, int Hq, int Hkv, int S, int hd,
                       int hd_v, int causal, float scale, long long qsb,
                       long long qsh, long long qss, long long ksb,
                       long long ksh, long long kss, long long vsb,
                       long long vsh, long long vss, long long osb,
                       long long osh, long long oss, void* stream) {
#define TC_IS(HDQK, HDV) || (hd == HDQK && hd_v == HDV)
  if (!(false TC_SHAPES(TC_IS)))
    return static_cast<int>(cudaErrorInvalidValue);
#undef TC_IS
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  if (!make_map(encode, &mq, q, hd, S, Hq, B, qsb, qsh, qss, TC_BM)
      || !make_map(encode, &mk, k, hd, S, Hkv, B, ksb, ksh, kss, TC_BN)
      || !make_map(encode, &mv, v, hd_v, S, Hkv, B, vsb, vsh, vss, TC_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = static_cast<float>(
      static_cast<double>(scale) * 1.4426950408889634);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TC_RUN(HDQK, HDV)                                                 \
  if (hd == HDQK && hd_v == HDV)                                          \
    return launch_tc<HDQK, HDV>(mq, mk, mv, out, osb, osh, oss, B, Hq, Hkv, \
                                S, causal, scale_log2, s);
  TC_SHAPES(TC_RUN)
#undef TC_RUN
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
