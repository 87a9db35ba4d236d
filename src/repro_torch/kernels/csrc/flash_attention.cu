// Causal / non-causal GQA flash attention on Hopper's CUDA cores (sm_90a):
// kernel K7, variant "simt" (float32 at every hd, bf16 at the hd that the
// tensor-core variant, csrc/flash_attention_tc.cu, does not take).
//
// Contract:
//   q   (B, Hq, S, hd)  float32 or bfloat16, contiguous, head-major;
//   k,v (B, Hkv, S, hd) in q's dtype, Hq % Hkv == 0: query head h reads kv
//       head h / (Hq / Hkv), without a copy of the kv heads;
//   out (B, Hq, S, hd) in q's dtype;
//   out[q] = sum_k softmax_k(scale * q . k) v[k] over the keys k < S and,
//   when causal, k <= q. hd <= 256, and a row of hd elements fills whole
//   16-byte units: hd % 4 == 0 in float32, hd % 8 == 0 in bf16, and every
//   pointer 16-byte aligned (the wrapper pads hd with zero columns and
//   copies an unaligned operand).
// Arithmetic, as the TPU kernel does it: q is multiplied by scale =
// hd**-0.5 of the unpadded hd (rounded to float32 by the caller) in
// float32 before the QK product; scores in float32; a masked score is
// -1e30; an online softmax keeps a running max m and a rescaled sum l
// per row; p = exp(s - m) is rounded to v's dtype (round to nearest even)
// before the PV product while l sums the unrounded float32 p; float32
// accumulation; out = acc / max(l, 1e-30), stored in q's dtype. Keys are
// masked at the true S: no padded key ever joins the softmax. Its plain
// version, src/repro_torch/kernels/ref.py::flash_attention_ref, sums in
// another order (float32, allclose).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
//   (_flash_kernel), whose program owns one (q_block, hd) query tile of
//   one (batch, head), keeps the whole score pipeline in VMEM and stops its
//   KV loop at the diagonal when causal.
// Bound on the H100: float32 stays off the tensor cores (TF32 would break
//   the float32 card-vs-CPU check of the full-width model), so the 4 * hd
//   FLOP of every kept (query, key) pair run at the 67 TFLOP/s FFMA rate:
//   at (B, Hq, Hkv, hd) = (2, 32, 8, 128), S = 256, causal, 1.08e9 FLOP
//   take 0.0161 ms and the 8.4 MB of q, k, v and out 0.0025 ms at
//   3.35 TB/s; at (1, 32, 8, 128), S = 4096, 1.37e11 FLOP take 2.05 ms.
//   Operations bound it, so the design keeps the FMA pipe fed: every other
//   instruction takes a scheduler slot from it.
// Design: one block of 4 warps per (b * Hq + h, 64-row query tile), on a
//   grid of (B * Hq, query tiles) with the heaviest (latest) query tiles
//   first. hd is a template constant per bucket (64, 96, 112, 128, 192,
//   256; a smaller hd runs in the next bucket with zero columns), and so
//   is the KV tile width TK: 64 where two blocks of 64 keys fit an SM's
//   shared memory, else 32 (kv_tile). The block stages its query tile once,
//   scaled, as float32; K and V tiles go through a ring of FA_STAGES
//   buffers in the input's dtype (bf16 stays bf16, half the bytes) by
//   16-byte cp.async with zero fill past S and hd, the next tile's copies
//   in flight while the current one is computed; one block barrier a tile.
//   Warp w owns query rows 16w .. 16w + 15, and a lane = 4 kg + rg owns
//   rows rg + 4i (i < 4) against keys kg + 8j (j < TK / 8): (1) scores in
//   a 4 x TK/8 register tile over d in steps of 4: the 4 rows' q as
//   LDS.128 and each key's k as LDS.128 (float32) or LDS.64 (bf16,
//   widened in registers), from rows padded by 16 bytes so the 8 keys or 4
//   rows a load touches sit in distinct bank groups; (2) the online
//   softmax in registers: a row's max and sum take 3 shfl.xor over its 8
//   lanes, m and l stay in registers, and p goes to a warp-private slice
//   of shared memory behind a __syncwarp; (3) O += p V with each lane's 4
//   rows x hd/8 columns in registers (p read as LDS.128 over 4 keys, V
//   rows as 8- or 16-byte chunks). A warp skips a KV tile that lies wholly
//   above its own diagonal, and masks only a tile that crosses it or S.
//   Every processed tile keeps at least one key of every row (the first
//   tile holds key 0), so the running max is finite after the first tile
//   and a masked score's exp(-1e30 - m) is exactly 0. Shared memory
//   (simt_smem_bytes, mirrored by kernels/flash_attention.py::
//   simt_smem_bytes): float32 at hd 128 takes 110,592 bytes (TK 32), so
//   two blocks hold an SM up to hd 128; hd 192 and 256 in float32 hold
//   one.
// What holds it on the H100 (700 W), as its times fit: shared memory's
//   delivery to the registers, 128 bytes a clock per SM counted per lane
//   even where lanes share an address, against 128 FFMA a clock. A lane's
//   4 x 4 score tile (float32, TK 32) loads 8 words per 16 FFMA and its
//   PV step 20 per 64, 2.46 FFMA a word over a tile: at most 62% of the
//   FFMA rate. At S = 4096 the kernel runs at about half its bound
//   (chip_smoke.py's K7 rows). A lane with 8 rows (32 rows a warp,
//   2 warps a block) loads fewer words per FFMA but needs 255 registers
//   at hd 128 and leaves one warp per scheduler, and was slower.
#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

constexpr int FA_TQ = 64;                 // query rows per block
constexpr int FA_R = 4;                   // query rows a lane holds
constexpr int FA_WARPS = FA_TQ / (4 * FA_R);  // 16 query rows a warp
constexpr int FA_THREADS = 32 * FA_WARPS;
constexpr int FA_STAGES = 2;              // depth of the K/V ring
constexpr int FA_PPAD = 8;                // floats of padding per p row
constexpr size_t FA_SMEM_SM = 233472;     // shared memory of an SM
constexpr size_t FA_SMEM_RESERVED = 1024; // the runtime's share per block
constexpr int FA_MAX_DEVICES = 64;        // devices whose attributes are kept
constexpr float FA_NEG_INF = -1e30f;

// Shared memory of one block: the float32 Q tile (rows padded by 16
// bytes), FA_STAGES K tiles (rows padded by 16 bytes) and V tiles in the
// input's dtype, and the p slices of the 4 warps.
__host__ __device__ constexpr size_t simt_smem_bytes(int hd, int tk,
                                                     int esize) {
  return 4 * static_cast<size_t>(FA_TQ) * (hd + 4) +
         static_cast<size_t>(FA_STAGES) * tk * (2 * hd * esize + 16) +
         4 * static_cast<size_t>(FA_TQ) * (tk + FA_PPAD);
}

// Keys per KV tile: 64 where two such blocks fit an SM, else 32.
__host__ __device__ constexpr int kv_tile(int hd, int esize) {
  return 2 * (simt_smem_bytes(hd, 64, esize) + FA_SMEM_RESERVED) <=
                 FA_SMEM_SM
             ? 64
             : 32;
}

// p as the PV product sees it: rounded to v's dtype
__device__ __forceinline__ float round_p(float p, const float*) { return p; }
__device__ __forceinline__ float round_p(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// bf16 pair word -> two floats (element 0 in the low half)
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// N consecutive elements at p (N * sizeof(T) of 4, 8 or 16 bytes, aligned
// to that) widened to float.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    static_assert(N == 4 || N == 2, "4 or 2 floats");
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p,
                                         float (&x)[N]) {
  if constexpr (N == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    x[0] = bf_lo(a.x); x[1] = bf_hi(a.x); x[2] = bf_lo(a.y);
    x[3] = bf_hi(a.y); x[4] = bf_lo(a.z); x[5] = bf_hi(a.z);
    x[6] = bf_lo(a.w); x[7] = bf_hi(a.w);
  } else if constexpr (N == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    x[0] = bf_lo(a.x); x[1] = bf_hi(a.x); x[2] = bf_lo(a.y);
    x[3] = bf_hi(a.y);
  } else if constexpr (N == 2) {
    const uint32_t a = *reinterpret_cast<const uint32_t*>(p);
    x[0] = bf_lo(a); x[1] = bf_hi(a);
  } else {
    static_assert(N == 8 || N == 4 || N == 2, "8, 4 or 2 bf16");
  }
}

// N floats stored to p in T (N * sizeof(T) bytes, aligned to that)
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ uint32_t bf_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&x)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf_pair(x[0], x[1]), bf_pair(x[2], x[3]));
  else
    *reinterpret_cast<uint32_t*>(p) = bf_pair(x[0], x[1]);
}

// 16-byte cp.async that reads `src_bytes` (16 or 0) and zero-fills the rest
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(repro::smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS, HD <= 128 ? 2 : 1)
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int Hq,
                  int Hkv, int S, int hd, int causal, float scale) {
  constexpr int ES = sizeof(T);
  constexpr int R = FA_R;
  constexpr int WR = 4 * R;                 // query rows a warp owns
  constexpr int TK = kv_tile(HD, ES);       // keys per KV tile
  constexpr int NK = TK / 8;                // keys per lane
  constexpr int EPC = 16 / ES;              // elements per 16-byte chunk
  constexpr int CH = HD / EPC;              // 16-byte chunks per row
  constexpr int QS = HD + 4;                // Q row stride (floats)
  constexpr int KS = HD + EPC;              // K row stride (elements)
  constexpr int PS = TK + FA_PPAD;          // p row stride (floats)
  constexpr int VEC = (HD / 8) % 4 == 0 ? 4 : 2;   // output columns a chunk
  constexpr int NC = HD / 8 / VEC;          // output chunks per lane
  // the PV loop over 4-key steps, unrolled whole in float32 up to hd 128,
  // else by 2 (whole, bf16 and hd >= 192 ran slower on the H100)
  constexpr int PV_UNROLL = sizeof(T) == 4 && HD <= 128 ? TK / 4 : 2;
  static_assert(HD % 16 == 0 && TK % 8 == 0, "bucket shapes");

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                 // [TQ][QS]
  T* ring = reinterpret_cast<T*>(q_s + FA_TQ * QS);  // [STAGES][K | V]
  float* p_all = reinterpret_cast<float*>(ring + FA_STAGES * TK * (KS + HD));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane & 3, kg = lane >> 2;
  const int n_qt = (S + FA_TQ - 1) / FA_TQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * FA_TQ;
  const int bh = blockIdx.x;                 // b * Hq + h
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const size_t q_base = static_cast<size_t>(bh) * S * hd;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + kvh) * S * hd;
  const int n_kt_all = (S + TK - 1) / TK;
  const int n_kt = causal ? min(n_kt_all, (q0 + FA_TQ + TK - 1) / TK)
                          : n_kt_all;

  // K/V tile t into ring slot t % FA_STAGES: 16-byte cp.async with zero
  // fill past S and hd
  auto stage = [&](int t) {
    T* ks = ring + (t % FA_STAGES) * TK * (KS + HD);
    T* vs = ks + TK * KS;
    const int k0 = t * TK;
    for (int i = tid; i < TK * CH; i += FA_THREADS) {
      const int r = i / CH, e = (i - r * CH) * EPC;
      const bool in = k0 + r < S && e < hd;
      const size_t off =
          in ? kv_base + static_cast<size_t>(k0 + r) * hd + e : 0;
      cp_async16_zfill(ks + r * KS + e, k + off, in ? 16 : 0);
      cp_async16_zfill(vs + r * HD + e, v + off, in ? 16 : 0);
    }
  };

#pragma unroll
  for (int t = 0; t < FA_STAGES - 1; ++t) {
    if (t < n_kt) stage(t);
    repro::cp_async_commit();
  }

  // the query tile, scaled in float32, zero past S and hd
  for (int r = warp; r < FA_TQ; r += FA_WARPS) {
    const int qp = q0 + r;
    float* dst = q_s + r * QS;
    const T* src = q + q_base + static_cast<size_t>(qp) * hd;
    for (int c = lane; c < CH; c += 32) {
      const int e = c * EPC;
      float x[EPC];
      if (qp < S && e < hd) {
        load_f32(src + e, x);
      } else {
#pragma unroll
        for (int u = 0; u < EPC; ++u) x[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < EPC; u += 4) {
        const float y[4] = {x[u] * scale, x[u + 1] * scale,
                            x[u + 2] * scale, x[u + 3] * scale};
        store_vec(dst + e + u, y);
      }
    }
  }

  const int qw0 = q0 + WR * warp;            // the warp's first row
  float* p_w = p_all + WR * warp * PS;       // the warp's p slice
  const float* q_w = q_s + (WR * warp + rg) * QS;
  float m[R], l[R], acc[R][NC * VEC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = FA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC * VEC; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_kt; ++t) {
    repro::cp_async_wait_group<FA_STAGES - 2>();   // my copies of tile t
    __syncthreads();          // everyone's; the slot of tile t - 1 is free
    if (t + FA_STAGES - 1 < n_kt) stage(t + FA_STAGES - 1);
    repro::cp_async_commit();

    const int k0 = t * TK;
    // a tile wholly above the warp's diagonal, or rows all past S
    if ((causal && k0 > qw0 + WR - 1) || qw0 >= S) continue;
    const T* ks = ring + (t % FA_STAGES) * TK * (KS + HD);
    const T* vs = ks + TK * KS;

    // (1) scores of rows rg + 4i against keys kg + 8j
    float s[R][NK];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float qv[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i) load_f32(q_w + 4 * i * QS + d, qv[i]);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        float kv[4];
        load_f32(ks + (kg + 8 * j) * KS + d, kv);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][j] = fmaf(qv[i][e], kv[e], s[i][j]);
      }
    }

    // (2) mask where the tile crosses S or the warp's diagonal, then the
    // online softmax; a row's 8 lanes are lanes rg + 4 kg
    if (k0 + TK > S || (causal && k0 + TK - 1 > qw0)) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const int kp = k0 + kg + 8 * j;
          if (kp >= S || (causal && qw0 + rg + 4 * i < kp))
            s[i][j] = FA_NEG_INF;
        }
    }
    float corr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < NK; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        s[i][j] = round_p(p, v);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j)
        p_w[(rg + 4 * i) * PS + kg + 8 * j] = s[i][j];
    __syncwarp();

    // (3) acc = acc * corr + p V over this tile: rows rg + 4i, columns
    // (kg + 8 c) * VEC .. + VEC - 1
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NC * VEC; ++j) acc[i][j] *= corr[i];
#pragma unroll(PV_UNROLL)
    for (int c0 = 0; c0 < TK; c0 += 4) {
      float pv[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i)
        load_f32(p_w + (rg + 4 * i) * PS + c0, pv[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const T* vrow = vs + (c0 + u) * HD + kg * VEC;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float vv[VEC];
          load_f32(vrow + 8 * VEC * c, vv);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][c * VEC + e] = fmaf(pv[i][u], vv[e], acc[i][c * VEC + e]);
        }
      }
    }
    __syncwarp();             // every lane has read p before the next tile
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = qw0 + rg + 4 * i;
    if (qp >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* dst = out + q_base + static_cast<size_t>(qp) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d0 = (kg + 8 * c) * VEC;
      float y[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[e] = acc[i][c * VEC + e] / li;
      if (d0 < hd) store_vec(dst + d0, y);
    }
  }
}

// Sets the instantiation's dynamic shared memory and carve-out once per
// device; later calls on that device only read the flag.
template <typename T, int HD>
cudaError_t configure(size_t* smem) {
  static std::atomic<bool> done[FA_MAX_DEVICES];
  *smem = simt_smem_bytes(HD, kv_tile(HD, sizeof(T)), sizeof(T));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const bool kept = err == cudaSuccess && dev < FA_MAX_DEVICES;
  if (kept && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_simt_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_simt_kernel<T, HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (kept) done[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int S, int hd, int causal, float scale,
           cudaStream_t stream) {
  size_t smem = 0;
  const cudaError_t err = configure<T, HD>(&smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (S + FA_TQ - 1) / FA_TQ);
  flash_simt_kernel<T, HD><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, S, hd, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// info = {blocks an SM, registers a thread, local (spill) bytes a thread,
// dynamic shared bytes, keys per KV tile, hd bucket}
template <typename T, int HD>
int query(int* info) {
  size_t smem = 0;
  cudaError_t err = configure<T, HD>(&smem);
  cudaFuncAttributes fa;
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&fa, flash_simt_kernel<T, HD>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_simt_kernel<T, HD>, FA_THREADS, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  info[0] = blocks;
  info[1] = fa.numRegs;
  info[2] = static_cast<int>(fa.localSizeBytes);
  info[3] = static_cast<int>(smem);
  info[4] = kv_tile(HD, sizeof(T));
  info[5] = HD;
  return 0;
}

// Calls F<T, bucket of hd>::run(args...) for the hd bucket of `hd`.
template <typename T, template <typename, int> class F, typename... A>
int by_bucket(int hd, A... args) {
  if (hd <= 64) return F<T, 64>::run(args...);
  if (hd <= 96) return F<T, 96>::run(args...);
  if (hd <= 112) return F<T, 112>::run(args...);
  if (hd <= 128) return F<T, 128>::run(args...);
  if (hd <= 192) return F<T, 192>::run(args...);
  return F<T, 256>::run(args...);
}

template <typename T, int HD>
struct Launch {
  static int run(const void* q, const void* k, const void* v, void* out,
                 int B, int Hq, int Hkv, int S, int hd, int causal,
                 float scale, cudaStream_t stream) {
    return launch<T, HD>(q, k, v, out, B, Hq, Hkv, S, hd, causal, scale,
                         stream);
  }
};

template <typename T, int HD>
struct Query {
  static int run(int* info) { return query<T, HD>(info); }
};

}  // namespace

extern "C" {

// Enqueues one K7 launch on `stream`; returns the CUDA error code (0 on
// success). `bf16` != 0: q, k, v and out are bfloat16, else float32. The
// wrapper (kernels/flash_attention.py) checks shapes, S >= 1, hd <= 256
// and the grid's limits, and hands over rows of whole 16-byte units (hd %
// 4 == 0 in float32, % 8 in bf16) at 16-byte aligned pointers.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Hq, int Hkv, int S, int hd, int causal,
                    int bf16, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return by_bucket<__nv_bfloat16, Launch>(hd, q, k, v, out, B, Hq, Hkv, S,
                                            hd, causal, scale, s);
  return by_bucket<float, Launch>(hd, q, k, v, out, B, Hq, Hkv, S, hd, causal,
                                  scale, s);
}

// The launch plan of the instantiation that runs hd in float32 (bf16 == 0)
// or bfloat16 on the current device, into info[6]: blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
// (spill) bytes a thread, dynamic shared bytes, keys per KV tile, the hd
// bucket. Returns the CUDA error code.
int flash_attention_simt_plan(int hd, int bf16, int* info) {
  if (bf16) return by_bucket<__nv_bfloat16, Query>(hd, info);
  return by_bucket<float, Query>(hd, info);
}

}  // extern "C"
