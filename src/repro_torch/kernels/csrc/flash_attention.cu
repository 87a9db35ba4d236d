// Causal / non-causal GQA flash attention for Hopper (sm_90a): kernel K7.
//
// Contract:
//   q   (B, Hq, S, hd)  float32 or bfloat16, contiguous, head-major;
//   k,v (B, Hkv, S, hd) in q's dtype, Hq % Hkv == 0: query head h reads kv
//       head h / (Hq / Hkv), without a copy of the kv heads;
//   out (B, Hq, S, hd) in q's dtype;
//   out[q] = sum_k softmax_k(scale * q . k) v[k] over the keys k < S and,
//   when causal, k <= q. hd <= 256.
// Arithmetic, as the TPU kernel does it: q is multiplied by scale =
// hd**-0.5 (rounded to float32 by the caller) in float32 before the QK
// product; scores in float32; a masked score is -1e30; an online softmax
// keeps a running max m and a rescaled sum l per row; p = exp(s - m) is
// rounded to v's dtype (round to nearest even) before the PV product while
// l sums the unrounded float32 p; float32 accumulation; out = acc /
// max(l, 1e-30), stored in q's dtype. Keys are masked at the true S: no
// padded key ever joins the softmax. Its plain version,
// src/repro_torch/kernels/ref.py::flash_attention_ref, sums in another
// order (float32, allclose).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
//   (_flash_kernel), whose program owns one (q_block, hd) query tile of
//   one (batch, head), keeps the whole score pipeline in VMEM and stops its
//   KV loop at the diagonal when causal.
// Bound on the H100: the prefill shape (B, Hq, Hkv, hd) = (1, 32, 8, 128)
//   at S = 4096 reads and writes 84 MB (0.025 ms at 3.35 TB/s) and does
//   1.4e11 FLOP causally (0.139 ms at the 989 TFLOP/s bf16 tensor-core
//   rate): operations bound it. This first form runs on the CUDA cores in
//   float32 (67 TFLOP/s peak), so it sits far above that bound; the
//   tensor-core form (wgmma on 64-row tiles, TMA loads, a warp-specialised
//   pipeline) is a later change.
// Design: one block of 256 threads per (b * Hq + h, 64-row query tile),
//   the heaviest (latest) query tiles launched first. The block stages its
//   query tile, already scaled, in shared memory as float32, then loops
//   over 64-row K/V tiles staged there too, and stops at the diagonal tile
//   when causal: tiles above it are never read. Per KV tile: (1) each
//   thread computes a 4 x 4 block of scores (rows tr + 16 i, columns
//   tc + 16 j) by FMA over hd, with Q and K rows padded to hd + 1 floats so
//   the 16 key rows a warp reads sit in 16 banks; (2) each warp runs the
//   online softmax of 8 rows, a lane per two columns, with shuffle
//   reductions, and overwrites the scores with p; (3) each thread rescales
//   and accumulates its 4 rows x hd/16 columns of the output in registers.
//   Rows and keys past S are staged as zeros and never stored. Every
//   processed tile keeps at least one key of every row < S (the diagonal
//   tile holds key q0 <= q; a non-causal tile starts below S), so the
//   running max is finite after the first tile and a masked score's
//   exp(-1e30 - m) is exactly 0. At hd = 128 the block needs 116 KB of
//   shared memory, so the launcher raises the dynamic shared-memory limit.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FA_TQ = 64;          // query rows per block
constexpr int FA_TK = 64;          // key rows per KV tile
constexpr int FA_PS = FA_TK + 1;   // padded row stride of the score tile
constexpr int FA_THREADS = 256;    // 16 x 16 thread grid
constexpr float FA_NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// p as the PV product sees it: rounded to v's dtype
__device__ __forceinline__ float round_p(float p, const float*) { return p; }
__device__ __forceinline__ float round_p(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

size_t smem_bytes(int hd) {
  return sizeof(float) *
         (static_cast<size_t>(FA_TQ + FA_TK) * (hd + 1)   // Q, K
          + static_cast<size_t>(FA_TK) * hd               // V
          + static_cast<size_t>(FA_TQ) * FA_PS            // scores / p
          + 3 * FA_TQ);                                   // m, l, corr
}

// NJ = output columns per thread (hd <= 16 * NJ)
template <typename T, int NJ>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int Hq, int Hkv, int S, int hd, int causal,
                       float scale) {
  extern __shared__ float smem[];
  const int qs = hd + 1;                     // padded Q / K row stride
  float* q_s = smem;                         // [FA_TQ][qs]
  float* k_s = q_s + FA_TQ * qs;             // [FA_TK][qs]
  float* v_s = k_s + FA_TK * qs;             // [FA_TK][hd]
  float* p_s = v_s + FA_TK * hd;             // [FA_TQ][FA_PS]
  float* m_s = p_s + FA_TQ * FA_PS;          // running max per row
  float* l_s = m_s + FA_TQ;                  // running sum per row
  float* c_s = l_s + FA_TQ;                  // this tile's rescale per row

  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_qt = (S + FA_TQ - 1) / FA_TQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * FA_TQ;
  const int bh = blockIdx.y;                 // b * Hq + h
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const size_t q_base = static_cast<size_t>(bh) * S * hd;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + kvh) * S * hd;

  for (int i = tid; i < FA_TQ * hd; i += FA_THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int qp = q0 + r;
    q_s[r * qs + d] =
        qp < S ? to_f32(q[q_base + static_cast<size_t>(qp) * hd + d]) * scale
               : 0.f;
  }
  if (tid < FA_TQ) {
    m_s[tid] = FA_NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_kt_all = (S + FA_TK - 1) / FA_TK;
  const int n_kt = causal ? min(n_kt_all, (q0 + FA_TQ + FA_TK - 1) / FA_TK)
                          : n_kt_all;
  __syncthreads();

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * FA_TK;
    for (int i = tid; i < FA_TK * hd; i += FA_THREADS) {
      const int r = i / hd, d = i - r * hd;
      const int kp = k0 + r;
      const size_t off = kv_base + static_cast<size_t>(kp) * hd + d;
      k_s[r * qs + d] = kp < S ? to_f32(k[off]) : 0.f;
      v_s[r * hd + d] = kp < S ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // (1) scores of rows tr + 16 i against keys tc + 16 j, masked
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(tr + 16 * i) * qs + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tc + 16 * j) * qs + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const int kp = k0 + c;
        const bool keep = kp < S && (!causal || q0 + r >= kp);
        p_s[r * FA_PS + c] = keep ? sc[i][j] : FA_NEG_INF;
      }
    }
    __syncthreads();

    // (2) online softmax: warp w owns rows 8w .. 8w + 7
    for (int rr = 0; rr < FA_TQ / 8; ++rr) {
      const int r = warp * (FA_TQ / 8) + rr;
      float* row = p_s + r * FA_PS;
      const float s0 = row[lane], s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      row[lane] = round_p(p0, v);
      row[lane + 32] = round_p(p1, v);
      __syncwarp();                          // every lane has read m_old
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // (3) acc = acc * corr + p V over this tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[tr + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < FA_TK; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(tr + 16 * i) * FA_PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tc + 16 * j;
        vv[j] = d < hd ? v_s[c * hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();                         // before the next tile's load
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const int qp = q0 + r;
    if (qp >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* dst = out + q_base + static_cast<size_t>(qp) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tc + 16 * j;
      if (d < hd) store(dst + d, acc[i][j] / l);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int S, int hd, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid((S + FA_TQ - 1) / FA_TQ, B * Hq);
  flash_attention_kernel<T, NJ><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, S, hd, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int Hq, int Hkv, int S, int hd, int causal, float scale,
              cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 2>(q, k, v, out, B, Hq, Hkv, S, hd, causal, scale,
                        stream);
  if (hd <= 64)
    return launch<T, 4>(q, k, v, out, B, Hq, Hkv, S, hd, causal, scale,
                        stream);
  if (hd <= 128)
    return launch<T, 8>(q, k, v, out, B, Hq, Hkv, S, hd, causal, scale,
                        stream);
  return launch<T, 16>(q, k, v, out, B, Hq, Hkv, S, hd, causal, scale,
                       stream);
}

}  // namespace

extern "C" {

// Enqueues one K7 launch on `stream`; returns the CUDA error code (0 on
// success). `bf16` != 0: q, k, v and out are bfloat16, else float32. The
// wrapper (kernels/flash_attention.py) checks shapes, S >= 1, hd <= 256
// and B * Hq <= 65535.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Hq, int Hkv, int S, int hd, int causal,
                    int bf16, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, hd, causal,
                                    scale, s);
  return launch_hd<float>(q, k, v, out, B, Hq, Hkv, S, hd, causal, scale, s);
}

}  // extern "C"
