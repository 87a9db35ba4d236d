// Helpers shared by the packed XNOR kernels (xnor_matmul.cu, xnor_conv.cu,
// xnor_conv_fused.cu): a fast division, the 1-bit MMA, cp.async staging,
// the TMA bulk copy on an mbarrier, cluster barriers, cluster launches,
// and the carry-save XOR-popcount core of the CUDA-core kernels (K1, K3
// and K5 vpu).
//
// Bit layout (src/repro_torch/core/bitpack.py): bit i of a packed int32
// word holds element i of its 32-element group, LSB first, 1 = +1, 0 = -1.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

// Phase stamps for benchmarks/torch_vpu_phases.py. Built with REPRO_PHASES
// defined, REPRO_PHASE_TABLE(t), at file scope, defines a device table t of
// 8 + 8 words for each of up to 2^16 blocks and extern "C" t_read(dst,
// bytes), which copies it out; REPRO_PHASE(t, i), i = 0 .. 6, has thread 0
// of the block write %globaltimer (ns) into column i, its SM's %clock64
// into column 8 + i and its SM into column 7. Otherwise both are empty.
#ifdef REPRO_PHASES
#define REPRO_PHASE_TABLE(t)                                                \
  __device__ unsigned long long t[1 << 16][16];                             \
  extern "C" int t##_read(void* dst, size_t bytes) {                        \
    return static_cast<int>(cudaMemcpyFromSymbol(dst, t, bytes));           \
  }
#define REPRO_PHASE(t, i)                                                   \
  if (threadIdx.x == 0) {                                                   \
    const size_t b_ =                                                       \
        (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;     \
    unsigned long long now_;                                                \
    unsigned sm_;                                                           \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now_));                \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                        \
    t[b_][i] = now_;                                                        \
    t[b_][8 + (i)] = clock64();                                             \
    t[b_][7] = sm_;                                                         \
  }
#else
#define REPRO_PHASE_TABLE(t)
#define REPRO_PHASE(t, i)
#endif

namespace repro {

constexpr size_t SMEM_LIMIT = 232448;  // H100 opt-in shared memory / block
constexpr int MAX_CLUSTER = 8;         // portable thread-block cluster size

// D += popc(A AND B) over k = 256 bits, m16n8k256, packed 1-bit operands,
// int32 accumulators. Fragments are packed words as they lie (lane = 4 g +
// t): a[0] row g, k-word t; a[1] row g + 8, word t; a[2], a[3] the same
// rows at word t + 4; b0 column g, word t; b1 column g, word t + 4;
// acc[0..1] row g, columns 2t and 2t + 1; acc[2..3] row g + 8. The AND form
// runs at the full rate on sm_90a; the XOR form is several times slower
// (csrc/mma_probe.cu measures both). With an all-ones A fragment the MMA
// adds the popcount of column g's words to every row, and with b0 = b1 =
// ~0u the popcount of each row's words to every column: the popcounts of
// the and.popc correction come from the tensor cores too.
__device__ __forceinline__ void mma_and_popc(int (&acc)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The split cluster barrier: every thread of every block of the cluster
// arrives (release) and later waits (acquire); a block must not exit while
// a peer may still read or write its shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// log2 of a power of two (a shift replaces a division: a runtime integer
// division costs a chain of some twenty dependent instructions).
__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

// Walks the row-major index i = threadIdx.x, threadIdx.x + step, ... of
// an (rows x B x C) grid as (r, b, c), with divisions only to start.
struct Walk3 {
  int r, b, c, dr, db, dc, B, C;
  __device__ __forceinline__ Walk3(int B_, int C_, int step)
      : r(threadIdx.x / C_ / B_), b(threadIdx.x / C_ % B_), c(threadIdx.x % C_),
        dr(step / C_ / B_), db(step / C_ % B_), dc(step % C_), B(B_), C(C_) {}
  __device__ __forceinline__ void next() {
    c += dc;
    b += db;
    r += dr;
    if (c >= C) {
      c -= C;
      ++b;
    }
    if (b >= B) {
      b -= B;
      ++r;
    }
  }
};

// Start copying words [k0, k1) of `rows` rows into dst at row stride ds
// (words): row r comes from row_src(r), a pointer to the row's word 0, or
// null for a zero row; words from k1 up to k1 + zpad are zero-filled by
// plain stores. 16-byte cp.async where `vec` (every row 16-byte aligned,
// k0, k1 and ds multiples of 4), else 4-byte; the caller commits and waits.
// All `nthreads` threads of the block take part, each walking (row, unit)
// pairs nthreads apart.
template <class RowSrc>
__device__ __forceinline__ void stage_words(int rows, int k0, int k1,
                                            int zpad, bool vec,
                                            RowSrc row_src, uint32_t* dst,
                                            int ds, int nthreads) {
  const int kn = k1 - k0, width = kn + zpad;
  const int unit = vec ? 4 : 1;
  for (Walk3 i(1, (width + unit - 1) / unit, nthreads); i.r < rows;
       i.next()) {
    const int k = i.c * unit;
    uint32_t* d = dst + i.r * ds + k;
    const int32_t* s = row_src(i.r);
    if (s != nullptr && k < kn) {
      if (vec) cp_async16(d, s + k0 + k); else cp_async4(d, s + k0 + k);
    } else {
      for (int j = 0; j < unit && k + j < width; ++j) d[j] = 0u;
    }
  }
}

// Are rows of K words at `src` 16-byte aligned from word k0 on?
__device__ __forceinline__ bool rows_vec(const int32_t* src, int K, int k0,
                                         int k1, int ds) {
  return K % 4 == 0 && k0 % 4 == 0 && (k1 - k0) % 4 == 0 && ds % 4 == 0 &&
         reinterpret_cast<uintptr_t>(src) % 16 == 0;
}

// Launch `kernel` as clusters of shape `cluster` (grid a multiple of it).
// The kernel's dynamic shared memory limit is raised once per (kernel,
// device) to the most a block can take beside its static shared memory. A cluster shape the device cannot hold at this shared memory
// (cudaOccupancyMaxActiveClusters = 0) is refused with the CUDA error; the
// check runs once per (kernel, device, cluster shape) and larger shared
// memory. Not thread-safe: launches come from one host thread.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 cluster,
                   int threads, size_t smem, void* stream, Args... args) {
  struct Seen {
    const void* kernel;
    int dev, csize;
    size_t smem;
  };
  static Seen seen[64];
  static int n_seen;
  const void* key = reinterpret_cast<const void*>(kernel);
  const int csize = cluster.x + 16 * (cluster.y + 16 * cluster.z);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  bool raised = false;
  Seen* same = nullptr;
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].kernel != key || seen[i].dev != dev) continue;
    raised = true;
    if (seen[i].csize == csize) same = &seen[i];
  }
  if (!raised) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_LIMIT - fa.sharedSizeBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (same == nullptr || smem > same->smem) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (same != nullptr) {
      same->smem = smem;
    } else if (n_seen < 64) {
      seen[n_seen++] = Seen{key, dev, csize, smem};
    }
  }
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// x / d for 0 <= x < 2^31 by a multiply and a shift (Granlund and
// Montgomery): the host computes mul and shift once for a divisor d >= 1,
// so a block decodes its grid index without a runtime division.
struct FastDiv {
  uint32_t mul, shift;
};

inline FastDiv make_fastdiv(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  const uint64_t m = ((1ull << 32) * ((1ull << l) - d)) / d + 1;
  return FastDiv{static_cast<uint32_t>(m), l};
}

__device__ __forceinline__ uint32_t fastdiv(uint32_t x, const FastDiv& f) {
  return (__umulhi(x, f.mul) + x) >> f.shift;
}

// ---------------------------------------------- mbarrier + TMA bulk copy

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
// counted on bar; both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                  "r"(smem_u32(bar))
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// --------------------------------- the carry-save XOR-popcount core (vpu)

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

// One 16-byte unit (V = 4) of XOR words d of a position into its running
// carry-save state: two full adders (a LOP3 each for sum and carry) fold
// d[0..3] into `ones` and add the popcounts of the two carries to `twos`,
// so popc(ones) + 2 * twos keeps the sum of popc(d): 2 popcounts a unit
// instead of 4, for 4 more LOP3s (the popc pipe runs 16 lanes a clock per
// SM, LOP3 64).
__device__ __forceinline__ void csa_unit(uint32_t d0, uint32_t d1,
                                         uint32_t d2, uint32_t d3,
                                         uint32_t& ones, int& twos) {
  const uint32_t o = ones;
  const uint32_t c1 = (o & d0) | (o & d1) | (d0 & d1);
  const uint32_t s1 = o ^ d0 ^ d1;
  const uint32_t c2 = (s1 & d2) | (s1 & d3) | (d2 & d3);
  ones = s1 ^ d2 ^ d3;
  twos += __popc(c1) + __popc(c2);
}

// dis[j] += the sum over vector units u0 .. u1-1 (V words each) of
// popc(x XOR w): filter row f, its words in order, against the patch of
// position j, whose word 0 is src[base[j]]. A tap row of the filter is
// nrow units that lie contiguous in src; the next tap row starts src_row
// words further on. NROW > 0 fixes nrow at compile time. Every V-word load
// of f serves VP positions. With V = 4 each unit goes through csa_unit.
template <int V, int NROW, int VP>
__device__ __forceinline__ void xor_popc(const uint32_t* f,
                                         const uint32_t* src,
                                         const int (&base)[VP], int src_row,
                                         int nrow_rt, int u0, int u1,
                                         int (&dis)[VP]) {
  const int nrow = NROW > 0 ? NROW : nrow_rt;
  int dy = 0, r = u0;
  while (r >= nrow) {                // a K slice starts in tap row dy
    r -= nrow;
    ++dy;
  }
  int off = dy * src_row + r * V;
  const int skip = src_row - nrow * V;
  uint32_t ones[VP];
  int twos[VP];
#pragma unroll
  for (int j = 0; j < VP; ++j) {
    ones[j] = 0u;
    twos[j] = 0;
  }
  for (int u = u0; u < u1; ++u) {
    uint32_t w[V];
    load_words<V>(f + u * V, w);
#pragma unroll
    for (int j = 0; j < VP; ++j) {
      uint32_t x[V];
      load_words<V>(src + base[j] + off, x);
      if constexpr (V == 4) {
        csa_unit(x[0] ^ w[0], x[1] ^ w[1], x[2] ^ w[2], x[3] ^ w[3], ones[j],
                 twos[j]);
      } else {
        dis[j] += __popc(x[0] ^ w[0]);
      }
    }
    off += V;
    if (++r == nrow) {                               // next tap row
      r = 0;
      off += skip;
    }
  }
#pragma unroll
  for (int j = 0; j < VP; ++j) dis[j] += __popc(ones[j]) + 2 * twos[j];
}

// One pass's filter rows x positions over a block's WARPS warps. A warp
// unit is 32 filter rows (lane = row; rows 32 g + lane of f_s at stride ls)
// by VP positions (base(p): the patch start of position p), positions in nb
// blocks of VP. With at most WARPS / 2 units, K (nv units of V words) is
// split into ks (a power of 2) contiguous slices whose partial sums meet
// in red (shared-memory atomics; WARPS / 2 * 32 * VP ints, zero on entry
// and left zero). Item i = (slice, position block, row group), row group
// fastest, goes to warp i mod WARPS. epi(g, pb, dis) receives each unit's
// whole XOR-popcount sums, in all 32 lanes of one warp.
template <int WARPS, int VP, int V, int NROW, class Base, class Epi>
__device__ __forceinline__ void run_units(int groups, int nb,
                                          const uint32_t* f_s, int ls,
                                          const uint32_t* src, int src_row,
                                          int nrow, int nv, Base base,
                                          Epi epi, int* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int units = groups * nb;
  int ks = 1, lks = 0;
  while (2 * ks * units <= WARPS && 2 * ks <= nv) {
    ks *= 2;
    ++lks;
  }
  int grp = 0, pb = 0, sl = 0;
  for (int i = 0; i < units * ks; ++i) {
    if (i % WARPS == warp) {
      int b[VP], dis[VP];
#pragma unroll
      for (int j = 0; j < VP; ++j) {
        b[j] = base(pb * VP + j);
        dis[j] = 0;
      }
      xor_popc<V, NROW, VP>(f_s + (grp * 32 + lane) * ls, src, b, src_row,
                            nrow, (nv * sl) >> lks, (nv * (sl + 1)) >> lks,
                            dis);
      if (ks == 1) {
        epi(grp, pb, dis);
      } else {
#pragma unroll
        for (int j = 0; j < VP; ++j)
          atomicAdd(&red[((pb * groups + grp) * VP + j) * 32 + lane], dis[j]);
      }
    }
    if (++grp == groups) {
      grp = 0;
      if (++pb == nb) {
        pb = 0;
        ++sl;
      }
    }
  }
  if (ks > 1) {
    __syncthreads();
    grp = pb = 0;
    for (int i = 0; i < units; ++i) {
      if (i % WARPS == warp) {
        int dis[VP];
#pragma unroll
        for (int j = 0; j < VP; ++j) {
          int* r = &red[((pb * groups + grp) * VP + j) * 32 + lane];
          dis[j] = *r;
          *r = 0;                                    // clean for the next pass
        }
        epi(grp, pb, dis);
      }
      if (++grp == groups) {
        grp = 0;
        ++pb;
      }
    }
  }
}

}  // namespace repro
