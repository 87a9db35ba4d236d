// Helpers shared by the packed XNOR kernels (xnor_matmul.cu, xnor_conv.cu,
// xnor_conv_fused.cu).
//
// Bit layout (src/repro_torch/core/bitpack.py): bit i of a packed int32
// word holds element i of its 32-element group, LSB first, 1 = +1, 0 = -1.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr size_t SMEM_LIMIT = 232448;  // H100 opt-in shared memory / block
constexpr int MAX_CLUSTER = 8;         // portable thread-block cluster size

// Eq. 8 epilogue shared by the kernels: agree-count y -> int32 count, or
// -> int8 bit (y >= c) XOR flip when thresholds are given (c != null).
__device__ __forceinline__ void store_output(void* out, size_t idx, int y,
                                             const float* c,
                                             const uint8_t* flip, int ch) {
  if (c != nullptr) {
    const bool ge = static_cast<float>(y) >= c[ch];
    static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(ge != (flip[ch] != 0));
  } else {
    static_cast<int32_t*>(out)[idx] = y;
  }
}

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

}  // namespace repro
