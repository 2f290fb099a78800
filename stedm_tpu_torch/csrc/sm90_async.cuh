// Hopper building blocks shared by the kernels of csrc/: register
// reallocation between warpgroups, mbarriers, TMA tile loads and bulk copies,
// named barriers, quad reductions, distributed shared memory (the flash
// kernels' exchanges across a cluster), the host-side tensor maps built
// from a tensor's strides, and the launch and occupancy query of a
// thread-block cluster kernel.
//
// Shared-memory tiles are kept as sub-tiles of 64 bf16 columns (128 bytes, one
// row of the 128-byte swizzle; the bf16 flash forward at Dh 32: 32 columns in
// the 64-byte swizzle), the layout the wgmma descriptors of wgmma_sm90.cuh
// read.

#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int WG = 128;             // threads of a warpgroup
constexpr int SUB = 64;             // columns of a sub-tile: 128 bytes, one swizzle row
constexpr int ROW_BYTES = SUB * 2;

template <int REGS>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Spin until the barrier has left the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box {the map's columns and rows, 1, 1} at (col, row, head, batch)
// into shared memory; its bytes are counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
         "r"(head), "r"(batch)
      : "memory");
}

// `bytes` (a multiple of 16) from a 16-byte-aligned global address into shared
// memory; the bytes are counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

// Bulk copies from shared to global memory, tracked by bulk groups: a plain
// store, and an fp32 add performed at the L2 (each element atomically).
// `bytes` a multiple of 16, both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until the committed bulk groups have read their shared memory ...
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... or until they are complete, their writes performed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Barrier among the 256 consumer threads, 0 .. 255 (id 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(2 * WG) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Distributed shared memory, for the flash kernels' head-dimension split
// across a cluster: an address of this block's shared memory as the same
// offset in rank `rank`'s, 16-byte loads from there, arrivals on an
// mbarrier there (release at cluster scope), and a wait on this block's
// mbarrier that acquires at cluster scope what the arrivals released.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint4 ld_cluster_u4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(addr) : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// This block's rank in its cluster and the cluster's index along x, read
// where they are needed: a value derived from blockIdx at the start of a
// kernel (blockIdx.x % 5, say) is held in a register through the whole
// kernel, which a consumer at its register budget spills.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_index_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
}

// Every thread of the cluster (not warp-aligned: the producer's idle lanes
// arrive from another path than its loading lane).
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// A named barrier among the `n` threads of a consumer group (id > 0; 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void group_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// One arrival on mbarrier `bar` of every rank of the cluster after a
// group_sync of the signalling group: lane r of its first warp (`lane` < CL)
// arrives on rank r. The release is cumulative, so it publishes what the
// whole group wrote, or read, before the barrier. A release waits until the
// thread's earlier memory operations have been performed, so one thread
// arriving on every rank in turn pays a round trip per rank; an arrival
// from every thread contends on each barrier's word.
template <int CL>
__device__ __forceinline__ void signal_ranks(uint32_t bar, int lane) {
  if (lane < CL) mbar_arrive_cluster(map_rank(bar, lane));
}

// The sum over the cluster's CL ranks, in rank order, of N float4 a thread
// kept in the exchange buffer at `xch` (slot f at xch + f * 128 * 16, this
// thread's first slot): every rank gets the same bits. A slot's loads are
// issued before its first add, at most G at a time (clusters of 5 to 8 at
// Dh 640 to 1024: eight in flight hold 32 registers beside the consumers'
// accumulators).
template <int N, int CL, int G = (CL < 4 ? CL : 4)>
__device__ __forceinline__ void sum_ranks(float4 (&v)[N], uint32_t xch) {
#pragma unroll
  for (int f = 0; f < N; ++f) {
#pragma unroll
    for (int r0 = 0; r0 < CL; r0 += G) {
      float4 t[G];
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (r0 + i < CL) t[i] = ld_cluster_f4(map_rank(xch + f * 128 * 16, r0 + i));
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (r0 + i >= CL) continue;
        if (r0 + i == 0) {
          v[f] = t[0];
        } else {
          v[f].x += t[i].x;
          v[f].y += t[i].y;
          v[f].z += t[i].z;
          v[f].w += t[i].w;
        }
      }
    }
  }
}

// sum_ranks's sum of one slot at `at` for its owner in a reduce-scatter:
// rank `rank`'s own term is `own`, kept in registers (its slot of the
// exchange buffer holds the sums), the other ranks' are read from their
// buffers; the same adds in the same order, so the same bits.
template <int CL, int G = (CL < 4 ? CL : 4)>
__device__ __forceinline__ float4 sum_ranks_own(uint32_t at, int rank, float4 own) {
  float4 v;
#pragma unroll
  for (int r0 = 0; r0 < CL; r0 += G) {
    float4 t[G];
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (r0 + i < CL && r0 + i != rank) t[i] = ld_cluster_f4(map_rank(at, r0 + i));
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (r0 + i >= CL) continue;
      const float4 x = r0 + i == rank ? own : t[i];
      if (r0 + i == 0) {
        v = x;
      } else {
        v.x += x.x;
        v.y += x.y;
        v.z += x.z;
        v.w += x.w;
      }
    }
  }
  return v;
}

// SMs of the current device, asked once (the cards of one host are alike).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library links no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 [B, H, T, D] tensor with element strides s = {batch, head, token} as
// the 4-D map {D, T, H, B}, read in boxes of `cols` columns (64: the 128-byte
// swizzle; 32: the 64-byte one) x `rows` tokens; rows past T, and columns
// past D (D = 32 in a 64-column box, which the flash backward runs padded to
// 64), arrive as zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int b, int h, int t, int d,
                     const int64_t* s, int rows, int cols = SUB) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2, (cuuint64_t)s[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == SUB ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A launch of `grid` blocks of `threads` threads with `smem` bytes of dynamic
// shared memory in clusters of `cluster` along x; `attr` holds the cluster
// attribute the returned config points to.
inline cudaLaunchConfig_t cluster_launch(cudaLaunchAttribute* attr, int grid, int threads,
                                         int cluster, int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `cluster` blocks of `kernel` (`threads` threads, `smem` bytes of
// dynamic shared memory each) that the device holds at once
// (cudaOccupancyMaxActiveClusters), or a negative cudaError_t.
template <typename Kernel>
inline int max_active_clusters(Kernel kernel, int threads, int cluster, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch(&attr, cluster, threads, cluster, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace sm90
