// GroupNorm(+[B, C] add | +FiLM)(+SiLU) forward over NHWC x, one launch a call.
//
// Replaces the TPU kernel _gn_silu_pallas (stedm_tpu/ops/gn_silu.py:125, body
// _make_kernel :53). Semantics of gn_silu_reference there (:166-196): the
// optional per-sample add goes in before the statistics, in fp32; fp32
// statistics E[v^2] - E[v]^2 over each group of a sample; the affine, then FiLM
// y * (1 + scale) + shift, then SiLU; the output has x's dtype.
//
// What bounds it on the H100: device memory. The op reads x and writes y, with
// a handful of flops an element, so the bound is one read and one write.
//
// Design. The TPU kernel keeps a whole sample in VMEM; a Hopper block cannot,
// but a thread-block cluster can hold a (sample, channel block) slab in the
// shared memory of its CTAs, which read each other's through DSMEM:
//
// - a cluster owns one (sample, channel block) of whole groups; its CTAs split
//   the rows (the launch plan, ops/gn_silu.py, fixes every size);
// - phase 1: each CTA streams its rows x channel-block tile into shared memory
//   by TMA (3-D map {C, HW, B}, boxes of box_rows x box_cols), one mbarrier a
//   slot, and sums v and v^2 per channel in fp32 as the boxes land;
// - phase 2: the CTA folds its threads' sums per channel and the channels of
//   each group in channel order, then every CTA reads the group sums of all
//   ranks through DSMEM in rank order, so every CTA gets the same statistics
//   and a run gives the same bits every time (a cluster of one skips DSMEM);
// - phase 3: the CTA normalises its tile from shared memory and writes y with
//   16-byte stores, so x is read once and y written once.
//
// Where a CTA's tile does not fit (the VQ shapes of 17-67 MB a sample), its
// boxes stream through the slots as a ring (box j in slot j % slots) in phase
// 1 and are read again in phase 3, newest first: the last `slots` boxes are
// still there then, and go first.
//
// The kernel is templated over x's dtype (bf16, fp32), the mode (plain, add,
// FiLM) and SiLU; gamma/beta and the [B, C] vectors are read as bf16 or fp32
// by a flag, once a thread.

#include <cooperative_groups.h>

#include "sm90_async.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using sm90::mbar_wait;
using sm90::smem_u32;

constexpr int THREADS = 512;

enum Mode { PLAIN = 0, ADD = 1, FILM = 2 };

// Plan indices: the int array the wrapper passes (ops/gn_silu.py, _PLAN_KEYS).
enum PlanIdx {
  P_CG, P_WIDTH, P_COL_BLOCKS, P_CLUSTER, P_ROWS_PER_CTA, P_BOX_ROWS, P_BOX_COLS,
  P_BOXES_PER_STAGE, P_BOX_STRIDE, P_STAGE_STRIDE, P_SLOTS, P_ROW_PHASES,
  P_GROUPS_PER_BLOCK, P_RED_OFF, P_PART_OFF, P_GSTAT_OFF, P_BAR_OFF, P_SMEM, P_COUNT
};

struct Params {
  void* out;
  const void* gamma;
  const void* beta;
  const void* vec0;     // add, or FiLM's scale
  const void* vec1;     // FiLM's shift
  int hw, c, cg, width, col_blocks, cluster, rows_per_cta, box_rows, box_cols, boxes_per_stage;
  int box_stride, stage_stride, slots, row_phases, groups_per_block;
  int red_off, part_off, gstat_off, bar_off;
  uint32_t stage_tx;    // bytes a slot's boxes deliver
  float n, eps;         // elements of a group, epsilon
  int param_bf16, vec_bf16;
};

__device__ __forceinline__ float load_f(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// 16 bytes of T from shared memory as floats, and floats back to 16 bytes.
template <typename T> struct Vec;

template <> struct Vec<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const unsigned char* p, float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(void* p, const float* v) {
    uint4 raw;
    raw.x = sm90::pack_bf16x2(v[0], v[1]);
    raw.y = sm90::pack_bf16x2(v[2], v[3]);
    raw.z = sm90::pack_bf16x2(v[4], v[5]);
    raw.w = sm90::pack_bf16x2(v[6], v[7]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const unsigned char* p, float* v) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  static __device__ __forceinline__ void store(void* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// One TMA box {box_cols, box_rows, 1} at (col, row, sample) into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row, int sample) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
         "r"(sample)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int MODE, bool SILU>
__global__ void __launch_bounds__(THREADS, 1)
gn_silu_kernel(const __grid_constant__ CUtensorMap map_x, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  constexpr int VEC = Vec<T>::N;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / p.cluster;
  const int b = cid / p.col_blocks;
  const int c0 = (cid % p.col_blocks) * p.width;
  const int r0 = rank * p.rows_per_cta;
  const int rows = max(0, min(p.hw - r0, p.rows_per_cta));   // 0 for an empty last CTA
  const int nb = (rows + p.box_rows - 1) / p.box_rows;   // boxes of rows, box j in slot j % slots
  float* red = reinterpret_cast<float*>(smem + p.red_off);
  float* part = reinterpret_cast<float*>(smem + p.part_off);
  float* gstat = reinterpret_cast<float*>(smem + p.gstat_off);
  const uint32_t tiles = smem_u32(smem);
  const uint32_t bar0 = smem_u32(smem + p.bar_off);

  auto issue = [&](int j) {   // box j into its slot; thread 0 only
    const int s = j % p.slots;
    const uint32_t bar = bar0 + 8 * s;
    sm90::mbar_expect_tx(bar, p.stage_tx);
    for (int i = 0; i < p.boxes_per_stage; ++i)
      tma_load_3d(tiles + s * p.stage_stride + i * p.box_stride, &map_x, bar,
                  c0 + i * p.box_cols, r0 + j * p.box_rows, b);
  };
  uint32_t phase = 0;   // parity of each slot's barrier, the same in every thread
  auto wait = [&](int s) {
    mbar_wait(bar0 + 8 * s, (phase >> s) & 1u);
    phase ^= 1u << s;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < min(nb, p.slots); ++s) sm90::mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int j = 0; j < min(nb, p.slots); ++j) issue(j);

  // thread -> (16-byte column vector cv, row phase rp); rows rp, rp + row_phases, ...
  const int nvec = p.width / VEC;
  const bool active = threadIdx.x < p.row_phases * nvec;
  const int cv = threadIdx.x % nvec;
  const int rp = threadIdx.x / nvec;
  const int col = cv * VEC;   // block-local channel of the thread's first element
  const int row_bytes = p.box_cols * static_cast<int>(sizeof(T));
  const int thread_off = (col / p.box_cols) * p.box_stride + (col % p.box_cols) * sizeof(T);
  const size_t vbase = static_cast<size_t>(b) * p.c + c0 + col;

  // the thread's per-channel vectors, loaded now so that their latency hides
  // under phase 1
  float a[VEC], gm[VEC], bt[VEC], f1[VEC], f2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    a[k] = (MODE == ADD && active) ? load_f(p.vec0, vbase + k, p.vec_bf16) : 0.f;
    gm[k] = active ? load_f(p.gamma, c0 + col + k, p.param_bf16) : 0.f;
    bt[k] = active ? load_f(p.beta, c0 + col + k, p.param_bf16) : 0.f;
    f1[k] = (MODE == FILM && active) ? 1.f + load_f(p.vec0, vbase + k, p.vec_bf16) : 1.f;
    f2[k] = (MODE == FILM && active) ? load_f(p.vec1, vbase + k, p.vec_bf16) : 0.f;
  }

  // phase 1: sums of v and v^2 per channel as the boxes land
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
  for (int j = 0; j < nb; ++j) {
    const int s = j % p.slots;
    wait(s);
    if (active) {
      const int n_rows = min(p.box_rows, rows - j * p.box_rows);
      const unsigned char* base = smem + s * p.stage_stride + thread_off;
#pragma unroll 2
      for (int r = rp; r < n_rows; r += p.row_phases) {
        float v[VEC];
        Vec<T>::load(base + r * row_bytes, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float t = MODE == ADD ? v[k] + a[k] : v[k];
          s1[k] += t;
          s2[k] = fmaf(t, t, s2[k]);
        }
      }
    }
    if (j + p.slots < nb) {   // streaming: refill the slot once all have read it
      __syncthreads();
      if (threadIdx.x == 0) issue(j + p.slots);
    }
  }

  // phase 2: per channel, the CTA's row phases in order; per group, its
  // channels in order; then per group, every rank's sums in rank order, so
  // that every CTA of the cluster gets the same statistics
  if (active) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      red[rp * p.width + col + k] = s1[k];
      red[(p.row_phases + rp) * p.width + col + k] = s2[k];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < p.width; c += THREADS) {   // column c: this thread's alone
    float t1 = 0.f, t2 = 0.f;
#pragma unroll 8   // the loads issue together; the sum keeps its order
    for (int i = 0; i < p.row_phases; ++i) {
      t1 += red[i * p.width + c];
      t2 += red[(p.row_phases + i) * p.width + c];
    }
    red[c] = t1;
    red[p.row_phases * p.width + c] = t2;
  }
  __syncthreads();
  const int gpb = p.groups_per_block;
  for (int g = threadIdx.x; g < gpb; g += THREADS) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll 8
    for (int i = 0; i < p.cg; ++i) {
      t1 += red[g * p.cg + i];
      t2 += red[p.row_phases * p.width + g * p.cg + i];
    }
    part[g] = t1;
    part[gpb + g] = t2;
  }
  if (p.cluster > 1) {
    cluster_arrive();   // every rank's sums are written ...
    cluster_wait();     // ... and visible here
  } else {
    __syncthreads();
  }
  for (int g = threadIdx.x; g < gpb; g += THREADS) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll 8
    for (int r = 0; r < p.cluster; ++r) {
      const float* other = p.cluster > 1 ? cluster.map_shared_rank(part, r) : part;
      t1 += other[g];
      t2 += other[gpb + g];
    }
    const float mean = t1 / p.n;
    const float var = t2 / p.n - mean * mean;
    gstat[g] = mean;
    gstat[gpb + g] = rsqrtf(var + p.eps);
  }
  if (p.cluster > 1) cluster_arrive();   // done reading the other ranks (waited at the end)
  __syncthreads();

  // phase 3: normalise from shared memory, write y
  float mean[VEC], scale[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int g = active ? (col + k) / p.cg : 0;
    mean[k] = gstat[g];
    scale[k] = gstat[gpb + g] * gm[k];   // rstd * gamma
  }
  T* out = static_cast<T*>(p.out) + (static_cast<size_t>(b) * p.hw + r0) * p.c + c0 + col;
  auto emit = [&](int j, int s) {
    if (!active) return;
    const int n_rows = min(p.box_rows, rows - j * p.box_rows);
    const unsigned char* base = smem + s * p.stage_stride + thread_off;
#pragma unroll 2
    for (int r = rp; r < n_rows; r += p.row_phases) {
      float v[VEC];
      Vec<T>::load(base + r * row_bytes, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float t = MODE == ADD ? v[k] + a[k] : v[k];
        float y = fmaf(t - mean[k], scale[k], bt[k]);
        if (MODE == FILM) y = fmaf(y, f1[k], f2[k]);
        if (SILU) y = __fdividef(y, 1.f + __expf(-y));   // y -> -inf: y / inf = -0
        v[k] = y;
      }
      Vec<T>::store(out + static_cast<size_t>(j * p.box_rows + r) * p.c, v);
    }
  };
  // newest first: the last `slots` boxes are still in their slots; each
  // emitted box frees its slot for the box `slots` boxes back, read again
  for (int j = nb - 1; j >= 0; --j) {
    const int s = j % p.slots;
    if (j < nb - p.slots) wait(s);
    emit(j, s);
    if (j - p.slots >= 0) {
      __syncthreads();
      if (threadIdx.x == 0) issue(j - p.slots);
    }
  }
  if (p.cluster > 1) cluster_wait();   // no CTA leaves while another may still read its sums
}

// A [B, HW, C] tensor of `es`-byte elements as the 3-D map {C, HW, B}, read in
// boxes of box_cols x box_rows without swizzle; rows past HW arrive as zeros.
bool make_map(CUtensorMap* map, const void* x, int b, int hw, int c, int es, int box_cols,
              int box_rows) {
  sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)hw, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)c * es, (cuuint64_t)hw * c * es};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(x), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

using Kernel = void (*)(const CUtensorMap, const Params);

template <typename T>
Kernel pick(int mode, int silu) {
#define CASE(M) \
  case M:       \
    return silu ? gn_silu_kernel<T, M, true> : gn_silu_kernel<T, M, false>
  switch (mode) {
    CASE(PLAIN);
    CASE(ADD);
    CASE(FILM);
  }
#undef CASE
  return nullptr;
}

}  // namespace

extern "C" {

// x, out: contiguous [b, hw, c] of bf16 (x_fp32 = 0) or fp32, 16-byte aligned;
// gamma, beta: [c] of bf16 (param_bf16 = 1) or fp32; vec0, vec1: [b, c] of bf16
// (vec_bf16 = 1) or fp32, the add (mode 1) or FiLM's scale and shift (mode 2),
// else null. plan: the P_COUNT ints of the launch plan. Returns the
// cudaError_t of the launch.
int gn_silu_launch(const void* x, void* out, const void* gamma, const void* beta,
                   const void* vec0, const void* vec1, int x_fp32, int param_bf16, int vec_bf16,
                   int mode, int silu, int b, int hw, int c, const int* plan, float eps,
                   void* stream) {
  if (b <= 0 || hw <= 0 || c <= 0 || mode < PLAIN || mode > FILM) return (int)cudaErrorInvalidValue;
  const int es = x_fp32 ? 4 : 2;
  Params p;
  p.out = out;
  p.gamma = gamma;
  p.beta = beta;
  p.vec0 = vec0;
  p.vec1 = vec1;
  p.hw = hw;
  p.c = c;
  p.cg = plan[P_CG];
  p.width = plan[P_WIDTH];
  p.col_blocks = plan[P_COL_BLOCKS];
  p.cluster = plan[P_CLUSTER];
  p.rows_per_cta = plan[P_ROWS_PER_CTA];
  p.box_rows = plan[P_BOX_ROWS];
  p.box_cols = plan[P_BOX_COLS];
  p.boxes_per_stage = plan[P_BOXES_PER_STAGE];
  p.box_stride = plan[P_BOX_STRIDE];
  p.stage_stride = plan[P_STAGE_STRIDE];
  p.slots = plan[P_SLOTS];
  p.row_phases = plan[P_ROW_PHASES];
  p.groups_per_block = plan[P_GROUPS_PER_BLOCK];
  p.red_off = plan[P_RED_OFF];
  p.part_off = plan[P_PART_OFF];
  p.gstat_off = plan[P_GSTAT_OFF];
  p.bar_off = plan[P_BAR_OFF];
  p.stage_tx = (uint32_t)(p.boxes_per_stage * p.box_rows * p.box_cols * es);
  p.n = (float)hw * (float)p.cg;
  p.eps = eps;
  p.param_bf16 = param_bf16;
  p.vec_bf16 = vec_bf16;
  if (p.width * p.col_blocks != c || p.slots < 1 || p.slots > 32 || p.cluster < 1 ||
      p.cluster > 8 || p.width / (16 / es) * p.row_phases > THREADS)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = x_fp32 ? pick<float>(mode, silu) : pick<bf16>(mode, silu);
  // set before every launch, and before the tensor map is encoded: a launch
  // from another host thread (autograd's) must not depend on an attribute
  // set, or a context made current, by an earlier call on another thread
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan[P_SMEM]);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map;
  if (!make_map(&map, x, b, hw, c, es, p.box_cols, p.box_rows))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sm90::cluster_launch(&attr, b * p.col_blocks * p.cluster, THREADS,
                                                      p.cluster, plan[P_SMEM],
                                                      (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, kernel, map, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of `cluster` CTAs with `smem` bytes of dynamic shared memory each
// that the device holds at once, or a negative cudaError_t.
int gn_silu_max_active_clusters(int cluster, int smem) {
  return sm90::max_active_clusters(pick<bf16>(ADD, 1), THREADS, cluster, smem);
}

}  // extern "C"
