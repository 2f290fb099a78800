// Nearest codebook entry for each token of the VQ decode path.
//
// Replaces the TPU kernel _nearest_code_pallas (stedm_tpu/ops/quantize.py:62,
// body _kernel :32). For each token z, returns argmin_j ||c_j||^2 - 2 z.c_j
// (the constant ||z||^2 is dropped); ties go to the lowest index, as the
// kernel's jnp.min over indices of equal distances (:48-52).
//
// What bounds it on the H100: instruction issue. With a 3-wide embedding a
// (token, code) pair costs 3 multiplies, 2 adds and one fused multiply-add for
// the distance; a running (min, argmin) adds a compare and two selects: 9
// issue slots a pair, ~2.4e9 a decode at batch 8 (32768 tokens x 8192 codes),
// against 0.5 MB of tokens in and indices out. A matrix-unit formulation would pad the 3-wide contraction to
// 8 and round it in TF32, losing the fp32 indices.
//
// Design:
// - register blocking: a thread holds 2 tokens, so one shared-memory load of a
//   code serves 2 distances; a CTA of 8 warps covers 512 tokens (4 warps of
//   4 tokens measure alike, 16 warps of 1 token or 8 tokens a thread slower:
//   tools/torch_nearest_code_variants.py);
// - the codebook is split across the CTAs of a cluster (up to 8), rank r
//   taking the r-th slice in code order, so that the grid fills the card: the
//   plan (ops/quantize.py) picks the split whose clusters the device holds at
//   once, one CTA an SM (its shared memory sees to that), 2 at N = 32768;
// - each CTA brings its slice in by a bulk copy and packs it in shared memory
//   as float4 (c0, c1, c2, ||c||^2), ||c||^2 computed here;
// - the argmin in two passes, 7 issue slots a pair: the first keeps only the
//   minimum of each block of 32 codes (one fminf a pair) and, with a strict
//   '<' in block order, the first block that holds the overall minimum; the
//   second computes that block's distances again (the same operations, so
//   the same bits) and takes the first code equal to the minimum. That is
//   the code a running strict '<' in code order keeps, ties included;
// - the CTAs then meet through DSMEM, each combining a share of the tokens
//   over the ranks in rank order with a strict '<', so ties keep the lowest
//   index;
// - the distance is formed in the TPU kernel's order of operations:
//   d = ||c||^2 - 2 * ((z0 c0 + z1 c1) + z2 c2), the products and sums
//   rounded one by one; fmaf(-2, dot, ||c||^2) rounds the same value once
//   (2 * dot is exact), so it equals __fsub_rn(||c||^2, 2 * dot) bit for bit.
//
// Any other width, and a codebook whose slice does not fit a CTA's shared
// memory (16,384 codes at N > 33,792 tokens, CompVis vq-f8's 4 x 16384 and
// vq-f16's 8 x 16384), take the streaming kernel, nearest_code_stream, as
// the TPU kernel loops over CODE_CHUNK = 2048 codes (quantize.py:38-53):
// - a first launch packs the codebook once, each code as its width's
//   coordinates and ||c||^2 (summed in code order, each square rounded),
//   padded to 4 floats (width <= 3) or a multiple of 8, and the codebook to
//   whole chunks of 32 KB by codes at ||c||^2 = +inf, which never win;
// - the search splits the chunks across the CTAs of a cluster as above (rank
//   r takes a contiguous run of them, in code order), and each CTA streams
//   its run through two shared-memory buffers by bulk copies, each on its
//   own mbarrier: the next chunk lands while this one is searched;
// - a thread holds 2 tokens; up to width 16 their coordinates sit in
//   registers (the width a template argument, the code read as float4s, a
//   broadcast), above they are read from the L1 each time;
// - the distance in the same order as the width-3 kernel's (so width 3
//   gives the same bits on both): the dot product summed in coordinate
//   order, each product and sum rounded, then fmaf(-2, dot, ||c||^2); the
//   running (min, argmin) keeps a strict '<' in code order, so ties go to
//   the lowest index within a CTA, and the cluster combines its ranks as
//   the width-3 kernel does.

#include <cooperative_groups.h>
#include <math.h>

#include "sm90_async.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int TPT = 2;                    // tokens a thread
constexpr int TILE = THREADS * TPT;       // tokens a CTA
constexpr int BLOCK = 32;                 // codes whose minimum the first pass compares at once

// ||c||^2 - 2 z.c in the TPU kernel's order of operations (the file's head)
__device__ __forceinline__ float distance(float z0, float z1, float z2, float4 c) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(z0, c.x), __fmul_rn(z1, c.y)),
                              __fmul_rn(z2, c.z));
  return fmaf(-2.f, dot, c.w);
}

__global__ void __launch_bounds__(THREADS, 1)
nearest_code_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                    int* __restrict__ out, int n, int n_embed, int codes_per_cta,
                    int scratch_off, int bar_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / split;
  const int code0 = rank * codes_per_cta;
  const int count = max(0, min(n_embed - code0, codes_per_cta));
  const int bulk = count & ~3;            // codes by bulk copy: 48-byte multiples
  float4* codes = reinterpret_cast<float4*>(smem);
  float* raw = reinterpret_cast<float*>(smem + scratch_off);   // the slice as it lies
  const uint32_t bar = sm90::smem_u32(smem + bar_off);

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && bulk > 0) {
    sm90::mbar_expect_tx(bar, bulk * 12);
    sm90::bulk_load(sm90::smem_u32(raw), cb + 3 * static_cast<size_t>(code0), bulk * 12, bar);
  }
  for (int i = 3 * bulk + threadIdx.x; i < 3 * count; i += THREADS)
    raw[i] = cb[3 * static_cast<size_t>(code0) + i];

  float z0[TPT], z1[TPT], z2[TPT];
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    const int tok = tile * TILE + k * THREADS + threadIdx.x;
    const bool in = tok < n;
    z0[k] = in ? z[3 * static_cast<size_t>(tok)] : 0.f;
    z1[k] = in ? z[3 * static_cast<size_t>(tok) + 1] : 0.f;
    z2[k] = in ? z[3 * static_cast<size_t>(tok) + 2] : 0.f;
  }
  if (bulk > 0) sm90::mbar_wait(bar, 0);
  __syncthreads();
  for (int j = threadIdx.x; j < count; j += THREADS) {
    const float c0 = raw[3 * j], c1 = raw[3 * j + 1], c2 = raw[3 * j + 2];
    codes[j] = make_float4(c0, c1, c2, __fadd_rn(__fadd_rn(__fmul_rn(c0, c0),
                                                          __fmul_rn(c1, c1)),
                                                __fmul_rn(c2, c2)));
  }
  __syncthreads();

  // pass 1: the minimum of each block of BLOCK codes, one fminf a pair, and
  // the first block whose minimum is below every earlier block's
  float best[TPT];
  int best_blk[TPT];
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    best[k] = INFINITY;
    best_blk[k] = 0;
  }
  for (int j0 = 0; j0 < count; j0 += BLOCK) {
    float m[TPT];
#pragma unroll
    for (int k = 0; k < TPT; ++k) m[k] = INFINITY;
    if (j0 + BLOCK <= count) {
#pragma unroll
      for (int i = 0; i < BLOCK; ++i) {
        const float4 c = codes[j0 + i];
#pragma unroll
        for (int k = 0; k < TPT; ++k) m[k] = fminf(m[k], distance(z0[k], z1[k], z2[k], c));
      }
    } else {
      for (int j = j0; j < count; ++j) {
        const float4 c = codes[j];
#pragma unroll
        for (int k = 0; k < TPT; ++k) m[k] = fminf(m[k], distance(z0[k], z1[k], z2[k], c));
      }
    }
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      if (m[k] < best[k]) {
        best[k] = m[k];
        best_blk[k] = j0;
      }
    }
  }
  // pass 2: the first code of that block at the minimum, the one a strict
  // '<' in code order keeps (the block's distances all formed at once, last
  // to first); with no finite minimum, the slice's first code
  int best_i[TPT];
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    best_i[k] = code0;
    if (best[k] < INFINITY) {
#pragma unroll
      for (int i = BLOCK - 1; i >= 0; --i) {
        const int j = best_blk[k] + i;
        const float d = distance(z0[k], z1[k], z2[k], codes[min(j, count - 1)]);
        if (j < count && d == best[k]) best_i[k] = code0 + j;
      }
    }
  }

  // the slice is packed: its scratch holds this CTA's (min, argmin) a token
  float* res_d = raw;
  int* res_i = reinterpret_cast<int*>(raw + TILE);
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    res_d[k * THREADS + threadIdx.x] = best[k];
    res_i[k * THREADS + threadIdx.x] = best_i[k];
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  // rank r combines the r-th share of the tile's tokens over all ranks
  const int share = TILE / split;
  for (int t = rank * share + threadIdx.x; t < (rank + 1) * share; t += THREADS) {
    float d = INFINITY;
    int idx = 0;
    for (int r = 0; r < split; ++r) {
      const float dr = cluster.map_shared_rank(res_d, r)[t];
      if (dr < d) {
        d = dr;
        idx = cluster.map_shared_rank(res_i, r)[t];
      }
    }
    const int tok = tile * TILE + t;
    if (tok < n) out[tok] = idx;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}


// ---- the streaming kernel: any width, any codebook size ----

constexpr int CHUNK_FLOATS = 8192;        // a chunk buffer: 32 KB of packed codes

// Floats a packed code of width e takes: e coordinates and ||c||^2, padded
// to 4 (e <= 3) or a multiple of 8 (ops/quantize.py:packed_width)
__host__ __device__ constexpr int packed_width(int e) { return e <= 3 ? 4 : (e + 8) / 8 * 8; }

// The packed codebook: code j's coordinates, then ||c_j||^2 at index e, zeros
// up to w floats; codes n_embed .. n_pad - 1 are zeros with ||c||^2 = +inf.
__global__ void __launch_bounds__(THREADS)
nearest_code_pack(const float* __restrict__ cb, float* __restrict__ packed, int n_embed, int n_pad,
                  int e, int w) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n_pad) return;
  float* dst = packed + static_cast<size_t>(j) * w;
  float sq = INFINITY;
  if (j < n_embed) {
    const float* c = cb + static_cast<size_t>(j) * e;
    sq = 0.f;
    for (int i = 0; i < e; ++i) {
      const float x = c[i];
      dst[i] = x;
      sq = i == 0 ? __fmul_rn(x, x) : __fadd_rn(sq, __fmul_rn(x, x));
    }
  } else {
    for (int i = 0; i < e; ++i) dst[i] = 0.f;
  }
  dst[e] = sq;
  for (int i = e + 1; i < w; ++i) dst[i] = 0.f;
}

// E > 0: the width, the tokens' coordinates in registers; E == 0: width
// `e_rt`, the coordinates read from global memory (the L1) at each code
template <int E>
__global__ void __launch_bounds__(THREADS, 1)
nearest_code_stream(const float* __restrict__ z, const float* __restrict__ packed,
                    int* __restrict__ out, int n, int e_rt, int w, int chunk, int n_chunks,
                    int chunks_per_cta, int res_off, int bar_off) {
  constexpr int W = packed_width(E > 0 ? E : 1);
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / split;
  const int e = E > 0 ? E : e_rt;
  const int c_begin = rank * chunks_per_cta;
  const int count = max(0, min(n_chunks - c_begin, chunks_per_cta));
  const int code0 = c_begin * chunk;
  const uint32_t bytes = static_cast<uint32_t>(chunk) * w * 4;
  const float* buf0 = reinterpret_cast<const float*>(smem);
  const float* buf1 = buf0 + chunk * w;
  const uint32_t bar = sm90::smem_u32(smem + bar_off);   // two: bar and bar + 8

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_init(bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < min(2, count); ++s) {
      sm90::mbar_expect_tx(bar + 8 * s, bytes);
      sm90::bulk_load(sm90::smem_u32(s ? buf1 : buf0),
                      packed + static_cast<size_t>(c_begin + s) * chunk * w, bytes, bar + 8 * s);
    }
  }

  int tok[TPT];
  float zr[TPT][E > 0 ? E : 1];
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    tok[k] = tile * TILE + k * THREADS + threadIdx.x;
#pragma unroll
    for (int i = 0; i < (E > 0 ? E : 1); ++i)
      zr[k][i] = E > 0 && tok[k] < n ? z[static_cast<size_t>(tok[k]) * E + i] : 0.f;
  }
  float best[TPT];
  int best_i[TPT];
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    best[k] = INFINITY;
    best_i[k] = code0;
  }

  for (int c = 0; c < count; ++c) {
    const int s = c & 1;
    sm90::mbar_wait(bar + 8 * s, (c >> 1) & 1);
    const float* codes = s ? buf1 : buf0;
    const int j0 = code0 + c * chunk;
    for (int jj = 0; jj < chunk; ++jj) {
      const float* cc = codes + jj * w;
      float dot[TPT];
      float csq;
      if (E > 0) {
        float cv[W];
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
          const float4 v4 = reinterpret_cast<const float4*>(cc)[q];
          cv[4 * q] = v4.x;
          cv[4 * q + 1] = v4.y;
          cv[4 * q + 2] = v4.z;
          cv[4 * q + 3] = v4.w;
        }
#pragma unroll
        for (int k = 0; k < TPT; ++k) {
          dot[k] = __fmul_rn(zr[k][0], cv[0]);
#pragma unroll
          for (int i = 1; i < (E > 0 ? E : 1); ++i)
            dot[k] = __fadd_rn(dot[k], __fmul_rn(zr[k][i], cv[i]));
        }
        csq = cv[E > 0 ? E : 0];
      } else {
#pragma unroll
        for (int k = 0; k < TPT; ++k) {
          const float* zt = z + static_cast<size_t>(min(tok[k], n - 1)) * e;
          dot[k] = __fmul_rn(__ldg(zt), cc[0]);
          for (int i = 1; i < e; ++i) dot[k] = __fadd_rn(dot[k], __fmul_rn(__ldg(zt + i), cc[i]));
        }
        csq = cc[e];
      }
#pragma unroll
      for (int k = 0; k < TPT; ++k) {
        const float d = fmaf(-2.f, dot[k], csq);
        if (d < best[k]) {
          best[k] = d;
          best_i[k] = j0 + jj;
        }
      }
    }
    __syncthreads();                      // every thread is done with this buffer
    if (threadIdx.x == 0 && c + 2 < count) {
      sm90::mbar_expect_tx(bar + 8 * s, bytes);
      sm90::bulk_load(sm90::smem_u32(codes),
                      packed + static_cast<size_t>(c_begin + c + 2) * chunk * w, bytes, bar + 8 * s);
    }
  }

  // the CTA's (min, argmin) a token, then the cluster's combine in rank order
  float* res_d = reinterpret_cast<float*>(smem + res_off);
  int* res_i = reinterpret_cast<int*>(res_d + TILE);
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    res_d[k * THREADS + threadIdx.x] = best[k];
    res_i[k * THREADS + threadIdx.x] = best_i[k];
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const int share = TILE / split;
  for (int t = rank * share + threadIdx.x; t < (rank + 1) * share; t += THREADS) {
    float d = INFINITY;
    int idx = 0;
    for (int r = 0; r < split; ++r) {
      const float dr = cluster.map_shared_rank(res_d, r)[t];
      if (dr < d || r == 0) {
        d = dr;
        idx = cluster.map_shared_rank(res_i, r)[t];
      }
    }
    const int tk = tile * TILE + t;
    if (tk < n) out[tk] = idx;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int E>
int stream_launch(const float* z, const float* packed, int* out, int n, int e, int w, int chunk,
                  int n_chunks, int split, int chunks_per_cta, int res_off, int bar_off, int smem,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(nearest_code_stream<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sm90::cluster_launch(&attr, ((n + TILE - 1) / TILE) * split,
                                                      THREADS, split, smem, stream);
  err = cudaLaunchKernelEx(&cfg, nearest_code_stream<E>, z, packed, out, n, e, w, chunk, n_chunks,
                           chunks_per_cta, res_off, bar_off);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// z: [n, 3] fp32; cb: [n_embed, 3] fp32, 16-byte aligned; out: [n] int32; all
// contiguous on the device. split (1..8, a power of two) CTAs of a cluster
// share a tile of 512 tokens, rank r taking codes [r * codes_per_cta, ...);
// codes_per_cta a multiple of 4. scratch_off, bar_off, smem: the
// shared-memory layout (ops/quantize.py). Returns the cudaError_t of the launch.
int nearest_code_launch(const void* z, const void* cb, void* out, int n, int n_embed, int split,
                        int codes_per_cta, int scratch_off, int bar_off, int smem,
                        void* stream) {
  if (n <= 0 || n_embed <= 0 || split < 1 || split > 8 || TILE % split != 0 ||
      codes_per_cta % 4 != 0 || split * codes_per_cta < n_embed)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(nearest_code_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sm90::cluster_launch(&attr, ((n + TILE - 1) / TILE) * split,
                                                      THREADS, split, smem, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, nearest_code_kernel, (const float*)z, (const float*)cb,
                           (int*)out, n, n_embed, codes_per_cta, scratch_off, bar_off);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of `split` CTAs with `smem` bytes of dynamic shared memory each
// that the device holds at once, or a negative cudaError_t.
int nearest_code_max_active_clusters(int split, int smem) {
  return sm90::max_active_clusters(nearest_code_kernel, THREADS, split, smem);
}

// The streaming kernel. z: [n, e] fp32; cb: [n_embed, e] fp32; packed: a
// device buffer of n_chunks * chunk * w floats, 16-byte aligned, which the
// first launch fills; out: [n] int32; all contiguous. w: the packed width
// (4 for e <= 3, else a multiple of 8 above e); chunk: codes a buffer
// (chunk * w <= 8192); split (1..8, a power of two) CTAs of a cluster share
// a tile of 512 tokens, rank r taking chunks [r * chunks_per_cta, ...);
// res_off, bar_off, smem: the shared-memory layout (ops/quantize.py). Returns
// the first cudaError_t of the two launches.
int nearest_code_stream_launch(const void* z, const void* cb, void* packed, void* out, int n,
                               int n_embed, int e, int w, int chunk, int n_chunks, int split,
                               int chunks_per_cta, int res_off, int bar_off, int smem,
                               void* stream) {
  if (n <= 0 || n_embed <= 0 || e <= 0 || w != packed_width(e) ||
      chunk <= 0 || chunk * w > CHUNK_FLOATS || n_chunks * chunk < n_embed || split < 1 ||
      split > 8 || TILE % split != 0 || split * chunks_per_cta < n_chunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_pad = n_chunks * chunk;
  nearest_code_pack<<<(n_pad + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (const float*)cb, (float*)packed, n_embed, n_pad, e, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define WIDTH(E) case E: return stream_launch<E>((const float*)z, (const float*)packed, (int*)out, \
      n, e, w, chunk, n_chunks, split, chunks_per_cta, res_off, bar_off, smem, s)
  switch (e) {
    WIDTH(1); WIDTH(2); WIDTH(3); WIDTH(4); WIDTH(5); WIDTH(6); WIDTH(7); WIDTH(8);
    WIDTH(9); WIDTH(10); WIDTH(11); WIDTH(12); WIDTH(13); WIDTH(14); WIDTH(15); WIDTH(16);
  }
#undef WIDTH
  return stream_launch<0>((const float*)z, (const float*)packed, (int*)out, n, e, w, chunk,
                          n_chunks, split, chunks_per_cta, res_off, bar_off, smem, s);
}

}  // extern "C"
