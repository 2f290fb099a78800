// fp32 matrix products on Hopper's tensor cores through wgmma, for the fp32
// flash-attention kernels (flash_attention_f32.cu, flash_attention_bwd_f32.cu).
//
// 3xTF32: each fp32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest, and A B is taken as A_lo B_hi +
// A_hi B_lo + A_hi B_hi with fp32 sums. Each product then carries about 2^-21
// of its size in error where one TF32 product carries 2^-11. wgmma reads a
// TF32 operand from shared memory by dropping the low 13 bits of each value,
// so both halves are stored apart, already rounded: the split pass below
// writes them once per call to global memory, and the kernels load them with
// TMA like any other tile.
//
// wgmma.mma_async ... .f32.tf32.tf32 (m64nNk8) has no transpose flags: A and
// B in shared memory are K-major (each row holds the 8 values of a k-step
// contiguous, 32 bytes), so an operand whose reduction runs along tokens is
// stored transposed ([B*H, D, T]) by the split pass. Tiles are sub-tiles of
// 32 fp32 columns (128 bytes, one row of the 128-byte swizzle), 1024 bytes
// an 8-row group: wgmma::descriptor of wgmma_sm90.cuh addresses them as it
// does 64 bf16 columns, and a k-step of 8 values is 32 bytes there as a bf16
// k-step of 16 is.
//
// A from registers: thread t of the warpgroup holds a0 = A[r][k], a1 =
// A[r + 8][k], a2 = A[r][k + 4], a3 = A[r + 8][k + 4] with r = 16 (t / 32) +
// (t % 32) / 4 and k = t % 4. The fp32 accumulator holds, in d[4 j + e], row
// r + 8 (e / 2) and column 8 j + 2 k + (e % 2): a product's columns 2k and
// 2k + 1 sit where the A fragment wants columns k and k + 4. So an
// accumulator becomes an A operand without shuffles when the B operand's
// k-values are stored in the order pi (position p of each group of 8 holds
// element 2p for p < 4, 2 (p - 4) + 1 for p >= 4): the split pass writes the
// transposed copies of V (forward), Q and dO (backward) in that order.

#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_async.cuh"
#include "wgmma_sm90.cuh"

namespace tf32w {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The A fragment of a k-step from an accumulator's four values of columns
// 8 kk + 2k, 8 kk + 2k + 1 (rows r, r + 8), split into hi and lo.
__device__ __forceinline__ void acc_to_a(const float* d, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(d[0], hi[0], lo[0]);
  split(d[2], hi[1], lo[1]);
  split(d[1], hi[2], lo[2]);
  split(d[3], hi[3], lo[3]);
}

// d (64 x 32) (+)= A B, both from shared memory (K-major descriptors).
__device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) (+)= A B, both from shared memory.
__device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128) (+)= A B, both from shared memory (the band kernels,
// flash_band.cu).
__device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 32) (+)= A B, A from registers.
__device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 64) (+)= A B, A from registers.
__device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Pins an accumulator's registers at this point of the program, so that the
// compiler moves no definition of them across the wgmma fence or wait beside
// it (it would then insert a warpgroup arrive of its own, and serialise the
// wgmmas when that lands in a divergent path).
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Pins A fragments' registers until this point: a wgmma reads its A operand
// from registers asynchronously, after the instruction has issued, so the
// fragments must keep their registers until the wait that completes the
// chains reading them (call it right after that wait); otherwise the
// compiler may give those registers to new values meanwhile.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int v = 0; v < 4; ++v) asm volatile("" : "+r"(a[k][v])::"memory");
}

// Starts a chain's accumulator: zeroes and pins it. The chain's first
// wgmma discards it (scale-d 0) but still takes it as an operand, so without
// the zeroes its previous values stay live into the chain, and where other
// code reads them meanwhile ptxas serialises the wgmmas (C7514).
template <int N>
__device__ __forceinline__ void fresh(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
  fence_operand(d);
}

// `x` through a move the compiler cannot see through: the descriptors of
// tiles that stay in shared memory (Q, K, V, dS) would otherwise be computed
// once outside the tile loops and kept in registers, 64 and more a thread.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  uint32_t r;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(r) : "r"(x));
  return r;
}

// One k-step of 3xTF32 with A and B from shared memory: `a` and `b` are the
// shared-memory addresses (below 256 KB) of the k-step in the hi tiles, the
// lo tiles lying `a_lo` and `b_lo` bytes after them. `first` starts the sum.
template <int N>
__device__ __forceinline__ void ss3(float (&d)[N], uint32_t a, uint32_t a_lo, uint32_t b,
                                    uint32_t b_lo, bool first) {
  a = opaque(a);
  b = opaque(b);
  const uint64_t ah = wgmma::descriptor(a / 16, 16), al = wgmma::descriptor((a + a_lo) / 16, 16);
  const uint64_t bh = wgmma::descriptor(b / 16, 16), bl = wgmma::descriptor((b + b_lo) / 16, 16);
  ss(d, al, bh, first ? 0 : 1);
  ss(d, ah, bl, 1);
  ss(d, ah, bh, 1);
}

// One k-step of 3xTF32 with A from registers (hi, lo) and B from shared memory.
template <int N>
__device__ __forceinline__ void rs3(float (&d)[N], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                    uint32_t b, uint32_t b_lo, bool first) {
  b = opaque(b);
  const uint64_t bh = wgmma::descriptor(b / 16, 16), bl = wgmma::descriptor((b + b_lo) / 16, 16);
  rs(d, al, bh, first ? 0 : 1);
  rs(d, ah, bl, 1);
  rs(d, ah, bh, 1);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps over the split copies, the cluster launch.
// ---------------------------------------------------------------------------

// An fp32 [2 (hi, lo), BH, rows, cols] array (contiguous, cols a multiple of
// 4) as the 4-D map {cols, rows, BH, 2}, read in boxes of 32 columns x
// `box_rows` rows in the 128-byte swizzle; rows past `rows` arrive as zeros.
inline bool make_split_map(CUtensorMap* map, const float* ptr, int bh, int rows, int cols,
                           int box_rows) {
  sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)bh, 2};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 4, (cuuint64_t)rows * cols * 4,
                                 (cuuint64_t)bh * rows * cols * 4};
  const cuuint32_t box[4] = {32, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// The split pass: up to four fp32 [B, H, T, D] inputs (any batch, head and
// token strides, last dimension contiguous), each written as its hi and lo
// halves, [2, B*H, T, D] ("nat"), and/or transposed, [2, B*H, D, TP] ("tr",
// TP = T rounded up to 8; tokens in [T, TP) are written as zeros), the
// tokens of each group of 8 in the order pi when `perm` is set. A block
// takes a 32-token x 32-column tile of every job. The inputs have `dx`
// columns and the copies `d`: with dx below d (the kernels run a head
// dimension padded to their instance, dx 48 or 96 in copies of 64 or 128)
// the columns from dx on are written as zeros. The Dh-32 instance takes
// copies of the head dimension itself (d = dx, a multiple of 4 up to 32):
// its tensor maps declare those columns, and TMA fills the rest of each
// 32-column box with zeros.
// ---------------------------------------------------------------------------

struct SplitJob {
  const float* x;
  int64_t sb, sh, st;   // element strides of x
  float* nat;           // or null
  float* tr;            // or null
  int perm;
};

struct SplitParams {
  SplitJob job[4];
  int njobs, h, t, d, dx, tp, bh;
};

constexpr int SPLIT_THREADS = 256;

__device__ __forceinline__ int pi8(int p) { return p < 4 ? 2 * p : 2 * (p - 4) + 1; }

__global__ void __launch_bounds__(SPLIT_THREADS) split_tf32(const SplitParams p) {
  __shared__ float tile[32][33];
  const int t0 = blockIdx.x * 32, d0 = blockIdx.y * 32, bh = blockIdx.z;
  const int b = bh / p.h, hh = bh % p.h;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const size_t nat_part = (size_t)p.bh * p.t * p.d, tr_part = (size_t)p.bh * p.d * p.tp;
  for (int j = 0; j < p.njobs; ++j) {
    const SplitJob& job = p.job[j];
    const float* x = job.x + b * job.sb + hh * job.sh;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int tok = t0 + ty + 8 * r;
      const float v = tok < p.t && d0 + tx < p.dx ? x[tok * job.st + d0 + tx] : 0.f;
      tile[ty + 8 * r][tx] = v;
      if (job.nat != nullptr && tok < p.t && d0 + tx < p.d) {
        uint32_t hi, lo;
        split(v, hi, lo);
        const size_t at = ((size_t)bh * p.t + tok) * p.d + d0 + tx;
        job.nat[at] = __uint_as_float(hi);
        job.nat[nat_part + at] = __uint_as_float(lo);
      }
    }
    if (job.tr != nullptr) {
      __syncthreads();
      const int src = job.perm ? (tx & ~7) + pi8(tx & 7) : tx;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int dd = ty + 8 * r;
        if (t0 + tx >= p.tp || d0 + dd >= p.d) continue;
        uint32_t hi, lo;
        split(tile[src][dd], hi, lo);
        const size_t at = ((size_t)bh * p.d + d0 + dd) * p.tp + t0 + tx;
        job.tr[at] = __uint_as_float(hi);
        job.tr[tr_part + at] = __uint_as_float(lo);
      }
    }
    __syncthreads();
  }
}

inline cudaError_t launch_split(const SplitParams& p, cudaStream_t stream) {
  const dim3 grid((p.tp + 31) / 32, (p.d + 31) / 32, p.bh);
  split_tf32<<<grid, SPLIT_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// The head-dimension split of both kernels over the instance they run (run
// below): the columns a block, 32 at the Dh-32 instance, 128 at 128, 256,
// 512 and every instance above 512, else 64 (the backward's 3-block
// instance of 128 columns, Dh 384, spilled), and instance / columns blocks
// a cluster, at most 8, the portable cluster size, at Dh 1024
// (ops/blocked_attention.py: fp32_columns gives that cluster size, which
// the entry points check).
inline int block_columns(int run) {
  return run == 32 ? 32 : run == 128 || run == 256 || run >= 512 ? 128 : 64;
}

// The instance (head dimension) the kernels run a head dimension d (a
// multiple of 4 up to 1024) at: 32 up to 32, then the smallest multiple of
// 64 at or above it up to 512, of 128 above (one 128-column slice a
// cluster rank). Only the real columns of the outputs are stored.
inline int run_columns(int d) {
  return d <= 32 ? 32 : d <= 512 ? (d + 63) / 64 * 64 : (d + 127) / 128 * 128;
}

// The columns of the split copies: the head dimension itself at the Dh-32
// instance, else the instance's, zeros past the head dimension.
inline int copy_columns(int d) { return d <= 32 ? d : run_columns(d); }

}  // namespace tf32w
