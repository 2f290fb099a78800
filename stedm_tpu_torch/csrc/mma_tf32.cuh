// fp32 matrix products on the tensor cores, and cp.async tile loads, for the
// fp32 flash-attention kernels (flash_attention_f32.cu,
// flash_attention_bwd_f32.cu).
//
// A product of fp32 tiles runs as three TF32 products (3xTF32): each operand
// x is split into hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest, and A B is taken as A_lo B_hi + A_hi B_lo + A_hi B_hi with fp32
// accumulation. Each product then carries about 2^-21 of its size in error,
// where a single TF32 product carries 2^-11: the plain fp32 versions, with
// TF32 off, are matched to about fp32 rounding.
//
// The tiles are mma.sync m16n8k8 fragments (lane = 4 g + t): A (16 x 8, row
// major) a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4];
// B (8 x 8) b0 = B[t][g], b1 = B[t + 4][g]; C (16 x 8) c0 = C[g][2 t],
// c1 = C[g][2 t + 1], c2 = C[g + 8][2 t], c3 = C[g + 8][2 t + 1].

#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b on one m16n8k8 tile, TF32 operands, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B to about fp32 accuracy: the two small cross terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// The A fragment of the 16 x 8 tile at `a` (row pitch `pitch` floats), split
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* a,
                                       int pitch, int g, int t) {
  split(a[g * pitch + t], hi[0], lo[0]);
  split(a[(g + 8) * pitch + t], hi[1], lo[1]);
  split(a[g * pitch + t + 4], hi[2], lo[2]);
  split(a[(g + 8) * pitch + t + 4], hi[3], lo[3]);
}

// The B fragment of a tile stored n-major (row n of `b` holds B[:, n]): the
// second operand of X Y^T with both X and Y kept row by row
__device__ __forceinline__ void load_b_nk(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* b,
                                          int pitch, int g, int t) {
  split(b[g * pitch + t], hi[0], lo[0]);
  split(b[g * pitch + t + 4], hi[1], lo[1]);
}

// The B fragment of a tile stored k-major (row k of `b` holds B[k, :])
__device__ __forceinline__ void load_b_kn(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* b,
                                          int pitch, int g, int t) {
  split(b[t * pitch + g], hi[0], lo[0]);
  split(b[(t + 4) * pitch + g], hi[1], lo[1]);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid (src
// is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [row0, row0 + rows) of a [T, D] fp32 slab (row pitch `stride`
// elements, 16-byte aligned rows) into shared memory at `pitch` floats a
// row; rows at or past t arrive as zeros. All `threads` threads take part.
template <int D, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* src, int64_t stride,
                                          int row0, int rows, int t) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = row0 + r < t;
    cp_async16(dst + r * pitch + c, src + (ok ? row0 + r : 0) * stride + c, ok);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

}  // namespace tf32x3
