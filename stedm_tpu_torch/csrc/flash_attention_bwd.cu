// Flash-attention backward (non-causal) for Hopper, bf16 in and out.
//
// Replaces the two backward Pallas TPU kernels of the stock flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_bwd_dkv
// and _flash_attention_bwd_dq, glued by _flash_attention_bwd), which the JAX
// package reaches through the gradient of stedm_tpu/ops/blocked_attention.py:
// flash_sdpa: the U-Net bottleneck AttentionBlock in training
// ([B, 8, 1024, 128] at 512^2, [B, 4, T, 64] in the tiny card model).
//
// With P = softmax(Q K^T * s) rebuilt from the forward's per-row log-sum-exp
// (csrc/flash_attention.cu writes it) and Di = rowsum(dO o O) computed
// outside (as the stock kernel does in jnp):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Di) * s,  dK = dS^T Q,  dQ = dS K.
// P and dS are rounded to bf16 before their products, as the stock kernel
// rounds them to dO's dtype; every sum is fp32.
//
// What bounds it on the H100: the five matrix products (10 BH T^2 Dh flops,
// 86 GFLOP at [8, 8, 1024, 128]) against about 100 MB of traffic, so
// tensor-core throughput, as for the forward.
//
// Design (mma.sync m16n8k16, ldmatrix from padded shared memory, cp.async
// tiles, the forward's building blocks; no atomics, so every result is the
// same from run to run):
//   * dkv kernel: one block of 4 warps per (batch*head, 64-key tile); each
//     warp owns 16 keys and keeps their fp32 dK and dV in registers while it
//     walks over the query tiles. It computes the transposed products S^T =
//     K Q^T and dP^T = V dO^T directly, so P^T and dS^T sit in the
//     accumulator layout with keys as rows and repack from registers into the
//     A operand of dV += P^T dO and dK += dS^T Q without shared memory. At
//     Dh = 128 the two accumulators take 128 registers a thread, so a query
//     tile there is 32 wide (S^T and dP^T 16 registers each); at Dh = 64 it
//     is 64 wide;
//   * dq kernel: one block of 4 warps per (batch*head, 64-query tile); each
//     warp owns 16 queries, keeps their dQ in registers and walks over the
//     key tiles: S = Q K^T, dP = dO V^T, dS, dQ += dS K;
//   * the tiles a block owns (K and V, or Q and dO) are loaded once; the
//     walked tiles stream through shared memory with cp.async, the second
//     operand landing while the first product runs; rows padded by 16 bytes
//     so an ldmatrix's 8 row addresses hit distinct banks;
//   * queries past T get P = 0 (their LSE reads as +inf); keys past T are
//     masked in the dq kernel and never written by the dkv kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;      // keys (dkv) or queries (dq) a block owns
constexpr int BK = 64;        // key tile of the dq kernel
constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr int PAD = 8;        // bf16 row padding (16 bytes)
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, col-major)
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start copying a rows x cols bf16 tile (cols a multiple of 8) from global
// memory, row stride src_ld, into shared memory with row stride dst_ld; rows at
// or past valid_rows are zero-filled (cp.async with a source size of 0).
__device__ inline void load_tile_async(bf16* dst, int dst_ld, const bf16* src, int src_ld,
                                       int rows, int cols, int valid_rows) {
  const int vec_per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * vec_per_row; i += THREADS) {
    const int r = i / vec_per_row;
    const int c = (i % vec_per_row) * 8;
    const bool ok = r < valid_rows;
    const bf16* from = ok ? src + (size_t)r * src_ld + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst + r * dst_ld + c)), "l"(from), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Operand fragments for mma_bf16, read with ldmatrix. Each returns the
// fragments of a 16-deep slice starting at k0.
//   A (16 rows x 16 of k) from row-major [row][k] storage at rows row0..+15;
__device__ inline void frag_a(uint32_t (&a)[4], const bf16* s, int ld, int row0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, s + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
//   B of the two 8-wide column tiles n0 and n0 + 8 (b[0..1] and b[2..3]) from
//   storage [n][k] (the B^T rows, e.g. K for Q K^T);
__device__ inline void frag_b_nk(uint32_t (&b)[4], const bf16* s, int ld, int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}
//   the same from storage [k][n] (e.g. V for P V), with the transposing load.
__device__ inline void frag_b_kn(uint32_t (&b)[4], const bf16* s, int ld, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(b, s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 + (lane >> 4) * 8);
}

// The A operand of a 16-deep product from a row's accumulator tiles 2 kk and
// 2 kk + 1 (16 x 16 of fp32 in the m16n8k16 accumulator layout), in bf16.
template <int N>
__device__ inline void acc_to_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

template <int N>
__device__ inline void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// c (16 rows x 8 N) += A (16 rows of sa, all D) * B (N rows of sb, all D)^T
template <int D, int N>
__device__ inline void gemm_nt(float (&c)[N][4], const bf16* sa, int row0, const bf16* sb) {
  constexpr int LD = D + PAD;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    frag_a(a, sa, LD, row0, kk);
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      uint32_t b[4];
      frag_b_nk(b, sb, LD, j * 8, kk);
      mma_bf16(c[j], a, b[0], b[1]);
      mma_bf16(c[j + 1], a, b[2], b[3]);
    }
  }
}

// c (16 rows x D) += P (16 rows x 16 KT, in registers) * B (16 KT rows of sb x D)
template <int D, int KT>
__device__ inline void gemm_acc_nn(float (&c)[D / 8][4], const float (&p)[KT * 2][4],
                                   const bf16* sb) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    acc_to_a(a, p, kk);
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t b[4];
      frag_b_kn(b, sb, LD, kk * 16, j * 8);
      mma_bf16(c[j], a, b[0], b[1]);
      mma_bf16(c[j + 1], a, b[2], b[3]);
    }
  }
}

// Write a warp's 16 x D fp32 accumulator as bf16 rows row0.. of out (rows >= T skipped).
template <int D>
__device__ inline void store_rows(bf16* out, const float (&c)[D / 8][4], int row0, int T) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < T) {
      bf16* o = out + (size_t)row * D + 2 * tg;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(o + j * 8) = pack_bf16x2(c[j][2 * r], c[j][2 * r + 1]);
    }
  }
}

template <int D, int BQ>
size_t dkv_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * ROWS + 2 * BQ) * (D + PAD) + sizeof(float) * 2 * BQ;
}

template <int D, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int T,
                     float scale_log2, float sm_scale) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + ROWS * LD;
  bf16* Qs = Vs + ROWS * LD;
  bf16* dOs = Qs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * LD);  // LSE * log2(e)
  float* di_s = lse_s + BQ;

  const int k0 = blockIdx.x * ROWS;
  const size_t head = (size_t)blockIdx.y * T * D;
  const size_t rows_of_head = (size_t)blockIdx.y * T;
  const int warp = threadIdx.x / 32;
  const int tg = (threadIdx.x % 32) & 3;
  const int r0 = warp * 16;  // this warp's keys within the tile

  load_tile_async(Ks, LD, k + head + (size_t)k0 * D, D, ROWS, D, T - k0);
  load_tile_async(Vs, LD, v + head + (size_t)k0 * D, D, ROWS, D, T - k0);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int qt = 0; qt < T; qt += BQ) {
    const int nq = T - qt < BQ ? T - qt : BQ;
    __syncthreads();  // the previous tile's readers of Qs, dOs, lse_s, di_s are done
    load_tile_async(Qs, LD, q + head + (size_t)qt * D, D, BQ, D, nq);
    load_tile_async(dOs, LD, dout + head + (size_t)qt * D, D, BQ, D, nq);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      lse_s[i] = i < nq ? lse[rows_of_head + qt + i] * LOG2E : INFINITY;
      di_s[i] = i < nq ? di[rows_of_head + qt + i] : 0.f;
    }
    cp_async_wait<1>();  // K, V and Q have landed; dO may be in flight
    __syncthreads();

    // P^T = exp2(S^T * s * log2e - LSE * log2e), S^T = K Q^T: keys x queries
    float p[BQ / 8][4];
    zero(p);
    gemm_nt<D, BQ / 8>(p, Ks, r0, Qs);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] = exp2f(p[j][e] * scale_log2 - lse_s[j * 8 + 2 * tg + (e & 1)]);

    cp_async_wait<0>();
    __syncthreads();
    gemm_acc_nn<D, BQ / 16>(dv_acc, p, dOs);  // dV += P^T dO

    // dS^T = P^T o (dP^T - Di) * s, dP^T = V dO^T
    float ds[BQ / 8][4];
    zero(ds);
    gemm_nt<D, BQ / 8>(ds, Vs, r0, dOs);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - di_s[j * 8 + 2 * tg + (e & 1)]) * sm_scale;
    gemm_acc_nn<D, BQ / 16>(dk_acc, ds, Qs);  // dK += dS^T Q
  }

  store_rows<D>(dk + head, dk_acc, k0 + r0, T);
  store_rows<D>(dv + head, dv_acc, k0 + r0, T);
}

template <int D>
size_t dq_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * ROWS + 2 * BK) * (D + PAD);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    bf16* __restrict__ dq, int T, float scale_log2, float sm_scale) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + ROWS * LD;
  bf16* Ks = dOs + ROWS * LD;
  bf16* Vs = Ks + BK * LD;

  const int q0 = blockIdx.x * ROWS;
  const size_t head = (size_t)blockIdx.y * T * D;
  const size_t rows_of_head = (size_t)blockIdx.y * T;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = warp * 16;  // this warp's queries within the tile

  load_tile_async(Qs, LD, q + head + (size_t)q0 * D, D, ROWS, D, T - q0);
  load_tile_async(dOs, LD, dout + head + (size_t)q0 * D, D, ROWS, D, T - q0);
  float lse2[2], di_r[2];  // rows g and g + 8 of this warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    lse2[r] = row < T ? lse[rows_of_head + row] * LOG2E : INFINITY;
    di_r[r] = row < T ? di[rows_of_head + row] : 0.f;
  }

  float dq_acc[D / 8][4];
  zero(dq_acc);

  for (int kt = 0; kt < T; kt += BK) {
    const int nk = T - kt < BK ? T - kt : BK;
    __syncthreads();  // the previous tile's readers of Ks and Vs are done
    load_tile_async(Ks, LD, k + head + (size_t)kt * D, D, BK, D, nk);
    load_tile_async(Vs, LD, v + head + (size_t)kt * D, D, BK, D, nk);
    cp_async_wait<1>();  // Q, dO and K have landed; V may be in flight
    __syncthreads();

    // P = exp2(S * s * log2e - LSE * log2e), S = Q K^T; keys past T masked
    float p[BK / 8][4];
    zero(p);
    gemm_nt<D, BK / 8>(p, Qs, r0, Ks);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] = kt + j * 8 + 2 * tg + (e & 1) < T
                      ? exp2f(p[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;

    cp_async_wait<0>();
    __syncthreads();
    // dS = P o (dP - Di) * s, dP = dO V^T
    float ds[BK / 8][4];
    zero(ds);
    gemm_nt<D, BK / 8>(ds, dOs, r0, Vs);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - di_r[e >> 1]) * sm_scale;
    gemm_acc_nn<D, BK / 16>(dq_acc, ds, Ks);  // dQ += dS K
  }

  store_rows<D>(dq + head, dq_acc, q0 + r0, T);
}

template <int D, int BQ>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, void* dk, void* dv, int bh, int t, float sm_scale,
               cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D, BQ>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + ROWS - 1) / ROWS, bh);
  flash_bwd_dkv_kernel<D, BQ><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, di, (bf16*)dk,
      (bf16*)dv, t, sm_scale * LOG2E, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* di, void* dq, int bh, int t, float sm_scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + ROWS - 1) / ROWS, bh);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, di, (bf16*)dq, t,
      sm_scale * LOG2E, sm_scale);
  return (int)cudaGetLastError();
}

bool bad_args(int bh, int t, int d) {
  return (d != 64 && d != 128) || t <= 0 || bh <= 0;
}

}  // namespace

extern "C" {

// q, k, v, dout: [BH, T, D] contiguous bf16 on the device, D 64 or 128; lse
// (the forward's, natural log) and di = rowsum(dout * o): [BH, T] fp32.
// dk, dv: [BH, T, D] bf16 outputs. Returns the cudaError_t of the launch.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* di, void* dk, void* dv, int bh, int t,
                            int d, float sm_scale, void* stream) {
  if (bad_args(bh, t, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dd = (const float*)di;
  if (d == 128) return launch_dkv<128, 32>(q, k, v, dout, l, dd, dk, dv, bh, t, sm_scale, s);
  return launch_dkv<64, 64>(q, k, v, dout, l, dd, dk, dv, bh, t, sm_scale, s);
}

// The same inputs; dq: [BH, T, D] bf16 output.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* di, void* dq, int bh, int t, int d,
                           float sm_scale, void* stream) {
  if (bad_args(bh, t, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dd = (const float*)di;
  if (d == 128) return launch_dq<128>(q, k, v, dout, l, dd, dq, bh, t, sm_scale, s);
  return launch_dq<64>(q, k, v, dout, l, dd, dq, bh, t, sm_scale, s);
}

}  // extern "C"
