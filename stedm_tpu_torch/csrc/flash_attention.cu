// Flash-attention forward (non-causal) for Hopper, bf16 in and out.
//
// Replaces the stock Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention, which the
// JAX package calls from stedm_tpu/ops/blocked_attention.py:flash_sdpa (the
// U-Net bottleneck AttentionBlock, [2B, 8, 256, 128]) and from
// stedm_tpu/models/vq.py:AttnBlockVQ (the VQ decoder mid-block, [B, 1, 4096,
// 512]). Computes O = softmax(Q K^T * sm_scale) V with an fp32 running max
// and sum per query row; P is rounded to bf16 before P V, as the stock kernel
// and the reference's exact path do. Key positions past T are masked, so T
// need not be a multiple of the tile. When asked, it also writes the fp32
// log-sum-exp of each query row (natural log of sum_j exp(s_ij * sm_scale)),
// which the backward kernels (csrc/flash_attention_bwd.cu) use to rebuild P;
// the stock kernel saves its running max and sum for the same purpose.
//
// What bounds it on the H100: the two matrix products. At the VQ shape they
// are ~2.7e11 flops a call against 3e8 bytes of input and output, far above
// the card's ~295 flops/byte balance point, so the bound is tensor-core
// throughput. At the U-Net shape (T = 256) the work per call is small and
// launch and tile-fill overheads dominate.
//
// Design (FlashAttention-2 layout on mma.sync; wgmma/TMA pipelines are later
// work):
//   * one block of 4 warps per (batch*head, 64-query tile, DVS-wide slice of
//     the value dimension); each warp owns 16 query rows, so the softmax
//     needs only shuffles among the 4 lanes that share a row;
//   * S = Q K^T, the running max/sum and the O accumulator stay in registers
//     in the m16n8k16 accumulator layout; P is repacked from S's registers
//     into the A operand of P V without touching shared memory;
//   * Dh = 512 does not fit a naive tile: an fp32 O accumulator of 16 x 512
//     would need 256 registers a thread. So a block keeps a DVS = 256 slice of
//     O (128 registers) and the two blocks of a query tile each compute Q K^T
//     over the full Dh (2x the Q K^T work at Dh = 512, accepted for now);
//   * Q (64 x Dh) is loaded into shared memory once; each 64-key tile of K
//     (64 x Dh) and of V (64 x DVS) is copied in with cp.async, V landing
//     while Q K^T runs; fragments come out of shared memory with ldmatrix
//     (rows padded by 16 bytes, so the 8 row addresses of an ldmatrix hit
//     distinct banks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128; // 4 warps x 16 query rows
constexpr int PAD = 8;       // bf16 row padding (16 bytes)

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

template <int DVS>
size_t smem_bytes(int d) {
  return sizeof(bf16) * ((size_t)(BQ + BK) * (d + PAD) + (size_t)BK * (DVS + PAD));
}

template <int DVS>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int D, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = D + PAD, ldv = DVS + PAD;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * ldq;
  bf16* Vs = Ks + BK * ldq;

  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * T * D;
  const int dv0 = blockIdx.z * DVS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // accumulator row (and row + 8) of this lane
  const int tg = lane & 3;   // accumulator columns 2 tg, 2 tg + 1 of each 8-wide tile
  // ldmatrix row addresses of this lane: A operand (16 x 16 at Q rows),
  // B = K^T (two 8-key tiles x 16 of Dh), B = V (16 keys x two 8-wide tiles)
  const bf16* qa = Qs + (warp * 16 + (lane & 15)) * ldq + (lane >> 4) * 8;
  const bf16* kb = Ks + ((lane & 7) + ((lane >> 4) << 3)) * ldq + ((lane >> 3) & 1) * 8;
  const bf16* vb = Vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldv + (lane >> 4) * 8;

  load_tile_async(Qs, ldq, q + head + (size_t)q0 * D, D, BQ, D, T - q0);

  float acc[DVS / 8][4];
#pragma unroll
  for (int j = 0; j < DVS / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units) of rows g, g + 8
  float l[2] = {0.f, 0.f};              // this lane's share of the running sum

  for (int kt = 0; kt < T; kt += BK) {
    const int nk = T - kt < BK ? T - kt : BK;
    __syncthreads();  // the previous tile's readers of Ks / Vs are done
    load_tile_async(Ks, ldq, k + head + (size_t)kt * D, D, BK, D, nk);
    load_tile_async(Vs, ldv, v + head + (size_t)kt * D + dv0, D, BK, DVS, nk);
    cp_async_wait<1>();  // Q and K have landed; V may still be in flight
    __syncthreads();

    // ---- S = Q K^T over the full head dimension ----
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + kk);
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + j * 8 * ldq + kk);
        mma_bf16(s[j], a, b[0], b[1]);
        mma_bf16(s[j + 1], a, b[2], b[3]);
      }
    }

    // ---- online softmax (log2 domain); keys past T are masked ----
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + j * 8 + 2 * tg + (e & 1);
        const float x = key < T ? s[j][e] * scale_log2 : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < DVS / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // ---- O += P V: P (bf16) straight from S's registers ----
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DVS / 8; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + kk * 16 * ldv + j * 8);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
  }

  // ---- normalise and write this warp's rows (and their LSE) ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / l[r];
    const int row = q0 + warp * 16 + g + 8 * r;
    // the blocks of one query tile (one per O slice) hold identical row
    // statistics: the first writes them
    if (lse != nullptr && blockIdx.z == 0 && tg == 0 && row < T)
      lse[(size_t)blockIdx.y * T + row] = (m[r] + log2f(l[r])) * 0.6931471805599453f;
    if (row < T) {
      bf16* out = o + head + (size_t)row * D + dv0 + 2 * tg;
#pragma unroll
      for (int j = 0; j < DVS / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + j * 8) =
            pack_bf16x2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
  }
}

template <int DVS>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int t,
           int d, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DVS>(d);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DVS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + BQ - 1) / BQ, bh, d / DVS);
  flash_fwd_kernel<DVS><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, t, d,
      sm_scale * 1.4426950408889634f);  // log2(e): the softmax runs on exp2
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: [BH, T, D] contiguous bf16 on the device; D a multiple of 64,
// at most 512. lse: [BH, T] fp32, or null when the caller needs no LSE.
// Returns the cudaError_t of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int bh, int t, int d, float sm_scale, void* stream) {
  if (d % 64 != 0 || d > 512 || d <= 0 || t <= 0 || bh <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the widest O slice that divides D: 256 (128 registers a thread) at most
  float* l = (float*)lse;
  if (d % 256 == 0) return launch<256>(q, k, v, o, l, bh, t, d, sm_scale, s);
  if (d % 128 == 0) return launch<128>(q, k, v, o, l, bh, t, d, sm_scale, s);
  return launch<64>(q, k, v, o, l, bh, t, d, sm_scale, s);
}

}  // extern "C"
