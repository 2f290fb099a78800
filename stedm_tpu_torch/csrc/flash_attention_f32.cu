// Flash-attention forward (non-causal) for Hopper, fp32 in and out.
//
// Replaces the stock Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention (_flash_attention_impl,
// flash_attention.py:589) where the JAX package runs it on fp32 q, k and v:
// with diffusion.compute_dtype=float32, the U-Net's AttentionBlock
// (stedm_tpu/ops/blocked_attention.py:flash_sdpa, [2B, 8, 256, 128] when
// sampling at 256^2, [B, 8, 1024, 128] when training at 512^2) and the
// codec's AttnBlockVQ (stedm_tpu/models/vq.py:89, [B, 1, 4096, 512] and
// [B, 1, 16384, 512]). Computes O = softmax(Q K^T * sm_scale) V with fp32
// logits, an fp32 running max and sum per query row, and P kept in fp32, as
// the plain version (ops/blocked_attention.py:attention_reference) does at
// fp32; keys past T are masked. When asked, it also writes the fp32
// log-sum-exp of each row, which the backward (flash_attention_bwd_f32.cu)
// uses to rebuild P. The bf16 kernels (flash_attention.cu) are untouched.
//
// What bounds it on the H100: the two products, 4 T^2 Dh operations a head
// against 16 T Dh bytes. At fp32 the products must keep fp32 accuracy, so
// TF32 alone (10-bit mantissa) will not do; they run as 3xTF32 mma.sync
// (mma_tf32.cuh), three TF32 products each, whose least time is 3 x 4 T^2 Dh
// over the TF32 peak (about 2.5x less than the same work in fp32 FFMA).
//
// Design (a simple kernel first):
//   * a block of 8 warps owns BR query rows of one head (128 at Dh <= 128,
//     64 at Dh <= 256, 32 above) and walks over key tiles of 32; Q stays in
//     shared memory, K and V tiles come in by cp.async, the K tile of the
//     next step loading under this step's softmax and P V, the V tile under
//     the next step's Q K^T;
//   * a warp owns 16 query rows x D / CG columns of O in registers; S = Q K^T
//     is split over the warps by (16 rows, 8-key n-tile) tiles and stored to
//     shared memory, where one warp a row takes the row's 32 keys, one a
//     lane: max, exp2, sum and the rescale factor with warp shuffles; then
//     every warp rescales its O rows and adds P V;
//   * the row pitches of the tiles in shared memory (D + 4 floats for Q and
//     K, D + 8 for V, 36 for S/P) put the fragment loads on distinct banks;
//   * the softmax runs on exp2 with the scale folded into one multiply;
//   * the tensor cores truncate as they accumulate, so no chain of mma.sync
//     into one accumulator is longer than 12 (Q K^T: 64 of Dh, split in two
//     parts; P V: one key tile): each chain starts from zero and is added to
//     the fp32 sum with one rounding to nearest, so the sums over Dh and
//     over the keys carry no truncation bias that grows with their length.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using namespace tf32x3;

constexpr int THREADS = 256;
constexpr int BC = 32;                   // keys a tile: one a lane in the row pass

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  int64_t sq[3], sk[3], sv[3], so[3];    // element strides {batch, head, token}
  int h, t;
  float scale_log2;                      // sm_scale * log2(e)
};

template <int D>
struct Shape {
  static constexpr int RG = D <= 128 ? 8 : D <= 256 ? 4 : 2;   // 16-row groups a block
  static constexpr int CG = 8 / RG;                            // warps sharing a row group
  static constexpr int BR = 16 * RG;
  static constexpr int DC = D / CG;                            // O columns a warp
  static constexpr int NT = DC / 8;
  static constexpr int TPW = 4 / CG;                           // S n-tiles a warp
  static constexpr int QS = D + 4, KS = D + 4, VS = D + 8, PS = BC + 4;
  static constexpr int K_OFF = BR * QS;
  static constexpr int V_OFF = K_OFF + BC * KS;
  static constexpr int P_OFF = V_OFF + BC * VS;
  static constexpr int M_OFF = P_OFF + BR * PS;                // running max (log2 domain)
  static constexpr int L_OFF = M_OFF + BR;                     // running sum
  static constexpr int A_OFF = L_OFF + BR;                     // this step's rescale
  static constexpr int SMEM = (A_OFF + BR) * 4;
  static_assert(DC % 8 == 0, "a warp's O columns come in n-tiles of 8");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_f32(const Params p) {
  using S = Shape<D>;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* ks = sm + S::K_OFF;
  float* vs = sm + S::V_OFF;
  float* ps = sm + S::P_OFF;
  float* ms = sm + S::M_OFF;
  float* ls = sm + S::L_OFF;
  float* as = sm + S::A_OFF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int bh = blockIdx.y, b = bh / p.h, hh = bh % p.h;
  const int q0 = blockIdx.x * S::BR;
  const float* qg = p.q + b * p.sq[0] + hh * p.sq[1];
  const float* kg = p.k + b * p.sk[0] + hh * p.sk[1];
  const float* vg = p.v + b * p.sv[0] + hh * p.sv[1];
  const int rg = warp / S::CG, cg = warp % S::CG, r0 = 16 * rg;
  const int n_tiles = (p.t + BC - 1) / BC;

  if (threadIdx.x < S::BR) {
    ms[threadIdx.x] = -INFINITY;
    ls[threadIdx.x] = 0.f;
  }
  load_rows<D, THREADS>(qs, S::QS, qg, p.sq[2], q0, S::BR, p.t);
  load_rows<D, THREADS>(ks, S::KS, kg, p.sk[2], 0, BC, p.t);
  cp_async_commit();
  load_rows<D, THREADS>(vs, S::VS, vg, p.sv[2], 0, BC, p.t);
  cp_async_commit();

  float o[S::NT][4];
#pragma unroll
  for (int i = 0; i < S::NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BC;
    cp_async_wait<1>();                  // Q and this K tile (the V tile may still fly)
    __syncthreads();
    // S = Q K^T: this warp's TPW n-tiles of its row group, in chunks of 64
    // of Dh, each summed apart (two parts in turn) and then added in
    float acc[S::TPW][4];
#pragma unroll
    for (int i = 0; i < S::TPW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int kc = 0; kc < D / 8; kc += 8) {
      float part[2][S::TPW][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < S::TPW; ++i)
          part[s][i][0] = part[s][i][1] = part[s][i][2] = part[s][i][3] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < 8; ++k2) {
        const int kk = kc + k2;
        uint32_t ah[4], al[4];
        load_a(ah, al, qs + r0 * S::QS + kk * 8, S::QS, g, tq);
#pragma unroll
        for (int i = 0; i < S::TPW; ++i) {
          uint32_t bhi[2], blo[2];
          load_b_nk(bhi, blo, ks + 8 * (cg * S::TPW + i) * S::KS + kk * 8, S::KS, g, tq);
          mma3(part[k2 & 1][i], ah, al, bhi, blo);
        }
      }
#pragma unroll
      for (int i = 0; i < S::TPW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += part[0][i][e] + part[1][i][e];
    }
#pragma unroll
    for (int i = 0; i < S::TPW; ++i) {
      const int col = 8 * (cg * S::TPW + i) + 2 * tq;
      *reinterpret_cast<float2*>(ps + (r0 + g) * S::PS + col) = make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(ps + (r0 + g + 8) * S::PS + col) =
          make_float2(acc[i][2], acc[i][3]);
    }
    __syncthreads();
    if (j + 1 < n_tiles) load_rows<D, THREADS>(ks, S::KS, kg, p.sk[2], kv0 + BC, BC, p.t);
    cp_async_commit();
    // the online softmax: a warp a row, a lane a key
    for (int r = warp; r < S::BR; r += THREADS / 32) {
      const float x = kv0 + lane < p.t ? ps[r * S::PS + lane] * p.scale_log2 : -INFINITY;
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float e = exp2f(x - m_new);
      const float sum = warp_sum(e);
      ps[r * S::PS + lane] = e;
      if (lane == 0) {
        const float a = exp2f(m_old - m_new);
        as[r] = a;
        ls[r] = ls[r] * a + sum;
        ms[r] = m_new;
      }
    }
    cp_async_wait<1>();                  // this V tile (the next K tile may still fly)
    __syncthreads();
    // O = O * alpha + P V over this warp's rows and columns: the tile's P V
    // summed apart for each n-tile, then folded in with one rounding
    const float a0 = as[r0 + g], a1 = as[r0 + g + 8];
    uint32_t ph[BC / 8][4], pl[BC / 8][4];
#pragma unroll
    for (int kk = 0; kk < BC / 8; ++kk) load_a(ph[kk], pl[kk], ps + r0 * S::PS + kk * 8, S::PS, g, tq);
#pragma unroll
    for (int i = 0; i < S::NT; ++i) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BC / 8; ++kk) {
        uint32_t bhi[2], blo[2];
        load_b_kn(bhi, blo, vs + kk * 8 * S::VS + cg * S::DC + i * 8, S::VS, g, tq);
        mma3(part, ph[kk], pl[kk], bhi, blo);
      }
      o[i][0] = fmaf(o[i][0], a0, part[0]);
      o[i][1] = fmaf(o[i][1], a0, part[1]);
      o[i][2] = fmaf(o[i][2], a1, part[2]);
      o[i][3] = fmaf(o[i][3], a1, part[3]);
    }
    __syncthreads();
    if (j + 1 < n_tiles) load_rows<D, THREADS>(vs, S::VS, vg, p.sv[2], kv0 + BC, BC, p.t);
    cp_async_commit();
  }

  const int qa = q0 + r0 + g, qb = qa + 8;
  const float inv_a = 1.f / ls[r0 + g], inv_b = 1.f / ls[r0 + g + 8];
  float* og = p.o + b * p.so[0] + hh * p.so[1];
#pragma unroll
  for (int i = 0; i < S::NT; ++i) {
    const int col = cg * S::DC + i * 8 + 2 * tq;
    if (qa < p.t)
      *reinterpret_cast<float2*>(og + qa * p.so[2] + col) = make_float2(o[i][0] * inv_a,
                                                                        o[i][1] * inv_a);
    if (qb < p.t)
      *reinterpret_cast<float2*>(og + qb * p.so[2] + col) = make_float2(o[i][2] * inv_b,
                                                                        o[i][3] * inv_b);
  }
  // the natural LSE of the scaled logits: (m + log2 l) ln 2
  if (p.lse != nullptr && threadIdx.x < S::BR && q0 + static_cast<int>(threadIdx.x) < p.t)
    p.lse[static_cast<int64_t>(bh) * p.t + q0 + threadIdx.x] =
        (ms[threadIdx.x] + log2f(ls[threadIdx.x])) * 0.6931471805599453f;
}

template <int D>
int launch(const Params& p, int b, cudaStream_t stream) {
  using S = Shape<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.t + S::BR - 1) / S::BR, b * p.h);
  flash_fwd_f32<D><<<grid, THREADS, S::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: fp32 [B, H, T, D] on the device, last dimension contiguous;
// strides: the element strides {batch, head, token} of q, k, v and o (12
// values), each a multiple of 4 (16 bytes), bases 16-byte aligned. D a
// multiple of 64, at most 512. lse: contiguous fp32 [B, H, T], or null when
// the caller needs no LSE. Returns the cudaError_t of the launch.
int flash_attention_f32_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int b, int h, int t, int d, const int64_t* strides, float sm_scale,
                            void* stream) {
  if (d % 64 != 0 || d > 512 || d <= 0 || t <= 0 || b <= 0 || h <= 0 || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  Params p = {(const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse,
              {}, {}, {}, {}, h, t, sm_scale * 1.4426950408889634f};
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64: return launch<64>(p, b, s);
    case 128: return launch<128>(p, b, s);
    case 192: return launch<192>(p, b, s);
    case 256: return launch<256>(p, b, s);
    case 320: return launch<320>(p, b, s);
    case 384: return launch<384>(p, b, s);
    case 448: return launch<448>(p, b, s);
    case 512: return launch<512>(p, b, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
