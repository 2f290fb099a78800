// Flash-attention backward (non-causal) for Hopper, fp32 in and out.
//
// Replaces the stock Pallas TPU kernels _flash_attention_bwd_dkv
// (jax/experimental/pallas/ops/tpu/flash_attention.py:941) and
// _flash_attention_bwd_dq (:1287) where the JAX package runs them on fp32
// q, k and v (diffusion.compute_dtype=float32): the U-Net's AttentionBlock in
// diffusion training ([B, 8, 1024, 128] at 512^2) and the codec's
// AttnBlockVQ in codec fine-tuning ([B, 1, 16384, 512]). Given the
// forward's inputs, its output O and LSE and the output gradient dO:
//   Di = rowsum(dO o O)                               (the Di pass)
//   P  = exp2(Q K^T * sm_scale * log2 e - LSE * log2 e)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Di) * sm_scale,
//   dK = dS^T Q,  dQ = dS K,
// all in fp32, as the plain version (ops/blocked_attention.py:
// attention_backward_reference) computes them at fp32. The bf16 backward
// (flash_attention_bwd.cu) is untouched.
//
// What bounds it on the H100: the products. This design runs seven of them
// (dK/dV side: Q K^T, dO V^T, P^T dO, dS^T Q; dQ side: Q K^T, dO V^T, dS K),
// 14 T^2 Dh operations a head, each as 3xTF32 mma.sync (mma_tf32.cuh): three
// TF32 products, for fp32 accuracy. Its least time is 3 x 14 T^2 Dh over the
// TF32 peak.
//
// Design (a simple kernel first, deterministic: no atomics, every sum in a
// fixed order, so two launches give the same bits):
//   * three launches: the Di pass (a warp a row), then one kernel template in
//     two instances. The dK/dV instance keeps R = 16 G keys of K and V in
//     shared memory and streams Q and dO (with the LSE and Di of each query)
//     in tiles of 32 queries; the dQ instance keeps R queries of Q and dO
//     and streams K and V. Both form X1 = A1 B1^T and X2 = A2 B2^T for the
//     tile, four warps each (one 8-column n-tile a warp, every row group),
//     then P and dS elementwise in shared memory, then the products into
//     the gradients, which the warps hold in registers, a warp 16 rows x
//     D / (8 / G) columns: dK += dS^T Q and dV += P^T dO, or dQ += dS K;
//   * G = 8, 4, 2, 1 16-row groups at Dh <= 64, 128, 256, 512; up to Dh 256
//     the streamed tiles are double-buffered (the next one loads under this
//     one's products); above, the shared memory holds one;
//   * rows past T arrive as zeros; a key past T has P = 0 (its LSE-based P
//     would not be), and no gradient row past T is stored;
//   * the tensor cores truncate as they accumulate, so no chain of mma.sync
//     into one accumulator is longer than 12 (X: 32 of Dh; the gradients:
//     one streamed tile); each chain starts from zero
//     and is added to its fp32 sum with one rounding to nearest.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using namespace tf32x3;

constexpr int THREADS = 256;
constexpr int SR = 32;                   // streamed rows a tile
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* d_o;
  const float* lse;                      // [B, H, T]
  const float* di;                       // [B, H, T], the Di pass's output
  float* dq;
  float* dk;
  float* dv;                             // contiguous [B, H, T, D]
  int64_t sq[3], sk[3], sv[3], so[3], sdo[3];
  int h, t;
  float sm_scale, scale_log2;
};

template <int D>
struct Shape {
  static constexpr int G = D <= 64 ? 8 : D <= 128 ? 4 : D <= 256 ? 2 : 1;
  static constexpr int CG = 8 / G;                 // warps sharing a row group's columns
  static constexpr int R = 16 * G;                 // resident rows
  static constexpr int DC = D / CG;
  static constexpr int NT = DC / 8;
  static constexpr int STAGES = D <= 256 ? 2 : 1;
  static constexpr int SETS = G == 1 ? 2 : 1;      // parts summed in turn along Dh
  static constexpr int AS = D + 4, BS = D + 4, PS = SR + 4;
  static constexpr int A2_OFF = R * AS;
  static constexpr int B1_OFF = 2 * R * AS;
  static constexpr int B2_OFF = B1_OFF + STAGES * SR * BS;
  static constexpr int PB_OFF = B2_OFF + STAGES * SR * BS;
  static constexpr int DS_OFF = PB_OFF + R * PS;
  static constexpr int RL_OFF = DS_OFF + R * PS;   // resident LSE * log2 e, Di (dQ side)
  static constexpr int RD_OFF = RL_OFF + R;
  static constexpr int SL_OFF = RD_OFF + R;        // streamed LSE * log2 e, Di (dK/dV side)
  static constexpr int SD_OFF = SL_OFF + STAGES * SR;
  static constexpr int SMEM = (SD_OFF + STAGES * SR) * 4;
  static_assert(DC % 8 == 0, "a warp's columns come in n-tiles of 8");
  static_assert(SMEM <= 232448, "shared memory");
};

// Di = rowsum(dO o O) in fp32, a warp a row of [B * H * T]
__global__ void __launch_bounds__(THREADS) di_pass(const Params p, float* out, int d, int rows) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int bh = row / p.t, tok = row % p.t, b = bh / p.h, hh = bh % p.h;
  const float* o = p.o + b * p.so[0] + hh * p.so[1] + tok * p.so[2];
  const float* g = p.d_o + b * p.sdo[0] + hh * p.sdo[1] + tok * p.sdo[2];
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(g[c], o[c], s);
  s = warp_sum(s);
  if (lane == 0) out[row] = s;
}

// DQ: the dQ instance (resident Q, dO; streamed K, V); else dK and dV
// (resident K, V; streamed Q, dO)
template <int D, bool DQ>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_f32(const Params p) {
  using S = Shape<D>;
  extern __shared__ __align__(16) float sm[];
  float* a1s = sm;
  float* a2s = sm + S::A2_OFF;
  float* b1s = sm + S::B1_OFF;
  float* b2s = sm + S::B2_OFF;
  float* pbs = sm + S::PB_OFF;
  float* dss = sm + S::DS_OFF;
  float* rls = sm + S::RL_OFF;
  float* rds = sm + S::RD_OFF;
  float* sls = sm + S::SL_OFF;
  float* sds = sm + S::SD_OFF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int bh = blockIdx.y, b = bh / p.h, hh = bh % p.h;
  const int res0 = blockIdx.x * S::R;
  const int64_t* sa1 = DQ ? p.sq : p.sk;
  const int64_t* sa2 = DQ ? p.sdo : p.sv;
  const int64_t* sb1 = DQ ? p.sk : p.sq;
  const int64_t* sb2 = DQ ? p.sv : p.sdo;
  const float* a1g = (DQ ? p.q : p.k) + b * sa1[0] + hh * sa1[1];
  const float* a2g = (DQ ? p.d_o : p.v) + b * sa2[0] + hh * sa2[1];
  const float* b1g = (DQ ? p.k : p.q) + b * sb1[0] + hh * sb1[1];
  const float* b2g = (DQ ? p.v : p.d_o) + b * sb2[0] + hh * sb2[1];
  const float* lse = p.lse + static_cast<int64_t>(bh) * p.t;
  const float* di = p.di + static_cast<int64_t>(bh) * p.t;
  const int n_tiles = (p.t + SR - 1) / SR;

  // a streamed tile (and, on the dK/dV side, its rows' LSE and Di) into a stage
  auto load_tile = [&](int j, int stage) {
    load_rows<D, THREADS>(b1s + stage * SR * S::BS, S::BS, b1g, sb1[2], j * SR, SR, p.t);
    load_rows<D, THREADS>(b2s + stage * SR * S::BS, S::BS, b2g, sb2[2], j * SR, SR, p.t);
    if (!DQ && threadIdx.x < SR) {
      const int row = j * SR + threadIdx.x;
      sls[stage * SR + threadIdx.x] = row < p.t ? lse[row] * LOG2E : 0.f;
      sds[stage * SR + threadIdx.x] = row < p.t ? di[row] : 0.f;
    }
  };

  load_rows<D, THREADS>(a1s, S::AS, a1g, sa1[2], res0, S::R, p.t);
  load_rows<D, THREADS>(a2s, S::AS, a2g, sa2[2], res0, S::R, p.t);
  if (DQ && threadIdx.x < S::R) {
    const int row = res0 + threadIdx.x;
    rls[threadIdx.x] = row < p.t ? lse[row] * LOG2E : 0.f;
    rds[threadIdx.x] = row < p.t ? di[row] : 0.f;
  }
  load_tile(0, 0);
  cp_async_commit();

  // the gradients: DQ: acc1 = dQ; else acc1 = dK, acc2 = dV
  float acc1[S::NT][4], acc2[DQ ? 1 : S::NT][4];
#pragma unroll
  for (int i = 0; i < S::NT; ++i) acc1[i][0] = acc1[i][1] = acc1[i][2] = acc1[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < (DQ ? 1 : S::NT); ++i) acc2[i][0] = acc2[i][1] = acc2[i][2] = acc2[i][3] = 0.f;
  const int which = warp / 4, xnt = warp % 4;      // X phase: X1 or X2, an n-tile
  const int rg = warp / S::CG, cg = warp % S::CG;  // products: rows and columns

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = S::STAGES == 2 ? j & 1 : 0;
    if (S::STAGES == 2) {
      if (j + 1 < n_tiles) load_tile(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* bst1 = b1s + stage * SR * S::BS;
    const float* bst2 = b2s + stage * SR * S::BS;
    // X = A B^T for one 8-column n-tile of the streamed rows, every row
    // group, in chunks of 32 of Dh a part, each summed apart and then added in
    float x[S::G][4];
#pragma unroll
    for (int i = 0; i < S::G; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
    {
      const float* as = which ? a2s : a1s;
      const float* bs = (which ? bst2 : bst1) + xnt * 8 * S::BS;
      for (int kc = 0; kc < D / 8; kc += 4 * S::SETS) {
        float part[S::SETS][S::G][4];
#pragma unroll
        for (int s = 0; s < S::SETS; ++s)
#pragma unroll
          for (int i = 0; i < S::G; ++i)
            part[s][i][0] = part[s][i][1] = part[s][i][2] = part[s][i][3] = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < 4 * S::SETS; ++k2) {
          const int kk = kc + k2;
          uint32_t bhi[2], blo[2];
          load_b_nk(bhi, blo, bs + kk * 8, S::BS, g, tq);
#pragma unroll
          for (int i = 0; i < S::G; ++i) {
            uint32_t ah[4], al[4];
            load_a(ah, al, as + i * 16 * S::AS + kk * 8, S::AS, g, tq);
            mma3(part[k2 % S::SETS][i], ah, al, bhi, blo);
          }
        }
#pragma unroll
        for (int i = 0; i < S::G; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[i][e] += S::SETS == 2 ? part[0][i][e] + part[S::SETS - 1][i][e] : part[0][i][e];
      }
    }
    const int col = xnt * 8 + 2 * tq;
    if (which == 1) {                                // dP, raw
#pragma unroll
      for (int i = 0; i < S::G; ++i) {
        *reinterpret_cast<float2*>(dss + (i * 16 + g) * S::PS + col) = make_float2(x[i][0], x[i][1]);
        *reinterpret_cast<float2*>(dss + (i * 16 + g + 8) * S::PS + col) =
            make_float2(x[i][2], x[i][3]);
      }
    }
    __syncthreads();
    if (which == 0) {                                // P and dS from X1 and dP
#pragma unroll
      for (int i = 0; i < S::G; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = i * 16 + g + (e >> 1) * 8, c = col + (e & 1);
          const float l2 = DQ ? rls[r] : sls[stage * SR + c];
          const float dd = DQ ? rds[r] : sds[stage * SR + c];
          const float pv = j * SR + c < p.t ? exp2f(x[i][e] * p.scale_log2 - l2) : 0.f;
          const float ds = pv * (dss[r * S::PS + c] - dd) * p.sm_scale;
          dss[r * S::PS + c] = ds;
          if (!DQ) pbs[r * S::PS + c] = pv;
        }
    }
    __syncthreads();
    // dQ += dS K, or dK += dS^T Q and dV += P^T dO (the transposes are the
    // resident side's rows): the tile's part summed apart for each n-tile,
    // then added with one rounding
    uint32_t dh[SR / 8][4], dl[SR / 8][4], ph[DQ ? 1 : SR / 8][4], pl[DQ ? 1 : SR / 8][4];
#pragma unroll
    for (int kk = 0; kk < SR / 8; ++kk) {
      load_a(dh[kk], dl[kk], dss + rg * 16 * S::PS + kk * 8, S::PS, g, tq);
      if (!DQ) load_a(ph[DQ ? 0 : kk], pl[DQ ? 0 : kk], pbs + rg * 16 * S::PS + kk * 8, S::PS, g, tq);
    }
#pragma unroll
    for (int i = 0; i < S::NT; ++i) {
      const int c0 = cg * S::DC + i * 8;
      float part1[4] = {0.f, 0.f, 0.f, 0.f}, part2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < SR / 8; ++kk) {
        uint32_t bhi[2], blo[2];
        load_b_kn(bhi, blo, bst1 + kk * 8 * S::BS + c0, S::BS, g, tq);
        mma3(part1, dh[kk], dl[kk], bhi, blo);
        if (!DQ) {
          load_b_kn(bhi, blo, bst2 + kk * 8 * S::BS + c0, S::BS, g, tq);
          mma3(part2, ph[DQ ? 0 : kk], pl[DQ ? 0 : kk], bhi, blo);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc1[i][e] += part1[e];
        if (!DQ) acc2[DQ ? 0 : i][e] += part2[e];
      }
    }
    __syncthreads();
    if (S::STAGES == 1 && j + 1 < n_tiles) {
      load_tile(j + 1, 0);
      cp_async_commit();
    }
  }

  const int ra = res0 + rg * 16 + g, rb = ra + 8;
  const int64_t base = static_cast<int64_t>(bh) * p.t * D;
  float* out1 = (DQ ? p.dq : p.dk) + base;
#pragma unroll
  for (int i = 0; i < S::NT; ++i) {
    const int c0 = cg * S::DC + i * 8 + 2 * tq;
    if (ra < p.t) {
      *reinterpret_cast<float2*>(out1 + static_cast<int64_t>(ra) * D + c0) =
          make_float2(acc1[i][0], acc1[i][1]);
      if (!DQ)
        *reinterpret_cast<float2*>(p.dv + base + static_cast<int64_t>(ra) * D + c0) =
            make_float2(acc2[DQ ? 0 : i][0], acc2[DQ ? 0 : i][1]);
    }
    if (rb < p.t) {
      *reinterpret_cast<float2*>(out1 + static_cast<int64_t>(rb) * D + c0) =
          make_float2(acc1[i][2], acc1[i][3]);
      if (!DQ)
        *reinterpret_cast<float2*>(p.dv + base + static_cast<int64_t>(rb) * D + c0) =
            make_float2(acc2[DQ ? 0 : i][2], acc2[DQ ? 0 : i][3]);
    }
  }
}

template <int D, bool DQ>
cudaError_t launch_side(const Params& p, int bh, cudaStream_t stream) {
  using S = Shape<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_f32<D, DQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return err;
  flash_bwd_f32<D, DQ><<<dim3((p.t + S::R - 1) / S::R, bh), THREADS, S::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
int launch(const Params& p, int bh, cudaStream_t stream) {
  di_pass<<<(bh * p.t + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, stream>>>(
      p, const_cast<float*>(p.di), D, bh * p.t);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_side<D, false>(p, bh, stream);
  if (err == cudaSuccess) err = launch_side<D, true>(p, bh, stream);
  return (int)err;
}

}  // namespace

extern "C" {

// Device bytes of the backward's workspace: the Di pass's output, fp32 [B * H, T].
size_t flash_attention_bwd_f32_workspace(int bh, int t, int d) {
  (void)d;
  return (static_cast<size_t>(bh) * t * 4 + 255) / 256 * 256;
}

// q, k, v, o, d_o: fp32 [B, H, T, D] on the device, last dimension contiguous;
// strides: their element strides {batch, head, token} (15 values), each a
// multiple of 4 (16 bytes), bases 16-byte aligned. lse: contiguous fp32
// [B, H, T]; dq, dk, dv: contiguous fp32 [B, H, T, D]; workspace:
// flash_attention_bwd_f32_workspace bytes. D a multiple of 64, at most 512.
// Returns the first cudaError_t of the three launches.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                            const void* d_o, const void* lse, void* dq, void* dk, void* dv,
                            void* workspace, int b, int h, int t, int d, const int64_t* strides,
                            float sm_scale, void* stream) {
  if (d % 64 != 0 || d > 512 || d <= 0 || t <= 0 || b <= 0 || h <= 0 || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  Params p = {(const float*)q, (const float*)k, (const float*)v, (const float*)o,
              (const float*)d_o, (const float*)lse, (const float*)workspace, (float*)dq,
              (float*)dk, (float*)dv, {}, {}, {}, {}, {}, h, t, sm_scale,
              sm_scale * LOG2E};
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
    p.sdo[i] = strides[12 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64: return launch<64>(p, b * h, s);
    case 128: return launch<128>(p, b * h, s);
    case 192: return launch<192>(p, b * h, s);
    case 256: return launch<256>(p, b * h, s);
    case 320: return launch<320>(p, b * h, s);
    case 384: return launch<384>(p, b * h, s);
    case 448: return launch<448>(p, b * h, s);
    case 512: return launch<512>(p, b * h, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
