// Flash attention (non-causal) above head dimension 1024 for Hopper, bf16
// and fp32, forward and backward: the band route.
//
// Replaces the stock Pallas TPU kernels of
// jax.experimental.pallas.ops.tpu.flash_attention where the JAX package runs
// them at any head dimension: the forward (_flash_attention_impl,
// flash_attention.py:589) and the backward (_flash_attention_bwd_dkv, :941,
// and _flash_attention_bwd_dq, :1287), reached through
// stedm_tpu/ops/blocked_attention.py:99 (flash_sdpa; the landscape U-Net at
// num_heads 1 with channel_mult [1, 4, 16] attends at Dh 2048, [2B, 1, 256,
// 2048] sampling at 256^2) and stedm_tpu/models/vq.py:89 (AttnBlockVQ; a
// codec with ddconfig.ch_mult [1, 2, 16] has a 2048-wide mid-block, [B, 1,
// 4096 | 16384, 2048] at 256^2 | 512^2). It computes what they compute: O and
// the fp32 LSE forward, dQ, dK and dV backward, P and dS rounded to the
// operands' type before their products as in the other kernels of csrc/.
//
// What bounds it on the H100: the products. Above Dh 1024 a score costs at
// least 4096 operations forward (Q K^T and P V, 2 Dh each), against a few
// bytes of workspace a score, so the band route writes S, P and dS of a band
// of rows to device memory between products instead of keeping a row's
// state on chip, and has no limit of width: no block ever holds a whole row
// of Q (at Dh 2048 64 rows of Q alone take 256 KB). The thread-block
// clusters of the instances up to 1024 (flash_attention.cu) sum S across
// 128-column slices through distributed shared memory, and that exchange,
// not the products, bounds them (PERF.md).
//
// Design: every product is one tiled kernel, band_gemm, C[z] = A[z] B[z]^T
// over 128 x 128 output tiles, both operands K-major (the reduction runs
// along their rows' contiguous columns), read by TMA from 4-D tensor maps
// (so q, k, v and dO are read through their own strides), with a fused
// epilogue:
//   EPI_S       S = Q K^T, fp32, into the band's workspace;
//   EPI_O       the output in the operands' type: O = P V^T', dQ = dS K^T',
//               dV = P^T dO^T', dK = dS^T Q^T' (X^T' a transposed copy of X);
//   EPI_P_ROW   P = exp2(S * scale * log2(e) - LSE[row] * log2(e)), fp32
//               (the backward's query sweep);
//   EPI_P_COL   the same with the LSE of the column (the key sweep, S^T);
//   EPI_DS_ROW  dS = P (dP - Di[row]) * scale in the operands' type, P read
//               back from EPI_P_ROW's output;
//   EPI_DS_COL  dS^T, and P^T in the operands' type (for dV).
// Forward, for a band of query rows: S (EPI_S), a row pass (band_rows: the
// row's max and sum on exp2, the LSE, and P normalised, in the operands'
// type), O (EPI_O). Backward, from a Di pass (band_stats: Di = rowsum(dO o
// O) and LSE * log2(e), as the other backwards' Di passes), two sweeps with
// no atomics, deterministic: a query sweep (P, dS, dQ) and a key sweep (P^T,
// dS^T and P^T, dV, dK). ops/flash_band.py plans the bands (heads and rows
// in flight, bounded by a workspace budget) and launches them.
//
// band_gemm: a block is three warpgroups, two consumers of 64 output rows
// each and a producer (setmaxnreg 240 / 24), one thread of which keeps TMA
// loads of 128-row A and B tiles of 128 bytes a row (64 bf16 or 32 fp32
// columns, the 128-byte swizzle) in flight through a ring of stages with
// full / empty mbarriers. bf16: m64n128k16 wgmma, fp32 accumulation. fp32:
// 3xTF32 (wgmma_tf32.cuh: the split halves of each operand, hi and lo, are
// TMA-loaded like any tile; A_lo B_hi + A_hi B_lo + A_hi B_hi), m64n128k8.
// The tensor cores truncate as they accumulate (flash_attention_f32.cu), so
// a chain of wgmma into one accumulator is capped (fp32: 4 k-steps, one
// stage; bf16: 16 k-steps, four stages) and each chain is added to an fp32
// sum in registers: the reductions here run over up to T = 16384 keys.
// Operands whose reduction runs along tokens are transposed once by a copy
// pass (band_transpose, bf16; band_split writes fp32's TF32 halves,
// natural and transposed), so every product has both operands K-major.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_async.cuh"
#include "wgmma_sm90.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 3 * WG;     // two consumer warpgroups, then the producer's
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int BM = 128, BN = 128;   // the output tile
constexpr int TILE = 128 * 128;     // bytes of a 128-row tile of 128-byte rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

enum { EPI_S = 0, EPI_O = 1, EPI_P_ROW = 2, EPI_P_COL = 3, EPI_DS_ROW = 4, EPI_DS_COL = 5 };

// bf16: one array an operand, k-tiles of 64 columns, chains of 4 k-tiles
// (16 k-steps); fp32: the hi and lo halves, k-tiles of 32 columns, chains of
// one k-tile (4 k-steps of 8: the cap of flash_attention_f32.cu).
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int BK = 64, PARTS = 1, STAGES = 6, CHAIN = 4;
  static constexpr int STAGE_BYTES = 2 * TILE;
};
template <>
struct Cfg<float> {
  static constexpr int BK = 32, PARTS = 2, STAGES = 3, CHAIN = 1;
  static constexpr int STAGE_BYTES = 4 * TILE;
};

template <typename T>
constexpr int smem_bytes() {
  return Cfg<T>::STAGES * Cfg<T>::STAGE_BYTES + 16 * Cfg<T>::STAGES + 1024;
}

struct GemmParams {
  int m, n, nk;                 // rows and columns of C stored, k-tiles
  // A's tile row r at map row a_row0 + r; block z at the map's (c2, c3) =
  // ((a_z0 + z) % a_n2, (a_z0 + z) / a_n2), the lo half of an fp32 split at c3 + 1
  int a_row0, a_z0, a_n2, b_row0, b_z0, b_n2;
  void* c;                      // the output
  void* c2;                     // EPI_DS_COL: P^T in the operands' type
  const float* p_in;            // EPI_DS_*: P, fp32, laid out as c
  const float* lse2;            // EPI_P_*: LSE * log2(e), [BH, T]
  const float* di;              // EPI_DS_*: Di, [BH, T]
  int64_t ldc, zs, half;        // a workspace output: (z, m, n) at z zs + m ldc + n; fp32
                                // operands' lo half `half` elements on
  int64_t o_sb, o_sh, o_st;     // EPI_O: element strides of the [B, H, T, *] output
  int h, z0, row0, t;           // heads; head of block z: z0 + z; token of row m: row0 + m
  float scale;                  // EPI_P_*: sm_scale * log2(e); EPI_DS_*: sm_scale
};

__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// An A operand of a later product: bf16 as it is, fp32 as its TF32 halves.
__device__ __forceinline__ void put_operand(bf16* p, int64_t, float a, float b) { put2(p, a, b); }

__device__ __forceinline__ void put_operand(float* p, int64_t half, float a, float b) {
  uint32_t ah, al, bh, bl;
  tf32w::split(a, ah, al);
  tf32w::split(b, bh, bl);
  put2(p, __uint_as_float(ah), __uint_as_float(bh));
  put2(p + half, __uint_as_float(al), __uint_as_float(bl));
}

// Thread lt of consumer cw holds, in acc[4 j + e], row 64 cw + 16 (lt / 32) +
// (lt % 32) / 4 + 8 (e / 2) and column 8 j + 2 (lt % 4) + (e % 2) of the tile.
template <typename T, int EPI>
__device__ __forceinline__ void epilogue(const GemmParams& p, const float (&acc)[64], int z,
                                         int m0, int n0, int lt) {
  const int zz = p.z0 + z;
  const int64_t vec = (int64_t)zz * p.t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + 16 * (lt / 32) + (lt % 32) / 4 + 8 * r;
    if (m >= p.m) continue;
    const int tok = p.row0 + m;
    const bool row_ok = tok < p.t;
    const int64_t at = (int64_t)z * p.zs + (int64_t)m * p.ldc;
    float rv = 0.f;
    if (EPI == EPI_P_ROW && row_ok) rv = p.lse2[vec + tok];
    if (EPI == EPI_DS_ROW && row_ok) rv = p.di[vec + tok];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lt % 4);
      if (n >= p.n) continue;
      float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
      if (EPI == EPI_S) {
        put2(static_cast<float*>(p.c) + at + n, v0, v1);
      } else if (EPI == EPI_O) {
        if (row_ok)
          put2(static_cast<T*>(p.c) + (zz / p.h) * p.o_sb + (zz % p.h) * p.o_sh +
                   (int64_t)tok * p.o_st + n, v0, v1);
      } else if (EPI == EPI_P_ROW || EPI == EPI_P_COL) {
        const bool ok0 = row_ok && n < p.t, ok1 = row_ok && n + 1 < p.t;
        float l0 = rv, l1 = rv;
        if (EPI == EPI_P_COL) {
          l0 = ok0 ? p.lse2[vec + n] : 0.f;
          l1 = ok1 ? p.lse2[vec + n + 1] : 0.f;
        }
        v0 = ok0 ? exp2f(fmaf(v0, p.scale, -l0)) : 0.f;
        v1 = ok1 ? exp2f(fmaf(v1, p.scale, -l1)) : 0.f;
        put2(static_cast<float*>(p.c) + at + n, v0, v1);
      } else {
        // P is 0 wherever the row or the column is past T, and so is dS there
        const float2 pp = *reinterpret_cast<const float2*>(p.p_in + at + n);
        float d0 = rv, d1 = rv;
        if (EPI == EPI_DS_COL) {
          d0 = row_ok && n < p.t ? p.di[vec + n] : 0.f;
          d1 = row_ok && n + 1 < p.t ? p.di[vec + n + 1] : 0.f;
        }
        put_operand(static_cast<T*>(p.c) + at + n, p.half, pp.x * (v0 - d0) * p.scale,
                    pp.y * (v1 - d1) * p.scale);
        if (EPI == EPI_DS_COL) put_operand(static_cast<T*>(p.c2) + at + n, p.half, pp.x, pp.y);
      }
    }
  }
}

// One k-tile of a consumer's chain: 64 rows of A against the 128 rows of B.
__device__ __forceinline__ void k_tile(float (&part)[64], uint32_t a_s, uint32_t b_s,
                                       bool first, bf16*) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)     // k-steps of 16 columns, 32 bytes of a row
    wgmma::ss<0>(part, wgmma::descriptor(a_s / 16 + kk * 2, 16),
                 wgmma::descriptor(b_s / 16 + kk * 2, 16), first && kk == 0 ? 0 : 1);
}

__device__ __forceinline__ void k_tile(float (&part)[64], uint32_t a_s, uint32_t b_s,
                                       bool first, float*) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)     // k-steps of 8 columns; the lo halves a tile on
    tf32w::ss3(part, a_s + kk * 32, TILE, b_s + kk * 32, TILE, first && kk == 0);
}

template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
band_gemm(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
          const GemmParams p) {
  using C = Cfg<T>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * C::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      const int az = p.a_z0 + z, bz = p.b_z0 + z;
      const int a2 = az % p.a_n2, a3 = az / p.a_n2, b2 = bz % p.b_n2, b3 = bz / p.b_n2;
      for (int i = 0; i < p.nk; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), C::STAGE_BYTES);
        const uint32_t st = base + s * C::STAGE_BYTES;
#pragma unroll
        for (int part = 0; part < C::PARTS; ++part) {
          tma_load(st + part * TILE, &map_a, full(s), i * C::BK, p.a_row0 + m0, a2, a3 + part);
          tma_load(st + (C::PARTS + part) * TILE, &map_b, full(s), i * C::BK, p.b_row0 + n0, b2,
                   b3 + part);
        }
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int cw = wg, lt = threadIdx.x % WG;
    float acc[64], part[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    for (int i0 = 0; i0 < p.nk; i0 += C::CHAIN) {      // a chain of CHAIN k-tiles into part
      const int i1 = i0 + C::CHAIN < p.nk ? i0 + C::CHAIN : p.nk;
      tf32w::fresh(part);
      for (int i = i0; i < i1; ++i) {
        const int s = i % STAGES;
        mbar_wait(full(s), (i / STAGES) & 1);
        const uint32_t st = base + s * C::STAGE_BYTES;
        wgmma::fence();
        k_tile(part, st + cw * 64 * 128, st + C::PARTS * TILE, i == i0, static_cast<T*>(nullptr));
        wgmma::commit();
        if (i > i0) {                                  // the k-tile before has landed
          wgmma::wait<1>();
          mbar_arrive(empty((i - 1) % STAGES));
        }
      }
      wgmma::wait<0>();
      tf32w::fence_operand(part);
      mbar_arrive(empty((i1 - 1) % STAGES));
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += part[e];
    }
    epilogue<T, EPI>(p, acc, z, m0 + cw * 64, n0, lt);
  }
}

// ---------------------------------------------------------------------------
// The forward's row pass: a row of S (fp32, columns past T ignored) to its
// max and sum on exp2, the LSE (natural log, [BH, T]) and P normalised, in
// the operands' type, zeros from column T to the row's end. One block a row.
// ---------------------------------------------------------------------------

constexpr int ROW_THREADS = 256;

struct RowParams {
  int m, t, tp, z0, row0;
  int64_t ldc, zs, half;
  float scale2;                 // sm_scale * log2(e)
};

__device__ __forceinline__ void combine(float& m, float& l, float m2, float l2) {
  const float mm = fmaxf(m, m2);
  l = mm == -INFINITY ? 0.f : l * exp2f(m - mm) + l2 * exp2f(m2 - mm);
  m = mm;
}

__device__ __forceinline__ void put4(bf16* p, int64_t, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

__device__ __forceinline__ void put4(float* p, int64_t half, const float (&v)[4]) {
  float4 hi, lo;
  float* h = &hi.x;
  float* l = &lo.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t a, b;
    tf32w::split(v[e], a, b);
    h[e] = __uint_as_float(a);
    l[e] = __uint_as_float(b);
  }
  *reinterpret_cast<float4*>(p) = hi;
  *reinterpret_cast<float4*>(p + half) = lo;
}

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
band_rows(const float* __restrict__ s, T* __restrict__ pw, float* __restrict__ lse,
          const RowParams p) {
  __shared__ float red[2][ROW_THREADS / 32];
  const int m = blockIdx.x, z = blockIdx.y;
  const int64_t at = (int64_t)z * p.zs + (int64_t)m * p.ldc;
  const float* row = s + at;
  float mx = -INFINITY, l = 0.f;
  for (int c = 4 * threadIdx.x; c < p.t; c += 4 * ROW_THREADS) {
    const float4 x = *reinterpret_cast<const float4*>(row + c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < p.t) combine(mx, l, xs[e] * p.scale2, 1.f);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, mx, o), l2 = __shfl_xor_sync(0xffffffffu, l, o);
    combine(mx, l, m2, l2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = mx;
    red[1][warp] = l;
  }
  __syncthreads();
  mx = red[0][0];
  l = red[1][0];
#pragma unroll
  for (int w = 1; w < ROW_THREADS / 32; ++w) combine(mx, l, red[0][w], red[1][w]);
  const float lse2 = mx + log2f(l);
  if (lse != nullptr && threadIdx.x == 0)
    lse[(int64_t)(p.z0 + z) * p.t + p.row0 + m] = lse2 * LN2;
  for (int c = 4 * threadIdx.x; c < p.tp; c += 4 * ROW_THREADS) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (c < p.t) {
      const float4 x = *reinterpret_cast<const float4*>(row + c);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < p.t) v[e] = exp2f(fmaf(xs[e], p.scale2, -lse2));
    }
    put4(pw + at + c, p.half, v);
  }
}

// ---------------------------------------------------------------------------
// The copy passes, for heads z0 .. of a [B, H, T, W] tensor (any batch,
// head and token strides, last dimension contiguous), a 32-token x
// 32-column tile a block: bf16 transposed, [cap, W, TP] (tokens in [T, TP)
// written as zeros); fp32 as TF32 hi and lo halves, natural [2, cap, T, W]
// and / or transposed [2, cap, W, TP].
// ---------------------------------------------------------------------------

struct CopyParams {
  int64_t sb, sh, st;
  int h, z0, cap, t, w, tp;   // cap: the heads the copies hold (the lo halves' offset)
};

__global__ void __launch_bounds__(256)
band_transpose(const bf16* __restrict__ x, bf16* __restrict__ tr, const CopyParams p) {
  __shared__ bf16 tile[32][34];
  const int t0 = blockIdx.x * 32, d0 = blockIdx.y * 32, z = blockIdx.z, zz = p.z0 + z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const bf16* src = x + (zz / p.h) * p.sb + (zz % p.h) * p.sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int tok = t0 + ty + 8 * r;
    tile[ty + 8 * r][tx] = tok < p.t && d0 + tx < p.w ? src[tok * p.st + d0 + tx]
                                                        : __float2bfloat16(0.f);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int dd = ty + 8 * r;
    if (d0 + dd < p.w && t0 + tx < p.tp)
      tr[((int64_t)z * p.w + d0 + dd) * p.tp + t0 + tx] = tile[tx][dd];
  }
}

__global__ void __launch_bounds__(256)
band_split(const float* __restrict__ x, float* __restrict__ nat, float* __restrict__ tr,
           const CopyParams p) {
  __shared__ float tile[32][33];
  const int t0 = blockIdx.x * 32, d0 = blockIdx.y * 32, z = blockIdx.z, zz = p.z0 + z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* src = x + (zz / p.h) * p.sb + (zz % p.h) * p.sh;
  const int64_t nat_half = (int64_t)p.cap * p.t * p.w, tr_half = (int64_t)p.cap * p.w * p.tp;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int tok = t0 + ty + 8 * r;
    const float v = tok < p.t && d0 + tx < p.w ? src[tok * p.st + d0 + tx] : 0.f;
    tile[ty + 8 * r][tx] = v;
    if (nat != nullptr && tok < p.t && d0 + tx < p.w) {
      uint32_t hi, lo;
      tf32w::split(v, hi, lo);
      const int64_t at = ((int64_t)z * p.t + tok) * p.w + d0 + tx;
      nat[at] = __uint_as_float(hi);
      nat[nat_half + at] = __uint_as_float(lo);
    }
  }
  if (tr == nullptr) return;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int dd = ty + 8 * r;
    if (d0 + dd >= p.w || t0 + tx >= p.tp) continue;
    uint32_t hi, lo;
    tf32w::split(tile[tx][dd], hi, lo);
    const int64_t at = ((int64_t)z * p.w + d0 + dd) * p.tp + t0 + tx;
    tr[at] = __uint_as_float(hi);
    tr[tr_half + at] = __uint_as_float(lo);
  }
}

// ---------------------------------------------------------------------------
// The backward's Di pass: Di = rowsum(dO o O) in fp32 and LSE * log2(e),
// [BH, T] each; one warp a row.
// ---------------------------------------------------------------------------

struct StatsParams {
  int64_t o_sb, o_sh, o_st, d_sb, d_sh, d_st;
  int h, rows, t, w;
};

__device__ __forceinline__ float row_dot(const bf16* o, const bf16* d, int w, int lane) {
  float s = 0.f;
  for (int c = 8 * lane; c < w; c += 256) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + c);
    const uint4 g = *reinterpret_cast<const uint4*>(d + c);
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, gw[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 af = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[k]));
      const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[k]));
      s = fmaf(af.x, gf.x, fmaf(af.y, gf.y, s));
    }
  }
  return s;
}

__device__ __forceinline__ float row_dot(const float* o, const float* d, int w, int lane) {
  float s = 0.f;
  for (int c = 4 * lane; c < w; c += 128) {
    const float4 a = *reinterpret_cast<const float4*>(o + c);
    const float4 g = *reinterpret_cast<const float4*>(d + c);
    s = fmaf(a.x, g.x, fmaf(a.y, g.y, fmaf(a.z, g.z, fmaf(a.w, g.w, s))));
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(256)
band_stats(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
           float* __restrict__ lse2, float* __restrict__ di, const StatsParams p) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= p.rows) return;
  const int zz = row / p.t, tok = row % p.t, b = zz / p.h, hh = zz % p.h;
  float s = row_dot(o + b * p.o_sb + hh * p.o_sh + tok * p.o_st,
                    dout + b * p.d_sb + hh * p.d_sh + tok * p.d_st, p.w, lane);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) {
    di[row] = s;
    lse2[row] = lse[row] * LOG2E;
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// A [n3, n2, rows, cols] view with element strides {s_row, s2, s3} (g: cols,
// rows, n2, n3, s_row, s2, s3) as the 4-D map {cols, rows, n2, n3}, read in
// 128-row boxes of 128 bytes (64 bf16 or 32 fp32 columns) in the 128-byte
// swizzle; rows and columns past the view's arrive as zeros.
bool make_operand_map(CUtensorMap* map, bool f32, const void* ptr, const int64_t* g) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int es = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1], (cuuint64_t)g[2],
                              (cuuint64_t)g[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[4] * es, (cuuint64_t)g[5] * es,
                                 (cuuint64_t)g[6] * es};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), 128, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int EPI>
cudaError_t launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb, const GemmParams& p,
                        int z, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        band_gemm<T, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((p.m + BM - 1) / BM, (p.n + BN - 1) / BN, z);
  band_gemm<T, EPI><<<grid, THREADS, smem_bytes<T>(), stream>>>(ma, mb, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_epi(int epi, const CUtensorMap& ma, const CUtensorMap& mb,
                       const GemmParams& p, int z, cudaStream_t stream) {
  switch (epi) {
    case EPI_S: return launch_gemm<T, EPI_S>(ma, mb, p, z, stream);
    case EPI_O: return launch_gemm<T, EPI_O>(ma, mb, p, z, stream);
    case EPI_P_ROW: return launch_gemm<T, EPI_P_ROW>(ma, mb, p, z, stream);
    case EPI_P_COL: return launch_gemm<T, EPI_P_COL>(ma, mb, p, z, stream);
    case EPI_DS_ROW: return launch_gemm<T, EPI_DS_ROW>(ma, mb, p, z, stream);
    case EPI_DS_COL: return launch_gemm<T, EPI_DS_COL>(ma, mb, p, z, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// C[z] (z < Z) = A[z] B[z]^T with epilogue `epi` (EPI_* above), operands
// bf16 (f32 = 0) or the TF32 halves of fp32 ones (f32 = 1: each operand a
// [2, ...] split whose c3 coordinate 0 is hi, 1 lo). ga, gb: each operand's
// view (make_operand_map); q: M, N, K, Z, a_row0, a_z0, b_row0, b_z0 (A's
// rows a_row0 .. of views a_z0 + z; B's likewise); e: ldc, zs, half, o_sb,
// o_sh, o_st, h, z0, row0, t (GemmParams). Returns a cudaError_t.
int flash_band_gemm(int f32, int epi, const void* a, const int64_t* ga, const void* b,
                    const int64_t* gb, const int64_t* q, void* c, void* c2, const float* p_in,
                    const float* lse2, const float* di, const int64_t* e, float scale,
                    cudaStream_t stream) {
  CUtensorMap ma, mb;
  if (!make_operand_map(&ma, f32, a, ga) || !make_operand_map(&mb, f32, b, gb))
    return (int)cudaErrorInvalidValue;
  GemmParams p;
  const int bk = f32 ? Cfg<float>::BK : Cfg<bf16>::BK;
  p.m = (int)q[0];
  p.n = (int)q[1];
  p.nk = (int)((q[2] + bk - 1) / bk);
  p.a_row0 = (int)q[4];
  p.a_z0 = (int)q[5];
  p.a_n2 = (int)ga[2];
  p.b_row0 = (int)q[6];
  p.b_z0 = (int)q[7];
  p.b_n2 = (int)gb[2];
  p.c = c;
  p.c2 = c2;
  p.p_in = p_in;
  p.lse2 = lse2;
  p.di = di;
  p.ldc = e[0];
  p.zs = e[1];
  p.half = e[2];
  p.o_sb = e[3];
  p.o_sh = e[4];
  p.o_st = e[5];
  p.h = (int)e[6];
  p.z0 = (int)e[7];
  p.row0 = (int)e[8];
  p.t = (int)e[9];
  p.scale = scale;
  const cudaError_t err = f32 ? launch_epi<float>(epi, ma, mb, p, (int)q[3], stream)
                              : launch_epi<bf16>(epi, ma, mb, p, (int)q[3], stream);
  return (int)err;
}

// The row pass over S [Z, M rows, ldc] (g: M, Z, ldc, zs, half, t, tp, z0,
// row0): P into pw (bf16 [Z, M, ldc], or fp32 TF32 halves `half` apart),
// the LSE of row m of view z at lse[(z0 + z) T + row0 + m] when lse is not null.
int flash_band_rows(int f32, const float* s, void* pw, float* lse, const int64_t* g,
                    float scale2, cudaStream_t stream) {
  RowParams p;
  p.m = (int)g[0];
  p.ldc = g[2];
  p.zs = g[3];
  p.half = g[4];
  p.t = (int)g[5];
  p.tp = (int)g[6];
  p.z0 = (int)g[7];
  p.row0 = (int)g[8];
  p.scale2 = scale2;
  const dim3 grid(p.m, (unsigned)g[1]);
  if (f32)
    band_rows<float><<<grid, ROW_THREADS, 0, stream>>>(s, static_cast<float*>(pw), lse, p);
  else
    band_rows<bf16><<<grid, ROW_THREADS, 0, stream>>>(s, static_cast<bf16*>(pw), lse, p);
  return (int)cudaGetLastError();
}

// The copy pass of heads z0 .. z0 + n - 1 of x (g: sb, sh, st, h, z0, n,
// cap, t, w, tp; the copies hold cap heads): bf16 transposed into tr; fp32
// split into nat and / or tr (either may be null).
int flash_band_copy(int f32, const void* x, const int64_t* g, void* nat, void* tr,
                    cudaStream_t stream) {
  CopyParams p;
  p.sb = g[0];
  p.sh = g[1];
  p.st = g[2];
  p.h = (int)g[3];
  p.z0 = (int)g[4];
  p.cap = (int)g[6];
  p.t = (int)g[7];
  p.w = (int)g[8];
  p.tp = (int)g[9];
  const dim3 grid((p.tp + 31) / 32, (p.w + 31) / 32, (unsigned)g[5]);
  if (f32)
    band_split<<<grid, 256, 0, stream>>>(static_cast<const float*>(x), static_cast<float*>(nat),
                                         static_cast<float*>(tr), p);
  else
    band_transpose<<<grid, 256, 0, stream>>>(static_cast<const bf16*>(x), static_cast<bf16*>(tr),
                                             p);
  return (int)cudaGetLastError();
}

// The Di pass (g: o_sb, o_sh, o_st, d_sb, d_sh, d_st, h, BH, t, w): Di and
// LSE * log2(e), [BH, T] each.
int flash_band_stats(int f32, const void* o, const void* dout, const int64_t* g,
                     const float* lse, float* lse2, float* di, cudaStream_t stream) {
  StatsParams p;
  p.o_sb = g[0];
  p.o_sh = g[1];
  p.o_st = g[2];
  p.d_sb = g[3];
  p.d_sh = g[4];
  p.d_st = g[5];
  p.h = (int)g[6];
  p.rows = (int)(g[7] * g[8]);
  p.t = (int)g[8];
  p.w = (int)g[9];
  const int grid = (p.rows + 7) / 8;
  if (f32)
    band_stats<float><<<grid, 256, 0, stream>>>(static_cast<const float*>(o),
                                                static_cast<const float*>(dout), lse, lse2, di, p);
  else
    band_stats<bf16><<<grid, 256, 0, stream>>>(static_cast<const bf16*>(o),
                                               static_cast<const bf16*>(dout), lse, lse2, di, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
