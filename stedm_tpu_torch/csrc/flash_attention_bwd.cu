// Flash-attention backward (non-causal) for Hopper, bf16 in and out.
//
// Replaces the two backward Pallas TPU kernels of the stock flash attention
// (JAX 0.9.0's jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dkv at :941, pallas_call :1121, and
// _flash_attention_bwd_dq at :1287, pallas_call :1456), which the JAX
// package reaches through the gradient of stedm_tpu/ops/blocked_attention.py:
// flash_sdpa: the U-Net bottleneck AttentionBlock in training
// ([B, 8, 1024, 128] at 512^2, [B, 4, T, 64] in the tiny card model).
//
// With P = softmax(Q K^T * s) rebuilt from the forward's per-row log-sum-exp
// (csrc/flash_attention.cu writes it) and Di = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Di) * s,  dK = dS^T Q,  dQ = dS K.
// P and dS are rounded to bf16 before their products, as the stock kernel
// rounds them to dO's dtype; every sum is fp32.
//
// What bounds it on the H100: the five matrix products, 10 BH T^2 Dh flops
// (86 GFLOP at [8, 8, 1024, 128]) against about 100 MB of traffic, so the
// tensor cores, which only wgmma drives at their rate. The stock TPU pair
// (and this port's first version) computes S and dP twice, once for dK/dV
// and once for dQ: 14 BH T^2 Dh. Here one kernel computes each product once;
// the price is that every key tile adds a partial dQ for every query tile,
// nk fp32 passes over dQ through the L2.
//
// Design:
//   * flash_bwd_prep, one small pass: Di = rowsum(dO o O) in fp32 and LSE *
//     log2(e), written per 64-row query tile into [BH, nq, 2, 64] (rows past
//     T: Di 0 and LSE +inf, so their P is 0), and the dQ turn counters
//     cleared;
//   * flash_bwd: a block owns one (batch * head, 128-key tile) and is three
//     warpgroups: two consumers, each owning 64 of the keys with their dK and
//     dV in fp32 registers (64 + 64 a thread at Dh 128), and a producer, one
//     thread of which loads K and V once and then streams 64-row tiles of Q
//     and dO (TMA, 4-D tensor maps built from the tensors' strides, so views
//     are read in place) and the tile's LSE and Di (bulk copy) through a ring
//     of stages with full/empty mbarriers; setmaxnreg gives the consumers 240
//     registers a thread;
//   * per query tile and consumer: S^T = K Q^T and dP^T = V dO^T (wgmma, both
//     operands K-major from shared memory, issued together and waited for),
//     P^T = exp2(S^T s log2e - LSE log2e) and dS^T = P^T o (dP^T - Di) s in
//     registers (fp32 S^T and dP^T beside dK and dV: 192 registers), then
//     dV += P^T dO and dK += dS^T Q (P^T, dS^T from registers; dO, Q
//     MN-major) and the consumer's part of dQ = dS K over its 64 keys (dS^T
//     through shared memory, read MN-major by the transposed-A wgmma; K
//     MN-major), 64 columns at a time. Keys past T get P = 0 and are never
//     written; queries past T arrive as zero rows with LSE +inf;
//   * the two consumers take turns at issuing their products (two named
//     barriers), so one's exponentials run under the other's products; they
//     are coupled only where consumer 0's dQ part goes to shared memory and
//     consumer 1 adds its own to it;
//   * a second producer thread adds that sum into an fp32 workspace with
//     bulk copies (the first key tile stores, the others reduce-add at the
//     L2) in key-tile order, so dQ is the same bits on every run: key tile
//     kt adds its part of a (head, query tile, column group) after key tile
//     kt - 1 has (a turn counter, acquire and release at GPU scope), and
//     waits only for blocks launched before it. The consumers go on with the
//     next tile meanwhile. The order costs the chain's latency: key tile kt
//     of a head runs about kt turn hand-overs behind key tile 0 (a walk
//     staggered by key tile was tried, with the turn order following the
//     walk: it measured slower, since blocks do not start together);
//   * flash_bwd_dq_convert turns the sums into bf16 dQ; with one key tile
//     (T <= 128) consumer 1 writes dQ itself and the adder and the
//     conversion have nothing to do.
//
// Head dimensions 64 and 128.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_async.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 3 * WG;     // two consumer warpgroups, then the producer's
// registers a thread after setmaxnreg: (24 + 2 * 240) * 128 = 64512 of the SM's 65536
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int BQ = 64;              // query rows a tile
constexpr int BKEYS = 128;          // keys a block, 64 a consumer warpgroup
constexpr int PREP_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Bwd {
  static constexpr int NSUB = D / SUB;                       // also the dQ column groups
  static constexpr int KV_BYTES = NSUB * BKEYS * ROW_BYTES;  // the K or the V tile
  static constexpr int QT_BYTES = NSUB * BQ * ROW_BYTES;     // a Q or a dO tile
  static constexpr int DS_BYTES = 64 * ROW_BYTES;            // a consumer's dS^T, [64 keys][64 queries]
  static constexpr int DQ_BYTES = BQ * SUB * 4;              // a column group's dQ part, fp32
  static constexpr int STAT_BYTES = 2 * BQ * 4;              // a tile's LSE * log2(e) and Di
  static constexpr int STAGES = 2;
  static constexpr int DS_OFF = 2 * KV_BYTES;                // consumer c, buffer u: + (2 c + u) DS
  static constexpr int DQ_OFF = DS_OFF + 4 * DS_BYTES;
  static constexpr int TILES_OFF = DQ_OFF + NSUB * DQ_BYTES;
  static constexpr int STATS_OFF = TILES_OFF + STAGES * 2 * QT_BYTES;
  static constexpr int BARS_OFF = STATS_OFF + STAGES * STAT_BYTES;
  static constexpr int SMEM = BARS_OFF + 8 * (1 + 2 * STAGES + 3 * NSUB) + 1024;  // + slack
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

struct Params {
  const float* stats;   // [BH, nq, 2, BQ]: LSE * log2(e), then Di, per query tile
  float* dq_acc;        // [BH, nq, D / 64, 16 * 128, 2]: dQ sums, as the consumers hold them
  int* turn;            // [BH, nq, D / 64]: key tiles that have added their dQ part
  bf16* dq;             // [BH, T, D] contiguous, as dk and dv; written here when nk == 1
  bf16* dk;
  bf16* dv;
  int t, h, nq, nk;
  float scale_log2, sm_scale;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Di, LSE * log2(e) and the turn counters for query tile blockIdx.x of head
// blockIdx.y; one warp a row.
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
flash_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ stats, int* __restrict__ turn,
               int64_t o_sb, int64_t o_sh, int64_t o_st, int64_t d_sb, int64_t d_sh, int64_t d_st,
               int t, int h, int nq) {
  constexpr int WARPS = PREP_THREADS / 32;
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stats + ((int64_t)bh * nq + j) * 2 * BQ;
#pragma unroll
  for (int i = 0; i < BQ / WARPS; ++i) {
    const int r = warp + i * WARPS, row = j * BQ + r;
    float di = 0.f;
    if (row < t) {
      const bf16* po = o + b * o_sb + hh * o_sh + row * o_st;
      const bf16* pd = dout + b * d_sb + hh * d_sh + row * d_st;
#pragma unroll
      for (int c = 2 * lane; c < D; c += 64) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(po + c));
        const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pd + c));
        di = fmaf(a.x, g.x, fmaf(a.y, g.y, di));
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) di += __shfl_xor_sync(0xffffffffu, di, m);
    }
    if (lane == 0) {
      st[r] = row < t ? lse[(int64_t)bh * t + row] * LOG2E : INFINITY;
      st[BQ + r] = di;
    }
  }
  if (threadIdx.x < D / SUB) turn[((int64_t)bh * nq + j) * (D / SUB) + threadIdx.x] = 0;
}

// dQ's fp32 sums, kept in the consumers' register order (thread lt's pair
// (jj, r) at float2 (2 jj + r) * 128 + lt of a column group's part), to bf16
// [BH, T, D]; one block a (query tile, head), 128 threads a column group.
template <int D>
__global__ void __launch_bounds__(D / SUB * WG)
flash_bwd_dq_convert(const float2* __restrict__ acc, bf16* __restrict__ dq, int t, int nq) {
  const int j = blockIdx.x, bh = blockIdx.y;
  const int c = threadIdx.x / WG, lt = threadIdx.x % WG;
  const int warp = lt / 32, g = (lt % 32) >> 2, tg = lt & 3;
  const float2* part = acc + (((int64_t)bh * nq + j) * (D / SUB) + c) * (BQ * SUB / 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = j * BQ + warp * 16 + g + 8 * r;
    if (row >= t) continue;
    bf16* out = dq + ((int64_t)bh * t + row) * D + c * SUB + 2 * tg;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 v = part[(2 * jj + r) * WG + lt];
      *reinterpret_cast<uint32_t*>(out + 8 * jj) = pack_bf16x2(v.x, v.y);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
          const Params p) {
  using C = Bwd<D>;
  constexpr int NSUB = C::NSUB, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t k_s = base, v_s = base + C::KV_BYTES;
  const uint32_t dq_s = base + C::DQ_OFF;          // column group c's part at dq_s + c * DQ_BYTES
  const uint32_t bars = base + C::BARS_OFF;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * (STAGES + s); };
  auto dq_half = [&](int c) { return bars + 8 + 16 * STAGES + 8 * c; };        // consumer 0's part
  auto dq_full = [&](int c) { return bars + 8 + 16 * STAGES + 8 * (NSUB + c); };  // the sum
  auto dq_empty = [&](int c) { return bars + 8 + 16 * STAGES + 8 * (2 * NSUB + c); };
  auto q_tile = [&](int s) { return base + C::TILES_OFF + s * 2 * C::QT_BYTES; };  // dO after it

  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.h, h = bh % p.h;
  const int key0 = kt * BKEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * WG);
    }
    for (int c = 0; c < NSUB; ++c) {
      mbar_init(dq_half(c), WG);
      mbar_init(dq_full(c), WG);
      mbar_init(dq_empty(c), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      // ---- loads: K and V once, then Q, dO, LSE and Di a query tile ----
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
      for (int sub = 0; sub < NSUB; ++sub) {
        tma_load(k_s + sub * BKEYS * ROW_BYTES, &map_k, kv_full, sub * SUB, key0, h, b);
        tma_load(v_s + sub * BKEYS * ROW_BYTES, &map_v, kv_full, sub * SUB, key0, h, b);
      }
      for (int j = 0; j < p.nq; ++j) {
        const int s = j % STAGES;
        const uint32_t q_s = q_tile(s), do_s = q_s + C::QT_BYTES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * C::QT_BYTES + C::STAT_BYTES);
        for (int sub = 0; sub < NSUB; ++sub) {
          tma_load(q_s + sub * BQ * ROW_BYTES, &map_q, full(s), sub * SUB, j * BQ, h, b);
          tma_load(do_s + sub * BQ * ROW_BYTES, &map_do, full(s), sub * SUB, j * BQ, h, b);
        }
        bulk_load(base + C::STATS_OFF + s * C::STAT_BYTES,
                  p.stats + ((int64_t)bh * p.nq + j) * 2 * BQ, C::STAT_BYTES, full(s));
      }
    } else if (threadIdx.x == 2 * WG + 32) {
      // ---- dQ: each column group's part into the fp32 sums, in key-tile order ----
      for (int j = 0; j < p.nq; ++j) {
        for (int c = 0; c < NSUB; ++c) {
          int* turn = p.turn + ((int64_t)bh * p.nq + j) * NSUB + c;
          float* acc = p.dq_acc + (((int64_t)bh * p.nq + j) * NSUB + c) * (C::DQ_BYTES / 4);
          mbar_wait(dq_full(c), j & 1);
          if (p.nk == 1) {                         // consumer 1 wrote dQ itself
            mbar_arrive(dq_empty(c));
            continue;
          }
          if (kt > 0) {
            while (ld_acquire(turn) < kt) {
            }
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
          }
          if (kt == 0)   // the first part is stored, the others are added to it
            bulk_store(acc, dq_s + c * C::DQ_BYTES, C::DQ_BYTES);
          else
            bulk_reduce_add_f32(acc, dq_s + c * C::DQ_BYTES, C::DQ_BYTES);
          bulk_commit();
          bulk_wait_read();
          mbar_arrive(dq_empty(c));                // the part's shared memory may be rewritten
          if (kt + 1 < p.nk) {
            bulk_wait();                           // the sums are written: pass the turn on
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
            __threadfence();
            atomicAdd(turn, 1);
          }
        }
      }
      bulk_wait();
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int cw = wg;                             // keys 64 cw .. 64 cw + 63 of the block
    const int lt = threadIdx.x % WG;
    const int warp = lt / 32, lane = lt % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int row_w = warp * 16 + g;               // this lane's keys: row_w, row_w + 8 of 64 cw ..
    const bool key_ok0 = key0 + cw * 64 + row_w < p.t, key_ok1 = key0 + cw * 64 + row_w + 8 < p.t;
    const uint32_t k_w = k_s + cw * 64 * ROW_BYTES, v_w = v_s + cw * 64 * ROW_BYTES;
    float2* dq_part = reinterpret_cast<float2*>(smem + C::DQ_OFF) + lt;

    // The two consumers take turns at issuing their products (named barriers
    // 2 and 3, one a warpgroup: it waits on its own, the other arrives
    // there), so that one's exponentials and dS run under the other's
    // products instead of both waiting for the tensor cores at once.
    auto take_turn = [&]() { asm volatile("bar.sync %0, %1;\n" :: "r"(2 + cw), "n"(2 * WG) : "memory"); };
    auto pass_turn = [&]() { asm volatile("bar.arrive %0, %1;\n" :: "r"(3 - cw), "n"(2 * WG) : "memory"); };
    if (cw == 1) pass_turn();                      // consumer 0 goes first

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < p.nq; ++i) {
      const int s = i % STAGES;
      const uint32_t q_s = q_tile(s), do_s = q_s + C::QT_BYTES;
      const uint32_t ds_w = base + C::DS_OFF + (2 * cw + (i & 1)) * C::DS_BYTES;
      const float* lse2 = reinterpret_cast<const float*>(smem + C::STATS_OFF + s * C::STAT_BYTES);
      const float* di = lse2 + BQ;
      mbar_wait(full(s), (i / STAGES) & 1);

      // ---- S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 queries ----
      float st[32], dp[32];
      take_turn();
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int sub = kk / 4, off = (kk % 4) * 32;
        wgmma::ss<0>(st, wgmma::descriptor(k_w / 16 + (sub * BKEYS * ROW_BYTES + off) / 16, 16),
                     wgmma::descriptor(q_s / 16 + (sub * BQ * ROW_BYTES + off) / 16, 16), kk != 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int sub = kk / 4, off = (kk % 4) * 32;
        wgmma::ss<0>(dp, wgmma::descriptor(v_w / 16 + (sub * BKEYS * ROW_BYTES + off) / 16, 16),
                     wgmma::descriptor(do_s / 16 + (sub * BQ * ROW_BYTES + off) / 16, 16), kk != 0);
      }
      wgmma::commit();
      pass_turn();
      wgmma::wait<0>();

      // ---- P^T (keys past T: 0) and dS^T = P^T o (dP^T - Di) * s, as bf16 A operands ----
      uint32_t pa[4][4], dsa[4][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * jj + 2 * tg);
        const float2 d = *reinterpret_cast<const float2*>(di + 8 * jj + 2 * tg);
        float pv[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = e < 2 ? key_ok0 : key_ok1;
          const float lv = e & 1 ? l.y : l.x, dv_ = e & 1 ? d.y : d.x;
          pv[e] = ok ? exp2f(fmaf(st[4 * jj + e], p.scale_log2, -lv)) : 0.f;
          ds[e] = pv[e] * (dp[4 * jj + e] - dv_) * p.sm_scale;
        }
        // columns 8 jj .. 8 jj + 7 are half of the A fragment of k-step jj / 2
        pa[jj / 2][2 * (jj & 1)] = pack_bf16x2(pv[0], pv[1]);
        pa[jj / 2][2 * (jj & 1) + 1] = pack_bf16x2(pv[2], pv[3]);
        dsa[jj / 2][2 * (jj & 1)] = pack_bf16x2(ds[0], ds[1]);
        dsa[jj / 2][2 * (jj & 1) + 1] = pack_bf16x2(ds[2], ds[3]);
      }
      // dS^T also goes to shared memory ([64 keys][64 queries], bf16, in the
      // 128-byte swizzle: row r's 16-byte chunk c lands at chunk c ^ (r & 7))
      unsigned char* ds_p = smem + (ds_w - base);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_w + 8 * (e & 1), chunk = (2 * kk + (e >> 1)) ^ (row & 7);
          *reinterpret_cast<uint32_t*>(ds_p + row * ROW_BYTES + chunk * 16 + tg * 4) = dsa[kk][e];
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

      // ---- dV += P^T dO, dK += dS^T Q (dO, Q MN-major), and this warpgroup's
      // part of dQ[:, 0 .. 63] = dS K over its 64 keys (dS^T and K MN-major) ----
      float dq[32];
      auto start_dq = [&](int c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma::ss<1, 1>(dq, wgmma::descriptor(ds_w / 16 + kk * ROW_BYTES, C::DS_BYTES),
                          wgmma::descriptor(k_w / 16 + c * (BKEYS * ROW_BYTES / 16) + kk * ROW_BYTES,
                                            BKEYS * ROW_BYTES),
                          kk != 0);
        wgmma::commit();
      };
      // consumer 0's part goes to shared memory, consumer 1 adds its own to
      // it and hands the sum to the adder thread (with one key tile the sum
      // is dQ, and consumer 1 writes it)
      auto combine = [&](int c) {
        float2* part = dq_part + c * (C::DQ_BYTES / 8);
        if (cw == 0) {
          mbar_wait(dq_empty(c), (i & 1) ^ 1);
#pragma unroll
          for (int f = 0; f < 16; ++f) part[f * WG] = make_float2(dq[2 * f], dq[2 * f + 1]);
          mbar_arrive(dq_half(c));
          return;
        }
        mbar_wait(dq_half(c), i & 1);
        if (p.nk == 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = i * BQ + row_w + 8 * r;
            if (row >= p.t) continue;
            bf16* out = p.dq + ((int64_t)bh * p.t + row) * D + c * SUB + 2 * tg;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const float2 a = part[(2 * jj + r) * WG];
              *reinterpret_cast<uint32_t*>(out + 8 * jj) =
                  pack_bf16x2(a.x + dq[4 * jj + 2 * r], a.y + dq[4 * jj + 2 * r + 1]);
            }
          }
        } else {
#pragma unroll
          for (int f = 0; f < 16; ++f) {
            const float2 a = part[f * WG];
            part[f * WG] = make_float2(a.x + dq[2 * f], a.y + dq[2 * f + 1]);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        mbar_arrive(dq_full(c));
      };
      take_turn();                                 // this warpgroup's dS^T is whole (and its turn)
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma::rs(dv, pa[kk], wgmma::descriptor(do_s / 16 + kk * ROW_BYTES, BQ * ROW_BYTES), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma::rs(dk, dsa[kk], wgmma::descriptor(q_s / 16 + kk * ROW_BYTES, BQ * ROW_BYTES), 1);
      wgmma::commit();
      start_dq(0);
      pass_turn();
      wgmma::wait<0>();
      mbar_arrive(empty(s));                       // the stage's Q, dO, LSE and Di are read
      combine(0);
      if (NSUB == 2) {                             // columns 64 .. 127
        wgmma::fence();
        start_dq(1);
        wgmma::wait<0>();
        combine(1);
      }
    }

    // ---- dK and dV of this warpgroup's keys (keys past T are not written) ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + cw * 64 + row_w + 8 * r;
      if (key >= p.t) continue;
      bf16* ok = p.dk + ((int64_t)bh * p.t + key) * D + 2 * tg;
      bf16* ov = p.dv + ((int64_t)bh * p.t + key) * D + 2 * tg;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        *reinterpret_cast<uint32_t*>(ok + 8 * jj) = pack_bf16x2(dk[4 * jj + 2 * r], dk[4 * jj + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(ov + 8 * jj) = pack_bf16x2(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Layout {   // the workspace: stats, turn counters, dQ sums (more than one key tile)
  int nq, nk;
  size_t stats_off, turn_off, acc_off, bytes;
};

Layout layout(int bh, int t, int d) {
  Layout l;
  l.nq = (t + BQ - 1) / BQ;
  l.nk = (t + BKEYS - 1) / BKEYS;
  const size_t tiles = (size_t)bh * l.nq;
  l.stats_off = 0;
  l.turn_off = tiles * 2 * BQ * 4;
  l.acc_off = l.turn_off + (tiles * (d / SUB) * 4 + 255) / 256 * 256;
  l.bytes = l.acc_off + (l.nk > 1 ? tiles * BQ * d * 4 : 0);
  return l;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, void* workspace, int b, int h, int t,
           const int64_t* s, float sm_scale, cudaStream_t stream) {
  using C = Bwd<D>;
  // set before every launch: a launch from another host thread (autograd's
  // worker, which runs this backward) did not see it set once from the first
  cudaError_t err = cudaFuncSetAttribute(flash_bwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const Layout l = layout(b * h, t, D);
  unsigned char* ws = (unsigned char*)workspace;
  float* stats = (float*)(ws + l.stats_off);
  int* turn = (int*)(ws + l.turn_off);
  float* acc = (float*)(ws + l.acc_off);
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!make_map(&map_q, q, b, h, t, D, s, BQ) || !make_map(&map_k, k, b, h, t, D, s + 3, BKEYS) ||
      !make_map(&map_v, v, b, h, t, D, s + 6, BKEYS) ||
      !make_map(&map_do, dout, b, h, t, D, s + 12, BQ))
    return (int)cudaErrorInvalidValue;
  const dim3 tiles(l.nq, b * h);
  flash_bwd_prep<D><<<tiles, PREP_THREADS, 0, stream>>>(
      (const bf16*)o, (const bf16*)dout, lse, stats, turn, s[9], s[10], s[11], s[12], s[13], s[14],
      t, h, l.nq);
  const Params p = {stats, acc, turn, (bf16*)dq, (bf16*)dk, (bf16*)dv, t, h, l.nq, l.nk,
                    sm_scale * LOG2E, sm_scale};
  flash_bwd<D><<<dim3(l.nk, b * h), THREADS, C::SMEM, stream>>>(map_q, map_k, map_v, map_do, p);
  if (l.nk > 1)
    flash_bwd_dq_convert<D><<<tiles, D / SUB * WG, 0, stream>>>((const float2*)acc, (bf16*)dq, t,
                                                                   l.nq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device workspace flash_attention_bwd needs for [B * H = bh, T, D].
size_t flash_attention_bwd_workspace(int bh, int t, int d) { return layout(bh, t, d).bytes; }

// q, k, v, o (the forward's output), dout: bf16 [B, H, T, D] on the device,
// last dimension contiguous; strides: the element strides {batch, head,
// token} of q, k, v, o and dout (15 values), each a multiple of 8 (16 bytes),
// bases 16-byte aligned. lse: the forward's fp32 [B, H, T] (natural log),
// contiguous. dq, dk, dv: contiguous bf16 [B, H, T, D] outputs. workspace:
// flash_attention_bwd_workspace(B * H, T, D) bytes, 256-byte aligned. D 64
// or 128. Launches the prep pass and the fused kernel on `stream`; returns
// the cudaError_t of the launches.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* dq, void* dk, void* dv,
                        void* workspace, int b, int h, int t, int d, const int64_t* strides,
                        float sm_scale, void* stream) {
  if ((d != 64 && d != 128) || t <= 0 || b <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  if (d == 128)
    return launch<128>(q, k, v, o, dout, l, dq, dk, dv, workspace, b, h, t, strides, sm_scale, s);
  return launch<64>(q, k, v, o, dout, l, dq, dk, dv, workspace, b, h, t, strides, sm_scale, s);
}

}  // extern "C"
