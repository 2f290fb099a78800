// Flash-attention backward (non-causal) for Hopper, bf16 in and out.
//
// Replaces the two backward Pallas TPU kernels of the stock flash attention
// (JAX 0.9.0's jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dkv at :941, pallas_call :1121, and
// _flash_attention_bwd_dq at :1287, pallas_call :1456), which the JAX
// package reaches through the gradient of stedm_tpu/ops/blocked_attention.py:
// flash_sdpa (the U-Net bottleneck AttentionBlock in training: [B, 8, 1024,
// 128] at 512^2, [B, 4, T, 64] in the tiny card model) and of
// stedm_tpu/models/vq.py:AttnBlockVQ (the codec's mid-block attention in
// codec fine-tuning: [B, 1, 16384, 512] at 512^2, [B, 1, 4096, 512] at 256^2).
//
// With P = softmax(Q K^T * s) rebuilt from the forward's per-row log-sum-exp
// (csrc/flash_attention.cu writes it) and Di = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Di) * s,  dK = dS^T Q,  dQ = dS K.
// P and dS are rounded to bf16 before their products, as the stock kernel
// rounds them to dO's dtype; every sum is fp32.
//
// What bounds it on the H100: the five matrix products, 10 BH T^2 Dh flops
// (86 GFLOP at [8, 8, 1024, 128], 2.75 TFLOP at [2, 1, 16384, 512]) against
// at most a few hundred MB of traffic, so the tensor cores, which only wgmma
// drives at their rate. The stock TPU pair (and this port's first version)
// computes S and dP twice, once for dK/dV and once for dQ: 14 BH T^2 Dh. Here
// one kernel computes each product once; the price is that every key tile
// adds a partial dQ for every query tile, nk fp32 passes over dQ through the
// L2.
//
// Design:
//   * flash_bwd_prep, one small pass: Di = rowsum(dO o O) in fp32 and LSE *
//     log2(e), written per 64-row query tile into [BH, nq, 2, 64] (rows past
//     T: Di 0 and LSE +inf, so their P is 0), and the dQ turn counters
//     cleared;
//   * flash_bwd: a block owns one (batch * head, 128-key tile) and 128
//     columns of the head dimension (all of it at Dh 64 and 128), and is three
//     warpgroups: two consumers, each owning 64 of the keys with their dK and
//     dV columns in fp32 registers (64 + 64 a thread at 128 columns), and a
//     producer, one thread of which loads K and V once and then streams
//     64-row tiles of Q and dO (TMA, 4-D tensor maps built from the tensors'
//     strides, so views are read in place) and the tile's LSE and Di (bulk
//     copy) through a ring of stages with full/empty mbarriers; setmaxnreg
//     gives the consumers 240 registers a thread;
//   * per query tile and consumer: S^T = K Q^T and dP^T = V dO^T (wgmma, both
//     operands K-major from shared memory, issued together and waited for),
//     P^T = exp2(S^T s log2e - LSE log2e) and dS^T = P^T o (dP^T - Di) s in
//     registers (fp32 S^T and dP^T beside dK and dV: 192 registers), then
//     dV += P^T dO and dK += dS^T Q (P^T, dS^T from registers; dO, Q
//     MN-major) and the consumer's part of dQ = dS K over its 64 keys (dS^T
//     through shared memory, read MN-major by the transposed-A wgmma; K
//     MN-major), 64 columns at a time. Keys past T get P = 0 and are never
//     written; queries past T arrive as zero rows with LSE +inf;
//   * Dh 256 and above (the codec's attention; the landscape U-Net at
//     num_heads 1, Dh 1024): dK and dV of 64 keys over 512 columns would
//     take the whole register file, and K and V of 64 keys half the shared
//     memory, so the head dimension is split across a thread-block cluster
//     of Dh / 128 blocks (2 at Dh 256, 4 at 512, 5 to 8 at the instances
//     640 to 1024), each the Dh-128 block above on its own 128 columns of
//     Q, K, V, dO, dK, dV and dQ. S^T and dP^T are sums over all columns:
//     each block computes its 128-column partials (64 x 64 fp32 a consumer)
//     and writes them to its shared memory; the eight 8-query column pairs
//     of a tile are dealt out to the ranks (rank jj * CL / 8 takes pair jj:
//     two pairs a rank at Dh 512, one at 1024, one or two at 640 to 896),
//     and a rank sums its pairs over the cluster through distributed shared
//     memory, in rank order, makes their bf16 P^T and dS^T and writes them
//     back over its own partials of those pairs, and every block gathers
//     all eight as its A fragments: each element is summed and rounded
//     once, so every block uses the same bits of P and dS (mbarriers at
//     cluster scope: partials written, P and dS written, and read, on every
//     rank; after a named barrier of the consumer, lane r of its first warp
//     arrives on rank r: with every thread arriving on every rank's
//     barrier the backward took 1.6x as long at Dh 512 and 2.2x at 1024).
//     A block reads 72 KB of other blocks' shared memory a tile at Dh 512,
//     84 KB at 1024 (192 KB at 512 when every block summed all partials
//     itself: that first version took 30.1 ms at [2, 1, 16384, 512] on an
//     NVIDIA H100 80GB HBM3 at 700 W, against 22.8 ms). The 64 KB of
//     partials leave room for one stage of Q and dO, not two;
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
// Head dimensions: instances at 64, 128, 256, 512, 640, 768, 896 and 1024
// (flash_bwd), and at 32 (flash_bwd_small below); every other multiple of
// 8 up to 1024 runs on the smallest instance at or above it (Dh 16 on
// <32>, 48 on <64>, 96 on <128>, 160 and 192 on <256>, 320, 384 and 448 on
// <512>, 520 and 576 on <640>, ...): the tensor maps declare the true
// columns, so TMA fills the rest of every Q, K, V and dO box with zeros (a
// whole 128-column slice of a cluster rank at Dh 160, 320 or 520: its
// partials of S^T and dP^T are zeros, and the exchange sums them as any
// other), they add nothing to S^T and dP^T and give dQ, dK and dV zero
// columns, which are not stored. The wrapper copies a head dimension whose
// rows are not 16 bytes apart into zero-padded tensors first
// (ops/blocked_attention.py: head_dim_plan).
//
// Dh 32 (flash_bwd_small<32>: the U-Net's AttentionBlock at
// num_head_channels 32, [B, 32, 1024, 32] training at 512^2; Dh 16 at
// num_head_channels 16): a tile's products are a quarter of Dh 128's, so
// the per-score work (exp2, dS, the packing) is no longer hidden under
// them, and the Dh-64 block above, run on a head dimension padded with
// zeros, spent half its products and its dQ traffic on zero columns. Here:
//   * 32-column boxes in the 64-byte swizzle (descriptor<64>, as the
//     forward's flash_fwd_small<32>): S^T = K Q^T and dP^T = V dO^T are two
//     32-byte k-steps each, dV += P^T dO, dK += dS^T Q and dQ = dS K are
//     m64n32k16 products; nothing is computed on padded columns;
//   * a block owns 256 keys, each consumer 128 of them as two 64-key halves
//     (dK and dV: 16 + 16 fp32 registers a thread a half): half 0's S^T and
//     dP^T; then half 1's S^T and dP^T, and half 0's dV, dK and share of
//     the consumer's dQ (dS^T through shared memory), half 1's P^T and dS^T
//     made while the latter run; then half 1's dV, dK and dQ share: three
//     turns a query tile between the two consumers, so one's exponentials
//     run under the other's products, and independent accumulators
//     interleaved in each turn;
//   * what bounds it is the per-score work, not the products or the dQ
//     order (variants on an NVIDIA H100 80GB HBM3 at 700 W: without the
//     exponentials 27 % faster, the dQ sums unordered no faster), so a
//     score costs one MUFU ex2 (ftz), two fused multiply-adds and a
//     multiply, a pack (P and dS, two to each) and an eighth of a
//     stmatrix; the key mask is applied only in a half that reaches past T;
//   * at T = 1024 that is 4 key tiles, not 8: the ordered dQ chain is half
//     as long, each partial is 64 x 32 fp32 (8 KB, none of it zero fill),
//     and every Q and dO tile serves 256 keys;
//   * the Di pass, the ordered and deterministic dQ sums and the conversion
//     pass are the other instances'.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// dQ is summed over key tiles in column groups of GC columns: 64, or the
// whole head dimension of the Dh-32 instance; the conversion pass takes CT
// of them at once (a block holds at most 1024 threads).
template <int D>
struct Groups {
  static constexpr int GC = D < SUB ? D : SUB;
  static constexpr int NG = D / GC;
  static constexpr int CT = NG < 8 ? NG : 8;
};

template <int D>
struct Bwd {
  static constexpr int CL = D <= 128 ? 1 : D / 128;          // blocks of a cluster
  static constexpr int DL = D / CL;                          // columns a block
  static constexpr int NSUB = DL / SUB;                      // a block's dQ column groups
  static constexpr int KV_BYTES = NSUB * BKEYS * ROW_BYTES;  // the K or the V tile
  static constexpr int QT_BYTES = NSUB * BQ * ROW_BYTES;     // a Q or a dO tile
  static constexpr int DS_BYTES = 64 * ROW_BYTES;            // a consumer's dS^T, [64 keys][64 queries]
  static constexpr int DQ_BYTES = BQ * SUB * 4;              // a column group's dQ part, fp32
  static constexpr int STAT_BYTES = 2 * BQ * 4;              // a tile's LSE * log2(e) and Di
  static constexpr int STAGES = CL > 1 ? 1 : 2;
  // a consumer's partial S^T and dP^T, [16 float4][128 threads], either consumer
  static constexpr int X_BYTES = CL > 1 ? 2 * 16 * WG * 16 : 0;
  static constexpr int DS_OFF = 2 * KV_BYTES;                // consumer c, buffer u: + (2 c + u) DS
  static constexpr int DQ_OFF = DS_OFF + 4 * DS_BYTES;
  static constexpr int TILES_OFF = DQ_OFF + NSUB * DQ_BYTES;
  static constexpr int STATS_OFF = TILES_OFF + STAGES * 2 * QT_BYTES;
  static constexpr int X_OFF = STATS_OFF + STAGES * STAT_BYTES;
  static constexpr int BARS_OFF = X_OFF + X_BYTES;
  static constexpr int SMEM = BARS_OFF + 8 * (1 + 2 * STAGES + 3 * NSUB + 6) + 1024;  // + slack
  static_assert(SMEM <= 232448, "shared memory");
};

struct Params {
  const float* stats;   // [BH, nq, 2, BQ]: LSE * log2(e), then Di, per query tile
  float* dq_acc;        // [BH, nq, groups, GC / 4 * 128, 2]: dQ sums, as the consumers hold them
  int* turn;            // [BH, nq, groups]: key tiles that have added their dQ part
  bf16* dq;             // [BH, T, D] contiguous, as dk and dv; written here when nk == 1
  bf16* dk;
  bf16* dv;
  int dcols;            // the head dimension of dq, dk, dv: the instance's, or fewer
  int t, h, nq, nk;
  float scale_log2, sm_scale;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// 2^x on the MUFU alone: results below 2^-126 flush to zero.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four 8 x 8 bf16 matrices from their mma fragments (register i: matrix i)
// into shared memory: lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

// Di, LSE * log2(e) and the turn counters for query tile blockIdx.x of head
// blockIdx.y; LANES threads a row, 16 bytes (8 columns) a thread a step.
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
flash_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ stats, int* __restrict__ turn,
               int64_t o_sb, int64_t o_sh, int64_t o_st, int64_t d_sb, int64_t d_sh, int64_t d_st,
               int t, int h, int nq, int dcols) {
  constexpr int LANES = D / 8 < 32 ? D / 8 : 32;
  constexpr int ROWS = PREP_THREADS / LANES;       // rows a pass
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int lane = threadIdx.x % LANES;
  float* st = stats + ((int64_t)bh * nq + j) * 2 * BQ;
#pragma unroll
  for (int r = threadIdx.x / LANES; r < BQ; r += ROWS) {
    const int row = j * BQ + r;
    float di = 0.f;
    if (row < t) {
      const bf16* po = o + b * o_sb + hh * o_sh + row * o_st;
      const bf16* pd = dout + b * d_sb + hh * d_sh + row * d_st;
#pragma unroll
      for (int c = 8 * lane; c < D; c += 8 * LANES) {
        if (c >= dcols) break;
        const uint4 a = *reinterpret_cast<const uint4*>(po + c);
        const uint4 g = *reinterpret_cast<const uint4*>(pd + c);
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, gw[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 af = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
          const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[w]));
          di = fmaf(af.x, gf.x, fmaf(af.y, gf.y, di));
        }
      }
    }
#pragma unroll
    for (int m = LANES / 2; m > 0; m >>= 1) di += __shfl_xor_sync(0xffffffffu, di, m);
    if (lane == 0) {
      st[r] = row < t ? lse[(int64_t)bh * t + row] * LOG2E : INFINITY;
      st[BQ + r] = di;
    }
  }
  constexpr int NG = Groups<D>::NG;
  if (threadIdx.x < NG) turn[((int64_t)bh * nq + j) * NG + threadIdx.x] = 0;
}

// dQ's fp32 sums, kept in the consumers' register order (thread lt's pair
// (jj, r) at float2 (2 jj + r) * 128 + lt of a column group's part), to bf16
// [BH, T, dcols]; one block a (query tile, head), 128 threads a column group
// (CT groups at once).
template <int D>
__global__ void __launch_bounds__(Groups<D>::CT * WG)
flash_bwd_dq_convert(const float2* __restrict__ acc, bf16* __restrict__ dq, int t, int nq,
                     int dcols) {
  constexpr int GC = Groups<D>::GC, NG = Groups<D>::NG, CT = Groups<D>::CT;
  const int j = blockIdx.x, bh = blockIdx.y;
  const int lt = threadIdx.x % WG;
  const int warp = lt / 32, g = (lt % 32) >> 2, tg = lt & 3;
  for (int c = threadIdx.x / WG; c < NG; c += CT) {
    const float2* part = acc + (((int64_t)bh * nq + j) * NG + c) * (BQ * GC / 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = j * BQ + warp * 16 + g + 8 * r;
      if (row >= t) continue;
      bf16* out = dq + ((int64_t)bh * t + row) * dcols + c * GC + 2 * tg;
#pragma unroll
      for (int jj = 0; jj < GC / 8; ++jj) {
        if (c * GC + 8 * jj >= dcols) break;
        const float2 v = part[(2 * jj + r) * WG + lt];
        *reinterpret_cast<uint32_t*>(out + 8 * jj) = pack_bf16x2(v.x, v.y);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
          const Params p) {
  using C = Bwd<D>;
  constexpr int NSUB = C::NSUB, STAGES = C::STAGES, CL = C::CL, NG = D / SUB;
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
  // consumer c's partials written by every rank / read by every rank (CL > 1)
  auto x_full = [&](int c) { return bars + 8 + 16 * STAGES + 24 * NSUB + 8 * c; };
  auto x_empty = [&](int c) { return bars + 8 + 16 * STAGES + 24 * NSUB + 8 * (2 + c); };
  auto y_full = [&](int c) { return bars + 8 + 16 * STAGES + 24 * NSUB + 8 * (4 + c); };  // P, dS
  auto q_tile = [&](int s) { return base + C::TILES_OFF + s * 2 * C::QT_BYTES; };  // dO after it

  // cluster rank `rank` (blockIdx.x % CL) owns columns col0 .. col0 + DL - 1
  const int kt = blockIdx.x / CL, rank = blockIdx.x % CL, bh = blockIdx.y;
  const int col0 = rank * C::DL;
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
    for (int c = 0; c < 2; ++c) {
      mbar_init(x_full(c), CL);
      mbar_init(x_empty(c), CL);
      mbar_init(y_full(c), CL);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (CL > 1)
    cluster_sync_all();   // every rank's barriers are initialised before any remote arrival
  else
    __syncthreads();

  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      // ---- loads: K and V once, then Q, dO, LSE and Di a query tile ----
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
      for (int sub = 0; sub < NSUB; ++sub) {
        tma_load(k_s + sub * BKEYS * ROW_BYTES, &map_k, kv_full, col0 + sub * SUB, key0, h, b);
        tma_load(v_s + sub * BKEYS * ROW_BYTES, &map_v, kv_full, col0 + sub * SUB, key0, h, b);
      }
      for (int j = 0; j < p.nq; ++j) {
        const int s = j % STAGES;
        const uint32_t q_s = q_tile(s), do_s = q_s + C::QT_BYTES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * C::QT_BYTES + C::STAT_BYTES);
        for (int sub = 0; sub < NSUB; ++sub) {
          tma_load(q_s + sub * BQ * ROW_BYTES, &map_q, full(s), col0 + sub * SUB, j * BQ, h, b);
          tma_load(do_s + sub * BQ * ROW_BYTES, &map_do, full(s), col0 + sub * SUB, j * BQ, h, b);
        }
        bulk_load(base + C::STATS_OFF + s * C::STAT_BYTES,
                  p.stats + ((int64_t)bh * p.nq + j) * 2 * BQ, C::STAT_BYTES, full(s));
      }
    } else if (threadIdx.x == 2 * WG + 32) {
      // ---- dQ: each column group's part into the fp32 sums, in key-tile order ----
      for (int j = 0; j < p.nq; ++j) {
        for (int c = 0; c < NSUB; ++c) {
          const int cg = rank * NSUB + c;          // the column group of the head
          int* turn = p.turn + ((int64_t)bh * p.nq + j) * NG + cg;
          float* acc = p.dq_acc + (((int64_t)bh * p.nq + j) * NG + cg) * (C::DQ_BYTES / 4);
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
    // the wgmma descriptors' addresses: a descriptor holds 14 bits of the
    // address / 16, the offset in the block's 256 KB shared window, and in a
    // cluster launch the window's address carries the block's rank from bit
    // 24 (TMA, mbarriers and mapa take the full address)
    const uint32_t dbase = base & 0x3FFFFu;
    const uint32_t k_w = dbase + cw * 64 * ROW_BYTES, v_w = dbase + C::KV_BYTES + cw * 64 * ROW_BYTES;
    float2* dq_part = reinterpret_cast<float2*>(smem + C::DQ_OFF) + lt;

    // The two consumers take turns at issuing their products (named barriers
    // 2 and 3, one a warpgroup: it waits on its own, the other arrives
    // there), so that one's exponentials and dS run under the other's
    // products instead of both waiting for the tensor cores at once.
    auto take_turn = [&]() { asm volatile("bar.sync %0, %1;\n" :: "r"(2 + cw), "n"(2 * WG) : "memory"); };
    auto pass_turn = [&]() { asm volatile("bar.arrive %0, %1;\n" :: "r"(3 - cw), "n"(2 * WG) : "memory"); };
    if (cw == 1) pass_turn();                      // consumer 0 goes first

    float dk[C::DL / 2], dv[C::DL / 2];
#pragma unroll
    for (int i = 0; i < C::DL / 2; ++i) dk[i] = dv[i] = 0.f;

    // With a cluster, P^T and dS^T as A operands from this rank's partial
    // S^T and dP^T: every thread writes its partials to its slots of the
    // block's exchange buffer ([16 float4][128 threads] a consumer: S^T's 8
    // column pairs jj, then dP^T's; thread lt of consumer c holds the same
    // elements on every rank). Rank jj * CL / 8 then sums the partials of
    // column pair jj over the cluster, in rank order, makes its P^T and dS^T
    // (bf16, the pair's halves of the A fragments: 16 bytes) and writes
    // them over its own S^T slot of that jj (which no other rank reads),
    // and every rank gathers all eight pairs: each element is summed and
    // rounded once, by one rank, and the cluster reads 3 / (2 CL) of what
    // an all-to-all of the partials would (3/8 at Dh 512, 3/16 at 1024).
    // P^T (keys past T: 0) and dS^T = P^T o (dP^T - Di) * s of this thread's
    // four elements of column pair jj (S^T and dP^T summed), as bf16 pairs:
    // P^T's two rows, then dS^T's
    auto p_ds = [&](int jj, const float* lse2, const float* di, const float (&sv)[4],
                    const float (&dpv)[4], uint32_t (&w)[4]) {
      const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * jj + 2 * tg);
      const float2 d = *reinterpret_cast<const float2*>(di + 8 * jj + 2 * tg);
      float pv[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = e < 2 ? key_ok0 : key_ok1;
        const float lv = e & 1 ? l.y : l.x, dv_ = e & 1 ? d.y : d.x;
        pv[e] = ok ? exp2f(fmaf(sv[e], p.scale_log2, -lv)) : 0.f;
        ds[e] = pv[e] * (dpv[e] - dv_) * p.sm_scale;
      }
      w[0] = pack_bf16x2(pv[0], pv[1]);
      w[1] = pack_bf16x2(pv[2], pv[3]);
      w[2] = pack_bf16x2(ds[0], ds[1]);
      w[3] = pack_bf16x2(ds[2], ds[3]);
    };

    // the column pairs of rank r: jj = first(r) .. first(r + 1) - 1, where
    // the owner of pair jj is jj * CL / 8
    auto first = [](int r) { return (8 * r + CL - 1) / CL; };
    const uint32_t x_mine = base + C::X_OFF + (cw * 16 * WG + lt) * 16;
    auto exchange = [&](int i, const float (&st)[32], const float (&dp)[32], const float* lse2,
                        const float* di, uint32_t (&pa)[4][4], uint32_t (&dsa)[4][4]) {
      unsigned char* mine = smem + (x_mine - base);
      auto slot = [&](int f) { return x_mine + f * WG * 16; };
      if (i > 0) mbar_wait_cluster(x_empty(cw), (i - 1) & 1);   // tile i - 1's were read
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        *reinterpret_cast<float4*>(mine + f * WG * 16) =
            make_float4(st[4 * f], st[4 * f + 1], st[4 * f + 2], st[4 * f + 3]);
        *reinterpret_cast<float4*>(mine + (8 + f) * WG * 16) =
            make_float4(dp[4 * f], dp[4 * f + 1], dp[4 * f + 2], dp[4 * f + 3]);
      }
#pragma unroll
      group_sync(4 + cw, WG);
      if (warp == 0) signal_ranks<CL>(x_full(cw), lane);
      mbar_wait_cluster(x_full(cw), i & 1);
      auto sum = [&](int f) {
        float4 a = ld_cluster_f4(map_rank(slot(f), 0));
#pragma unroll
        for (int r = 1; r < CL; ++r) {
          const float4 o = ld_cluster_f4(map_rank(slot(f), r));
          a.x += o.x;
          a.y += o.y;
          a.z += o.z;
          a.w += o.w;
        }
        return a;
      };
      // this rank's pairs: P^T's two rows, then dS^T's, in slot jj
#pragma unroll 1
      for (int jj = first(rank); jj < first(rank + 1); ++jj) {
        const float4 s4 = sum(jj), d4 = sum(8 + jj);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, dpv[4] = {d4.x, d4.y, d4.z, d4.w};
        uint32_t w[4];
        p_ds(jj, lse2, di, sv, dpv, w);
        *reinterpret_cast<uint4*>(mine + jj * WG * 16) = make_uint4(w[0], w[1], w[2], w[3]);
      }
#pragma unroll
      group_sync(4 + cw, WG);
      if (warp == 0) signal_ranks<CL>(y_full(cw), lane);
      mbar_wait_cluster(y_full(cw), i & 1);
      // columns 8 jj .. 8 jj + 7 are half of the A fragment of k-step jj / 2
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const uint4 a = ld_cluster_u4(map_rank(slot(jj), jj * CL / 8));
        pa[jj / 2][2 * (jj & 1)] = a.x;
        pa[jj / 2][2 * (jj & 1) + 1] = a.y;
        dsa[jj / 2][2 * (jj & 1)] = a.z;
        dsa[jj / 2][2 * (jj & 1) + 1] = a.w;
      }
#pragma unroll
      group_sync(4 + cw, WG);
      if (warp == 0) signal_ranks<CL>(x_empty(cw), lane);
    };

    mbar_wait(kv_full, 0);
    for (int i = 0; i < p.nq; ++i) {
      const int s = i % STAGES;
      const uint32_t q_s = q_tile(s) - base + dbase, do_s = q_s + C::QT_BYTES;
      const uint32_t ds_w = dbase + C::DS_OFF + (2 * cw + (i & 1)) * C::DS_BYTES;
      const float* lse2 = reinterpret_cast<const float*>(smem + C::STATS_OFF + s * C::STAT_BYTES);
      const float* di = lse2 + BQ;
      mbar_wait(full(s), (i / STAGES) & 1);

      // ---- S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 queries ----
      float st[32], dp[32];
      take_turn();
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < C::DL / 16; ++kk) {
        const int sub = kk / 4, off = (kk % 4) * 32;
        wgmma::ss<0>(st, wgmma::descriptor(k_w / 16 + (sub * BKEYS * ROW_BYTES + off) / 16, 16),
                     wgmma::descriptor(q_s / 16 + (sub * BQ * ROW_BYTES + off) / 16, 16), kk != 0);
      }
#pragma unroll
      for (int kk = 0; kk < C::DL / 16; ++kk) {
        const int sub = kk / 4, off = (kk % 4) * 32;
        wgmma::ss<0>(dp, wgmma::descriptor(v_w / 16 + (sub * BKEYS * ROW_BYTES + off) / 16, 16),
                     wgmma::descriptor(do_s / 16 + (sub * BQ * ROW_BYTES + off) / 16, 16), kk != 0);
      }
      wgmma::commit();
      pass_turn();
      wgmma::wait<0>();

      // ---- P^T (keys past T: 0) and dS^T = P^T o (dP^T - Di) * s, as bf16 A operands ----
      uint32_t pa[4][4], dsa[4][4];
      if constexpr (CL > 1) {
        exchange(i, st, dp, lse2, di, pa, dsa);
      } else {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float sv[4] = {st[4 * jj], st[4 * jj + 1], st[4 * jj + 2], st[4 * jj + 3]};
          const float dpv[4] = {dp[4 * jj], dp[4 * jj + 1], dp[4 * jj + 2], dp[4 * jj + 3]};
          uint32_t w[4];
          p_ds(jj, lse2, di, sv, dpv, w);
          // columns 8 jj .. 8 jj + 7 are half of the A fragment of k-step jj / 2
          pa[jj / 2][2 * (jj & 1)] = w[0];
          pa[jj / 2][2 * (jj & 1) + 1] = w[1];
          dsa[jj / 2][2 * (jj & 1)] = w[2];
          dsa[jj / 2][2 * (jj & 1) + 1] = w[3];
        }
      }
      // dS^T also goes to shared memory ([64 keys][64 queries], bf16, in the
      // 128-byte swizzle: row r's 16-byte chunk c lands at chunk c ^ (r & 7))
      unsigned char* ds_p = smem + (ds_w - dbase);
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
            bf16* out = p.dq + ((int64_t)bh * p.t + row) * p.dcols + (rank * NSUB + c) * SUB +
                        2 * tg;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              if ((rank * NSUB + c) * SUB + 8 * jj >= p.dcols) break;
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
      bf16* ok = p.dk + ((int64_t)bh * p.t + key) * p.dcols + col0 + 2 * tg;
      bf16* ov = p.dv + ((int64_t)bh * p.t + key) * p.dcols + col0 + 2 * tg;
#pragma unroll
      for (int jj = 0; jj < C::DL / 8; ++jj) {
        if (col0 + 8 * jj >= p.dcols) break;
        *reinterpret_cast<uint32_t*>(ok + 8 * jj) = pack_bf16x2(dk[4 * jj + 2 * r], dk[4 * jj + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(ov + 8 * jj) = pack_bf16x2(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
      }
    }
  }
  // no block leaves while another rank may still read its partials or
  // arrive on its barriers
  if (CL > 1) cluster_sync_all();
}

// ---------------------------------------------------------------------------
// Dh <= 32: 256 keys a block, 128 a consumer as two 64-key halves, 32-column
// tiles in the 64-byte swizzle (the design notes at the top of the file).
// ---------------------------------------------------------------------------

template <int D>
struct Small {
  static_assert(D == 32, "the 64-byte swizzle holds 32 bf16 columns a row");
  static constexpr int RB = 2 * D;                     // bytes a row
  static constexpr int BKEYS = 256;                    // keys a block, 128 a consumer
  static constexpr int KV_BYTES = BKEYS * RB;          // the K or the V tile
  static constexpr int QT_BYTES = BQ * RB;             // a Q or a dO tile
  static constexpr int DS_BYTES = 128 * ROW_BYTES;     // a consumer's dS^T, [128 keys][64 queries]
  static constexpr int DQ_BYTES = BQ * D * 4;          // the block's dQ part, fp32
  static constexpr int STAT_BYTES = 2 * BQ * 4;
  static constexpr int STAGES = 4;
  static constexpr int DS_OFF = 2 * KV_BYTES;          // consumer c: + c DS_BYTES
  static constexpr int DQ_OFF = DS_OFF + 2 * DS_BYTES;
  static constexpr int TILES_OFF = DQ_OFF + DQ_BYTES;
  static constexpr int STATS_OFF = TILES_OFF + STAGES * 2 * QT_BYTES;
  static constexpr int BARS_OFF = STATS_OFF + STAGES * STAT_BYTES;
  static constexpr int SMEM = BARS_OFF + 8 * (1 + 2 * STAGES + 3) + 1024;  // + slack
  static_assert(SMEM <= 232448, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_small(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                const Params p) {
  using C = Small<D>;
  constexpr int STAGES = C::STAGES, RB = C::RB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t k_s = base, v_s = base + C::KV_BYTES, dq_s = base + C::DQ_OFF;
  const uint32_t bars = base + C::BARS_OFF;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * (STAGES + s); };
  const uint32_t dq_half = bars + 8 + 16 * STAGES;   // consumer 0's part is written
  const uint32_t dq_full = dq_half + 8;              // the sum is written
  const uint32_t dq_empty = dq_half + 16;            // the adder has read it
  auto q_tile = [&](int s) { return base + C::TILES_OFF + s * 2 * C::QT_BYTES; };  // dO after it

  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.h, h = bh % p.h;
  const int key0 = kt * C::BKEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * WG);
    }
    mbar_init(dq_half, WG);
    mbar_init(dq_full, WG);
    mbar_init(dq_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      // ---- loads: K and V once, then Q, dO, LSE and Di a query tile ----
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
      tma_load(k_s, &map_k, kv_full, 0, key0, h, b);
      tma_load(v_s, &map_v, kv_full, 0, key0, h, b);
      for (int j = 0; j < p.nq; ++j) {
        const int s = j % STAGES;
        const uint32_t q_s = q_tile(s), do_s = q_s + C::QT_BYTES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * C::QT_BYTES + C::STAT_BYTES);
        tma_load(q_s, &map_q, full(s), 0, j * BQ, h, b);
        tma_load(do_s, &map_do, full(s), 0, j * BQ, h, b);
        bulk_load(base + C::STATS_OFF + s * C::STAT_BYTES,
                  p.stats + ((int64_t)bh * p.nq + j) * 2 * BQ, C::STAT_BYTES, full(s));
      }
    } else if (threadIdx.x == 2 * WG + 32) {
      // ---- dQ: the block's part into the fp32 sums, in key-tile order ----
      for (int j = 0; j < p.nq; ++j) {
        int* turn = p.turn + (int64_t)bh * p.nq + j;
        float* acc = p.dq_acc + ((int64_t)bh * p.nq + j) * (C::DQ_BYTES / 4);
        mbar_wait(dq_full, j & 1);
        if (p.nk == 1) {                           // consumer 1 wrote dQ itself
          mbar_arrive(dq_empty);
          continue;
        }
        if (kt > 0) {
          while (ld_acquire(turn) < kt) {
          }
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
        }
        if (kt == 0)   // the first part is stored, the others are added to it
          bulk_store(acc, dq_s, C::DQ_BYTES);
        else
          bulk_reduce_add_f32(acc, dq_s, C::DQ_BYTES);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(dq_empty);                     // the part's shared memory may be rewritten
        if (kt + 1 < p.nk) {
          bulk_wait();                             // the sums are written: pass the turn on
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          __threadfence();
          atomicAdd(turn, 1);
        }
      }
      bulk_wait();
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int cw = wg;                             // keys 128 cw .. 128 cw + 127 of the block
    const int lt = threadIdx.x % WG;
    const int warp = lt / 32, lane = lt % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int row_w = warp * 16 + g;               // this lane's keys of a half: row_w, row_w + 8
    const int key_c = key0 + cw * 128 + row_w;
    // keys past T get P = 0 (half 0: key_c, key_c + 8; half 1: + 64)
    const bool ok00 = key_c < p.t, ok01 = key_c + 8 < p.t;
    const bool ok10 = key_c + 64 < p.t, ok11 = key_c + 72 < p.t;
    const uint32_t dbase = base & 0x3FFFFu;        // the wgmma descriptors' addresses
    const uint32_t k_w = dbase + cw * 128 * RB, v_w = dbase + C::KV_BYTES + cw * 128 * RB;
    const uint32_t ds_w = dbase + C::DS_OFF + cw * C::DS_BYTES;
    const uint32_t ds_sa = base + C::DS_OFF + cw * C::DS_BYTES;   // its shared address
    float2* dq_part = reinterpret_cast<float2*>(smem + C::DQ_OFF) + lt;

    auto take_turn = [&]() { asm volatile("bar.sync %0, %1;\n" :: "r"(2 + cw), "n"(2 * WG) : "memory"); };
    auto pass_turn = [&]() { asm volatile("bar.arrive %0, %1;\n" :: "r"(3 - cw), "n"(2 * WG) : "memory"); };
    if (cw == 1) pass_turn();                      // consumer 0 goes first

    float dk0[16], dk1[16], dv0[16], dv1[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) dk0[e] = dk1[e] = dv0[e] = dv1[e] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < p.nq; ++i) {
      const int s = i % STAGES;
      const uint32_t q_s = q_tile(s) - base + dbase, do_s = q_s + C::QT_BYTES;
      const float* lse2 = reinterpret_cast<const float*>(smem + C::STATS_OFF + s * C::STAT_BYTES);
      const float* di = lse2 + BQ;
      mbar_wait(full(s), (i / STAGES) & 1);

      float st[32], dp[32];
      uint32_t pa0[4][4], dsa0[4][4], pa1[4][4], dsa1[4][4];
      // S^T = K Q^T and dP^T = V dO^T of the half's 64 keys x 64 queries,
      // two 32-byte k-steps each (K-major, the 64-byte swizzle), the two
      // chains interleaved: a chain of wgmma on one accumulator runs at the
      // instruction's latency, independent chains at the tensor cores' rate
      auto start_s = [&](int half) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          wgmma::ss<0>(st, wgmma::descriptor<64>((k_w + half * 64 * RB + 32 * kk) / 16, 16),
                       wgmma::descriptor<64>((q_s + 32 * kk) / 16, 16), kk != 0);
          wgmma::ss<0>(dp, wgmma::descriptor<64>((v_w + half * 64 * RB + 32 * kk) / 16, 16),
                       wgmma::descriptor<64>((do_s + 32 * kk) / 16, 16), kk != 0);
        }
      };
      // the half's dV += P^T dO and dK += dS^T Q (P^T, dS^T from registers;
      // dO, Q MN-major, 16 queries a k-step) and its share of this
      // consumer's dQ = dS K (dS^T of the half's 64 keys MN-major through
      // the transposed A, K MN-major), three chains interleaved
      auto start_grads = [&](int half, const uint32_t (&pa)[4][4], const uint32_t (&dsa)[4][4],
                             float (&dvh)[16], float (&dkh)[16], float (&dqh)[16]) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma::rs(dvh, pa[kk], wgmma::descriptor<64>(do_s / 16 + kk * RB, BQ * RB), 1);
          wgmma::rs(dkh, dsa[kk], wgmma::descriptor<64>(q_s / 16 + kk * RB, BQ * RB), 1);
          wgmma::ss<1, 1>(dqh, wgmma::descriptor(ds_w / 16 + (4 * half + kk) * ROW_BYTES,
                                                 C::DS_BYTES),
                          wgmma::descriptor<64>(k_w / 16 + (4 * half + kk) * RB, C::KV_BYTES),
                          kk != 0);
        }
      };
      // P^T and dS^T of the half as bf16 A fragments, and dS^T into rows
      // 64 half .. of the consumer's [128 keys][64 queries] buffer (the
      // 128-byte swizzle: row r's 16-byte chunk c lands at chunk c ^ (r & 7)).
      // The per-score work bounds this kernel, so it is cut to the bone:
      // exp2 on the MUFU alone (P below 2^-126 flushes to 0), dS = P (dP s
      // - Di s) as one fused multiply-add and a multiply, the key mask only
      // in a half that reaches past T (RAGGED), and each k-step's four dS^T
      // fragments stored by one stmatrix.
      auto scores = [&](auto ragged, int half, bool ok0, bool ok1, uint32_t (&pa)[4][4],
                        uint32_t (&dsa)[4][4]) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * jj + 2 * tg);
          const float2 d = *reinterpret_cast<const float2*>(di + 8 * jj + 2 * tg);
          const float ds0 = d.x * p.sm_scale, ds1 = d.y * p.sm_scale;
          float pv[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pv[e] = exp2_ftz(fmaf(st[4 * jj + e], p.scale_log2, -(e & 1 ? l.y : l.x)));
            if constexpr (decltype(ragged)::value) pv[e] = (e < 2 ? ok0 : ok1) ? pv[e] : 0.f;
            ds[e] = pv[e] * fmaf(dp[4 * jj + e], p.sm_scale, -(e & 1 ? ds1 : ds0));
          }
          // columns 8 jj .. 8 jj + 7 are half of the A fragment of k-step jj / 2
          pa[jj / 2][2 * (jj & 1)] = pack_bf16x2(pv[0], pv[1]);
          pa[jj / 2][2 * (jj & 1) + 1] = pack_bf16x2(pv[2], pv[3]);
          dsa[jj / 2][2 * (jj & 1)] = pack_bf16x2(ds[0], ds[1]);
          dsa[jj / 2][2 * (jj & 1) + 1] = pack_bf16x2(ds[2], ds[3]);
        }
        // lane l gives the row of 8 x 8 matrix l / 8 (fragment e of dsa[kk]:
        // rows 8 (e & 1) .., columns 16 kk + 8 (e >> 1) ..) that it stores
        const int m = lane >> 3, row = half * 64 + warp * 16 + 8 * (m & 1) + (lane & 7);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          stmatrix_x4(ds_sa + row * ROW_BYTES + (((2 * kk + (m >> 1)) ^ (row & 7)) << 4), dsa[kk]);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      };
      auto half_scores = [&](int half, bool ok0, bool ok1, uint32_t (&pa)[4][4],
                             uint32_t (&dsa)[4][4]) {
        if (key_c - row_w + 64 * half + 64 <= p.t)     // every key of the half is below T
          scores(std::false_type{}, half, ok0, ok1, pa, dsa);
        else
          scores(std::true_type{}, half, ok0, ok1, pa, dsa);
      };

      // ---- half 0's S^T and dP^T ----
      take_turn();
      wgmma::fence();
      start_s(0);
      wgmma::commit();
      pass_turn();
      wgmma::wait<0>();
      half_scores(0, ok00, ok01, pa0, dsa0);
      // ---- half 1's S^T and dP^T, then half 0's dV, dK and dQ share; half
      // 1's P^T and dS^T are made while the latter run ----
      float dqa[16], dqb[16];
      take_turn();                                 // (and half 0's dS^T is whole)
      wgmma::fence();
      start_s(1);
      wgmma::commit();
      start_grads(0, pa0, dsa0, dv0, dk0, dqa);
      wgmma::commit();
      pass_turn();
      wgmma::wait<1>();
      half_scores(1, ok10, ok11, pa1, dsa1);
      // ---- half 1's dV, dK and dQ share ----
      take_turn();                                 // (and half 1's dS^T is whole)
      wgmma::fence();
      start_grads(1, pa1, dsa1, dv1, dk1, dqb);
      wgmma::commit();
      pass_turn();
      wgmma::wait<0>();
      float dq[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) dq[e] = dqa[e] + dqb[e];
      mbar_arrive(empty(s));                       // the stage's Q, dO, LSE and Di are read

      // consumer 0's part goes to shared memory, consumer 1 adds its own to
      // it and hands the sum to the adder thread (with one key tile the sum
      // is dQ, and consumer 1 writes it)
      if (cw == 0) {
        mbar_wait(dq_empty, (i & 1) ^ 1);
#pragma unroll
        for (int f = 0; f < 8; ++f) dq_part[f * WG] = make_float2(dq[2 * f], dq[2 * f + 1]);
        mbar_arrive(dq_half);
      } else {
        mbar_wait(dq_half, i & 1);
        if (p.nk == 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = i * BQ + row_w + 8 * r;
            if (row >= p.t) continue;
            bf16* out = p.dq + ((int64_t)bh * p.t + row) * p.dcols + 2 * tg;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              if (8 * jj >= p.dcols) break;
              const float2 a = dq_part[(2 * jj + r) * WG];
              *reinterpret_cast<uint32_t*>(out + 8 * jj) =
                  pack_bf16x2(a.x + dq[4 * jj + 2 * r], a.y + dq[4 * jj + 2 * r + 1]);
            }
          }
        } else {
#pragma unroll
          for (int f = 0; f < 8; ++f) {
            const float2 a = dq_part[f * WG];
            dq_part[f * WG] = make_float2(a.x + dq[2 * f], a.y + dq[2 * f + 1]);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        mbar_arrive(dq_full);
      }
    }

    // ---- dK and dV of this consumer's keys (keys past T are not written) ----
    auto store = [&](int half, const float (&dkh)[16], const float (&dvh)[16]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key_c + 64 * half + 8 * r;
        if (key >= p.t) continue;
        bf16* ok = p.dk + ((int64_t)bh * p.t + key) * p.dcols + 2 * tg;
        bf16* ov = p.dv + ((int64_t)bh * p.t + key) * p.dcols + 2 * tg;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (8 * jj >= p.dcols) break;
          *reinterpret_cast<uint32_t*>(ok + 8 * jj) = pack_bf16x2(dkh[4 * jj + 2 * r], dkh[4 * jj + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(ov + 8 * jj) = pack_bf16x2(dvh[4 * jj + 2 * r], dvh[4 * jj + 2 * r + 1]);
        }
      }
    };
    store(0, dk0, dv0);
    store(1, dk1, dv1);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The instance that runs head dimension d (a multiple of 8 up to 1024), and
// the keys a block of it owns.
inline int instance_of(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : d <= 512 ? 512
                                                                         : (d + 127) / 128 * 128;
}
inline int block_keys(int d) { return instance_of(d) == 32 ? Small<32>::BKEYS : BKEYS; }

struct Layout {   // the workspace: stats, turn counters, dQ sums (more than one key tile)
  int nq, nk;
  size_t stats_off, turn_off, acc_off, bytes;
};

Layout layout(int bh, int t, int d) {
  Layout l;
  const int run = instance_of(d), groups = run < SUB ? 1 : run / SUB;
  l.nq = (t + BQ - 1) / BQ;
  l.nk = (t + block_keys(d) - 1) / block_keys(d);
  const size_t tiles = (size_t)bh * l.nq;
  l.stats_off = 0;
  l.turn_off = tiles * 2 * BQ * 4;
  l.acc_off = l.turn_off + (tiles * groups * 4 + 255) / 256 * 256;
  l.bytes = l.acc_off + (l.nk > 1 ? tiles * BQ * run * 4 : 0);
  return l;
}

// The launches of instance D at head dimension dcols: the prep pass, the
// fused kernel (flash_bwd, or flash_bwd_small at D 32) and, with more than
// one key tile, the dQ conversion.
template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, void* workspace, int b, int h, int t,
           int dcols, const int64_t* s, float sm_scale, cudaStream_t stream) {
  constexpr bool SMALL = D == 32;
  constexpr int W = SMALL ? 64 : D;          // (flash_bwd's instance, unused at D 32)
  constexpr int SMEM = SMALL ? Small<32>::SMEM : Bwd<W>::SMEM;
  constexpr int CL = SMALL ? 1 : Bwd<W>::CL;
  constexpr int COLS = SMALL ? D : SUB;      // the tensor maps' box columns
  auto kernel = SMALL ? flash_bwd_small<32> : flash_bwd<W>;
  // set before every launch: a launch from another host thread (autograd's
  // worker, which runs this backward) did not see it set once from the first
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const Layout l = layout(b * h, t, D);
  unsigned char* ws = (unsigned char*)workspace;
  float* stats = (float*)(ws + l.stats_off);
  int* turn = (int*)(ws + l.turn_off);
  float* acc = (float*)(ws + l.acc_off);
  CUtensorMap map_q, map_k, map_v, map_do;
  const int keys = block_keys(D);
  if (!make_map(&map_q, q, b, h, t, dcols, s, BQ, COLS) ||
      !make_map(&map_k, k, b, h, t, dcols, s + 3, keys, COLS) ||
      !make_map(&map_v, v, b, h, t, dcols, s + 6, keys, COLS) ||
      !make_map(&map_do, dout, b, h, t, dcols, s + 12, BQ, COLS))
    return (int)cudaErrorInvalidValue;
  const dim3 tiles(l.nq, b * h);
  flash_bwd_prep<D><<<tiles, PREP_THREADS, 0, stream>>>(
      (const bf16*)o, (const bf16*)dout, lse, stats, turn, s[9], s[10], s[11], s[12], s[13], s[14],
      t, h, l.nq, dcols);
  const Params p = {stats, acc, turn, (bf16*)dq, (bf16*)dk, (bf16*)dv, dcols, t, h, l.nq, l.nk,
                    sm_scale * LOG2E, sm_scale};
  if (CL == 1) {
    kernel<<<dim3(l.nk, b * h), THREADS, SMEM, stream>>>(map_q, map_k, map_v, map_do, p);
  } else {   // clusters of CL blocks along x, one column slice each
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_launch(&attr, 0, THREADS, CL, SMEM, stream);
    cfg.gridDim = dim3(l.nk * CL, b * h);
    err = cudaLaunchKernelEx(&cfg, kernel, map_q, map_k, map_v, map_do, p);
    if (err != cudaSuccess) return (int)err;
  }
  if (l.nk > 1)
    flash_bwd_dq_convert<D><<<tiles, Groups<D>::CT * WG, 0, stream>>>((const float2*)acc,
                                                                      (bf16*)dq, t, l.nq, dcols);
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
// flash_attention_bwd_workspace(B * H, T, D) bytes, 256-byte aligned. D a
// multiple of 8 up to 1024, run on the instance instance_of(D) (32, 64,
// 128, 256, 512, 640, 768, 896 or 1024). Launches the prep pass, the fused kernel and (more than one
// key tile) the dQ conversion on `stream`; returns the cudaError_t of the
// launches.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* dq, void* dk, void* dv,
                        void* workspace, int b, int h, int t, int d, const int64_t* strides,
                        float sm_scale, void* stream) {
  if (d % 8 != 0 || d > 1024 || d <= 0 || t <= 0 || b <= 0 || h <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
#define BWD(D)                                                                                \
  case D:                                                                                     \
    return launch<D>(q, k, v, o, dout, l, dq, dk, dv, workspace, b, h, t, d, strides, sm_scale, s)
  switch (instance_of(d)) {
    BWD(32); BWD(64); BWD(128); BWD(256); BWD(512); BWD(640); BWD(768); BWD(896); BWD(1024);
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}

// Clusters of the instance that runs head dimension d (512 < d <= 1024, a
// cluster of d / 128 rounded up) that the device holds at once
// (cudaOccupancyMaxActiveClusters at one block an SM), or a negative
// cudaError_t.
int flash_attention_bwd_max_active_clusters(int d) {
#define CLUSTER(D) case D: return max_active_clusters(flash_bwd<D>, THREADS, D / 128, Bwd<D>::SMEM)
  switch ((d + 127) / 128 * 128) { CLUSTER(640); CLUSTER(768); CLUSTER(896); CLUSTER(1024); }
#undef CLUSTER
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
