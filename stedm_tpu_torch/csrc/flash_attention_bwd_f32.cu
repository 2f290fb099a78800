// Flash-attention backward (non-causal) for Hopper, fp32 in and out.
//
// Replaces the stock Pallas TPU kernels _flash_attention_bwd_dkv
// (jax/experimental/pallas/ops/tpu/flash_attention.py:941) and
// _flash_attention_bwd_dq (:1287) where the JAX package runs them on fp32
// q, k and v (diffusion.compute_dtype=float32): the U-Net's AttentionBlock in
// diffusion training ([B, 8, 1024, 128] at 512^2) and the codec's
// AttnBlockVQ in codec fine-tuning ([B, 1, 16384, 512]). Given the
// forward's inputs, its output O and LSE and the output gradient dO:
//   Di = rowsum(dO o O)
//   P  = exp2(Q K^T * sm_scale * log2 e - LSE * log2 e)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Di) * sm_scale,
//   dK = dS^T Q,  dQ = dS K,
// all in fp32, as the plain version (ops/blocked_attention.py:
// attention_backward_reference) computes them at fp32. The bf16 backward
// (flash_attention_bwd.cu) is untouched.
//
// What bounds it on the H100: the five products, 10 T^2 Dh operations a
// head, each as three TF32 wgmma products (3xTF32, wgmma_tf32.cuh) for fp32
// accuracy; the least time is 3 x 10 T^2 Dh over the TF32 peak.
//
// Design (after flash_attention_bwd.cu, each product computed once):
//   * flash_bwd_f32_stats: LSE * log2(e) and Di = rowsum(dO o O) per
//     32-query tile, [B*H, nq, 2, 32] (rows past T: +inf and 0, so their P
//     is 0); the split pass (wgmma_tf32.cuh: split_tf32) writes Q, K, V and
//     dO as TF32 hi and lo halves, [2, B*H, T, D], and Q and dO transposed,
//     [2, B*H, D, T']: wgmma's TF32 operands in shared memory are K-major
//     only, and each of Q and dO is reduced over Dh in one product and over
//     tokens in another. Q^T and dO^T hold each group of 8 tokens in the
//     order pi, so P^T and dS^T go from their accumulators into the A
//     operand as they are;
//   * flash_bwd_f32: a block owns 64 keys and DL columns of the head
//     dimension (DL = 128 at Dh 128, 256, 512 and the instances above 512,
//     else 64); Dh / DL blocks form a thread-block cluster (5 to 8 at Dh
//     640 to 1024). K and V (hi and lo, 128 KB at 128
//     columns) stay in shared memory, and K^T, the A operand of dQ^T =
//     K^T dS^T, in registers (each consumer its 64 head columns x 64 keys,
//     hi and lo, 64 a thread, read once from the split K: streamed with
//     every query tile it took a third of the ring and stalled the dQ^T
//     products on its loads). A producer warpgroup streams, per 32-query
//     tile, Q and dO (the B operands of S^T = K Q^T and dP^T = V dO^T) and
//     dO^T and Q^T (of dV += P^T dO and dK += dS^T Q) as 16 KB items
//     through a ring of four slots (TMA from 4-D tensor maps over the split
//     copies, full/empty mbarriers), and each tile's LSE and Di through a
//     ring of two. Two
//     consumer warpgroups under setmaxnreg split the products by role:
//     consumer 0 computes S^T, P^T, dV and dQ^T's first 64 columns,
//     consumer 1 dP^T, dS^T, dK and dQ^T's others, each holding one of dV
//     and dK in fp32 registers (64 a thread at 128 columns);
//   * S^T and dP^T over the cluster: each rank computes its partials over
//     its columns, and the ranks sum them through distributed shared memory
//     in rank order, so all ranks (and both consumers, which each make P^T)
//     have the same bits of P^T and dS^T. From clusters of 4 the sum is a
//     reduce-scatter and a gather (as in flash_attention_f32.cu): each rank
//     sums 1/CL of S^T's partials (consumer 0) and of dP^T's (consumer 1)
//     over the cluster and writes the sums over its own partials, and
//     consumer 0 reads S^T's sums back from their owners, consumer 1 S^T's
//     and dP^T's: 35 KB of other blocks' shared memory a rank a 32-query
//     tile at Dh 1024, where every consumer summing every partial read 168
//     KB. In clusters of 2 and 3 (Dh 256 and the Dh-192 instance) every
//     consumer still sums every rank's partials itself, which measured
//     faster there (tools/torch_flash_f32_variants.py). One exchange
//     section a consumer, 8 KB, holds a tile's partials and sums and then
//     its dQ^T part for the adder, so a tile's round trips run one after
//     another (no second section fits beside K, V, the ring and dS); after
//     a named barrier of the warpgroup, lane r of its first warp signals
//     rank r's barrier (signal_ranks);
//   * consumer 1 writes dS transposed ([32 queries][64 keys], hi and lo) as
//     the B operand of dQ^T (named barriers hand it to consumer 0 and back);
//     each consumer stages its part of dQ^T in its exchange section, and a
//     thread of the producer warpgroup adds it into an fp32 workspace with
//     one bulk reduction at the L2, in key-block order behind a turn
//     counter per (head, query tile, rank, half), so dQ
//     is the same bits on every run (no atomics in an unordered sum: block
//     kt adds after block kt - 1 has, kt = 0 stores; the bulk reduction
//     takes whole lines at the L2, where per-thread reductions were slower);
//     flash_bwd_f32_dq writes the sums into dQ;
//   * the tensor cores truncate as they accumulate (measured on mma.sync
//     and on wgmma: tools/torch_flash_f32_variants.py), so no wgmma chain
//     into one accumulator is longer than 4 k-steps (12 wgmma): the chains
//     go to two fresh accumulators in turn,
//     each added to its fp32 sum in registers with one rounding to nearest
//     while the next chain runs;
//   * keys past T get P = 0, and no gradient row past T is stored;
//   * a head dimension above 32 that is not a multiple of 64 (a multiple
//     of 4: 48, 96, 160, ...) runs the instantiation of the next multiple
//     of 64 (above 512: of 128; run_columns): the split pass writes copies
//     of that width whose columns past the head dimension are zeros (they
//     add nothing to S^T and dP^T, and give dQ, dK and dV zero columns
//     there), and only the real columns of each gradient are stored.
// All products are m64n32k8: S^T and dP^T are 64 keys x 32 queries, and dK,
// dV and dQ^T are kept as 32-column accumulators.
//
// Head dimensions 4 to 32 (num_head_channels 32 and 16) run an instance of
// their own, flash_bwd_f32_small below (the Dh-64 instance on copies
// zero-padded to 64 columns spent half of S^T, dP^T, dV and dK on zeros,
// passed S^T from one consumer to the other through shared memory every
// query tile and rebuilt P^T in both):
//   * the split copies have the head dimension's own columns (the tensor
//     maps declare them; TMA fills each 32-column box with zeros);
//   * a block owns 128 keys, and each consumer 64 of them with every
//     product of its keys: S^T = K Q^T and dP^T = V dO^T (one chain of 4
//     k-steps each), P^T and dS^T once, dV += P^T dO and dK += dS^T Q, and
//     its part of dQ^T = K^T dS^T over its 64 keys (K^T in registers; the
//     m64 tile's rows 32..63 are zero, the one product at half use), with
//     no exchange between the consumers;
//   * its dS ([32 queries][64 keys], hi and lo) goes into shared memory as
//     the B operand of its dQ^T, written from the A fragments of dK's
//     product (no second split);
//   * the dQ^T parts (32 rows, 4 KB) go to the adder in the order of the
//     64-key units, as the Dh-64 instance's blocks added theirs: unit 2 kb
//     + c is block kb's consumer c, one turn counter a (head, query tile),
//     so dQ, dK and dV are that route's bits.
// On the H100 it runs at 3.7x its 3xTF32 bound at [8, 32, 1024, 32]; the
// per-score work (exp2, the hi/lo splits) is at most 13 % of it
// (tools/torch_flash_f32_variants.py --variant noexp, nosplit).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_async.cuh"
#include "wgmma_sm90.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace sm90;
using namespace tf32w;

constexpr int THREADS = 3 * WG;            // two consumer warpgroups, then the producer's
// registers a thread after setmaxnreg: (24 + 2 * 240) * 128 = 64512 of the SM's 65536
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int BKV = 64, BQ = 32;           // keys a block, queries a tile
constexpr int ITEM = 16384;                // a streamed item: hi (8 KB), then lo
constexpr int ITEM_PART = 8192;
constexpr int NSLOT = 4;
constexpr int STAT_BYTES = 2 * BQ * 4;     // a tile's LSE * log2(e), then Di
constexpr int XCH_BYTES = 4 * WG * 16;     // a consumer's partials, [4 float4][128 threads]
constexpr int STATS_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int DL>
struct Bwd {
  static constexpr int NC = DL / 64;
  static constexpr int KV_PART = BKV * DL * 4;          // K or V, hi or lo
  static constexpr int V_OFF = 2 * KV_PART;
  static constexpr int RING_OFF = 4 * KV_PART;
  static constexpr int DS_PART = BQ * BKV * 4;          // dS [32 queries][64 keys], hi or lo
  static constexpr int DS_OFF = RING_OFF + NSLOT * ITEM;
  static constexpr int XCH_OFF = DS_OFF + 2 * DS_PART;  // S^T's partials, then dP^T's
  static constexpr int STAT_OFF = XCH_OFF + 2 * XCH_BYTES;
  static constexpr int BAR_OFF = STAT_OFF + 2 * STAT_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (9 + 2 * NSLOT + 4) + 1024;   // + alignment slack
  static constexpr int ITEMS = 4 * NC;                  // streamed items a query tile
  static_assert(SMEM <= 232448, "shared memory");
};

struct Params {
  const float* ks;      // K split, [2, BH, T, D]: its lo half at ks + ks_part
  int64_t ks_part;
  const float* stats;   // [BH, nq, 2, BQ]
  float* acc;           // [BH, nq, D / 64, 64 * BQ]: dQ^T's sums in register order
  int* turn;            // [BH, nq, cl, NC]
  float* dk;            // [BH, T, D] contiguous, as dv
  float* dv;
  int t, d, nq, nk;     // d: the columns the kernel runs at (the instance, run_columns)
  int dcols;            // the head dimension of dk, dv
  float scale_log2, sm_scale;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// LSE * log2(e) and Di = rowsum(dO o O) for query tile blockIdx.x of head
// blockIdx.y; one warp a row.
__global__ void __launch_bounds__(STATS_THREADS)
flash_bwd_f32_stats(const float* __restrict__ o, const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ stats, int64_t o_sb,
                    int64_t o_sh, int64_t o_st, int64_t d_sb, int64_t d_sh, int64_t d_st, int t,
                    int h, int d, int nq) {
  constexpr int WARPS = STATS_THREADS / 32;
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stats + ((int64_t)bh * nq + j) * 2 * BQ;
  for (int r = warp; r < BQ; r += WARPS) {
    const int row = j * BQ + r;
    float di = 0.f;
    if (row < t) {
      const float* po = o + b * o_sb + hh * o_sh + row * o_st;
      const float* pd = dout + b * d_sb + hh * d_sh + row * d_st;
      for (int c = lane; c < d; c += 32) di = fmaf(pd[c], po[c], di);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) di += __shfl_xor_sync(0xffffffffu, di, m);
    }
    if (lane == 0) {
      st[r] = row < t ? lse[(int64_t)bh * t + row] * LOG2E : INFINITY;
      st[BQ + r] = di;
    }
  }
}

// dQ^T's sums into dQ, [BH, T, D]: the sums of (head, query tile j, head
// columns 64 c ..) are NT / 2 rows of dQ^T in the consumers' register order
// (thread lt's accumulator element 4 f + k at float4 f * NT + lt, component
// k): 8 KB by 128 threads, or at the Dh-32 instance 4 KB by the 64 threads
// of a consumer's first two warps (its rows 0..31); one block a (query
// tile, column group, head), a thread a register set.
template <int NT>
__global__ void __launch_bounds__(NT)
flash_bwd_f32_dq(const float4* __restrict__ acc, float* __restrict__ dq, int t, int nq,
                 int dcols) {
  const int j = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int lt = threadIdx.x, warp = lt / 32, g = (lt % 32) >> 2, tg = lt & 3;
  const float4* part = acc + (((int64_t)bh * nq + j) * gridDim.y + c) * (4 * NT) + lt;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const float4 v = part[f * NT];
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = 4 * f + k;
      const int col = 64 * c + 16 * warp + g + 8 * ((e >> 1) & 1);
      const int q = j * BQ + 8 * (e / 4) + 2 * tg + (e & 1);
      if (q < t && col < dcols) dq[((int64_t)bh * t + q) * dcols + col] = x[k];
    }
  }
}

// Consumer CW: 0 computes S^T, P^T, dV and dQ^T's first 64 columns; 1
// dP^T, dS^T, dK and dQ^T's others.
template <int DL, int CL, int CW>
__device__ __forceinline__ void bwd_consumer(const Params& p, unsigned char* smem, uint32_t base,
                                             uint32_t bars, int bh) {
  using C = Bwd<DL>;
  constexpr int NC = C::NC, ITEMS = C::ITEMS;
  // the partials reduce-scattered from clusters of 4 (below, every rank
  // summing every partial measured faster: tools/torch_flash_f32_variants.py)
  constexpr bool SCATTER = CL >= 4;
  // remote loads in flight when an owner sums its unit: two above four
  // ranks (four spilled the consumers at Dh 1024)
  constexpr int REDUCE_LOADS = CL <= 4 ? CL : 2;
  // wgmma descriptors take the offset in the block's 256 KB window: in a
  // cluster launch the window's address carries the rank from bit 24
  const uint32_t dbase = base & 0x3FFFFu;
  const uint32_t kv_full = bars, x_full = bars + 8, x_empty = bars + 16;
  const uint32_t y_full = bars + 88 + 16 * NSLOT;
  auto st_full = [&](int u) { return bars + 24 + 8 * u; };
  auto st_empty = [&](int u) { return bars + 40 + 8 * u; };
  auto full = [&](int s) { return bars + 56 + 8 * s; };
  auto empty = [&](int s) { return bars + 56 + 8 * (NSLOT + s); };
  // this consumer's dQ^T part staged for the adder / read by the adder
  const uint32_t staged = bars + 56 + 16 * NSLOT + 8 * CW, freed = bars + 72 + 16 * NSLOT + 8 * CW;
  // the block's columns and keys (re-read for the stores at the end)
  const int col0 = cluster_rank() * DL, key0 = cluster_index_x() * BKV;
  const int lt = threadIdx.x % WG, warp = lt / 32, lane = lt % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int key_w = 16 * warp + g;               // this lane's keys: key_w, key_w + 8 of the block
  const bool key_ok0 = key0 + key_w < p.t, key_ok1 = key0 + key_w + 8 < p.t;
  auto slot_addr = [&](int item) { return dbase + C::RING_OFF + (item % NSLOT) * ITEM; };
  auto wait_item = [&](int item) { mbar_wait(full(item % NSLOT), (item / NSLOT) & 1); };
  auto free_item = [&](int item) { mbar_arrive(empty(item % NSLOT)); };
  const uint32_t ds_s = dbase + C::DS_OFF;
  const uint32_t xch = base + C::XCH_OFF + lt * 16;          // S^T's section; dP^T's + XCH_BYTES
  unsigned char* xch_p = smem + C::XCH_OFF + CW * XCH_BYTES + lt * 16;
  // the rank that sums slot f of this thread's partials: the 4 x 128 (slot,
  // thread) units of a section dealt out in order, 512 / CL a rank; from
  // clusters of 4 at most one of a thread's slots, 128 units apart, is this
  // rank's (the reduce sums that one; a loop over the four spilled)
  auto owner = [&](int f) { return ((f * WG + lt) * CL) >> 9; };
  // named barriers: 1 + CW within a consumer; 4 "dS written" (consumer 1
  // arrives, 0 waits); 5 "dS read" (consumer 0 arrives after its dQ^T
  // products of tiles 0 .. nq - 2, consumer 1 waits before writing tiles
  // 1 .. nq - 1)

  // consumer 0: dV, consumer 1: dK; 2 NC accumulators of 32 columns each
  float dg[2 * NC][16];
#pragma unroll
  for (int c = 0; c < 2 * NC; ++c)
#pragma unroll
    for (int e = 0; e < 16; ++e) dg[c][e] = 0.f;

  // K^T's A fragments for this consumer's dQ^T rows (head columns col0 +
  // 64 CW + r, r = 16 warp + g (+ 8)) over the block's keys (k-step kk:
  // keys 8 kk + tg (+ 4)); keys past T are 0
  uint32_t kth[CW < NC ? 8 : 1][4], ktl[CW < NC ? 8 : 1][4];
  if constexpr (CW < NC) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int key = key0 + 8 * kk + tg + 4 * (v >> 1);
        const int col = col0 + 64 * CW + key_w + 8 * (v & 1);
        const int64_t at = ((int64_t)bh * p.t + key) * p.d + col;
        kth[kk][v] = key < p.t ? __float_as_uint(p.ks[at]) : 0u;
        ktl[kk][v] = key < p.t ? __float_as_uint(p.ks[p.ks_part + at]) : 0u;
      }
  }

  mbar_wait(kv_full, 0);
  int it = 0;                                    // the first item of this query tile
  for (int j = 0; j < p.nq; ++j) {
    float pa[16], pb[16];

    // ---- consumer 0: S^T = K Q^T, consumer 1: dP^T = V dO^T, over this
    // rank's columns: chain ch covers columns 32 ch .. (item ch / 2) ----
    float x[16];
    auto x_chain = [&](int ch, float (&acc)[16]) {
      const int item = it + CW * NC + ch / 2;
      if (ch % 2 == 0) wait_item(item);
      const uint32_t a = dbase + CW * C::V_OFF + ch * BKV * 128;
      const uint32_t b = slot_addr(item) + (ch % 2) * BQ * 128;
      fresh(acc);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss3(acc, a + kk * 32, C::KV_PART, b + kk * 32, ITEM_PART, kk == 0);
      wgmma::commit();
    };
    auto x_fold = [&](int ch, float (&acc)[16]) {
      fence_operand(acc);
#pragma unroll
      for (int e = 0; e < 16; ++e) x[e] = ch == 0 ? acc[e] : x[e] + acc[e];
      if (ch % 2 == 1) free_item(it + CW * NC + ch / 2);
    };
    constexpr int NX = 2 * NC;
    x_chain(0, pa);
#pragma unroll
    for (int ch = 1; ch < NX; ++ch) {
      if (ch % 2) x_chain(ch, pb); else x_chain(ch, pa);
      wgmma::wait<1>();
      if (ch % 2) x_fold(ch - 1, pa); else x_fold(ch - 1, pb);
    }
    wgmma::wait<0>();
    x_fold(NX - 1, pb);

    // ---- the full S^T (both consumers) and dP^T (consumer 1): the ranks'
    // partials summed in rank order. From clusters of 4 a reduce-scatter
    // and a gather through the consumers' sections: post (write the
    // partials, one arrival on every rank), reduce (each rank sums the
    // units it owns over the cluster and writes the sums over its own
    // partials, which no other rank reads; one arrival on every rank),
    // gather (each thread reads its sums from their owners: consumer 0
    // S^T's, consumer 1 S^T's and dP^T's). At Dh 1024 a rank reads 7 KB of
    // other ranks' partials of each section and 21 KB of their sums, 35 KB
    // of other blocks' shared memory a 32-query tile, not the 168 KB of
    // every consumer summing every partial itself. A rank posts tile j
    // after every rank gathered j - 1 (x_empty), and reduces it after every
    // rank posted it. Below 4, each consumer sums every rank's partials of
    // S^T (and consumer 1 of dP^T) itself. P^T (keys past T: 0) and, in consumer
    // 1, dS^T = P^T o (dP^T - Di) * s; element e: key key_w + 8 ((e >> 1) &
    // 1), query 8 (e / 4) + 2 tg + (e & 1) ----
    {
      if (j > 0) mbar_wait_cluster(x_empty, (j - 1) & 1);
      if (CW < NC && j > 0) mbar_wait(freed, (j - 1) & 1);   // the adder has read the section
#pragma unroll
      for (int f = 0; f < 4; ++f)
        *reinterpret_cast<float4*>(xch_p + f * WG * 16) =
            make_float4(x[4 * f], x[4 * f + 1], x[4 * f + 2], x[4 * f + 3]);
      group_sync(1 + CW, WG);
      if (warp == 0) signal_ranks<CL>(x_full, lane);
      if constexpr (SCATTER) {
        const int rank = cluster_rank();
        mbar_wait_cluster(x_full, j & 1);
        int mine = -1;
#pragma unroll
        for (int f = 0; f < 4; ++f)
          if (owner(f) == rank) mine = f;
        if (mine >= 0) {
          float4 v[1];
          sum_ranks<1, CL, REDUCE_LOADS>(v, xch + CW * XCH_BYTES + mine * WG * 16);
          *reinterpret_cast<float4*>(xch_p + mine * WG * 16) = v[0];
        }
        group_sync(1 + CW, WG);
        if (warp == 0) signal_ranks<CL>(y_full, lane);
      }
      mbar_wait(st_full(j % 2), (j / 2) & 1);
      const float* stat = reinterpret_cast<const float*>(smem + C::STAT_OFF + (j % 2) * STAT_BYTES);
      // P^T from S^T's sums; in consumer 1 dS^T from P^T and dP^T's sums.
      // Element e: slot e / 4, key key_w + 8 ((e >> 1) & 1), query q(e)
      auto q_of = [&](int e) { return 8 * (e / 4) + 2 * tg + (e & 1); };
      auto p_of = [&](int e, float st) {
        const bool ok = (e & 2) ? key_ok1 : key_ok0;
        return ok ? exp2f(fmaf(st, p.scale_log2, -stat[q_of(e)])) : 0.f;
      };
      auto ds_of = [&](int e, float pt, float dpt) {
        return pt * (dpt - stat[BQ + q_of(e)]) * p.sm_scale;
      };
      if constexpr (SCATTER) {
        // the sums gathered GATHER slots at a time: 16 registers of loads
        // in flight in either consumer
        constexpr int GATHER = CW == 0 ? 4 : 2;
        mbar_wait_cluster(y_full, j & 1);
#pragma unroll
        for (int f0 = 0; f0 < 4; f0 += GATHER) {
          float4 v[GATHER], w[GATHER];
#pragma unroll
          for (int f = 0; f < GATHER; ++f) {
            v[f] = ld_cluster_f4(map_rank(xch + (f0 + f) * WG * 16, owner(f0 + f)));
            if constexpr (CW == 1)
              w[f] = ld_cluster_f4(map_rank(xch + XCH_BYTES + (f0 + f) * WG * 16, owner(f0 + f)));
          }
#pragma unroll
          for (int e = 4 * f0; e < 4 * (f0 + GATHER); ++e) {
            x[e] = p_of(e, (&v[e / 4 - f0].x)[e % 4]);
            if constexpr (CW == 1) x[e] = ds_of(e, x[e], (&w[e / 4 - f0].x)[e % 4]);
          }
        }
      } else {
        float4 v[4];
        mbar_wait_cluster(x_full, j & 1);
        sum_ranks<4, CL>(v, xch);
#pragma unroll
        for (int e = 0; e < 16; ++e) x[e] = p_of(e, (&v[e / 4].x)[e % 4]);
        if constexpr (CW == 1) {
          sum_ranks<4, CL>(v, xch + XCH_BYTES);
#pragma unroll
          for (int e = 0; e < 16; ++e) x[e] = ds_of(e, x[e], (&v[e / 4].x)[e % 4]);
        }
      }
      group_sync(1 + CW, WG);
      if (warp == 0) signal_ranks<CL>(x_empty, lane);
      mbar_arrive(st_empty(j % 2));
    }
    if (CW == 1) {
      // dS as the B operand of dQ^T: [32 queries][64 keys], hi then lo, in
      // the 128-byte swizzle (row q's 16-byte chunk c at chunk c ^ (q & 7)),
      // once consumer 0's products of the previous tile have read it
      if (j > 0) group_sync(5, 2 * WG);
      unsigned char* ds_p = smem + C::DS_OFF;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int q = 8 * (e / 4) + 2 * tg + (e & 1), key = key_w + 8 * ((e >> 1) & 1);
        const int at = (key / 32) * BQ * 128 + q * 128 + ((((key % 32) / 4) ^ (q & 7)) * 16) +
                       (key % 4) * 4;
        uint32_t hi, lo;
        split(x[e], hi, lo);
        *reinterpret_cast<uint32_t*>(ds_p + at) = hi;
        *reinterpret_cast<uint32_t*>(ds_p + C::DS_PART + at) = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      group_sync(2, WG);                         // this consumer's own products read it too
      group_arrive(4, 2 * WG);
    }
    // P^T (consumer 0) or dS^T (consumer 1) as A operands
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(x + 4 * kk, ah[kk], al[kk]);

    // ---- consumer 0: dV += P^T dO (dO^T items), consumer 1: dK += dS^T Q
    // (Q^T items); chain c covers columns 32 c .. (item c / 2) ----
    auto g_chain = [&](int c, float (&acc)[16]) {
      const int item = it + (2 + CW) * NC + c / 2;
      if (c % 2 == 0) wait_item(item);
      const uint32_t b = slot_addr(item) + (c % 2) * 32 * 128;
      fresh(acc);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) rs3(acc, ah[kk], al[kk], b + kk * 32, ITEM_PART, kk == 0);
      wgmma::commit();
    };
    auto g_fold = [&](int c, float (&acc)[16]) {
      fence_operand(acc);
#pragma unroll
      for (int e = 0; e < 16; ++e) dg[c][e] += acc[e];
      if (c % 2 == 1) free_item(it + (2 + CW) * NC + c / 2);
    };
    g_chain(0, pa);
#pragma unroll
    for (int c = 1; c < 2 * NC; ++c) {
      if (c % 2) g_chain(c, pb); else g_chain(c, pa);
      wgmma::wait<1>();
      if (c % 2) g_fold(c - 1, pa); else g_fold(c - 1, pb);
    }
    wgmma::wait<0>();
    g_fold(2 * NC - 1, pb);

    // ---- dQ^T = K^T dS^T over the block's keys: consumer h takes the head
    // columns 64 h .. (with 64 columns, consumer 0 all of them); chain kh
    // covers keys 32 kh .. ----
    if (CW == 0) group_sync(4, 2 * WG);          // consumer 1's dS is in shared memory
    if (CW < NC) {
      float dq[16];
      auto d_chain = [&](int kh, float (&acc)[16]) {
        const uint32_t b = ds_s + kh * BQ * 128;
        fresh(acc);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          rs3(acc, kth[4 * kh + kk], ktl[4 * kh + kk], b + kk * 32, C::DS_PART, kk == 0);
        wgmma::commit();
      };
      d_chain(0, pa);
      d_chain(1, pb);
      wgmma::wait<0>();
      fence_operand(pa);
      fence_operand(pb);
#pragma unroll
      for (int e = 0; e < 16; ++e) dq[e] = pa[e] + pb[e];
      if (CW == 0 && j + 1 < p.nq) group_arrive(5, 2 * WG);   // dS may be rewritten

      // ---- this block's part of dQ^T to the adder (a thread of the
      // producer warpgroup), staged in this consumer's exchange section (free
      // once every rank has read the tile's partials) in register order ----
      if constexpr (CL > 1) mbar_wait_cluster(x_empty, j & 1);
#pragma unroll
      for (int f = 0; f < 4; ++f)
        *reinterpret_cast<float4*>(xch_p + f * WG * 16) =
            make_float4(dq[4 * f], dq[4 * f + 1], dq[4 * f + 2], dq[4 * f + 3]);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      group_sync(1 + CW, WG);
      if (lt == 0) mbar_arrive(staged);
    }
    it += ITEMS;
  }

  // ---- consumer 0's dV, consumer 1's dK for this block's keys (keys past
  // T are not written) ----
  float* out = CW == 0 ? p.dv : p.dk;
  const int col0_ = cluster_rank() * DL, key0_ = cluster_index_x() * BKV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0_ + key_w + 8 * r;
    if (key >= p.t) continue;
    float* o = out + ((int64_t)bh * p.t + key) * p.dcols + col0_ + 2 * tg;
#pragma unroll
    for (int c = 0; c < 2 * NC; ++c)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (col0_ + 32 * c + 8 * jj + 2 * tg < p.dcols)
          *reinterpret_cast<float2*>(o + 32 * c + 8 * jj) =
              make_float2(dg[c][4 * jj + 2 * r], dg[c][4 * jj + 2 * r + 1]);
  }
}

template <int DL, int CL>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_f32(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_qt, const __grid_constant__ CUtensorMap map_dot,
              const Params p) {
  using C = Bwd<DL>;
  constexpr int NC = C::NC, ITEMS = C::ITEMS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + C::BAR_OFF;
  const uint32_t kv_full = bars, x_full = bars + 8, x_empty = bars + 16;
  auto st_full = [&](int u) { return bars + 24 + 8 * u; };
  auto st_empty = [&](int u) { return bars + 40 + 8 * u; };
  auto full = [&](int s) { return bars + 56 + 8 * s; };
  auto empty = [&](int s) { return bars + 56 + 8 * (NSLOT + s); };

  const int bh = blockIdx.y;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(x_full, 2 * CL);
    mbar_init(x_empty, 2 * CL);
    for (int u = 0; u < 2; ++u) {
      mbar_init(st_full(u), 1);
      mbar_init(st_empty(u), 2 * WG);
    }
    for (int s = 0; s < NSLOT; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG);
    }
    for (int c = 0; c < 4; ++c) mbar_init(bars + 56 + 16 * NSLOT + 8 * c, 1);   // staged[2], freed[2]
    mbar_init(bars + 88 + 16 * NSLOT, 2 * CL);                                   // y_full
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if constexpr (CL > 1)
    cluster_sync_all();   // every rank's barriers are initialised before any remote arrival
  else
    __syncthreads();

  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      const int col0 = cluster_rank() * DL, key0 = cluster_index_x() * BKV;
      // ---- loads: K and V once, then a query tile's LSE and Di and its
      // items in the order the consumers take them: Q, dO, dO^T, Q^T (NC
      // items each, 64 columns an item) ----
      mbar_expect_tx(kv_full, 4 * C::KV_PART);
      for (int part = 0; part < 2; ++part)
        for (int sub = 0; sub < DL / 32; ++sub) {
          const uint32_t at = base + part * C::KV_PART + sub * BKV * 128;
          tma_load(at, &map_k, kv_full, col0 + 32 * sub, key0, bh, part);
          tma_load(at + C::V_OFF, &map_v, kv_full, col0 + 32 * sub, key0, bh, part);
        }
      int it = 0;
      for (int j = 0; j < p.nq; ++j) {
        mbar_wait(st_empty(j % 2), ((j / 2) & 1) ^ 1);
        mbar_expect_tx(st_full(j % 2), STAT_BYTES);
        bulk_load(base + C::STAT_OFF + (j % 2) * STAT_BYTES,
                  p.stats + ((int64_t)bh * p.nq + j) * 2 * BQ, STAT_BYTES, st_full(j % 2));
        for (int n = 0; n < ITEMS; ++n, ++it) {
          const int s = it % NSLOT, kind = n / NC, c = n % NC;
          const uint32_t dst = base + C::RING_OFF + s * ITEM;
          mbar_wait(empty(s), ((it / NSLOT) & 1) ^ 1);
          mbar_expect_tx(full(s), ITEM);
          for (int part = 0; part < 2; ++part) {
            const uint32_t at = dst + part * ITEM_PART;
            if (kind <= 1) {      // Q, dO: 32 queries x columns 64 c .., two sub-tiles
              const CUtensorMap* map = kind == 0 ? &map_q : &map_do;
              tma_load(at, map, full(s), col0 + 64 * c, j * BQ, bh, part);
              tma_load(at + BQ * 128, map, full(s), col0 + 64 * c + 32, j * BQ, bh, part);
            } else {              // dO^T, Q^T: columns 64 c .. x 32 queries
              tma_load(at, kind == 2 ? &map_dot : &map_qt, full(s), j * BQ, col0 + 64 * c, bh,
                       part);
            }
          }
        }
      }
    } else if (threadIdx.x % 32 == 0 && threadIdx.x / 32 - 9 < NC) {
      // ---- the adder of consumer c: its dQ^T part of each query tile into
      // the sums with one 8 KB bulk reduction at the L2 (block kt = 0
      // stores), after block kt - 1 has added its own (the turn counter) ----
      const int c = threadIdx.x / 32 - 9;
      const uint32_t staged = bars + 56 + 16 * NSLOT + 8 * c, freed = bars + 72 + 16 * NSLOT + 8 * c;
      const uint32_t src = base + Bwd<DL>::XCH_OFF + c * XCH_BYTES;
      for (int j = 0; j < p.nq; ++j) {
        const int rank = cluster_rank(), kt = cluster_index_x();
        int* turn = p.turn + (((int64_t)bh * p.nq + j) * CL + rank) * NC + c;
        float* acc = p.acc + (((int64_t)bh * p.nq + j) * (p.d / 64) + rank * NC + c) * (64 * BQ);
        mbar_wait(staged, j & 1);
        if (kt > 0) {
          while (ld_acquire(turn) < kt) {
          }
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          bulk_reduce_add_f32(acc, src, XCH_BYTES);
        } else {
          bulk_store(acc, src, XCH_BYTES);
        }
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(freed);                        // the section may be written again
        bulk_wait();                               // the sums are written: pass the turn on
        if (kt + 1 < p.nk) {
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          __threadfence();
          atomicAdd(turn, 1);
        }
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    if (wg == 0)
      bwd_consumer<DL, CL, 0>(p, smem, base, bars, bh);
    else
      bwd_consumer<DL, CL, 1>(p, smem, base, bars, bh);
  }
  // no block leaves while another rank may still read its partials or
  // arrive on its barriers
  if constexpr (CL > 1) cluster_sync_all();
}

// ---------------------------------------------------------------------------
// The Dh-32 instance (head dimensions 4 .. 32): 128 keys a block, each
// consumer 64 keys and every product of them.
// ---------------------------------------------------------------------------

namespace dh32 {
constexpr int BKV = 128;                   // keys a block
constexpr int KV_PART = BKV * 128;         // K or V, hi or lo: 128 keys x 32 columns
constexpr int V_OFF = 2 * KV_PART;
constexpr int ITEM_PART = BQ * 128;        // a streamed item's hi or lo: 32 x 32
constexpr int ITEM = 2 * ITEM_PART;
constexpr int NSLOT = 8;
constexpr int RING_OFF = 4 * KV_PART;
constexpr int DS_PART = BQ * 64 * 4;       // a consumer's dS [32 queries][64 keys], hi or lo
constexpr int DS_OFF = RING_OFF + NSLOT * ITEM;
constexpr int STG_BYTES = 4 * 64 * 16;     // a consumer's dQ^T rows 0..31: [4 float4][64 threads]
constexpr int STG_OFF = DS_OFF + 4 * DS_PART;
constexpr int STAT_OFF = STG_OFF + 2 * STG_BYTES;
constexpr int BAR_OFF = STAT_OFF + 2 * STAT_BYTES;
constexpr int SMEM = BAR_OFF + 8 * (5 + 2 * NSLOT + 4) + 1024;   // + alignment slack
static_assert(SMEM <= 232448, "shared memory");
}  // namespace dh32

// Consumer CW: keys 64 CW .. 64 CW + 63 of the block, every product of them.
template <int CW>
__device__ __forceinline__ void small_consumer(const Params& p, unsigned char* smem, uint32_t base,
                                               uint32_t bars, int bh) {
  using dh32::BKV, dh32::KV_PART, dh32::V_OFF, dh32::ITEM_PART, dh32::ITEM, dh32::NSLOT, dh32::RING_OFF, dh32::DS_PART, dh32::DS_OFF, dh32::STG_BYTES, dh32::STG_OFF,
      dh32::STAT_OFF;
  const uint32_t dbase = base & 0x3FFFFu;
  const uint32_t kv_full = bars;
  auto st_full = [&](int u) { return bars + 8 + 8 * u; };
  auto st_empty = [&](int u) { return bars + 24 + 8 * u; };
  auto full = [&](int s) { return bars + 40 + 8 * s; };
  auto empty = [&](int s) { return bars + 40 + 8 * (NSLOT + s); };
  const uint32_t staged = bars + 40 + 16 * NSLOT + 8 * CW, freed = bars + 56 + 16 * NSLOT + 8 * CW;
  const int lt = threadIdx.x % WG, warp = lt / 32, lane = lt % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int key0 = blockIdx.x * BKV + 64 * CW;
  const int key_w = 16 * warp + g;               // this lane's keys: key_w, key_w + 8 of the 64
  const bool key_ok0 = key0 + key_w < p.t, key_ok1 = key0 + key_w + 8 < p.t;
  auto slot_addr = [&](int item) { return dbase + RING_OFF + (item % NSLOT) * ITEM; };
  auto wait_item = [&](int item) { mbar_wait(full(item % NSLOT), (item / NSLOT) & 1); };
  auto free_item = [&](int item) { mbar_arrive(empty(item % NSLOT)); };
  const uint32_t ka = dbase + CW * 64 * 128, va = dbase + V_OFF + CW * 64 * 128;
  const uint32_t ds_s = dbase + DS_OFF + CW * 2 * DS_PART;
  unsigned char* ds_p = smem + DS_OFF + CW * 2 * DS_PART;

  float dv[16], dk[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) dv[e] = dk[e] = 0.f;

  // K^T's A fragments for dQ^T's rows (head columns r = 16 warp + g (+ 8);
  // rows from d on, warps 2 and 3 whole, are 0) over this consumer's keys
  // (k-step kk: keys 8 kk + tg (+ 4)); keys past T are 0
  uint32_t kth[8][4], ktl[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int key = key0 + 8 * kk + tg + 4 * (v >> 1), col = key_w + 8 * (v & 1);
      const int64_t at = ((int64_t)bh * p.t + key) * p.d + col;
      const bool ok = key < p.t && col < p.d;
      kth[kk][v] = ok ? __float_as_uint(p.ks[at]) : 0u;
      ktl[kk][v] = ok ? __float_as_uint(p.ks[p.ks_part + at]) : 0u;
    }

  mbar_wait(kv_full, 0);
  for (int j = 0; j < p.nq; ++j) {
    const int it = 4 * j;                        // Q, dO, dO^T, Q^T of query tile j
    // ---- S^T = K Q^T and dP^T = V dO^T over the 32 columns, one chain each ----
    float x[16], y[16];
    wait_item(it);
    wait_item(it + 1);
    fresh(x);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ss3(x, ka + kk * 32, KV_PART, slot_addr(it) + kk * 32, ITEM_PART, kk == 0);
    wgmma::commit();
    fresh(y);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ss3(y, va + kk * 32, KV_PART, slot_addr(it + 1) + kk * 32, ITEM_PART, kk == 0);
    wgmma::commit();
    wgmma::wait<0>();
    fence_operand(x);
    fence_operand(y);
    free_item(it);
    free_item(it + 1);

    // ---- P^T (keys past T: 0) and dS^T = P^T o (dP^T - Di) * s; element e:
    // key key_w + 8 ((e >> 1) & 1), query 8 (e / 4) + 2 tg + (e & 1) ----
    mbar_wait(st_full(j % 2), (j / 2) & 1);
    const float* stat = reinterpret_cast<const float*>(smem + STAT_OFF + (j % 2) * STAT_BYTES);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int q = 8 * (e / 4) + 2 * tg + (e & 1);
      const bool ok = (e & 2) ? key_ok1 : key_ok0;
      x[e] = ok ? exp2f(fmaf(x[e], p.scale_log2, -stat[q])) : 0.f;
      y[e] = x[e] * (y[e] - stat[BQ + q]) * p.sm_scale;
    }

    // ---- dV += P^T dO (dO^T item) ----
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(x + 4 * kk, ah[kk], al[kk]);
    float ga[16], gb[16];
    wait_item(it + 2);
    fresh(ga);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) rs3(ga, ah[kk], al[kk], slot_addr(it + 2) + kk * 32, ITEM_PART, kk == 0);
    wgmma::commit();

    // ---- dS^T's A fragments; dS as dQ^T's B operand: [32 queries][64
    // keys], hi then lo, in the 128-byte swizzle (row q's 16-byte chunk c at
    // chunk c ^ (q & 7)), from the fragments (element 4 kk + m is fragment
    // value m of k-step kk, m = 1 and 2 swapped) ----
    uint32_t sh[4][4], sl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(y + 4 * kk, sh[kk], sl[kk]);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int q = 8 * (e / 4) + 2 * tg + (e & 1), key = key_w + 8 * ((e >> 1) & 1);
      const int at = (key / 32) * BQ * 128 + q * 128 + ((((key % 32) / 4) ^ (q & 7)) * 16) +
                     (key % 4) * 4;
      const int v = (e & 3) == 1 ? 2 : (e & 3) == 2 ? 1 : e & 3;
      *reinterpret_cast<uint32_t*>(ds_p + at) = sh[e / 4][v];
      *reinterpret_cast<uint32_t*>(ds_p + DS_PART + at) = sl[e / 4][v];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    group_sync(1 + CW, WG);                      // the warpgroup's products read it

    // ---- dK += dS^T Q (Q^T item) ----
    wait_item(it + 3);
    fresh(gb);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) rs3(gb, sh[kk], sl[kk], slot_addr(it + 3) + kk * 32, ITEM_PART, kk == 0);
    wgmma::commit();
    wgmma::wait<1>();
    fence_frags(ah);
    fence_frags(al);
    fence_operand(ga);
#pragma unroll
    for (int e = 0; e < 16; ++e) dv[e] += ga[e];
    free_item(it + 2);

    // ---- dQ^T = K^T dS^T over this consumer's 64 keys: chain kh covers
    // keys 32 kh .. ----
    float da[16], db[16];
    fresh(da);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) rs3(da, kth[kk], ktl[kk], ds_s + kk * 32, DS_PART, kk == 0);
    wgmma::commit();
    fresh(db);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      rs3(db, kth[4 + kk], ktl[4 + kk], ds_s + BQ * 128 + kk * 32, DS_PART, kk == 0);
    wgmma::commit();
    wgmma::wait<2>();
    fence_frags(sh);
    fence_frags(sl);
    fence_operand(gb);
#pragma unroll
    for (int e = 0; e < 16; ++e) dk[e] += gb[e];
    free_item(it + 3);
    wgmma::wait<0>();
    fence_operand(da);
    fence_operand(db);

    // ---- dQ^T's rows 0..31 (warps 0 and 1) to the adder, staged in
    // register order once it has read the previous tile's ----
    if (j > 0) mbar_wait(freed, (j - 1) & 1);
    if (warp < 2) {
      float4* stg = reinterpret_cast<float4*>(smem + STG_OFF + CW * STG_BYTES) + lt;
#pragma unroll
      for (int f = 0; f < 4; ++f)
        stg[f * 64] = make_float4(da[4 * f] + db[4 * f], da[4 * f + 1] + db[4 * f + 1],
                                  da[4 * f + 2] + db[4 * f + 2], da[4 * f + 3] + db[4 * f + 3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    group_sync(1 + CW, WG);
    if (lt == 0) mbar_arrive(staged);
    // the tile's LSE and Di slot is released only here, after the warpgroup's
    // barrier: released right after the reads, its reload for tile j + 2
    // corrupted dS^T in some blocks of large grids (consumers skewed by the
    // adder's turns), which the barrier-separated release does not
    mbar_arrive(st_empty(j % 2));
  }

  // ---- dV and dK of this consumer's keys (keys past T, columns past dcols
  // not written) ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + key_w + 8 * r;
    if (key >= p.t) continue;
    const int64_t row = ((int64_t)bh * p.t + key) * p.dcols + 2 * tg;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (8 * jj + 2 * tg >= p.dcols) continue;
      *reinterpret_cast<float2*>(p.dv + row + 8 * jj) =
          make_float2(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
      *reinterpret_cast<float2*>(p.dk + row + 8 * jj) =
          make_float2(dk[4 * jj + 2 * r], dk[4 * jj + 2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_f32_small(const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_qt,
                    const __grid_constant__ CUtensorMap map_dot, const Params p) {
  using dh32::BKV, dh32::KV_PART, dh32::V_OFF, dh32::ITEM_PART, dh32::ITEM, dh32::NSLOT, dh32::RING_OFF, dh32::DS_PART, dh32::DS_OFF, dh32::STG_BYTES, dh32::STG_OFF,
      dh32::STAT_OFF, dh32::BAR_OFF;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  // barriers: kv_full, st_full[2], st_empty[2], full[NSLOT], empty[NSLOT],
  // staged[2], freed[2]
  const uint32_t bars = base + BAR_OFF;
  const uint32_t kv_full = bars;
  auto st_full = [&](int u) { return bars + 8 + 8 * u; };
  auto st_empty = [&](int u) { return bars + 24 + 8 * u; };
  auto full = [&](int s) { return bars + 40 + 8 * s; };
  auto empty = [&](int s) { return bars + 40 + 8 * (NSLOT + s); };
  const int bh = blockIdx.y, wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int u = 0; u < 2; ++u) {
      mbar_init(st_full(u), 1);
      mbar_init(st_empty(u), 2 * WG);
    }
    for (int s = 0; s < NSLOT; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * WG);
    }
    for (int c = 0; c < 4; ++c) mbar_init(bars + 40 + 16 * NSLOT + 8 * c, 1);   // staged, freed
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      // ---- loads: K and V of the block's 128 keys once, then a query
      // tile's LSE and Di and its items in the order the consumers take
      // them: Q, dO, dO^T, Q^T ----
      const int key0 = blockIdx.x * BKV;
      mbar_expect_tx(kv_full, 4 * KV_PART);
      for (int part = 0; part < 2; ++part) {
        tma_load(base + part * KV_PART, &map_k, kv_full, 0, key0, bh, part);
        tma_load(base + V_OFF + part * KV_PART, &map_v, kv_full, 0, key0, bh, part);
      }
      int it = 0;
      for (int j = 0; j < p.nq; ++j) {
        mbar_wait(st_empty(j % 2), ((j / 2) & 1) ^ 1);
        mbar_expect_tx(st_full(j % 2), STAT_BYTES);
        bulk_load(base + STAT_OFF + (j % 2) * STAT_BYTES,
                  p.stats + ((int64_t)bh * p.nq + j) * 2 * BQ, STAT_BYTES, st_full(j % 2));
        for (int kind = 0; kind < 4; ++kind, ++it) {
          const int s = it % NSLOT;
          const uint32_t dst = base + RING_OFF + s * ITEM;
          mbar_wait(empty(s), ((it / NSLOT) & 1) ^ 1);
          mbar_expect_tx(full(s), ITEM);
          for (int part = 0; part < 2; ++part) {
            const uint32_t at = dst + part * ITEM_PART;
            if (kind <= 1)        // Q, dO: 32 queries x 32 columns
              tma_load(at, kind == 0 ? &map_q : &map_do, full(s), 0, j * BQ, bh, part);
            else                  // dO^T, Q^T: 32 columns x 32 queries
              tma_load(at, kind == 2 ? &map_dot : &map_qt, full(s), j * BQ, 0, bh, part);
          }
        }
      }
    } else if (threadIdx.x == 2 * WG + 32 || threadIdx.x == 2 * WG + 64) {
      // ---- the adder of consumer c: its dQ^T part of each query tile into
      // the sums with one 4 KB bulk reduction at the L2, in the order of the
      // 64-key units (unit 0 stores), behind one turn counter a (head,
      // query tile); a unit wholly past T adds nothing ----
      const int c = threadIdx.x / 32 - 9, u = 2 * blockIdx.x + c;
      const uint32_t staged = bars + 40 + 16 * NSLOT + 8 * c, freed = bars + 56 + 16 * NSLOT + 8 * c;
      const uint32_t src = base + STG_OFF + c * STG_BYTES;
      for (int j = 0; j < p.nq; ++j) {
        mbar_wait(staged, j & 1);
        if (u >= p.nk) {
          mbar_arrive(freed);
          continue;
        }
        int* turn = p.turn + (int64_t)bh * p.nq + j;
        float* acc = p.acc + ((int64_t)bh * p.nq + j) * (32 * BQ);
        if (u > 0) {
          while (ld_acquire(turn) < u) {
          }
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          bulk_reduce_add_f32(acc, src, STG_BYTES);
        } else {
          bulk_store(acc, src, STG_BYTES);
        }
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(freed);                        // the section may be written again
        bulk_wait();                               // the sums are written: pass the turn on
        if (u + 1 < p.nk) {
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          __threadfence();
          atomicAdd(turn, 1);
        }
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    if (wg == 0)
      small_consumer<0>(p, smem, base, bars, bh);
    else
      small_consumer<1>(p, smem, base, bars, bh);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The workspace: the split copies (Q, K, V, dO natural; Q and dO
// transposed), the stats, the turn counters and dQ^T's sums, each region
// 256-byte aligned.
struct Layout {
  int nq, nk, tp;
  size_t nat[4], tr[2], stats_off, turn_off, acc_off, bytes;
};

// d: the copies' columns (copy_columns); at the Dh-32 instance (d <= 32)
// one turn counter and one 32-row part of dQ^T's sums a (head, query tile),
// else D / 64 of each, of 64 rows.
Layout layout(int bh, int t, int d) {
  Layout l;
  l.nq = (t + BQ - 1) / BQ;
  l.nk = (t + BKV - 1) / BKV;
  l.tp = (t + 7) / 8 * 8;
  const size_t nat = align256((size_t)2 * bh * t * d * 4);
  const size_t tr = align256((size_t)2 * bh * d * l.tp * 4);
  const size_t groups = d <= 32 ? 1 : d / 64, rows = d <= 32 ? 32 : 64;   // cl * NC = D / 64
  size_t off = 0;
  for (int i = 0; i < 4; ++i, off += nat) l.nat[i] = off;
  for (int i = 0; i < 2; ++i, off += tr) l.tr[i] = off;
  l.stats_off = off;
  off += align256((size_t)bh * l.nq * 2 * BQ * 4);
  l.turn_off = off;
  off += align256((size_t)bh * l.nq * groups * 4);
  l.acc_off = off;
  l.bytes = off + align256((size_t)bh * l.nq * groups * rows * BQ * 4);
  return l;
}

// The stats pass, then the split pass (Q, K, V, dO as they are; Q and dO
// transposed in the order pi): copies of `d` columns, the inputs' `dx`.
cudaError_t prepare(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const float* lse, const Layout& l, unsigned char* ws, int bh, int h, int t,
                    int d, int dx, const int64_t* s, cudaStream_t stream) {
  flash_bwd_f32_stats<<<dim3(l.nq, bh), STATS_THREADS, 0, stream>>>(
      (const float*)o, (const float*)dout, lse, (float*)(ws + l.stats_off), s[9], s[10], s[11],
      s[12], s[13], s[14], t, h, dx, l.nq);
  float* nat[4];
  float* tr[2];
  for (int i = 0; i < 4; ++i) nat[i] = (float*)(ws + l.nat[i]);   // Q, K, V, dO
  for (int i = 0; i < 2; ++i) tr[i] = (float*)(ws + l.tr[i]);     // Q^T, dO^T (pi)
  SplitParams sp = {};
  sp.job[0] = {(const float*)q, s[0], s[1], s[2], nat[0], tr[0], 1};
  sp.job[1] = {(const float*)k, s[3], s[4], s[5], nat[1], nullptr, 0};
  sp.job[2] = {(const float*)v, s[6], s[7], s[8], nat[2], nullptr, 0};
  sp.job[3] = {(const float*)dout, s[12], s[13], s[14], nat[3], tr[1], 1};
  sp.njobs = 4;
  sp.h = h;
  sp.t = t;
  sp.d = d;
  sp.dx = dx;
  sp.tp = l.tp;
  sp.bh = bh;
  return launch_split(sp, stream);
}

// The Dh-32 instance: copies of the head dimension's own d columns.
int launch_small(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, void* dq, void* dk, void* dv, void* workspace, int b, int h,
                 int t, int d, const int64_t* s, float sm_scale, cudaStream_t stream) {
  // set before every launch (see launch below)
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_f32_small,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dh32::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int bh = b * h;
  const Layout l = layout(bh, t, d);
  unsigned char* ws = (unsigned char*)workspace;
  float* acc = (float*)(ws + l.acc_off);
  int* turn = (int*)(ws + l.turn_off);
  err = cudaMemsetAsync(turn, 0, (size_t)bh * l.nq * 4, stream);
  if (err != cudaSuccess) return (int)err;
  err = prepare(q, k, v, o, dout, lse, l, ws, bh, h, t, d, d, s, stream);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_k, map_v, map_q, map_do, map_qt, map_dot;
  if (!make_split_map(&map_k, (float*)(ws + l.nat[1]), bh, t, d, dh32::BKV) ||
      !make_split_map(&map_v, (float*)(ws + l.nat[2]), bh, t, d, dh32::BKV) ||
      !make_split_map(&map_q, (float*)(ws + l.nat[0]), bh, t, d, BQ) ||
      !make_split_map(&map_do, (float*)(ws + l.nat[3]), bh, t, d, BQ) ||
      !make_split_map(&map_qt, (float*)(ws + l.tr[0]), bh, d, l.tp, 32) ||
      !make_split_map(&map_dot, (float*)(ws + l.tr[1]), bh, d, l.tp, 32))
    return (int)cudaErrorInvalidValue;
  const Params p = {(float*)(ws + l.nat[1]), (int64_t)bh * t * d, (float*)(ws + l.stats_off), acc,
                    turn, (float*)dk, (float*)dv, t, d, l.nq, l.nk, d, sm_scale * LOG2E, sm_scale};
  flash_bwd_f32_small<<<dim3((t + dh32::BKV - 1) / dh32::BKV, bh), THREADS, dh32::SMEM, stream>>>(
      map_k, map_v, map_q, map_do, map_qt, map_dot, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_f32_dq<64><<<dim3(l.nq, 1, bh), 64, 0, stream>>>((const float4*)acc, (float*)dq, t,
                                                              l.nq, d);
  return (int)cudaGetLastError();
}

template <int DL, int CL>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, void* workspace, int b, int h, int t,
           int d, const int64_t* s, float sm_scale, cudaStream_t stream) {
  using C = Bwd<DL>;
  // set before every launch: a launch from another host thread (autograd's
  // worker, which runs this backward) did not see it set once from the first
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_f32<DL, CL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int bh = b * h, dx = d;
  d = run_columns(d);
  const Layout l = layout(bh, t, d);
  unsigned char* ws = (unsigned char*)workspace;
  float* nat[4];
  float* tr[2];
  for (int i = 0; i < 4; ++i) nat[i] = (float*)(ws + l.nat[i]);   // Q, K, V, dO
  for (int i = 0; i < 2; ++i) tr[i] = (float*)(ws + l.tr[i]);     // Q^T, dO^T (pi)
  float* stats = (float*)(ws + l.stats_off);
  int* turn = (int*)(ws + l.turn_off);
  float* acc = (float*)(ws + l.acc_off);

  err = cudaMemsetAsync(turn, 0, (size_t)bh * l.nq * (d / 64) * 4, stream);
  if (err != cudaSuccess) return (int)err;
  err = prepare(q, k, v, o, dout, lse, l, ws, bh, h, t, d, dx, s, stream);
  if (err != cudaSuccess) return (int)err;

  CUtensorMap map_k, map_v, map_q, map_do, map_qt, map_dot;
  if (!make_split_map(&map_k, nat[1], bh, t, d, BKV) ||
      !make_split_map(&map_v, nat[2], bh, t, d, BKV) ||
      !make_split_map(&map_q, nat[0], bh, t, d, BQ) ||
      !make_split_map(&map_do, nat[3], bh, t, d, BQ) ||
      !make_split_map(&map_qt, tr[0], bh, d, l.tp, 64) ||
      !make_split_map(&map_dot, tr[1], bh, d, l.tp, 64))
    return (int)cudaErrorInvalidValue;
  const Params p = {nat[1], (int64_t)bh * t * d, stats, acc, turn, (float*)dk, (float*)dv, t, d,
                    l.nq, l.nk, dx, sm_scale * LOG2E, sm_scale};
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_launch(&attr, 0, THREADS, CL, C::SMEM, stream);
  cfg.gridDim = dim3(l.nk * CL, bh);
  err = cudaLaunchKernelEx(&cfg, flash_bwd_f32<DL, CL>, map_k, map_v, map_q, map_do, map_qt, map_dot,
                           p);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_f32_dq<WG><<<dim3(l.nq, d / 64, bh), WG, 0, stream>>>((const float4*)acc, (float*)dq,
                                                                   t, l.nq, dx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Device bytes of the backward's workspace for [B * H = bh, T, D]: Q, K, V
// and dO split, [2, bh, T, C] fp32 each (C = copy_columns(D)); Q and dO
// split and transposed, [2, bh, C, T rounded up to 8] each; LSE * log2(e)
// and Di, [bh, nq, 2, 32]; the turn counters, [bh, nq, C / 64] int32 (at
// the Dh-32 instance [bh, nq]); dQ^T's sums, [bh, nq, C / 64, 64 * 32] (at
// the Dh-32 instance [bh, nq, 32 * 32]) in the consumers' register order;
// nq = ceil(T / 32); each region 256-byte aligned.
size_t flash_attention_bwd_f32_workspace(int bh, int t, int d) {
  return layout(bh, t, copy_columns(d)).bytes;
}

// q, k, v, o, d_o: fp32 [B, H, T, D] on the device, last dimension contiguous;
// strides: their element strides {batch, head, token} (15 values), each a
// multiple of 4 (16 bytes), bases 16-byte aligned. lse: contiguous fp32
// [B, H, T]; dq, dk, dv: contiguous fp32 [B, H, T, D]; workspace:
// flash_attention_bwd_f32_workspace bytes, 256-byte aligned. D a multiple
// of 4 up to 1024, run on the instance run_columns(D); `cluster` the blocks
// that split it (1 at the Dh-32 instance, instance / 128 at 128, 256, 512
// and above 512, else instance / 64; anything else is refused). Launches the stats and split passes, the
// kernel and the dQ pass on `stream`; returns the first cudaError_t of the
// launches.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                            const void* d_o, const void* lse, void* dq, void* dk, void* dv,
                            void* workspace, int b, int h, int t, int d, int cluster,
                            const int64_t* strides, float sm_scale, void* stream) {
  const int run = run_columns(d);
  if (d % 4 != 0 || d > 1024 || d <= 0 || t <= 0 || b <= 0 || h <= 0 || b * h > 65535 ||
      cluster != run / block_columns(run))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
#define BWD(D, DL)                                                                           \
  case D:                                                                                    \
    return launch<DL, D / DL>(q, k, v, o, d_o, l, dq, dk, dv, workspace, b, h, t, d, strides, \
                              sm_scale, s)
  if (run == 32)
    return launch_small(q, k, v, o, d_o, l, dq, dk, dv, workspace, b, h, t, d, strides, sm_scale,
                        s);
  switch (run) {
    BWD(64, 64); BWD(128, 128); BWD(192, 64); BWD(256, 128);
    BWD(320, 64); BWD(384, 64); BWD(448, 64); BWD(512, 128);
    BWD(640, 128); BWD(768, 128); BWD(896, 128); BWD(1024, 128);
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}

// Clusters of the instance that runs head dimension d (512 < d <= 1024, a
// cluster of d / 128 rounded up) that the device holds at once
// (cudaOccupancyMaxActiveClusters at one block an SM), or a negative
// cudaError_t.
int flash_attention_bwd_f32_max_active_clusters(int d) {
#define CLUSTER(D) \
  case D: return max_active_clusters(flash_bwd_f32<128, D / 128>, THREADS, D / 128, Bwd<128>::SMEM)
  switch ((d + 127) / 128 * 128) { CLUSTER(640); CLUSTER(768); CLUSTER(896); CLUSTER(1024); }
#undef CLUSTER
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
