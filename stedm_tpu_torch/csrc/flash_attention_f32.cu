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
// against 16 T Dh bytes. They must keep fp32 accuracy, so each runs as three
// TF32 wgmma products (3xTF32, wgmma_tf32.cuh); the least time is 3 x 4 T^2
// Dh over the TF32 peak.
//
// Design:
//   * a split pass (wgmma_tf32.cuh: split_tf32) writes Q and K as their TF32
//     hi and lo halves, [2, B*H, T, D], and V transposed, [2, B*H, D, T'],
//     its keys in the order pi of each group of 8, so that P goes from S's
//     accumulator into the A operand of P V as it is; the workspace holds
//     them (flash_attention_f32_workspace);
//   * the head dimension is split across a thread-block cluster of CL =
//     Dh / DL blocks (DL = 128 columns at Dh 128, 256, 512 and the
//     instances above 512, 640 to 1024 in clusters of 5 to 8, else 64):
//     Q, one K tile and one V tile of 64 keys as hi and lo take 192 KB at
//     128 columns, and O of 64 rows 64 registers a thread. Rank r holds
//     columns r DL .. r DL + DL - 1 of Q and O; each rank computes its
//     partial S = Q K^T over its columns, and the ranks sum the partials
//     through distributed shared memory in rank order, so every rank has the
//     same bits of S (and of the softmax, which each computes). From
//     clusters of 4 the sum is a reduce-scatter and a gather, as in the
//     bf16 forward's cluster kernel (flash_attention.cu): each rank sums
//     1/CL of the partials over the cluster, its own term from its
//     registers, writes the sums over its own partials, and every thread
//     reads its sums back from their owners, 28 KB of other blocks' shared
//     memory a rank a 64-key tile at Dh 1024, where every rank summing
//     every partial read 112 KB; tile j's partials are posted two tiles
//     ahead of its softmax, reduced one ahead and gathered after the P V
//     of the tile before (two exchange buffers a consumer, 8 KB each: the
//     ring takes the rest of the shared memory), so each round trip runs
//     under a tile's softmax and P V. In clusters of 2 and 3 (Dh 256 and
//     the Dh-192 instance) every rank still sums every partial, posted one
//     tile ahead, which measured faster there
//     (tools/torch_flash_f32_variants.py). After a named barrier of the
//     warpgroup, lane r of its first warp signals rank r's barrier
//     (signal_ranks);
//   * a block owns 64 query rows and is three warpgroups: a producer, one
//     thread of which loads Q once and then streams 64-key tiles of K and
//     V^T as 64 x 64 items (hi and lo, 32 KB) through a ring of four slots
//     with full/empty mbarriers, TMA from 4-D tensor maps over the split
//     copies, so the next tile's K loads while this tile's softmax and P V
//     run (with the reduce-scatter, K and V^T have rings of two slots and a
//     thread each, so that S of tile i + 2 loads and runs before tile i's P V
//     frees V^T's slots: one thread loading both in turn kept K behind V^T's
//     slot); and two consumers under setmaxnreg, consumer c taking keys 32 c
//     .. 32 c + 31 of every tile with a running max, sum and O of its own
//     (split-K within the block: their wgmma streams and exchanges overlap),
//     the two combined through shared memory at the end;
//   * the tensor cores truncate as they accumulate (measured on mma.sync
//     and on wgmma: tools/torch_flash_f32_variants.py), so no wgmma chain
//     into one accumulator is longer than 4 k-steps (12 wgmma): S's chains
//     over 32 columns each go to two fresh
//     accumulators in turn, each added to the fp32 sum in registers with one
//     rounding to nearest while the next chain runs; a tile's P V over a
//     consumer's 32 keys is one chain, and O = O * alpha + P V is one fused
//     multiply-add an element;
//   * the softmax runs on exp2 with the scale folded into one fused
//     multiply-add an element; keys >= T are masked to -inf in the last tile
//     only; rows >= T are not stored;
//   * a head dimension above 32 that is not a multiple of 64 (a multiple
//     of 4: 48, 96, 160, ...) runs the instantiation of the next multiple
//     of 64 (above 512: of 128; run_columns): the split pass writes copies
//     of that width whose columns past the head dimension are zeros (they
//     add nothing to S, and O gets zero columns there), and only O's real
//     columns are stored; the chains keep their 4-k-step cap.
// S is m64n32k8 (64 rows x a consumer's 32 keys), P V m64n64k8 (one
// accumulator per 64 columns of O, one V^T item each).
//
// Head dimensions 4 to 32 (num_head_channels 32 and 16) run an instance of
// their own, flash_fwd_f32_small below (the Dh-64 instance on copies
// zero-padded to 64 columns spent half of every product on zeros, wrote
// twice the split bytes, and at T 256 paid a block's prologue and its two
// consumers' combine every 4 key tiles):
//   * the split copies have the head dimension's own columns; the tensor
//     maps declare them, and TMA fills the rest of each 32-column box (one
//     128-byte row of the swizzle) with zeros, which add nothing to S;
//   * a work item is 128 query rows of one head, and the two consumers
//     take 64 rows each of every 64-key tile (no split-K, so no combine at
//     the end): S = Q K^T is one m64n64k8 chain of 4 k-steps, inside the
//     cap, and P V two m64n32k8 chains of 4 k-steps (keys 0..31, 32..63)
//     into O's 16 registers a thread;
//   * the grid is persistent, one block an SM walking the work items
//     (head-major, so a head's two or more query tiles run side by side
//     and share K and V^T in the L2): the producer loads the next item's Q
//     into the second of two Q slots and its first K and V^T tiles into an
//     eight-slot ring (16 KB items) while the consumers finish this one, so
//     the prologue is paid once an SM;
//   * O and the LSE follow the same softmax as above, but each row's max
//     and sum run over all 64 keys of a tile where the Dh-64 instance kept
//     one per 32-key half and combined them at the end, so O and the LSE
//     differ from that route in the last bits (tools/torch_flash_f32_variants.py
//     `padded` runs it and compares).
// On the H100 it runs at 3-6x its 3xTF32 bound (T 1024 and 256); the
// per-score work is at most 13 % of it, the split pass half of it at T 256
// and a quarter at T 1024 (tools/torch_flash_f32_variants.py --variant
// noexp, nosplit, nocopy).

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
constexpr int BM = 64, BK = 64;            // query rows a block, keys a tile
constexpr int SUBB = 64 * 128;             // a 64-row x 32-column sub-tile
constexpr int ITEM = 4 * SUBB;             // a 64 x 64 item: hi, then lo (2 sub-tiles each)
constexpr int ITEM_PART = 2 * SUBB;
constexpr int NSLOT = 4;
constexpr int XCH_BYTES = 4 * WG * 16;     // a consumer's S partials, [4 float4][128 threads]

template <int DL, int CL>
struct Fwd {
  static constexpr int NC = DL / 64;                 // 64-column items a tile of K or V^T
  static constexpr int Q_PART = BM * DL * 4;
  static constexpr int RING_OFF = 2 * Q_PART;
  static constexpr int XCH_OFF = RING_OFF + NSLOT * ITEM;
  static constexpr int BAR_OFF = XCH_OFF + 4 * XCH_BYTES;   // [consumer][buffer]
  // the S partials reduce-scattered from clusters of 4 (at 2, every rank
  // summing every partial measured faster: tools/torch_flash_f32_variants.py)
  static constexpr bool SCATTER = CL >= 4;
  static constexpr int RS = SCATTER ? NSLOT / 2 : NSLOT;   // slots a ring
  static constexpr int SMEM = BAR_OFF + 8 * (9 + 2 * NSLOT) + 1024;   // + alignment slack
  static_assert(SMEM <= 232448, "shared memory");
  // the end: a consumer's running max and sum ([2][128]) and the half of O
  // the other consumer combines ([NC * 16][128]), over the ring
  static_assert(2 * (4 * WG + NC * 16 * WG) * 4 <= NSLOT * ITEM, "the combine's buffers");
  // K item c (kind 0) or V^T item c (kind 1) of tile i: its place in the
  // order its ring is loaded in, and its slot. One ring takes the tile's K
  // items, then its V^T items; with the reduce-scatter, K and V^T have
  // rings of their own, loaded by two producer threads, so that K runs two
  // tiles ahead of the softmax while V^T waits for its slot
  __device__ static int seq(int kind, int i, int c) {
    return SCATTER ? NC * i + c : 2 * NC * i + kind * NC + c;
  }
  __device__ static int slot(int kind, int i, int c) {
    return (SCATTER ? kind * RS : 0) + seq(kind, i, c) % RS;
  }
};

struct Params {
  float* o;
  float* lse;                 // [B, H, T] or null
  int64_t o_sb, o_sh, o_st;   // element strides of o
  int t, h;                   // tokens, heads
  int dcols;                  // O's columns: the head dimension (the instance's, or fewer)
  float scale_log2;           // sm_scale * log2(e): the softmax runs on exp2
};

// Consumer CW: keys 32 CW .. 32 CW + 31 of every tile, a running max, sum
// and O of its own, combined with the other consumer's at the end.
template <int DL, int CL, int CW>
__device__ __forceinline__ void fwd_consumer(const Params& p, unsigned char* smem, uint32_t base,
                                             uint32_t bars, int rank, int q0, int bh,
                                             int ntiles) {
  using C = Fwd<DL, CL>;
  constexpr int NC = C::NC, NCH = DL / 32;
  const uint32_t dbase = base & 0x3FFFFu;   // wgmma descriptors' addresses (see the kernel)
  // remote loads in flight when an owner sums a unit: the most that spilled
  // no consumer (ptxas -v: tools/torch_flash_f32_variants.py)
  constexpr int REDUCE_LOADS = CL == 4 ? 1 : 2;
  // tile j's exchange, in this consumer's buffer j % 2: the partials
  // (x_full: written by every rank), then the sums (y_full: written by
  // every rank); with every rank summing every partial, the second
  // barrier says that every rank read them (x_empty)
  auto x_full = [&](int j) { return bars + 8 + 8 * (2 * CW + j % 2); };
  auto y_full = [&](int j) { return bars + 40 + 8 * (2 * CW + j % 2); };
  auto x_empty = y_full;
  auto full = [&](int s) { return bars + 72 + 8 * s; };
  auto empty = [&](int s) { return bars + 72 + 8 * (NSLOT + s); };
  const int col0 = rank * DL;
  const int lt = threadIdx.x % WG, warp = lt / 32, lane = lt % 32;
  const int g = lane >> 2, tg = lane & 3;
  // this thread's slot 0 of tile j's exchange buffer (slot f at + f * WG * 16)
  auto xch = [&](int j) { return base + C::XCH_OFF + (2 * CW + j % 2) * XCH_BYTES + lt * 16; };
  // the rank that sums slot f of this thread: the 4 x 128 (slot, thread)
  // units of a consumer dealt out in order, 512 / CL a rank
  auto owner = [&](int f) { return ((f * WG + lt) * CL) >> 9; };
  auto slot_addr = [&](int kind, int i, int c) {
    return dbase + C::RING_OFF + C::slot(kind, i, c) * ITEM;
  };
  auto wait_item = [&](int kind, int i, int c) {
    mbar_wait(full(C::slot(kind, i, c)), (C::seq(kind, i, c) / C::RS) & 1);
  };
  auto free_item = [&](int kind, int i, int c) { mbar_arrive(empty(C::slot(kind, i, c))); };

  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max (scaled, log2 units) of rows g, g + 8
  float l[2] = {0.f, 0.f};               // this lane's share of the running sum

  // ---- S = Q K^T of tile i for this consumer's 32 keys over the rank's
  // columns: chain ch covers columns 32 ch .. (K item ch / 2 of the tile,
  // sub-tile ch % 2) ----
  auto s_tile = [&](int i, float (&s)[16]) {
    float pa[16], pb[16];
    auto s_chain = [&](int ch, float (&acc)[16]) {
      if (ch % 2 == 0) wait_item(0, i, ch / 2);
      const uint32_t a = dbase + ch * SUBB;
      const uint32_t b = slot_addr(0, i, ch / 2) + (ch % 2) * SUBB + CW * 32 * 128;
      fresh(acc);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss3(acc, a + kk * 32, C::Q_PART, b + kk * 32, ITEM_PART, kk == 0);
      wgmma::commit();
    };
    auto s_fold = [&](int ch, float (&acc)[16]) {
      fence_operand(acc);
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = ch == 0 ? acc[e] : s[e] + acc[e];
      if (ch % 2 == 1) free_item(0, i, ch / 2);
    };
    s_chain(0, pa);
#pragma unroll
    for (int ch = 1; ch < NCH; ++ch) {
      if (ch % 2) s_chain(ch, pb); else s_chain(ch, pa);
      wgmma::wait<1>();
      if (ch % 2) s_fold(ch - 1, pa); else s_fold(ch - 1, pb);
    }
    wgmma::wait<0>();
    s_fold(NCH - 1, pb);
  };
  // ---- the ranks' partials of tile j summed in rank order, a
  // reduce-scatter and a gather through buffer j % 2: post (write the
  // partials of the units other ranks own, one arrival on every rank),
  // reduce (each rank sums the units it owns over the cluster, its own
  // term from its registers, and writes the sums over its own partials,
  // which no other rank reads; one arrival on every rank), gather (each
  // thread reads its sums from their owners). At Dh 1024 a consumer reads
  // 7 KB of other ranks' partials and 7 KB of their sums, so a rank reads 28
  // KB of other blocks' shared memory a 64-key tile, not the 112 KB of
  // every consumer summing every partial itself.
  // Tile j is posted two tiles ahead of its softmax, reduced one ahead and
  // gathered after the P V of the tile before, so each round trip has a
  // tile's work to complete under. No barrier says that a buffer was read:
  // a rank posts tile j after it gathered tile j - 2, which waited for
  // every rank's reduce of j - 2 (its reads of the partials), and reduces
  // tile j after every rank posted j, which each did after it gathered
  // j - 2 (its reads of the sums); for the same reasons no rank arrives a
  // phase ahead ----
  auto post = [&](int j, const float (&x)[16]) {
    unsigned char* at = smem + (xch(j) - base);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (owner(f) == rank) continue;
      *reinterpret_cast<float4*>(at + f * WG * 16) =
          make_float4(x[4 * f], x[4 * f + 1], x[4 * f + 2], x[4 * f + 3]);
    }
    group_sync(1 + CW, WG);
    if (warp == 0) signal_ranks<CL>(x_full(j), lane);
  };
  auto reduce = [&](int j, const float (&x)[16]) {
    mbar_wait_cluster(x_full(j), (j / 2) & 1);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (owner(f) != rank) continue;
      const float4 own = make_float4(x[4 * f], x[4 * f + 1], x[4 * f + 2], x[4 * f + 3]);
      *reinterpret_cast<float4*>(smem + (xch(j) - base) + f * WG * 16) =
          sum_ranks_own<CL, REDUCE_LOADS>(xch(j) + f * WG * 16, rank, own);
    }
    group_sync(1 + CW, WG);
    if (warp == 0) signal_ranks<CL>(y_full(j), lane);
  };
  auto gather = [&](int j, float (&s)[16]) {
    mbar_wait_cluster(y_full(j), (j / 2) & 1);
    float4 v[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) v[f] = ld_cluster_f4(map_rank(xch(j) + f * WG * 16, owner(f)));
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      s[4 * f] = v[f].x;
      s[4 * f + 1] = v[f].y;
      s[4 * f + 2] = v[f].z;
      s[4 * f + 3] = v[f].w;
    }
  };
  // ---- clusters of 2 and 3: every rank sums every partial of tile j,
  // posted before tile j - 1's softmax and P V (post_all: write, one arrival
  // on every rank; collect: wait, sum, release) ----
  auto post_all = [&](int j, const float (&x)[16]) {
    if (j >= 2) mbar_wait_cluster(x_empty(j), ((j - 2) / 2) & 1);
    unsigned char* at = smem + (xch(j) - base);
#pragma unroll
    for (int f = 0; f < 4; ++f)
      *reinterpret_cast<float4*>(at + f * WG * 16) =
          make_float4(x[4 * f], x[4 * f + 1], x[4 * f + 2], x[4 * f + 3]);
    group_sync(1 + CW, WG);
    if (warp == 0) signal_ranks<CL>(x_full(j), lane);
  };
  auto collect = [&](int j, float (&s)[16]) {
    float4 v[4];
    mbar_wait_cluster(x_full(j), (j / 2) & 1);
    sum_ranks<4, CL>(v, xch(j));
    group_sync(1 + CW, WG);
    if (warp == 0) signal_ranks<CL>(x_empty(j), lane);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      s[4 * f] = v[f].x;
      s[4 * f + 1] = v[f].y;
      s[4 * f + 2] = v[f].z;
      s[4 * f + 3] = v[f].w;
    }
  };

  mbar_wait(bars, 0);                    // Q
  // s: tile i's S; x: this rank's partials of tile i + 1 until its reduce
  // (with every rank summing every partial: until they are collected)
  float s[16], x[16];
  s_tile(0, s);
  if constexpr (C::SCATTER) {
    post(0, s);
    if (ntiles > 1) {
      s_tile(1, x);
      post(1, x);
    }
    reduce(0, s);
    gather(0, s);
  } else if constexpr (CL > 1) {
    post_all(0, s);
    collect(0, s);
  }
  for (int i = 0; i < ntiles; ++i) {
    const bool more = i + 1 < ntiles;
    if constexpr (C::SCATTER) {
      if (more) reduce(i + 1, x);
      if (i + 2 < ntiles) {
        s_tile(i + 2, x);
        post(i + 2, x);
      }
    } else if constexpr (CL > 1) {       // (with no exchange, S of the next tile after P V)
      if (more) {
        s_tile(i + 1, x);
        post_all(i + 1, x);
      }
    }

    // ---- the online softmax: keys i BK + 32 CW + 8 j + 2 tg + (e & 1) ----
    const int key0 = i * BK + 32 * CW;
    if (key0 + 32 > p.t) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (key0 + (e / 4) * 8 + 2 * tg + (e & 1) >= p.t) s[e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY}, alpha[2];
#pragma unroll
    for (int e = 0; e < 16; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // consumer 1 may have seen no key yet (T <= 32): its max stays -inf
      // and 0 stands in for it, so that nothing becomes NaN
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * p.scale_log2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_use);    // 0 on the first tile (m = -inf)
      m[r] = m_new;
      l[r] *= alpha[r];
      mx[r] = m_use;
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = (e >> 1) & 1;
      s[e] = exp2f(fmaf(s[e], p.scale_log2, -mx[r]));
      l[r] += s[e];
    }
    // P as the A operand of P V, split: k-step kk holds keys 8 kk + 2 tg, + 1
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(s + 4 * kk, ph[kk], pl[kk]);

    // ---- O = O * alpha + P V: chain c covers O's columns 64 c .. (V^T
    // item c, this consumer's sub-tile of keys) ----
    float qa[32], qb[32];
    auto pv_chain = [&](int c, float (&acc)[32]) {
      wait_item(1, i, c);
      const uint32_t b = slot_addr(1, i, c) + CW * SUBB;
      fresh(acc);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) rs3(acc, ph[kk], pl[kk], b + kk * 32, ITEM_PART, kk == 0);
      wgmma::commit();
    };
    auto pv_fold = [&](int c, float (&acc)[32]) {
      fence_operand(acc);
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = fmaf(o[c][e], alpha[(e >> 1) & 1], acc[e]);
      free_item(1, i, c);
    };
    pv_chain(0, qa);
#pragma unroll
    for (int c = 1; c < NC; ++c) {
      if (c % 2) pv_chain(c, qb); else pv_chain(c, qa);
      wgmma::wait<1>();
      if (c % 2) pv_fold(c - 1, qa); else pv_fold(c - 1, qb);
    }
    wgmma::wait<0>();
    if (NC % 2) pv_fold(NC - 1, qa); else pv_fold(NC - 1, qb);
    if (more) {
      if constexpr (C::SCATTER) {
        gather(i + 1, s);
      } else if constexpr (CL > 1) {
        collect(i + 1, x);
#pragma unroll
        for (int e = 0; e < 16; ++e) s[e] = x[e];
      } else {
        s_tile(i + 1, s);
      }
    }
  }

  // ---- combine the two consumers' softmax states (split-K) and store:
  // consumer CW finishes the flat elements CW * NC * 16 .. of O, the other
  // consumer's share of its O going through the ring's memory ----
  constexpr int HALF = NC * 16;
  float* stat = reinterpret_cast<float*>(smem + C::RING_OFF);          // [2][4][128]
  float* part = stat + 2 * 4 * WG;                                     // [2][HALF][128]
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  group_sync(3, 2 * WG);                 // both consumers are done with the ring's items
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    stat[(CW * 4 + r) * WG + lt] = m[r];
    stat[(CW * 4 + 2 + r) * WG + lt] = l[r];
  }
#pragma unroll
  for (int f = 0; f < HALF; ++f) {       // the elements the other consumer finishes
    constexpr int other = (1 - CW) * HALF;
    part[(CW * HALF + f) * WG + lt] = o[(other + f) / 32][(other + f) % 32];
  }
  group_sync(3, 2 * WG);
  const int b = bh / p.h, h = bh % p.h;
  const int row0 = q0 + warp * 16 + g;
  float sc_me[2], sc_other[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mo = stat[((1 - CW) * 4 + r) * WG + lt];
    const float lo = stat[((1 - CW) * 4 + 2 + r) * WG + lt];
    const float mm = fmaxf(m[r], mo);     // finite: consumer 0 always holds key 0
    sc_me[r] = exp2f(m[r] - mm);
    sc_other[r] = exp2f(mo - mm);
    const float total = l[r] * sc_me[r] + lo * sc_other[r];
    inv[r] = 1.f / total;
    const int row = row0 + 8 * r;
    if (CW == 0 && rank == 0 && p.lse != nullptr && tg == 0 && row < p.t)
      p.lse[(int64_t)bh * p.t + row] = (mm + log2f(total)) * 0.6931471805599453f;
  }
#pragma unroll
  for (int f = 0; f < HALF; f += 2) {
    constexpr int mine = CW * HALF;
    const int c = (mine + f) / 32, e = (mine + f) % 32, r = (e >> 1) & 1;
    const int row = row0 + 8 * r;
    if (row >= p.t || col0 + 64 * c + 8 * (e / 4) + 2 * tg >= p.dcols) continue;
    const float* po = part + ((1 - CW) * HALF + f) * WG + lt;
    const float x0 = fmaf(o[c][e], sc_me[r], po[0] * sc_other[r]);
    const float x1 = fmaf(o[c][e + 1], sc_me[r], po[WG] * sc_other[r]);
    float* out = p.o + b * p.o_sb + h * p.o_sh + row * p.o_st + col0 + 64 * c + 8 * (e / 4) +
                 2 * tg;
    *reinterpret_cast<float2*>(out) = make_float2(x0 * inv[r], x1 * inv[r]);
  }
}

template <int DL, int CL>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_vt, const Params p) {
  using C = Fwd<DL, CL>;
  constexpr int NC = C::NC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  // barriers: Q full, x_full[2][2] and y_full[2][2] (consumer c's
  // partials, then its sums, in buffer u written on every rank),
  // full[NSLOT], empty[NSLOT]
  const uint32_t bars = base + C::BAR_OFF;
  auto full = [&](int s) { return bars + 72 + 8 * s; };
  auto empty = [&](int s) { return bars + 72 + 8 * (NSLOT + s); };

  const int rank = blockIdx.x % CL, q0 = blockIdx.x / CL * BM, bh = blockIdx.y;
  const int col0 = rank * DL;
  const int ntiles = (p.t + BK - 1) / BK;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int x = 0; x < 8; ++x) mbar_init(bars + 8 + 8 * x, CL);   // x_full[2][2], y_full[2][2]
    for (int s = 0; s < NSLOT; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if constexpr (CL > 1)
    cluster_sync_all();   // every rank's barriers are initialised before any remote arrival
  else
    __syncthreads();

  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    // ---- loads: Q once, then K and V^T a 64-column item at a time (kind 0,
    // 1), by thread 0 of the warpgroup; with the reduce-scatter thread 32
    // takes the V^T items, which have a ring of their own (C::slot) ----
    auto load = [&](int kind, int i, int c) {
      const int s = C::slot(kind, i, c);
      const uint32_t dst = base + C::RING_OFF + s * ITEM;
      mbar_wait(empty(s), ((C::seq(kind, i, c) / C::RS) & 1) ^ 1);
      mbar_expect_tx(full(s), ITEM);
      for (int part = 0; part < 2; ++part)
        for (int sub = 0; sub < 2; ++sub) {
          const uint32_t at = dst + part * ITEM_PART + sub * SUBB;
          if (kind == 0)   // K: 64 keys x columns 64 c ..
            tma_load(at, &map_k, full(s), col0 + 64 * c + 32 * sub, i * BK, bh, part);
          else             // V^T: columns 64 c .. x 64 keys
            tma_load(at, &map_vt, full(s), i * BK + 32 * sub, col0 + 64 * c, bh, part);
        }
    };
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(bars, 2 * C::Q_PART);
      for (int part = 0; part < 2; ++part)
        for (int sub = 0; sub < DL / 32; ++sub)
          tma_load(base + part * C::Q_PART + sub * SUBB, &map_q, bars, col0 + 32 * sub, q0, bh,
                   part);
      for (int i = 0; i < ntiles; ++i) {
        for (int c = 0; c < NC; ++c) load(0, i, c);
        if constexpr (!C::SCATTER)
          for (int c = 0; c < NC; ++c) load(1, i, c);
      }
    } else if (C::SCATTER && threadIdx.x == 2 * WG + 32) {
      for (int i = 0; i < ntiles; ++i)
        for (int c = 0; c < NC; ++c) load(1, i, c);
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    if (wg == 0)
      fwd_consumer<DL, CL, 0>(p, smem, base, bars, rank, q0, bh, ntiles);
    else
      fwd_consumer<DL, CL, 1>(p, smem, base, bars, rank, q0, bh, ntiles);
  }
  // no block leaves while another rank may still read its partials or
  // arrive on its barriers
  if constexpr (CL > 1) cluster_sync_all();
}

// ---------------------------------------------------------------------------
// The Dh-32 instance (head dimensions 4 .. 32): persistent blocks, a work
// item 128 query rows of one head, the two consumers 64 rows each.
// ---------------------------------------------------------------------------

namespace dh32 {
constexpr int BM = 128;                    // query rows a work item
constexpr int Q_PART = BM * 128;           // Q's hi or lo: 128 rows x 32 columns
constexpr int KV_PART = 64 * 128;          // a K tile's (64 keys) or V^T tile's (32 x 64) hi or lo
constexpr int KV_ITEM = 2 * KV_PART;       // hi, then lo
constexpr int VSUB = 32 * 128;             // V^T's sub-tile of 32 keys
constexpr int NSLOT = 8;
constexpr int RING_OFF = 4 * Q_PART;       // after two Q slots (hi, lo each)
constexpr int BAR_OFF = RING_OFF + NSLOT * KV_ITEM;
constexpr int SMEM = BAR_OFF + 8 * (4 + 2 * NSLOT) + 1024;   // + alignment slack
static_assert(SMEM <= 232448, "shared memory");
}  // namespace dh32

// Consumer CW: rows 64 CW .. 64 CW + 63 of every work item of this block.
// Work item n of the block (w = blockIdx.x + n gridDim.x: head w / nqt,
// query tile w % nqt) has its Q in slot n % 2 and its tile i's K and V^T at
// ring positions 2 (n ntiles + i) and 2 (n ntiles + i) + 1.
template <int CW>
__device__ __forceinline__ void small_consumer(const Params& p, uint32_t base, uint32_t bars,
                                               int items, int nqt, int ntiles) {
  using dh32::BM, dh32::Q_PART, dh32::KV_PART, dh32::KV_ITEM, dh32::VSUB, dh32::NSLOT, dh32::RING_OFF;
  const uint32_t dbase = base & 0x3FFFFu;
  auto q_full = [&](int u) { return bars + 8 * u; };
  auto q_empty = [&](int u) { return bars + 16 + 8 * u; };
  auto full = [&](int s) { return bars + 32 + 8 * s; };
  auto empty = [&](int s) { return bars + 32 + 8 * (NSLOT + s); };
  const int lt = threadIdx.x % WG, warp = lt / 32, lane = lt % 32;
  const int g = lane >> 2, tg = lane & 3;
  int n = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
    const int bh = w / nqt, q0 = (w % nqt) * BM, qs = n % 2;
    float o[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // running max (scaled, log2 units) of rows g, g + 8
    float l[2] = {0.f, 0.f};               // this lane's share of the running sum
    const uint32_t qa = dbase + 2 * qs * Q_PART + CW * 64 * 128;
    mbar_wait(q_full(qs), (n / 2) & 1);
    for (int i = 0; i < ntiles; ++i) {
      const int seq = 2 * (n * ntiles + i), sk = seq % NSLOT, sv = (seq + 1) % NSLOT;
      // ---- S = Q K^T over the 32 columns: one chain of 4 k-steps ----
      float s[32];
      mbar_wait(full(sk), (seq / NSLOT) & 1);
      const uint32_t kb = dbase + RING_OFF + sk * KV_ITEM;
      fresh(s);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ss3(s, qa + kk * 32, Q_PART, kb + kk * 32, KV_PART, kk == 0);
      wgmma::commit();
      wgmma::wait<0>();
      fence_operand(s);
      mbar_arrive(empty(sk));
      if (i == ntiles - 1) mbar_arrive(q_empty(qs));   // Q read for the last time

      // ---- the online softmax: element e holds key i BK + 8 (e / 4) + 2 tg +
      // (e & 1) of row g + 8 ((e >> 1) & 1); tile i's first key is < T, so
      // every row's max is finite ----
      const int key0 = i * BK;
      if (key0 + BK > p.t) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (key0 + (e / 4) * 8 + 2 * tg + (e & 1) >= p.t) s[e] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY}, alpha[2];
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]) * p.scale_log2);
        alpha[r] = exp2f(m[r] - m_new);    // 0 on the first tile (m = -inf)
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        s[e] = exp2f(fmaf(s[e], p.scale_log2, -m[r]));
        l[r] += s[e];
      }
      // P as the A operand of P V, split: k-step kk holds keys 8 kk + 2 tg, + 1
      uint32_t ph[8][4], pl[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) acc_to_a(s + 4 * kk, ph[kk], pl[kk]);

      // ---- O = O * alpha + P V: a chain a 32-key sub-tile of V^T ----
      float pa[16], pb[16];
      mbar_wait(full(sv), ((seq + 1) / NSLOT) & 1);
      const uint32_t vb = dbase + RING_OFF + sv * KV_ITEM;
      fresh(pa);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) rs3(pa, ph[kk], pl[kk], vb + kk * 32, KV_PART, kk == 0);
      wgmma::commit();
      fresh(pb);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        rs3(pb, ph[4 + kk], pl[4 + kk], vb + VSUB + kk * 32, KV_PART, kk == 0);
      wgmma::commit();
      wgmma::wait<1>();
      fence_operand(pa);
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = fmaf(o[e], alpha[(e >> 1) & 1], pa[e]);
      wgmma::wait<0>();
      fence_frags(ph);
      fence_frags(pl);
      fence_operand(pb);
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] += pb[e];
      mbar_arrive(empty(sv));
    }

    // ---- this consumer's 64 rows of O (rows >= T and columns >= dcols not
    // stored) and their LSE ----
    const int b = bh / p.h, h = bh % p.h;
    const int row0 = q0 + CW * 64 + warp * 16 + g;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float total = quad_sum(l[r]);
      inv[r] = 1.f / total;
      const int row = row0 + 8 * r;
      if (p.lse != nullptr && tg == 0 && row < p.t)
        p.lse[(int64_t)bh * p.t + row] = (m[r] + log2f(total)) * 0.6931471805599453f;
    }
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      const int r = (e >> 1) & 1, row = row0 + 8 * r, col = 8 * (e / 4) + 2 * tg;
      if (row >= p.t || col >= p.dcols) continue;
      float* out = p.o + b * p.o_sb + h * p.o_sh + row * p.o_st + col;
      *reinterpret_cast<float2*>(out) = make_float2(o[e] * inv[r], o[e + 1] * inv[r]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_small(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_vt, const Params p, int bh_total) {
  using dh32::BM, dh32::Q_PART, dh32::KV_PART, dh32::KV_ITEM, dh32::VSUB, dh32::NSLOT, dh32::RING_OFF, dh32::BAR_OFF;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // barriers: q_full[2], q_empty[2] (Q's two slots), full[NSLOT], empty[NSLOT]
  const uint32_t bars = base + BAR_OFF;
  auto q_full = [&](int u) { return bars + 8 * u; };
  auto q_empty = [&](int u) { return bars + 16 + 8 * u; };
  auto full = [&](int s) { return bars + 32 + 8 * s; };
  auto empty = [&](int s) { return bars + 32 + 8 * (NSLOT + s); };
  const int nqt = (p.t + BM - 1) / BM, items = bh_total * nqt, ntiles = (p.t + BK - 1) / BK;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int u = 0; u < 2; ++u) {
      mbar_init(q_full(u), 1);
      mbar_init(q_empty(u), 2 * WG);
    }
    for (int s = 0; s < NSLOT; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x != 2 * WG) return;
    // ---- loads, by one thread: each work item's Q (128 rows, hi and lo),
    // then its K and V^T tiles in turn through the ring ----
    int n = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
      const int bh = w / nqt, q0 = (w % nqt) * BM, qs = n % 2;
      mbar_wait(q_empty(qs), ((n / 2) & 1) ^ 1);
      mbar_expect_tx(q_full(qs), 2 * Q_PART);
      for (int part = 0; part < 2; ++part)
        tma_load(base + (2 * qs + part) * Q_PART, &map_q, q_full(qs), 0, q0, bh, part);
      for (int i = 0; i < ntiles; ++i)
        for (int kind = 0; kind < 2; ++kind) {
          const int seq = 2 * (n * ntiles + i) + kind, s = seq % NSLOT;
          const uint32_t dst = base + RING_OFF + s * KV_ITEM;
          mbar_wait(empty(s), ((seq / NSLOT) & 1) ^ 1);
          mbar_expect_tx(full(s), KV_ITEM);
          for (int part = 0; part < 2; ++part) {
            if (kind == 0)   // K: 64 keys x 32 columns
              tma_load(dst + part * KV_PART, &map_k, full(s), 0, i * BK, bh, part);
            else             // V^T: 32 columns x 64 keys, two sub-tiles of 32 keys
              for (int sub = 0; sub < 2; ++sub)
                tma_load(dst + part * KV_PART + sub * VSUB, &map_vt, full(s), i * BK + 32 * sub,
                         0, bh, part);
          }
        }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    if (wg == 0)
      small_consumer<0>(p, base, bars, items, nqt, ntiles);
    else
      small_consumer<1>(p, base, bars, items, nqt, ntiles);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Layout {
  size_t q_off, k_off, vt_off, bytes;
  int tp;
};

Layout layout(int bh, int t, int d) {
  Layout l;
  l.tp = (t + 7) / 8 * 8;
  const size_t nat = align256((size_t)2 * bh * t * d * 4);
  l.q_off = 0;
  l.k_off = nat;
  l.vt_off = 2 * nat;
  l.bytes = 2 * nat + align256((size_t)2 * bh * d * l.tp * 4);
  return l;
}

// The split pass over q, k and v into the workspace: Q and K as they are,
// V transposed in the order pi; copies of `d` columns, the inputs' `dx`.
cudaError_t split_inputs(const void* q, const void* k, const void* v, const Layout& l, int bh,
                         int h, int t, int d, int dx, const int64_t* s, unsigned char* ws,
                         cudaStream_t stream) {
  SplitParams sp = {};
  sp.job[0] = {(const float*)q, s[0], s[1], s[2], (float*)(ws + l.q_off), nullptr, 0};
  sp.job[1] = {(const float*)k, s[3], s[4], s[5], (float*)(ws + l.k_off), nullptr, 0};
  sp.job[2] = {(const float*)v, s[6], s[7], s[8], nullptr, (float*)(ws + l.vt_off), 1};
  sp.njobs = 3;
  sp.h = h;
  sp.t = t;
  sp.d = d;
  sp.dx = dx;
  sp.tp = l.tp;
  sp.bh = bh;
  return launch_split(sp, stream);
}

// The Dh-32 instance: copies of the head dimension's own d columns, one
// block an SM over the work items.
int launch_small(const void* q, const void* k, const void* v, const Params& p, int b, int d,
                 const int64_t* s, unsigned char* ws, cudaStream_t stream) {
  // set before every launch (see launch below)
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_small,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dh32::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int bh = b * p.h;
  const Layout l = layout(bh, p.t, d);
  err = split_inputs(q, k, v, l, bh, p.h, p.t, d, d, s, ws, stream);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_q, map_k, map_vt;
  if (!make_split_map(&map_q, (float*)(ws + l.q_off), bh, p.t, d, dh32::BM) ||
      !make_split_map(&map_k, (float*)(ws + l.k_off), bh, p.t, d, BK) ||
      !make_split_map(&map_vt, (float*)(ws + l.vt_off), bh, d, l.tp, 32))
    return (int)cudaErrorInvalidValue;
  const int items = bh * ((p.t + dh32::BM - 1) / dh32::BM);
  const int grid = items < sm_count() ? items : sm_count();
  flash_fwd_f32_small<<<grid, THREADS, dh32::SMEM, stream>>>(map_q, map_k, map_vt, p, bh);
  return (int)cudaGetLastError();
}

template <int DL, int CL>
int launch(const void* q, const void* k, const void* v, const Params& p, int b, int d,
           const int64_t* s, unsigned char* ws, cudaStream_t stream) {
  using C = Fwd<DL, CL>;
  // set before every launch, so that a launch from another host thread
  // (autograd's worker, when a checkpointed block recomputes) sees it
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<DL, CL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int bh = b * p.h, dx = d;
  d = run_columns(d);
  const Layout l = layout(bh, p.t, d);
  float* qs = (float*)(ws + l.q_off);
  float* ks = (float*)(ws + l.k_off);
  float* vt = (float*)(ws + l.vt_off);
  err = split_inputs(q, k, v, l, bh, p.h, p.t, d, dx, s, ws, stream);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_q, map_k, map_vt;
  if (!make_split_map(&map_q, qs, bh, p.t, d, BM) || !make_split_map(&map_k, ks, bh, p.t, d, BK) ||
      !make_split_map(&map_vt, vt, bh, d, l.tp, 64))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_launch(&attr, 0, THREADS, CL, C::SMEM, stream);
  cfg.gridDim = dim3((p.t + BM - 1) / BM * CL, bh);
  return (int)cudaLaunchKernelEx(&cfg, flash_fwd_f32<DL, CL>, map_q, map_k, map_vt, p);
}

}  // namespace

extern "C" {

// Device bytes of the forward's workspace for [B * H = bh, T, D]: Q and K
// split, [2, bh, T, C] fp32 each, and V split and transposed, [2, bh, C, T
// rounded up to 8], C = copy_columns(D), each region 256-byte aligned.
size_t flash_attention_f32_workspace(int bh, int t, int d) {
  return layout(bh, t, copy_columns(d)).bytes;
}

// q, k, v, o: fp32 [B, H, T, D] on the device, last dimension contiguous;
// strides: the element strides {batch, head, token} of q, k, v and o (12
// values). D a multiple of 4 up to 1024, run on the instance run_columns(D);
// `cluster` the blocks that split it, 1 at the Dh-32 instance, instance /
// 128 at 128, 256, 512 and above 512 (clusters of 5 to 8), else instance /
// 64 (the wrapper's plan; anything else is refused). lse:
// contiguous fp32 [B, H, T], or null when the caller needs no LSE.
// workspace: flash_attention_f32_workspace bytes, 256-byte aligned.
// Launches the split pass and the kernel on `stream`; returns the
// cudaError_t of the launches.
int flash_attention_f32_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            void* workspace, int b, int h, int t, int d, int cluster,
                            const int64_t* strides, float sm_scale, void* stream) {
  const int run = run_columns(d);
  if (d % 4 != 0 || d > 1024 || d <= 0 || t <= 0 || b <= 0 || h <= 0 || b * h > 65535 ||
      cluster != run / block_columns(run))
    return (int)cudaErrorInvalidValue;
  const Params p = {(float*)o, (float*)lse, strides[9], strides[10], strides[11], t, h, d,
                    sm_scale * 1.4426950408889634f};
  cudaStream_t s = (cudaStream_t)stream;
  unsigned char* ws = (unsigned char*)workspace;
#define FWD(D, DL) \
  case D: return launch<DL, D / DL>(q, k, v, p, b, d, strides, ws, s)
  if (run == 32) return launch_small(q, k, v, p, b, d, strides, ws, s);
  switch (run) {
    FWD(64, 64); FWD(128, 128); FWD(192, 64); FWD(256, 128);
    FWD(320, 64); FWD(384, 64); FWD(448, 64); FWD(512, 128);
    FWD(640, 128); FWD(768, 128); FWD(896, 128); FWD(1024, 128);
  }
#undef FWD
  return (int)cudaErrorInvalidValue;
}

// Clusters of the instance that runs head dimension d (512 < d <= 1024, a
// cluster of d / 128 rounded up) that the device holds at once
// (cudaOccupancyMaxActiveClusters at one block an SM), or a negative
// cudaError_t.
int flash_attention_f32_max_active_clusters(int d) {
#define CLUSTER(D)                                                                  \
  case D:                                                                           \
    return max_active_clusters(flash_fwd_f32<128, D / 128>, THREADS, D / 128,       \
                               Fwd<128, D / 128>::SMEM)
  switch ((d + 127) / 128 * 128) { CLUSTER(640); CLUSTER(768); CLUSTER(896); CLUSTER(1024); }
#undef CLUSTER
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
