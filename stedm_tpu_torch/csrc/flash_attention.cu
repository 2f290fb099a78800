// Flash-attention forward (non-causal) for Hopper, bf16 in and out.
//
// Replaces the stock Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention, which the
// JAX package calls from stedm_tpu/ops/blocked_attention.py:flash_sdpa (the
// U-Net bottleneck AttentionBlock: [2B, 8, 256, 128] when sampling at 256^2,
// [B, 8, 1024, 128] when training at 512^2) and from
// stedm_tpu/models/vq.py:AttnBlockVQ (the VQ mid-blocks: [B, 1, 4096, 512]
// and [B, 1, 16384, 512]). Computes O = softmax(Q K^T * sm_scale) V with fp32
// logits and an fp32 running max and sum per query row; P is rounded to bf16
// before P V, as the stock kernel and the reference's exact path do. Key
// positions past T are masked, so T need not be a multiple of the tile. When
// asked, it also writes the fp32 log-sum-exp of each query row (natural log
// of sum_j exp(s_ij * sm_scale)), which the backward
// (csrc/flash_attention_bwd.cu) uses to rebuild P.
//
// What bounds it on the H100. At Dh 512 the two matrix products: 4 T^2 Dh
// operations a head against 8 T Dh bytes, far above the card's ~295
// operations a byte, so the tensor cores are the limit, and they reach their
// rate only through wgmma. A 64-row query tile is all the registers allow
// there (its fp32 O is 128 KB), and Q, one K tile and one V tile of 64 keys
// already fill the shared memory, so the products of one tile cannot overlap
// the softmax of the next: the kernel runs at about half the peak, with the
// loads hidden. At T = 256 and Dh 128 a call moves 33.5 MB and runs 17
// GFLOP: bytes, the launch, and the latency of a load-compute-store chain;
// at T = 1024 the products again, with the softmax's exponentials to hide.
//
// Design:
//   * a block is three warpgroups: two consumers that run wgmma and one
//     producer, one thread of which starts the TMA loads; setmaxnreg moves
//     the producer's registers to the consumers (24 and 240 a thread), which
//     the 128 fp32 O values a thread at Dh 256 and 512 need;
//   * q, k, v are read through 4-D tensor maps {Dh, T, H, B} built from the
//     tensors' strides, so any batch, head and token stride is taken as it
//     is; a tile lands in shared memory as 64-column sub-tiles in the
//     128-byte swizzle that the wgmma descriptors read; rows past T arrive as
//     zeros; full/empty mbarriers hand the tiles back and forth;
//   * S = Q K^T: Q (A) and the K tile (B, K-major) from shared memory; O += P
//     V: the V tile [keys, Dh] as an MN-major B, so V is never transposed;
//   * Dh <= 256 (flash_fwd_small): each consumer warpgroup owns 64 query rows
//     of a 128-row tile and the whole O of them in registers; P goes from
//     S's registers into the A operand of P V. K and V tiles go through
//     rings of two stages (three at Dh 64, six at Dh 32) shared by both
//     warpgroups, so K and V are read once per 128 rows; a K slot is freed
//     as soon as its Q K^T has landed, a V slot after its P V. Inside a
//     warpgroup Q K^T of tile i + 1 is started before P V of tile i and the
//     softmax of tile i + 1 runs under that P V; the two warpgroups take
//     turns at starting (named barriers), so one's softmax runs under the
//     other's products. The kernel is persistent, one block an SM walking
//     over (head, query tile) items, with a second Q buffer where it fits:
//     the producer loads the next item's Q, K and V while this item's last
//     products and its epilogue run;
//   * 256 < Dh <= 512 (flash_fwd_wide): the two consumers share one 64-row query tile,
//     each owning half of O's columns. S is computed once: each takes half
//     of the key tile's columns over the full Dh, the row maxima are
//     combined through shared memory, and P (bf16, 64 x 64, 8 KB) goes
//     through shared memory as the A operand of both warpgroups' P V. Q, one
//     K tile, one V tile and P fill the 227 KB, so instead of whole stages
//     the K tile and the two V halves are released separately: K for tile
//     i + 1 loads while the softmax and P V of tile i run, each V half while
//     Q K^T of the next tile runs. Each consumer's 32 m64n32k16 of a tile
//     go to two accumulators in turn: a chain on one accumulator runs at the
//     wgmma's latency, not its rate.
//     A 2-block cluster (one O half a block, K multicast, S exchanged
//     through distributed shared memory) is the other way to one Q K^T; two
//     warpgroups of one block were taken because their exchange needs only
//     named barriers and the block's own shared memory;
//   * Dh > 512 (flash_fwd_cluster, the instances 640, 768, 896 and 1024:
//     the landscape U-Net at num_heads 1, [2B, 1, 256, 1024] sampling and
//     [B, 1, 1024, 1024] training at 512^2, and a codec whose mid-block is
//     1024 wide, [B, 1, 4096, 1024] and [B, 1, 16384, 1024]): Q of 64 rows
//     over 1024 columns alone is 128 KB, so no block holds a whole row of
//     Q and K. The head dimension is split across a thread-block cluster
//     of Dh / 128 blocks (5 to 8, the portable maximum), each holding its
//     128 columns of Q, K, V and O, the design of the fp32 forward
//     (flash_attention_f32.cu) on bf16 operands: each consumer computes its
//     32 keys' partial S over the rank's columns, the ranks sum the
//     partials in rank order through distributed shared memory, so every
//     rank has the same bits of S and makes the same softmax, P goes from
//     the sums' registers into the A operand of P V over the rank's
//     columns, and the two key-split consumers combine their softmax
//     states through shared memory at the end. The sum is a reduce-scatter
//     and a gather: each rank sums an eighth of the elements over the
//     cluster and every thread reads its sums back from their owners, 28 KB
//     of other blocks' shared memory a 64-key tile at Dh 1024. Every rank
//     summing every partial read 112 KB a tile and took 49.5 ms at [2, 1,
//     16384, 1024], 6.4 of it without the exchange (NVIDIA H100 80GB HBM3,
//     700 W): DSMEM's rate, not the products, bounds this kernel. A tile's
//     partials are posted three tiles ahead of its softmax, reduced two
//     ahead and gathered one ahead, so each round trip runs under a tile's
//     work, and two producer threads load K and V, so that K runs three
//     tiles ahead while V waits for its slot (one thread loading both kept
//     K behind V's slot: 27.9 ms against 20.7);
//   * the softmax runs on exp2 with the scale folded into one fused
//     multiply-add an element; keys >= T are masked to -inf in the last tile
//     only; rows >= T are not stored;
//   * Dh 32 (the U-Net's AttentionBlock at num_head_channels 32: [2B, 32,
//     256, 32] sampling at 256^2, [B, 32, 1024, 32] training at 512^2): a
//     row is 64 bytes, half the 128-byte swizzle row, so flash_fwd_small<32>
//     keeps its tiles as 32-column sub-tiles in the 64-byte swizzle (the
//     tensor maps' boxes and every wgmma descriptor, descriptor<64>): Q K^T
//     is two k-steps of 32 bytes within the row, P V one m64n32k16 a key
//     step. A K or V tile is 8 KB, so the ring holds six stages, not
//     three;
//   * any other head dimension that is a multiple of 8 (16-byte rows) runs
//     on the smallest instance at or above it (Dh 16 on flash_fwd_small<32>,
//     96 on <128>, 160 on <192>, 264 on flash_fwd_wide<320>, 520 and 576
//     on flash_fwd_cluster<640>, where rank 4 holds 8 real columns or
//     none): the tensor
//     maps declare the true columns, so TMA fills the rest of every box with
//     zeros, which add nothing to S and give O zero columns, and O's columns
//     past the head dimension are not stored. The wrapper copies a head
//     dimension whose rows are not 16 bytes apart into zero-padded tensors
//     first (ops/blocked_attention.py: head_dim_plan).

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

struct Params {
  bf16* o;
  float* lse;             // [B, H, T] or null
  int64_t o_sb, o_sh, o_st;  // element strides of o (last dimension contiguous)
  int t, h, nbh;          // tokens, heads, batch * heads
  int dcols;              // the head dimension of q, k, v and o: the instance's, or fewer
  float scale_log2;       // sm_scale * log2(e): the softmax runs on exp2
};

// Masks the keys >= t of a tile (columns key0 + 8 j + 2 tg + (e & 1)) and
// returns this lane's row maxima of the raw logits, reduced over its quad.
template <int NREG>
__device__ __forceinline__ void mask_and_max(float (&s)[NREG], int key0, int t, int tg,
                                             bool ragged, float (&mx)[2]) {
  if (ragged) {
#pragma unroll
    for (int i = 0; i < NREG; ++i)
      if (key0 + (i / 4) * 8 + 2 * tg + (i & 1) >= t) s[i] = -INFINITY;
  }
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int i = 0; i < NREG; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
}

// s <- exp2(s * scale - m_new) and the running sum; mx holds the tile's raw
// row maxima. alpha = exp2(m_old - m_new) is what the O accumulator has to be
// rescaled by (`rescale`) before this tile's P V is added to it.
template <int NREG>
__device__ __forceinline__ void softmax_scores(float (&s)[NREG], const float (&mx)[2],
                                               float (&m)[2], float (&l)[2], float (&alpha)[2],
                                               float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = exp2f(m[r] - m_new);  // 0 on the first tile (m = -inf)
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < NREG; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2f(fmaf(s[i], scale_log2, -m[r]));
    l[r] += s[i];
  }
}

template <int OREG>
__device__ __forceinline__ void rescale(float (&o)[OREG], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < OREG; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// Rows row0 + {0, 8} of this lane, columns col0 + 8 j + 2 tg + {0, 1}; the
// columns at or past dcols (zeros of a narrower head dimension) are not
// stored.
template <int OREG>
__device__ __forceinline__ void store_rows(const Params& p, const float (&o)[OREG],
                                           const float (&inv)[2], int b, int h, int row0,
                                           int col0, int tg) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.t) continue;
    bf16* out = p.o + b * p.o_sb + h * p.o_sh + row * p.o_st + col0 + 2 * tg;
#pragma unroll
    for (int j = 0; j < OREG / 4; ++j) {
      if (col0 + 8 * j >= p.dcols) break;
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_bf16x2(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Dh <= 256: 128 query rows an item, 64 a consumer warpgroup, O whole in
// registers, P from registers, rings of K and V tiles, persistent blocks.
// ---------------------------------------------------------------------------

template <int D>
struct Small {
  static constexpr int CL = 1;                             // a plain launch
  static constexpr int BM = 128;
  static constexpr int BK = D <= 128 ? 128 : 64;
  // sub-tiles of SC columns, rows of RB bytes: 64 columns in the 128-byte
  // swizzle, or at Dh 32 all 32 in the 64-byte one
  static constexpr int RB = D == 32 ? 64 : ROW_BYTES;
  static constexpr int SC = RB / 2;
  static constexpr int NSUB = D / SC;
  static constexpr int Q_BYTES = NSUB * BM * RB;
  static constexpr int KV_BYTES = NSUB * BK * RB;          // one K or one V tile
  static constexpr int BUDGET = 224 * 1024;
  // a second Q buffer where two K/V stages still fit beside it, then stages
  static constexpr int QBUF = 2 * Q_BYTES + 4 * KV_BYTES <= BUDGET ? 2 : 1;
  static constexpr int FIT = (BUDGET - QBUF * Q_BYTES) / (2 * KV_BYTES);
  static constexpr int MAX_STAGES = D == 32 ? 6 : 3;
  static constexpr int STAGES = FIT >= MAX_STAGES ? MAX_STAGES : FIT >= 3 ? 3 : 2;
  static constexpr int BARS = QBUF * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BARS + 32 + 32 * STAGES + 1024;   // + barriers + alignment slack
  static dim3 grid(const Params& p) {                      // one block an SM, or an item
    const int nwork = (p.t + BM - 1) / BM * p.nbh;
    return dim3(nwork < sm_count() ? nwork : sm_count());
  }
};

// Persistent: the grid is one block an SM, and block x takes the work items
// x, x + gridDim.x, ... of (batch * head, 128-row query tile), query tiles of
// one head next to each other. The producer runs ahead across items, so the
// next item's Q and first K/V tiles land while this item's last products and
// its epilogue run.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_small(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const Params p) {
  using C = Small<D>;
  constexpr int BK = C::BK, NSUB = C::NSUB, STAGES = C::STAGES, QBUF = C::QBUF;
  constexpr int RB = C::RB, SC = C::SC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = base + QBUF * C::Q_BYTES, bars = base + C::BARS;
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 16 + 8 * qb; };
  auto k_full = [&](int s) { return bars + 32 + 8 * s; };
  auto v_full = [&](int s) { return bars + 32 + 8 * (STAGES + s); };
  auto k_empty = [&](int s) { return bars + 32 + 8 * (2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 32 + 8 * (3 * STAGES + s); };

  const int ntiles = (p.t + BK - 1) / BK;
  const int nq = (p.t + C::BM - 1) / C::BM;      // query tiles a head
  const int nwork = nq * p.nbh;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < QBUF; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), 2 * WG);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 2 * WG);
      mbar_init(v_empty(s), 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      int it = 0;                                  // K/V tiles loaded so far, over all items
      int item = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++item) {
        const int bh = w / nq, q0 = (w % nq) * C::BM;
        const int b = bh / p.h, h = bh % p.h;
        const int qb = item % QBUF;
        const uint32_t q_s = base + qb * C::Q_BYTES;
        mbar_wait(q_empty(qb), ((item / QBUF) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), C::Q_BYTES);
        for (int sub = 0; sub < NSUB; ++sub)
          tma_load(q_s + sub * C::BM * RB, &map_q, q_full(qb), sub * SC, q0, h, b);
        for (int i = 0; i < ntiles; ++i, ++it) {
          const int s = it % STAGES;
          const uint32_t free_parity = ((it / STAGES) & 1) ^ 1;
          const uint32_t k_s = kv_s + s * 2 * C::KV_BYTES, v_s = k_s + C::KV_BYTES;
          mbar_wait(k_empty(s), free_parity);
          mbar_expect_tx(k_full(s), C::KV_BYTES);
          for (int sub = 0; sub < NSUB; ++sub)
            tma_load(k_s + sub * BK * RB, &map_k, k_full(s), sub * SC, i * BK, h, b);
          mbar_wait(v_empty(s), free_parity);
          mbar_expect_tx(v_full(s), C::KV_BYTES);
          for (int sub = 0; sub < NSUB; ++sub)
            tma_load(v_s + sub * BK * RB, &map_v, v_full(s), sub * SC, i * BK, h, b);
        }
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int cw = wg;                             // consumer index: query rows 64 cw ..
    const int warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, tg = lane & 3;

    // Software pipeline: Q K^T of tile i + 1 is started before P V of tile i,
    // and the softmax of tile i + 1 runs while P V of tile i is on the tensor
    // cores; O is rescaled only after that P V has landed. `it` counts K/V
    // tiles over all items, as the producer does.
    float o[D / 2], sc[BK / 2], mx[2], alpha[2], m[2], l[2];
    uint32_t pa[BK / 16][4];
    uint32_t q_w = 0;                              // this warpgroup's rows of the item's Q
    auto start_qk = [&](int it) {
      const uint32_t k_s = kv_s + (it % STAGES) * 2 * C::KV_BYTES;
      mbar_wait(k_full(it % STAGES), (it / STAGES) & 1);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {     // k-steps of 16 columns, 32 bytes of a row
        const int sub = kk / (SC / 16), off = (kk % (SC / 16)) * 32;
        wgmma::ss<0>(sc, wgmma::descriptor<RB>(q_w / 16 + (sub * C::BM * RB + off) / 16, 16),
                     wgmma::descriptor<RB>(k_s / 16 + (sub * BK * RB + off) / 16, 16),
                     kk != 0);
      }
      wgmma::commit();
    };
    auto start_pv = [&](int it) {
      const uint32_t v_s = kv_s + (it % STAGES) * 2 * C::KV_BYTES + C::KV_BYTES;
      mbar_wait(v_full(it % STAGES), (it / STAGES) & 1);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)     // 16 keys a step: 16 rows of RB bytes
        wgmma::rs(o, pa[kk], wgmma::descriptor<RB>(v_s / 16 + kk * RB, BK * RB), 1);
      wgmma::commit();
    };
    // the tile's softmax: P (bf16) goes from S's registers into the A operand of P V
    auto scores = [&](int i) {
      mask_and_max(sc, i * BK, p.t, tg, (i + 1) * BK > p.t, mx);
      softmax_scores(sc, mx, m, l, alpha, p.scale_log2);
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    // The two warpgroups take turns at starting their products (named
    // barriers 2 and 3, one a warpgroup: it waits on its own, the other
    // arrives there), so that one's softmax runs under the other's products
    // instead of both waiting for the tensor cores at once.
    auto take_turn = [&]() { asm volatile("bar.sync %0, %1;\n" :: "r"(2 + cw), "n"(2 * WG) : "memory"); };
    auto pass_turn = [&]() { asm volatile("bar.arrive %0, %1;\n" :: "r"(3 - cw), "n"(2 * WG) : "memory"); };
    if (cw == 1) pass_turn();                            // warpgroup 0 goes first

    int it = 0, item = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, ++item) {
      const int bh = w / nq, q0 = (w % nq) * C::BM;
      const int qb = item % QBUF;
      q_w = base + qb * C::Q_BYTES + cw * 64 * RB;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;   // running max (scaled, log2 units) of rows g, g + 8
      l[0] = l[1] = 0.f;         // this lane's share of the running sum

      mbar_wait(q_full(qb), (item / QBUF) & 1);
      take_turn();
      start_qk(it);
      pass_turn();
      wgmma::wait<0>();
      mbar_arrive(k_empty(it % STAGES));
      scores(0);                                           // O is still zero: no rescale
      pack_p();
      for (int i = 0; i + 1 < ntiles; ++i, ++it) {
        take_turn();
        start_qk(it + 1);
        start_pv(it);
        pass_turn();
        wgmma::wait<1>();                                  // S of tile i + 1 has landed
        mbar_arrive(k_empty((it + 1) % STAGES));
        if (i + 2 == ntiles) mbar_arrive(q_empty(qb));     // that was the item's last read of Q
        scores(i + 1);
        wgmma::wait<0>();                                  // P V of tile i has landed
        mbar_arrive(v_empty(it % STAGES));
        rescale(o, alpha);
        pack_p();
      }
      if (ntiles == 1) mbar_arrive(q_empty(qb));
      take_turn();
      start_pv(it);
      pass_turn();
      wgmma::wait<0>();
      mbar_arrive(v_empty(it % STAGES));
      ++it;

      float inv[2];
      const int row0 = q0 + cw * 64 + warp * 16 + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        inv[r] = 1.f / l[r];
        const int row = row0 + 8 * r;
        if (p.lse != nullptr && tg == 0 && row < p.t)
          p.lse[(int64_t)bh * p.t + row] = (m[r] + log2f(l[r])) * 0.6931471805599453f;
      }
      store_rows(p, o, inv, bh / p.h, bh % p.h, row0, 0, tg);
    }
  }
}

// ---------------------------------------------------------------------------
// 256 < Dh <= 512: 64 query rows a block; consumer c owns O's columns of the
// sub-tiles [SUB0, SUB0 + NS) and computes S for keys 32 c .. 32 c + 31 of
// each 64-key tile; P goes through shared memory.
// ---------------------------------------------------------------------------

template <int D>
struct Wide {
  static constexpr int CL = 1;
  static constexpr int BM = 64, BK = 64, SC = SUB;
  static constexpr int NSUB = D / SUB;
  static constexpr int N0 = (NSUB + 1) / 2;                // sub-tiles of consumer 0
  static constexpr int TILE_BYTES = NSUB * 64 * ROW_BYTES;  // Q, a K tile or a V tile
  static constexpr int SUB_BYTES = 64 * ROW_BYTES;
  static constexpr int P_OFF = 3 * TILE_BYTES;
  static constexpr int STAT_OFF = P_OFF + SUB_BYTES;       // row maxima, then row sums: [2][64] each
  static constexpr int BARS = STAT_OFF + 4 * 64 * 4;
  static constexpr int SMEM = BARS + 64 + 1024;
  static dim3 grid(const Params& p) { return dim3((p.t + BM - 1) / BM, p.nbh); }
};

template <int D, int CW>
__device__ __forceinline__ void wide_consumer(const Params& p, unsigned char* smem, uint32_t base,
                                              uint32_t bars, int q0, int b, int h, int ntiles) {
  using C = Wide<D>;
  constexpr int NSUB = C::NSUB, N0 = C::N0;
  constexpr int SUB0 = CW == 0 ? 0 : N0;
  constexpr int NS = CW == 0 ? N0 : NSUB - N0;
  constexpr int NCOL = NS * SUB;                 // this consumer's O columns
  const uint32_t q_s = base, k_s = base + C::TILE_BYTES, v_s = base + 2 * C::TILE_BYTES;
  const uint32_t p_s = base + C::P_OFF;
  unsigned char* p_ptr = smem + C::P_OFF;
  float* row_max = reinterpret_cast<float*>(smem + C::STAT_OFF);   // [2][64]
  float* row_sum = row_max + 2 * 64;                               // [2][64]
  const uint32_t q_full = bars, k_empty = bars + 40;
  auto k_full = [&](int c) { return bars + 8 + 8 * c; };
  const uint32_t v_full = bars + 24 + 8 * CW, v_empty = bars + 48 + 8 * CW;

  const int warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int row_l = warp * 16 + g;               // this lane's rows row_l, row_l + 8 of the tile

  float o[NCOL / 2];
#pragma unroll
  for (int i = 0; i < NCOL / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int i = 0; i < ntiles; ++i) {
    const uint32_t parity = i & 1;

    // ---- S (64 x 32) = Q K^T for this consumer's keys, over the full Dh ----
    // two accumulators, summed below: a chain of m64n32k16 on one
    // accumulator runs at the wgmma's latency, not its rate
    float sc[16], sc1[16];
    mbar_wait(k_full(0), parity);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kk == N0 * 4) mbar_wait(k_full(1), parity);
      const int sub = kk / 4, off = (kk % 4) * 32;
      const uint64_t da = wgmma::descriptor(q_s / 16 + (sub * C::SUB_BYTES + off) / 16, 16);
      const uint64_t db = wgmma::descriptor(
          k_s / 16 + (sub * C::SUB_BYTES + CW * 32 * ROW_BYTES + off) / 16, 16);
      if (kk % 2 == 0) wgmma::ss<0>(sc, da, db, kk >= 2);
      if (kk % 2 == 1) wgmma::ss<0>(sc1, da, db, kk >= 2);
    }
    wgmma::commit();
    wgmma::wait<0>();
#pragma unroll
    for (int e = 0; e < 16; ++e) sc[e] += sc1[e];
    mbar_arrive(k_empty);

    // ---- row maxima over both consumers' halves ----
    float mx[2];
    mask_and_max(sc, i * 64 + CW * 32, p.t, tg, (i + 1) * 64 > p.t, mx);
    if (tg == 0) {
      row_max[CW * 64 + row_l] = mx[0];
      row_max[CW * 64 + row_l + 8] = mx[1];
    }
    consumer_sync(1);   // both halves' maxima are written; P of the last tile has been read
    mx[0] = fmaxf(mx[0], row_max[(1 - CW) * 64 + row_l]);
    mx[1] = fmaxf(mx[1], row_max[(1 - CW) * 64 + row_l + 8]);
    float alpha[2];
    softmax_scores(sc, mx, m, l, alpha, p.scale_log2);
    rescale(o, alpha);

    // ---- P (bf16) into its swizzled K-major tile: columns 32 CW + 8 j + 2 tg ----
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_l + 8 * r;
        const int chunk = (4 * CW + j) ^ (row & 7);
        *reinterpret_cast<uint32_t*>(p_ptr + row * ROW_BYTES + chunk * 16 + tg * 4) =
            pack_bf16x2(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync(2);   // P is whole and visible to wgmma

    // ---- O[:, this consumer's columns] += P V ----
    mbar_wait(v_full, parity);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma::ss<1>(o, wgmma::descriptor(p_s / 16 + kk * 2, 16),
                         wgmma::descriptor(v_s / 16 + (SUB0 * C::SUB_BYTES) / 16 + kk * ROW_BYTES,
                                           C::SUB_BYTES), 1);
    wgmma::commit();
    wgmma::wait<0>();
    mbar_arrive(v_empty);
  }

  // ---- the row sums of both halves, then normalise and store ----
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if (tg == 0) {
    row_sum[CW * 64 + row_l] = l[0];
    row_sum[CW * 64 + row_l + 8] = l[1];
  }
  consumer_sync(1);
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float total = l[r] + row_sum[(1 - CW) * 64 + row_l + 8 * r];
    inv[r] = 1.f / total;
    const int row = q0 + row_l + 8 * r;
    if (CW == 0 && p.lse != nullptr && tg == 0 && row < p.t)
      p.lse[(int64_t)blockIdx.y * p.t + row] = (m[r] + log2f(total)) * 0.6931471805599453f;
  }
  store_rows(p, o, inv, b, h, q0 + row_l, SUB0 * SUB, tg);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wide(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const Params p) {
  using C = Wide<D>;
  constexpr int NSUB = C::NSUB, N0 = C::N0;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  // barriers: q_full, k_full[2], v_full[2], k_empty, v_empty[2]
  const uint32_t bars = base + C::BARS;
  const uint32_t q_full = bars, k_empty = bars + 40;
  auto k_full = [&](int c) { return bars + 8 + 8 * c; };
  auto v_full = [&](int c) { return bars + 24 + 8 * c; };
  auto v_empty = [&](int c) { return bars + 48 + 8 * c; };

  const int q0 = blockIdx.x * C::BM;
  const int b = blockIdx.y / p.h, h = blockIdx.y % p.h;
  const int ntiles = (p.t + C::BK - 1) / C::BK;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_empty, 2 * WG);
    for (int c = 0; c < 2; ++c) {
      mbar_init(k_full(c), 1);
      mbar_init(v_full(c), 1);
      mbar_init(v_empty(c), WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      const uint32_t q_s = base, k_s = base + C::TILE_BYTES, v_s = base + 2 * C::TILE_BYTES;
      mbar_expect_tx(q_full, C::TILE_BYTES);
      for (int sub = 0; sub < NSUB; ++sub)
        tma_load(q_s + sub * C::SUB_BYTES, &map_q, q_full, sub * SUB, q0, h, b);
      for (int i = 0; i < ntiles; ++i) {
        const uint32_t free_parity = (i & 1) ^ 1;
        mbar_wait(k_empty, free_parity);
        for (int c = 0; c < 2; ++c) {
          const int s0 = c == 0 ? 0 : N0, s1 = c == 0 ? N0 : NSUB;
          mbar_expect_tx(k_full(c), (s1 - s0) * C::SUB_BYTES);
          for (int sub = s0; sub < s1; ++sub)
            tma_load(k_s + sub * C::SUB_BYTES, &map_k, k_full(c), sub * SUB, i * 64, h, b);
        }
        for (int c = 0; c < 2; ++c) {
          const int s0 = c == 0 ? 0 : N0, s1 = c == 0 ? N0 : NSUB;
          mbar_wait(v_empty(c), free_parity);
          mbar_expect_tx(v_full(c), (s1 - s0) * C::SUB_BYTES);
          for (int sub = s0; sub < s1; ++sub)
            tma_load(v_s + sub * C::SUB_BYTES, &map_v, v_full(c), sub * SUB, i * 64, h, b);
        }
      }
    }
  } else if (wg == 0) {
    reg_alloc<CONSUMER_REGS>();
    wide_consumer<D, 0>(p, smem, base, bars, q0, b, h, ntiles);
  } else {
    reg_alloc<CONSUMER_REGS>();
    wide_consumer<D, 1>(p, smem, base, bars, q0, b, h, ntiles);
  }
}

// ---------------------------------------------------------------------------
// 512 < Dh <= 1024: the head dimension split across a cluster of Dh / 128
// blocks. Rank r holds columns 128 r .. 128 r + 127 of Q, K, V and O for 64
// query rows; consumer c takes keys 32 c .. 32 c + 31 of every 64-key tile,
// with a running max, sum and O of its own (split-K within the block),
// combined with the other consumer's at the end.
// ---------------------------------------------------------------------------

template <int D>
struct Cluster {
  static constexpr int CL = D / 128;                  // blocks of a cluster
  static constexpr int BM = 64, BK = 64, SC = SUB;
  static constexpr int NSUB = 2;                      // 64-column sub-tiles of a rank's slice
  static constexpr int SUB_BYTES = 64 * ROW_BYTES;    // 64 rows x 64 columns
  static constexpr int TILE_BYTES = NSUB * SUB_BYTES; // Q, a K or a V slice: 16 KB
  static constexpr int STAGES = 3;                    // K and V slices of a tile a stage
  static constexpr int RING_OFF = TILE_BYTES;
  static constexpr int XCH_BYTES = 4 * WG * 16;       // a consumer's S partials, [4 float4][128 threads]
  static constexpr int NBUF = 3;                      // tiles in flight through the exchange
  static constexpr int XCH_OFF = RING_OFF + STAGES * 2 * TILE_BYTES;
  // the exchange: partials, then sums, [NBUF][consumer] each
  static constexpr int BARS = XCH_OFF + 2 * NBUF * 2 * XCH_BYTES;
  static constexpr int SMEM = BARS + 8 * (1 + 4 * STAGES + 4 * NBUF) + 1024;   // + alignment slack
  static_assert(SMEM <= 232448, "shared memory");
  // the end: both consumers' running max and sum ([2][4][128]) and the half
  // of O that the other consumer finishes ([2][32][128]), over the ring
  static_assert(2 * (4 * WG + 32 * WG) * 4 <= STAGES * 2 * TILE_BYTES, "the combine's buffers");
  static dim3 grid(const Params& p) { return dim3((p.t + BM - 1) / BM * CL, p.nbh); }
};

template <int D, int CW>
__device__ __forceinline__ void cluster_consumer(const Params& p, unsigned char* smem,
                                                 uint32_t base, uint32_t bars, int rank, int q0,
                                                 int bh, int ntiles) {
  using C = Cluster<D>;
  constexpr int CL = C::CL, S = C::STAGES;
  // wgmma descriptors take the offset in the block's 256 KB window: in a
  // cluster launch the window's address carries the rank from bit 24
  const uint32_t dbase = base & 0x3FFFFu;
  auto k_full = [&](int i) { return bars + 8 + 8 * (i % S); };
  auto v_full = [&](int i) { return bars + 8 + 8 * (S + i % S); };
  auto k_empty = [&](int i) { return bars + 8 + 8 * (2 * S + i % S); };
  auto v_empty = [&](int i) { return bars + 8 + 8 * (3 * S + i % S); };
  // tile j's exchange: this consumer's partials (x_full: written by every
  // rank) and its sums (y_full: written by every rank), in buffer j % NBUF
  constexpr int NBUF = C::NBUF;
  auto x_full = [&](int j) { return bars + 8 + 32 * S + 8 * (2 * (j % NBUF) + CW); };
  auto y_full = [&](int j) { return bars + 8 + 32 * S + 8 * (2 * (NBUF + j % NBUF) + CW); };
  auto k_at = [&](int i) { return dbase + C::RING_OFF + (i % S) * 2 * C::TILE_BYTES; };
  const int col0 = rank * 128;
  const int lt = threadIdx.x % WG, warp = lt / 32, lane = lt % 32;
  const int g = lane >> 2, tg = lane & 3;
  // this thread's slot 0 of tile j's partials and of its sums (slot f at +
  // f * WG * 16)
  auto part_at = [&](int j) {
    return base + C::XCH_OFF + (2 * (j % NBUF) + CW) * C::XCH_BYTES + lt * 16;
  };
  auto sum_at = [&](int j) {
    return base + C::XCH_OFF + (2 * (NBUF + j % NBUF) + CW) * C::XCH_BYTES + lt * 16;
  };
  // the rank that sums slot f of this thread: the 4 x 128 (slot, thread)
  // units of a consumer dealt out in order, 512 / CL a rank
  auto owner = [&](int f) { return ((f * WG + lt) * CL) >> 9; };

  float o[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) o[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max (scaled, log2 units) of rows g, g + 8
  float l[2] = {0.f, 0.f};               // this lane's share of the running sum

  // ---- S = Q K^T of tile i for this consumer's 32 keys over the rank's 128
  // columns: 8 k-steps, going to two accumulators in turn (a chain on one
  // accumulator runs at the wgmma's latency, not its rate) ----
  auto s_tile = [&](int i, float (&s)[16]) {
    float sa[16], sb[16];
    mbar_wait(k_full(i), (i / S) & 1);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int sub = kk / 4, off = (kk % 4) * 32;
      const uint64_t da = wgmma::descriptor((dbase + sub * C::SUB_BYTES + off) / 16, 16);
      const uint64_t db = wgmma::descriptor(
          (k_at(i) + sub * C::SUB_BYTES + CW * 32 * ROW_BYTES + off) / 16, 16);
      if (kk % 2 == 0) wgmma::ss<0>(sa, da, db, kk >= 2);
      if (kk % 2 == 1) wgmma::ss<0>(sb, da, db, kk >= 2);
    }
    wgmma::commit();
    wgmma::wait<0>();
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = sa[e] + sb[e];
    mbar_arrive(k_empty(i));
  };
  // ---- the ranks' partials of tile j summed in rank order: post (write
  // the partials, one arrival on every rank), reduce (each rank sums the
  // units it owns over the cluster, writes the sums, one arrival on every
  // rank), gather (each thread reads its sums from their owners). A rank
  // reads 1/8 of the partials and 7/8 of the sums at Dh 1024: 28 KB of
  // other blocks' shared memory a 64-key tile, a quarter of what summing
  // every partial itself read. Tile j is posted three tiles ahead, reduced
  // two ahead and gathered one ahead of its softmax, so each round trip has
  // a tile's work to complete under. No barrier says that a buffer was
  // read: a rank posts tile j after it gathered tile j - 3, which waited
  // for every rank's reduce of j - 3 (its reads of the partials), and
  // reduces tile j after every rank posted j, which each did after it
  // gathered j - 3 (its reads of the sums); for the same reasons no rank
  // arrives a phase ahead ----
  auto post = [&](int j, const float (&s)[16]) {
    unsigned char* at = smem + (part_at(j) - base);
#pragma unroll
    for (int f = 0; f < 4; ++f)
      *reinterpret_cast<float4*>(at + f * WG * 16) =
          make_float4(s[4 * f], s[4 * f + 1], s[4 * f + 2], s[4 * f + 3]);
    group_sync(1 + CW, WG);
    if (warp == 0) signal_ranks<CL>(x_full(j), lane);
  };
  auto reduce = [&](int j) {
    mbar_wait_cluster(x_full(j), (j / NBUF) & 1);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (owner(f) != rank) continue;
      float4 v[1];
      sum_ranks<1, CL>(v, part_at(j) + f * WG * 16);
      *reinterpret_cast<float4*>(smem + (sum_at(j) - base) + f * WG * 16) = v[0];
    }
    group_sync(1 + CW, WG);
    if (warp == 0) signal_ranks<CL>(y_full(j), lane);
  };
  auto gather = [&](int j, float (&s)[16]) {
    mbar_wait_cluster(y_full(j), (j / NBUF) & 1);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float4 v = ld_cluster_f4(map_rank(sum_at(j) + f * WG * 16, owner(f)));
      s[4 * f] = v.x;
      s[4 * f + 1] = v.y;
      s[4 * f + 2] = v.z;
      s[4 * f + 3] = v.w;
    }
  };

  mbar_wait(bars, 0);                    // Q
  float s[16], part[16];
  for (int j = 0; j < 3 && j < ntiles; ++j) {
    s_tile(j, part);
    post(j, part);
  }
  for (int j = 0; j < 2 && j < ntiles; ++j) reduce(j);
  gather(0, s);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 3 < ntiles) {
      s_tile(i + 3, part);
      post(i + 3, part);
    }
    if (i + 2 < ntiles) reduce(i + 2);

    // ---- the online softmax: keys i BK + 32 CW + 8 j + 2 tg + (e & 1) ----
    const int key0 = i * C::BK + 32 * CW;
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
    uint32_t pa[2][4];                   // P (bf16) as the A operand: k-step kk holds keys 16 kk ..
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = (e >> 1) & 1;
      s[e] = exp2f(fmaf(s[e], p.scale_log2, -mx[r]));
      l[r] += s[e];
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int w = 0; w < 4; ++w) pa[kk][w] = pack_bf16x2(s[8 * kk + 2 * w], s[8 * kk + 2 * w + 1]);
    rescale(o, alpha);

    // ---- O[:, the rank's columns] += P V over this consumer's 32 keys (V
    // MN-major: [keys][columns], 64-column sub-tiles 8 KB apart) ----
    const uint32_t v_s = k_at(i) + C::TILE_BYTES;
    mbar_wait(v_full(i), (i / S) & 1);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma::rs(o, pa[kk], wgmma::descriptor(v_s / 16 + (2 * CW + kk) * ROW_BYTES, C::SUB_BYTES),
                1);
    wgmma::commit();
    wgmma::wait<0>();
    mbar_arrive(v_empty(i));
    if (i + 1 < ntiles) gather(i + 1, s);
  }

  // ---- combine the two consumers' softmax states (split-K) and store:
  // consumer CW finishes O's columns 64 CW .. 64 CW + 63 of the rank's
  // slice (flat elements 32 CW ..), the other consumer's share of them
  // going through the ring's memory ----
  float* stat = reinterpret_cast<float*>(smem + C::RING_OFF);          // [2][4][128]
  float* half = stat + 2 * 4 * WG;                                     // [2][32][128]
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  group_sync(3, 2 * WG);                 // both consumers are done with the ring's tiles
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    stat[(CW * 4 + r) * WG + lt] = m[r];
    stat[(CW * 4 + 2 + r) * WG + lt] = l[r];
  }
#pragma unroll
  for (int f = 0; f < 32; ++f) half[(CW * 32 + f) * WG + lt] = o[(1 - CW) * 32 + f];
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
  for (int f = 0; f < 32; f += 2) {
    const int e = CW * 32 + f, r = (e >> 1) & 1;
    const int row = row0 + 8 * r, col = col0 + 8 * (e / 4) + 2 * tg;
    if (row >= p.t || col0 + 8 * (e / 4) >= p.dcols) continue;
    const float* po = half + ((1 - CW) * 32 + f) * WG + lt;
    const float x0 = fmaf(o[e], sc_me[r], po[0] * sc_other[r]);
    const float x1 = fmaf(o[e + 1], sc_me[r], po[WG] * sc_other[r]);
    *reinterpret_cast<uint32_t*>(p.o + b * p.o_sb + h * p.o_sh + row * p.o_st + col) =
        pack_bf16x2(x0 * inv[r], x1 * inv[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_cluster(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const Params p) {
  using C = Cluster<D>;
  constexpr int CL = C::CL, S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  // barriers: Q full, k_full[S], v_full[S], k_empty[S], v_empty[S],
  // x_full[NBUF][2] and y_full[NBUF][2] (consumer c's partials, then its
  // sums, of the tile in buffer u written on every rank)
  const uint32_t bars = base + C::BARS;
  auto k_full = [&](int s) { return bars + 8 + 8 * s; };
  auto v_full = [&](int s) { return bars + 8 + 8 * (S + s); };
  auto k_empty = [&](int s) { return bars + 8 + 8 * (2 * S + s); };
  auto v_empty = [&](int s) { return bars + 8 + 8 * (3 * S + s); };

  const int rank = blockIdx.x % CL, q0 = blockIdx.x / CL * C::BM, bh = blockIdx.y;
  const int b = bh / p.h, h = bh % p.h;
  const int col0 = rank * 128;
  const int ntiles = (p.t + C::BK - 1) / C::BK;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 2 * WG);
      mbar_init(v_empty(s), 2 * WG);
    }
    for (int x = 0; x < 4 * C::NBUF; ++x) mbar_init(bars + 8 + 32 * S + 8 * x, CL);   // x/y_full
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  cluster_sync_all();   // every rank's barriers are initialised before any remote arrival

  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    const int loader = threadIdx.x == 2 * WG ? 0 : threadIdx.x == 2 * WG + 32 ? 1 : -1;
    if (loader >= 0) {
      // ---- loads: the rank's slice of Q once, then of K (one thread) and
      // V (another, so that K runs three tiles ahead of the softmax while V
      // waits for its slot) a tile at a time (columns past the head
      // dimension arrive as zeros) ----
      if (loader == 0) {
        mbar_expect_tx(bars, C::TILE_BYTES);
        for (int sub = 0; sub < C::NSUB; ++sub)
          tma_load(base + sub * C::SUB_BYTES, &map_q, bars, col0 + sub * SUB, q0, h, b);
      }
      const CUtensorMap* map = loader == 0 ? &map_k : &map_v;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % S;
        const uint32_t at = base + C::RING_OFF + s * 2 * C::TILE_BYTES + loader * C::TILE_BYTES;
        const uint32_t full = loader == 0 ? k_full(s) : v_full(s);
        mbar_wait(loader == 0 ? k_empty(s) : v_empty(s), ((i / S) & 1) ^ 1);
        mbar_expect_tx(full, C::TILE_BYTES);
        for (int sub = 0; sub < C::NSUB; ++sub)
          tma_load(at + sub * C::SUB_BYTES, map, full, col0 + sub * SUB, i * C::BK, h, b);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    if (wg == 0)
      cluster_consumer<D, 0>(p, smem, base, bars, rank, q0, bh, ntiles);
    else
      cluster_consumer<D, 1>(p, smem, base, bars, rank, q0, bh, ntiles);
  }
  // no block leaves while another rank may still read its partials or
  // arrive on its barriers
  cluster_sync_all();
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename Cfg, typename Kernel>
int launch(Kernel kernel, const void* q, const void* k, const void* v, const Params& p, int b,
           int d, const int64_t* strides, cudaStream_t stream) {
  // set before every launch, so that a launch from another host thread
  // (autograd's worker, when a checkpointed block recomputes) sees it
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_q, map_k, map_v;
  if (!make_map(&map_q, q, b, p.h, p.t, d, strides, Cfg::BM, Cfg::SC) ||
      !make_map(&map_k, k, b, p.h, p.t, d, strides + 3, Cfg::BK, Cfg::SC) ||
      !make_map(&map_v, v, b, p.h, p.t, d, strides + 6, Cfg::BK, Cfg::SC))
    return (int)cudaErrorInvalidValue;
  if constexpr (Cfg::CL > 1) {   // clusters of CL blocks along x
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_launch(&attr, 0, THREADS, Cfg::CL, Cfg::SMEM, stream);
    cfg.gridDim = Cfg::grid(p);
    return (int)cudaLaunchKernelEx(&cfg, kernel, map_q, map_k, map_v, p);
  }
  kernel<<<Cfg::grid(p), THREADS, Cfg::SMEM, stream>>>(map_q, map_k, map_v, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: bf16 [B, H, T, D] on the device, last dimension contiguous;
// strides: the element strides {batch, head, token} of q, k, v and o (12
// values), each a multiple of 8 (16 bytes), bases 16-byte aligned. D a
// multiple of 8 up to 1024: it runs on the smallest instance at or above it
// (32, the multiples of 64 up to 512, then of 128), whose tensor maps
// declare D columns, so the columns past D arrive as zeros and O's are not
// stored. lse:
// contiguous fp32 [B, H, T], or null when the caller needs no LSE. Returns
// the cudaError_t of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                        int h, int t, int d, const int64_t* strides, float sm_scale,
                        void* stream) {
  if (d % 8 != 0 || d > 1024 || d <= 0 || t <= 0 || b <= 0 || h <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Params p = {(bf16*)o, (float*)lse, strides[9], strides[10], strides[11], t, h, b * h, d,
                    sm_scale * 1.4426950408889634f};
  const int instance = d <= 32 ? 32 : d <= 512 ? (d + 63) / 64 * 64 : (d + 127) / 128 * 128;
#define SMALL(D) case D: return launch<Small<D>>(flash_fwd_small<D>, q, k, v, p, b, d, strides, s)
#define WIDE(D) case D: return launch<Wide<D>>(flash_fwd_wide<D>, q, k, v, p, b, d, strides, s)
#define CLUSTER(D) \
  case D: return launch<Cluster<D>>(flash_fwd_cluster<D>, q, k, v, p, b, d, strides, s)
  switch (instance) {
    SMALL(32); SMALL(64); SMALL(128); SMALL(192); SMALL(256);
    WIDE(320); WIDE(384); WIDE(448); WIDE(512);
    CLUSTER(640); CLUSTER(768); CLUSTER(896); CLUSTER(1024);
  }
#undef SMALL
#undef WIDE
#undef CLUSTER
  return (int)cudaErrorInvalidValue;
}

// Clusters of the instance that runs head dimension d (512 < d <= 1024, a
// cluster of d / 128 rounded up) that the device holds at once
// (cudaOccupancyMaxActiveClusters at one block an SM), or a negative
// cudaError_t.
int flash_attention_fwd_max_active_clusters(int d) {
#define CLUSTER(D) \
  case D: return max_active_clusters(flash_fwd_cluster<D>, THREADS, D / 128, Cluster<D>::SMEM)
  switch ((d + 127) / 128 * 128) { CLUSTER(640); CLUSTER(768); CLUSTER(896); CLUSTER(1024); }
#undef CLUSTER
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
