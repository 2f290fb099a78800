#!/usr/bin/env python3
"""Variants of the fp32 flash kernels, made from the shipped sources by text
substitution, held to phase 10a's tolerances against float64, compared bit
for bit with the shipped kernels and timed against them in turns.

Each variant is built again under ``build/kernels/variants/`` with its table
of substitutions applied to ``csrc/flash_attention_f32.cu`` (``fwd``) or
``csrc/flash_attention_bwd_f32.cu`` (``bwd``); each old text must occur
exactly once. The variants:

* ``allread`` (both): the cross-block sums of the earlier design, text for
  text: every consumer of every rank reads every rank's partials of S (and
  in the backward consumer 1 also of dP^T) and sums them itself, through one
  exchange a tile (the forward's partials posted one tile ahead, K and V^T
  loaded by one producer thread through one ring). The shipped kernels sum
  the same terms in the same order through a reduce-scatter and a gather, so
  its outputs must be the shipped bits, and its time beside the shipped
  kernel's is what the reduce-scatter gained;
* ``scatter2`` (both): the reduce-scatter at every cluster size (the
  shipped kernels keep every rank summing every partial at clusters of 2
  and 3, Dh 192 and 256). Its outputs must be the shipped bits;
* ``local`` (both, at the reduce-scatter's instances): no exchange; each
  rank takes its own partials as the sums, with no remote read and no wait
  on another rank. Its outputs are wrong (the check must reject them); the
  shipped time less its time is the exchange's share;
* ``unordered`` (bwd): the dQ adder adds its part without waiting for its
  turn (the key-block order that keeps dQ the same bits from run to run):
  what the order costs. Its dQ is wrong where block 0's store lands after
  another block's add;
* ``padded`` (both): head dimensions up to 32 on the Dh-64 instance over
  split copies zero-padded to 64 columns, the route before the Dh-32
  instances. Its dQ, dK and dV must be the shipped bits (the Dh-32
  backward adds the same 64-key parts in the same order); its O and LSE
  differ in the last bits (the Dh-32 forward's rows take their max and sum
  over a tile's 64 keys at once, the Dh-64 instance's over two 32-key
  halves combined at the end), and the script prints by how much;
* ``noexp`` and ``nosplit`` (both, at the Dh-32 instances' shapes): the
  per-score work taken out, one part at a time: ``noexp`` takes P (the
  forward's P, the backward's P^T) without its exp2, ``nosplit`` hands the
  products P (forward), P^T and dS^T (backward) as their raw bits with a
  zero lo half instead of splitting each into TF32 hi and lo. Their
  outputs are wrong (not judged); the shipped time less theirs is what
  that work costs;
* ``nocopy`` (both, at the same shapes): the split pass left out (the
  backward keeps its stats pass), so the kernels read a workspace nobody
  wrote this call. Its outputs are wrong (not judged); the shipped time
  less its time is the split pass's share;
* ``long`` (both): no 4-k-step cap on the wgmma chains (the tensor cores
  truncate as they accumulate: measured on mma.sync for the first fp32
  kernels), so the shipped kernels start a fresh accumulator every 4
  k-steps (12 wgmma) and add it to the fp32 sum in registers with one
  rounding to nearest. ``long`` drops that: in the forward S in one chain
  over the block's columns and O accumulated by the wgmmas across all key
  tiles (O rescaled in registers before each tile's P V); in the backward
  S^T and dP^T in one chain over the block's columns and dK and dV
  accumulated by the wgmmas across all query tiles.

For each shape the script prints, for the shipped kernel and each variant,
the worst error against the plain version's steps in float64 as a share of
phase 10a's tolerance (2^-16 (P|V| + |ref|) forward, 2^-16 (sqrt(sum
terms^2) + |ref|) for each gradient), whether the variant's outputs (O and
the LSE; dQ, dK and dV) equal the shipped kernel's bit for bit, and the
times in turns (shipped, each variant, each variant again in reverse order,
shipped), with the card's name and power limit::

    python3 tools/torch_flash_f32_variants.py [--kernel fwd|bwd ...] \\
        [--variant allread|scatter2|local|unordered|padded|noexp|nosplit|nocopy|long ...] \\
        [--shape B,H,T,D ...]

It also prints each build's spills by kernel instance (``ptxas -v``).
It exits non-zero if the check rejects the shipped kernel or a variant whose
outputs are right, accepts ``local``, or finds the bits of ``allread`` or
``scatter2`` (or the gradients of ``padded``) differ from the shipped
kernel's.
The variants are not part of the port.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

FWD_LONG = [
    ("""    s_chain(0, pa);
#pragma unroll
    for (int ch = 1; ch < NCH; ++ch) {
      if (ch % 2) s_chain(ch, pb); else s_chain(ch, pa);
      wgmma::wait<1>();
      if (ch % 2) s_fold(ch - 1, pa); else s_fold(ch - 1, pb);
    }
    wgmma::wait<0>();
    s_fold(NCH - 1, pb);
""", """    (void)pa;
    (void)pb;
    fresh(s);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      if (ch % 2 == 0) wait_item(0, i, ch / 2);
      const uint32_t a = dbase + ch * SUBB;
      const uint32_t b = slot_addr(0, i, ch / 2) + (ch % 2) * SUBB + CW * 32 * 128;
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss3(s, a + kk * 32, C::Q_PART, b + kk * 32, ITEM_PART, false);
      wgmma::commit();
    }
    wgmma::wait<0>();
    fence_operand(s);
    for (int c = 0; c < NC; ++c) free_item(0, i, c);
"""),
    ("""    pv_chain(0, qa);
#pragma unroll
    for (int c = 1; c < NC; ++c) {
      if (c % 2) pv_chain(c, qb); else pv_chain(c, qa);
      wgmma::wait<1>();
      if (c % 2) pv_fold(c - 1, qa); else pv_fold(c - 1, qb);
    }
    wgmma::wait<0>();
    if (NC % 2) pv_fold(NC - 1, qa); else pv_fold(NC - 1, qb);
""", """    (void)qa;
    (void)qb;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];
      wait_item(1, i, c);
      const uint32_t b = slot_addr(1, i, c) + CW * SUBB;
      fence_operand(o[c]);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) rs3(o[c], ph[kk], pl[kk], b + kk * 32, ITEM_PART, false);
      wgmma::commit();
    }
    wgmma::wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      fence_operand(o[c]);
      free_item(1, i, c);
    }
"""),
]

BWD_LONG = [
    ("""    x_chain(0, pa);
#pragma unroll
    for (int ch = 1; ch < NX; ++ch) {
      if (ch % 2) x_chain(ch, pb); else x_chain(ch, pa);
      wgmma::wait<1>();
      if (ch % 2) x_fold(ch - 1, pa); else x_fold(ch - 1, pb);
    }
    wgmma::wait<0>();
    x_fold(NX - 1, pb);
""", """    fresh(x);
#pragma unroll
    for (int ch = 0; ch < NX; ++ch) {
      const int item = it + CW * NC + ch / 2;
      if (ch % 2 == 0) wait_item(item);
      const uint32_t a = dbase + CW * C::V_OFF + ch * BKV * 128;
      const uint32_t b = slot_addr(item) + (ch % 2) * BQ * 128;
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss3(x, a + kk * 32, C::KV_PART, b + kk * 32, ITEM_PART, false);
      wgmma::commit();
    }
    wgmma::wait<0>();
    fence_operand(x);
    for (int c = 0; c < NC; ++c) free_item(it + CW * NC + c);
"""),
    ("""    g_chain(0, pa);
#pragma unroll
    for (int c = 1; c < 2 * NC; ++c) {
      if (c % 2) g_chain(c, pb); else g_chain(c, pa);
      wgmma::wait<1>();
      if (c % 2) g_fold(c - 1, pa); else g_fold(c - 1, pb);
    }
    wgmma::wait<0>();
    g_fold(2 * NC - 1, pb);
""", """#pragma unroll
    for (int c = 0; c < 2 * NC; ++c) {
      const int item = it + (2 + CW) * NC + c / 2;
      if (c % 2 == 0) wait_item(item);
      const uint32_t b = slot_addr(item) + (c % 2) * 32 * 128;
      fence_operand(dg[c]);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) rs3(dg[c], ah[kk], al[kk], b + kk * 32, ITEM_PART, false);
      wgmma::commit();
    }
    wgmma::wait<0>();
#pragma unroll
    for (int c = 0; c < 2 * NC; ++c) fence_operand(dg[c]);
    for (int c = 0; c < NC; ++c) free_item(it + (2 + CW) * NC + c);
"""),
]

# every thread writes all its partials to its own buffer and reads them back
# as the sums: no arrival on, or read from, another rank
FWD_LOCAL = [
    ("""      if (owner(f) == rank) continue;
""", ""),
    ("""    }
    group_sync(1 + CW, WG);
    if (warp == 0) signal_ranks<CL>(x_full(j), lane);
""", """    }
"""),
    ("""    mbar_wait_cluster(x_full(j), (j / 2) & 1);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (owner(f) != rank) continue;
      const float4 own = make_float4(x[4 * f], x[4 * f + 1], x[4 * f + 2], x[4 * f + 3]);
      *reinterpret_cast<float4*>(smem + (xch(j) - base) + f * WG * 16) =
          sum_ranks_own<CL, REDUCE_LOADS>(xch(j) + f * WG * 16, rank, own);
    }
    group_sync(1 + CW, WG);
    if (warp == 0) signal_ranks<CL>(y_full(j), lane);
""", """    (void)j;
    (void)x;
"""),
    ("""    mbar_wait_cluster(y_full(j), (j / 2) & 1);
    float4 v[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) v[f] = ld_cluster_f4(map_rank(xch(j) + f * WG * 16, owner(f)));
""", """    float4 v[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) v[f] = ld_cluster_f4(map_rank(xch(j) + f * WG * 16, rank));
"""),
]

# both consumers write all their partials to their own rank's sections; the
# block's consumers still meet at x_full and x_empty (consumer 1 reads
# consumer 0's S^T), each arriving CL times on its own rank
BWD_LOCAL = [
    ("""      if (warp == 0) signal_ranks<CL>(x_full, lane);
""", """      if (warp == 0 && lane < CL) mbar_arrive_cluster(map_rank(x_full, cluster_rank()));
"""),
    ("""      if constexpr (SCATTER) {
        const int rank = cluster_rank();
        mbar_wait_cluster(x_full, j & 1);
""", """      if constexpr (false) {
        const int rank = cluster_rank();
        mbar_wait_cluster(x_full, j & 1);
"""),
    ("""        mbar_wait_cluster(y_full, j & 1);
""", """        mbar_wait_cluster(x_full, j & 1);
"""),
    ("""            v[f] = ld_cluster_f4(map_rank(xch + (f0 + f) * WG * 16, owner(f0 + f)));
""", """            v[f] = ld_cluster_f4(map_rank(xch + (f0 + f) * WG * 16, cluster_rank()));
"""),
    ("""              w[f] = ld_cluster_f4(map_rank(xch + XCH_BYTES + (f0 + f) * WG * 16, owner(f0 + f)));
""", """              w[f] = ld_cluster_f4(map_rank(xch + XCH_BYTES + (f0 + f) * WG * 16, cluster_rank()));
"""),
    ("""      if (warp == 0) signal_ranks<CL>(x_empty, lane);
""", """      if (warp == 0 && lane < CL) mbar_arrive_cluster(map_rank(x_empty, cluster_rank()));
"""),
]

FWD_SCATTER2 = [("""  static constexpr bool SCATTER = CL >= 4;
""", """  static constexpr bool SCATTER = CL >= 2;
""")]

# (a thread owns two slots in clusters of 2 or 3: the reduce loops over them)
BWD_SCATTER2 = [("""  constexpr bool SCATTER = CL >= 4;
""", """  constexpr bool SCATTER = CL >= 2;
"""), ("""        int mine = -1;
#pragma unroll
        for (int f = 0; f < 4; ++f)
          if (owner(f) == rank) mine = f;
        if (mine >= 0) {
          float4 v[1];
          sum_ranks<1, CL, REDUCE_LOADS>(v, xch + CW * XCH_BYTES + mine * WG * 16);
          *reinterpret_cast<float4*>(xch_p + mine * WG * 16) = v[0];
        }
""", """#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if (owner(f) != rank) continue;
          float4 v[1];
          sum_ranks<1, CL, REDUCE_LOADS>(v, xch + CW * XCH_BYTES + f * WG * 16);
          *reinterpret_cast<float4*>(xch_p + f * WG * 16) = v[0];
        }
""")]

BWD_UNORDERED = [
    ("""          while (ld_acquire(turn) < kt) {
          }
""", ""),
]

FWD_ALLREAD = [
    ("""
template <int DL, int CL>
struct Fwd {
""",
     """
template <int DL>
struct Fwd {
"""),
    ("""  // the S partials reduce-scattered from clusters of 4 (at 2, every rank
  // summing every partial measured faster: tools/torch_flash_f32_variants.py)
  static constexpr bool SCATTER = CL >= 4;
  static constexpr int RS = SCATTER ? NSLOT / 2 : NSLOT;   // slots a ring
""",
     """"""),
    ("""  // K item c (kind 0) or V^T item c (kind 1) of tile i: its place in the
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
""",
     """"""),
    ("""  using C = Fwd<DL, CL>;
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
""",
     """  using C = Fwd<DL>;
  constexpr int NC = C::NC, NCH = DL / 32;
  const uint32_t dbase = base & 0x3FFFFu;   // wgmma descriptors' addresses (see the kernel)
  // this consumer's exchange buffers u = 0, 1: partials written by every
  // rank (x_full) and read by every rank (x_empty)
  auto x_full = [&](int u) { return bars + 8 + 8 * (2 * CW + u); };
  auto x_empty = [&](int u) { return bars + 40 + 8 * (2 * CW + u); };
"""),
    ("""  // this thread's slot 0 of tile j's exchange buffer (slot f at + f * WG * 16)
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
""",
     """  auto xch = [&](int u) { return base + C::XCH_OFF + (2 * CW + u) * XCH_BYTES + lt * 16; };
  auto slot_addr = [&](int item) { return dbase + C::RING_OFF + (item % NSLOT) * ITEM; };
  auto wait_item = [&](int item) { mbar_wait(full(item % NSLOT), (item / NSLOT) & 1); };
"""),
    ("""  // sub-tile ch % 2) ----
  auto s_tile = [&](int i, float (&s)[16]) {
    float pa[16], pb[16];
    auto s_chain = [&](int ch, float (&acc)[16]) {
      if (ch % 2 == 0) wait_item(0, i, ch / 2);
      const uint32_t a = dbase + ch * SUBB;
      const uint32_t b = slot_addr(0, i, ch / 2) + (ch % 2) * SUBB + CW * 32 * 128;
""",
     """  // sub-tile ch % 2); the tile's K items are items 2 NC i .. ----
  auto s_tile = [&](int i, float (&s)[16]) {
    const int it = 2 * NC * i;
    float pa[16], pb[16];
    auto s_chain = [&](int ch, float (&acc)[16]) {
      const int item = it + ch / 2;
      if (ch % 2 == 0) wait_item(item);
      const uint32_t a = dbase + ch * SUBB;
      const uint32_t b = slot_addr(item) + (ch % 2) * SUBB + CW * 32 * 128;
"""),
    ("""      if (ch % 2 == 1) free_item(0, i, ch / 2);
""",
     """      if (ch % 2 == 1) mbar_arrive(empty((it + ch / 2) % NSLOT));
"""),
    ("""  // ---- the ranks' partials of tile j summed in rank order, a
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
""",
     """  // ---- the ranks' partials of tile i summed in rank order through buffer
  // i % 2: post (write, one arrival on every rank), collect (wait, sum,
  // release); tile i + 1 is posted before tile i's softmax and P V, so the
  // round trip runs under them ----
  auto post = [&](int i, const float (&s)[16]) {
    const int u = i % 2;
    if (i >= 2) mbar_wait_cluster(x_empty(u), ((i - 2) / 2) & 1);
    unsigned char* at = smem + (xch(u) - base);
#pragma unroll
    for (int f = 0; f < 4; ++f)
      *reinterpret_cast<float4*>(at + f * WG * 16) =
          make_float4(s[4 * f], s[4 * f + 1], s[4 * f + 2], s[4 * f + 3]);
    group_sync(1 + CW, WG);
    if (warp == 0) signal_ranks<CL>(x_full(u), lane);
  };
  auto collect = [&](int i, float (&s)[16]) {
    const int u = i % 2;
    float4 v[4];
    mbar_wait_cluster(x_full(u), (i / 2) & 1);
    sum_ranks<4, CL>(v, xch(u));
    group_sync(1 + CW, WG);
    if (warp == 0) signal_ranks<CL>(x_empty(u), lane);
"""),
    ("""  // s: tile i's S; x: this rank's partials of tile i + 1 until its reduce
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
""",
     """  float s[16], s_next[16];
  s_tile(0, s);
  if constexpr (CL > 1) {
    post(0, s);
    collect(0, s);
  }
  for (int i = 0; i < ntiles; ++i) {
    const int it = 2 * NC * i + NC;      // this tile's first V^T item
    const bool more = i + 1 < ntiles;
    if constexpr (CL > 1) {              // (with no exchange, S of the next tile after P V)
      if (more) {
        s_tile(i + 1, s_next);
        post(i + 1, s_next);
"""),
    ("""      wait_item(1, i, c);
      const uint32_t b = slot_addr(1, i, c) + CW * SUBB;
""",
     """      const int item = it + c;
      wait_item(item);
      const uint32_t b = slot_addr(item) + CW * SUBB;
"""),
    ("""      free_item(1, i, c);
""",
     """      mbar_arrive(empty((it + c) % NSLOT));
"""),
    ("""      if constexpr (C::SCATTER) {
        gather(i + 1, s);
      } else if constexpr (CL > 1) {
        collect(i + 1, x);
#pragma unroll
        for (int e = 0; e < 16; ++e) s[e] = x[e];
""",
     """      if constexpr (CL > 1) {
        collect(i + 1, s_next);
#pragma unroll
        for (int e = 0; e < 16; ++e) s[e] = s_next[e];
"""),
    ("""              const __grid_constant__ CUtensorMap map_vt, const Params p) {
  using C = Fwd<DL, CL>;
  constexpr int NC = C::NC;
""",
     """              const __grid_constant__ CUtensorMap map_vt, const Params p) {
  using C = Fwd<DL>;
  constexpr int NC = C::NC;
"""),
    ("""  // barriers: Q full, x_full[2][2] and y_full[2][2] (consumer c's
  // partials, then its sums, in buffer u written on every rank),
  // full[NSLOT], empty[NSLOT]
""",
     """  // barriers: Q full, x_full[2][2] and x_empty[2][2] (consumer c's
  // partials in buffer u written and read on every rank), full[NSLOT],
  // empty[NSLOT]
"""),
    ("""    for (int x = 0; x < 8; ++x) mbar_init(bars + 8 + 8 * x, CL);   // x_full[2][2], y_full[2][2]
""",
     """    for (int x = 0; x < 8; ++x) mbar_init(bars + 8 + 8 * x, CL);   // x_full[2][2], x_empty[2][2]
"""),
    ("""    // ---- loads: Q once, then K and V^T a 64-column item at a time (kind 0,
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
""",
     """    if (threadIdx.x == 2 * WG) {
      // ---- loads: Q once, then K and V^T a 64-column item at a time ----
"""),
    ("""      for (int i = 0; i < ntiles; ++i) {
        for (int c = 0; c < NC; ++c) load(0, i, c);
        if constexpr (!C::SCATTER)
          for (int c = 0; c < NC; ++c) load(1, i, c);
      }
    } else if (C::SCATTER && threadIdx.x == 2 * WG + 32) {
      for (int i = 0; i < ntiles; ++i)
        for (int c = 0; c < NC; ++c) load(1, i, c);
""",
     """      int it = 0;
      for (int i = 0; i < ntiles; ++i) {
        for (int kind = 0; kind < 2; ++kind) {
          for (int c = 0; c < NC; ++c, ++it) {
            const int s = it % NSLOT;
            const uint32_t dst = base + C::RING_OFF + s * ITEM;
            mbar_wait(empty(s), ((it / NSLOT) & 1) ^ 1);
            mbar_expect_tx(full(s), ITEM);
            for (int part = 0; part < 2; ++part)
              for (int sub = 0; sub < 2; ++sub) {
                const uint32_t at = dst + part * ITEM_PART + sub * SUBB;
                if (kind == 0)   // K: 64 keys x columns 64 c ..
                  tma_load(at, &map_k, full(s), col0 + 64 * c + 32 * sub, i * BK, bh, part);
                else             // V^T: columns 64 c .. x 64 keys
                  tma_load(at, &map_vt, full(s), i * BK + 32 * sub, col0 + 64 * c, bh, part);
              }
          }
        }
      }
"""),
    ("""           const int64_t* s, unsigned char* ws, cudaStream_t stream) {
  using C = Fwd<DL, CL>;
  // set before every launch, so that a launch from another host thread
""",
     """           const int64_t* s, unsigned char* ws, cudaStream_t stream) {
  using C = Fwd<DL>;
  // set before every launch, so that a launch from another host thread
"""),
    ("""#define CLUSTER(D)                                                                  \\
  case D:                                                                           \\
    return max_active_clusters(flash_fwd_f32<128, D / 128>, THREADS, D / 128,       \\
                               Fwd<128, D / 128>::SMEM)
""",
     """#define CLUSTER(D) \\
  case D: return max_active_clusters(flash_fwd_f32<128, D / 128>, THREADS, D / 128, Fwd<128>::SMEM)
"""),
]

BWD_ALLREAD = [
    ("""  // the partials reduce-scattered from clusters of 4 (below, every rank
  // summing every partial measured faster: tools/torch_flash_f32_variants.py)
  constexpr bool SCATTER = CL >= 4;
  // remote loads in flight when an owner sums its unit: two above four
  // ranks (four spilled the consumers at Dh 1024)
  constexpr int REDUCE_LOADS = CL <= 4 ? CL : 2;
""",
     """  // remote loads in flight a slot when the ranks' partials are summed: two
  // above four ranks (four spilled the consumers at Dh 1024)
  constexpr int SUM_LOADS = CL <= 4 ? CL : 2;
"""),
    ("""  const uint32_t y_full = bars + 88 + 16 * NSLOT;
""",
     """"""),
    ("""  // the rank that sums slot f of this thread's partials: the 4 x 128 (slot,
  // thread) units of a section dealt out in order, 512 / CL a rank; from
  // clusters of 4 at most one of a thread's slots, 128 units apart, is this
  // rank's (the reduce sums that one; a loop over the four spilled)
  auto owner = [&](int f) { return ((f * WG + lt) * CL) >> 9; };
""",
     """"""),
    ("""    // partials summed in rank order. From clusters of 4 a reduce-scatter
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
""",
     """    // partials summed in rank order; P^T (keys past T: 0) and, in consumer
"""),
    ("""      if constexpr (SCATTER) {
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
""",
     """      mbar_wait(st_full(j % 2), (j / 2) & 1);
      const float* stat = reinterpret_cast<const float*>(smem + C::STAT_OFF + (j % 2) * STAT_BYTES);
      mbar_wait_cluster(x_full, j & 1);
      float4 v[4];
      sum_ranks<4, CL, SUM_LOADS>(v, xch);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float st = (&v[e / 4].x)[e % 4];
        const int q = 8 * (e / 4) + 2 * tg + (e & 1);
        const bool ok = (e & 2) ? key_ok1 : key_ok0;
        x[e] = ok ? exp2f(fmaf(st, p.scale_log2, -stat[q])) : 0.f;
      }
      if constexpr (CW == 1) {
        sum_ranks<4, CL, SUM_LOADS>(v, xch + XCH_BYTES);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int q = 8 * (e / 4) + 2 * tg + (e & 1);
          x[e] = x[e] * ((&v[e / 4].x)[e % 4] - stat[BQ + q]) * p.sm_scale;
"""),
    ("""    mbar_init(bars + 88 + 16 * NSLOT, 2 * CL);                                   // y_full
""",
     """"""),
]

# the route before the Dh-32 instances: run_columns and copy_columns give 64
# from 4 to 32 columns
PADDED = [("""#include "wgmma_tf32.cuh"
""", """#include "wgmma_tf32.cuh"

namespace tf32w {
inline int run_padded(int d) { return d <= 32 ? 64 : run_columns(d); }
inline int copy_padded(int d) { return d <= 32 ? 64 : copy_columns(d); }
}  // namespace tf32w
#define run_columns run_padded
#define copy_columns copy_padded
""")]
# the Dh-32 instances' per-score work taken out (outputs wrong)
def raw_a(src: str, hi: str, lo: str) -> str:
    """A loop body giving the A fragments of k-step kk as the raw bits of
    the accumulator `src` (acc_to_a's order) and a zero lo half."""
    return ("{\n      const float* d = SRC + 4 * kk;\n"
            "      HI[kk][0] = __float_as_uint(d[0]);\n      HI[kk][1] = __float_as_uint(d[2]);\n"
            "      HI[kk][2] = __float_as_uint(d[1]);\n      HI[kk][3] = __float_as_uint(d[3]);\n"
            "      LO[kk][0] = LO[kk][1] = LO[kk][2] = LO[kk][3] = 0u;\n    }"
            ).replace("SRC", src).replace("HI", hi).replace("LO", lo)
FWD_NOEXP = [("""        s[e] = exp2f(fmaf(s[e], p.scale_log2, -m[r]));
        l[r] += s[e];""", """        s[e] = fmaf(s[e], p.scale_log2, -m[r]);
        l[r] += s[e];""")]
BWD_NOEXP = [("""      x[e] = ok ? exp2f(fmaf(x[e], p.scale_log2, -stat[q])) : 0.f;
      y[e] = x[e] * (y[e] - stat[BQ + q]) * p.sm_scale;""", """      x[e] = ok ? fmaf(x[e], p.scale_log2, -stat[q]) : 0.f;
      y[e] = x[e] * (y[e] - stat[BQ + q]) * p.sm_scale;""")]
FWD_NOSPLIT = [("""      for (int kk = 0; kk < 8; ++kk) acc_to_a(s + 4 * kk, ph[kk], pl[kk]);""",
                """      for (int kk = 0; kk < 8; ++kk) """ + raw_a("s", "ph", "pl"))]
BWD_NOSPLIT = [("""    for (int kk = 0; kk < 4; ++kk) acc_to_a(x + 4 * kk, ah[kk], al[kk]);
    float ga[16], gb[16];""", """    for (int kk = 0; kk < 4; ++kk) """ + raw_a("x", "ah", "al") + """
    float ga[16], gb[16];"""),
               ("""    for (int kk = 0; kk < 4; ++kk) acc_to_a(y + 4 * kk, sh[kk], sl[kk]);""",
                """    for (int kk = 0; kk < 4; ++kk) """ + raw_a("y", "sh", "sl"))]

# the split pass left out (outputs wrong)
NOCOPY = [("  return launch_split(sp, stream);\n}", "  (void)sp;\n  return cudaSuccess;\n}")]

# phase 12a's and 13a's shapes at Dh 32 and 16 and the entry points' batch 2
DH32 = {"fwd": ((16, 32, 256, 32), (8, 32, 1024, 32), (2, 32, 1024, 32), (16, 64, 256, 16),
                (8, 64, 1024, 16)),
        "bwd": ((8, 32, 1024, 32), (2, 32, 1024, 32), (8, 64, 1024, 16))}

# 14a's fp32 shapes (the one-head U-Net's 512^2 training, the 1024-wide
# codec at 256^2), phase 10a's Dh-512 ones (the VQ encoder at 512^2, batch
# 8; the codec's backward at 256^2), the other instances of 128 columns a
# block (clusters of 5 to 7), and of 64 (clusters of 3, 5 and 7)
WIDE = ((2, 1, 4096, 640), (2, 1, 4096, 768), (2, 1, 4096, 896))
NARROW = ((4, 2, 4096, 256), (4, 2, 4096, 192), (4, 2, 4096, 320), (4, 2, 4096, 448))
NEW_SHAPES = {
    "fwd": ((8, 1, 1024, 1024), (2, 1, 4096, 1024), (8, 1, 4096, 512)) + WIDE + NARROW,
    "bwd": ((8, 1, 1024, 1024), (2, 1, 4096, 1024), (2, 1, 4096, 512)) + WIDE + NARROW,
}
# the instances that reduce-scatter: clusters of 4 and more
SCATTERED = {k: tuple(s for s in v if s[3] >= 320) for k, v in NEW_SHAPES.items()}
# and with no cluster (Dh 128, one block a head's columns): phase 10a's
# U-Net sampling and 512^2 training shapes
SINGLE = {"fwd": ((16, 8, 256, 128), (8, 8, 1024, 128)),
          "bwd": ((8, 8, 1024, 128), (2, 8, 1024, 128))}
# kernel: (source stem, {variant: (substitutions, outputs right, shapes)})
KERNELS = {
    "fwd": ("flash_attention_f32", {
        "allread": (FWD_ALLREAD, True, SINGLE["fwd"] + NEW_SHAPES["fwd"]),
        "scatter2": (FWD_SCATTER2, True, NEW_SHAPES["fwd"]),
        "local": (FWD_LOCAL, False, SCATTERED["fwd"]),
        "padded": (PADDED, True, DH32["fwd"]),
        "noexp": (FWD_NOEXP, None, DH32["fwd"]),
        "nosplit": (FWD_NOSPLIT, None, DH32["fwd"]),
        "nocopy": (NOCOPY, None, DH32["fwd"]),
        "long": (FWD_LONG, True, ((8, 8, 1024, 128), (2, 1, 16384, 512), (1, 1, 2500, 512))),
    }),
    "bwd": ("flash_attention_bwd_f32", {
        "allread": (BWD_ALLREAD, True, SINGLE["bwd"] + NEW_SHAPES["bwd"]),
        "scatter2": (BWD_SCATTER2, True, NEW_SHAPES["bwd"]),
        "local": (BWD_LOCAL, False, SCATTERED["bwd"]),
        "unordered": (BWD_UNORDERED, None, SCATTERED["bwd"]),
        "padded": (PADDED, True, DH32["bwd"]),
        "noexp": (BWD_NOEXP, None, DH32["bwd"]),
        "nosplit": (BWD_NOSPLIT, None, DH32["bwd"]),
        "nocopy": (NOCOPY, None, DH32["bwd"]),
        "long": (BWD_LONG, True, ((2, 8, 1024, 128), (2, 1, 4096, 512), (2, 1, 16384, 512))),
    }),
}


def variant_source(kernel: str, name: str) -> str:
    from stedm_tpu_torch import _device

    stem, variants = KERNELS[kernel]
    src = (_device.CSRC / f"{stem}.cu").read_text()
    for old, new in variants[name][0] if name in variants else ():
        if src.count(old) != 1:
            raise SystemExit(f"the shipped source no longer has the text to replace:\n{old}")
        src = src.replace(old, new)
    return src


def build_variant(kernel: str, name: str) -> subprocess.Popen:
    """Starts nvcc on the variant; the library is ``lib<stem>_<name>.so``."""
    from stedm_tpu_torch import _device

    stem = KERNELS[kernel][0]
    out = _device.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{stem}_{name}.cu"
    cu.write_text(variant_source(kernel, name))
    return subprocess.Popen([_device._nvcc(), *_device.NVCC_FLAGS, "-I", str(_device.CSRC),
                             "-o", str(out / f"lib{stem}_{name}.so"), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def variant_fn(kernel: str, name: str):
    """The variant's C entry point with the shipped one's signature, and its
    workspace bytes for (B * H, T, Dh)."""
    import torch

    from stedm_tpu_torch import _device
    from stedm_tpu_torch.ops import blocked_attention as a

    stem = KERNELS[kernel][0]
    lib = ctypes.CDLL(str(_device.BUILD_DIR / "variants" / f"lib{stem}_{name}.so"))
    if kernel == "fwd":
        fn = lib.flash_attention_f32_fwd
        fn.argtypes, fn.restype = a._fwd_lib(torch.float32).argtypes, ctypes.c_int
    else:
        fn = lib.flash_attention_bwd_f32
        fn.argtypes, fn.restype = a._bwd_lib(torch.float32).argtypes, ctypes.c_int
    ws = getattr(lib, f"{stem}_workspace")
    ws.argtypes, ws.restype = [ctypes.c_int] * 3, ctypes.c_size_t
    return fn, ws


def fwd_errors(torch, got, q, k, v, s) -> float:
    """The worst |got - ref| / 2^-16 (P|V| + |ref|) over the batch, ref in float64."""
    worst = 0.0
    for i in range(q.shape[0]):
        Q, K, V = (x[i:i + 1].double() for x in (q, k, v))
        P = torch.softmax((Q @ K.transpose(-1, -2)) * s, -1)
        ref = P @ V
        tol = 2 ** -16 * (P @ V.abs() + ref.abs())
        worst = max(worst, float(((got[i:i + 1].double() - ref).abs() / tol).max()))
        del P, ref, tol
    return worst


def bwd_errors(torch, cs, got, q, k, v, o, lse, do, s) -> float:
    """The worst |got - ref| / 2^-16 (sqrt(sum terms^2) + |ref|) over dQ, dK,
    dV and the batch, ref the plain version's steps in float64."""
    worst = 0.0
    for i in range(q.shape[0]):
        sl = slice(i, i + 1)
        ref, bounds = cs._f64_backward(torch, q[sl], k[sl], v[sl], o[sl], lse[sl], do[sl], s)
        for j in range(3):
            worst = max(worst, cs._ratio(torch, got[j][sl], ref[j],
                                         cs.F32_REL * (bounds[j] + ref[j].abs())))
        del ref, bounds
    return worst


def ptxas_summary(text: str) -> list:
    """Each flash kernel's instance (its template arguments) and its spills,
    from ``ptxas -v``'s output."""
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name and "flash_" in name and "_stats" not in name and "_dq" not in name:
            args = re.findall(r"Li(\d+)E", name)
            out.append(f"<{', '.join(args)}> {m.group(1)}/{m.group(2)} B spilled")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", action="append", choices=sorted(KERNELS),
                    help="kernels to run (default: both)")
    ap.add_argument("--variant", action="append",
                    choices=sorted({n for _, v in KERNELS.values() for n in v}),
                    help="variants to run where the kernel has them (default: all but long, "
                         "padded, noexp, nosplit and nocopy)")
    ap.add_argument("--shape", action="append",
                    help="B,H,T,D to run instead of each variant's shapes")
    args = ap.parse_args()
    kernels = args.kernel or list(KERNELS)
    chosen = args.variant or ["allread", "scatter2", "local", "unordered"]
    shapes = [tuple(int(x) for x in s.split(",")) for s in args.shape] if args.shape else None
    import torch

    import chip_smoke as cs
    from stedm_tpu_torch.ops import blocked_attention as a

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}")
    # (the shipped text too, built again for its ptxas report)
    builds = {(k, n): build_variant(k, n) for k in kernels
              for n in ["shipped", *chosen] if n == "shipped" or n in KERNELS[k][1]}
    for (k, n), proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {k} variant {n}:\n{log}")
        print(f"{k} {n}: " + "; ".join(ptxas_summary(log)), flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda").zero_
    gen = torch.Generator(device="cuda").manual_seed(13)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    failed = []
    for kernel in kernels:
        variants = {n: KERNELS[kernel][1][n] for n in chosen if n in KERNELS[kernel][1]}
        fns = {n: variant_fn(kernel, n) for n in variants}
        todo = shapes or sorted({sh for _, _, shs in variants.values() for sh in shs},
                                key=lambda sh: (sh[3], sh[2]))
        for shape in todo:
            names = [n for n in variants if shapes or shape in variants[n][2]]
            b, h, t, d = shape
            plan = a.fp32_plan(b, h, t, d)
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
            s = d ** -0.5
            strides = [x for y in (q, k, v, q) for x in a.check_strided(y, "x")]
            nbytes = max([plan[f"{kernel}_workspace"]] + [w(b * h, t, d) for _, w in fns.values()])
            ws = torch.empty(nbytes, device="cuda", dtype=torch.uint8)
            if kernel == "fwd":
                def launch(fn):
                    out, lse = torch.empty_like(q), torch.empty(shape[:3], device="cuda")
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             lse.data_ptr(), ws.data_ptr(), b, h, t, d, plan["cluster"],
                             (ctypes.c_int64 * 12)(*strides), float(s), stream())
                    if err:
                        raise RuntimeError(f"fp32 forward variant: cudaError {err}")
                    return out, lse

                shipped = lambda: a.flash_attention_cuda(q, k, v, s, return_lse=True)
                errors = lambda got: fwd_errors(torch, got[0], q, k, v, s)
                parts = ("O", "LSE")
            else:
                o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
                bstrides = strides[:9] + [x for y in (o, do) for x in a.check_strided(y, "x")]

                def launch(fn):
                    grads = [torch.empty_like(q) for _ in range(3)]
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             do.data_ptr(), lse.data_ptr(), *(g.data_ptr() for g in grads),
                             ws.data_ptr(), b, h, t, d, plan["cluster"],
                             (ctypes.c_int64 * 15)(*bstrides), float(s), stream())
                    if err:
                        raise RuntimeError(f"fp32 backward variant: cudaError {err}")
                    return grads

                shipped = lambda: a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
                errors = lambda got: bwd_errors(torch, cs, got, q, k, v, o, lse, do, s)
                parts = ("dQ", "dK", "dV")
            runs = {"shipped": shipped}
            runs.update({n: (lambda fn=fns[n][0]: launch(fn)) for n in names})
            outs = {n: [x.clone() for x in f()] for n, f in runs.items()}
            torch.cuda.synchronize()
            errs = {n: errors(outs[n]) for n in runs}
            iters = 20 if t * d <= 1024 * 128 else 10 if t * d <= 4096 * 1024 else 3
            order = ["shipped", *names, *reversed(names), "shipped"]
            times = {}
            for n in order:
                times.setdefault(n, []).append(cs.time_ms(runs[n], iters, flush))
            t_s = sum(times["shipped"]) / 2
            print(f"{kernel} {list(shape)} (cluster {plan['cluster']}): shipped {t_s:.4f} ms "
                  f"({times['shipped'][0]:.4f}, {times['shipped'][1]:.4f}), "
                  f"{errs['shipped']:.3f} of the tolerance", flush=True)
            if errs["shipped"] > 1:
                failed.append(f"{kernel} shipped {list(shape)}")
            for n in names:
                right = variants[n][1]
                same = {p: torch.equal(x, y) for p, x, y in zip(parts, outs[n], outs["shipped"])}
                t_v = sum(times[n]) / 2
                print(f"  {n}: {t_v:.4f} ms ({times[n][0]:.4f}, {times[n][1]:.4f}), "
                      f"{t_v / t_s:.3f} of shipped; {errs[n]:.3f} of the tolerance "
                      f"({'accepted' if errs[n] <= 1 else 'rejected'}); bit for bit equal to "
                      f"shipped: " + ", ".join(f"{p} {x}" for p, x in same.items()), flush=True)
                if right is not None and (errs[n] <= 1) != right:
                    failed.append(f"{kernel} {n} {list(shape)}: judged wrongly")
                if n in ("allread", "scatter2") and not all(same.values()):
                    failed.append(f"{kernel} {n} {list(shape)}: other bits")
                if n == "padded" and kernel == "bwd" and not all(same.values()):
                    failed.append(f"{kernel} {n} {list(shape)}: other gradient bits")
                if n == "padded" and kernel == "fwd":
                    worst = {p: float((x - y).abs().max())
                             for p, x, y in zip(parts, outs[n], outs["shipped"])}
                    print("    largest |padded - shipped|: "
                          + ", ".join(f"{p} {x:.3e}" for p, x in worst.items()), flush=True)
            del q, k, v, do, outs
            torch.cuda.empty_cache()
    print(f"card: {card}")
    if failed:
        print("FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
