#!/usr/bin/env python3
"""On-card check of stedm_tpu_torch: kernels, main path, one JSON verdict.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. header: the card's name and power limit (nvidia-smi), torch's version; the
   CUDA kernels are built from ``stedm_tpu_torch/csrc`` (one nvcc per source,
   all at once);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with the tolerance it prints, timed beside its plain
   version, a PyTorch library call computing the same function (a yardstick
   only; the port never calls it) and its bound on an H100; the forward
   kernels at the sampling and the training shapes, the flash forward also
   at a ragged T, at Dh 256 and on the strided views that the U-Net's
   AttentionBlock hands it, bit for bit against contiguous copies;
   2b. the flash-attention backward (its Di pass and the fused kernel for dQ,
   dK and dV), launched directly and through ``FlashAttentionFunction`` on
   the AttentionBlock's strided views, against ``attention_backward_reference``
   at the training shapes, two launches bit for bit, the Di pass against
   ``_row_dot``, and the forward's output and LSE against
   ``attention_reference`` and ``torch.logsumexp`` (each gradient within
   2^-7 (sqrt(sum terms^2) + |ref|), ``backward_errors``); then the same at Dh 512
   (the codec's AttnBlockVQ, a cluster of four blocks a key tile) at
   ``[2, 1, 4096, 512]``, a ragged ``[1, 1, 2500, 512]`` and the codec
   fine-tuning shape ``[2, 1, 16384, 512]``, timed against its bound and
   SDPA's backward (the backend that takes Dh 512 named);
   2c. ``GNSiLUFunction`` on the card (CUDA forward, plain backward): its
   output against ``gn_silu_reference``, its gradients against autograd of
   ``gn_silu_reference`` at the 512^2 U-Net training shapes;
3. a tiny STEDM on the card against the same model on the CPU (plain
   versions), DDIM-4 with rescaled CFG;
   3b. the same tiny model (non-zero ``proj_out``, Dh 64) trained for three
   micro-steps at accumulation 2 on the card and on the CPU, same t and noise;
   3c. a tiny codec (ch 32, patch 48, mid-block attention at C 512, T 576)
   fine-tuned for two steps of the ``vq`` and two of the ``kl`` variant on
   the card and on the CPU (in bf16, and in fp32 as the control of what bf16
   alone moves), same weights, images and posterior noise, with an ActNorm
   discriminator, the GAN gated off and then live; log values, each step's
   gradients and the parameters' change held to fixed tolerances; the
   shipped BatchNorm discriminator on the same images on both;
   3d. the tiny STEDM in the composed serving mode (refreshes (0, 3, 5) of 8
   steps, guidance window (0.25, 0.75), CFG 1.5, phi 0.7, bf16): the eager
   loop and the CUDA-graph block sampler on the card against the eager loop
   on the CPU (phase 3's tolerance), and the latent z_0 of the graph replay
   against the card's eager loop's bit for bit;
4. the flagship main path: ``build_flagship(batch=8)`` at 256^2, bf16,
   ``make_sample_fn`` with DDIM-50, CFG 1.5, rescale 0.7 and shared-encoder
   batched CFG, as bench.py runs it; launch counts are zeroed just before and
   read just after (the cold run also logs the GN calls by shape and the sum
   of their bounds), and a second warm run is timed;
   4d. the serving mode as bench.py's headline runs it: refreshes from
   ``positions_from_spec("auto:5")`` on the committed drift profile (which
   must read (0, 3, 21, 33, 41)), the window (0.35, 0.65) -> (18, 32) with
   its forced refresh, so 6 full passes and 44 cached; eager (launch counts
   zeroed just before and read just after: 7 flash launches, the GN launches
   that the schedule and the module counts imply), then graph-replayed
   (``make_host_sample_fn``: its latent z_0 equal to the eager loop's bit
   for bit), and the exact trajectory graph-replayed (its z_0 equal to the
   eager exact loop's; the decoded images, which the random-weight decoder
   quantizes and saturates, are only logged); img/s of four warm runs each; the cached-vs-exact PSNR and ``measure_cache_drift`` of the
   port's flagship, logged; then profiles of the three (device time, idle
   share, one GN device kernel for each GN the schedule implies: the
   profiler counts the replays, the wrappers only the capture);
5. a profile of one more warm run: device time by kernel category and the
   device's idle share (full table in ``<out>/profile.txt``), one GN device
   kernel for each GN launch and no Triton kernel; then the host time of a
   GN and a nearest-code wrapper call with the card kept busy;
   4b. full-width training, the second main path: ``build_flagship(batch=8,
   patch=512, nonzero_init=True)``, ``make_train_step`` with AdamW lr 1e-4,
   weight decay 0.01, accumulation 4 and the EMA, as tools/bench_train.py
   runs the JAX package; launch counts of one micro-step (zeroed just before,
   read just after), gradient and update checks, samples/s over timed
   applied updates, peak memory and a profile of one micro-step
   (``<out>/profile_train.txt``);
   4c. full-width codec fine-tuning, the third main path: the vq-f4 codec
   (55,322,782 parameters) at 512^2, batch 2, bf16 compute with fp32
   parameters, config_ae.yaml's loss block with ``disc_start`` 0 and LPIPS
   with seeded random weights (both printed as overrides), Adam at the
   train_ae.py lr rule; launch counts of one step (zeroed just before, read
   just after), finite losses, moving parameters, perplexity, samples/s over
   five timed steps, peak memory and a profile of one step
   (``<out>/profile_codec.txt``);
6. the train and predict entry points (``stedm_tpu_torch.train_diff.main``,
   ``predict_diff.main``) at the shipped widths of configs/config_diff.yaml
   and config_predict.yaml (landscape U-Net, VQ-f4, Swin-V2-T, 512^2, batch
   2) on a synthetic Flowers-102 tree written under ``build/`` (102 classes,
   three 500x667 images each): a training run of 8 micro-steps at
   accumulation 4 (``data.samples=16``, one epoch, 20-step previews), a
   resume into a second epoch, then README's predict of 8 pairs with the
   run's EMA weights, exact (DDIM-50, cut from the config's 128 to make room
   for phase 12) and in the serving mode
   (``auto:5``, window (0.35, 0.65), 50 steps), each through the CUDA-graph
   block sampler; pair counts, PNG shapes and values, finite losses, the
   moved EMA, the resumed step and the launches of every kernel inside these
   calls checked; samples/s, pairs/s after the first batch, the share of
   the host clock spent outside the sampler, the checkpoint's size and the
   phase's seconds printed;
7. downstream segmentation, on phase 6's tree: 7a. a tiny ``SegUNet`` (four
   depth-1 stages, narrow decoder) trained two micro-steps at accumulation 2
   and then evaluated, on the card and on the CPU in fp32 from the same
   weights and batches: losses, train- and eval-mode logits, confusion
   matrices (a flip allowed only where the CPU's two logits nearly tie),
   running statistics and the update held to the ``SEG_*`` tolerances; the
   same run with torch's BatchNorm momentum on the card must fail them;
   7b. the shipped MiT-B2 U-Net (config_seg.yaml: 512^2, batch 2,
   accumulation 4, bf16, AdamW at the scaled lr, weight decay 1e-4): launch
   counts of one micro-step (zeroed just before, read just after), finite
   losses, moving parameters and running statistics, samples/s over four
   timed updates, the host's time to issue a micro-step, peak memory, eval
   images/s and a profile of one micro-step (``<out>/profile_seg.txt``, its
   host ops in ``profile_seg_host.txt``); 7c. ``stedm_tpu_torch.train_seg.main``
   on phase 6's Flowers tree and its exact predict output as
   ``flowers_syn`` (README's mix 0.2 / 0.8; the cuts printed): both
   checkpoints, IoUs in [0, 1], every key the JAX entry point logs, the
   launches inside the call and the phase's seconds;
8. histopathology at the shipped widths of her2.yaml / catch.yaml, on
   synthetic slides written under ``build/`` (removed at the end): 8a. a HER2
   tree (three 8192^2 annotated slides with one 4000^2 ROI each, rasterised
   by the port's ``prep.rasterize_rois``, two scoring slides and their score
   list) and the host's rates on it (slide open, patch reads, a training
   item's reads, PNG decode and augmentations); 8b. ``train_ae.main
   data=her2`` (vq-f4, 512^2, batch 2, ``disc_start`` 0, no LPIPS weights):
   8 steps, finite logs, moving codec, both checkpoints; 8c.
   ``train_diff.main data=her2 style_sampling=nearby``: 8 micro-steps at
   accumulation 4 and a resume, the layout mapper [2 -> 3], samples/s and
   the data and h2d laps; 8d. ``predict_diff.main`` pairing her2_anno
   layouts with her2_unanno styles, 8 pairs exact (DDIM-50, cut for phase 12)
   and 8 in the serving mode through the CUDA-graph sampler; 8e. ``train_seg.main`` on 8d's pairs
   (her2_anno 0.2, her2_syn 0.8), one epoch, the patient IoU keys and a val
   tile with a cut margin; 8f. CATCH (when h5py imports; else one line says
   so): ``train_diff.main data=catch`` for one update and ``train_seg.main
   data=catch`` for one epoch with the subtype IoU; the launches of every
   kernel inside each call;
9. the rest of the generation workflow at the shipped widths: 9a.
   PLMS-50 and DPM-Solver++(2M)-50 on phase 4's flagship and batch, eager
   (launches zeroed just before and read just after; 51 and 50 U-Net
   evaluations) and as graph-replayed host blocks (the latent z_0 equal to
   the eager one's bit for bit), img/s of three warm runs each and the
   device time of a profiled graph run; the tiny STEDM with PLMS and
   DPM-Solver, and a tiny 2x-patch canvas, card (eager and graph) against
   the CPU at phase 3's tolerance; 9b. ``predict_diff.main
   +canvas_size=1024`` on phase 6's tree (2 x 2 layouts a canvas, batches
   of 8 layouts, so two canvases a batch and every tile at phase 2's
   batch-2 shapes; three batches, exact DDIM-25 through the graph-replayed
   blocks, tiled eps and decode): PNG pairs at the canvas size, pairs/s
   after the first batch and tiles a step; 9c.
   ``train_diff.main style_agg=svit`` (the shipped set-ViT, dropout 0.1
   from the step's generator) for 8 micro-steps, each an update, at lr
   1e-4: finite losses, sViT parameters moved by at least half the lr, peak
   memory, the encoder's device ms; then
   ``predict_diff.main`` on its checkpoint; 9d. the codec hand-off:
   ``train_ae.main`` writes ``<run>_best.pt``, ``train_diff.main`` takes it
   as its first stage and a random-weight CompVis U-Net ``.ckpt`` the
   script writes (the printed counts checked), the codec equal to the AE
   checkpoint bit for bit after the steps, then ``predict_diff.main`` on
   that run; the launches of every kernel inside each call; phase 6's tree
   is removed at the end of phase 10;
10. the fp32 compute path and the wide codebooks, on phase 6's tree: 10a.
   the fp32 flash forward (``csrc/flash_attention_f32.cu``: 3xTF32 wgmma
   over TF32 hi and lo copies, the head dimension split across a cluster)
   at the sampling,
   training and codec shapes, a ragged T and the AttentionBlock's strided
   views (bit for bit against contiguous copies), within 2^-16 (P|V| +
   |ref|) of ``attention_reference``; the fp32 backward
   (``csrc/flash_attention_bwd_f32.cu``) directly and through
   ``FlashAttentionFunction`` on strided views, two launches bit for bit,
   each gradient within 2^-16 (sqrt(sum terms^2) + |ref|) of
   ``attention_backward_reference``'s steps in float64 (the fp32 plain
   version's own reading logged beside it: cuBLAS sums 16k keys in one
   sequence); at every shape the plain version with TF32 products must
   fail the same tolerance; GN+SiLU at fp32; nearest code at N 32768 and
   131072, widths 3-16 and codebooks to 16384 codes (the resident and the
   streaming kernel), duplicated codes keeping the lowest index; all timed
   beside their plain versions, SDPA at fp32 (its backend named) and their
   bounds (3xTF32 products over the TF32 peak); 10b. the tiny STEDM at fp32
   sampled and trained on the card against the CPU (``F32_TINY_TOL``);
   10c. at fp32 the flagship sampler (DDIM-25, cut for phase 12; eager and as
   graphs, the latents bit for bit, a profile), a 512^2 training micro-step and a vq-f4 codec step
   (profiled: ``profile_f32_codec.txt`` and the fp32 flash kernels' share
   of its device time);
   10d. ``train_ae``, ``train_diff`` and ``predict_diff`` (4 pairs, the
   eager sampler) at ``diffusion.compute_dtype=float32``, and ``train_ae`` with vq-f8's and
   vq-f16's codebooks (4 / 4 / 16384, 8 / 8 / 16384); in 10c and 10d the
   launches of every kernel inside each call, and no CUDA tensor reaching
   a plain version (``PlainOnCard``);
11. several processes (``stedm_tpu_torch/parallel/``), on phase 6's tree:
   11a. a one-process torchrun-style launch (the script sets RANK,
   WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) over NCCL:
   ``train_diff.main`` (2 micro-steps, accumulation 2) and
   ``predict_diff.main`` (8 pairs), their launches counted; 11b. two gloo
   ranks sharing this card (the script runs itself as each process,
   ``--dist-worker``) against one process at the same global batch, fp32 at
   reduced widths: the parameters and the EMA after two updates within 2 lr
   each and 1e-3 lr on average (``DIST_*``), the scale factor, seg PNGs
   equal and images within 1; the same ranks drawing t and the noise for
   their own rows only must fail that check (its reading printed); 11c.
   phase 8c's HER2 epoch through the worker-process loader
   (``location.loader=grain``, 4 worker processes) beside 8c's threaded
   loader: samples/s, the data lap's share of the epoch, the host ms of an
   item; phase 8's tree is removed at the end;
12. the diffusion model's options, on phase 6's tree (removed at its end):
   12a. the bf16 forward and the fp32 kernels at Dh 32
   (``num_head_channels: 32``: the bf16 forward's own instance and the
   fp32 kernels' own Dh-32 instances, the forward persistent over 128-row
   work items, the backward 128 keys a block, both on split copies of the
   true columns; launches counted as ``<kernel>_dh32``; the bf16
   backward's own Dh-32 instance is checked in 13a) at 12c's sampling and
   micro-step shapes and the entry points' batch 2 against their plain
   versions with phase 2b's and 10a's tolerances, and GroupNorm with FiLM
   at the scale-shift ResBlocks' shapes, forward and backward; 12b.
   tiny STEDMs with the options (``OPTIONS_12B`` under the cosine schedule
   sampled in bf16, sampled and trained at fp32; the spatial transformer
   under crossattn, sampled) on the card against the CPU; 12c. the
   flagship sampler (256^2, batch 8, DDIM-50, CFG 1.5, phi 0.7) with the
   landscape U-Net under ``OPTIONS_12C`` (scale-shift norm, up/down
   ResBlocks, 32-wide heads): warm img/s and the device time a batch, and
   a 512^2 micro-step of it in bf16 and at fp32;
   12d. ``train_diff.main`` (2 micro-steps) and ``predict_diff.main`` (8
   pairs, DDIM-20) with the spatial transformer, U-Net dropout 0.1,
   crossattn, the cosine schedule and ``+adamw_m_bf16``, then
   ``train_ae.main`` (2 steps) with codec dropout 0.1; 12e. the two entry
   points with 12c's U-Net (the Dh-32 kernels at batch 2, and 4 under
   predict's CFG), since the spatial transformer replaces every flash
   launch of the U-Net;
13. every head dimension up to 512 (``ops/blocked_attention.py``:
   ``head_dim_plan``), on phase 6's tree: 13a. the bf16 backward's Dh-32
   instance (``flash_bwd_small<32>``, 256 keys a block) at 12c's and
   train_diff's micro-step shapes, and the four flash kernels at Dh 16
   (``num_head_channels: 16``, on each kernel's Dh-32 instance; launches
   counted as ``<kernel>_dh16``) at the sampling and
   512^2 micro-step shapes, timed beside their plain versions, SDPA and
   their bounds, with phase 2b's and 10a's tolerances; then correctness,
   each timed once: Dh 20 (bf16: zero-padded copies of width 24), 48, 96
   and 160 through all four kernels, 192, 320, 384 and 448 through the
   bf16 backward (padded instances: a cluster rank's whole column slice
   may be zero fill); 13b. the tiny STEDM at ``num_head_channels: 16``
   card against CPU: a bf16 sample (phase 3's tolerance) and, at fp32,
   a sample and three micro-steps (10b's); 13c. ``train_diff.main`` (2
   micro-steps) and ``predict_diff.main`` (8 pairs, DDIM-20) with phase
   6's config and ``+diffusion.unet_config.params.num_head_channels=16``
   (64 heads of 16 at the bottleneck), samples/s and pairs/s; 13d.
   ``predict_diff.main`` with ``num_heads=1`` (Dh 1024: the forward's
   cluster instance, counted as ``flash_attention_dh1024``), 4 pairs at
   DDIM-4, on 13c's checkpoint, the same model's flash override reaching
   its AttentionBlocks, and above the cluster instances, on tiny tensors:
   the codec's AttnBlockVQ at 1152 channels launches the band kernel on
   the card and matches the CPU, and at Dh 1152, 2048 and 4096 ``sdpa``
   under each impl, ``flash_attention`` with its gradient and AttnBlockVQ
   launch the band kernels, no plain version on a CUDA tensor;
14. the flash kernels above Dh 512 (thread-block clusters of Dh / 128, up
   to 8), on phase 6's tree: 14a. the clusters each instance holds at
   once; the Dh-1024 instances against their plain versions with phase 2's,
   2b's and 10a's checks at the one-head U-Net's sampling and 512^2
   training shapes and the 1024-wide codec's 512^2 mid-block (the bf16
   forward at ``[16, 1, 256, 1024]``, ``[8, 1, 1024, 1024]``, ``[2, 1,
   16384, 1024]``, the backward at the last two, fp32 at ``[8, 1, 1024,
   1024]`` and ``[2, 1, 4096, 1024]``), timed beside the plain versions,
   SDPA (its backend named) and the bound; Dh 520, 576, 640, 768 and 896
   at ``[2, 4, 320, Dh]`` through all four kernels, each timed once; 14b.
   ``train_diff.main`` (2 micro-steps at 512^2) and ``predict_diff.main``
   (4 pairs, DDIM-4) at ``num_heads=1``, bf16; 14c. the same at fp32 (one
   micro-step); 14d. ``train_ae.main`` (2 steps and the val decode) with
   ``ddconfig.ch_mult=[1,2,8]`` (the mid-block 1024 wide, T 16384 at
   512^2). Each path must launch its Dh-1024 kernels
   (``<kernel>_dh1024``) and no plain attention;
15. the band route above Dh 1024 (``ops/flash_band.py``, ``csrc/flash_band.cu``:
   tiled products over bands of rows with fused epilogues), on phase 6's
   tree: 15a. the four band kernels (bf16 and fp32, forward and backward)
   at Dh 1100 (bf16 copies of width 1104), 1152, 1536 and 2048 at ``[2, 4,
   320, Dh]`` (each timed once), then at the one-head U-Net's ``[16, 1,
   256, 2048]``, the 2048-wide codec's ``[2, 1, 4096, 2048]`` and ``[2, 1,
   16384, 2048]``, and ``[2, 1, 1024, 4096]``, against their plain versions
   (bf16 2^-7, fp32 2^-16 against float64), two backward launches bit for
   bit, timed beside the plain route on the card, SDPA (its backend named)
   and the bound; the band route against the cluster instances at ``[2, 1,
   16384, 1024]`` (a record; the wrappers keep the cluster there); 15b.
   ``train_diff.main`` (2 micro-steps; fp32 one) and ``predict_diff.main``
   (4 pairs, DDIM-4) at ``num_heads=1`` and ``channel_mult=[1,4,16]``
   (Dh 2048 at the bottleneck), bf16 and fp32; 15c. ``train_ae.main`` (2
   steps and the val decode) with ``ddconfig.ch_mult=[1,2,16]`` at 256^2
   (the mid-block 2048 wide, T 4096). Each path must launch the band
   kernels and no plain version on a CUDA tensor;
16. a ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

fp32 matrix products and convolutions run without TF32 here (both backend
flags are set False) so the fp32 plain versions are exact references.

``--out DIR`` (default ``build/chip_smoke``, git-ignored) receives the nvcc
log, the profile tables, the whole standard output (``chip_smoke.log``) and
each kernel's record with its shapes and its launches on every path
(``kernels.json``; the kernels line holds the summary).
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense): HBM rate, bf16 tensor-core and fp32 peaks
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


LOG_FILE: Path | None = None     # set by main(): <out>/chip_smoke.log


def log(msg: str) -> None:
    print(msg, flush=True)
    if LOG_FILE is not None:
        with LOG_FILE.open("a") as f:
            f.write(msg + "\n")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def prune_results(entry_root: Path, keep=("data",)) -> None:
    """Removes the result directories under phase 6's tree that no later run
    reads (everything but ``keep``), so that the checkpoints the next runs
    write reuse their blocks: the card machine's disk takes a bounded total
    of writes (45 GiB), and phase 14's checkpoints took it past that while
    phases 6-12's 37 GiB of results stayed."""
    gone = 0
    for d in sorted(entry_root.iterdir()):
        if d.name not in keep and d.is_dir():
            gone += sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
            shutil.rmtree(d)
    log(f"  removed the earlier runs' result directories under {entry_root.name}/ "
        f"({gone / 2 ** 30:.2f} GiB)")


def time_ms(fn, iters: int, flush=None) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` launches, each timed
    with CUDA events after the L2 was flushed (``flush``), after 2 warm-ups.
    The card is kept busy for about half a millisecond before the first
    event, so that the host has queued ``fn``'s launches by the time the
    card reaches them: the events then bracket device time, not the host's
    path through the wrapper."""
    import torch

    spin = int(0.5e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3)
    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# phase 10's paths, each a call whose launches are zeroed just before and
# read just after: the fp32 ones, and the wide-codebook codec runs (bf16, as
# config_ae.yaml computes)
PATHS_F32 = ("f32_sample_batch", "f32_train_micro_step", "f32_codec_step", "f32_entry_ae",
             "f32_entry_train", "f32_entry_predict")
PATHS_WIDE = ("wide4_entry_ae", "wide8_entry_ae")
# phase 12's paths: the options' flagship sampler and 512^2 micro-step, the
# entry points with the spatial transformer (12d) and at Dh 32 (12e), bf16;
# the options' 512^2 micro-step at fp32
PATHS_12 = ("opt_sample_batch", "opt_train_micro_step", "opt_entry_train", "opt_entry_predict",
            "opt_entry_ae", "opt_dh32_entry_train", "opt_dh32_entry_predict")
PATHS_12_F32 = ("opt_f32_train_micro_step",)
# phase 13's paths: the entry points at num_head_channels 16 (13c), the
# tiny fp32 sample and micro-steps at Dh 16 (13b), predict at Dh 1024 (13d)
PATHS_13 = ("dh16_entry_train", "dh16_entry_predict")
PATH_13_F32 = "dh16_f32_tiny"
PATH_13D = "dh1024_entry_predict"
# phase 14's: the entry points at num_heads 1 (14b), at fp32 (14c), and
# train_ae with a 1024-wide codec mid-block (14d)
PATHS_14 = ("dh1024_train", "dh1024_predict")
PATHS_14_F32 = ("dh1024_f32_train", "dh1024_f32_predict")
PATH_14_AE = "dh1024_entry_ae"
# phase 15's: the entry points at num_heads 1 and channel_mult [1, 4, 16]
# (15b, bf16 and fp32), train_ae with a 2048-wide codec mid-block (15c)
PATHS_15 = ("dh2048_train", "dh2048_predict")
PATHS_15_F32 = ("dh2048_f32_train", "dh2048_f32_predict")
PATH_15_AE = "dh2048_entry_ae"


# ptxas's notes that wgmma instructions were serialised
SERIALISED = ("C7512", "C7514", "C7520")

# the keys of each kernel on the kernels line
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms")


class KernelRecord:
    """Per-kernel sums over the checked shapes plus each shape's numbers."""

    # the bf16 paths of phases 4-9, then phase 10's
    PATHS_BF16 = ("sample_batch", "serving_batch", "train_micro_step", "codec_step",
                  "entry_train", "entry_predict_exact", "entry_predict_serving",
                  "seg_train_step", "seg_entry", "her2_ae", "her2_train", "her2_predict_exact",
                  "her2_predict_serving", "her2_seg", "catch_train", "catch_seg", "plms_batch",
                  "dpm_batch", "canvas_predict", "svit_train", "svit_predict", "handoff_ae",
                  "handoff_train", "handoff_predict", "dist_train", "dist_predict")
    PATHS = (PATHS_BF16 + PATHS_F32 + PATHS_WIDE + PATHS_12 + PATHS_12_F32 + PATHS_13
             + (PATH_13_F32, PATH_13D) + PATHS_14 + PATHS_14_F32 + (PATH_14_AE,) + PATHS_15
             + PATHS_15_F32 + (PATH_15_AE,))

    def __init__(self, name, route, source, replaces, counter=None, paths=PATHS_BF16):
        # the launch counter the kernel's wrapper adds to, and the main paths
        # on which that counter counts this kernel alone
        self.counter, self.paths = counter or name, paths
        self.entry = dict(name=name, route=route, source=source, replaces=replaces,
                          launches=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                          bound_ms=0.0, bound_by="bytes", library_ms=0.0, shapes=[])
        self._bound_split = {"bytes": 0.0, "operations": 0.0}

    def add(self, shape, err, tol_ok, ms, plain_ms, library_ms, nbytes, ops, peak):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / peak * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        e = self.entry
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["ms"] += ms
        e["plain_ms"] += plain_ms
        e["library_ms"] += library_ms
        e["bound_ms"] += bound
        self._bound_split[by] += bound
        e["bound_by"] = max(self._bound_split, key=self._bound_split.get)
        e["shapes"].append(dict(shape=list(shape), max_abs_err=err, within_tol=tol_ok,
                                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=bound, bound_by=by))
        log(f"  {e['name']} {list(shape)}: max_abs_err={err:.3e} "
            f"{'ok' if tol_ok else 'OUT OF TOLERANCE'}  kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={bound:.4f} ({by})")
        require(tol_ok, f"{e['name']} disagrees with its plain version at {list(shape)}")


def kernel_records() -> dict:
    """A record for every kernel of the kernels line, with the paths on
    which its counter counts it alone."""
    stock_flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    bf16, f32, wide = KernelRecord.PATHS_BF16, PATHS_F32, PATHS_WIDE
    return {
        "gn_silu": KernelRecord("gn_silu", "cuda", "stedm_tpu_torch/csrc/gn_silu.cu",
                                "stedm_tpu/ops/gn_silu.py:125", paths=bf16 + wide),
        "flash_attention": KernelRecord(
            "flash_attention", "cuda", "stedm_tpu_torch/csrc/flash_attention.cu",
            "stedm_tpu/ops/blocked_attention.py:99", paths=bf16 + wide),
        # the backward's two instances share one counter: every backward of
        # diffusion training is at Dh 64/128 and every one of codec
        # fine-tuning at Dh 512 (a cluster of four blocks a key tile)
        "flash_attention_bwd": KernelRecord(
            "flash_attention_bwd", "cuda", "stedm_tpu_torch/csrc/flash_attention_bwd.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq)", paths=("sample_batch", "train_micro_step",
                                                "entry_train", "her2_train", "catch_train",
                                                "svit_train", "handoff_train",
                                                "dist_train")),
        "flash_attention_bwd_dh512": KernelRecord(
            "flash_attention_bwd_dh512", "cuda", "stedm_tpu_torch/csrc/flash_attention_bwd.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq), reached through stedm_tpu/models/vq.py:89",
            counter="flash_attention_bwd", paths=("codec_step", "her2_ae", "handoff_ae") + wide),
        "nearest_code": KernelRecord("nearest_code", "cuda",
                                     "stedm_tpu_torch/csrc/nearest_code.cu",
                                     "stedm_tpu/ops/quantize.py:62", paths=bf16 + f32),
        # phase 10's kernels: the fp32 flash forward and backward, GN+SiLU at
        # fp32 (the same kernel and counter, its fp32 shapes), and the
        # streaming nearest code of any width and codebook size
        "flash_attention_f32": KernelRecord(
            "flash_attention_f32", "cuda", "stedm_tpu_torch/csrc/flash_attention_f32.cu",
            f"{stock_flash}:589 (_flash_attention_impl), reached through "
            "stedm_tpu/ops/blocked_attention.py:99 and stedm_tpu/models/vq.py:89", paths=f32),
        "flash_attention_bwd_f32": KernelRecord(
            "flash_attention_bwd_f32", "cuda", "stedm_tpu_torch/csrc/flash_attention_bwd_f32.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq)", paths=("f32_train_micro_step", "f32_codec_step",
                                                "f32_entry_ae", "f32_entry_train")),
        "gn_silu_f32": KernelRecord("gn_silu_f32", "cuda", "stedm_tpu_torch/csrc/gn_silu.cu",
                                    "stedm_tpu/ops/gn_silu.py:125", counter="gn_silu", paths=f32),
        "nearest_code_stream": KernelRecord(
            "nearest_code_stream", "cuda", "stedm_tpu_torch/csrc/nearest_code.cu",
            "stedm_tpu/ops/quantize.py:62", paths=wide),
        # phase 12's kernels: each flash kernel at Dh 32 (num_head_channels
        # 32; each kernel's own Dh-32 instance; counted apart: ops.LAUNCHES
        # "<name>_dh32") and GroupNorm with FiLM (use_scale_shift_norm,
        # counted apart: "gn_silu_film")
        "flash_attention_dh32": KernelRecord(
            "flash_attention_dh32", "cuda", "stedm_tpu_torch/csrc/flash_attention.cu",
            "stedm_tpu/ops/blocked_attention.py:99", paths=PATHS_12),
        "flash_attention_bwd_dh32": KernelRecord(
            "flash_attention_bwd_dh32", "cuda", "stedm_tpu_torch/csrc/flash_attention_bwd.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq)", paths=PATHS_12),
        "flash_attention_f32_dh32": KernelRecord(
            "flash_attention_f32_dh32", "cuda", "stedm_tpu_torch/csrc/flash_attention_f32.cu",
            f"{stock_flash}:589 (_flash_attention_impl), reached through "
            "stedm_tpu/ops/blocked_attention.py:99", paths=PATHS_12_F32),
        "flash_attention_bwd_f32_dh32": KernelRecord(
            "flash_attention_bwd_f32_dh32", "cuda",
            "stedm_tpu_torch/csrc/flash_attention_bwd_f32.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq)", paths=PATHS_12_F32),
        "gn_silu_film": KernelRecord("gn_silu_film", "cuda", "stedm_tpu_torch/csrc/gn_silu.cu",
                                     "stedm_tpu/ops/gn_silu.py:125", paths=PATHS_12),
        # phase 13's: each flash kernel at Dh 16 (num_head_channels 16, on
        # each kernel's Dh-32 instance, reading 16 columns; counted apart:
        # "<name>_dh16")
        "flash_attention_dh16": KernelRecord(
            "flash_attention_dh16", "cuda", "stedm_tpu_torch/csrc/flash_attention.cu",
            "stedm_tpu/ops/blocked_attention.py:99", paths=PATHS_13),
        "flash_attention_bwd_dh16": KernelRecord(
            "flash_attention_bwd_dh16", "cuda", "stedm_tpu_torch/csrc/flash_attention_bwd.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq)", paths=PATHS_13),
        "flash_attention_f32_dh16": KernelRecord(
            "flash_attention_f32_dh16", "cuda", "stedm_tpu_torch/csrc/flash_attention_f32.cu",
            f"{stock_flash}:589 (_flash_attention_impl), reached through "
            "stedm_tpu/ops/blocked_attention.py:99", paths=(PATH_13_F32,)),
        "flash_attention_bwd_f32_dh16": KernelRecord(
            "flash_attention_bwd_f32_dh16", "cuda",
            "stedm_tpu_torch/csrc/flash_attention_bwd_f32.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq)", paths=(PATH_13_F32,)),
        # phase 14's: each flash kernel at Dh 1024 (the landscape U-Net at
        # num_heads 1, a codec whose mid-block is 1024 wide), on a cluster of
        # eight 128-column blocks; counted apart: "<name>_dh1024"
        "flash_attention_dh1024": KernelRecord(
            "flash_attention_dh1024", "cuda", "stedm_tpu_torch/csrc/flash_attention.cu",
            "stedm_tpu/ops/blocked_attention.py:99 and stedm_tpu/models/vq.py:89",
            paths=(PATH_13D,) + PATHS_14 + (PATH_14_AE,)),
        "flash_attention_bwd_dh1024": KernelRecord(
            "flash_attention_bwd_dh1024", "cuda", "stedm_tpu_torch/csrc/flash_attention_bwd.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq)", paths=("dh1024_train", PATH_14_AE)),
        "flash_attention_f32_dh1024": KernelRecord(
            "flash_attention_f32_dh1024", "cuda", "stedm_tpu_torch/csrc/flash_attention_f32.cu",
            f"{stock_flash}:589 (_flash_attention_impl), reached through "
            "stedm_tpu/ops/blocked_attention.py:99", paths=PATHS_14_F32),
        "flash_attention_bwd_f32_dh1024": KernelRecord(
            "flash_attention_bwd_f32_dh1024", "cuda",
            "stedm_tpu_torch/csrc/flash_attention_bwd_f32.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq)", paths=("dh1024_f32_train",)),
        # phase 15's: the band route above Dh 1024 (csrc/flash_band.cu; the
        # one-head U-Net at channel_mult [1, 4, 16], a 2048-wide codec
        # mid-block), each kernel counted under its own name
        "flash_band": KernelRecord(
            "flash_band", "cuda", "stedm_tpu_torch/csrc/flash_band.cu",
            f"{stock_flash}:589 (_flash_attention_impl), reached through "
            "stedm_tpu/ops/blocked_attention.py:99 and stedm_tpu/models/vq.py:89",
            paths=PATHS_15 + (PATH_15_AE,)),
        "flash_band_bwd": KernelRecord(
            "flash_band_bwd", "cuda", "stedm_tpu_torch/csrc/flash_band.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq)", paths=(PATHS_15[0], PATH_15_AE)),
        "flash_band_f32": KernelRecord(
            "flash_band_f32", "cuda", "stedm_tpu_torch/csrc/flash_band.cu",
            f"{stock_flash}:589 (_flash_attention_impl), reached through "
            "stedm_tpu/ops/blocked_attention.py:99", paths=PATHS_15_F32),
        "flash_band_bwd_f32": KernelRecord(
            "flash_band_bwd_f32", "cuda", "stedm_tpu_torch/csrc/flash_band.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq)", paths=(PATHS_15_F32[0],)),
    }


def bf16_close(got, ref, rel: float, abs_: float):
    """max |got - ref| and whether every element is within rel*|ref| + abs."""
    d = (got.float() - ref.float()).abs()
    return float(d.max()), bool((d <= rel * ref.float().abs() + abs_).all())


def check_gn(torch, rec, flush, cases=None):
    from stedm_tpu_torch.ops import gn_silu as g

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = cases or [  # (shape NHWC, mode, eps)
        # sampling at 256^2: U-Net level 0, decoder concats, bottleneck, VQ decoder
        ((8, 64, 64, 128), "add", 1e-5), ((16, 64, 64, 640), "add", 1e-5),
        ((16, 16, 16, 1536), "add", 1e-5), ((16, 8, 8, 2048), "add", 1e-5),
        ((16, 8, 8, 1024), "film", 1e-5), ((8, 256, 256, 256), "plain", 1e-6),
        # training at 512^2: U-Net level 0 and bottleneck, VQ encoder levels 0 and 2
        ((8, 128, 128, 128), "add", 1e-5), ((8, 32, 32, 1024), "add", 1e-5),
        ((8, 32, 32, 1024), "film", 1e-5), ((8, 512, 512, 128), "plain", 1e-6),
        ((8, 128, 128, 512), "plain", 1e-6),
        # the entry points at 512^2, batch 2: U-Net level 0, the CFG fan-out's
        # decoder concat and bottleneck FiLM (batch 4), VQ levels 0 and 2
        ((2, 128, 128, 128), "add", 1e-5), ((4, 128, 128, 256), "add", 1e-5),
        ((4, 32, 32, 1024), "film", 1e-5), ((2, 512, 512, 128), "plain", 1e-6),
        ((2, 128, 128, 512), "plain", 1e-6)]
    for shape, mode, eps in cases:
        b, c = shape[0], shape[3]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
        vec = lambda: 0.5 * torch.randn(b, c, generator=gen, device="cuda").to(torch.bfloat16)
        kw = dict(eps=eps)
        if mode == "add":
            kw["add"] = vec()
        elif mode == "film":
            kw["film_scale"], kw["film_shift"] = vec(), vec()
        got = g.gn_silu_cuda(x, gamma, beta, **kw)
        ref = g.gn_silu_reference(x, gamma, beta, **kw)
        torch.cuda.synchronize()
        # bf16 output: the two may round to neighbouring bf16 values (2^-7 relative)
        err, ok = bf16_close(got, ref, rel=2 ** -7, abs_=2 ** -9)
        ms = time_ms(lambda: g.gn_silu_cuda(x, gamma, beta, **kw), 10, flush)
        pms = time_ms(lambda: g.gn_silu_reference(x, gamma, beta, **kw), 3, flush)
        xc = x.permute(0, 3, 1, 2)
        lib = time_ms(lambda: torch.nn.functional.silu(
            torch.nn.functional.group_norm(xc, 32, gamma.to(x.dtype), beta.to(x.dtype), eps)),
            10, flush)
        numel = x.numel()
        nbytes = 2 * numel * 2 + 4 * 2 * c + (2 * b * c * 2 if mode != "plain" else 0)
        rec.add(shape, err, ok, ms, pms, lib, nbytes, 10 * numel, FP32_FLOPS)


def _attention_close(torch, got, q, k, v, s):
    """max |got - attention_reference| and whether every element is within tolerance."""
    from stedm_tpu_torch.ops import blocked_attention as a

    ref = a.attention_reference(q, k, v, s)
    # both round P and the output to bf16 (P unnormalised in the kernel,
    # normalised in the plain version): each is within 2^-9 (P |V| + |o|)
    # of the exact value, so they differ by at most 2^-8 of it; 2x margin
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * s, dim=-1)
    scale = p @ v.float().abs() + ref.float().abs()
    del p
    d = (got.float() - ref.float()).abs()
    return float(d.max()), bool((d <= 2 ** -7 * scale).all())


# U-Net bottleneck and VQ decoder at 256^2 (sampling); the U-Net bottleneck
# and the VQ encoder at 512^2 (training: the first with the LSE, the second
# the frozen encode, batch 8); a ragged T and the head dimension between
# and the entry points' bottleneck (predict's CFG fan-out, training) and
# VQ mid-block at 512^2, batch 2
ATTENTION_SHAPES = ((16, 8, 256, 128), (8, 1, 4096, 512), (8, 8, 1024, 128), (8, 1, 16384, 512),
                    (2, 4, 200, 64), (2, 2, 520, 256), (4, 8, 1024, 128), (2, 8, 1024, 128),
                    (2, 1, 16384, 512))


def check_attention(torch, rec, flush, shapes=ATTENTION_SHAPES, strided=True):
    from stedm_tpu_torch.ops import blocked_attention as a

    gen = torch.Generator(device="cuda").manual_seed(2)
    for shape in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        s = shape[-1] ** -0.5
        got = a.flash_attention_cuda(q, k, v, s)
        torch.cuda.synchronize()
        # one sample at a time: the fp32 logits of the whole VQ-encoder batch take 8.6 GB
        err, ok = 0.0, True
        for i in range(shape[0]):
            e, o = _attention_close(torch, got[i:i + 1], q[i:i + 1], k[i:i + 1], v[i:i + 1], s)
            err, ok = max(err, e), ok and o
        iters = 10 if shape[2] <= 1024 else 3
        ms = time_ms(lambda: a.flash_attention_cuda(q, k, v, s), iters, flush)
        ms_lse = time_ms(lambda: a.flash_attention_cuda(q, k, v, s, return_lse=True), iters,
                         flush)
        log(f"  flash_attention {list(shape)}: kernel_ms {ms:.4f} without LSE (sampling), "
            f"{ms_lse:.4f} writing LSE (training)")
        pms = time_ms(lambda: a.attention_reference(q, k, v, s), 3, flush)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=s), iters, flush)
        bh, t, d = shape[0] * shape[1], shape[2], shape[3]
        rec.add(shape, err, ok, ms, pms, lib, 4 * bh * t * d * 2, 4 * bh * t * t * d,
                BF16_FLOPS)
    if not strided:
        return
    # the layout the U-Net's AttentionBlock hands over: q, k, v as views of
    # the packed projection, O written token-major so that merging the heads
    # is a view; the same kernel on contiguous copies must give the same bits
    proj = torch.randn((16, 256, 8, 3, 128), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = proj.permute(0, 2, 3, 1, 4).unbind(2)
    s = 128 ** -0.5
    out = torch.empty((16, 256, 8, 128), device="cuda", dtype=torch.bfloat16).permute(0, 2, 1, 3)
    got = a.flash_attention_cuda(q, k, v, s, out=out)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    same = torch.equal(got, a.flash_attention_cuda(qc, kc, vc, s))
    merged = got.transpose(1, 2).reshape(16, 256, 8 * 128)
    is_view = merged.data_ptr() == got.data_ptr() and merged.is_contiguous()
    ms = time_ms(lambda: a.flash_attention_cuda(q, k, v, s, out=out), 10, flush)
    ms_copies = time_ms(lambda: a.flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), s).transpose(1, 2).reshape(16, 256, 1024),
        10, flush)
    log(f"  flash_attention strided [16, 8, 256, 128] (views of a [16, 256, 8, 3, 128] "
        f"projection, O laid out [16, 256, 8, 128]): equal to the contiguous launch bit for "
        f"bit: {same}; merging the heads is a view: {is_view}; kernel_ms {ms:.4f} against "
        f"{ms_copies:.4f} with the three copies in and the one out")
    require(same, "the strided launch differs from the contiguous one")
    require(is_view, "the token-major output does not merge its heads as a view")


def check_nearest(torch, rec, flush):
    gen = torch.Generator(device="cuda").manual_seed(3)
    n_embed = 8192
    for n in (8 * 64 * 64, 2 * 128 * 128):     # the flagship batch; the entry points' 512^2
        _check_nearest_at(torch, rec, flush, gen, n, n_embed)


def _check_nearest_at(torch, rec, flush, gen, n: int, n_embed: int):
    from stedm_tpu_torch.ops import quantize as qz

    z = torch.randn(n, 3, generator=gen, device="cuda")
    cb = torch.randn(n_embed, 3, generator=gen, device="cuda")
    got = qz.nearest_code_cuda(z, cb)
    ref = qz.nearest_code_reference(z, cb)
    torch.cuda.synchronize()
    # equal indices, except where the two best distances tie within fp32 rounding
    diff = (got != ref).nonzero().flatten()
    z64, cb64 = z.double(), cb.double()
    d_got = ((z64[diff] - cb64[got[diff].long()]) ** 2).sum(1)
    d_ref = ((z64[diff] - cb64[ref[diff].long()]) ** 2).sum(1)
    tol = 1e-5 * (1 + (z64[diff] ** 2).sum(1))
    err = float((d_got - d_ref).abs().max()) if diff.numel() else 0.0
    ok = bool(((d_got - d_ref).abs() <= tol).all()) and diff.numel() <= n // 1000
    log(f"  nearest_code: {diff.numel()} of {n} indices differ (fp32 near-ties)")
    ms = time_ms(lambda: qz.nearest_code_cuda(z, cb), 10, flush)
    pms = time_ms(lambda: qz.nearest_code_reference(z, cb), 3, flush)
    lib = time_ms(lambda: torch.cdist(z, cb).argmin(dim=1), 3, flush)
    rec.add((n, n_embed), err, ok, ms, pms, lib, 12 * n + 12 * n_embed + 4 * n,
            7 * n * n_embed, FP32_FLOPS)
    # the kernel's own floor, a model and not a measurement (so it stays out
    # of the kernels line): 7 issue slots a (token, code) pair (3 multiplies,
    # 2 adds, a fused multiply-add, a minimum) over 4 schedulers of 32 lanes
    # an SM at the card's highest clock; the clock under load:
    # tools/torch_nearest_code_variants.py
    props = torch.cuda.get_device_properties(0)
    floor = 7 * n * n_embed / (props.multi_processor_count * 4 * 32 * props.clock_rate * 1e3) * 1e3
    log(f"  nearest_code issue-slot floor {floor:.4f} ms (modelled: {props.multi_processor_count} "
        f"SMs at the card's highest clock, {props.clock_rate / 1e3:.0f} MHz)")


def host_us_per_call(torch, fn, calls: int = 200) -> float:
    """Host time of one wrapper call in microseconds, with the card kept busy
    (a long sleep kernel ahead of the calls) so that the launches queue and
    the clock reads the wrapper's own path: checks, plan lookup, ctypes."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(50e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3))
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def wrapper_host_times(torch) -> dict:
    from stedm_tpu_torch.ops import gn_silu as g
    from stedm_tpu_torch.ops import quantize as qz

    x = torch.randn(16, 8, 8, 2048, device="cuda").to(torch.bfloat16)
    gamma, beta = torch.ones(2048, device="cuda"), torch.zeros(2048, device="cuda")
    add = torch.randn(16, 2048, device="cuda").to(torch.bfloat16)
    z, cb = torch.randn(32768, 3, device="cuda"), torch.randn(8192, 3, device="cuda")
    times = {"gn_silu": host_us_per_call(torch, lambda: g.gn_silu(x, gamma, beta, add=add)),
             "nearest_code": host_us_per_call(torch, lambda: qz.nearest_code(z, cb)),
             "torch silu (one ATen launch)": host_us_per_call(
                 torch, lambda: torch.nn.functional.silu(x))}
    log("  host time a wrapper call, card busy: " + ", ".join(
        f"{k} {v:.1f} us" for k, v in times.items()) + " ([16, 8^2, 2048] add; N 32768 x 8192)")
    return times


class GNCallLog:
    """Records the shape and mode of every GN kernel launch while active, by
    standing in for ``gn_silu_cuda`` in its module (the wrappers look it up
    at call time)."""

    def __init__(self):
        from stedm_tpu_torch.ops import gn_silu as g

        self.module, self.calls = g, {}

    def __enter__(self):
        launch = self.original = self.module.gn_silu_cuda

        def recorded(x, gamma, beta, add=None, film_scale=None, film_shift=None, **kw):
            mode = "add" if add is not None else "film" if film_scale is not None else "plain"
            vec = (add if add is not None else film_scale)
            key = (tuple(x.shape), mode, x.element_size(),
                   0 if vec is None else vec.element_size(), gamma.element_size())
            self.calls[key] = self.calls.get(key, 0) + 1
            return launch(x, gamma, beta, add, film_scale, film_shift, **kw)

        self.module.gn_silu_cuda = recorded
        return self

    def __exit__(self, *exc):
        self.module.gn_silu_cuda = self.original

    def report(self) -> float:
        """Logs the calls by shape with each one's bound (x read, y written,
        gamma, beta and the vectors read once) and returns the sum of the
        bounds in ms."""
        total = 0.0
        for (shape, mode, es, vs, ps), n in sorted(self.calls.items(), key=lambda kv: -kv[1]):
            b, c = shape[0], shape[3]
            numel = b * shape[1] * shape[2] * c
            nbytes = 2 * numel * es + 2 * c * ps + {"plain": 0, "add": 1, "film": 2}[mode] * b * c * vs
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            total += n * bound
            log(f"    gn_silu {list(shape)} {mode}: {n} calls x bound {bound:.4f} ms")
        log(f"  GN calls of one sampled batch: {sum(self.calls.values())}, sum of their bounds "
            f"{total:.3f} ms (the yardstick of the gn_silu category)")
        return total


# phase 3's and 3d's tolerance, card (kernels, bf16) against CPU (plain
# versions, bf16): mean and max absolute error of the images. bf16
# activations, other conv algorithms and summation orders on the two
# devices, through the U-Net passes and the decoder
TINY_TOL = (1e-2, 0.125)


def _tiny_sampling_models(torch, dtype=None, unet_options=None, conditioning_key="hybrid",
                          schedule: str = "linear"):
    """Phase 3's tiny STEDM on the CPU and a copy on the card (computing in
    ``dtype``, bf16 unless given; phase 12b: with ``unet_options``,
    ``conditioning_key`` and ``schedule``), its batch, x_T and the schedule."""
    from stedm_tpu_torch.core.schedules import DiffusionSchedule
    from stedm_tpu_torch.models.stedm import STEDM

    p = 32
    dtype = dtype or torch.bfloat16
    torch.manual_seed(4)
    cfg = _tiny_configs(p, unet_options, conditioning_key)
    cpu = STEDM(dtype=dtype, **cfg).eval()
    with torch.no_grad():
        for prm in cpu.parameters():
            if prm.dim() == 4:
                prm.add_(0.005)
    gpu = STEDM(dtype=dtype, **cfg).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu.cuda()
    gen = torch.Generator().manual_seed(5)
    seg = torch.zeros(2, p, p, 2)
    seg[..., 0] = 1
    seg[:, 8:20, 4:28] = torch.tensor([0.0, 1.0])
    batch = {"segmentation": seg, "style_imgs": torch.rand(2, 1, p, p, 3, generator=gen) * 2 - 1}
    x_T = torch.randn(2, p // 4, p // 4, 3, generator=gen)
    return cpu, gpu, batch, x_T, DiffusionSchedule.create(schedule, 1000, 0.0015, 0.0205)


def sample_with_latent(sampler, model, batch, **kw):
    """``sampler``'s images and the latent z_0 it handed the decoder: the
    trajectory's own result, which a saturated or quantizing decode hides."""
    seen, decode = [], model.decode_first_stage
    model.decode_first_stage = lambda z, *a: (seen.append(z.clone()), decode(z, *a))[1]
    try:
        img = sampler(model, batch, **kw)
    finally:
        del model.decode_first_stage
    return img, seen[0].float()


def inside_clamp(img) -> float:
    """The share of pixels strictly inside the decoder's [-1, 1] clamp."""
    return float((img.abs() < 1.0).float().mean())


def _tiny_close(torch, got, ref, what: str) -> None:
    d = (got.float().cpu() - ref.float()).abs()
    mean_err, max_err = float(d.mean()), float(d.max())
    ok = bool(torch.isfinite(got).all()) and mean_err <= TINY_TOL[0] and max_err <= TINY_TOL[1]
    log(f"  {what}: mean_abs_err={mean_err:.3e} max_abs_err={max_err:.3e} (tolerance mean "
        f"{TINY_TOL[0]}, max {TINY_TOL[1]}) {'ok' if ok else 'FAILED'}")
    require(ok, f"{what}: the card disagrees with the CPU reference")


def tiny_parity(torch):
    """A tiny STEDM, DDIM-4 with rescaled CFG, bf16: card (kernels) against
    CPU (plain versions), same weights and x_T."""
    from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn

    cpu, gpu, batch, x_T, sched = _tiny_sampling_models(torch)
    cfg = SamplerConfig(ddim_steps=4, eta=0.0, cfg_scale=1.5, rescale_phi=0.7,
                        batched_cfg=True, downsample=4)
    ref = make_sample_fn(cpu, sched, cfg, device="cpu")(cpu, batch, x_T=x_T)
    got = make_sample_fn(gpu, sched, cfg, device="cuda")(gpu, batch, x_T=x_T)
    _tiny_close(torch, got, ref, "tiny STEDM card vs CPU")


def tiny_serving_parity(torch):
    """Phase 3d: the tiny STEDM in the composed serving mode (refreshes
    (0, 3, 5) of 8 steps, window (0.25, 0.75) with its forced refresh, CFG
    1.5, phi 0.7, bf16), eager and graph-replayed on the card against the
    eager loop on the CPU, same weights and x_T; the latent z_0 of the graph
    replay against the card's eager loop's bit for bit."""
    from stedm_tpu_torch.train.host_sampler import make_host_sample_fn
    from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn

    cpu, gpu, batch, x_T, sched = _tiny_sampling_models(torch)
    cfg = SamplerConfig(ddim_steps=8, eta=0.0, cfg_scale=1.5, rescale_phi=0.7,
                        batched_cfg=True, downsample=4, cache_schedule=(0, 3, 5),
                        cfg_interval=(0.25, 0.75))
    ref, z_ref = sample_with_latent(make_sample_fn(cpu, sched, cfg, device="cpu"), cpu, batch,
                                    x_T=x_T)
    exact = make_sample_fn(cpu, sched, SamplerConfig(
        ddim_steps=8, cfg_scale=1.5, rescale_phi=0.7, downsample=4), device="cpu")(
        cpu, batch, x_T=x_T)
    eager, z_eager = sample_with_latent(make_sample_fn(gpu, sched, cfg), gpu, batch, x_T=x_T)
    host = make_host_sample_fn(gpu, sched, cfg, unroll=3)
    graph, z_graph = sample_with_latent(host, gpu, batch, x_T=x_T)
    log(f"  blocks {host.block_sizes}; the serving image against the exact one on the CPU: "
        f"max |diff| {float((ref - exact).abs().max()):.3e}; pixels inside the clamp "
        f"{inside_clamp(ref):.4f}; latent z_0 card eager vs CPU: relative L2 "
        f"{float((z_eager.cpu() - z_ref).norm() / z_ref.norm()):.3e} (logged)")
    _tiny_close(torch, eager, ref, "tiny serving mode, card eager vs CPU")
    _tiny_close(torch, graph, ref, "tiny serving mode, card graph replay vs CPU")
    same = torch.equal(z_graph, z_eager)
    log(f"  graph replay's latent z_0 equals the card's eager loop's bit for bit: {same} (max "
        f"|diff| {float((z_graph - z_eager).abs().max()):.3e}); images equal: "
        f"{torch.equal(graph, eager)}")
    require(same, "the graph replay's latent differs from the eager loop's on the card")


def _rms_bound(*pairs):
    """sqrt(sum (a b)^2) over each product's terms: the scale of what
    rounding its terms independently moves the sum."""
    return sum(a.float().square() @ b.float().square() for a, b in pairs).sqrt()


def backward_errors(torch, q, k, v, o, lse, do, s, *grad_sets):
    """Phase 2b's test of (dq, dk, dv) sets against the plain backward: P and
    dS round to bf16 on both sides (at most one ulp apart), the fp32 sums run
    in other orders and the outputs round to bf16 (one ulp is at most 2^-7
    |ref|), so each element must lie within 2^-7 (sqrt(sum terms^2) + |ref|).
    For each set, {name: (max |err|, max |err| / tolerance)}."""
    from stedm_tpu_torch.ops import blocked_attention as a

    ref = a.attention_backward_reference(q, k, v, o, lse, do, s)
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * s, -1)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - a._row_dot(do, o)[..., None]) * s
    out = [{} for _ in grad_sets]
    for i, (name, pairs) in enumerate((("dq", ((ds, k),)), ("dk", ((ds.transpose(-1, -2), q),)),
                                       ("dv", ((p.transpose(-1, -2), do),)))):
        tol = 2 ** -7 * (_rms_bound(*pairs) + ref[i].float().abs())
        for res, grads in zip(out, grad_sets):
            diff = (grads[i].float() - ref[i].float()).abs()
            res[name] = (float(diff.max()), float((diff / tol).max()))
        del diff, tol
    return out


def sdpa_backend(torch, q, k, v, s) -> str:
    """The backend that PyTorch's dispatch picks for these SDPA inputs."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, scale=s)).name


def check_attention_backward(torch, rec, flush, shapes, seed):
    """Phase 2b: the backward (Di pass + fused kernel) against the plain
    backward, the forward's LSE against torch.logsumexp; times beside the
    plain backward and the autograd backward of SDPA (all three compute dq,
    dk and dv together)."""
    from stedm_tpu_torch.ops import blocked_attention as a

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for shape in shapes:
        b, h, t, dh = shape
        # q, k, v as the AttentionBlock hands them over: views of one packed
        # [B, T, H, 3, Dh] projection; the output gradient token-major, as it
        # comes back through the head merge
        proj = torch.randn((b, t, h, 3, dh), generator=gen, device="cuda").to(torch.bfloat16)
        qv, kv, vv = proj.permute(0, 2, 3, 1, 4).unbind(2)
        q, k, v = qv.contiguous(), kv.contiguous(), vv.contiguous()
        do_tm = torch.randn((b, t, h, dh), generator=gen, device="cuda").to(torch.bfloat16)
        do = do_tm.permute(0, 2, 1, 3).contiguous()
        s = dh ** -0.5
        o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
        logits = (q.float() @ k.float().transpose(-1, -2)) * s
        lse_ref = torch.logsumexp(logits, -1)
        d = (lse - lse_ref).abs()
        lse_ok = bool((d <= 1e-5 * lse_ref.abs() + 1e-4).all())
        log(f"  forward LSE {list(shape)}: max_abs_err={float(d.max()):.3e} (tolerance "
            f"1e-5 rel + 1e-4 abs: fp32 sums in another order) {'ok' if lse_ok else 'FAILED'}")
        require(lse_ok, f"forward LSE disagrees with torch.logsumexp at {list(shape)}")
        o_err, o_ok = _attention_close(torch, o, q, k, v, s)
        log(f"  forward O {list(shape)}: max_abs_err={o_err:.3e} (tolerance 2^-7 (P|V| + |ref|)) "
            f"{'ok' if o_ok else 'OUT OF TOLERANCE'}")
        require(o_ok, f"forward output disagrees with attention_reference at {list(shape)}")
        ws = torch.empty(a.bwd_workspace_bytes(b * h, t, dh), device="cuda", dtype=torch.uint8)
        got = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s, workspace=ws)
        # the Di pass: [BH, nq, 2, 64] of LSE * log2(e) and Di, padded past T
        nq = (t + 63) // 64
        stats = ws[:b * h * nq * 2 * 64 * 4].view(torch.float32).view(b * h, nq, 2, 64)
        stats = stats.transpose(1, 2).reshape(b, h, 2, nq * 64)
        di_ref = a._row_dot(do, o)
        di_err = float((stats[:, :, 1, :t] - di_ref).abs().max())
        di_tol = 1e-5 * float((do.float() * o.float()).abs().sum(-1).max())
        lse2_err = float((stats[:, :, 0, :t] - lse * 1.4426950408889634).abs().max())
        pad_ok = bool((stats[:, :, 1, t:] == 0).all() and torch.isinf(stats[:, :, 0, t:]).all())
        log(f"  Di pass {list(shape)}: Di max_abs_err={di_err:.3e} against _row_dot (tolerance "
            f"{di_tol:.3e}: fp32 sums in another order), LSE*log2(e) {lse2_err:.3e}, padding "
            f"{'ok' if pad_ok else 'WRONG'}")
        require(di_err <= di_tol and lse2_err <= 1e-5 * float(lse.abs().max()) + 1e-6 and pad_ok,
                f"the Di pass disagrees at {list(shape)}")
        again = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
        # the same gradients through FlashAttentionFunction on the strided
        # views, as the model takes them
        leaves = proj.detach().clone().requires_grad_()
        lq, lk, lv = leaves.permute(0, 2, 3, 1, 4).unbind(2)
        out_fn = a.flash_attention(lq, lk, lv, s)
        out_fn.transpose(1, 2).backward(do_tm)
        grads_fn = leaves.grad.permute(0, 2, 3, 1, 4).unbind(2)
        torch.cuda.synchronize()
        # dQ's parts are added in a fixed order: two launches give the same
        # bits, and so do the Function on the views and the direct launch
        run_diff = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, again))
        same = torch.equal(out_fn.detach(), o) and all(
            torch.equal(x, y) for x, y in zip(grads_fn, got))
        del out_fn, leaves, again, logits
        errs, fn_errs = backward_errors(torch, q, k, v, o, lse, do, s, got, grads_fn)
        del grads_fn
        for label, e in (("kernel", errs), ("FlashAttentionFunction (strided views)", fn_errs)):
            log(f"  backward {list(shape)} {label}: " + ", ".join(
                f"{n} max_abs_err={x:.3e} ({r:.3f} of its tolerance) "
                f"{'ok' if r <= 1 else 'OUT OF TOLERANCE'}" for n, (x, r) in e.items())
                + " (tolerance 2^-7 (sqrt(sum terms^2) + |ref|))")
        log(f"  two launches: max |diff| {run_diff:.3e} (run to run); FlashAttentionFunction on "
            f"the strided views equals the direct launch bit for bit: {same}")
        require(run_diff == 0.0, f"two backward launches differ at {list(shape)}")
        require(same and all(r <= 1 for _, r in fn_errs.values()),
                f"FlashAttentionFunction's gradients disagree at {list(shape)}")
        # the kernel and SDPA's backward in turns (kernel, SDPA, SDPA, kernel,
        # kernel, SDPA), before the fp32 plain version; each the fastest of
        # its three turns: a turn now and then reads several times the others
        # (the host's path through the wrapper or autograd outlasting the
        # 0.5 ms head start on a shared host CPU)
        iters = 10 if t <= 4096 else 3
        backend = sdpa_backend(torch, q, k, v, s)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=s)
        kernel = lambda: a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
        library = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
        order = (kernel, library, library, kernel, kernel, library)
        turns = [time_ms(f, iters, flush) for f in order]
        k_turns = [t_ for f, t_ in zip(order, turns) if f is kernel]
        l_turns = [t_ for f, t_ in zip(order, turns) if f is library]
        ms, lib = min(k_turns), min(l_turns)
        del out, leaves
        ms_views = time_ms(lambda: a.flash_attention_bwd_cuda(qv, kv, vv, o, lse, do, s), iters,
                           flush)
        ms_di = time_ms(lambda: a._row_dot(do, o), iters, flush)
        pms = time_ms(lambda: a.attention_backward_reference(q, k, v, o, lse, do, s), 3, flush)
        log(f"  backward {list(shape)}: {ms:.4f} ms (Di pass, fused kernel, dQ conversion; turns "
            + ", ".join(f"{x:.4f}" for x in k_turns) + f") on contiguous q, k, v, {ms_views:.4f} "
            f"ms on the strided views; SDPA's backward ({backend}) {lib:.4f} ms (turns "
            + ", ".join(f"{x:.4f}" for x in l_turns) + f"); Di as a torch expression "
            f"(_row_dot) alone takes {ms_di:.4f} ms")
        n = b * h * t * dh
        # reads q, k, v, o, dO and the LSE, writes dq, dk, dv; the five
        # products 10 BH T^2 Dh flops
        rec.add(shape, max(e for e, _ in errs.values()), all(r <= 1 for _, r in errs.values()), ms,
                pms, lib, 5 * n * 2 + b * h * t * 4 + 3 * n * 2, 10 * b * h * t * t * dh,
                BF16_FLOPS)


def check_gn_backward(torch, flush, cases=(((8, 128, 128, 128), "add"),
                                           ((8, 32, 32, 1024), "add"),
                                           ((8, 32, 32, 1024), "film"))):
    """Phase 2c: GNSiLUFunction on the card (CUDA forward, plain backward)
    against autograd of gn_silu_reference at the 512^2 U-Net training shapes
    (phase 12a: the scale-shift ResBlocks' FiLM shapes)."""
    from stedm_tpu_torch.ops import gn_silu as g

    gen = torch.Generator(device="cuda").manual_seed(7)
    for shape, mode in cases:
        b, c = shape[0], shape[3]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
        names = {"add": ["add"], "film": ["film_scale", "film_shift"]}[mode]
        extra = [(0.5 * torch.randn(b, c, generator=gen, device="cuda")).to(torch.bfloat16)
                 for _ in names]
        dy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

        def graph(fn):
            leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta, *extra)]
            return fn(*leaves[:3], **dict(zip(names, leaves[3:]))), leaves

        y, leaves = graph(g.gn_silu)                 # GNSiLUFunction
        y_ref, leaves_ref = graph(g.gn_silu_reference)
        # the Function's forward output (the CUDA kernel), as check_gn holds it
        y_err, y_ok = bf16_close(y.detach(), y_ref.detach(), rel=2 ** -7, abs_=2 ** -9)
        log(f"  gn_silu forward (GNSiLUFunction) {list(shape)} {mode}: max_abs_err={y_err:.3e} "
            f"{'ok' if y_ok else 'OUT OF TOLERANCE'} (tolerance 2^-7 |ref| + 2^-9)")
        require(y_ok, f"GNSiLUFunction's output disagrees at {list(shape)} {mode}")
        got = torch.autograd.grad(y, leaves, dy, retain_graph=True)
        ref = torch.autograd.grad(y_ref, leaves_ref, dy, retain_graph=True)
        worst, ok = 0.0, True
        for a_, r in zip(got, ref):
            d = (a_.float() - r.float()).abs()
            worst = max(worst, float(d.max()))
            # dx rounds to bf16; the fp32 sums run in other orders
            ok &= bool((d <= 2 ** -7 * r.float().abs() + 1e-3 * r.float().abs().max()).all())
        ms = time_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True), 5, flush)
        ref_ms = time_ms(lambda: torch.autograd.grad(y_ref, leaves_ref, dy, retain_graph=True),
                         5, flush)

        def recompute_grad():                  # what a Function backward by autograd pays
            fresh = [t.detach().requires_grad_() for t in leaves_ref]
            yy = g.gn_silu_reference(*fresh[:3], **dict(zip(names, fresh[3:])))
            return torch.autograd.grad(yy, fresh, dy)

        rec_ms = time_ms(recompute_grad, 5, flush)
        log(f"  gn_silu backward {list(shape)} {mode}: max_abs_err={worst:.3e} "
            f"{'ok' if ok else 'OUT OF TOLERANCE'} (tolerance 2^-7 |ref| + 1e-3 max|ref|); "
            f"ported backward (plain torch, recomputes) {ms:.4f} ms, autograd of the plain "
            f"forward {ref_ms:.4f} ms without its recompute, {rec_ms:.4f} ms with it")
        require(ok, f"GN backward disagrees with autograd at {list(shape)} {mode}")


def _tiny_configs(p: int, unet_options=None, conditioning_key: str = "hybrid") -> dict:
    return dict(
        unet_config=dict(in_channels=6, out_channels=3, model_channels=32,
                         num_res_blocks=1, channel_mult=(1, 4, 8), num_heads=4,
                         attention_resolutions=(32, 16, 8), **(unet_options or {})),
        first_stage_config=dict(embed_dim=3, n_embed=256, ddconfig=dict(
            z_channels=3, resolution=p, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2, 2],
            num_res_blocks=1, attn_resolutions=[])),
        cond_stage_config=dict(n_stages=2, in_channels=2, out_channels=3),
        style_agg="mean", style_sampling="nearby", patch_size=p,
        conditioning_key=conditioning_key)


def _tiny_train_runs(torch, dtype, unet_options=None, schedule: str = "linear") -> dict:
    """The tiny STEDM (Dh 64 at the bottleneck, non-zero proj_out) trained
    for three micro-steps at accumulation 2, computing in ``dtype``, on the
    CPU and on the card, same weights, t and noise: for each device the
    losses, the first micro-step's gradients, the parameters' change and the
    launch counts."""
    from stedm_tpu_torch.core.schedules import DiffusionSchedule
    from stedm_tpu_torch.models.stedm import STEDM
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train.optim import make_optimizer
    from stedm_tpu_torch.train.steps import create_train_state, make_train_step

    p = 32
    torch.manual_seed(8)
    cpu = STEDM(dtype=dtype, **_tiny_configs(p, unet_options))
    for layer in cpu.unet.zero_init_layers():
        layer.reset_parameters()
    gpu = STEDM(dtype=dtype, **_tiny_configs(p, unet_options))
    gpu.load_state_dict(cpu.state_dict())
    gpu.cuda()
    gen = torch.Generator().manual_seed(9)
    seg = torch.zeros(2, p, p, 2)
    seg[..., 0] = 1
    seg[:, 8:20, 4:28] = torch.tensor([0.0, 1.0])
    style = torch.rand(2, 1, p, p, 3, generator=gen) * 2 - 1
    style[1] = -2.0                                  # a constant (dropped) style set
    batch = {"image": torch.rand(2, p, p, 3, generator=gen) * 2 - 1, "segmentation": seg,
             "style_imgs": style}
    draws = [(torch.randint(0, 1000, (2,), generator=gen), torch.randn(2, 8, 8, 3, generator=gen))
             for _ in range(3)]
    sched = DiffusionSchedule.create(schedule, 1000, 0.0015, 0.0205)
    runs = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        before = {k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()}
        tx = make_optimizer(1e-3, accumulate_grad_batches=2)
        state = create_train_state(model, tx)
        step = make_train_step(model, sched, tx, device=dev)
        reset_launch_counts()
        losses, grads = [], None
        for i, (t, noise) in enumerate(draws):
            state, m = step(state, batch, t=t, noise=noise)
            losses.append(float(m["loss"]))
            if i == 0:
                grads = {k: q.grad.float().cpu().clone() for k, q in model.named_parameters()
                         if q.grad is not None}
        counts = dict(LAUNCHES)
        after = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
        runs[dev] = (losses, grads, {k: after[k] - before[k] for k in before}, counts)
    return runs


def tiny_train_parity(torch):
    """Phase 3b: the tiny STEDM trained for three micro-steps at
    accumulation 2 in bf16, on the card (kernels) and on the CPU (plain
    versions), same weights, t and noise."""
    runs = _tiny_train_runs(torch, torch.bfloat16)
    (lc, gc, dc, _), (lg, gg, dg, counts) = runs["cpu"], runs["cuda"]
    require(counts["flash_attention_bwd"] >= 3,
            f"the card's tiny training did not launch the backward kernel: {counts}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    log(f"  losses card {['%.5f' % x for x in lg]} cpu {['%.5f' % x for x in lc]}: max rel err "
        f"{loss_err:.3e} (tolerance 2e-2)")
    ok = loss_err <= 2e-2
    # bf16 activations round at other places on the two devices (other conv
    # algorithms, summation orders, the kernels against their plain
    # versions): a 4-17 % relative gradient difference per group was measured
    # between bf16 and fp32 on the CPU. Adam's first step is about
    # lr * sign(g), so its update flips on small gradients; both updates have
    # norm ~ lr sqrt(n), and a relative error <= 1 means a cosine >= 0.5.
    for group in ("unet", "cond_stage", "agg"):
        ks = [k for k in gc if k.startswith(group + ".")]
        g_c, g_g = (torch.cat([g[k].flatten() for k in ks]) for g in (gc, gg))
        kd = [k for k in dc if k.startswith(group + ".")]
        d_c, d_g = (torch.cat([d[k].flatten() for k in kd]) for d in (dc, dg))
        g_err = float((g_g - g_c).norm() / g_c.norm())
        d_err = float((d_g - d_c).norm() / d_c.norm())
        log(f"  {group}: grad rel err {g_err:.3e} (tolerance 0.3), update rel err {d_err:.3e} "
            "(tolerance 1.0)")
        ok &= g_err <= 0.3 and d_err <= 1.0
    fs_moved = max(float(dg[k].abs().max()) for k in dg if k.startswith("first_stage."))
    ok &= fs_moved == 0.0
    log(f"  first_stage moved by {fs_moved}; launches on the card {counts}")
    require(ok, "tiny STEDM training on the card disagrees with the CPU")


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


# Phase 3c's tolerances, fixed: each about three times what bf16 alone moves
# the same quantity on the CPU (bf16 against fp32, printed beside it as the
# control). Adam's first updates are about lr * sign(g), so an update flips
# where its gradient is within rounding of zero, and after one step the two
# runs start from parameters that differ by those flips: the controls read
# up to 0.054 for a first step's gradient, 0.14 for a second's, 0.24 for the
# change of the parameters over both. A zero update reads 1, one of the
# wrong sign 2.
CODEC_GRAD_TOL = (0.15, 0.45)  # relative L2 error of step 0's and step 1's gradient
CODEC_UPDATE_TOL = 0.6         # relative L2 error of the parameters' change
CODEC_LOG_TOL = (2e-2, 5e-3)   # each log value: relative, absolute
# the codebook's usage counts nearest codes, which after step 0 switch
# between codes within rounding of each other (control up to 1.4 %)
CODEC_USAGE_RTOL = 5e-2


def _codec_run(torch, device, dtype, fs, cfg, ref, img, noise, lr, variant):
    """Two (len(noise)) fine-tuning steps of a copy of ``ref``'s modules on
    ``device`` with the codec computing in ``dtype``: the log values, each
    step's gradient of both sides, the change of both sides' parameters and
    the launch counts."""
    from stedm_tpu_torch import train_ae
    from stedm_tpu_torch.models.lpips import LPIPS
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train import ae_steps
    from stedm_tpu_torch.train.vae_losses import build_discriminator

    nets = (train_ae.build_codec(fs, dtype=dtype)[0], build_discriminator(cfg), LPIPS())
    for src, dst in zip(ref, nets):
        dst.load_state_dict(src.state_dict())
    model, disc, lpips = (m.to(device) for m in nets)
    flat = lambda ts: torch.cat([t.detach().float().flatten().cpu() for t in ts])
    before = [flat(model.parameters()), flat(disc.parameters())]
    logvar = ae_steps.init_lossvar(0.0, device=device) if variant == "kl" else None
    state = ae_steps.create_ae_state(model, disc, *ae_steps.ae_optimizers(lr), logvar=logvar)
    grads = {"gen": [], "disc": []}
    for side, opt in (("gen", state.gen_opt), ("disc", state.disc_opt)):
        opt.register_step_pre_hook(lambda o, *_, side=side: grads[side].append(
            flat(p.grad for g in o.param_groups for p in g["params"])))
    step = ae_steps.make_ae_train_step(model, cfg, lpips=lpips, variant=variant, device=device)
    reset_launch_counts()
    logs = []
    for nz in noise:
        state, lg, _ = step(state, img, noise=nz)
        logs.append({k: float(v) for k, v in lg.items()})
    counts = dict(LAUNCHES)
    return dict(logs=logs, grads=grads, counts=counts,
                update={"gen": flat(model.parameters()) - before[0],
                        "disc": flat(disc.parameters()) - before[1]})


def tiny_codec_parity(torch):
    """Phase 3c: a tiny codec (ch 32, ch_mult 4-16: the mid-block attention
    at C 512 as in vq-f4, T 576 at patch 48, five key tiles, ragged) in bf16,
    two fine-tuning steps of each variant with LPIPS at train_ae.py's lr and
    config_ae.yaml's loss block (a two-layer discriminator of width 16), on
    the card (kernels) and on the CPU (plain versions), from the same seeded
    weights, images and posterior noise; the CPU also runs the codec in fp32,
    the control that shows what bf16 alone moves. Two stages: the GAN terms
    gated off for both steps (disc_start 2; the discriminator still runs,
    its loss times 0), then live from step 0; each step's gradients, the
    parameters' change and every log value held to fixed tolerances.

    Both stages use taming's ActNorm discriminator (use_actnorm). Under batch
    statistics a discriminator at its start sees real and fake batches
    alike: its gradient, the GAN term's and its mean logit on the
    reconstruction are small differences of near-equal sums, which bf16
    alone moves by 15-25 % (PERF.md). The shipped BatchNorm discriminator is
    held on identical inputs instead, at the end.

    The vq codebook holds the fp32 latents of the images (and 896 codes spread
    like them): every latent lies on its own code, so a nearest code can only
    flip to one within rounding of it and the codes chosen do not move the
    reconstruction beyond rounding."""
    from stedm_tpu_torch import train_ae
    from stedm_tpu_torch.models.lpips import LPIPS
    from stedm_tpu_torch.train.vae_losses import VAELossConfig, build_discriminator

    p, steps, n_embed = 48, 2, 2048
    dd = dict(z_channels=3, resolution=p, in_channels=3, out_ch=3, ch=32, ch_mult=[4, 16],
              num_res_blocks=1, attn_resolutions=[], dropout=0.0)
    lr = train_ae.scaled_lr(train_ae.BASE_LR, 1, 2)
    gen = torch.Generator().manual_seed(12)
    img = torch.rand(2, p, p, 3, generator=gen) * 2 - 1
    codecs = {"vq": {"target": "VQModelInterface", "params": dict(
        embed_dim=3, n_embed=n_embed, ddconfig=dict(dd, double_z=False))},
        "kl": {"target": "AutoencoderKL", "params": dict(
            embed_dim=3, ddconfig=dict(dd, double_z=True))}}
    log(f"  tolerances (relative L2): gradient at steps 0, 1 {CODEC_GRAD_TOL}, update "
        f"{CODEC_UPDATE_TOL}; log values {CODEC_LOG_TOL[0]} relative (d_weight the gradient's, the "
        f"code usage {CODEC_USAGE_RTOL}) + "
        f"{CODEC_LOG_TOL[1]}; the control is the CPU's bf16 against its fp32")
    for stage, disc_start in (("GAN gated off", steps), ("GAN live", 0)):
        cfg = VAELossConfig(**{**train_ae.AE_LOSS, "disc_ndf": 16, "disc_num_layers": 2,
                               "use_actnorm": True, "disc_start": disc_start})
        sides = ("gen",) if cfg.disc_start >= steps else ("gen", "disc")
        for variant, fs in codecs.items():
            torch.manual_seed(13)
            ref = (train_ae.build_codec(fs, dtype=torch.float32)[0], build_discriminator(cfg),
                   LPIPS())
            if variant == "vq":
                with torch.no_grad():
                    z = ref[0].encode(img).float().reshape(-1, 3)
                    codes = torch.randn(n_embed, 3, generator=gen) * z.std(0) + z.mean(0)
                    codes[:len(z)] = z
                    ref[0].quantize.embedding.weight.copy_(codes)
            shape = ref[0].latent_shape(img.shape) if variant == "kl" else None
            noise = [torch.randn(shape, generator=gen) if shape else None for _ in range(steps)]
            cpu, f32, card = (_codec_run(torch, dev, dt, fs, cfg, ref, img, noise, lr, variant)
                              for dev, dt in (("cpu", torch.bfloat16), ("cpu", torch.float32),
                                              ("cuda", torch.bfloat16)))
            rows, ok = [], True
            worst, worst_key, ctrl, ctrl_key = 0.0, "", 0.0, ""
            rtol, atol = CODEC_LOG_TOL
            for i in range(steps):
                for k, v in cpu["logs"][i].items():
                    # the adaptive weight is a ratio of gradient norms
                    tol = {"train/d_weight": CODEC_GRAD_TOL[i], "train/perplexity": CODEC_USAGE_RTOL,
                           "train/cluster_usage": CODEC_USAGE_RTOL}.get(k, rtol) * abs(v) + atol
                    if abs(card["logs"][i][k] - v) / tol > worst:
                        worst, worst_key = abs(card["logs"][i][k] - v) / tol, f"{k}@{i}"
                    if abs(f32["logs"][i][k] - v) / tol > ctrl:
                        ctrl, ctrl_key = abs(f32["logs"][i][k] - v) / tol, f"{k}@{i}"
            ok &= worst <= 1.0
            rows.append(f"log values use {worst:.3f} of their tolerance ({worst_key}; control "
                        f"{ctrl:.3f}, {ctrl_key})")
            for side in sides:
                for i in range(steps):
                    e = _rel(card["grads"][side][i], cpu["grads"][side][i])
                    c = _rel(cpu["grads"][side][i], f32["grads"][side][i])
                    ok &= e <= CODEC_GRAD_TOL[i]
                    rows.append(f"{side} gradient @{i} {e:.3e} (control {c:.3e})")
                e = _rel(card["update"][side], cpu["update"][side])
                c = _rel(cpu["update"][side], f32["update"][side])
                ok &= e <= CODEC_UPDATE_TOL
                rows.append(f"{side} update {e:.3e} (control {c:.3e})")
            ps = [x["train/perplexity"] for x in card["logs"]] if variant == "vq" else []
            log(f"  {stage}, {variant}: total loss card "
                f"{[round(x['train/total_loss'], 5) for x in card['logs']]} cpu "
                f"{[round(x['train/total_loss'], 5) for x in cpu['logs']]} fp32 "
                f"{[round(x['train/total_loss'], 5) for x in f32['logs']]}"
                + (f"; perplexity {[round(x, 2) for x in ps]}" if ps else "")
                + "\n    " + "; ".join(rows) + f"\n    launches on the card {card['counts']}")
            require(ok, f"the tiny {variant} codec fine-tuned on the card disagrees with the CPU "
                    f"({stage})")
            moved = [float(card["update"][s].abs().max()) for s in sides]
            require(min(moved) > 0, f"the tiny {variant} codec's parameters did not move: {moved}")
            # two steps, each: the generator's forward and backward through the
            # encoder's and the decoder's attention, the discriminator's re-run
            counts = card["counts"]
            require(counts["flash_attention_bwd"] == 2 * steps
                    and counts["flash_attention"] == 4 * steps,
                    f"the tiny {variant} codec's attention launches: {counts}")
            require(counts["gn_silu"] > 0 and counts["nearest_code"] == (
                2 * steps if variant == "vq" else 0),
                f"the tiny {variant} codec's GN / nearest-code launches: {counts}")
    # the BatchNorm discriminator's logits, gradient and new running
    # statistics on the same real and fake images (fp32, TF32 off): the sums
    # in other orders
    cfg = VAELossConfig(**{**train_ae.AE_LOSS, "disc_ndf": 16, "disc_num_layers": 2})
    torch.manual_seed(14)
    d_cpu = build_discriminator(cfg)
    d_gpu = build_discriminator(cfg)
    d_gpu.load_state_dict(d_cpu.state_dict())
    d_gpu.cuda()
    real, fake = (torch.rand(2, p, p, 3, generator=gen) * 2 - 1 for _ in range(2))
    outs = []
    for d in (d_cpu, d_gpu):
        dev = next(d.parameters()).device
        logits_real, st = d(real.to(dev))
        logits_fake, st = d(fake.to(dev), st)
        loss = cfg.d_loss()(logits_real, logits_fake)
        outs.append([torch.cat([logits_real.flatten(), logits_fake.flatten()]).detach().cpu(),
                     torch.cat([g.flatten().cpu() for g in
                                torch.autograd.grad(loss, list(d.parameters()))]),
                     torch.cat([torch.cat([m.cpu(), v.cpu()]) for m, v in st])])
    errs = [_rel(g, c) for g, c in zip(outs[1], outs[0])]
    log("  BatchNorm discriminator on the same images: logits, gradient, running statistics "
        "rel err " + ", ".join(f"{e:.3e}" for e in errs) + " (tolerance 1e-3)")
    require(max(errs) <= 1e-3, "the discriminator on the card disagrees with the CPU")


PROFILE_ATTEMPTS = 3


def _median(xs):
    xs = sorted(xs)
    return (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2]) / 2


def timed_runs(torch, run, n: int = 4) -> list:
    """Host-clock seconds of ``n`` warm runs, each ending in a synchronise."""
    times = []
    for _ in range(n):
        t1 = time.time()
        run()
        torch.cuda.synchronize()
        times.append(time.time() - t1)
    return times


def gn_modules(modules) -> int:
    from stedm_tpu_torch.models.layers import GNSiLU

    return sum(isinstance(m, GNSiLU) for mod in modules for m in mod.modules())


def serving_flagship(torch, model, batch, schedule, exact_img, out_dir: Path,
                     card: str) -> dict:
    """Phase 4d: bench.py's headline serving mode on the flagship, eager, then
    graph-replayed; the exact trajectory graph-replayed; the drift profile of
    the port's flagship. Returns its numbers and the serving batch's launch
    counts (zeroed just before the eager serving run, read just after)."""
    import numpy as np

    from stedm_tpu_torch.core.cache_schedule import positions_from_spec
    from stedm_tpu_torch.core.ddim import guided_range
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train.calibrate import measure_cache_drift
    from stedm_tpu_torch.train.host_sampler import make_host_sample_fn
    from stedm_tpu_torch.train.steps import (SamplerConfig, make_sample_fn, plan_sampler,
                                             prepare_conditioning)

    steps, b = 50, exact_img.shape[0]
    drift_ref = np.load(REPO / "tools" / "bench_assets" / "drift_untrained_flagship.npy")
    positions = positions_from_spec("auto:5", steps, drift_ref)
    window = guided_range(steps, (0.35, 0.65))
    log(f"  refresh positions auto:5 on the committed drift profile: {positions}; window "
        f"(0.35, 0.65) -> {window}")
    require(positions == (0, 3, 21, 33, 41), f"auto:5 gives {positions}")
    require(window == (18, 32), f"the window resolves to {window}")
    n_full = len(set(positions) | {window[0]})
    base = dict(ddim_steps=steps, eta=0.0, cfg_scale=1.5, rescale_phi=0.7, batched_cfg=True,
                downsample=4)
    cfg = SamplerConfig(**base, cache_schedule=positions, cfg_interval=(0.35, 0.65))
    unet = model.unet
    n_shallow = unet.shallow_blocks(cfg.cache_levels)
    gn_full = gn_modules([unet])
    gn_shallow = gn_modules([*unet.input_blocks[:n_shallow], *unet.output_blocks[-n_shallow:],
                             unet.out["0"]])
    gn_decode = gn_modules([model.first_stage.decoder])
    want_gn = n_full * gn_full + (steps - n_full) * gn_shallow
    log(f"  {n_full} full passes and {steps - n_full} cached; GN modules: {gn_full} in a full "
        f"pass, {gn_shallow} in a cached one, {gn_decode} in the codec")

    gen = torch.Generator(device="cuda")
    eager = make_sample_fn(model, schedule, cfg)
    reset_launch_counts()
    t1 = time.time()
    img, z_s = sample_with_latent(eager, model, batch, generator=gen.manual_seed(0))
    torch.cuda.synchronize()
    cold_s = time.time() - t1
    counts = dict(LAUNCHES)
    log(f"  eager serving: cold run {cold_s:.2f} s; launches {counts}")
    require(tuple(img.shape) == tuple(exact_img.shape), f"shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), "non-finite serving output")
    require(float(img.min()) >= -1.0 and float(img.max()) <= 1.0, "serving output outside [-1, 1]")
    require(float(img.float().std()) > 0.0, "flat serving output")
    require(bool(torch.isfinite(z_s).all()) and float(z_s.std()) > 0.0,
            "non-finite or flat serving latent")
    require(counts["flash_attention"] == n_full + 1,
            f"{counts['flash_attention']} flash launches, not {n_full} full passes + the decode")
    require(counts["gn_silu"] == want_gn + gn_decode,
            f"{counts['gn_silu']} GN launches, the schedule implies {want_gn + gn_decode}")
    require(counts["nearest_code"] == 1, f"nearest-code launches {counts['nearest_code']}")
    eager_times = timed_runs(torch, lambda: eager(model, batch, generator=gen.manual_seed(0)))

    host = make_host_sample_fn(model, schedule, cfg, unroll=10)
    t1 = time.time()
    img_g, z_g = sample_with_latent(host, model, batch, generator=gen.manual_seed(0))
    torch.cuda.synchronize()
    capture_s = time.time() - t1
    cap = host.capture_launches
    log(f"  graph serving: blocks {host.block_sizes}; first call (warm-up, capture, replay) "
        f"{capture_s:.2f} s; launches counted at capture {cap}")
    require(cap["flash_attention"] == n_full and cap["gn_silu"] == want_gn,
            f"the capture's launches {cap}: {n_full} flash, {want_gn} GN expected")
    # the decoded images carry little of the trajectory here (random weights:
    # the VQ decode quantizes z_0 to codes, then saturates into the clamp),
    # so the latents are what is held equal; the images are logged
    same = torch.equal(z_g, z_s)
    log(f"  graph replay's latent z_0 equals the eager loop's bit for bit: {same} (max |diff| "
        f"{float((z_g - z_s).abs().max()):.3e}); images equal {torch.equal(img_g, img)}, "
        f"pixels inside the clamp {inside_clamp(img):.4f}")
    require(same, "the graph-replayed serving latent differs from the eager loop's")
    graph_times = timed_runs(torch, lambda: host(model, batch, generator=gen.manual_seed(0)))

    _, z_e = sample_with_latent(make_sample_fn(model, schedule, SamplerConfig(**base)), model,
                                batch, generator=gen.manual_seed(0))
    host_exact = make_host_sample_fn(model, schedule, SamplerConfig(**base), unroll=10)
    img_ge, z_ge = sample_with_latent(host_exact, model, batch, generator=gen.manual_seed(0))
    torch.cuda.synchronize()
    same_exact = torch.equal(z_ge, z_e)
    log(f"  graph exact: blocks {host_exact.block_sizes}; launches counted at capture "
        f"{host_exact.capture_launches}; latent z_0 equals the eager exact loop's bit for bit: "
        f"{same_exact} (max |diff| {float((z_ge - z_e).abs().max()):.3e}); image equals phase "
        f"4's eager batch {torch.equal(img_ge, exact_img)}, pixels inside the clamp "
        f"{inside_clamp(exact_img):.4f}")
    require(same_exact, "the graph-replayed exact latent differs from the eager loop's")
    exact_times = timed_runs(torch, lambda: host_exact(model, batch,
                                                       generator=gen.manual_seed(0)))
    rates = {name: [b / t for t in ts] for name, ts in (
        ("serving_eager", eager_times), ("serving_graph", graph_times),
        ("exact_graph", exact_times))}
    for name, r in rates.items():
        log(f"  {name} img/s (4 warm runs, host clock): " + " ".join(f"{x:.4f}" for x in r)
            + f"; median {_median(r):.4f} on {card}")
    mse = float((img.float() - exact_img.float()).square().mean())
    psnr = 10 * math.log10(4.0 / max(mse, 1e-12))
    log(f"  cached-vs-exact PSNR of the port's flagship (random weights): {psnr:.2f} dB "
        f"(MSE {mse:.3e}, floored at 1e-12)")

    z_rel = float((z_s - z_e).norm() / z_e.norm())
    require(z_rel > 0.0, "the serving latent equals the exact one: no pass was cached")
    with torch.inference_mode():
        codes = [model.first_stage.quantize(z / model.scale_factor) for z in (z_s, z_e)]
        same_codes = float((codes[0] == codes[1]).all(-1).float().mean())
        log(f"  cached-vs-exact latents z_0: relative L2 {z_rel:.3e}, max |diff| "
            f"{float((z_s - z_e).abs().max()):.3e}; tokens quantized alike {same_codes:.4f}")
        plan = plan_sampler(model, schedule, cfg)
        prep_ms = _median(timed_runs(torch, lambda: prepare_conditioning(
            model, batch, plan, next(model.parameters()).device))) * 1e3
        dec_ms = _median(timed_runs(torch, lambda: model.decode_first_stage(z_s))) * 1e3
    log(f"  outside the blocks, host clock (4 runs, median): conditioning (layout and two style "
        f"encodes) {prep_ms:.2f} ms, VQ decode {dec_ms:.2f} ms")

    t1 = time.time()
    drift = measure_cache_drift(model, schedule, SamplerConfig(**base), batch,
                                generator=gen.manual_seed(0))
    drift_s = time.time() - t1
    log(f"  measure_cache_drift on the port's flagship ({drift_s:.2f} s): length {len(drift)}, "
        f"auto:5 on it {positions_from_spec('auto:5', steps, drift)}; correlation with the "
        f"committed profile {float(np.corrcoef(drift, drift_ref)[0, 1]):.3f}")
    log("    port    " + " ".join(f"{x:.3f}" for x in drift))
    log("    profile " + " ".join(f"{x:.3f}" for x in drift_ref))
    require(len(drift) == steps - 1 and bool(np.isfinite(drift).all()),
            f"drift profile of length {len(drift)}, finite {bool(np.isfinite(drift).all())}")

    log("== phase 5 (serving): where the device time goes")
    profiles = {}
    serving_gn, exact_gn = want_gn + gn_decode, steps * gn_full + gn_decode
    for name, run, wall, want in (
            ("serving_eager", lambda: eager(model, batch, generator=gen.manual_seed(0)),
             _median(eager_times), serving_gn),
            ("serving_graph", lambda: host(model, batch, generator=gen.manual_seed(0)),
             _median(graph_times), serving_gn),
            ("exact_graph", lambda: host_exact(model, batch, generator=gen.manual_seed(0)),
             _median(exact_times), exact_gn)):
        # the replays' kernels are counted here, by the profiler (CUPTI). A
        # profile that lost records (seen once on an exact replay: ~5 % of
        # every kernel's records gone, its device time short) is no
        # measurement: it is taken again, at most PROFILE_ATTEMPTS times
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            log(f"  -- {name} (profile {attempt})")
            kernels = profile_main_path(torch, run, wall * 1e3, out_dir, f"profile_{name}.txt")
            busy = sum(ms for _, _, ms in kernels)
            gn_k = sum(n for k, n, _ in kernels if "gn_silu_kernel" in k)
            log(f"  {name}: GN device kernels seen {gn_k} (the schedule implies {want} with "
                "the decode)")
            if gn_k == want:
                break
        profiles[name] = dict(device_busy_ms=busy, idle_share=1 - busy / (wall * 1e3),
                              gn_device_kernels=gn_k, profile_attempts=attempt)
        require(busy > 0 and gn_k == want, f"{name}: {gn_k} GN device kernels, busy {busy}")
    return dict(serving_counts=counts, serving_positions=list(positions),
                serving_window=list(window), serving_img_per_s_runs=rates,
                serving_img_per_s={k: _median(v) for k, v in rates.items()},
                serving_psnr_db=psnr, serving_latent_rel_l2=z_rel, serving_prep_ms=prep_ms,
                serving_decode_ms=dec_ms, serving_capture_s=capture_s,
                serving_drift=[float(x) for x in drift], serving_profiles=profiles)


def train_flagship(torch, out_dir: Path) -> dict:
    """Phase 4b: full-width training (the second main path); returns its numbers."""
    from stedm_tpu_torch.models.attention import AttentionBlock
    from stedm_tpu_torch.models.layers import GNSiLU
    from stedm_tpu_torch.models.stedm import build_flagship
    from stedm_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_launch_counts
    from stedm_tpu_torch.train.optim import make_optimizer
    from stedm_tpu_torch.train.steps import create_train_state, make_train_step

    batch_size, accum = 8, 4
    model, batch, schedule = build_flagship(batch=batch_size, patch=512, nonzero_init=True)
    tx = make_optimizer(1e-4, accumulate_grad_batches=accum, weight_decay=0.01)
    state = create_train_state(model, tx)
    step = make_train_step(model, schedule, tx)
    gen = torch.Generator(device="cuda").manual_seed(0)
    groups = {"unet": model.unet, "cond_stage": model.cond_stage, "agg": model.agg}
    before = {g: [p.detach().clone() for p in m.parameters()] for g, m in groups.items()}
    fs_before = [p.detach().clone() for p in model.first_stage.parameters()]
    ema_before = [v.clone() for v in state.ema_params.values()]

    reset_launch_counts()
    t1 = time.time()
    state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    cold_s = time.time() - t1
    counts, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
    n_gn = sum(isinstance(x, GNSiLU) for x in model.modules())
    log(f"  first micro-step {cold_s:.2f} s, loss {float(m['loss']):.5f}; launches in one "
        f"micro-step {counts}, plain GN backward calls {plain['gn_silu_bwd']}; GN modules "
        f"{n_gn}")
    require(bool(torch.isfinite(m["loss"])), "non-finite training loss")
    for name in ("gn_silu", "flash_attention", "flash_attention_bwd"):
        require(counts[name] >= 1, f"no {name} launch in a training micro-step: {counts}")
    n_attn = sum(isinstance(x, AttentionBlock) for x in model.unet.modules())
    require(counts["flash_attention_bwd"] == n_attn,
            f"{counts['flash_attention_bwd']} backward launches for {n_attn} AttentionBlocks")
    require(plain["gn_silu_bwd"] >= 1, "no GN backward in a training micro-step")
    for g, mod in groups.items():
        grads = [p.grad for p in mod.parameters()]
        require(all(x is not None for x in grads), f"{g}: a parameter got no gradient")
        norm = float(torch.linalg.vector_norm(torch.stack([x.float().norm() for x in grads])))
        log(f"  {g}: gradient norm {norm:.4e} over {len(grads)} tensors")
        require(0 < norm < float("inf"), f"{g}: gradient norm {norm}")
    qkv = [p.grad for n, p in model.unet.named_parameters() if n.endswith("qkv.weight")]
    qkv_norm = float(qkv[0].float().norm())
    log(f"  AttentionBlock qkv gradient norm {qkv_norm:.4e} (the backward kernels saw signal)")
    require(qkv_norm > 0, "the attention's qkv got a zero gradient")
    for _ in range(accum - 1):
        state, m = step(state, batch, gen)
        require(bool(torch.isfinite(m["loss"])), "non-finite training loss")
    torch.cuda.synchronize()
    require(state.opt_state.gradient_step == 1, "the first update was not applied")
    for g, mod in groups.items():
        moved = any(not torch.equal(b, p) for b, p in zip(before[g], mod.parameters()))
        require(moved, f"{g} did not change after an applied update")
    require(all(torch.equal(b, p) for b, p in zip(fs_before, model.first_stage.parameters())),
            "the frozen first stage changed")
    require(any(not torch.equal(b, p) for b, p in zip(ema_before, state.ema_params.values())),
            "the EMA shadow did not change")
    del before, fs_before, ema_before
    log("  after one applied update: unet, cond_stage, agg and the EMA changed; "
        "first_stage bitwise unchanged")

    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(3):                       # timed applied updates
        t1 = time.time()
        for _ in range(accum):
            state, m = step(state, batch, gen)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        times.append(time.time() - t1)
    require(bool(torch.isfinite(torch.stack(losses)).all()), "non-finite training loss")
    require(state.opt_state.gradient_step == 4, "updates were not applied")
    median_s = sorted(times)[1]
    sps = batch_size * accum / median_s
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("  timed applied updates (4 micro-steps of 8 samples each): " + " ".join(
        f"{batch_size * accum / t:.4f}" for t in times) + f" samples/s; median {sps:.4f}; "
        f"peak memory {peak:.2f} GiB; losses {float(losses[0]):.4f} .. {float(losses[-1]):.4f}")
    profile_main_path(torch, lambda: step(state, batch, gen), median_s / accum * 1e3, out_dir,
                      "profile_train.txt")
    return dict(train_samples_per_s=sps,
                train_samples_per_s_runs=[batch_size * accum / t for t in times],
                train_peak_mem_gib=peak, train_launches_per_micro_step=counts,
                train_gn_bwd_per_micro_step=plain["gn_silu_bwd"])


def codec_finetune(torch, out_dir: Path) -> dict:
    """Phase 4c: full-width codec fine-tuning (the third main path); returns
    its numbers."""
    from stedm_tpu_torch import train_ae
    from stedm_tpu_torch.models.lpips import LPIPS
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train.ae_steps import (ae_optimizers, create_ae_state,
                                                make_ae_train_step)
    from stedm_tpu_torch.train.vae_losses import VAELossConfig, build_discriminator

    batch, p = 2, 512
    torch.manual_seed(0)
    model, variant = train_ae.build_codec(train_ae.VQ_F4, dtype=torch.bfloat16)
    model.cuda()
    n_params = sum(x.numel() for x in model.parameters())
    require(n_params == 55_322_782, f"vq-f4 has {n_params} parameters")
    cfg = VAELossConfig(**{**train_ae.AE_LOSS, "disc_start": 0})
    lr = train_ae.scaled_lr(train_ae.BASE_LR, 1, batch)
    log(f"  vq-f4 {n_params} parameters, {p}^2, batch {batch}, bf16 compute, fp32 parameters, "
        f"Adam(0.5, 0.9) lr {lr:.3e} (base_lr x 1 x {batch}); config_ae.yaml's loss block with "
        f"two overrides: disc_start 0 (the file: {train_ae.AE_LOSS['disc_start']}), so that "
        "both adversaries' terms are live at once; LPIPS with seeded random weights at "
        f"perceptual_weight {cfg.perceptual_weight} (train_ae.py turns the term off without "
        "staged weights)")
    disc, lpips = build_discriminator(cfg).cuda(), LPIPS().cuda()
    state = create_ae_state(model, disc, *ae_optimizers(lr))
    step = make_ae_train_step(model, cfg, lpips=lpips, variant=variant)
    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand((batch, p, p, 3), generator=gen, device="cuda") * 2 - 1
    gen_before = [x.detach().clone() for x in model.parameters()]
    disc_before = [x.detach().clone() for x in disc.parameters()]

    reset_launch_counts()
    t1 = time.time()
    state, lg, rec = step(state, img)
    torch.cuda.synchronize()
    cold_s = time.time() - t1
    counts = dict(LAUNCHES)
    vals = {k: float(v) for k, v in lg.items()}
    log(f"  first step {cold_s:.2f} s; launches in one step {counts}; log " + ", ".join(
        f"{k.split('/')[1]} {v:.5g}" for k, v in vals.items()))
    for name in ("gn_silu", "flash_attention", "flash_attention_bwd", "nearest_code"):
        require(counts[name] >= 1, f"no {name} launch in a codec step: {counts}")
    # the encoder's and the decoder's mid-block attention: a backward each,
    # and a forward each in the generator's pass and in the re-run
    require(counts["flash_attention_bwd"] == 2 and counts["flash_attention"] == 4,
            f"attention launches in a codec step: {counts}")
    require(tuple(rec.shape) == (batch, p, p, 3) and bool(torch.isfinite(rec).all()),
            "the reconstruction is not finite NHWC")
    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        before_bwd = LAUNCHES["flash_attention_bwd"]
        t1 = time.time()
        state, lg, _ = step(state, img)
        torch.cuda.synchronize()
        times.append(time.time() - t1)
        require(LAUNCHES["flash_attention_bwd"] == before_bwd + 2,
                "a codec step did not launch the backward kernel twice")
        losses.append({k: float(v) for k, v in lg.items()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for lgv in [vals] + losses:
        require(all(math.isfinite(v) for v in lgv.values()), f"non-finite log {lgv}")
        require(1.0 <= lgv["train/perplexity"] <= 8192, f"perplexity {lgv['train/perplexity']}")
    require(any(not torch.equal(b_, x) for b_, x in zip(gen_before, model.parameters())),
            "the codec did not move")
    require(any(not torch.equal(b_, x) for b_, x in zip(disc_before, disc.parameters())),
            "the discriminator did not move")
    del gen_before, disc_before
    median_s = sorted(times)[2]
    sps = batch / median_s
    log("  timed steps: " + " ".join(f"{batch / t:.4f}" for t in times) + f" samples/s; median "
        f"{sps:.4f}; peak memory {peak:.2f} GiB; total_loss {losses[0]['train/total_loss']:.4f} "
        f".. {losses[-1]['train/total_loss']:.4f}, disc_loss {losses[-1]['train/disc_loss']:.4f}, "
        f"perplexity {losses[-1]['train/perplexity']:.1f}; codec and discriminator moved")
    kernels = profile_main_path(torch, lambda: step(state, img), median_s * 1e3, out_dir,
                                "profile_codec.txt")
    busy = sum(ms for _, _, ms in kernels)
    shares = {cat: sum(ms for name, _, ms in kernels if re.search(pat, name)) / busy
              for cat, pat in (("flash_fwd", r"flash_fwd_"), ("flash_bwd", r"flash_bwd"))}
    log(f"  flash forward {shares['flash_fwd']:.1%} and backward {shares['flash_bwd']:.1%} of "
        "the step's device time")
    return dict(codec_samples_per_s=sps, codec_samples_per_s_runs=[batch / t for t in times],
                codec_peak_mem_gib=peak, codec_launches_per_step=counts,
                codec_device_busy_ms=busy, codec_flash_shares=shares)


# Phase 6's synthetic Flowers-102: every class (both configured class lists
# must cover all 102 bins), three images each (two in the train split, one in
# val or test), at the published images' 500-pixel shorter side
FLOWERS_CLASSES, FLOWERS_PER_CLASS, FLOWERS_HW = 102, 3, (500, 667)


def write_flowers_tree(root: Path) -> int:
    """imgs/image_*.jpg (smooth random colour fields), segs/segmim_*.jpg
    (blue background around an ellipse), imagelabels.mat and setid.mat under
    ``root/flowers``; returns the image count."""
    import numpy as np
    import scipy.io
    from PIL import Image

    base = root / "flowers"
    (base / "imgs").mkdir(parents=True)
    (base / "segs").mkdir(parents=True)
    rng = np.random.default_rng(0)
    h, w = FLOWERS_HW
    yy, xx = np.mgrid[0:h, 0:w]
    labels, ids = [], ([], [], [])
    n = FLOWERS_CLASSES * FLOWERS_PER_CLASS
    for i in range(n):
        labels.append(i % FLOWERS_CLASSES + 1)
        low = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
        img = Image.fromarray(low).resize((w, h), Image.BILINEAR)
        img.save(base / "imgs" / f"image_{i + 1:05d}.jpg", quality=90)
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.15, 0.3) * h, rng.uniform(0.15, 0.3) * w
        fg = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        seg = np.zeros((h, w, 3), np.uint8)
        seg[..., 2] = 255
        seg[fg] = rng.integers(40, 220, 3)
        Image.fromarray(seg).save(base / "segs" / f"segmim_{i + 1:05d}.jpg", quality=90)
        round_ = i // FLOWERS_CLASSES
        ids[0 if round_ < 2 else 1 + (i % 2)].append(i + 1)
    scipy.io.savemat(base / "imagelabels.mat", {"labels": np.array(labels)[None]})
    scipy.io.savemat(base / "setid.mat", {"trnid": np.array(ids[0])[None],
                                         "valid": np.array(ids[1])[None],
                                         "tstid": np.array(ids[2])[None]})
    return n


def write_preview_fixture(root: Path, patch: int) -> None:
    """test_img_diff/flowers: the preview layout and two augmented styles, as
    tests/test_e2e_flowers.py:86-95 writes them, at the patch size."""
    import numpy as np
    from PIL import Image

    folder = root / "test_img_diff" / "flowers"
    (folder / "augmented").mkdir(parents=True)
    cond = np.zeros((patch, patch), np.uint8)
    cond[patch // 4:3 * patch // 4, patch // 4:3 * patch // 4] = 255
    Image.fromarray(cond).save(folder / "test_c.png")
    for i in range(2):
        style = np.random.default_rng(i).integers(0, 255, (patch, patch, 3), np.uint8)
        Image.fromarray(style).save(folder / "augmented" / f"{i}_img.png")


def check_pairs(folder: Path, n: int, patch: int) -> None:
    import numpy as np
    from PIL import Image

    imgs, segs = sorted(folder.glob("img_*.png")), sorted(folder.glob("seg_*.png"))
    require(len(imgs) == len(segs) == n, f"{folder.name}: {len(imgs)} images and {len(segs)} "
            f"segmentations, expected {n} pairs")
    require([p.name[4:] for p in imgs] == [p.name[4:] for p in segs],
            f"{folder.name}: unpaired files")
    for pi, ps in zip(imgs, segs):
        img, seg = np.array(Image.open(pi)), np.array(Image.open(ps))
        require(img.shape == (patch, patch, 3) and img.dtype == np.uint8,
                f"{pi.name}: {img.shape} {img.dtype}")
        require(seg.shape == (patch, patch) and set(np.unique(seg).tolist()) <= {0, 1},
                f"{ps.name}: shape {seg.shape}, values {np.unique(seg)[:5]}")


def predict_rates(out: dict) -> dict:
    """Pairs/s after the first batch, and the shares of that time spent
    outside the sampler (host clock)."""
    steady = out["steady_s"]
    ph = out["steady_phase_s"]
    rate = (out["pairs"] - out["first_batch_pairs"]) / steady
    outside = (ph["data"] + ph["h2d"] + ph["png"]) / steady
    log(f"    {out['pairs']} pairs; first batch ({out['first_batch_pairs']} pairs) "
        f"{out['first_batch_s']:.3f} s after set-up ({out['setup_s']:.3f} s); then "
        f"{rate:.4f} pairs/s over {steady:.3f} s, of which outside the sampler "
        f"{outside:.4f} (data {ph['data']:.4f} s, H2D {ph['h2d']:.4f} s, PNG "
        f"{ph['png']:.4f} s), issuing the sampler {ph['sample']:.4f} s, waiting for the "
        f"card {ph['wait']:.4f} s")
    return {"pairs_per_s": rate, "outside_sampler_share": outside, **out}


def entry_points(torch) -> tuple[Path, dict]:
    """Phase 6: the train and predict entry points at the shipped widths on a
    synthetic Flowers tree: train, resume, predict exact, predict in the
    serving mode. Returns the tree's root (phase 7 reads it, then removes
    it) and its numbers with the launch counts of each call."""
    from stedm_tpu_torch import predict_diff, train_diff
    from stedm_tpu_torch.config import compose
    from stedm_tpu_torch.models.stedm import build_stedm
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train import checkpoints

    t0 = time.time()
    root = REPO / "build" / "chip_smoke_entry"
    shutil.rmtree(root, ignore_errors=True)
    data, results, patch = root / "data", root / "results", 512
    n_imgs = write_flowers_tree(data)
    write_preview_fixture(data, patch)
    log(f"  synthetic Flowers-102: {n_imgs} images {FLOWERS_HW[0]}x{FLOWERS_HW[1]} in "
        f"{FLOWERS_CLASSES} classes, written in {time.time() - t0:.1f} s")
    where = [f"location.data_dir={data}", f"location.result_dir={results}"]
    train_args = ["data=flowers", "style_sampling=augmented", "style_agg=mean", *where,
                  "+diffusion.scale_by_std=true",
                  # the cuts: the epoch's sample budget, the epochs, the preview steps
                  "data.samples=16", "num_epochs=1", "+preview_ddim_steps=20"]
    counts = {}

    log(f"  train_diff.main({train_args})")
    reset_launch_counts()
    first = train_diff.main(train_args)
    torch.cuda.synchronize()
    counts["entry_train"] = dict(LAUNCHES)
    run = first["run_dir"]
    ep = first["epochs"][0]
    log(f"  trained: {ep['micro_steps']} micro-steps of {ep['samples'] // ep['micro_steps']}, "
        f"step {first['step']}, loss {ep['loss']:.5f}, {ep['samples'] / ep['seconds']:.4f} "
        f"samples/s over the epoch ({ep['seconds']:.2f} s, first micro-steps included); "
        f"scale factor {first['scale_factor']:.6f}; launches {counts['entry_train']}")
    require(first["step"] == 8 and ep["micro_steps"] == 8, f"steps {first['step']}")
    ckpt_file = checkpoints.checkpoint_file(f"{run}/ckpt", Path(run).name + "_last")
    saved = checkpoints.load(ckpt_file)
    size_gib = ckpt_file.stat().st_size / 2 ** 30
    log(f"  checkpoint {ckpt_file.name}: {size_gib:.3f} GiB, step {saved['step']}, "
        f"{saved['opt']['gradient_step']} updates applied")
    require(saved["step"] == 8 and saved["opt"]["gradient_step"] == 2,
            "the checkpoint is not the state after 8 micro-steps and 2 updates")
    for f in ("scale_factor.json", "events.jsonl"):
        require((Path(run) / f).is_file(), f"{f} was not written")
    previews = sorted(p.name for p in (Path(run) / "previews").glob("*.png"))
    require(len(previews) == 6, f"previews: {previews}")
    # the run's initial U-Net: the same build, on the card, from the same seed
    init = build_stedm(compose("config_diff", train_args), seed=0).unet.state_dict()
    moved = sum(not torch.equal(init[k].cpu(), v) for k, v in saved["ema"].items())
    log(f"  the EMA shadow moved in {moved} of {len(init)} U-Net tensors")
    require(moved > 0, "the EMA shadow did not move")
    del init, saved

    log("  resumed: +resume=true num_epochs=2")
    reset_launch_counts()
    resumed = train_diff.main(train_args + ["+resume=true", "num_epochs=2"])
    torch.cuda.synchronize()
    for k, v in LAUNCHES.items():
        counts["entry_train"][k] += v
    ep2 = resumed["epochs"][0]
    log(f"  resumed at step {resumed['start_step']} (saved: {first['step']}), its first "
        f"micro-step is step {resumed['start_step'] + 1}; epoch {ep2['epoch']}: "
        f"{ep2['micro_steps']} micro-steps, loss {ep2['loss']:.5f}, "
        f"{ep2['samples'] / ep2['seconds']:.4f} samples/s ({ep2['seconds']:.2f} s); step "
        f"{resumed['step']}")
    require(resumed["start_step"] == first["step"] and ep2["epoch"] == 1
            and resumed["step"] == first["step"] + 8, "the resume did not continue the run")
    for e in (ep, ep2):
        require(math.isfinite(e["loss"]), f"epoch {e['epoch']}: loss {e['loss']}")
    torch.cuda.empty_cache()

    readme = ["data=flowers", "data/dataset=[flowers_anno,flowers_unanno]",
              "data.ratios=[1.0,1.0]", "cfg_scale=1.5",
              # the run's style settings, so that its checkpoint is found
              "style_sampling=augmented", "style_agg=mean", *where,
              "data.samples=4", "+use_ema=true"]
    predicts = {}
    # cut, to make room for phase 12: the exact run at DDIM-50, not the
    # config's 128 (143 steps)
    for name, extra in (("exact", ["ddim_steps=50"]), ("serving", [
            "ddim_steps=50", "+cache_schedule=auto:5", "+cfg_interval=[0.35,0.65]"])):
        args = readme + extra + [f"+predict_name={name}"]
        log(f"  predict_diff.main({args})")
        reset_launch_counts()
        out = predict_diff.main(args)
        torch.cuda.synchronize()
        counts[f"entry_predict_{name}"] = dict(LAUNCHES)
        log(f"    launches (warm-up and capture; replays uncounted) "
            f"{counts[f'entry_predict_{name}']}")
        check_pairs(Path(out["predict_dir"]), 8, patch)
        predicts[name] = predict_rates(out)
        torch.cuda.empty_cache()

    # the kernels of this bf16 path (phase 10 runs the fp32 and streaming ones)
    total = {k: sum(c[k] for c in counts.values())
             for k in ("gn_silu", "flash_attention", "flash_attention_bwd", "nearest_code")}
    for k, v in total.items():
        require(v > 0, f"no {k} launch inside the entry-point calls: {counts}")
    seconds = time.time() - t0
    log(f"  phase 6 took {seconds:.1f} s (its tree stays for phases 7 and 9)")
    return root, dict(entry_counts=counts, entry_seconds=seconds, entry_checkpoint_gib=size_gib,
                entry_train_samples_per_s=[e["samples"] / e["seconds"] for e in (ep, ep2)],
                entry_predict={k: {kk: vv for kk, vv in v.items() if kk != "predict_dir"}
                               for k, v in predicts.items()})


# phase 7a's tolerances, card (fp32, TF32 off) against CPU (fp32), same
# weights and batches: the sums run in other orders (cuDNN's convolution
# algorithms), which moves each value by about 1e-6 of its size; Adam's first
# update is about lr * sign(g), so where a gradient is near zero its element
# flips: the update is held in relative L2 norm, as in phases 3b and 3c
SEG_LOSS_RTOL = 1e-4
SEG_LOGIT_ATOL = 1e-3     # train- and eval-mode logits, |logit| ~ 1
SEG_STATS_ATOL = 1e-5     # BatchNorm running statistics
SEG_UPDATE_REL = 1e-2     # relative L2 error of the parameters' change
SEG_TIE = 1e-3            # a pixel whose CPU logits differ by less may flip its argmax
SEG_LR = 1e-4
SEG_TINY = dict(classes=2, decoder_channels=(64, 32, 16, 16, 8), encoder_config=dict(
    embed_dims=(32, 64, 80, 128), depths=(1, 1, 1, 1), num_heads=(1, 2, 5, 8),
    sr_ratios=(8, 4, 2, 1)))
# the keys the JAX entry point logs with a val and a test split
# (train_seg.py:48-84, :185-240)
SEG_EVENT_KEYS = ("Train Loss", "epoch", "epoch_time_s", "Train IoU Score",
                  "Train Subtype Var", "Val Loss", "Val IoU Score", "Val Subtype Var",
                  "Val Patient IoU Score", "Val Patient IoU Var") + tuple(
    f"Test ({tag}) {k}" for tag in ("last", "best")
    for k in ("IoU Score", "Subtype Var", "Patient IoU Score", "Patient IoU Var"))


def _seg_run(torch, model, device: str, batches, eval_batch) -> dict:
    """Two train micro-steps at accumulation 2 (one update), then an eval
    step with cuts and instance ids: each step's loss, matrix and train-mode
    logits (of a copy, so that the running statistics move once a step), the
    eval outputs and eval-mode logits, and the state_dict."""
    import copy

    from stedm_tpu_torch.train.seg_steps import (
        create_seg_state,
        make_seg_eval_step,
        make_seg_optimizer,
        make_seg_train_step,
    )

    state = create_seg_state(model, make_seg_optimizer(SEG_LR, 2))
    step = make_seg_train_step(model, num_classes=3, overlap=2, device=device)
    out = {"loss": [], "cm": [], "logits": []}
    for img, seg in batches:
        img, seg = img.to(device), seg.to(device)
        with torch.no_grad():
            out["logits"].append(copy.deepcopy(model)(img, train=True).cpu())
        state, m = step(state, img, seg)
        out["loss"].append(float(m["loss"]))
        out["cm"].append(m["cm"].cpu())
    ev = make_seg_eval_step(model, num_classes=3, num_inst=4, overlap=2, device=device)(
        *(t.to(device) for t in eval_batch))
    out["eval"] = {k: v.cpu() for k, v in ev.items()}
    with torch.no_grad():
        out["eval_logits"] = model(eval_batch[0].to(device), train=False).cpu()
    out["state"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    out["updates"] = state.opt_state.gradient_step
    return out


def _ties(logits) -> int:
    """Pixels whose two class logits differ by less than ``SEG_TIE``."""
    return int(((logits[..., 1] - logits[..., 0]).abs() < SEG_TIE).sum())


def seg_mismatches(torch, got: dict, ref: dict, init: dict) -> list[str]:
    """What of ``got`` (the card) falls outside the ``SEG_*`` tolerances
    around ``ref`` (the CPU); ``init`` is the state both started from."""
    bad = []
    for i, (a, b) in enumerate(zip(got["loss"], ref["loss"])):
        if abs(a - b) > SEG_LOSS_RTOL * abs(b):
            bad.append(f"loss {i}: {a:.7f} vs {b:.7f}")
    pairs = [(f"train logits {i}", a, b) for i, (a, b) in
             enumerate(zip(got["logits"], ref["logits"]))]
    for name, a, b in pairs + [("eval logits", got["eval_logits"], ref["eval_logits"])]:
        err = float((a - b).abs().max())
        if err > SEG_LOGIT_ATOL:
            bad.append(f"{name}: max |diff| {err:.3e}")
    # a flipped pixel moves two cells of a matrix by one each
    cms = [(f"train cm {i}", a, b, _ties(lg)) for i, (a, b, lg) in
           enumerate(zip(got["cm"], ref["cm"], ref["logits"]))]
    ties = _ties(ref["eval_logits"])
    cms += [("eval cm", got["eval"]["cm"], ref["eval"]["cm"], ties),
            ("eval inst_cm", got["eval"]["inst_cm"], ref["eval"]["inst_cm"], ties)]
    for name, a, b, n_ties in cms:
        off = float((a - b).abs().sum())
        if off > 2 * n_ties:
            bad.append(f"{name}: {off:.0f} counts off, {n_ties} near-ties")
    if abs(got["eval"]["loss"].item() - ref["eval"]["loss"].item()) > \
            SEG_LOSS_RTOL * abs(ref["eval"]["loss"].item()):
        bad.append("eval loss")
    stats = [k for k in ref["state"] if "running" in k]
    worst = max(float((got["state"][k] - ref["state"][k]).abs().max()) for k in stats)
    if worst > SEG_STATS_ATOL:
        bad.append(f"running statistics: max |diff| {worst:.3e}")
    names = [k for k in ref["state"] if "running" not in k]
    d_got = torch.cat([(got["state"][k] - init[k]).flatten() for k in names])
    d_ref = torch.cat([(ref["state"][k] - init[k]).flatten() for k in names])
    rel = float((d_got - d_ref).norm() / d_ref.norm())
    if rel > SEG_UPDATE_REL or got["updates"] != ref["updates"]:
        bad.append(f"update: relative L2 error {rel:.3e}, updates {got['updates']} vs "
                   f"{ref['updates']}")
    log(f"    losses {[round(x, 6) for x in got['loss']]} (CPU "
        f"{[round(x, 6) for x in ref['loss']]}); running statistics max |diff| {worst:.3e}; "
        f"update relative L2 error {rel:.3e}; eval matrix counts off "
        f"{float((got['eval']['cm'] - ref['eval']['cm']).abs().sum()):.0f} ({ties} near-ties)")
    return bad


def tiny_seg_parity(torch) -> dict:
    """Phase 7a: a tiny SegUNet on the card against the CPU, then the same
    with torch's BatchNorm momentum on the card, which must fail."""
    import numpy as np

    from stedm_tpu_torch.models.segformer import BatchNorm, SegUNet

    rng = np.random.default_rng(0)
    p, b = 64, 2
    batches = [(torch.from_numpy(rng.normal(size=(b, p, p, 3)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, 3, (b, p, p)))) for _ in range(2)]
    eval_batch = (torch.from_numpy(rng.normal(size=(3, p, p, 3)).astype(np.float32)),
                  torch.from_numpy(rng.integers(0, 3, (3, p, p))), torch.tensor([0, 2, 5]),
                  torch.tensor([1, 0, 3]), torch.tensor([3, 1, 3]))
    torch.manual_seed(0)
    cpu_model = SegUNet(**SEG_TINY)
    init = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    ref = _seg_run(torch, cpu_model, "cpu", batches, eval_batch)
    result = {}
    for variant, momentum in (("flax BatchNorm (the port)", None),
                              ("torch's BatchNorm momentum 0.1 (wrong)", 0.9)):
        model = SegUNet(**SEG_TINY).cuda()
        model.load_state_dict(init)
        if momentum is not None:
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.momentum = momentum
        log(f"  {variant}:")
        bad = seg_mismatches(torch, _seg_run(torch, model, "cuda", batches, eval_batch),
                             ref, init)
        log(f"    outside tolerance: {bad or 'nothing'}")
        result["wrong" if momentum else "port"] = bad
    require(not result["port"], f"the tiny SegUNet on the card disagrees with the CPU: "
            f"{result['port']}")
    require(any("running statistics" in x for x in result["wrong"]),
            "the check accepted torch's BatchNorm momentum")
    return {"seg_parity_wrong_variant_rejected_by": result["wrong"]}


def seg_flagship(torch, out_dir: Path) -> dict:
    """Phase 7b: the shipped MiT-B2 U-Net trained and evaluated at the
    shapes of configs/config_seg.yaml; returns its numbers."""
    from stedm_tpu_torch.config import compose
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train.optim import scaled_lr
    from stedm_tpu_torch.train.seg_steps import (
        create_seg_state,
        make_seg_eval_step,
        make_seg_optimizer,
        make_seg_train_step,
    )
    from stedm_tpu_torch.train_seg import build_seg_model

    cfg = compose("config_seg", [])
    batch, accum, p = cfg.data.batch_base * cfg.location.batch_mul, \
        cfg.accumulate_grad_batches, cfg.data.patch_size
    lr = scaled_lr(cfg.base_lr, cfg.data.batch_base, cfg.location.batch_mul, 1, cfg.lr)
    model = build_seg_model(cfg, "cuda", seed=0)
    n_params = sum(x.numel() for x in model.parameters())
    tx = make_seg_optimizer(lr, accum)
    state = create_seg_state(model, tx)
    losses_kw = dict(ce_ratio=cfg.ce_ratio, dice_ratio=cfg.dice_ratio)
    step = make_seg_train_step(model, num_classes=cfg.data.num_classes,
                               overlap=cfg.data.overlap_train, **losses_kw)
    log(f"  {n_params:,} parameters, {model.dtype}, {p}^2, batch {batch}, accumulation "
        f"{accum}, lr {lr:.3e} (base_lr {cfg.base_lr} scaled), weight decay {tx.weight_decay}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand((batch, p, p, 3), generator=gen, device="cuda") * 2 - 1
    yy, xx = torch.meshgrid(torch.arange(p, device="cuda"), torch.arange(p, device="cuda"),
                            indexing="ij")
    centre = torch.rand((batch, 2), generator=gen, device="cuda") * p / 2 + p / 4
    seg = ((((yy - centre[:, :1, None]) / (p / 5)) ** 2
            + ((xx - centre[:, 1:, None]) / (p / 4)) ** 2) <= 1).long()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    reset_launch_counts()
    t1 = time.time()
    state, m = step(state, img, seg)
    torch.cuda.synchronize()
    cold_s = time.time() - t1
    counts = dict(LAUNCHES)
    log(f"  first micro-step {cold_s:.2f} s, loss {float(m['loss']):.5f}; launches in one "
        f"micro-step {counts} (no kernel of this package lies on this path)")
    for _ in range(accum - 1):
        state, m = step(state, img, seg)
    torch.cuda.synchronize()
    require(state.opt_state.gradient_step == 1, "the first update was not applied")
    after = model.state_dict()
    still = [k for k in before if "running" not in k and torch.equal(before[k], after[k])]
    stats_still = [k for k in before if "running" in k and torch.equal(before[k], after[k])]
    log(f"  after one applied update: {len(before) - 20 - len(still)} of {len(before) - 20} "
        f"parameter tensors and {20 - len(stats_still)} of 20 running-statistic buffers "
        f"moved; unmoved: {still}")
    # a key bias adds the same q.b to every logit of a row, which the softmax
    # cancels: its gradient is zero, and at lr 1e-6 its decay below rounding
    require(all(k.endswith("attn.k.bias") for k in still), f"parameters did not move: {still}")
    require(not stats_still, f"running statistics did not move: {stats_still}")
    del before, after

    torch.cuda.reset_peak_memory_stats()
    times, issue, losses = [], [], []
    for _ in range(4):                       # timed applied updates
        t1 = time.time()
        for _ in range(accum):
            state, m = step(state, img, seg)
            losses.append(m["loss"])
        # the step never waits for the card, so this is the host's time to
        # issue the update's work
        issue.append(time.time() - t1)
        torch.cuda.synchronize()
        times.append(time.time() - t1)
    require(bool(torch.isfinite(torch.stack(losses)).all()), "non-finite segmentation loss")
    require(state.opt_state.gradient_step == 5, "updates were not applied")
    median_s = _median(times)
    sps = batch * accum / median_s
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    issue_ms = _median(issue) / accum * 1e3
    log("  timed applied updates (4 micro-steps of 2 samples each): " + " ".join(
        f"{batch * accum / t:.4f}" for t in times) + f" samples/s; median {sps:.4f}; "
        f"peak memory {peak:.3f} GiB; losses {float(losses[0]):.5f} .. {float(losses[-1]):.5f}; "
        f"the host issues a micro-step in {issue_ms:.2f} ms (median)")

    evaluate = make_seg_eval_step(model, num_classes=cfg.data.num_classes,
                                  num_inst=cfg.data.num_val_inst, overlap=cfg.data.overlap_val,
                                  **losses_kw)
    zeros = torch.zeros(batch, dtype=torch.long, device="cuda")
    wsi = torch.arange(batch, device="cuda")
    ev = evaluate(img, seg, zeros, zeros, wsi)
    masked = batch * (p - 2 * cfg.data.overlap_val) ** 2
    require(bool(torch.isfinite(ev["loss"])) and float(ev["cm"].sum()) == masked
            and float(ev["inst_cm"].sum()) == masked, "eval step: loss or matrix counts")
    n_eval = 10
    eval_s = _median(timed_runs(torch, lambda: [evaluate(img, seg, zeros, zeros, wsi)
                                                for _ in range(n_eval)], 3))
    eval_ips = batch * n_eval / eval_s
    log(f"  eval: {eval_ips:.4f} images/s (median of three runs of {n_eval} batches); "
        f"loss {float(ev['loss']):.5f}")
    micro_ms = median_s / accum * 1e3
    kernels = profile_main_path(torch, lambda: step(state, img, seg), micro_ms, out_dir,
                                "profile_seg.txt", host_top=10)
    busy_ms = sum(ms for _, _, ms in kernels)
    n_kernels = sum(n for _, n, _ in kernels)
    log(f"  {n_kernels} device kernels a micro-step: {issue_ms / max(n_kernels, 1) * 1e3:.1f} "
        f"us of host time each against {busy_ms / max(n_kernels, 1) * 1e3:.1f} us of device "
        f"time")
    return dict(seg_train_samples_per_s=sps,
                seg_train_samples_per_s_runs=[batch * accum / t for t in times],
                seg_peak_mem_gib=peak, seg_eval_img_per_s=eval_ips,
                seg_micro_step_ms=micro_ms, seg_issue_ms=issue_ms, seg_profiled_busy_ms=busy_ms,
                seg_idle_share=1 - busy_ms / micro_ms, seg_kernels_per_micro_step=n_kernels,
                seg_launches_per_micro_step=counts, seg_params=n_params)


def seg_entry_point(torch, root: Path) -> dict:
    """Phase 7c: train_seg.main on phase 6's Flowers tree, with its exact
    predict output as ``flowers_syn``; returns its numbers and launches."""
    import json as json_

    from stedm_tpu_torch import train_seg
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train import checkpoints

    t0 = time.time()
    data, results = root / "data", root / "results_seg"
    args = ["data/dataset=[flowers_anno,flowers_syn]", "data.ratios=[0.2,0.8]",
            # phase 6's exact predict output (8 pairs at 512^2)
            "data.dataset.flowers_syn.folder_name=exact",
            f"location.data_dir={data}", f"location.result_dir={results}",
            # the cuts: the epoch's sample budget (10000) and the epochs (75)
            "data.samples=40", "num_epochs=2"]
    log(f"  train_seg.main({args})")
    reset_launch_counts()
    out = train_seg.main(args)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    run = Path(out["run_dir"])
    name = run.name
    for tag in ("last", "best"):
        f = checkpoints.checkpoint_file(run / "ckpt", f"{name}_{tag}")
        require(f.is_file(), f"{f.name} was not written")
        require(checkpoints.load(f)["format"] == "seg_state", f"{f.name} is no seg state")
    events = [json_.loads(ln) for ln in (run / "events.jsonl").read_text().splitlines()]
    logged = {k for e in events for k in e}
    missing = [k for k in SEG_EVENT_KEYS if k not in logged]
    require(not missing, f"keys the JAX entry point logs are missing: {missing}")
    ious = {k: v for e in events for k, v in e.items() if "IoU" in k and "Var" not in k}
    require(all(0.0 <= v <= 1.0 for v in ious.values()), f"IoUs outside [0, 1]: {ious}")
    require(set(out["tests"]) == {"last", "best"}, f"tests run: {sorted(out['tests'])}")
    losses = [e["loss"] for e in out["epochs"]] + [e["val"]["loss"] for e in out["epochs"]]
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    figures = sorted(q.name for q in run.glob("*_cm_*.png"))
    seconds = time.time() - t0
    ep = out["epochs"]
    log(f"  {len(ep)} epochs of {[e['micro_steps'] for e in ep]} micro-steps, train loss "
        f"{[round(e['loss'], 5) for e in ep]}, val loss {[round(e['val']['loss'], 5) for e in ep]}, "
        f"train samples/s over each epoch (first micro-steps and host data included) "
        f"{[round(e['samples'] / e['seconds'], 4) for e in ep]}; step {out['step']}")
    log(f"  Test IoU last {out['tests']['last']['Test (last) IoU Score']:.5f}, best "
        f"{out['tests']['best']['Test (best) IoU Score']:.5f}; CM figures {figures}; "
        f"launches {counts}; phase 7c took {seconds:.1f} s")
    return dict(seg_entry_counts=counts, seg_entry_seconds=seconds,
                seg_entry_ious=ious, seg_entry_epochs=ep)


# Phase 8's synthetic histopathology: slides at a size the published HER2
# slides' 10^5-pixel sides are cut to (an ArraySlide holds a slide and its
# pyramid in host memory), one ROI of about 4096^2 per annotated slide (not a
# multiple of the 512-pixel tile, so val tiles have cut margins), the shipped
# her2.yaml / her2_anno.yaml values otherwise
HER2_SLIDE, HER2_ROI, HER2_ROI_AT = 8192, 4000, 2048
HER2_IDS = {101: "train", 102: "val", 103: "test"}     # folds [[102]]
HER2_SCORING = ("5001", "5002")
HER2_LABELS = ("HER2 0", "HER2 1+", "HER2 2+", "HER2 3+", "DCIS")   # classes 1-5
# CATCH: slides named by subtype (catch_anno.yaml's label_dict value of each)
CATCH_SLIDES = (("Melanoma_01", 0, "train", 3), ("Trichoblastoma_02", 1, "train", 1),
                ("Melanoma_03", 2, "val", 3), ("SCC_04", 3, "test", 6))


def tissue_slide(rng, side: int):
    """An RGB slide: white background, tissue (a union of ellipses covering
    the centre) of a smooth random stain field."""
    import cv2
    import numpy as np
    from PIL import Image

    low = 512
    mask = np.zeros((low, low), np.uint8)
    cv2.ellipse(mask, (low // 2, low // 2), (low * 3 // 8, low * 3 // 8), 0, 0, 360, 1, -1)
    for _ in range(6):
        c = rng.integers(low // 8, low * 7 // 8, 2)
        r = rng.integers(low // 16, low // 6, 2)
        cv2.ellipse(mask, (int(c[0]), int(c[1])), (int(r[0]), int(r[1])),
                    float(rng.uniform(0, 180)), 0, 360, 1, -1)
    field = rng.integers(90, 230, (64, 64, 3), dtype=np.uint8)
    stain = np.asarray(Image.fromarray(field).resize((side, side), Image.BILINEAR))
    tissue = np.asarray(Image.fromarray(mask * 255).resize((side, side), Image.NEAREST)) > 0
    return np.where(tissue[..., None], stain, np.uint8(255))


def _blobs(rng, lo: int, hi: int, n: int, labels):
    """``n`` polygons (ellipses) with centres in [lo, hi)^2, cycling ``labels``."""
    import cv2
    import numpy as np

    out = []
    for i in range(n):
        c = rng.integers(lo + 300, hi - 300, 2)
        r = rng.integers(150, min(900, (hi - lo) // 4), 2)
        poly = cv2.ellipse2Poly((int(c[0]), int(c[1])), (int(r[0]), int(r[1])),
                                int(rng.integers(0, 180)), 0, 360, 15)
        out.append((poly.astype(np.float64), labels[i % len(labels)]))
    return out


def write_her2_tree(root: Path) -> list:
    """The HER2 tree under ``root``: her2_anno_her2_anno/{wsi, train_val.pkl,
    test.pkl} rasterised with the port's ``prep.rasterize_rois``, and the
    scoring slides (``<id>_HER2_IHC.svs``, JPEG content) with
    ``all_wsi_scores.csv`` (empty USE cells, one excluded row). Returns the
    overrides that point the shipped config at it."""
    import pickle

    import numpy as np
    from PIL import Image

    from stedm_tpu_torch.config import compose
    from stedm_tpu_torch.data.prep import rasterize_rois

    cfg = compose("config_diff", ["data=her2"])
    label_dict = dict(cfg.data.dataset.her2_anno.label_dict)
    base = root / "her2_anno_her2_anno"
    (base / "wsi").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lists = {"train_val": [], "test": []}
    lo, hi = HER2_ROI_AT, HER2_ROI_AT + HER2_ROI
    for num, split in HER2_IDS.items():
        name = f"slide_{num}.jpg"
        Image.fromarray(tissue_slide(rng, HER2_SLIDE)).save(base / "wsi" / name, quality=90)
        roi = dict(x1=lo, y1=lo, x2=hi, y2=hi)
        rois = rasterize_rois([roi], _blobs(rng, lo, hi, 8, HER2_LABELS), label_dict,
                              cfg.data.lookup_f, name)
        lists["test" if split == "test" else "train_val"] += rois
    for split, lst in lists.items():
        with open(base / f"{split}.pkl", "wb") as f:
            pickle.dump(lst, f)
    scoring = root / "scoring_wsi"
    scoring.mkdir()
    for sid in HER2_SCORING:
        Image.fromarray(tissue_slide(rng, HER2_SLIDE)).save(scoring / f"{sid}_HER2_IHC.svs",
                                                            format="JPEG", quality=90)
    (root / "all_wsi_scores.csv").write_text(
        "Tumorblock_ID;HERIHCScore;USE\n5001;2+;\n5002;3;\n5003;1;excluded\n")
    return ["data=her2", f"location.data_dir={root}",
            "data.dataset.her2_anno.score_dict={101: 0, 102: 0, 103: 1}",
            "data.dataset.her2_anno.folds=[[102]]"]


def write_catch_tree(root: Path) -> list:
    """The CATCH tree under ``root``: catch_catch_anno/{wsi, anno.hdf5,
    train.pkl, val.pkl, test.pkl}, each slide's tissue (value 0) and tumour
    (its subtype's class) polygons rasterised with the port's
    ``catch.rasterize_wsi_chunked`` (chunks of 8192). Returns the overrides."""
    import pickle

    import h5py
    import numpy as np
    from PIL import Image

    from stedm_tpu_torch.data.catch import rasterize_wsi_chunked

    base = root / "catch_catch_anno"
    (base / "wsi").mkdir(parents=True)
    rng = np.random.default_rng(1)
    lists = {"train": [], "val": [], "test": []}
    with h5py.File(base / "anno.hdf5", "w") as f:
        for name, num, split, cls in CATCH_SLIDES:
            Image.fromarray(tissue_slide(rng, HER2_SLIDE)).save(base / "wsi" / f"{name}.jpg",
                                                                quality=90)
            c = HER2_SLIDE // 2
            tissue = np.array([[c - 3000, c - 3000], [c + 3000, c - 3000],
                               [c + 3000, c + 3000], [c - 3000, c + 3000]], np.float64)
            conts = [(tissue, 0)] + [(p, cls) for p, _ in
                                     _blobs(rng, c - 2800, c + 2800, 5, (cls,))]
            offset, samp = rasterize_wsi_chunked(conts, f, str(num), 128, chunk_size=8192)
            lists[split].append((f"{name}.jpg", offset, samp, num))
    for split, lst in lists.items():
        with open(base / f"{split}.pkl", "wb") as fh:
            pickle.dump(lst, fh)
    return ["data=catch", f"location.data_dir={root}"]


def wsi_read_rates(args: list) -> dict:
    """Host throughput of the HER2 data path on this machine's CPU, one thread
    unless stated: opening a slide (JPEG decode and pyramid), patch reads
    (``wsi_sample``, and ``wsi_sample_batch`` on the pool), and a training
    item split into its reads, its ROI segmentation's PNG decode and its
    augmentations."""
    import cv2
    import numpy as np

    from stedm_tpu_torch.config import compose
    from stedm_tpu_torch.data import augment
    from stedm_tpu_torch.data.dm import DataModule
    from stedm_tpu_torch.data.wsi import open_slide, wsi_sample, wsi_sample_batch

    cfg = compose("config_diff", args)
    p, b = cfg.data.patch_size, cfg.data.base_scale
    dm = DataModule(cfg)
    dm.setup()
    ds = dm.data_modules["her2_anno"].train_dataset()
    roi = ds._img_l[0]
    t = time.perf_counter()
    slide = open_slide(roi[0])
    open_s = time.perf_counter() - t
    rng = np.random.default_rng(0)
    pos = rng.integers(p * b, HER2_SLIDE - p * b, (64, 2))
    t = time.perf_counter()
    for yx in pos:
        wsi_sample(slide, (0, 0), p, b, yx)
    single = len(pos) / (time.perf_counter() - t)
    t = time.perf_counter()
    wsi_sample_batch(slide, (0, 0), p, b, pos)
    pooled = len(pos) / (time.perf_counter() - t)
    n = 16
    t = time.perf_counter()
    for _ in range(n):
        cv2.imdecode(roi[2], cv2.IMREAD_ANYDEPTH)
    decode_s = (time.perf_counter() - t) / n
    trans, crop = augment.base_transforms(p), wsi_sample(slide, (0, 0), p, b, pos[0])
    seg = np.zeros((p * b, p * b), np.uint8)
    t = time.perf_counter()
    for i in range(n):
        trans(np.random.default_rng(i), crop, seg)
    augment_s = (time.perf_counter() - t) / n
    ds[0]   # this thread's slide handle
    t = time.perf_counter()
    for i in range(n):
        ds.__getitem__(i, rng=np.random.default_rng(i))
    item_s = (time.perf_counter() - t) / n
    out = dict(slide_open_s=open_s, patches_per_s_one_thread=single,
               patches_per_s_pool=pooled, roi_png_decode_ms=decode_s * 1e3,
               augment_ms=augment_s * 1e3, item_ms=item_s * 1e3,
               reads_ms_per_item=2e3 / single)
    log(f"  host, one thread: a slide opens in {open_s:.3f} s ({HER2_SLIDE}^2 JPEG and its "
        f"pyramid); wsi_sample {single:.1f} patches/s ({p}^2 at base scale {b}), "
        f"wsi_sample_batch on the pool {pooled:.1f} patches/s; a training item "
        f"{item_s * 1e3:.2f} ms: its two reads ~{2e3 / single:.2f} ms, the ROI PNG decode "
        f"{decode_s * 1e3:.2f} ms, the augmentations {augment_s * 1e3:.2f} ms")
    return out


def _launch_check(counts: dict, names, what: str) -> None:
    for k in names:
        require(counts.get(k, 0) > 0, f"no {k} launch inside {what}: {counts}")


def style_white_share(args: list, n: int = 16) -> dict:
    """The white share (every channel >= 253, ``tissue_mask``'s threshold) of
    the style patches that the scoring slides give predict, read as the
    sampler reads them (augmentations off; ``nearby`` moves a patch up to
    its own extent off the mask cell): ``n`` items of the port's
    ``HER2_DS_UnAnno``; and of reads centred on ``n`` mask cells, at the
    port's scale and at the JAX package's, ``kernel_size``, which lands 4x
    out on an ``ArraySlide``."""
    import numpy as np

    from stedm_tpu_torch.config import compose
    from stedm_tpu_torch.data import augment
    from stedm_tpu_torch.data.dm import DataModule
    from stedm_tpu_torch.data.wsi import wsi_sample

    cfg = compose("config_predict", args)
    p, b = cfg.data.patch_size, cfg.data.base_scale
    dm = DataModule(cfg)
    dm.setup()
    ds = dm.data_modules["her2_unanno"].predict_dataset()
    ds._transforms = ds._style_sampler._transforms = augment.eval_transforms(p)

    def white(patch) -> float:
        return float((np.asarray(patch).min(-1) >= 253).mean())

    port = []
    for i in range(n):
        style = ds.__getitem__(i, rng=np.random.default_rng(i))[3][0]
        port.append(white(np.rint((style + 1) / 2 * 255)))
    rng, centre, ref = np.random.default_rng(0), [], []
    for coords, step, (path, *_, key) in zip(ds._sample_list, ds._mask_steps, ds._ds_list):
        slide = ds._slides.get(key, path)
        for c in coords[rng.integers(0, len(coords), n // len(ds._sample_list))]:
            centre.append(white(wsi_sample(slide, (0, 0), p, b, (c[:2] + 0.5) * step)))
            ref.append(white(wsi_sample(slide, (0, 0), p, b, (c[:2] + 0.5) * ds.kernel_size)))
    out = dict(port_white_share=port, port_mostly_white=sum(w > 0.5 for w in port),
               centre_white_share=centre, centre_mostly_white=sum(w > 0.5 for w in centre),
               reference_white_share=ref, reference_mostly_white=sum(w > 0.5 for w in ref),
               mask_steps=ds._mask_steps, kernel_size=ds.kernel_size)
    log(f"  style patches from the scoring slides: mean white share {np.mean(port):.4f}, "
        f"{out['port_mostly_white']} of {n} mostly white; reads centred on mask cells: at the "
        f"port's scale (mask step {ds._mask_steps}) {np.mean(centre):.4f}, "
        f"{out['centre_mostly_white']} of {len(centre)} mostly white; at the JAX package's "
        f"(kernel_size {ds.kernel_size}) {np.mean(ref):.4f}, {out['reference_mostly_white']} "
        f"of {len(ref)} mostly white")
    require(out["port_mostly_white"] < n / 2,
            f"{out['port_mostly_white']} of {n} style patches are mostly white: {port}")
    return out


def histopathology(torch) -> dict:
    """Phase 8: the WSI reader chain and the entry points over HER2 (8a-8e)
    and CATCH (8f) at the shipped widths; returns its numbers, the launches
    of each call and what phase 11c needs of 8c (its tree stays)."""
    import importlib.util

    import numpy as np

    from stedm_tpu_torch import predict_diff, train_ae, train_diff, train_seg
    from stedm_tpu_torch.config import compose
    from stedm_tpu_torch.data.dm import DataModule
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train import checkpoints

    t0 = time.time()
    root = REPO / "build" / "chip_smoke_her2"
    shutil.rmtree(root, ignore_errors=True)
    data, results = root / "data", root / "results"
    log("== phase 8a: the synthetic HER2 tree")
    her2 = write_her2_tree(data) + [f"location.result_dir={results}"]
    log(f"  {len(HER2_IDS)} annotated slides of {HER2_SLIDE}^2 (train 101, val 102 by the "
        f"fold, test 103), one {HER2_ROI}^2 ROI each with classes 1-5, and "
        f"{len(HER2_SCORING)} scoring slides, written in {time.time() - t0:.1f} s; cut: "
        f"real HER2 slides are ~10^5 pixels a side and hold several ROIs, data.samples "
        f"10000 -> 16, num_epochs 10 (ae) / 25 (diff) / 75 (seg) -> 1, a resume, 2; the "
        f"shipped her2.yaml otherwise (patch 512, base scale 2, lookup_f 32, overlaps "
        f"64 / 128, 6 classes, batch 2)")
    rates = wsi_read_rates(her2)
    counts, out = {}, {"her2_wsi": rates}

    def run(name: str, main, args: list):
        log(f"  {main.__module__}.main({args})")
        reset_launch_counts()
        torch.cuda.synchronize()
        res = main(args)
        torch.cuda.synchronize()
        counts[name] = dict(LAUNCHES)
        log(f"    launches {counts[name]}")
        torch.cuda.empty_cache()
        return res

    log("== phase 8b: train_ae.main data=her2 (vq-f4 at 512^2, batch 2, bf16, disc_start 0, "
        "no LPIPS weights: the perceptual term off, as in the JAX entry point)")
    ae_args = her2 + ["data.samples=16", "num_epochs=1", "loss.disc_start=0"]
    ae = run("her2_ae", train_ae.main, ae_args)
    ep = ae["epochs"][0]
    require(ae["step"] == 8 and ep["steps"] == 8, f"codec steps {ae['step']}")
    require(all(np.isfinite(v) for v in {**ep["train"], **ep["val"]}.values()),
            f"non-finite codec logs {ep}")
    run_dir = Path(ae["run_dir"])
    for tag in ("last", "best"):
        f = checkpoints.checkpoint_file(run_dir / "ckpt", f"{run_dir.name}_{tag}")
        require(f.is_file() and checkpoints.load(f)["format"] == "ae_state",
                f"{f.name} was not written")
    saved = checkpoints.load(checkpoints.checkpoint_file(run_dir / "ckpt",
                                                         f"{run_dir.name}_last"))
    cfg = compose("config_ae", ae_args)
    fs = dict(cfg.diffusion.first_stage_config)
    with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
        torch.manual_seed(0)
        init = train_ae.build_codec(fs, dtype=torch.bfloat16)[0].state_dict()
    moved = sum(not torch.equal(init[k].cpu(), v) for k, v in saved["params"].items())
    require(moved > 0, "the codec did not move")
    log(f"  {ep['steps']} steps, {ep['steps'] * 2 / ep['seconds']:.4f} samples/s over the "
        f"epoch ({ep['seconds']:.2f} s, first steps included; data lap {ep['data_s']:.3f} s, "
        f"h2d {ep['h2d_s']:.3f} s); train nll_loss {ep['train']['train/nll_loss']:.5f}, "
        f"val rec_loss {ep['val']['val/rec_loss']:.5f}, perplexity "
        f"{ep['train']['train/perplexity']:.2f}; {moved} of {len(init)} codec tensors moved; "
        "_last and _best written")
    _launch_check(counts["her2_ae"], ("gn_silu", "flash_attention", "flash_attention_bwd",
                                      "nearest_code"), "train_ae.main")
    out["her2_ae"] = dict(samples_per_s=ep["steps"] * 2 / ep["seconds"], data_s=ep["data_s"],
                          h2d_s=ep["h2d_s"], seconds=ep["seconds"])
    del saved, init

    log("== phase 8c: train_diff.main data=her2 style_sampling=nearby (the landscape U-Net, "
        "VQ-f4, Swin-V2-T at 512^2, batch 2, accumulation 4), then a resume")
    diff_args = her2 + ["style_sampling=nearby", "data.samples=16", "num_epochs=1"]
    first = run("her2_train", train_diff.main, diff_args)
    resumed = train_diff.main(diff_args + ["+resume=true", "num_epochs=2"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    eps = first["epochs"] + resumed["epochs"]
    require(first["step"] == 8 and resumed["start_step"] == 8 and resumed["step"] == 16,
            f"steps {first['step']} / {resumed['start_step']} / {resumed['step']}")
    require(all(math.isfinite(e["loss"]) for e in eps), f"losses {[e['loss'] for e in eps]}")
    run_dir = Path(first["run_dir"])
    saved = checkpoints.load(checkpoints.checkpoint_file(run_dir / "ckpt",
                                                         f"{run_dir.name}_last"))
    mapper = tuple(saved["params"]["cond_stage.channel_mapper.weight"].shape)
    require(mapper == (3, 2, 1, 1), f"layout mapper {mapper}")
    del saved
    for e in eps:
        log(f"  epoch {e['epoch']}: {e['micro_steps']} micro-steps, loss {e['loss']:.5f}, "
            f"{e['samples'] / e['seconds']:.4f} samples/s ({e['seconds']:.2f} s; data lap "
            f"{e['data_s']:.3f} s, h2d {e['h2d_s']:.3f} s)")
    log(f"  the layout mapper is [2 -> 3] (weight {list(mapper)}): the one-hot of 6 classes "
        "collapsed to background / tumour, as the JAX entry point feeds and initialises it")
    _launch_check(counts["her2_train"], ("gn_silu", "flash_attention", "flash_attention_bwd"),
                  "train_diff.main")
    out["her2_train"] = [dict(samples_per_s=e["samples"] / e["seconds"], data_s=e["data_s"],
                              h2d_s=e["h2d_s"], seconds=e["seconds"]) for e in eps]

    log("== phase 8d: predict_diff.main data=her2 data/dataset=[her2_anno,her2_unanno] (layouts "
        "of the annotated slides, styles from the scoring slides), the run's EMA weights")
    readme = her2 + ["data/dataset=[her2_anno,her2_unanno]", "data.ratios=[1.0,1.0]",
                     "cfg_scale=1.5", "style_sampling=nearby", "data.samples=4", "+use_ema=true"]
    out["her2_style_white"] = style_white_share(readme)
    out["her2_predict"] = {}
    # cut, to make room for phase 12: the exact run at DDIM-50, not the
    # config's 128 (143 steps; its first batch took 11.4 s)
    for name, extra in (("exact", ["ddim_steps=50"]), ("serving", [
            "ddim_steps=50", "+cache_schedule=auto:5", "+cfg_interval=[0.35,0.65]"])):
        res = run(f"her2_predict_{name}", predict_diff.main,
                  readme + extra + [f"+predict_name={name}"])
        check_pairs(Path(res["predict_dir"]), 8, 512)
        out["her2_predict"][name] = {k: v for k, v in predict_rates(res).items()
                                     if k != "predict_dir"}
        _launch_check(counts[f"her2_predict_{name}"],
                      ("gn_silu", "flash_attention", "nearest_code"), "predict_diff.main")

    log("== phase 8e: train_seg.main data=her2 data/dataset=[her2_anno,her2_syn] "
        "data.ratios=[0.2,0.8] on 8d's exact pairs")
    t1 = time.time()
    seg_args = her2 + ["data/dataset=[her2_anno,her2_syn]", "data.ratios=[0.2,0.8]",
                       "data.dataset.her2_syn.folder_name=exact", "data.samples=20",
                       "num_epochs=1"]   # cut (PR 14): 2 epochs -> 1
    seg = run("her2_seg", train_seg.main, seg_args)
    out["her2_seg"] = check_seg_run(Path(seg["run_dir"]), seg, ("Val Patient IoU Score",
                                                                 "Val Patient IoU Var"))
    dm = DataModule(compose("config_seg", seg_args))
    dm.setup()
    val = dm.data_modules["her2_anno"].val_dataset()
    x_tiles = val._patcher._x_p
    cuts = val[x_tiles - 1][3]
    require(cuts[1] > 0, f"the last tile of the ROI's first row has cut margins {cuts}")
    log(f"  {len(val)} val tiles of 512^2 over the {HER2_ROI}^2 ROI; the last of its first row "
        f"cut by {cuts} (y, x) pixels; phase 8e took {time.time() - t1:.1f} s")

    out["catch"], not_run = None, []
    if importlib.util.find_spec("h5py") is None:
        log("8f not run: h5py is not installed")
        not_run = ["catch_train", "catch_seg"]
    else:
        log("== phase 8f: CATCH (base scale 8, lookup_f 128, 8 classes): train_diff.main for "
            "one update, train_seg.main for one epoch with the subtype IoU")
        t1 = time.time()
        catch_root = root / "catch"
        catch = write_catch_tree(catch_root) + [f"location.result_dir={results}"]
        log(f"  {len(CATCH_SLIDES)} slides of {HER2_SLIDE}^2 by subtype, segmentations in "
            f"anno.hdf5, written in {time.time() - t1:.1f} s; cut: data.samples 10000 -> 8, "
            "one epoch")
        c_train = run("catch_train", train_diff.main,
                      catch + ["style_sampling=nearby", "data.samples=8", "num_epochs=1"])
        require(c_train["step"] == 4 and math.isfinite(c_train["epochs"][0]["loss"]),
                f"CATCH training {c_train['step']} steps, loss {c_train['epochs'][0]['loss']}")
        c_seg = run("catch_seg", train_seg.main, catch + ["data.samples=8", "num_epochs=1"])
        metrics = check_seg_run(Path(c_seg["run_dir"]), c_seg, ("Val Subtype IoU Score",
                                                                "Val Subtype IoU Var"))
        out["catch"] = dict(seconds=time.time() - t1, seg=metrics,
                            train_epoch_s=c_train["epochs"][0]["seconds"])
        log(f"  phase 8f took {time.time() - t1:.1f} s")
    out["seconds"] = time.time() - t0
    log(f"  phase 8 took {out['seconds']:.1f} s (its tree stays for phase 11c)")
    keep = dict(root=root, diff_args=diff_args, threaded_epochs=eps,
                threaded_steps=first["step"])
    return {"her2_counts": counts, "paths_not_run": not_run, "histopathology": out,
            "her2_keep": keep}


def check_seg_run(run: Path, res: dict, extra_keys) -> dict:
    """A train_seg.main run: both checkpoints, every key the JAX entry point
    logs and ``extra_keys``, IoUs in [0, 1], finite losses."""
    import json as json_

    from stedm_tpu_torch.train import checkpoints

    for tag in ("last", "best"):
        f = checkpoints.checkpoint_file(run / "ckpt", f"{run.name}_{tag}")
        require(f.is_file() and checkpoints.load(f)["format"] == "seg_state",
                f"{f.name} was not written")
    events = [json_.loads(ln) for ln in (run / "events.jsonl").read_text().splitlines()]
    logged = {k for e in events for k in e}
    missing = [k for k in SEG_EVENT_KEYS + tuple(extra_keys) if k not in logged]
    require(not missing, f"{run.name}: keys missing from the event log: {missing}")
    ious = {k: v for e in events for k, v in e.items() if "IoU" in k and "Var" not in k}
    require(all(0.0 <= v <= 1.0 for v in ious.values()), f"IoUs outside [0, 1]: {ious}")
    losses = [e["loss"] for e in res["epochs"]] + [e["val"]["loss"] for e in res["epochs"]]
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    ep = res["epochs"]
    log(f"  {run.name}: {len(ep)} epochs of {[e['micro_steps'] for e in ep]} micro-steps, "
        f"train loss {[round(e['loss'], 5) for e in ep]}, val loss "
        f"{[round(e['val']['loss'], 5) for e in ep]}, samples/s "
        f"{[round(e['samples'] / e['seconds'], 4) for e in ep]}; IoUs {ious}")
    return dict(ious=ious, samples_per_s=[e["samples"] / e["seconds"] for e in ep])


# Phase 9's tolerance for the tiny card-against-CPU checks is phase 3's
# (TINY_TOL); its cuts: the canvas and the set-ViT's predict at 50 and 20
# DDIM steps (config_predict.yaml: 128), 8 micro-steps for the sViT run and 4
# for the hand-off's.
# The entry points' patch (configs/data/flowers.yaml)
ENTRY_PATCH = 512


def _sampler_runs(torch, model, batch, schedule, cfg, name: str, out_dir: Path,
                  card: str) -> dict:
    """Phase 9a for one method on the flagship: the eager loop (launches
    zeroed just before, read just after), the graph-replayed blocks (their
    latent equal to the eager one's bit for bit), warm img/s of both and the
    device time of a graph run."""
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train.host_sampler import make_host_sample_fn
    from stedm_tpu_torch.train.steps import make_sample_fn

    b = batch["segmentation"].shape[0]
    gen = torch.Generator(device="cuda")
    eager = make_sample_fn(model, schedule, cfg)
    reset_launch_counts()
    t1 = time.time()
    img, z_e = sample_with_latent(eager, model, batch, generator=gen.manual_seed(0))
    torch.cuda.synchronize()
    cold_s = time.time() - t1
    counts = dict(LAUNCHES)
    evals = counts["flash_attention"] - 1      # one bottleneck attention an eval, + the decode
    log(f"  {name} eager: cold run {cold_s:.2f} s; launches {counts}; U-Net evaluations {evals}")
    require(bool(torch.isfinite(img).all()) and float(img.float().std()) > 0,
            f"{name}: non-finite or flat images")
    require(bool(torch.isfinite(z_e).all()) and float(z_e.std()) > 0,
            f"{name}: non-finite or flat latent")
    want = cfg.ddim_steps + (cfg.method == "plms")
    require(evals == want, f"{name}: {evals} U-Net evaluations, not {want}")
    require(counts["nearest_code"] == 1, f"{name}: nearest-code launches {counts}")
    # cut, to make room for phase 12: two warm runs each, eager and as graphs
    eager_t = timed_runs(torch, lambda: eager(model, batch, generator=gen.manual_seed(0)), 2)
    host = make_host_sample_fn(model, schedule, cfg)
    t1 = time.time()
    _, z_g = sample_with_latent(host, model, batch, generator=gen.manual_seed(0))
    torch.cuda.synchronize()
    capture_s = time.time() - t1
    same = torch.equal(z_g, z_e)
    log(f"  {name} graph: blocks {host.block_sizes}; first call (warm-up, capture, replay) "
        f"{capture_s:.2f} s; launches at capture {host.capture_launches}; latent z_0 equals the "
        f"eager loop's bit for bit: {same} (max |diff| {float((z_g - z_e).abs().max()):.3e})")
    require(same, f"{name}: the graph-replayed latent differs from the eager loop's")
    graph_t = timed_runs(torch, lambda: host(model, batch, generator=gen.manual_seed(0)), 2)
    rates = {"eager": [b / t for t in eager_t], "graph": [b / t for t in graph_t]}
    for mode, r in rates.items():
        log(f"  {name} {mode} img/s (2 warm runs, host clock): "
            + " ".join(f"{x:.4f}" for x in r) + f"; median {_median(r):.4f} on {card}")
    kernels = profile_main_path(torch, lambda: host(model, batch, generator=gen.manual_seed(0)),
                                _median(graph_t) * 1e3, out_dir, f"profile_{name}_graph.txt")
    busy = sum(ms for _, _, ms in kernels)
    require(busy > 0, f"{name}: the profiler saw no device time")
    return dict(counts=counts, numbers=dict(
        evaluations=evals, img_per_s={k: _median(v) for k, v in rates.items()},
        img_per_s_runs=rates, graph_device_ms=busy, capture_s=capture_s,
        graph_idle_share=1 - busy / (_median(graph_t) * 1e3)))


def tiny_alt_parity(torch):
    """Phase 9a's and 9b's tiny checks: PLMS and DPM-Solver on the tiny STEDM,
    and a 2x-patch canvas (exact DDIM), card eager and graph against the CPU
    at phase 3's tolerance; each graph's latent equal to the card's eager
    latent bit for bit."""
    from stedm_tpu_torch.train.host_sampler import make_host_sample_fn
    from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn

    cpu, gpu, batch, x_T, sched = _tiny_sampling_models(torch)
    p = batch["segmentation"].shape[1]
    seg = torch.zeros(2, 2 * p, 2 * p, 2)
    seg[..., 0] = 1
    seg[:, 10:44, 20:60] = torch.tensor([0.0, 1.0])
    canvas = {"segmentation": seg, "style_imgs": batch["style_imgs"]}
    x_c = torch.randn(2, p // 2, p // 2, 3, generator=torch.Generator().manual_seed(6))
    base = dict(eta=0.0, cfg_scale=1.5, rescale_phi=0.7, batched_cfg=True, downsample=4)
    for what, kw, b, x in (("PLMS-6", dict(method="plms", ddim_steps=6), batch, x_T),
                           ("DPM-Solver++(2M)-6", dict(method="dpm", ddim_steps=6), batch, x_T),
                           ("2x-patch canvas, DDIM-4", dict(ddim_steps=4), canvas, x_c)):
        cfg = SamplerConfig(**base, **kw)
        ref = make_sample_fn(cpu, sched, cfg, device="cpu")(cpu, b, x_T=x)
        eager, z_e = sample_with_latent(make_sample_fn(gpu, sched, cfg), gpu, b, x_T=x)
        graph, z_g = sample_with_latent(make_host_sample_fn(gpu, sched, cfg, unroll=3), gpu, b,
                                        x_T=x)
        _tiny_close(torch, eager, ref, f"tiny {what}, card eager vs CPU")
        _tiny_close(torch, graph, ref, f"tiny {what}, card graph replay vs CPU")
        require(torch.equal(z_g, z_e), f"tiny {what}: the graph's latent differs from eager")


def generation_workflow(torch, entry_root: Path, out_dir: Path, card: str) -> tuple:
    """Phase 9: the rest of the generation workflow at the shipped widths:
    9a PLMS-50 and DPM-Solver++(2M)-50 on the flagship, eager and as graphs;
    9b a 2x-patch canvas through predict_diff.main on phase 6's tree; 9c
    train_diff.main and predict_diff.main with style_agg=svit; 9d the codec
    hand-off train_ae -> train_diff (+ a CompVis U-Net .ckpt) -> predict.
    Returns its numbers and the launches of each path."""
    from stedm_tpu_torch import predict_diff, train_ae, train_diff
    from stedm_tpu_torch.config import compose
    from stedm_tpu_torch.models.stedm import build_flagship, build_stedm
    from stedm_tpu_torch.models.svit import SViT
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.ops.tiled import tile_grid
    from stedm_tpu_torch.train import checkpoints
    from stedm_tpu_torch.train.optim import scaled_lr
    from stedm_tpu_torch.train.steps import SamplerConfig

    t0 = time.time()
    counts, out = {}, {}

    def run(name: str, main, args: list):
        log(f"  {main.__module__}.main({args})")
        reset_launch_counts()
        torch.cuda.synchronize()
        res = main(args)
        torch.cuda.synchronize()
        counts[name] = dict(LAUNCHES)
        log(f"    launches {counts[name]}")
        torch.cuda.empty_cache()
        return res

    log("== phase 9a: PLMS-50 and DPM-Solver++(2M)-50 on the flagship (256^2, batch 8, CFG "
        "1.5, phi 0.7, bf16), eager and as graphed host blocks; the tiny model and a tiny "
        "canvas, card against CPU")
    tiny_alt_parity(torch)
    model, batch, schedule = build_flagship(batch=8)
    base = dict(ddim_steps=50, eta=0.0, cfg_scale=1.5, rescale_phi=0.7, batched_cfg=True,
                downsample=4)
    for method, path in (("plms", "plms_batch"), ("dpm", "dpm_batch")):
        res = _sampler_runs(torch, model, batch, schedule, SamplerConfig(**base, method=method),
                            method, out_dir, card)
        counts[path] = res["counts"]
        out[f"sampler_{method}"] = res["numbers"]
    del model, batch
    torch.cuda.empty_cache()

    data, patch = entry_root / "data", ENTRY_PATCH
    where = [f"location.data_dir={data}", f"location.result_dir={entry_root / 'results'}"]
    readme = ["data=flowers", "data/dataset=[flowers_anno,flowers_unanno]",
              "data.ratios=[1.0,1.0]", "cfg_scale=1.5", "style_sampling=augmented",
              "style_agg=mean", *where, "+use_ema=true"]
    log(f"== phase 9b: predict_diff.main +canvas_size={2 * patch} (2 x 2 layouts of phase 6's "
        "tree a canvas, two canvases a batch, three batches, exact DDIM-25, the "
        "graph-replayed blocks)")
    t1 = time.time()
    # batches of 8 layouts make two canvases, so each tile's U-Net and decode
    # run at batch 2: the entry points' shapes that phase 2 holds the kernels
    # at (GN [2, 128^2, 128], FiLM [4, 32^2, 1024], flash [2, 1, 16384, 512]
    # and [4, 8, 1024, 128], nearest code at N 32768); three batches, since
    # predict writes the first batch's PNGs after it has issued the second
    res = run("canvas_predict", predict_diff.main, readme + [
        # cut (PR 14): DDIM-50 -> 25, halving the blocks captured as graphs
        f"+canvas_size={2 * patch}", "data.samples=12", "data.batch_size=8", "ddim_steps=25",
        "+predict_name=canvas"])
    check_pairs(Path(res["predict_dir"]), 6, 2 * patch)
    lat = patch // 4
    tiles = len(tile_grid(2 * lat, 2 * lat, lat, int(lat * 0.75)))
    out["canvas"] = dict(predict_rates(res), tiles_per_step=tiles, seconds=time.time() - t1)
    log(f"  {tiles} latent tiles of {lat}^2 a step on a {2 * lat}^2 latent canvas; phase 9b "
        f"took {out['canvas']['seconds']:.1f} s")
    require(counts["canvas_predict"]["nearest_code"] >= tiles,
            f"the canvas decode launched nearest code {counts['canvas_predict']}")

    log("== phase 9c: train_diff.main style_agg=svit (the shipped sViT: patch 8, dim 256, "
        "depth 6, 12 heads, dropout 0.1: 4098 tokens at 512^2) for 8 updates at lr 1e-4, then "
        "predict_diff.main on its checkpoint")
    t1 = time.time()
    # the U-Net's zero-initialised output convs pass the style no gradient
    # until two updates have moved the final conv and then the bottleneck
    # ResBlockStyle's, and the style's gradient grows with both; at the
    # config's lr (base_lr 1e-7 x batch 2) and accumulation 4 it stays below
    # AdamW's eps and the sViT moves by its weight decay alone (lr * 0.01 *
    # |p|). So the run takes lr 1e-4 and an update every micro-step
    # (overrides): 8 updates
    svit_args = ["data=flowers", "style_sampling=augmented", "style_agg=svit", *where,
                 "data.samples=16", "num_epochs=1", "+preview_ddim_steps=4", "lr=1e-4",
                 "accumulate_grad_batches=1"]
    torch.cuda.reset_peak_memory_stats()
    res = run("svit_train", train_diff.main, svit_args)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ep = res["epochs"][0]
    require(res["step"] == 8 and math.isfinite(ep["loss"]), f"sViT run: {res}")
    saved = checkpoints.load(f"{res['run_dir']}/ckpt/{Path(res['run_dir']).name}_last")
    cfg = compose("config_diff", svit_args)
    init = build_stedm(cfg, seed=0).agg.state_dict()
    lr = scaled_lr(cfg.base_lr, cfg.data.batch_base, cfg.location.batch_mul, 1, cfg.lr)
    step = {k: float((init[k].cpu() - saved["params"][f"agg.{k}"]).abs().max()) for k in init}
    moved = sum(d >= 0.5 * lr for d in step.values())
    require(moved > 0 and saved["opt"]["gradient_step"] == 8,
            f"{moved} sViT tensors moved by half the lr {lr:.3e} or more after "
            f"{saved['opt']['gradient_step']} updates")
    enc = SViT(image_size=patch, num_classes=512, dtype=torch.bfloat16,
               **{k: v for k, v in dict(cfg.style_agg).items() if k != "name"}).cuda()
    x = torch.rand(2, 1, patch, patch, 3, device="cuda") * 2 - 1
    g = torch.Generator(device="cuda").manual_seed(0)
    fwd_ms = time_ms(lambda: enc(x, train=True, generator=g), 5)
    fb_ms = time_ms(lambda: enc(x, train=True, generator=g).float().square().mean().backward(), 5)
    del enc, x, init, saved
    log(f"  sViT: {ep['micro_steps']} micro-steps, loss {ep['loss']:.5f}, "
        f"{ep['samples'] / ep['seconds']:.4f} samples/s over the epoch; {moved} of {len(step)} "
        f"sViT tensors moved by at least half the lr ({lr:.3e}; largest step "
        f"{max(step.values()):.3e}); peak memory {peak:.3f} GiB; the encoder alone at batch 2 "
        f"(train mode, CUDA events): forward {fwd_ms:.3f} ms, forward + backward {fb_ms:.3f} ms")
    pred = run("svit_predict", predict_diff.main, [
        "data=flowers", "data/dataset=[flowers_anno,flowers_unanno]", "data.ratios=[1.0,1.0]",
        "cfg_scale=1.5", "style_sampling=augmented", "style_agg=svit", *where,
        "data.samples=2", "ddim_steps=20", "+predict_name=svit"])
    check_pairs(Path(pred["predict_dir"]), 4, patch)
    out["svit"] = dict(peak_gib=peak, encoder_fwd_ms=fwd_ms, encoder_fwd_bwd_ms=fb_ms,
                       samples_per_s=ep["samples"] / ep["seconds"], moved=moved,
                       predict=predict_rates(pred), seconds=time.time() - t1)
    log(f"  phase 9c took {out['svit']['seconds']:.1f} s")

    log("== phase 9d: the codec hand-off: train_ae.main (vq-f4 at 512^2, batch 2, disc_start "
        "0) -> train_diff.main with its _best.pt as the first stage and a CompVis U-Net .ckpt "
        "(random weights) -> predict_diff.main")
    t1 = time.time()
    hand = entry_root / "handoff"
    hwhere = [f"location.data_dir={data}", f"location.result_dir={hand}"]
    ae = run("handoff_ae", train_ae.main, ["data=flowers", "style_sampling=augmented", *hwhere,
                                           "data.samples=8", "num_epochs=1",
                                           "loss.disc_start=0"])
    best = checkpoints.load(f"{ae['run_dir']}/ckpt/{Path(ae['run_dir']).name}_best")
    unet_sd = build_stedm(compose("config_diff", ["data=flowers", *hwhere]), seed=7,
                          device="cpu").unet.state_dict()
    hand.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": {f"model.diffusion_model.{k}": v for k, v in unet_sd.items()}},
               hand / "unet.ckpt")
    fs = f"diffusion.first_stage_config.params.ckpt_path={Path(ae['run_dir']).name}/ckpt/" \
         f"{Path(ae['run_dir']).name}_best.pt"
    h_args = ["data=flowers", "style_sampling=augmented", "style_agg=mean", *hwhere, fs,
              "diffusion.ckpt_path=unet.ckpt", "data.samples=8", "num_epochs=1",
              "+preview_ddim_steps=4"]
    tr = run("handoff_train", train_diff.main, h_args)
    n_codec, n_unet = len(best["params"]), len(unet_sd)
    log(f"  warm starts: {tr['warm_start']} (codec tensors {n_codec}, U-Net tensors {n_unet})")
    require(tr["warm_start"] == {"first_stage": (n_codec, 0), "diffusion": (n_unet, 0)},
            f"warm-start counts {tr['warm_start']}")
    saved = checkpoints.load(f"{tr['run_dir']}/ckpt/{Path(tr['run_dir']).name}_last")
    frozen = all(torch.equal(saved["params"][f"first_stage.{k}"], v)
                 for k, v in best["params"].items())
    moved = sum(not torch.equal(saved["params"][f"unet.{k}"], v) for k, v in unet_sd.items())
    log(f"  the codec after {tr['step']} micro-steps equals train_ae's _best bit for bit: "
        f"{frozen}; the U-Net moved from the .ckpt in {moved} of {n_unet} tensors")
    require(frozen, "the hand-off's codec differs from the train_ae checkpoint")
    require(moved > 0 and all(math.isfinite(e["loss"]) for e in tr["epochs"]),
            "the hand-off's U-Net did not train")
    del best, saved, unet_sd
    pred = run("handoff_predict", predict_diff.main, [
        "data=flowers", "data/dataset=[flowers_anno,flowers_unanno]", "data.ratios=[1.0,1.0]",
        "cfg_scale=1.5", "style_sampling=augmented", "style_agg=mean", *hwhere,
        "data.samples=2", "ddim_steps=20", "+predict_name=handoff"])
    check_pairs(Path(pred["predict_dir"]), 4, patch)
    out["handoff"] = dict(predict=predict_rates(pred), seconds=time.time() - t1,
                          ae_samples_per_s=ae["epochs"][0]["steps"] * 2
                          / ae["epochs"][0]["seconds"])
    out["seconds"] = time.time() - t0
    log(f"  phase 9d took {out['handoff']['seconds']:.1f} s; phase 9 took {out['seconds']:.1f} s")
    for name, c in counts.items():
        _launch_check(c, ("gn_silu", "flash_attention", "nearest_code")
                      + (("flash_attention_bwd",) if "train" in name or name == "handoff_ae"
                         else ()), name)
    return {f"phase9_{k}": v for k, v in out.items()}, counts


# Phase 10: the fp32 compute path (diffusion.compute_dtype=float32) and the
# wide-codebook path (CompVis vq-f8's 4 x 16384 and vq-f16's 8 x 16384
# codebooks on vq-f4's layout), on their own kernels: the fp32 flash forward
# and backward (3xTF32 wgmma), GN+SiLU at fp32, and nearest code at any
# width and codebook size (the streaming kernel).

# NVIDIA H100 SXM data sheet (dense): the TF32 tensor-core peak; the fp32
# flash kernels run every product as three TF32 products
TF32_FLOPS = 494.7e12
# phase 10a's tolerances: phase 2's and 2b's bf16 forms, 2^-7 (P|V| + |ref|)
# and 2^-7 (sqrt(sum terms^2) + |ref|), with 2^-7 replaced by 2^-16; a kernel
# that rounds its products to TF32 alone (2^-11) fails them, as the TF32
# control (the plain version with TF32 on) must show at every shape
F32_REL = 2 ** -16
# phase 10b's tolerance, card (kernels, fp32, TF32 off) against CPU (plain
# versions, fp32), relative (L2 norm for tensors): phase 3's bf16 tolerance
# tightened to what fp32 permits (other convolution algorithms and
# summation orders move each value by about 1e-6 of its size)
F32_TINY_TOL = 1e-4
# the update of 10b's tiny training, relative L2: Adam's first update is
# lr g / (|g| + 1e-8) an element, so where |g| lies near eps the gradients'
# relative differences of about 1e-5 become differences of the update's own
# size (at bf16, phase 3b allows 1.0)
F32_TINY_UPDATE_TOL = 1e-2
_LOG2E = 1.4426950408889634


def _ratio(torch, got, ref, tol) -> float:
    return float(((got.double() - ref.double()).abs() / tol).max())


F32_FORWARD_SHAPES = ((16, 8, 256, 128), (8, 1, 4096, 512), (8, 8, 1024, 128),
                      (8, 1, 16384, 512), (2, 1, 16384, 512), (1, 1, 2500, 512))


def f32_forward_checks(torch, rec, flush, shapes=F32_FORWARD_SHAPES, strided=True):
    """10a: the fp32 forward against attention_reference (fp32, TF32 off),
    a sample at a time, within 2^-16 (P|V| + |ref|); the LSE against
    torch.logsumexp; the TF32 control; times beside the plain version and
    SDPA at fp32; the AttentionBlock's strided views bit for bit against
    contiguous copies."""
    from stedm_tpu_torch.ops import blocked_attention as a

    gen = torch.Generator(device="cuda").manual_seed(21)
    # F32_FORWARD_SHAPES: the U-Net bottleneck sampling at 256^2 (CFG batch
    # 16) and training at 512^2; the VQ decoder at 256^2 and the encoder at
    # 512^2 (batch 8), the codec at 512^2 and batch 2 (its encode); a ragged T
    for shape in shapes:
        b, h, t, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        s = d ** -0.5
        got, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
        torch.cuda.synchronize()
        worst, ctrl, lse_ok, err = 0.0, 0.0, True, 0.0
        for i in range(b):
            sl = slice(i, i + 1)
            ref, lref = a.attention_reference(q[sl], k[sl], v[sl], s, return_lse=True)
            p = torch.softmax((q[sl] @ k[sl].transpose(-1, -2)) * s, -1)
            tol = F32_REL * (p @ v[sl].abs() + ref.abs())
            del p
            worst = max(worst, _ratio(torch, got[sl], ref, tol))
            err = max(err, float((got[sl] - ref).abs().max()))
            lse_ok &= bool(((lse[sl] - lref).abs() <= 1e-5 * lref.abs() + 1e-5).all())
            if i == 0:
                torch.backends.cuda.matmul.allow_tf32 = True
                bad = a.attention_reference(q[sl], k[sl], v[sl], s)
                torch.backends.cuda.matmul.allow_tf32 = False
                ctrl = _ratio(torch, bad, ref, tol)
                del bad
            del ref, tol
        again = a.flash_attention_cuda(q, k, v, s)
        same = torch.equal(again, got)
        log(f"  flash_attention_f32 {list(shape)}: {worst:.3f} of the tolerance 2^-16 (P|V| + "
            f"|ref|) (the earlier mma.sync kernel: 0.023-0.055); the plain version with TF32 "
            f"products {ctrl:.1f} of it (must exceed 1); "
            f"LSE within 1e-5 rel + 1e-5: {lse_ok}; two launches equal: {same}")
        require(ctrl > 1, f"the TF32 control passes the fp32 tolerance at {list(shape)}")
        require(lse_ok and same, f"the fp32 forward's LSE or run-to-run bits at {list(shape)}")
        iters = 10 if t <= 1024 else 3
        ms = time_ms(lambda: a.flash_attention_cuda(q, k, v, s), iters, flush)
        pms = time_ms(lambda: a.attention_reference(q, k, v, s), 2, flush)
        backend = sdpa_backend(torch, q, k, v, s)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=s),
                      iters, flush)
        log(f"  flash_attention_f32 {list(shape)}: SDPA at fp32 runs {backend}")
        bh = b * h
        rec.add(shape, err, worst <= 1, ms, pms, lib, 4 * bh * t * d * 4,
                3 * 4 * bh * t * t * d, TF32_FLOPS)
        del q, k, v, got, lse, again
        torch.cuda.empty_cache()
    if not strided:
        return
    # the AttentionBlock's views of its packed fp32 projection, O token-major
    proj = torch.randn((16, 256, 8, 3, 128), generator=gen, device="cuda")
    q, k, v = proj.permute(0, 2, 3, 1, 4).unbind(2)
    s = 128 ** -0.5
    out = torch.empty((16, 256, 8, 128), device="cuda").permute(0, 2, 1, 3)
    got = a.flash_attention_cuda(q, k, v, s, out=out)
    same = torch.equal(got, a.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                                   v.contiguous(), s))
    via = a.flash_attention(q, k, v, s)
    merged = via.transpose(1, 2).reshape(16, 256, 8 * 128)
    is_view = merged.data_ptr() == via.data_ptr()
    log(f"  flash_attention_f32 strided [16, 8, 256, 128] (views of a [16, 256, 8, 3, 128] fp32 "
        f"projection, O laid out [16, 256, 8, 128]): equal to the contiguous launch bit for "
        f"bit: {same}; flash_attention's output too: {torch.equal(via, got)}; the heads merge "
        f"as a view: {is_view}")
    require(same and torch.equal(via, got) and is_view,
            "the fp32 strided launch differs from the contiguous one")


def _f64_backward(torch, q, k, v, o, lse, do, s):
    """attention_backward_reference's steps in float64 (P from the LSE in the
    log2 domain, Di = rowsum(dO o O), dS = P o (dP - Di) * s) and each
    gradient's sqrt(sum terms^2)."""
    Q, K, V, O, DO = (x.double() for x in (q, k, v, o, do))
    P = torch.exp2((Q @ K.transpose(-1, -2)) * (s * _LOG2E) - lse.double()[..., None] * _LOG2E)
    dS = P * (DO @ V.transpose(-1, -2) - (DO * O).sum(-1, keepdim=True)) * s
    ref = (dS @ K, dS.transpose(-1, -2) @ Q, P.transpose(-1, -2) @ DO)
    bounds = ((dS.square() @ K.square()).sqrt(), (dS.transpose(-1, -2).square() @ Q.square()).sqrt(),
              (P.transpose(-1, -2).square() @ DO.square()).sqrt())
    return ref, bounds


def f32_backward_checks(torch, rec, flush, shapes=((8, 8, 1024, 128), (2, 8, 1024, 128),
                                                   (2, 1, 4096, 512), (2, 1, 16384, 512))):
    """10a: the fp32 backward (Di pass, dK/dV and dQ kernels) on the
    AttentionBlock's strided views and directly, two launches bit for bit,
    each gradient within 2^-16 (sqrt(sum terms^2) + |ref|) of the plain
    version's steps evaluated in float64; the fp32 plain version's own
    reading and the TF32 control logged beside it; times beside the plain
    version and SDPA's backward at fp32."""
    from stedm_tpu_torch.ops import blocked_attention as a

    gen = torch.Generator(device="cuda").manual_seed(22)
    for shape in shapes:
        b, h, t, dh = shape
        proj = torch.randn((b, t, h, 3, dh), generator=gen, device="cuda")
        qv, kv, vv = proj.permute(0, 2, 3, 1, 4).unbind(2)
        q, k, v = qv.contiguous(), kv.contiguous(), vv.contiguous()
        do_tm = torch.randn((b, t, h, dh), generator=gen, device="cuda")
        do = do_tm.permute(0, 2, 1, 3).contiguous()
        s = dh ** -0.5
        o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
        got = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
        again = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
        leaves = proj.detach().clone().requires_grad_()
        lq, lk, lv = leaves.permute(0, 2, 3, 1, 4).unbind(2)
        out_fn = a.flash_attention(lq, lk, lv, s)
        out_fn.transpose(1, 2).backward(do_tm)
        via = leaves.grad.permute(0, 2, 3, 1, 4).unbind(2)
        torch.cuda.synchronize()
        det = all(torch.equal(x, y) for x, y in zip(got, again))
        same = torch.equal(out_fn.detach(), o) and all(torch.equal(x, y) for x, y in zip(via, got))
        del again, leaves, out_fn, via
        worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
        plain32, vs32, ctrl, err = dict(worst), dict(worst), dict(worst), 0.0
        for i in range(b):
            sl = slice(i, i + 1)
            args = (q[sl], k[sl], v[sl], o[sl], lse[sl], do[sl], s)
            ref64, bounds = _f64_backward(torch, *args)
            r32 = a.attention_backward_reference(*args)
            if i == 0:
                torch.backends.cuda.matmul.allow_tf32 = True
                bad = a.attention_backward_reference(*args)
                torch.backends.cuda.matmul.allow_tf32 = False
            for j, name in enumerate(("dq", "dk", "dv")):
                tol = F32_REL * (bounds[j] + ref64[j].abs())
                worst[name] = max(worst[name], _ratio(torch, got[j][sl], ref64[j], tol))
                plain32[name] = max(plain32[name], _ratio(torch, r32[j], ref64[j], tol))
                vs32[name] = max(vs32[name], _ratio(torch, got[j][sl], r32[j],
                                                    F32_REL * (bounds[j] + r32[j].abs())))
                err = max(err, float((got[j][sl].double() - ref64[j]).abs().max()))
                if i == 0:
                    ctrl[name] = _ratio(torch, bad[j], ref64[j], tol)
                del tol
            del ref64, bounds, r32
            if i == 0:
                del bad
            torch.cuda.empty_cache()
        fmt = lambda d_: ", ".join(f"{n} {x:.3f}" for n, x in d_.items())
        log(f"  flash_attention_bwd_f32 {list(shape)}: against the plain version's steps in "
            f"float64, of the tolerance 2^-16 (sqrt(sum terms^2) + |ref|): kernel {fmt(worst)} "
            f"(the earlier mma.sync kernels: 0.113-0.213); "
            f"the fp32 plain version (cuBLAS, TF32 off) {fmt(plain32)}; the kernel against the "
            f"fp32 plain version {fmt(vs32)}; the TF32 control {fmt(ctrl)} (must exceed 1)")
        log(f"  two launches equal bit for bit: {det}; FlashAttentionFunction on the strided "
            f"views equals the direct launch: {same}")
        require(det and same, f"fp32 backward launches differ at {list(shape)}")
        require(all(x > 1 for x in ctrl.values()),
                f"the TF32 control passes the fp32 tolerance at {list(shape)}")
        iters = 5 if t <= 1024 else 2
        ms = time_ms(lambda: a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s), iters, flush)
        pms = time_ms(lambda: a.attention_backward_reference(q, k, v, o, lse, do, s), 2, flush)
        backend = sdpa_backend(torch, q, k, v, s)
        lv = [x.detach().requires_grad_() for x in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*lv, scale=s)
        lib = time_ms(lambda: torch.autograd.grad(out, lv, do, retain_graph=True), iters, flush)
        log(f"  flash_attention_bwd_f32 {list(shape)}: SDPA's backward at fp32 runs {backend}")
        del out, lv
        n = b * h * t * dh
        rec.add(shape, err, all(x <= 1 for x in worst.values()), ms, pms, lib,
                8 * n * 4 + b * h * t * 4, 3 * 10 * b * h * t * t * dh, TF32_FLOPS)
        del q, k, v, o, lse, do, got, proj
        torch.cuda.empty_cache()


def f32_gn_checks(torch, rec, flush):
    """10a: GN+SiLU at fp32 at the fp32 path's shapes against
    gn_silu_reference."""
    from stedm_tpu_torch.ops import gn_silu as g

    gen = torch.Generator(device="cuda").manual_seed(24)
    for shape, mode, eps in (((8, 64, 64, 128), "add", 1e-5), ((16, 64, 64, 640), "add", 1e-5),
                             ((16, 8, 8, 1024), "film", 1e-5), ((8, 256, 256, 256), "plain", 1e-6),
                             ((8, 128, 128, 128), "add", 1e-5), ((8, 32, 32, 1024), "film", 1e-5),
                             ((8, 512, 512, 128), "plain", 1e-6),
                             ((2, 512, 512, 128), "plain", 1e-6)):
        b, c = shape[0], shape[3]
        x = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
        kw = dict(eps=eps)
        if mode == "add":
            kw["add"] = 0.5 * torch.randn(b, c, generator=gen, device="cuda")
        elif mode == "film":
            kw["film_scale"] = 0.5 * torch.randn(b, c, generator=gen, device="cuda")
            kw["film_shift"] = 0.5 * torch.randn(b, c, generator=gen, device="cuda")
        got = g.gn_silu_cuda(x, gamma, beta, **kw)
        ref = g.gn_silu_reference(x, gamma, beta, **kw)
        torch.cuda.synchronize()
        # fp32 statistics summed in another order
        err, ok = bf16_close(got, ref, rel=1e-5, abs_=1e-5)
        ms = time_ms(lambda: g.gn_silu_cuda(x, gamma, beta, **kw), 10, flush)
        pms = time_ms(lambda: g.gn_silu_reference(x, gamma, beta, **kw), 3, flush)
        xc = x.permute(0, 3, 1, 2)
        lib = time_ms(lambda: torch.nn.functional.silu(
            torch.nn.functional.group_norm(xc, 32, gamma, beta, eps)), 10, flush)
        nbytes = 2 * x.numel() * 4 + 4 * 2 * c + 4 * b * c * (len(kw) - 1)
        rec.add(shape, err, ok, ms, pms, lib, nbytes, 10 * x.numel(), FP32_FLOPS)
        del x, got, ref
    log("  (gn_silu_f32 tolerance: 1e-5 |ref| + 1e-5, fp32 statistics in another order)")


def wide_nearest_checks(torch, rec_res, rec_stream, flush):
    """10a: nearest code at N 32768 and 131072 for widths 3, 4, 8 and 16 and
    codebooks up to 16384 codes, and two duplicated-code cases (exact ties
    must go to the lowest index); indices equal to the plain version's but at
    fp32 near-ties, as tests/test_torch_ops.py:_assert_codes_agree checks
    them. Each timing goes to the record of the kernel that ran."""
    from stedm_tpu_torch.ops import quantize as qz

    gen = torch.Generator(device="cuda").manual_seed(23)
    cases = [(n, w, ne, False) for n in (32768, 131072)
             for w, ne in ((3, 8192), (3, 16384), (4, 16384), (8, 16384), (16, 4096))]
    cases += [(32768, 4, 16384, True), (131072, 3, 16384, True)]
    for n, width, n_embed, dup in cases:
        cb = torch.randn(n_embed, width, generator=gen, device="cuda")
        if dup:                      # the second half repeats the first, neighbours too
            half = (n_embed + 1) // 2
            cb = torch.cat([cb[:half], cb[:half]])[:n_embed].contiguous()
            cb[1::7] = cb[0::7][:cb[1::7].shape[0]]
            z = cb[torch.randint(0, n_embed, (n,), generator=gen, device="cuda")].clone()
            z[::3] += 0.01 * torch.randn(z[::3].shape, generator=gen, device="cuda")
        else:
            z = torch.randn(n, width, generator=gen, device="cuda")
        plan = qz._launch_plan(n, n_embed, width, qz._device_active(0))
        got = qz.nearest_code_cuda(z, cb)
        ref = qz.nearest_code_reference(z, cb)
        torch.cuda.synchronize()
        diff = (got != ref).nonzero().flatten()
        z64, cb64 = z.double(), cb.double()
        d_got = ((z64[diff] - cb64[got[diff].long()]) ** 2).sum(1)
        d_ref = ((z64[diff] - cb64[ref[diff].long()]) ** 2).sum(1)
        tol = 1e-5 * (1 + (z64[diff] ** 2).sum(1))
        err = float((d_got - d_ref).abs().max()) if diff.numel() else 0.0
        ok = bool(((d_got - d_ref).abs() <= tol).all()) and diff.numel() <= max(1, n // 1000)
        ties = ""
        if dup:
            rows = [tuple(r) for r in cb.tolist()]
            first = {}
            for i, row in enumerate(rows):
                first.setdefault(row, i)
            lowest = all(first[rows[i]] == i for i in got.tolist())
            ok &= lowest
            ties = f"; every exact tie to its lowest index: {lowest}"
        same = torch.equal(got, qz.nearest_code_cuda(z, cb))
        ok &= same
        log(f"  nearest code N {n} x ({width}, {n_embed}){' duplicated codes' if dup else ''}: "
            f"the {plan['kernel']} kernel, split {plan['split']}; {diff.numel()} of {n} indices "
            f"differ (fp32 near-ties){ties}; two launches equal: {same}")
        ms = time_ms(lambda: qz.nearest_code_cuda(z, cb), 10, flush)
        pms = time_ms(lambda: qz.nearest_code_reference(z, cb), 3, flush)
        lib = time_ms(lambda: torch.cdist(z, cb).argmin(dim=1), 3, flush)
        rec = rec_res if plan["kernel"] == "resident" else rec_stream
        rec.add((n, width, n_embed) + (("duplicated",) if dup else ()), err, ok, ms, pms, lib,
                4 * width * (n + n_embed) + 4 * n, (2 * width + 1) * n * n_embed, FP32_FLOPS)


class PlainOnCard:
    """Counts calls of the plain attention and nearest-code versions that
    get a CUDA tensor (the wrappers send only CPU tensors there)."""

    NAMES = (("blocked_attention", "attention_reference"),
             ("blocked_attention", "attention_backward_reference"),
             ("flash_band", "forward_plain"), ("flash_band", "backward_plain"),
             ("quantize", "nearest_code_reference"))

    def __enter__(self):
        from stedm_tpu_torch.ops import blocked_attention, flash_band, quantize

        self.mods = {"blocked_attention": blocked_attention, "flash_band": flash_band,
                     "quantize": quantize}
        self.saved, self.calls = {}, 0
        for mod, name in self.NAMES:
            fn = getattr(self.mods[mod], name)
            self.saved[(mod, name)] = fn

            def counted(*args, _fn=fn, **kw):
                if any(getattr(x, "is_cuda", False) for x in args):
                    self.calls += 1
                return _fn(*args, **kw)

            setattr(self.mods[mod], name, counted)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(self.mods[mod], name, fn)


def _tiny_rel(torch, got, ref) -> float:
    return float((got.float().cpu() - ref.float()).norm() / ref.float().norm())


def f32_tiny_parity(torch, unet_options=None, suffix: str = "", schedule: str = "linear"):
    """10b: the tiny STEDM at fp32, DDIM-4 with rescaled CFG, then three
    micro-steps at accumulation 2, card (kernels) against CPU (plain
    versions), same weights, x_T, t and noise (phases 12b and 13b: with
    ``unet_options`` and ``schedule``, the flash kernels counted under their
    names + ``suffix``). Returns the launches of the sample and the
    micro-steps together."""
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn

    log(f"  tolerance {F32_TINY_TOL} relative (L2 norm for tensors): phase 3's bf16 tolerance "
        "tightened to what fp32 permits")
    cpu, gpu, batch, x_T, sched = _tiny_sampling_models(torch, torch.float32, unet_options,
                                                        schedule=schedule)
    cfg = SamplerConfig(ddim_steps=4, eta=0.0, cfg_scale=1.5, rescale_phi=0.7,
                        batched_cfg=True, downsample=4)
    ref = make_sample_fn(cpu, sched, cfg, device="cpu")(cpu, batch, x_T=x_T)
    reset_launch_counts()
    got = make_sample_fn(gpu, sched, cfg, device="cuda")(gpu, batch, x_T=x_T)
    torch.cuda.synchronize()
    counts = sampled = dict(LAUNCHES)
    rel = _tiny_rel(torch, got, ref)
    log(f"  tiny STEDM sampling at fp32, card vs CPU: relative L2 {rel:.3e}, max |diff| "
        f"{float((got.cpu() - ref).abs().max()):.3e}; launches {counts}")
    require(counts["flash_attention_f32" + suffix] > 0 and counts["flash_attention" + suffix] == 0,
            f"the fp32 sampler did not run the fp32 forward: {counts}")
    require(rel <= F32_TINY_TOL, "tiny fp32 sampling: the card disagrees with the CPU")
    runs = _tiny_train_runs(torch, torch.float32, unet_options, schedule)
    (lc, gc, dc, _), (lg, gg, dg, counts) = runs["cpu"], runs["cuda"]
    require(counts["flash_attention_bwd_f32" + suffix] >= 3
            and counts["flash_attention_bwd" + suffix] == 0,
            f"the fp32 training did not run the fp32 backward: {counts}")
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(lg, lc))
    log(f"  losses card {['%.7f' % x for x in lg]} cpu {['%.7f' % x for x in lc]}: max rel err "
        f"{loss_err:.3e}")
    ok = loss_err <= F32_TINY_TOL
    for group in ("unet", "cond_stage", "agg"):
        g_c, g_g = (torch.cat([g[k].flatten() for k in gc if k.startswith(group + ".")])
                    for g in (gc, gg))
        d_c, d_g = (torch.cat([d[k].flatten() for k in dc if k.startswith(group + ".")])
                    for d in (dc, dg))
        g_err, d_err = _tiny_rel(torch, g_g, g_c), _tiny_rel(torch, d_g, d_c)
        log(f"  {group}: gradient rel err {g_err:.3e}, update rel err {d_err:.3e} (tolerance "
            f"{F32_TINY_UPDATE_TOL}: Adam's g / (|g| + eps))")
        ok &= g_err <= F32_TINY_TOL and d_err <= F32_TINY_UPDATE_TOL
    log(f"  launches on the card {counts}")
    require(ok, "tiny fp32 training on the card disagrees with the CPU")
    return {k: sampled[k] + counts[k] for k in counts}


def f32_full_width(torch, out_dir: Path, card: str) -> tuple:
    """10c: the flagship at fp32: sampling eager and as graphs, a 512^2
    training micro-step, a vq-f4 codec step; the launches and plain calls of
    each, no CUDA tensor reaching a plain version."""
    from stedm_tpu_torch import train_ae
    from stedm_tpu_torch.models.lpips import LPIPS
    from stedm_tpu_torch.models.stedm import build_flagship
    from stedm_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_launch_counts
    from stedm_tpu_torch.train.ae_steps import ae_optimizers, create_ae_state, make_ae_train_step
    from stedm_tpu_torch.train.host_sampler import make_host_sample_fn
    from stedm_tpu_torch.train.optim import make_optimizer
    from stedm_tpu_torch.train.steps import (SamplerConfig, create_train_state, make_sample_fn,
                                             make_train_step)
    from stedm_tpu_torch.train.vae_losses import VAELossConfig, build_discriminator

    counts, out = {}, {}
    t0 = time.time()

    def counted(name, fn):
        reset_launch_counts()
        with PlainOnCard() as guard:
            res = fn()
            torch.cuda.synchronize()
        counts[name] = {**LAUNCHES, **{f"plain_{k}": v for k, v in PLAIN_CALLS.items()}}
        log(f"    launches {counts[name]}; plain versions given a CUDA tensor: {guard.calls}")
        require(guard.calls == 0, f"{name}: a plain version ran on the card")
        return res

    log("== phase 10c: the flagship at fp32 (256^2, batch 8, DDIM-25, CFG 1.5, phi 0.7), "
        "eager and as graphs")
    model, batch, schedule = build_flagship(batch=8, dtype=torch.float32)
    # cut, to make room for phase 12: DDIM-50 -> 25, five fp32 batches of ~6 s
    cfg = SamplerConfig(ddim_steps=25, eta=0.0, cfg_scale=1.5, rescale_phi=0.7,
                        batched_cfg=True, downsample=4)
    sample = make_sample_fn(model, schedule, cfg)
    gen = torch.Generator(device="cuda")
    img, z_e = counted("f32_sample_batch", lambda: sample_with_latent(
        sample, model, batch, generator=gen.manual_seed(0)))
    c = counts["f32_sample_batch"]
    require(tuple(img.shape) == (8, 256, 256, 3) and bool(torch.isfinite(img).all())
            and float(img.float().std()) > 0, "the fp32 flagship's images")
    require(c["flash_attention_f32"] >= 26 and c["flash_attention"] == 0
            and c["nearest_code"] == 1 and c["gn_silu"] > 0, f"fp32 sampling launches {c}")
    # a batch takes seconds at fp32 (cuDNN's fp32 convolutions, TF32 off):
    # one warm run each, eager and as graphs, and the profiled graph run
    eager = timed_runs(torch, lambda: sample(model, batch, generator=gen.manual_seed(0)), 1)
    host = make_host_sample_fn(model, schedule, cfg, unroll=10)
    _, z_g = sample_with_latent(host, model, batch, generator=gen.manual_seed(0))
    torch.cuda.synchronize()
    same = torch.equal(z_g, z_e)
    log(f"  graph exact at fp32: blocks {host.block_sizes}; launches at capture "
        f"{host.capture_launches}; latent z_0 equals the eager loop's bit for bit: {same} (max "
        f"|diff| {float((z_g - z_e).abs().max()):.3e})")
    require(same, "the fp32 graph latent differs from the eager loop's")
    graph = timed_runs(torch, lambda: host(model, batch, generator=gen.manual_seed(0)), 1)
    kernels = profile_main_path(torch, lambda: host(model, batch, generator=gen.manual_seed(0)),
                                graph[0] * 1e3, out_dir, "profile_f32_graph.txt")
    busy = sum(ms for _, _, ms in kernels)
    out["sample"] = dict(eager_img_per_s=8 / eager[0], graph_img_per_s=8 / graph[0],
                         graph_device_busy_ms=busy)
    log(f"  fp32 flagship img/s (host clock), eager {8 / eager[0]:.4f}, as graphs "
        f"{8 / graph[0]:.4f}; device busy {busy:.1f} ms a graphed batch on {card}; "
        f"10c's sampling took {time.time() - t0:.1f} s")
    del model, batch, sample, host, img, z_e, z_g
    torch.cuda.empty_cache()

    log("== phase 10c: a 512^2 training micro-step at fp32 (batch 8, AdamW, accumulation 4)")
    model, batch, schedule = build_flagship(batch=8, patch=512, nonzero_init=True,
                                            dtype=torch.float32)
    tx = make_optimizer(1e-4, accumulate_grad_batches=4, weight_decay=0.01)
    state = create_train_state(model, tx)
    step = make_train_step(model, schedule, tx)
    before = [p.detach().clone() for p in model.unet.parameters()]
    state, m = counted("f32_train_micro_step", lambda: step(state, batch, gen))
    c = counts["f32_train_micro_step"]
    require(bool(torch.isfinite(m["loss"])), "non-finite fp32 training loss")
    require(c["flash_attention_bwd_f32"] > 0 and c["flash_attention_f32"] > 0
            and c["flash_attention_bwd"] == 0, f"fp32 training launches {c}")
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    for _ in range(4):
        state, m = step(state, batch, gen)
        require(bool(torch.isfinite(m["loss"])), "non-finite fp32 training loss")
    torch.cuda.synchronize()
    sec = time.time() - t1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = sum(not torch.equal(b_, p) for b_, p in zip(before, model.unet.parameters()))
    require(state.opt_state.gradient_step >= 1 and moved > 0, "the fp32 U-Net did not move")
    out["train"] = dict(samples_per_s=32 / sec, peak_mem_gib=peak)
    log(f"  4 micro-steps of 8 (an applied update) in {sec:.2f} s: {32 / sec:.4f} samples/s; "
        f"peak memory {peak:.2f} GiB; loss {float(m['loss']):.5f}; {moved} U-Net tensors moved; "
        f"10c at {time.time() - t0:.1f} s")
    del model, batch, state, step, before, tx
    torch.cuda.empty_cache()

    log("== phase 10c: a vq-f4 codec fine-tuning step at fp32 (512^2, batch 2)")
    torch.manual_seed(0)
    codec, variant = train_ae.build_codec(train_ae.VQ_F4, dtype=torch.float32)
    codec.cuda()
    lcfg = VAELossConfig(**{**train_ae.AE_LOSS, "disc_start": 0})
    disc, lpips = build_discriminator(lcfg).cuda(), LPIPS().cuda()
    st = create_ae_state(codec, disc, *ae_optimizers(train_ae.scaled_lr(train_ae.BASE_LR, 1, 2)))
    astep = make_ae_train_step(codec, lcfg, lpips=lpips, variant=variant)
    img = torch.rand((2, 512, 512, 3), generator=gen.manual_seed(1), device="cuda") * 2 - 1
    before = [p.detach().clone() for p in codec.parameters()]
    st, lg, _ = counted("f32_codec_step", lambda: astep(st, img))
    c = counts["f32_codec_step"]
    require(c["flash_attention_bwd_f32"] == 2 and c["flash_attention_f32"] == 4
            and c["nearest_code"] >= 1, f"fp32 codec step launches {c}")
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    st, lg, _ = astep(st, img)
    torch.cuda.synchronize()
    sec = time.time() - t1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vals = {k: float(v) for k, v in lg.items()}
    require(all(math.isfinite(x) for x in vals.values()), f"non-finite fp32 codec logs {vals}")
    moved = sum(not torch.equal(b_, p) for b_, p in zip(before, codec.parameters()))
    require(moved > 0, "the fp32 codec did not move")
    # where the step's device time goes, and the fp32 flash kernels' share
    # (their split, stats and dQ passes included)
    kernels = profile_main_path(torch, lambda: astep(st, img), sec * 1e3, out_dir,
                                "profile_f32_codec.txt")
    busy = sum(ms for _, _, ms in kernels)
    flash = sum(ms for name, _, ms in kernels if re.search(F32_FLASH_KERNELS, name))
    out["codec"] = dict(samples_per_s=2 / sec, peak_mem_gib=peak, device_busy_ms=busy,
                        flash_ms=flash, flash_share=flash / busy if busy else None)
    log(f"  a step in {sec:.3f} s: {2 / sec:.4f} samples/s (with the earlier mma.sync flash "
        f"kernels, on an H100 80GB HBM3 at 700 W: 1.840 s, 1.0867 samples/s); peak memory "
        f"{peak:.2f} GiB; total_loss {vals['train/total_loss']:.4f}, perplexity "
        f"{vals['train/perplexity']:.1f}; {moved} codec tensors moved; device busy {busy:.1f} ms "
        f"a step, the fp32 flash kernels {flash:.1f} ms of it "
        f"({flash / busy if busy else 0:.1%}); 10c took {time.time() - t0:.1f} s")
    del codec, disc, lpips, st, astep, img, before
    torch.cuda.empty_cache()
    return out, counts


def f32_entry_points(torch, entry_root: Path) -> tuple:
    """10d: train_ae, train_diff and predict_diff at
    diffusion.compute_dtype=float32, then train_ae with CompVis vq-f8's and
    vq-f16's codebooks (embed_dim / z_channels / n_embed 4 / 4 / 16384 and
    8 / 8 / 16384) on vq-f4's layout, on phase 6's Flowers tree. The cuts:
    4 codec steps and 4 micro-steps (one update) a run, 4-step previews,
    and the 8 exact pairs at 10 DDIM steps (config_predict.yaml: 128; an
    fp32 step at 512^2 takes about 250 ms with cuDNN's fp32 convolutions)."""
    from stedm_tpu_torch import predict_diff, train_ae, train_diff
    from stedm_tpu_torch.config import compose
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train import checkpoints

    counts, out = {}, {}
    data, results = entry_root / "data", entry_root / "phase10"
    where = [f"location.data_dir={data}", f"location.result_dir={results}"]
    fp32 = ["diffusion.compute_dtype=float32"]

    def run(name: str, main, args: list):
        log(f"  {main.__module__}.main({args})")
        reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        with PlainOnCard() as guard:
            res = main(args)
            torch.cuda.synchronize()
        counts[name] = dict(LAUNCHES)
        log(f"    {time.time() - t1:.1f} s; launches {counts[name]}; plain versions given a CUDA "
            f"tensor: {guard.calls}")
        require(guard.calls == 0, f"{name}: a plain version ran on the card")
        torch.cuda.empty_cache()
        return res

    def codec_run(name: str, extra: list, dtype, want: tuple):
        args = ["data=flowers", "style_sampling=augmented", *where, "data.samples=8",
                "num_epochs=1", "loss.disc_start=0", f"run_name={name}", *extra]
        ae = run(name, train_ae.main, args)
        ep = ae["epochs"][0]
        require(ae["step"] == 4 and ep["steps"] == 4, f"{name}: codec steps {ae['step']}")
        require(all(math.isfinite(v) for v in {**ep["train"], **ep["val"]}.values()),
                f"{name}: non-finite codec logs {ep}")
        run_dir = Path(ae["run_dir"])
        files = sorted(p.name for p in (run_dir / "ckpt").iterdir())
        for tag in ("last", "best"):
            f = checkpoints.checkpoint_file(run_dir / "ckpt", f"{name}_{tag}")
            require(f.is_file(), f"{name}: {f.name} was not written")
        require((run_dir / "events.jsonl").is_file(), f"{name}: no events.jsonl")
        saved = checkpoints.load(checkpoints.checkpoint_file(run_dir / "ckpt", f"{name}_last"))
        fs = dict(compose("config_ae", args).diffusion.first_stage_config)
        with torch.random.fork_rng(devices=[0]), torch.device("cuda"):
            torch.manual_seed(0)
            init = train_ae.build_codec(fs, dtype=dtype)[0].state_dict()
        moved = sum(not torch.equal(init[k].cpu(), v) for k, v in saved["params"].items())
        require(moved > 0, f"{name}: the codec did not move")
        cb = saved["params"]["quantize.embedding.weight"]
        require(tuple(cb.shape) == want, f"{name}: codebook {tuple(cb.shape)}")
        used = ep["train"]["train/cluster_usage"], ep["val"]["val/cluster_usage"]
        log(f"  {name}: codebook {tuple(cb.shape)}; {ep['steps']} steps, "
            f"{ep['steps'] * 2 / ep['seconds']:.4f} samples/s over the epoch; train total_loss "
            f"{ep['train']['train/total_loss']:.5f}, val rec_loss "
            f"{ep['val']['val/rec_loss']:.5f}; distinct codes a step {used[0]:.1f} (train), "
            f"{used[1]:.1f} (val); {moved} of {len(init)} codec tensors moved; written {files}")
        out[name] = dict(samples_per_s=ep["steps"] * 2 / ep["seconds"], codes_used=used,
                         seconds=ep["seconds"])
        return ae

    log("== phase 10d: the entry points at diffusion.compute_dtype=float32 on phase 6's tree")
    codec_run("f32_entry_ae", fp32, torch.float32, (8192, 3))
    tr = run("f32_entry_train", train_diff.main,
             ["data=flowers", "style_sampling=augmented", "style_agg=mean", *where, *fp32,
              "data.samples=8", "num_epochs=1", "+preview_ddim_steps=4"])
    ep = tr["epochs"][0]
    require(tr["step"] == 4 and math.isfinite(ep["loss"]), f"fp32 train_diff: {tr['step']}")
    run_dir = Path(tr["run_dir"])
    saved = checkpoints.load(checkpoints.checkpoint_file(run_dir / "ckpt", run_dir.name + "_last"))
    require(saved["opt"]["gradient_step"] == 1, "fp32 train_diff applied no update")
    files = sorted(p.name for p in run_dir.iterdir())
    log(f"  fp32 train_diff: {ep['micro_steps']} micro-steps, loss {ep['loss']:.5f}, "
        f"{ep['samples'] / ep['seconds']:.4f} samples/s; an update applied; written {files}")
    out["f32_entry_train"] = dict(samples_per_s=ep["samples"] / ep["seconds"])
    del saved
    pred = run("f32_entry_predict", predict_diff.main,
               ["data=flowers", "data/dataset=[flowers_anno,flowers_unanno]",
                "data.ratios=[1.0,1.0]", "cfg_scale=1.5", "style_sampling=augmented",
                "style_agg=mean", *where, *fp32, "data.samples=2", "ddim_steps=4",
                # cut (PR 14): 4 pairs through the eager sampler; 10c holds the
                # fp32 graphs, whose capture at 512^2 took 31 s here; and,
                # for phase 12, DDIM-10 -> 4: its first batch took 17.3 s
                "+host_loop=false", "+predict_name=f32"])
    check_pairs(Path(pred["predict_dir"]), 4, ENTRY_PATCH)
    out["f32_entry_predict"] = {k: v for k, v in predict_rates(pred).items()
                                if k != "predict_dir"}
    log("== phase 10d: train_ae.main with vq-f8's and vq-f16's codebooks on vq-f4's layout")
    p = "diffusion.first_stage_config.params"
    for name, e in (("wide4_entry_ae", 4), ("wide8_entry_ae", 8)):
        codec_run(name, [f"{p}.embed_dim={e}", f"{p}.ddconfig.z_channels={e}",
                         f"{p}.n_embed=16384"], torch.bfloat16, (16384, e))
    for name, c in counts.items():
        names = (("gn_silu", "flash_attention_f32", "nearest_code") if name.startswith("f32")
                 else ("gn_silu", "flash_attention", "flash_attention_bwd", "nearest_code_stream"))
        if name in ("f32_entry_ae", "f32_entry_train"):
            names += ("flash_attention_bwd_f32",)
        _launch_check(c, names, name)
        if name.startswith("f32"):
            require(c["flash_attention"] == 0 and c["flash_attention_bwd"] == 0,
                    f"{name}: a bf16 flash kernel ran on the fp32 path: {c}")
    return out, counts


def fp32_and_wide(torch, entry_root: Path, out_dir: Path, card: str, recs: dict) -> tuple:
    """Phase 10, on phase 6's tree; returns its numbers and the launches of
    each path."""
    t0 = time.time()
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB: the L2 flush
    flush = scratch.zero_
    log("== phase 10a: the fp32 kernels and nearest code at every width, against their plain "
        "versions (TF32 off)")
    log(f"  card: {card}")
    f32_forward_checks(torch, recs["flash_attention_f32"], flush)
    f32_backward_checks(torch, recs["flash_attention_bwd_f32"], flush)
    f32_gn_checks(torch, recs["gn_silu_f32"], flush)
    wide_nearest_checks(torch, recs["nearest_code"], recs["nearest_code_stream"], flush)
    del scratch, flush
    torch.cuda.empty_cache()
    t_a = time.time() - t0
    log(f"  phase 10a took {t_a:.1f} s")
    log("== phase 10b: the tiny STEDM at fp32, card against CPU")
    t_b = time.time()
    f32_tiny_parity(torch)
    log(f"  phase 10b took {time.time() - t_b:.1f} s")
    full, counts = f32_full_width(torch, out_dir, card)
    entry, entry_counts = f32_entry_points(torch, entry_root)
    seconds = time.time() - t0
    log(f"  phase 10 took {seconds:.1f} s (10a {t_a:.1f} s)")
    return ({"phase10_full": full, "phase10_entry": entry, "phase10_seconds": seconds},
            {**counts, **entry_counts})


# the fp32 flash kernels' device kernels: the forward and the backward, their
# split pass, the backward's stats and dQ passes
F32_FLASH_KERNELS = r"flash_fwd_f32|flash_bwd_f32|split_tf32"

# device-kernel name patterns, first match wins
_CATEGORIES = (
    ("gn_silu (CUDA)", r"gn_silu_kernel"),
    ("fp32 flash split pass (CUDA)", r"split_tf32"),
    ("flash_attention (CUDA)", r"flash_fwd_"),
    ("flash_attention_bwd (CUDA)", r"flash_bwd"),
    ("nearest_code (CUDA)", r"nearest_code_kernel"),
    ("convolution (cuDNN)", r"conv|cudnn|fprop|dgrad|wgrad|implicit|xmma_.*(nhwc|nchw)"),
    ("matmul (cuBLAS)", r"gemm|cutlass|cublas|splitK|nvjet"),
    ("optimizer / EMA (foreach)", r"multi_tensor|foreach|fused_adam"),
    ("reduction (GN backward sums, ...)", r"reduce_kernel|Reduce"),
    ("dtype cast / layout copy", r"copy_kernel"),
    ("concatenation", r"CatArray"),
    ("elementwise (add, SiLU, upsample, ...)", r"elementwise|upsample|roll"),
)


def profile_main_path(torch, run, unprofiled_ms: float, out_dir: Path,
                      table: str = "profile.txt", host_top: int = 0) -> list:
    """Device time by kernel category over one warm main-path run
    (torch.profiler; CUDA kernel events only, so nothing counts twice). The
    idle share is also given against ``unprofiled_ms``, the wall time of the
    same run without the profiler's host overhead. ``host_top`` > 0 also
    logs that many host-side ops by self CPU time (profiler on, so inflated
    alike) and writes them all to ``<table stem>_host.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    kernels = [(ev.key, ev.count, ev.self_device_time_total / 1e3)
               for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy_ms = sum(ms for _, _, ms in kernels)
    if busy_ms == 0:
        log("  the profiler saw no device time")
        return kernels
    by_cat: dict[str, float] = {}
    for name, _, ms in kernels:
        cat = next((c for c, pat in _CATEGORIES if re.search(pat, name)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    log(f"  profiled run: wall {wall_ms:.1f} ms (profiler on), device busy {busy_ms:.1f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f}; against the unprofiled median wall "
        f"{unprofiled_ms:.1f} ms: {1 - busy_ms / unprofiled_ms:.3f}")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        log(f"    {cat:24s} {ms:9.2f} ms  {ms / busy_ms:6.1%}")
    top = sorted(kernels, key=lambda k: -k[2])
    (out_dir / table).write_text("\n".join(
        f"{ms:10.3f} ms {n:6d}x {name}" for name, n, ms in top))
    for name, n, ms in top[:8]:
        log(f"    top: {ms:8.2f} ms {n:5d}x {name[:100]}")
    if host_top:
        host = sorted(((ev.key, ev.count, ev.self_cpu_time_total / 1e3)
                       for ev in prof.key_averages() if ev.device_type == DeviceType.CPU),
                      key=lambda k: -k[2])
        (out_dir / table.replace(".txt", "_host.txt")).write_text("\n".join(
            f"{ms:10.3f} ms {n:6d}x {name}" for name, n, ms in host))
        log(f"    host ops (self CPU time, profiler on): {sum(ms for *_, ms in host):.1f} ms "
            f"over {sum(n for _, n, _ in host)} calls")
        for name, n, ms in host[:host_top]:
            log(f"    host: {ms:8.2f} ms {n:5d}x {name[:100]}")
    return kernels


# Phase 11: several processes, one card each (stedm_tpu_torch/parallel/dist.py).
# 11b's tolerance, two gloo ranks against one process at the same global
# batch, fp32 (TF32 off): the sums run in other orders (a rank's half batch,
# the all-reduce), so gradients differ in their last bits, and Adam's update
# of a gradient that is rounding noise takes either sign; every parameter
# within 2 lr an update and the mean over all within 1e-3 lr. A rank that
# draws t and the noise for its own rows only (``rank_rows`` dropped) moves
# most parameters by a sizeable fraction of lr.
DIST_LR, DIST_UPDATES, DIST_MEAN_TOL = 1e-4, 2, 1e-3
DIST_TRAIN = ["data=flowers", "style_sampling=augmented", "style_agg=mean", "lr=1e-4",
              "diffusion.compute_dtype=float32", "data.patch_size=64",
              "diffusion.unet_config.params.model_channels=32",
              "diffusion.unet_config.params.num_res_blocks=1",
              "diffusion.unet_config.params.num_heads=4",
              "diffusion.first_stage_config.params.ddconfig.ch=32",
              "diffusion.first_stage_config.params.ddconfig.num_res_blocks=1",
              "diffusion.first_stage_config.params.n_embed=256", "data.test_folder=null",
              "+diffusion.scale_by_std=true", "data.samples=16", "num_epochs=1",
              "accumulate_grad_batches=2"]
DIST_PREDICT = ["data=flowers", "data/dataset=[flowers_anno,flowers_unanno]",
                "data.ratios=[1.0,1.0]", "style_sampling=augmented", "style_agg=mean",
                "diffusion.compute_dtype=float32", "data.patch_size=64",
                "diffusion.unet_config.params.model_channels=32",
                "diffusion.unet_config.params.num_res_blocks=1",
                "diffusion.unet_config.params.num_heads=4",
                "diffusion.first_stage_config.params.ddconfig.ch=32",
                "diffusion.first_stage_config.params.ddconfig.num_res_blocks=1",
                "diffusion.first_stage_config.params.n_embed=256", "data.samples=4",
                "ddim_steps=10"]
DIST_GLOBAL_BATCH = 4
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_worker(mode: str, data: str, results: str, out: str) -> int:
    """One process of phase 11b (``chip_smoke.py --dist-worker``): ``one``
    is a plain process; ``rank`` and ``local_draws`` are ranks of a gloo
    group on ``cuda:0`` (NCCL refuses two ranks on one device), the latter
    with each rank drawing t and the noise for its own rows only. Trains
    and predicts at the global batch of ``DIST_GLOBAL_BATCH``; writes the
    returned numbers to ``out``."""
    import torch

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from stedm_tpu_torch import predict_diff, train_diff
    from stedm_tpu_torch.parallel import dist

    if mode != "one":
        torch.distributed.init_process_group("gloo", init_method="env://")
    if mode == "local_draws":
        dist.rank_rows = lambda sample, shape, **kw: sample(tuple(shape), **kw)
    world = dist.world_size()
    where = [f"location.data_dir={data}", f"location.result_dir={results}",
             f"location.mesh.data={world}", f"data.batch_size={DIST_GLOBAL_BATCH // world}"]
    got = {"world": world, "backend": torch.distributed.get_backend() if world > 1 else None}
    got["train"] = train_diff.main(DIST_TRAIN + where)
    if mode != "local_draws":
        got["predict"] = predict_diff.main(DIST_PREDICT + where + [
            f"+predict_name={Path(results).name}"])
    Path(out).write_text(json.dumps(got, default=str))
    if world > 1:
        torch.distributed.destroy_process_group()
    return 0


def _param_reading(torch, a: dict, b: dict) -> tuple[float, float]:
    """(max, mean) |a - b| over the float tensors, in units of lr."""
    diffs = [(a[k].double() - b[k].double()).abs() for k in a if a[k].is_floating_point()]
    n = sum(d.numel() for d in diffs)
    return (float(max(d.max() for d in diffs)) / DIST_LR,
            float(sum(d.sum() for d in diffs)) / n / DIST_LR)


def _loader_item_ms(loader, workers: int) -> tuple[float, int]:
    """One pass of ``loader`` alone: the host ms a worker spends on an item
    with all ``workers`` busy (wall time x workers / items), and the items."""
    t = time.perf_counter()
    n = sum(len(b[0]) for b in loader)
    return (time.perf_counter() - t) * workers / max(n, 1) * 1e3, n


def several_processes(torch, entry_root: Path, her2: dict, card: str) -> tuple[dict, dict]:
    """Phase 11: 11a a one-process torchrun-style launch over NCCL
    (``train_diff`` 2 micro-steps at accumulation 2, ``predict_diff`` 8
    pairs) on phase 6's tree; 11b two gloo ranks on this card against one
    process, and the variant without the ranks' rows of the draws, which
    must fail; 11c phase 8's HER2 ``train_diff`` epoch through the
    worker-process loader (``location.loader=grain``, 4 workers) beside the
    threaded loader's. Removes phase 8's tree. Returns its numbers and the
    launches of 11a's calls."""
    import threading

    t0 = time.time()
    data, root = entry_root / "data", entry_root / "phase11"
    out, counts = nccl_launch(torch, data, root)
    # 11c's workers spawn (and open their slides) while 11b's processes run
    loaders = {}
    spawn = threading.Thread(target=lambda: loaders.update(her2_loaders(her2)))
    spawn.start()
    out["gloo"] = two_ranks(torch, data, root)
    spawn.join()
    require("workers" in loaders, "11c: the worker loader did not start")
    out["her2_loaders"] = worker_loader_epoch(torch, her2, **loaders)
    out["seconds"] = time.time() - t0
    log(f"  phase 11 took {out['seconds']:.1f} s on {card}")
    return {"phase11": out}, counts


def nccl_launch(torch, data: Path, root: Path) -> tuple[dict, dict]:
    """Phase 11a; returns its numbers and its calls' launches."""
    import os

    from stedm_tpu_torch import predict_diff, train_diff
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.parallel import dist
    from stedm_tpu_torch.train import checkpoints

    counts, out = {}, {}
    log("== phase 11a: a one-process torchrun-style launch (RANK, WORLD_SIZE, LOCAL_RANK, "
        "MASTER_ADDR, MASTER_PORT set), NCCL: train_diff (2 micro-steps, accumulation 2) "
        "and predict_diff (8 pairs, DDIM-20) on phase 6's tree at the shipped widths")
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                      MASTER_PORT=str(free_port()))
    where = [f"location.data_dir={data}", f"location.result_dir={root / 'nccl'}"]
    reset_launch_counts()
    train = train_diff.main(["data=flowers", "style_sampling=augmented", "style_agg=mean",
                             *where, "+diffusion.scale_by_std=true", "data.samples=4",
                             "num_epochs=1", "accumulate_grad_batches=2",
                             "data.test_folder=null"])
    torch.cuda.synchronize()
    counts["dist_train"] = dict(LAUNCHES)
    backend = torch.distributed.get_backend()
    require(backend == "nccl" and dist.world_size() == 1, f"backend {backend}")
    saved = checkpoints.load(checkpoints.checkpoint_file(f"{train['run_dir']}/ckpt",
                                                         Path(train["run_dir"]).name + "_last"))
    require(train["step"] == 2 and saved["opt"]["gradient_step"] == 1,
            f"steps {train['step']}, updates {saved['opt']['gradient_step']}")
    del saved
    reset_launch_counts()
    pred = predict_diff.main(["data=flowers", "data/dataset=[flowers_anno,flowers_unanno]",
                              "data.ratios=[1.0,1.0]", "style_sampling=augmented",
                              "style_agg=mean", *where, "data.samples=4", "ddim_steps=20",
                              "+predict_name=phase11a"])
    torch.cuda.synchronize()
    counts["dist_predict"] = dict(LAUNCHES)
    check_pairs(Path(pred["predict_dir"]), 8, 512)
    torch.distributed.destroy_process_group()
    for k in TORCHRUN_ENV:
        os.environ.pop(k)
    ep = train["epochs"][0]
    out["nccl"] = dict(train_samples_per_s=ep["samples"] / ep["seconds"], pairs=pred["pairs"],
                       predict=predict_rates(pred))
    log(f"  backend {backend}, world 1: {ep['micro_steps']} micro-steps, 1 update, loss "
        f"{ep['loss']:.5f}, {ep['samples'] / ep['seconds']:.4f} samples/s; {pred['pairs']} "
        f"pairs; launches train {counts['dist_train']}, predict {counts['dist_predict']}")
    for name in ("dist_train", "dist_predict"):
        _launch_check(counts[name], ("gn_silu", "flash_attention"), name)
    require(counts["dist_train"]["flash_attention_bwd"] > 0, "no flash backward in 11a")
    torch.cuda.empty_cache()
    return out, counts


def two_ranks(torch, data: Path, root: Path) -> dict:
    """Phase 11b; returns its readings."""
    import os

    import numpy as np
    from PIL import Image

    from stedm_tpu_torch.train import checkpoints

    t1 = time.time()
    log(f"== phase 11b: two gloo ranks sharing this card against one process, global batch "
        f"{DIST_GLOBAL_BATCH}, fp32 at reduced widths (patch 64, U-Net 32 channels, codec 32): "
        f"train_diff {2 * DIST_UPDATES} micro-steps at accumulation 2 ({DIST_UPDATES} updates, "
        f"scale_by_std), predict_diff 8 pairs (DDIM-10) from each run's checkpoint; then the "
        f"ranks without their rows of the draws")
    port, port_bad = free_port(), free_port()
    root.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, mode, env in (
            ("one", "one", {}),
            *((f"rank{r}", "rank", {"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                                    "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
              for r in range(2)),
            *((f"bad{r}", "local_draws", {"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                                          "MASTER_ADDR": "localhost",
                                          "MASTER_PORT": str(port_bad)}) for r in range(2))):
        results = root / {"one": "one", "rank": "two", "local_draws": "bad"}[mode]
        env = {**{k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}, **env}
        procs.append((tag, results, subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dist-worker", mode, str(data),
             str(results), str(root / f"{tag}.json")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    runs = {}
    for tag, results, proc in procs:
        try:
            text, _ = proc.communicate(timeout=600)
        finally:
            proc.kill()
        (root / f"{tag}.log").write_text(text)
        require(proc.returncode == 0, f"11b worker {tag} failed:\n{text[-3000:]}")
        runs[tag] = (json.loads((root / f"{tag}.json").read_text()), results)

    def params(results):
        run = "diff_flowers_augmented_mean"
        return checkpoints.load(results / run / "ckpt" / f"{run}_last")

    ref, two, bad = (params(runs[t][1]) for t in ("one", "rank0", "bad0"))
    require(ref["step"] == two["step"] == bad["step"] == 2 * DIST_UPDATES
            and two["opt"]["gradient_step"] == DIST_UPDATES, "11b steps")
    readings = {}
    for name, other in (("ranks", two), ("local_draws", bad)):
        readings[name] = {k: _param_reading(torch, ref[k], other[k]) for k in ("params", "ema")}
    max_tol = 2 * DIST_UPDATES
    for name, r in readings.items():
        log(f"  {name}: parameters max {r['params'][0]:.4g} lr, mean {r['params'][1]:.4g} lr; "
            f"EMA max {r['ema'][0]:.4g} lr, mean {r['ema'][1]:.4g} lr (tolerance: max "
            f"{max_tol} lr, mean {DIST_MEAN_TOL} lr)")
    ok = {name: all(m <= max_tol and mean <= DIST_MEAN_TOL for m, mean in r.values())
          for name, r in readings.items()}
    require(ok["ranks"], "two ranks did not train the parameters of one process")
    require(not ok["local_draws"], "the check passed ranks that draw for their own rows only")
    sf = [runs[t][0]["train"]["scale_factor"] for t in ("one", "rank0", "rank1")]
    require(abs(sf[1] - sf[0]) <= 1e-6 * abs(sf[0]) and sf[1] == sf[2], f"scale factors {sf}")
    require(runs["rank0"][0]["backend"] == "gloo", "11b backend")
    want, got = data / "syn_data" / "one", data / "syn_data" / "two"
    names = sorted(p.name for p in want.glob("*.png"))
    require(len(names) == 16 and names == sorted(p.name for p in got.glob("*.png")),
            f"pairs {len(names)}")
    img_diff, seg_equal = 0, True
    for name in names:
        a, b = np.array(Image.open(want / name)), np.array(Image.open(got / name))
        if name.startswith("seg"):
            seg_equal &= bool(np.array_equal(a, b))
        else:
            img_diff = max(img_diff, int(np.abs(a.astype(int) - b.astype(int)).max()))
    pairs = [runs[t][0]["predict"]["pairs"] for t in ("one", "rank0", "rank1")]
    log(f"  scale factors one / rank 0 / rank 1: {sf}; pairs written {pairs}; seg PNGs "
        f"equal: {seg_equal}; images max |diff| {img_diff} (tolerance 1); 11b took "
        f"{time.time() - t1:.1f} s")
    require(pairs == [8, 4, 4] and seg_equal and img_diff <= 1, "11b predict")
    return dict(readings=readings, scale_factors=sf, img_max_diff=img_diff,
                seconds=time.time() - t1)


def _grain_args(her2: dict) -> list:
    return her2["diff_args"] + ["location.loader=grain", "location.n_workers=4",
                                f"location.result_dir={her2['root'] / 'grain'}", "num_epochs=2"]


def her2_loaders(her2: dict) -> dict:
    """Phase 11c's loader alone: phase 8c's HER2 train dataset through the
    worker loader (4 workers), its first pass (the spawn included, timed
    while phase 11b runs beside it)."""
    from stedm_tpu_torch.config import compose
    from stedm_tpu_torch.data.dm import DataModule

    cfg = compose("config_diff", _grain_args(her2))
    cfg.data.batch_size = cfg.data.batch_base * cfg.location.batch_mul   # as train_diff sets it
    dm = DataModule(cfg)
    dm.setup()
    workers = dm.train_loader(seed=0)
    spawn_ms, _ = _loader_item_ms(workers, 4)
    return {"workers": workers, "spawn_ms": spawn_ms}


def worker_loader_epoch(torch, her2: dict, workers, spawn_ms: float) -> dict:
    """Phase 11c; removes phase 8's tree; returns each loader's numbers."""
    import gc
    import multiprocessing

    from stedm_tpu_torch import train_diff
    from stedm_tpu_torch.data.loader import Loader
    from stedm_tpu_torch.data.worker_loader import WorkerLoader
    from stedm_tpu_torch.ops import reset_launch_counts

    t1 = time.time()
    log("== phase 11c: phase 8c's HER2 train_diff epoch through the worker-process loader "
        "(location.loader=grain, 4 worker processes) beside phase 8c's threaded loader (4 "
        "threads)")
    grain = _grain_args(her2)
    require(isinstance(workers, WorkerLoader), f"loader {type(workers).__name__}")
    w_ms_warm, n = _loader_item_ms(workers, 4)     # spawned and first pass beside 11b
    workers.close()
    threads = Loader(workers.dataset, workers.batch_size, shuffle=True, num_workers=4)
    _loader_item_ms(threads, 4)                    # this process's slides opened
    t_ms, _ = _loader_item_ms(threads, 4)
    reset_launch_counts()
    run = train_diff.main(grain)
    torch.cuda.synchronize()
    gc.collect()
    left = multiprocessing.active_children()
    require(not left, f"worker processes left running: {left}")
    # epoch 0 of each run: threads start with it, workers are spawned in it;
    # epoch 1: 8c's resumed run (fresh threads), the workers kept
    def row(e, item_ms):
        return dict(samples_per_s=e["samples"] / e["seconds"],
                    data_share=e["data_s"] / e["seconds"], item_ms=item_ms,
                    seconds=e["seconds"])

    (t0_, t1_), (w0_, w1_) = her2["threaded_epochs"], run["epochs"]
    rows = {"threads_epoch0": row(t0_, t_ms), "threads_epoch1": row(t1_, t_ms),
            "workers_epoch0": row(w0_, spawn_ms), "workers_epoch1": row(w1_, w_ms_warm)}
    require(run["step"] == 2 * her2["threaded_steps"]
            and all(math.isfinite(e["loss"]) for e in run["epochs"]),
            f"grain epochs: {run['step']} steps, losses {[e['loss'] for e in run['epochs']]}")
    for name, r in rows.items():
        log(f"  {name}: {r['samples_per_s']:.4f} samples/s, data lap {100 * r['data_share']:.1f} "
            f"% of the epoch ({r['seconds']:.2f} s), item {r['item_ms']:.2f} ms of a worker "
            f"(the loader alone over {n} items)")
    log(f"  (epoch 0 spawns the workers; their item ms there is the loader's first pass, "
        f"the spawn included, timed beside phase 11b); 11c took {time.time() - t1:.1f} s")
    shutil.rmtree(her2["root"], ignore_errors=True)
    return rows


# ---- phase 12: the diffusion model's options ----

# the options of the JAX U-Net that phase 12c runs at the landscape widths:
# FiLM in every ResBlock, ResBlocks that resample, 32-wide heads (the
# bottleneck AttentionBlock at Dh 32)
OPTIONS_12C = dict(use_scale_shift_norm=True, resblock_updown=True, num_head_channels=32)
# 12b's tiny models: the same with the resampling convs off (Dh 32 at the
# 256-channel bottleneck), then the spatial transformer under crossattn
OPTIONS_12B = dict(OPTIONS_12C, conv_resample=False)
OPTIONS_12B_ST = dict(use_spatial_transformer=True, transformer_depth=2, num_head_channels=32)
UNET_KEY = "diffusion.unet_config.params."
# 12d: the overrides of the spatial transformer's entry-point run
OVERRIDES_12D = [UNET_KEY + "use_spatial_transformer=true", UNET_KEY + "dropout=0.1",
                 "diffusion.conditioning_key=crossattn", "diffusion.beta_schedule=cosine",
                 "+adamw_m_bf16=true"]
# 12e: 12c's U-Net through the entry points (batch 2; predict's CFG batch 4)
OVERRIDES_12E = [UNET_KEY + "use_scale_shift_norm=true", UNET_KEY + "resblock_updown=true",
                 "+" + UNET_KEY + "num_head_channels=32"]
# the scale-shift ResBlocks' GroupNorm at 256^2 sampling, batch 8: the FiLM
# of U-Net levels 0, 1 and 2
FILM_CASES = (((8, 64, 64, 128), "film", 1e-5), ((8, 32, 32, 512), "film", 1e-5),
              ((8, 16, 16, 1024), "film", 1e-5))


def options_kernels(torch, recs):
    """12a: the bf16 forward and the fp32 kernels at Dh 32 against their
    plain versions (phase 2b's and 10a's tolerance forms; the bf16
    backward's Dh-32 instance: 13a), and GroupNorm with FiLM at the
    scale-shift ResBlocks' shapes, forward and backward."""
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # the L2 flush
    flush = scratch.zero_
    log("  -- bf16 forward: 12c's sampling bottleneck (CFG batch 16) and 512^2 micro-step "
        "(batch 8), the entry points' (batch 2, predict's CFG batch 4)")
    check_attention(torch, recs["flash_attention_dh32"], flush,
                    shapes=((16, 32, 256, 32), (8, 32, 1024, 32), (2, 32, 1024, 32),
                            (4, 32, 1024, 32)), strided=False)
    log("  -- fp32 forward and backward (the Dh-32 instances): the sampling bottleneck, 12c's "
        "fp32 micro-step and the entry points' batch 2")
    f32_forward_checks(torch, recs["flash_attention_f32_dh32"], flush,
                       shapes=((16, 32, 256, 32), (8, 32, 1024, 32), (2, 32, 1024, 32)),
                       strided=False)
    f32_backward_checks(torch, recs["flash_attention_bwd_f32_dh32"], flush,
                        shapes=((8, 32, 1024, 32), (2, 32, 1024, 32)))
    log("  -- GroupNorm + FiLM + SiLU at the scale-shift ResBlocks' shapes, forward and "
        "backward")
    check_gn(torch, recs["gn_silu_film"], flush, cases=FILM_CASES)
    check_gn_backward(torch, flush, cases=tuple((c[0], c[1]) for c in FILM_CASES))
    del scratch, flush
    torch.cuda.empty_cache()


def options_tiny_parity(torch):
    """12b: tiny STEDMs with the new options, card against CPU: OPTIONS_12B
    under the cosine schedule sampled (DDIM-4, rescaled CFG) in bf16
    (phase 3's tolerance), then sampled and trained (three micro-steps) at
    fp32 (10b's); the spatial transformer under crossattn sampled in bf16."""
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn

    cfg = SamplerConfig(ddim_steps=4, eta=0.0, cfg_scale=1.5, rescale_phi=0.7,
                        batched_cfg=True, downsample=4)
    for opts, key in ((OPTIONS_12B, "hybrid"), (OPTIONS_12B_ST, "crossattn")):
        cpu, gpu, batch, x_T, sched = _tiny_sampling_models(torch, torch.bfloat16, opts, key,
                                                            "cosine")
        ref = make_sample_fn(cpu, sched, cfg, device="cpu")(cpu, batch, x_T=x_T)
        reset_launch_counts()
        got = make_sample_fn(gpu, sched, cfg, device="cuda")(gpu, batch, x_T=x_T)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        _tiny_close(torch, got, ref, f"tiny STEDM {key} {opts} (cosine) card vs CPU")
        log(f"    launches {counts}")
        # the AttentionBlock at Dh 32 (none under the spatial transformer,
        # whose attention is plain torch); flash_attention counts the codec's
        require((counts["flash_attention_dh32"] > 0) == (key == "hybrid"),
                f"the tiny {key} sampler's launches {counts}")
        require(key != "hybrid" or counts["gn_silu_film"] > 0, f"no FiLM launch: {counts}")
        del cpu, gpu
    # training held at fp32 (10b's tolerances): in bf16 this model's
    # gradients move 12-24 % between bf16 and fp32 on the CPU (the shipped
    # tiny model's 3-5 %), past phase 3b's 0.3 for two bf16 runs
    f32_tiny_parity(torch, OPTIONS_12B, "_dh32", "cosine")


def options_sampler(torch, model, batch, schedule, out_dir: Path, card: str,
                    landscape_ms: float) -> tuple:
    """12c's sampler (256^2, batch 8, DDIM-50, CFG 1.5, phi 0.7, shared-encoder
    CFG) on ``model``: its launches and numbers."""
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn

    n_params = sum(p.numel() for p in model.unet.parameters())
    cfg = SamplerConfig(ddim_steps=50, eta=0.0, cfg_scale=1.5, rescale_phi=0.7,
                        batched_cfg=True, downsample=4)
    sample = make_sample_fn(model, schedule, cfg)
    gen = torch.Generator(device="cuda")
    reset_launch_counts()
    t1 = time.time()
    img = sample(model, batch, generator=gen.manual_seed(0))
    torch.cuda.synchronize()
    cold_s = time.time() - t1
    c = dict(LAUNCHES)
    log(f"  U-Net with {OPTIONS_12C}: {n_params} parameters; cold batch {cold_s:.2f} s; "
        f"launches {c}")
    require(tuple(img.shape) == (8, 256, 256, 3) and bool(torch.isfinite(img).all()),
            "the options' flagship sample is not finite of shape [8, 256, 256, 3]")
    require(float(img.float().std()) > 0.0, "flat output")
    require(c["flash_attention_dh32"] >= 50 and c["flash_attention"] >= 1
            and c["gn_silu_film"] > 0 and c["nearest_code"] == 1,
            f"the options' sampler did not run the Dh-32 forward and FiLM: {c}")
    times = timed_runs(torch, lambda: sample(model, batch, generator=gen.manual_seed(0)), 2)
    median_s = _median(times)
    kernels = profile_main_path(torch, lambda: sample(model, batch, generator=gen.manual_seed(0)),
                                median_s * 1e3, out_dir, "profile_options.txt")
    busy_ms = sum(ms for _, _, ms in kernels)
    log(f"  options' flagship: warm img/s " + " ".join(f"{8 / t:.4f}" for t in times)
        + f" (median {8 / median_s:.4f}); device time a batch {busy_ms:.1f} ms, against "
        f"{landscape_ms:.1f} ms for the landscape U-Net in phase 5 of this run, on {card}")
    return c, dict(img_per_s=8 / median_s, img_per_s_runs=[8 / t for t in times],
                   device_ms_per_batch=busy_ms, landscape_device_ms=landscape_ms, cold_s=cold_s)


def options_flagship(torch, out_dir: Path, card: str, landscape_ms: float) -> tuple:
    """12c: the landscape U-Net under OPTIONS_12C: the flagship sampler, then
    a 512^2 training micro-step in bf16 and at fp32. Returns the numbers and
    each path's launches."""
    from stedm_tpu_torch.models.attention import AttentionBlock
    from stedm_tpu_torch.models.stedm import build_flagship
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train.optim import make_optimizer
    from stedm_tpu_torch.train.steps import create_train_state, make_train_step

    counts, out = {}, {}
    model, batch, schedule = build_flagship(batch=8, unet_options=OPTIONS_12C)
    counts["opt_sample_batch"], out["sample"] = options_sampler(
        torch, model, batch, schedule, out_dir, card, landscape_ms)
    del model, batch
    torch.cuda.empty_cache()

    for dtype, name in ((torch.bfloat16, "opt_train_micro_step"),
                        (torch.float32, "opt_f32_train_micro_step")):
        model, batch, schedule = build_flagship(batch=8, patch=512, nonzero_init=True,
                                                dtype=dtype, unet_options=OPTIONS_12C)
        # accumulation 2: the first micro-step's gradients stay to be read
        tx = make_optimizer(1e-4, accumulate_grad_batches=2)
        state = create_train_state(model, tx)
        step = make_train_step(model, schedule, tx)
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t1 = time.time()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        cold_s = time.time() - t1
        counts[name] = c = dict(LAUNCHES)
        n_attn = sum(isinstance(x, AttentionBlock) for x in model.unet.modules())
        sfx = "_f32" if dtype == torch.float32 else ""
        log(f"  {name}: first micro-step {cold_s:.2f} s, loss {float(m['loss']):.5f}; launches "
            f"{c}; AttentionBlocks {n_attn}")
        require(bool(torch.isfinite(m["loss"])), f"{name}: non-finite loss")
        require(c[f"flash_attention_bwd{sfx}_dh32"] == n_attn
                and c[f"flash_attention{sfx}_dh32"] >= n_attn,
                f"{name}: {n_attn} AttentionBlocks, launches {c}")
        qkv = [p.grad for n, p in model.unet.named_parameters() if n.endswith("qkv.weight")]
        require(float(qkv[0].float().norm()) > 0, f"{name}: the attention's qkv got no gradient")
        times = []
        for _ in range(2):
            t1 = time.time()
            state, m = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.time() - t1)
        require(bool(torch.isfinite(m["loss"])) and state.opt_state.gradient_step == 1,
                f"{name}: non-finite loss, or the update not applied")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[name] = dict(samples_per_s=[8 / t for t in times], peak_mem_gib=peak)
        log(f"  {name}: warm micro-steps " + " ".join(f"{8 / t:.4f}" for t in times)
            + f" samples/s (the first applies the update); peak memory {peak:.2f} GiB")
        del model, batch, state, step, tx
        torch.cuda.empty_cache()
    return out, counts


def options_entry_points(torch, entry_root: Path) -> tuple:
    """12d: train_diff (2 micro-steps) and predict_diff (8 pairs, DDIM-20)
    with the spatial transformer, U-Net dropout 0.1, crossattn, the cosine
    schedule and a bf16 first moment, then train_ae (2 steps) with codec
    dropout 0.1; 12e: train_diff and predict_diff with 12c's U-Net (the
    Dh-32 kernels at the entry points' batch 2). On phase 6's tree."""
    from stedm_tpu_torch import predict_diff, train_ae, train_diff
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train import checkpoints

    data, patch = entry_root / "data", 512
    counts, out = {}, {}

    def run(name: str, main, args: list):
        log(f"  {main.__module__}.main({args})")
        reset_launch_counts()
        torch.cuda.synchronize()
        res = main(args)
        torch.cuda.synchronize()
        counts[name] = dict(LAUNCHES)
        log(f"    launches {counts[name]}")
        torch.cuda.empty_cache()
        return res

    for tag, overrides in (("opt", OVERRIDES_12D), ("opt_dh32", OVERRIDES_12E)):
        t1 = time.time()
        where = [f"location.data_dir={data}", f"location.result_dir={entry_root / tag}"]
        style = ["data=flowers", "style_sampling=augmented", "style_agg=mean", *where]
        tr = run(f"{tag}_entry_train", train_diff.main, style + overrides + [
            "+diffusion.scale_by_std=true", "data.samples=4", "num_epochs=1",
            "+preview_ddim_steps=4", "accumulate_grad_batches=1"])
        ep = tr["epochs"][0]
        require(tr["step"] == 2 and math.isfinite(ep["loss"]), f"{tag}: train_diff {tr['step']} "
                f"steps, loss {ep['loss']}")
        ckpt = checkpoints.load(checkpoints.checkpoint_file(
            f"{tr['run_dir']}/ckpt", Path(tr["run_dir"]).name + "_last"))
        if "+adamw_m_bf16=true" in overrides:
            m_dtypes = {v["exp_avg"].dtype for v in ckpt["opt"]["adamw"]["state"].values()}
            log(f"    the checkpoint's first moments: {m_dtypes}")
            require(m_dtypes == {torch.bfloat16}, f"first moments {m_dtypes}")
        del ckpt
        pred = run(f"{tag}_entry_predict", predict_diff.main, [
            "data=flowers", "data/dataset=[flowers_anno,flowers_unanno]",
            "data.ratios=[1.0,1.0]", "cfg_scale=1.5", "style_sampling=augmented",
            "style_agg=mean", *where, *overrides, "data.samples=4", "ddim_steps=20",
            f"+predict_name={tag}"])
        check_pairs(Path(pred["predict_dir"]), 8, patch)
        out[tag] = dict(train_loss=ep["loss"], predict=predict_rates(pred),
                        seconds=time.time() - t1)
        log(f"  {tag}: train loss {ep['loss']:.5f}; {time.time() - t1:.1f} s")
    ae = run("opt_entry_ae", train_ae.main, [
        "data=flowers", "style_sampling=augmented", f"location.data_dir={data}",
        f"location.result_dir={entry_root / 'opt_ae'}", "data.samples=4", "num_epochs=1",
        "loss.disc_start=0", "diffusion.first_stage_config.params.ddconfig.dropout=0.1"])
    ep = ae["epochs"][0]
    logs = {**ep["train"], **ep["val"]}.values()
    require(ae["step"] == 2 and all(math.isfinite(v) for v in logs),
            f"train_ae with codec dropout: {ae['step']} steps, {ep}")
    out["ae_steps"] = ae["step"]
    return out, counts


def model_options(torch, entry_root: Path, out_dir: Path, card: str, recs: dict,
                  landscape_ms: float) -> tuple:
    """Phase 12, on phase 6's tree; returns its numbers and each path's
    launches (a path's count of each kernel zeroed just before it and read
    just after)."""
    from stedm_tpu_torch.ops import LAUNCHES

    t0 = time.time()
    log("== phase 12a: the bf16 forward and the fp32 flash kernels at Dh 32 and GroupNorm "
        "with FiLM against their plain versions")
    options_kernels(torch, recs)
    t_a = time.time() - t0
    log(f"  phase 12a took {t_a:.1f} s")
    log("== phase 12b: tiny STEDMs with the new options, card against CPU")
    t1 = time.time()
    options_tiny_parity(torch)
    t_b = time.time() - t1
    log(f"  phase 12b took {t_b:.1f} s")
    log(f"== phase 12c: the flagship with {OPTIONS_12C} (256^2 sampling, batch 8, DDIM-50, "
        "CFG 1.5, phi 0.7; a 512^2 micro-step in bf16 and at fp32)")
    t1 = time.time()
    flagship, counts = options_flagship(torch, out_dir, card, landscape_ms)
    t_c = time.time() - t1
    log(f"  phase 12c took {t_c:.1f} s")
    log("== phase 12d: train_diff / predict_diff with the spatial transformer, dropout 0.1, "
        "crossattn, cosine, +adamw_m_bf16, and train_ae with codec dropout; 12e: the "
        "entry points with 12c's U-Net")
    t1 = time.time()
    entry, entry_counts = options_entry_points(torch, entry_root)
    t_d = time.time() - t1
    counts.update(entry_counts)
    dh32 = {k: sum(c[k] for c in counts.values()) for k in LAUNCHES if k.endswith("_dh32")}
    log(f"  phase 12 launches at Dh 32, each kernel apart: {dh32}; gn_silu_film "
        f"{sum(c['gn_silu_film'] for c in counts.values())}")
    for k, v in dh32.items():
        require(v > 0, f"phase 12 launched no {k}")
    seconds = time.time() - t0
    log(f"  phase 12d/12e took {t_d:.1f} s; phase 12 took {seconds:.1f} s (12a {t_a:.1f}, "
        f"12b {t_b:.1f}, 12c {t_c:.1f})")
    return ({"phase12_flagship": flagship, "phase12_entry": entry,
             "phase12_seconds": seconds}, counts)


# ---- phase 13: every head dimension up to 512 ----

DH16 = dict(num_head_channels=16)
HEAD16 = "+" + UNET_KEY + "num_head_channels=16"
HEADS1 = UNET_KEY + "num_heads=1"       # the landscape U-Net's bottleneck in one head of 1024
# 13a's correctness widths: through every kernel (Dh 20: the bf16 kernels'
# zero-padded copies of width 24), and through the bf16 backward alone (its
# padded instances <256> and <512>); at a ragged T
PAD_WIDTHS = (20, 48, 96, 160)
PAD_BWD_WIDTHS = (192, 320, 384, 448)
PAD_SHAPE = (2, 4, 320)


def _padded_width_check(torch, flush, kernel: str, d: int) -> dict:
    """One 13a correctness case: ``kernel`` ("fwd", "bwd", "f32_fwd",
    "f32_bwd") at [2, 4, 320, d] against its plain version with phase 2b's
    (bf16) or 10a's (fp32, against float64 steps) tolerance, timed once
    beside the plain version and SDPA; its ratio to the tolerance and its
    bound."""
    from stedm_tpu_torch.ops import blocked_attention as a

    shape = PAD_SHAPE + (d,)
    f32 = kernel.startswith("f32")
    dtype = torch.float32 if f32 else torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1300 + d)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    s = d ** -0.5
    bh, t = shape[0] * shape[1], shape[2]
    if kernel.endswith("fwd"):
        got = a.flash_attention_cuda(q, k, v, s)
        ref = a.attention_reference(q, k, v, s)
        pv = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * s, -1) @ v.float().abs()
        tol = (F32_REL if f32 else 2 ** -7) * (pv + ref.float().abs())
        ratio = float(((got.float() - ref.float()).abs() / tol).max())
        fn = lambda: a.flash_attention_cuda(q, k, v, s)
        plain = lambda: a.attention_reference(q, k, v, s)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=s)
        nbytes, ops = 4 * bh * t * d * q.element_size(), 4 * bh * t * t * d
    else:
        o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
        got = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
        if f32:
            ref, bounds = _f64_backward(torch, q, k, v, o, lse, do, s)
            ratio = max(_ratio(torch, g, r, F32_REL * (bd + r.abs()))
                        for g, r, bd in zip(got, ref, bounds))
        else:
            ratio = max(r for _, r in backward_errors(torch, q, k, v, o, lse, do, s, got)[0].values())
        fn = lambda: a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
        plain = lambda: a.attention_backward_reference(q, k, v, o, lse, do, s)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=s)
        library = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
        n = bh * t * d
        nbytes, ops = 8 * n * q.element_size() + bh * t * 4, 10 * bh * t * t * d
    peak = TF32_FLOPS / 3 if f32 else BF16_FLOPS      # 3xTF32: three products a product
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    plan = a.head_dim_plan(d, dtype, kernel.endswith("bwd"))
    row = dict(kernel=kernel, shape=list(shape), instance=plan.instance, width=plan.width,
               ratio=ratio, ms=time_ms(fn, 1, flush), plain_ms=time_ms(plain, 1, flush),
               library_ms=time_ms(library, 1, flush), bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    where = "the band route" if plan.band else f"the Dh-{plan.instance} instance"
    log(f"  {kernel} Dh {d} {list(shape)} on {where}"
        + (f" (copies of width {plan.width})" if plan.width != d else "")
        + f": {ratio:.3f} of its tolerance {'ok' if ratio <= 1 else 'OUT OF TOLERANCE'}; "
        f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
        f"library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
    require(ratio <= 1, f"{kernel} at Dh {d} disagrees with its plain version")
    return row


def head_dim_kernels(torch, recs) -> list:
    """13a: the bf16 backward's Dh-32 instance at the micro-step shapes, the
    four kernels at Dh 16, timed; then the padded widths, each timed once."""
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # the L2 flush
    flush = scratch.zero_
    log("  -- bf16 backward at Dh 32 (flash_bwd_small<32>, and the forward with its LSE): "
        "12c's 512^2 micro-step (batch 8) and train_diff's (batch 2)")
    check_attention_backward(torch, recs["flash_attention_bwd_dh32"], flush,
                             ((8, 32, 1024, 32), (2, 32, 1024, 32)), 31)
    log("  -- Dh 16 (num_head_channels 16): the sampling bottleneck (CFG batch 16), a 512^2 "
        "micro-step (batch 8); bf16, then fp32")
    check_attention(torch, recs["flash_attention_dh16"], flush,
                    shapes=((16, 64, 256, 16), (8, 64, 1024, 16)), strided=False)
    check_attention_backward(torch, recs["flash_attention_bwd_dh16"], flush,
                             ((8, 64, 1024, 16),), 41)
    f32_forward_checks(torch, recs["flash_attention_f32_dh16"], flush,
                       shapes=((16, 64, 256, 16), (8, 64, 1024, 16)), strided=False)
    f32_backward_checks(torch, recs["flash_attention_bwd_f32_dh16"], flush,
                        shapes=((8, 64, 1024, 16),))
    log(f"  -- the padded widths at {list(PAD_SHAPE)} + [Dh], correctness, each timed once")
    rows = [_padded_width_check(torch, flush, kernel, d) for d in PAD_WIDTHS
            for kernel in ("fwd", "bwd", "f32_fwd", "f32_bwd")]
    rows += [_padded_width_check(torch, flush, "bwd", d) for d in PAD_BWD_WIDTHS]
    del scratch, flush
    torch.cuda.empty_cache()
    return rows


def head_dim_tiny_parity(torch) -> dict:
    """13b: the tiny STEDM at num_head_channels 16 (Dh 16 at every attention
    block) card against CPU: a bf16 sample, then fp32 sampling and three
    micro-steps; returns the fp32 runs' launches."""
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn

    cfg = SamplerConfig(ddim_steps=4, eta=0.0, cfg_scale=1.5, rescale_phi=0.7,
                        batched_cfg=True, downsample=4)
    cpu, gpu, batch, x_T, sched = _tiny_sampling_models(torch, torch.bfloat16, DH16)
    ref = make_sample_fn(cpu, sched, cfg, device="cpu")(cpu, batch, x_T=x_T)
    reset_launch_counts()
    got = make_sample_fn(gpu, sched, cfg, device="cuda")(gpu, batch, x_T=x_T)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    _tiny_close(torch, got, ref, f"tiny STEDM {DH16} card vs CPU")
    log(f"    launches {counts}")
    require(counts["flash_attention_dh16"] > 0,
            f"the tiny sampler at Dh 16 did not run the Dh-16 forward: {counts}")
    del cpu, gpu
    return f32_tiny_parity(torch, DH16, "_dh16")


def head_dim_entry_points(torch, entry_root: Path) -> tuple:
    """13c: train_diff (2 micro-steps) and predict_diff (8 pairs, DDIM-20)
    with phase 6's config at num_head_channels 16; 13d: predict_diff at
    num_heads 1 (Dh 1024: the forward's cluster instance) on 13c's
    checkpoint, and the flash override reaching the model."""
    from stedm_tpu_torch import predict_diff, train_diff
    from stedm_tpu_torch.config import compose
    from stedm_tpu_torch.models.attention import AttentionBlock
    from stedm_tpu_torch.models.stedm import build_stedm
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts

    data, patch = entry_root / "data", 512
    prune_results(entry_root)
    where = [f"location.data_dir={data}", f"location.result_dir={entry_root / 'dh16'}"]
    style = ["data=flowers", "style_sampling=augmented", "style_agg=mean", *where]
    counts, out = {}, {}

    def run(name: str, main, args: list):
        log(f"  {main.__module__}.main({args})")
        reset_launch_counts()
        torch.cuda.synchronize()
        res = main(args)
        torch.cuda.synchronize()
        counts[name] = dict(LAUNCHES)
        log(f"    launches {counts[name]}")
        torch.cuda.empty_cache()
        return res

    tr = run("dh16_entry_train", train_diff.main, style + [
        HEAD16, "+diffusion.scale_by_std=true", "data.samples=4", "num_epochs=1",
        "+preview_ddim_steps=4", "accumulate_grad_batches=1"])
    ep = tr["epochs"][0]
    c = counts["dh16_entry_train"]
    out["train_samples_per_s"] = ep["samples"] / ep["seconds"]
    log(f"  13c train_diff: {ep['micro_steps']} micro-steps, loss {ep['loss']:.5f}, "
        f"{out['train_samples_per_s']:.4f} samples/s over the epoch ({ep['seconds']:.2f} s, "
        "the first micro-step included)")
    require(tr["step"] == 2 and math.isfinite(ep["loss"]),
            f"train_diff at Dh 16: {tr['step']} steps, loss {ep['loss']}")
    require(c["flash_attention_dh16"] > 0 and c["flash_attention_bwd_dh16"] > 0,
            f"train_diff at Dh 16 did not run the Dh-16 kernels: {c}")
    readme = ["data=flowers", "data/dataset=[flowers_anno,flowers_unanno]",
              "data.ratios=[1.0,1.0]", "cfg_scale=1.5", "style_sampling=augmented",
              "style_agg=mean", *where]
    pred = run("dh16_entry_predict", predict_diff.main, readme + [
        HEAD16, "data.samples=4", "ddim_steps=20", "+predict_name=dh16"])
    check_pairs(Path(pred["predict_dir"]), 8, patch)
    out["predict"] = {k: v for k, v in predict_rates(pred).items() if k != "predict_dir"}
    require(counts["dh16_entry_predict"]["flash_attention_dh16"] > 0,
            f"predict at Dh 16 did not run the Dh-16 forward: {counts['dh16_entry_predict']}")

    pred = run(PATH_13D, predict_diff.main, readme + [
        HEADS1, "data.samples=2", "ddim_steps=4", "+predict_name=dh1024"])
    check_pairs(Path(pred["predict_dir"]), 4, patch)
    out["predict_dh1024"] = {k: v for k, v in predict_rates(pred).items() if k != "predict_dir"}
    c = counts[PATH_13D]
    require(c.get("flash_attention_dh1024", 0) > 0,
            f"predict at Dh 1024 did not run the Dh-1024 forward: {c}")
    cfg = compose("config_predict", readme + [HEADS1, UNET_KEY + "attn_impl=flash"])
    blocks = [m for m in build_stedm(cfg, "meta").unet.modules() if isinstance(m, AttentionBlock)]
    require(blocks and all(b.attn_impl == "flash" and b.num_heads == 1 for b in blocks),
            "the flash override did not reach the AttentionBlocks")
    return out, counts


def above_the_kernels(torch) -> dict:
    """13d: above Dh 1024, on tiny tensors: the codec's AttnBlockVQ at 1152
    channels launches the band kernel on the card and matches its CPU copy
    (the band route's plain versions); at Dh 1152, 2048 and 4096 sdpa under
    each of its four impls, flash_attention with a gradient and AttnBlockVQ
    launch the band kernels (``flash_band``, ``flash_band_bwd``), and the
    plain attention runs on no CUDA tensor."""
    from stedm_tpu_torch.models.vq import AttnBlockVQ
    from stedm_tpu_torch.ops import LAUNCHES
    from stedm_tpu_torch.ops import blocked_attention as a

    torch.manual_seed(14)
    block = AttnBlockVQ(1152).eval()
    x = torch.randn(1, 1152, 8, 8)
    with torch.no_grad():
        ref = block(x)
        before = LAUNCHES["flash_band_f32"]
        got = block.cuda()(x.cuda())
        torch.cuda.synchronize()
    err = _tiny_rel(torch, got, ref)
    require(LAUNCHES["flash_band_f32"] == before + 1, "AttnBlockVQ at 1152 channels did not "
            "launch the band forward")
    require(err <= 1e-4, f"AttnBlockVQ at 1152 channels, card against CPU: {err}")
    del block
    launched = {}
    with PlainOnCard() as guard:
        for d in (1152, 2048, 4096):
            q = torch.randn((1, 1, 64, d), device="cuda", dtype=torch.bfloat16)
            before = dict(LAUNCHES)
            for impl in ("exact", "chunked", "flash", "auto"):
                a.sdpa(q, q, q, d ** -0.25, impl=impl)
            leaf = q.clone().requires_grad_()
            a.flash_attention(leaf, leaf, leaf, d ** -0.5).sum().backward()
            with torch.no_grad():
                AttnBlockVQ(d).cuda()(torch.randn(1, d, 8, 8, device="cuda"))
            torch.cuda.synchronize()
            launched[d] = {k: LAUNCHES[k] - before[k] for k in ("flash_band", "flash_band_bwd",
                                                              "flash_band_f32")}
    log(f"  13d: AttnBlockVQ at 1152 channels on the card: relative L2 {err:.3e} against the "
        f"CPU (fp32); band launches at Dh 1152 / 2048 / 4096 of sdpa's four impls, "
        f"flash_attention with its gradient and AttnBlockVQ: {launched}")
    require(guard.calls == 0, "a plain version ran on a CUDA tensor above Dh 1024")
    require(all(n == {"flash_band": 5, "flash_band_bwd": 1, "flash_band_f32": 1}
                for n in launched.values()), f"above Dh 1024 a route missed the band kernels: "
            f"{launched}")
    return {"above_1024_rel_err": err, "above_1024_launches": launched}


def head_dims(torch, entry_root: Path, recs: dict) -> tuple:
    """Phase 13, on phase 6's tree; returns its numbers and each path's
    launches (zeroed just before each path and read just after)."""
    t0 = time.time()
    log("== phase 13a: the bf16 backward's Dh-32 instance, the flash kernels at Dh 16, and "
        "the padded head dimensions against their plain versions")
    padded = head_dim_kernels(torch, recs)
    t_a = time.time() - t0
    log(f"  phase 13a took {t_a:.1f} s")
    log(f"== phase 13b: the tiny STEDM at {DH16}, card against CPU (bf16 sample; fp32 "
        "sample and micro-steps)")
    t1 = time.time()
    f32_counts = head_dim_tiny_parity(torch)
    t_b = time.time() - t1
    log(f"  phase 13b took {t_b:.1f} s")
    log("== phase 13c: train_diff / predict_diff at num_head_channels 16; 13d: predict_diff "
        "at num_heads 1 (Dh 1024: the cluster kernels), and above 1024 the plain attention "
        "and the flash refusal on tiny tensors")
    t1 = time.time()
    entry, counts = head_dim_entry_points(torch, entry_root)
    entry.update(above_the_kernels(torch))
    counts[PATH_13_F32] = f32_counts
    seconds = time.time() - t0
    log(f"  phase 13c/13d took {time.time() - t1:.1f} s; phase 13 took {seconds:.1f} s (13a "
        f"{t_a:.1f}, 13b {t_b:.1f})")
    return {"phase13_padded_widths": padded, "phase13_entry": entry,
            "phase13_seconds": seconds}, counts


# ---- phase 14: the flash kernels above Dh 512, up to 1024 ----

# 14a's shapes: the bf16 forward at the one-head U-Net's sampling (256^2,
# CFG batch 16) and 512^2 training shapes and at the 1024-wide codec's
# 512^2 mid-block (batch 2); the backwards at the training and codec
# shapes; fp32 at the training shape and the codec's at 256^2; then every
# other cluster instance and partial slices, each timed once
WIDE_FWD_SHAPES = ((16, 1, 256, 1024), (8, 1, 1024, 1024), (2, 1, 16384, 1024))
WIDE_BWD_SHAPES = ((8, 1, 1024, 1024), (2, 1, 16384, 1024))
WIDE_F32_SHAPES = ((8, 1, 1024, 1024), (2, 1, 4096, 1024))
WIDE_WIDTHS = (520, 576, 640, 768, 896)
# 14d: the codec with a 1024-wide last level and mid-block
WIDE_CODEC = "diffusion.first_stage_config.params.ddconfig.ch_mult=[1,2,8]"


def wide_head_kernels(torch, recs) -> list:
    """14a: the Dh-1024 instances of the four kernels against their plain
    versions at the main paths' shapes (phase 2's, 2b's and 10a's checks
    and tolerances), timed beside them, SDPA (its backend named) and the
    bound; the clusters each instance holds at once; then Dh 520 to 896 at
    [2, 4, 320, Dh], each timed once."""
    import ctypes

    from stedm_tpu_torch._device import load_library
    from stedm_tpu_torch.ops import blocked_attention as a

    for stem, name in (("flash_attention", "flash_attention_fwd"),
                       ("flash_attention_bwd", "flash_attention_bwd"),
                       ("flash_attention_f32", "flash_attention_f32"),
                       ("flash_attention_bwd_f32", "flash_attention_bwd_f32")):
        fn = getattr(load_library(stem), f"{name}_max_active_clusters")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        held = {d: fn(d) for d in a.CLUSTER_HEAD_DIMS}
        log(f"  {stem}: clusters held at once (cudaOccupancyMaxActiveClusters, one block an SM), "
            f"by instance: {held}")
        require(min(held.values()) >= 1, f"{stem}: a cluster instance fits nowhere: {held}")
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # the L2 flush
    flush = scratch.zero_
    log("  -- bf16 forward at Dh 1024 (flash_fwd_cluster<1024>, a cluster of 8): the one-head "
        "U-Net sampling at 256^2 and training at 512^2, the 1024-wide codec mid-block at 512^2")
    gen = torch.Generator(device="cuda").manual_seed(14)
    for shape in WIDE_FWD_SHAPES:
        q = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        log(f"  SDPA at {list(shape)} runs {sdpa_backend(torch, q, q, q, shape[-1] ** -0.5)}")
    check_attention(torch, recs["flash_attention_dh1024"], flush, shapes=WIDE_FWD_SHAPES,
                    strided=False)
    log("  -- bf16 backward at Dh 1024 (flash_bwd<1024>, a cluster of 8)")
    check_attention_backward(torch, recs["flash_attention_bwd_dh1024"], flush, WIDE_BWD_SHAPES,
                             140)
    log("  -- fp32 forward and backward at Dh 1024 (clusters of 8 blocks of 128 columns)")
    f32_forward_checks(torch, recs["flash_attention_f32_dh1024"], flush, shapes=WIDE_F32_SHAPES,
                       strided=False)
    f32_backward_checks(torch, recs["flash_attention_bwd_f32_dh1024"], flush,
                        shapes=WIDE_F32_SHAPES)
    log(f"  -- Dh {', '.join(map(str, WIDE_WIDTHS))} at {list(PAD_SHAPE)} + [Dh] (the cluster "
        "instances 640, 768 and 896; 520 and 576 on 640, rank 4 of 5 holding 8 or 64 real "
        "columns), correctness, each timed once")
    rows = [_padded_width_check(torch, flush, kernel, d) for d in WIDE_WIDTHS
            for kernel in ("fwd", "bwd", "f32_fwd", "f32_bwd")]
    del scratch, flush
    torch.cuda.empty_cache()
    return rows


def wide_head_entry_points(torch, entry_root: Path) -> tuple:
    """14b: train_diff (2 micro-steps at 512^2) and predict_diff (4 pairs,
    DDIM-4) with phase 6's config at num_heads 1 (the bottleneck in one
    head of 1024), bf16; 14c: the same at fp32, one micro-step; 14d:
    train_ae (2 steps and the val decode) with the codec at ch_mult [1, 2,
    8] (mid-block 1024 wide, T 16384 at 512^2). Each path must launch a
    Dh-1024 kernel and no plain attention."""
    from stedm_tpu_torch import predict_diff, train_ae, train_diff
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts

    data = entry_root / "data"
    counts, out = {}, {}
    prune_results(entry_root)

    def run(name: str, main, args: list):
        log(f"  {main.__module__}.main({args})")
        reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        with PlainOnCard() as guard:
            res = main(args)
            torch.cuda.synchronize()
        counts[name] = dict(LAUNCHES)
        log(f"    {time.time() - t1:.1f} s; launches {counts[name]}")
        require(guard.calls == 0,
                f"{name}: the plain attention ran on the card")
        torch.cuda.empty_cache()
        return res

    for dtype, (tr_path, pr_path) in (("bfloat16", PATHS_14), ("float32", PATHS_14_F32)):
        f32 = dtype == "float32"
        where = [f"location.data_dir={data}", f"location.result_dir={entry_root / tr_path}"]
        extra = ["diffusion.compute_dtype=float32"] if f32 else []
        tr = run(tr_path, train_diff.main, [
            "data=flowers", "style_sampling=augmented", "style_agg=mean", *where, HEADS1, *extra,
            "+diffusion.scale_by_std=true", "data.samples=2" if f32 else "data.samples=4",
            "num_epochs=1", "+preview_ddim_steps=4", "accumulate_grad_batches=1"])
        ep = tr["epochs"][0]
        out[tr_path] = ep["samples"] / ep["seconds"]
        log(f"  {tr_path}: {ep['micro_steps']} micro-step(s) at num_heads 1 ({dtype}), loss "
            f"{ep['loss']:.5f}, {out[tr_path]:.4f} samples/s over the epoch")
        require(tr["step"] == (1 if f32 else 2) and math.isfinite(ep["loss"]),
                f"{tr_path}: {tr['step']} steps, loss {ep['loss']}")
        pred = run(pr_path, predict_diff.main, [
            "data=flowers", "data/dataset=[flowers_anno,flowers_unanno]", "data.ratios=[1.0,1.0]",
            "cfg_scale=1.5", "style_sampling=augmented", "style_agg=mean", *where, HEADS1, *extra,
            "data.samples=2", "ddim_steps=4", "+host_loop=false", f"+predict_name={pr_path}"])
        check_pairs(Path(pred["predict_dir"]), 4, ENTRY_PATCH)
        out[pr_path] = {k: v for k, v in predict_rates(pred).items() if k != "predict_dir"}
        fwd, bwd = (("flash_attention_f32_dh1024", "flash_attention_bwd_f32_dh1024") if f32 else
                    ("flash_attention_dh1024", "flash_attention_bwd_dh1024"))
        _launch_check(counts[tr_path], (fwd, bwd), tr_path)
        _launch_check(counts[pr_path], (fwd,), pr_path)
        prune_results(entry_root)
    ae = run(PATH_14_AE, train_ae.main, [
        "data=flowers", "style_sampling=augmented", f"location.data_dir={data}",
        f"location.result_dir={entry_root / PATH_14_AE}", "data.samples=4", "num_epochs=1",
        "loss.disc_start=0", f"run_name={PATH_14_AE}", WIDE_CODEC])
    ep = ae["epochs"][0]
    require(ae["step"] == 2 and all(math.isfinite(v) for v in {**ep["train"], **ep["val"]}.values()),
            f"train_ae with a 1024-wide mid-block: {ae['step']} steps, {ep}")
    _launch_check(counts[PATH_14_AE], ("flash_attention_dh1024", "flash_attention_bwd_dh1024"),
                  PATH_14_AE)
    out[PATH_14_AE] = dict(samples_per_s=ep["steps"] * 2 / ep["seconds"], seconds=ep["seconds"],
                           val_rec_loss=ep["val"]["val/rec_loss"])
    log(f"  {PATH_14_AE}: 2 steps and the val decode at ch_mult [1, 2, 8] (mid-block 1024 wide, "
        f"T 16384), {out[PATH_14_AE]['samples_per_s']:.4f} samples/s over the epoch, val rec_loss "
        f"{ep['val']['val/rec_loss']:.5f}")
    return out, counts


def wide_heads(torch, entry_root: Path, recs: dict) -> tuple:
    """Phase 14, on phase 6's tree; returns its numbers and each path's
    launches (zeroed just before each path and read just after)."""
    t0 = time.time()
    log("== phase 14a: the flash kernels at Dh 1024 (clusters of 8) and the other cluster "
        "instances against their plain versions")
    log(f"  card: {card_line()}")
    rows = wide_head_kernels(torch, recs)
    t_a = time.time() - t0
    log(f"  phase 14a took {t_a:.1f} s")
    log("== phase 14b/14c: train_diff / predict_diff at num_heads 1 (Dh 1024), bf16 and fp32; "
        "14d: train_ae with a 1024-wide codec mid-block")
    entry, counts = wide_head_entry_points(torch, entry_root)
    seconds = time.time() - t0
    log(f"  phase 14 took {seconds:.1f} s (14a {t_a:.1f})")
    return {"phase14_widths": rows, "phase14_entry": entry, "phase14_seconds": seconds}, counts



# ---- phase 15: the band route above Dh 1024 (ops/flash_band.py) ----

# 15a's shapes: the four kernels at widths through the route's copies and
# TMA fill ([2, 4, 320, Dh], each timed once), then at the main paths' shapes:
# the one-head U-Net's bottleneck at Dh 2048 sampling at 256^2 (CFG batch
# 16), the 2048-wide codec mid-block at 256^2 and 512^2 (batch 2), Dh 4096
BAND_PAD_WIDTHS = (1100, 1152, 1536, 2048)
BAND_SHAPES = ((16, 1, 256, 2048), (2, 1, 4096, 2048), (2, 1, 16384, 2048), (2, 1, 1024, 4096))
# 15b: the landscape U-Net with a 2048-wide bottleneck in one head; 15c: the
# codec with a 2048-wide last level and mid-block
BAND_UNET = [HEADS1, UNET_KEY + "channel_mult=[1,4,16]"]
BAND_CODEC = "diffusion.first_stage_config.params.ddconfig.ch_mult=[1,2,16]"


def _band_fwd_check(torch, q, k, v, s, f32: bool):
    """The forward's O and LSE against the band route's plain version (bf16:
    2^-7 (P|V| + |ref|), phase 2's form) or the float64 steps (fp32: 2^-16
    (P|V| + |ref|), 10a's), a sample at a time; (max |err|, max ratio)."""
    from stedm_tpu_torch.ops import blocked_attention as a
    from stedm_tpu_torch.ops import flash_band

    got, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
    err, ratio, lse_ok = 0.0, 0.0, True
    for i in range(q.shape[0]):
        sl = slice(i, i + 1)
        if f32:
            qd, kd, vd = (x[sl].double() for x in (q, k, v))
            logits = (qd @ kd.transpose(-1, -2)) * s
            p = torch.softmax(logits, -1)
            ref, lref = p @ vd, torch.logsumexp(logits, -1)
        else:
            ref, lref = flash_band.forward_plain(q[sl], k[sl], v[sl], s, return_lse=True)
            p = torch.softmax((q[sl].float() @ k[sl].float().transpose(-1, -2)) * s, -1)
        tol = (F32_REL if f32 else 2 ** -7) * (p @ v[sl].to(p.dtype).abs() + ref.abs().to(p.dtype))
        d = (got[sl].to(p.dtype) - ref.to(p.dtype)).abs()
        err, ratio = max(err, float(d.max())), max(ratio, float((d / tol).max()))
        lse_ok &= bool(((lse[sl].double() - lref.double()).abs()
                        <= 1e-5 * lref.double().abs() + 1e-4).all())
        del p, ref, tol, d
    require(lse_ok, f"the band forward's LSE at {list(q.shape)}")
    return err, ratio


def _band_bwd_check(torch, q, k, v, o, lse, do, s, got, f32: bool):
    """The backward's dq, dk, dv against the band route's plain version
    (bf16: 2^-7 (sqrt(sum terms^2) + |ref|), phase 2b's form) or the float64
    steps (fp32: 2^-16, 10a's), a sample at a time; (max |err|, max ratio)."""
    from stedm_tpu_torch.ops import flash_band

    err, ratio = 0.0, 0.0
    for i in range(q.shape[0]):
        sl = slice(i, i + 1)
        args = tuple(x[sl] for x in (q, k, v, o, lse, do)) + (s,)
        if f32:
            ref, bounds = _f64_backward(torch, *args)
        else:
            ref = flash_band.backward_plain(*args)
            p = torch.softmax((q[sl].float() @ k[sl].float().transpose(-1, -2)) * s, -1)
            ds = p * (do[sl].float() @ v[sl].float().transpose(-1, -2)
                      - (do[sl].float() * o[sl].float()).sum(-1, keepdim=True)) * s
            bounds = (_rms_bound((ds, k[sl])), _rms_bound((ds.transpose(-1, -2), q[sl])),
                      _rms_bound((p.transpose(-1, -2), do[sl])))
            del p, ds
        for g, r, bd in zip(got, ref, bounds):
            r = r.to(bd.dtype)
            d = (g[sl].to(bd.dtype) - r).abs()
            tol = (F32_REL if f32 else 2 ** -7) * (bd + r.abs())
            err, ratio = max(err, float(d.max())), max(ratio, float((d / tol).max()))
            del d, tol
        del ref, bounds
        torch.cuda.empty_cache()
    return err, ratio


def band_kernel_checks(torch, recs, flush, shapes, time_it: bool = True) -> list:
    """15a: at each shape the four band kernels (bf16 and fp32, forward and
    backward, through the flash wrappers) against their plain versions,
    two backward launches bit for bit, each timed beside its plain version
    (the band route's, on the card) and SDPA (its backend named), and added
    to its record with the bound."""
    from stedm_tpu_torch.ops import blocked_attention as a
    from stedm_tpu_torch.ops import flash_band

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(15)
    for shape in shapes:
        b, h, t, d = shape
        bh, s = b * h, d ** -0.5
        iters = 3 if t <= 4096 else 1
        for dtype in (torch.bfloat16, torch.float32):
            f32 = dtype == torch.float32
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for _ in range(4))
            fname, bname = flash_band.COUNTERS[dtype]
            err, ratio = _band_fwd_check(torch, q, k, v, s, f32)
            o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
            got = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
            again = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            del again
            berr, bratio = _band_bwd_check(torch, q, k, v, o, lse, do, s, got, f32)
            backend = sdpa_backend(torch, q, k, v, s)
            row = dict(shape=list(shape), dtype=str(dtype), fwd_ratio=ratio, bwd_ratio=bratio,
                       sdpa=backend, two_launches_equal=same)
            log(f"  band {dtype} {list(shape)}: forward {ratio:.3f} of its tolerance, backward "
                f"{bratio:.3f} ({'2^-16 against float64' if f32 else '2^-7 against the plain version'}"
                f"); two backward launches equal: {same}; SDPA runs {backend}")
            require(ratio <= 1 and bratio <= 1 and same,
                    f"the band kernels at {dtype} {list(shape)} disagree with their plain versions")
            if time_it:
                fwd = lambda: a.flash_attention_cuda(q, k, v, s)
                bwd = lambda: a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=s)
                lib_b = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
                lib_f = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=s)
                t_ = {n: time_ms(f, iters, flush) for n, f in (
                    ("fwd", fwd), ("bwd", bwd), ("lib_f", lib_f), ("lib_b", lib_b),
                    ("plain_f", lambda: flash_band.forward_plain(q, k, v, s)),
                    ("plain_b", lambda: flash_band.backward_plain(q, k, v, o, lse, do, s)))}
                del out, leaves
                # fp32: three TF32 products a product (3xTF32)
                es, peak, mul = (4, TF32_FLOPS, 3) if f32 else (2, BF16_FLOPS, 1)
                recs[fname].add(shape, err, True, t_["fwd"], t_["plain_f"], t_["lib_f"],
                                4 * bh * t * d * es, mul * 4 * bh * t * t * d, peak)
                recs[bname].add(shape, berr, True, t_["bwd"], t_["plain_b"], t_["lib_b"],
                                8 * bh * t * d * es + bh * t * 4, mul * 10 * bh * t * t * d, peak)
                row.update({f"{n}_ms": x for n, x in t_.items()})
            rows.append(row)
            del q, k, v, do, o, lse, got
            torch.cuda.empty_cache()
    return rows


def band_at_1024(torch) -> dict:
    """15a's record for later work: the band route against the Dh-1024
    cluster instances at the 1024-wide codec's 512^2 shape, bf16, forward
    and backward, in turns (cluster, band, band, cluster), each the faster
    of its two turns. The wrappers keep the cluster instances at 1024."""
    from stedm_tpu_torch.ops import blocked_attention as a
    from stedm_tpu_torch.ops import flash_band

    shape = (2, 1, 16384, 1024)
    gen = torch.Generator(device="cuda").manual_seed(1024)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    s = 1024 ** -0.5
    o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
    st = {n: a.check_strided(x, n) for n, x in (("q", q), ("k", k), ("v", v), ("o", o),
                                                   ("do", do))}
    band_o = torch.empty_like(q)

    def band_fwd():
        flash_band.forward_cuda(q, k, v, s, band_o, None, {**st, "out": st["q"]})

    fns = {"cluster_fwd": lambda: a.flash_attention_cuda(q, k, v, s), "band_fwd": band_fwd,
           "cluster_bwd": lambda: a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s),
           "band_bwd": lambda: flash_band.backward_cuda(q, k, v, o, lse, do, s, st)}
    band_fwd()
    o_err = float((band_o.float() - o.float()).abs().max())
    out = {}
    for kind in ("fwd", "bwd"):
        order = (f"cluster_{kind}", f"band_{kind}", f"band_{kind}", f"cluster_{kind}")
        turns = [(n, time_ms(fns[n], 2)) for n in order]
        for n in (f"cluster_{kind}", f"band_{kind}"):
            out[f"{n}_ms"] = min(x for m, x in turns if m == n)
    log(f"  the band route at Dh 1024 [2, 1, 16384, 1024] bf16 against the cluster instances "
        f"(in turns): forward {out['band_fwd_ms']:.4f} ms vs {out['cluster_fwd_ms']:.4f}, "
        f"backward {out['band_bwd_ms']:.4f} vs {out['cluster_bwd_ms']:.4f}; O max |diff| "
        f"{o_err:.3e}")
    return out


def band_entry_points(torch, entry_root: Path) -> tuple:
    """15b: train_diff (2 micro-steps at 512^2; fp32 one) and predict_diff
    (4 pairs, DDIM-4) with phase 6's config at num_heads 1 and channel_mult
    [1, 4, 16] (the bottleneck in one head of 2048), bf16 and fp32; 15c:
    train_ae (2 steps and the val decode) with the codec at ch_mult [1, 2,
    16] at 256^2 (mid-block 2048 wide, T 4096). Each path must launch the
    band kernels and no plain version on a CUDA tensor."""
    from stedm_tpu_torch import predict_diff, train_ae, train_diff
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts

    data = entry_root / "data"
    counts, out = {}, {}
    prune_results(entry_root)

    def run(name: str, main, args: list):
        log(f"  {main.__module__}.main({args})")
        reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        with PlainOnCard() as guard:
            res = main(args)
            torch.cuda.synchronize()
        counts[name] = dict(LAUNCHES)
        log(f"    {time.time() - t1:.1f} s; launches {counts[name]}")
        require(guard.calls == 0, f"{name}: a plain version ran on the card")
        torch.cuda.empty_cache()
        return res

    for dtype, (tr_path, pr_path) in (("bfloat16", PATHS_15), ("float32", PATHS_15_F32)):
        f32 = dtype == "float32"
        where = [f"location.data_dir={data}", f"location.result_dir={entry_root / tr_path}"]
        extra = ["diffusion.compute_dtype=float32"] if f32 else []
        tr = run(tr_path, train_diff.main, [
            "data=flowers", "style_sampling=augmented", "style_agg=mean", *where, *BAND_UNET,
            *extra, "+diffusion.scale_by_std=true", "data.samples=2" if f32 else "data.samples=4",
            "num_epochs=1", "+preview_ddim_steps=4", "accumulate_grad_batches=1"])
        ep = tr["epochs"][0]
        out[tr_path] = ep["samples"] / ep["seconds"]
        log(f"  {tr_path}: {ep['micro_steps']} micro-step(s) at num_heads 1, channel_mult [1, 4, "
            f"16] ({dtype}), loss {ep['loss']:.5f}, {out[tr_path]:.4f} samples/s over the epoch")
        require(tr["step"] == (1 if f32 else 2) and math.isfinite(ep["loss"]),
                f"{tr_path}: {tr['step']} steps, loss {ep['loss']}")
        pred = run(pr_path, predict_diff.main, [
            "data=flowers", "data/dataset=[flowers_anno,flowers_unanno]", "data.ratios=[1.0,1.0]",
            "cfg_scale=1.5", "style_sampling=augmented", "style_agg=mean", *where, *BAND_UNET,
            *extra, "data.samples=2", "ddim_steps=4", "+host_loop=false",
            f"+predict_name={pr_path}"])
        check_pairs(Path(pred["predict_dir"]), 4, ENTRY_PATCH)
        out[pr_path] = {k: v for k, v in predict_rates(pred).items() if k != "predict_dir"}
        fwd, bwd = ("flash_band_f32", "flash_band_bwd_f32") if f32 else ("flash_band",
                                                                         "flash_band_bwd")
        _launch_check(counts[tr_path], (fwd, bwd), tr_path)
        _launch_check(counts[pr_path], (fwd,), pr_path)
        prune_results(entry_root)
    ae = run(PATH_15_AE, train_ae.main, [
        "data=flowers", "style_sampling=augmented", f"location.data_dir={data}",
        f"location.result_dir={entry_root / PATH_15_AE}", "data.samples=4", "num_epochs=1",
        "data.patch_size=256", "loss.disc_start=0", f"run_name={PATH_15_AE}", BAND_CODEC])
    ep = ae["epochs"][0]
    require(ae["step"] == 2 and all(math.isfinite(v) for v in {**ep["train"], **ep["val"]}.values()),
            f"train_ae with a 2048-wide mid-block: {ae['step']} steps, {ep}")
    _launch_check(counts[PATH_15_AE], ("flash_band", "flash_band_bwd"), PATH_15_AE)
    out[PATH_15_AE] = dict(samples_per_s=ep["steps"] * 2 / ep["seconds"], seconds=ep["seconds"],
                           val_rec_loss=ep["val"]["val/rec_loss"])
    log(f"  {PATH_15_AE}: 2 steps and the val decode at ch_mult [1, 2, 16], 256^2 (mid-block 2048 "
        f"wide, T 4096), {out[PATH_15_AE]['samples_per_s']:.4f} samples/s over the epoch, val "
        f"rec_loss {ep['val']['val/rec_loss']:.5f}")
    prune_results(entry_root)
    return out, counts


def band_route(torch, entry_root: Path, recs: dict) -> tuple:
    """Phase 15, on phase 6's tree; returns its numbers and each path's
    launches (zeroed just before each path and read just after)."""
    from stedm_tpu_torch.ops import flash_band

    t0 = time.time()
    log("== phase 15a: the band route (csrc/flash_band.cu) above Dh 1024 against its plain "
        "versions")
    log(f"  card: {card_line()}")
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # the L2 flush
    flush = scratch.zero_
    log(f"  -- Dh {', '.join(map(str, BAND_PAD_WIDTHS))} at {list(PAD_SHAPE)} + [Dh] (1100: "
        "bf16 copies of width 1104), correctness, each timed once")
    widths = [_padded_width_check(torch, flush, kernel, d) for d in BAND_PAD_WIDTHS
              for kernel in ("fwd", "bwd", "f32_fwd", "f32_bwd")]
    for shape in BAND_SHAPES:
        b, h, t, d = shape
        plans = {f"{dt}_{'bwd' if bw else 'fwd'}": flash_band.band_plan(b * h, t, d, dt, bw)
                 for dt in (torch.bfloat16, torch.float32) for bw in (False, True)}
        log(f"  {list(shape)}: bands (heads x rows, bands, workspace MiB) " + ", ".join(
            f"{n} {p.heads} x {p.rows}, {len(p.chunks)}, {p.workspace / 2 ** 20:.1f}"
            for n, p in plans.items()))
    rows = band_kernel_checks(torch, recs, flush, BAND_SHAPES)
    del scratch, flush
    at_1024 = band_at_1024(torch)
    torch.cuda.empty_cache()
    t_a = time.time() - t0
    log(f"  phase 15a took {t_a:.1f} s")
    log("== phase 15b/15c: train_diff / predict_diff at num_heads 1, channel_mult [1, 4, 16] "
        "(Dh 2048), bf16 and fp32; train_ae with a 2048-wide codec mid-block at 256^2")
    entry, counts = band_entry_points(torch, entry_root)
    seconds = time.time() - t0
    log(f"  phase 15 took {seconds:.1f} s (15a {t_a:.1f})")
    return {"phase15_widths": widths, "phase15_kernels": rows, "phase15_at_1024": at_1024,
            "phase15_entry": entry, "phase15_seconds": seconds}, counts


def main() -> int:
    global LOG_FILE
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=REPO / "build" / "chip_smoke",
                    help="directory for the nvcc log and the profile table")
    ap.add_argument("--dist-worker", nargs=4, metavar=("MODE", "DATA", "RESULTS", "OUT"),
                    help="(phase 11b runs itself so) one process of the two-rank check")
    args = ap.parse_args()
    if args.dist_worker:
        return dist_worker(*args.dist_worker)
    out_dir = args.out
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a card", file=sys.stderr)
        return 2
    if not (REPO / "stedm_tpu_torch" / "__init__.py").exists():
        print("stedm_tpu_torch/ is not beside chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from stedm_tpu_torch._device import build_all
    from stedm_tpu_torch.models.layers import GNSiLU
    from stedm_tpu_torch.models.stedm import build_flagship
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn

    t0 = time.time()
    out_dir.mkdir(parents=True, exist_ok=True)
    LOG_FILE = out_dir / "chip_smoke.log"
    LOG_FILE.write_text("")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"== phase 1: header\n  card: {card}\n  torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for fp32 matmul and cuDNN")
    builds = build_all(["gn_silu", "flash_attention", "flash_attention_bwd", "nearest_code",
                        "flash_attention_f32", "flash_attention_bwd_f32", "flash_band"])
    (out_dir / "nvcc.log").write_text("\n".join(f"== {k}\n{v}" for k, v in builds.items()))
    for stem, text in builds.items():
        regs = [ln.strip() for ln in text.splitlines() if "Used" in ln and "registers" in ln]
        spills = [ln.strip() for ln in text.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        serialised = sum(any(f"({c})" in ln for c in SERIALISED) for ln in text.splitlines())
        log(f"  built {stem}: {'; '.join(regs) or 'ok'}; "
            f"{len(spills)} of {len(regs)} kernels spill{': ' + '; '.join(spills) if spills else ''}; "
            f"{serialised} with serialised wgmma")
        # the fp32 flash kernels sit near the register budget, where ptxas
        # spills or serialises wgmma without failing the build
        require(stem not in ("flash_attention_f32", "flash_attention_bwd_f32", "flash_band")
                or not (spills or serialised),
                f"{stem} spills or serialises wgmma ({', '.join(SERIALISED)})")
    log(f"  build {time.time() - t0:.1f} s")

    log("== phase 2: kernels against their plain versions (bf16 unless stated)")
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB
    flush = scratch.zero_
    recs = kernel_records()
    check_gn(torch, recs["gn_silu"], flush)
    check_attention(torch, recs["flash_attention"], flush)
    check_nearest(torch, recs["nearest_code"], flush)
    log("== phase 2b: flash-attention backward (Di pass + fused kernel) against its plain "
        "version")
    # 512^2 training bottleneck, a shorter sequence, the tiny card model's Dh
    check_attention_backward(torch, recs["flash_attention_bwd"], flush,
                             ((8, 8, 1024, 128), (4, 8, 256, 128), (2, 4, 64, 64),
                              (2, 8, 1024, 128)), 6)
    log("  -- Dh 512 (the codec's AttnBlockVQ): 256^2, a ragged T, codec fine-tuning at 512^2")
    check_attention_backward(torch, recs["flash_attention_bwd_dh512"], flush,
                             ((2, 1, 4096, 512), (1, 1, 2500, 512), (2, 1, 16384, 512)), 16)
    log("== phase 2c: GroupNorm+SiLU backward (GNSiLUFunction) against autograd")
    check_gn_backward(torch, flush)
    del scratch
    torch.cuda.empty_cache()
    log(f"  phase 2 done at {time.time() - t0:.1f} s")

    log("== phase 3: tiny STEDM, card against CPU")
    tiny_parity(torch)
    log("== phase 3b: tiny STEDM trained on the card against the CPU")
    tiny_train_parity(torch)
    log("== phase 3c: a tiny codec fine-tuned on the card against the CPU (vq, then kl)")
    tiny_codec_parity(torch)
    log("== phase 3d: the tiny STEDM in the composed serving mode, card (eager and graph "
        "replay) against CPU")
    tiny_serving_parity(torch)

    log("== phase 4: flagship main path (256^2, batch 8, DDIM-50, CFG 1.5, phi 0.7, "
        "shared-encoder batched CFG)")
    batch_size = 8
    model, batch, schedule = build_flagship(batch=batch_size)
    cfg = SamplerConfig(ddim_steps=50, eta=0.0, cfg_scale=1.5, rescale_phi=0.7,
                        batched_cfg=True, downsample=4)
    sample = make_sample_fn(model, schedule, cfg)
    gen = torch.Generator(device="cuda")
    reset_launch_counts()
    t1 = time.time()
    with GNCallLog() as gn_log:
        img = sample(model, batch, generator=gen.manual_seed(0))
        torch.cuda.synchronize()
    cold_s = time.time() - t1
    counts = dict(LAUNCHES)
    n_gn_unet = sum(isinstance(m, GNSiLU) for m in model.unet.modules())
    log(f"  cold run {cold_s:.2f} s; launches {counts}; GN modules in the U-Net: {n_gn_unet}")
    require(tuple(img.shape) == (batch_size, 256, 256, 3), f"shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), "non-finite output")
    require(float(img.min()) >= -1.0 and float(img.max()) <= 1.0, "output outside [-1, 1]")
    require(float(img.float().std()) > 0.0, "flat output")
    require(counts["gn_silu"] >= n_gn_unet * 50, f"too few GN launches: {counts}")
    require(counts["flash_attention"] >= 51, f"too few attention launches: {counts}")
    require(counts["nearest_code"] >= 1, f"no nearest-code launch: {counts}")
    require(sum(gn_log.calls.values()) == counts["gn_silu"], "the GN call log missed calls")
    gn_bound_ms = gn_log.report()
    t1 = time.time()
    img2 = sample(model, batch, generator=gen.manual_seed(0))
    torch.cuda.synchronize()
    warm_s = time.time() - t1
    log(f"  warm run vs cold run, same seed: max |diff| "
        f"{float((img.float() - img2.float()).abs().max()):.3e}")
    ips = batch_size / warm_s
    log(f"  flagship img/s (warm run, {warm_s:.3f} s): {ips:.4f} on {card}")
    # the spread of the host clock, for the record
    more = timed_runs(torch, lambda: sample(model, batch, generator=gen.manual_seed(0)), 3)
    median_s = _median([warm_s] + more)
    log("  warm runs img/s: " + " ".join(f"{batch_size / t:.4f}" for t in [warm_s] + more)
        + f"; median {batch_size / median_s:.4f}")

    log("== phase 5: where the device time goes (one more warm run, profiled)")
    reset_launch_counts()
    kernels = profile_main_path(torch, lambda: sample(model, batch, generator=gen.manual_seed(0)),
                                median_s * 1e3, out_dir)
    gn_kernels = sum(n for name, n, _ in kernels if "gn_silu_kernel" in name)
    gn_ms = sum(ms for name, _, ms in kernels if "gn_silu_kernel" in name)
    foreign = [name for name, _, _ in kernels if "triton" in name.lower()
               or name.startswith(("stats_kernel", "apply_kernel"))]
    log(f"  GN device kernels {gn_kernels} for {LAUNCHES['gn_silu']} wrapper launches, "
        f"{gn_ms:.2f} ms against the sum of their bounds {gn_bound_ms:.3f} ms; Triton kernels: "
        f"{len(foreign)}")
    require(gn_kernels == LAUNCHES["gn_silu"], "GN device kernels and launches differ")
    require(not foreign, f"Triton kernels on the main path: {foreign[:3]}")
    log("== phase 4d: the serving mode (bench.py's headline: cache_schedule auto:5, "
        "cfg_interval (0.35, 0.65), cache levels 1), eager and graph-replayed; the exact "
        "trajectory graph-replayed")
    serving = serving_flagship(torch, model, batch, schedule, img, out_dir, card)
    del model, sample, img, img2
    torch.cuda.empty_cache()

    host_us = wrapper_host_times(torch)
    log("== phase 4b: full-width training (512^2, batch 8, bf16, AdamW lr 1e-4, wd 0.01, "
        "accumulation 4, EMA)")
    train = train_flagship(torch, out_dir)
    torch.cuda.empty_cache()
    log("== phase 4c: full-width codec fine-tuning (vq-f4, 512^2, batch 2, bf16, Adam, "
        "LPIPS + PatchGAN)")
    codec = codec_finetune(torch, out_dir)
    torch.cuda.empty_cache()
    log("== phase 6: the train and predict entry points at the shipped widths (landscape "
        "U-Net, VQ-f4, Swin-V2-T, 512^2) on a synthetic Flowers-102")
    entry_root, entry = entry_points(torch)
    torch.cuda.empty_cache()
    t7 = time.time()
    log("== phase 7a: a tiny SegUNet trained and evaluated on the card against the CPU "
        "(fp32), then a wrong variant")
    seg_parity = tiny_seg_parity(torch)
    log("== phase 7b: the MiT-B2 U-Net at the shipped widths (512^2, batch 2, accumulation 4, "
        "bf16, AdamW wd 1e-4)")
    seg = seg_flagship(torch, out_dir)
    torch.cuda.empty_cache()
    log("== phase 7c: train_seg.main on phase 6's Flowers tree and its predicted pairs")
    seg_entry = seg_entry_point(torch, entry_root)
    seg_seconds = time.time() - t7
    log(f"  phase 7 took {seg_seconds:.1f} s")
    her2 = histopathology(torch)
    workflow, workflow_counts = generation_workflow(torch, entry_root, out_dir, card)
    phase10, phase10_counts = fp32_and_wide(torch, entry_root, out_dir, card, recs)
    phase11, phase11_counts = several_processes(torch, entry_root, her2.pop("her2_keep"), card)
    phase12, phase12_counts = model_options(torch, entry_root, out_dir, card, recs,
                                            sum(ms for _, _, ms in kernels))
    phase13, phase13_counts = head_dims(torch, entry_root, recs)
    phase14, phase14_counts = wide_heads(torch, entry_root, recs)
    phase15, phase15_counts = band_route(torch, entry_root, recs)
    shutil.rmtree(entry_root, ignore_errors=True)
    # launches: each kernel's count on each main path it runs on, zeroed just
    # before and read just after (the sampler's batch, the serving batch, one
    # training micro-step, one codec step, the entry points, one segmentation
    # micro-step, the segmentation entry point)
    path_counts = {"sample_batch": counts, "serving_batch": serving.pop("serving_counts"),
                   "train_micro_step": train["train_launches_per_micro_step"],
                   "codec_step": codec["codec_launches_per_step"], **entry["entry_counts"],
                   "seg_train_step": seg["seg_launches_per_micro_step"],
                   "seg_entry": seg_entry["seg_entry_counts"], **her2.pop("her2_counts"),
                   **workflow_counts, **phase10_counts, **phase11_counts, **phase12_counts,
                   **phase13_counts, **phase14_counts, **phase15_counts}
    # no route runs the plain attention on the card (above Dh 1024 the band
    # kernels), so no path counts it
    plain = {p: c.get("attention_plain", 0) for p, c in path_counts.items()}
    log(f"  attention_plain on each path: {plain}")
    for p, n in plain.items():
        require(n == 0, f"{p} ran the plain attention {n} times")
    not_run = her2.pop("paths_not_run")
    if not_run:
        log(f"  launches on {', '.join(not_run)}: null, those paths did not run")
    for name, rec in recs.items():
        # null on a path that did not run; 0 on one where the kernel's counter
        # counts the other instance of its kernel (the backward's Dh)
        per_path = {f"launches_{p}": None if p in not_run else
                    path_counts[p].get(rec.counter, 0) if p in rec.paths else 0
                    for p in KernelRecord.PATHS}
        rec.entry["launches"] = next((n for n in per_path.values() if n), 0)
        rec.entry.update(per_path)
        require(rec.entry["launches"] > 0, f"{name} was launched on no main path")

    log(f"  total {time.time() - t0:.1f} s")
    print(json.dumps({"flagship_img_per_s": ips,
                      "flagship_img_per_s_runs": [batch_size / t for t in [warm_s] + more],
                      "gn_bound_ms_sample_batch": gn_bound_ms, "gn_ms_sample_batch": gn_ms,
                      "host_us_per_call": host_us, **serving, **train, **codec, **entry,
                      **seg_parity, **seg, **seg_entry, "seg_seconds": seg_seconds,
                      **her2, **workflow, **phase10, **phase11, **phase12, **phase13,
                      **phase14, **phase15, "card": card}))
    # the line holds each kernel's summary; its shapes and its launches on
    # every path (tens of kB) go to <out>/kernels.json
    (out_dir / "kernels.json").write_text(json.dumps([r.entry for r in recs.values()], indent=1))
    print(json.dumps({"kernels": [{k: r.entry[k] for k in KERNEL_KEYS} for r in recs.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
