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
   run's EMA weights, exact (128 DDIM steps) and in the serving mode
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
8. a ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

fp32 matrix products and convolutions run without TF32 here (both backend
flags are set False) so the fp32 plain versions are exact references.

``--out DIR`` (default ``build/chip_smoke``, git-ignored) receives the nvcc
log and the profile table.
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


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


class KernelRecord:
    """Per-kernel sums over the checked shapes plus each shape's numbers."""

    PATHS = ("sample_batch", "serving_batch", "train_micro_step", "codec_step", "entry_train",
             "entry_predict_exact", "entry_predict_serving", "seg_train_step", "seg_entry")

    def __init__(self, name, route, source, replaces, counter=None, paths=PATHS):
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


def bf16_close(got, ref, rel: float, abs_: float):
    """max |got - ref| and whether every element is within rel*|ref| + abs."""
    d = (got.float() - ref.float()).abs()
    return float(d.max()), bool((d <= rel * ref.float().abs() + abs_).all())


def check_gn(torch, rec, flush):
    from stedm_tpu_torch.ops import gn_silu as g

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (shape NHWC, mode, eps)
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


def check_attention(torch, rec, flush):
    from stedm_tpu_torch.ops import blocked_attention as a

    gen = torch.Generator(device="cuda").manual_seed(2)
    # U-Net bottleneck and VQ decoder at 256^2 (sampling); the U-Net bottleneck
    # and the VQ encoder at 512^2 (training: the first with the LSE, the second
    # the frozen encode, batch 8); a ragged T and the head dimension between
    # and the entry points' bottleneck (predict's CFG fan-out, training) and
    # VQ mid-block at 512^2, batch 2
    for shape in ((16, 8, 256, 128), (8, 1, 4096, 512), (8, 8, 1024, 128), (8, 1, 16384, 512),
                  (2, 4, 200, 64), (2, 2, 520, 256), (4, 8, 1024, 128), (2, 8, 1024, 128),
                  (2, 1, 16384, 512)):
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


def _tiny_sampling_models(torch):
    """Phase 3's tiny STEDM on the CPU and a copy on the card, its batch, x_T
    and the schedule."""
    from stedm_tpu_torch.core.schedules import DiffusionSchedule
    from stedm_tpu_torch.models.stedm import STEDM

    p = 32
    torch.manual_seed(4)
    cpu = STEDM(dtype=torch.bfloat16, **_tiny_configs(p)).eval()
    with torch.no_grad():
        for prm in cpu.parameters():
            if prm.dim() == 4:
                prm.add_(0.005)
    gpu = STEDM(dtype=torch.bfloat16, **_tiny_configs(p)).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu.cuda()
    gen = torch.Generator().manual_seed(5)
    seg = torch.zeros(2, p, p, 2)
    seg[..., 0] = 1
    seg[:, 8:20, 4:28] = torch.tensor([0.0, 1.0])
    batch = {"segmentation": seg, "style_imgs": torch.rand(2, 1, p, p, 3, generator=gen) * 2 - 1}
    x_T = torch.randn(2, p // 4, p // 4, 3, generator=gen)
    return cpu, gpu, batch, x_T, DiffusionSchedule.create("linear", 1000, 0.0015, 0.0205)


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


def check_gn_backward(torch, flush):
    """Phase 2c: GNSiLUFunction on the card (CUDA forward, plain backward)
    against autograd of gn_silu_reference at the 512^2 U-Net training shapes."""
    from stedm_tpu_torch.ops import gn_silu as g

    gen = torch.Generator(device="cuda").manual_seed(7)
    for shape, mode in (((8, 128, 128, 128), "add"), ((8, 32, 32, 1024), "add"),
                        ((8, 32, 32, 1024), "film")):
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


def _tiny_configs(p: int) -> dict:
    return dict(
        unet_config=dict(in_channels=6, out_channels=3, model_channels=32,
                         num_res_blocks=1, channel_mult=(1, 4, 8), num_heads=4,
                         attention_resolutions=(32, 16, 8)),
        first_stage_config=dict(embed_dim=3, n_embed=256, ddconfig=dict(
            z_channels=3, resolution=p, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2, 2],
            num_res_blocks=1, attn_resolutions=[])),
        cond_stage_config=dict(n_stages=2, in_channels=2, out_channels=3),
        style_agg="mean", style_sampling="nearby", patch_size=p)


def tiny_train_parity(torch):
    """Phase 3b: the tiny STEDM (Dh 64 at the bottleneck, non-zero proj_out)
    trained for three micro-steps at accumulation 2 in bf16, on the card
    (kernels) and on the CPU (plain versions), same weights, t and noise."""
    from stedm_tpu_torch.core.schedules import DiffusionSchedule
    from stedm_tpu_torch.models.stedm import STEDM
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from stedm_tpu_torch.train.optim import make_optimizer
    from stedm_tpu_torch.train.steps import create_train_state, make_train_step

    p = 32
    torch.manual_seed(8)
    cpu = STEDM(dtype=torch.bfloat16, **_tiny_configs(p))
    for layer in cpu.unet.zero_init_layers():
        layer.reset_parameters()
    gpu = STEDM(dtype=torch.bfloat16, **_tiny_configs(p))
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
    sched = DiffusionSchedule.create("linear", 1000, 0.0015, 0.0205)
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
    for name, extra in (("exact", []), ("serving", [
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

    total = {k: sum(c[k] for c in counts.values()) for k in LAUNCHES}
    for k, v in total.items():
        require(v > 0, f"no {k} launch inside the entry-point calls: {counts}")
    seconds = time.time() - t0
    log(f"  phase 6 took {seconds:.1f} s (its tree stays for phase 7)")
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


# device-kernel name patterns, first match wins
_CATEGORIES = (
    ("gn_silu (CUDA)", r"gn_silu_kernel"),
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=REPO / "build" / "chip_smoke",
                    help="directory for the nvcc log and the profile table")
    out_dir = ap.parse_args().out
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

    stock_flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    t0 = time.time()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"== phase 1: header\n  card: {card}\n  torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for fp32 matmul and cuDNN")
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = build_all(["gn_silu", "flash_attention", "flash_attention_bwd", "nearest_code"])
    (out_dir / "nvcc.log").write_text("\n".join(f"== {k}\n{v}" for k, v in builds.items()))
    for stem, text in builds.items():
        regs = [ln.strip() for ln in text.splitlines() if "Used" in ln and "registers" in ln]
        spills = [ln.strip() for ln in text.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        serialised = sum("(C7512)" in ln or "(C7514)" in ln for ln in text.splitlines())
        log(f"  built {stem}: {'; '.join(regs) or 'ok'}; "
            f"{len(spills)} of {len(regs)} kernels spill{': ' + '; '.join(spills) if spills else ''}; "
            f"{serialised} with serialised wgmma")
    log(f"  build {time.time() - t0:.1f} s")

    log("== phase 2: kernels against their plain versions (bf16 unless stated)")
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB
    flush = scratch.zero_
    recs = {
        "gn_silu": KernelRecord("gn_silu", "cuda", "stedm_tpu_torch/csrc/gn_silu.cu",
                                "stedm_tpu/ops/gn_silu.py:125"),
        "flash_attention": KernelRecord(
            "flash_attention", "cuda", "stedm_tpu_torch/csrc/flash_attention.cu",
            "stedm_tpu/ops/blocked_attention.py:99"),
        # the backward's two instances share one counter: every backward of
        # diffusion training is at Dh 64/128 and every one of codec
        # fine-tuning at Dh 512 (a cluster of four blocks a key tile)
        "flash_attention_bwd": KernelRecord(
            "flash_attention_bwd", "cuda", "stedm_tpu_torch/csrc/flash_attention_bwd.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq)", paths=("sample_batch", "train_micro_step",
                                                "entry_train")),
        "flash_attention_bwd_dh512": KernelRecord(
            "flash_attention_bwd_dh512", "cuda", "stedm_tpu_torch/csrc/flash_attention_bwd.cu",
            f"{stock_flash}:941 (_flash_attention_bwd_dkv) and {stock_flash}:1287 "
            "(_flash_attention_bwd_dq), reached through stedm_tpu/models/vq.py:89",
            counter="flash_attention_bwd", paths=("codec_step",)),
        "nearest_code": KernelRecord("nearest_code", "cuda",
                                     "stedm_tpu_torch/csrc/nearest_code.cu",
                                     "stedm_tpu/ops/quantize.py:62"),
    }
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
    shutil.rmtree(entry_root, ignore_errors=True)
    seg_seconds = time.time() - t7
    log(f"  phase 7 took {seg_seconds:.1f} s")
    # launches: each kernel's count on each main path it runs on, zeroed just
    # before and read just after (the sampler's batch, the serving batch, one
    # training micro-step, one codec step, the entry points, one segmentation
    # micro-step, the segmentation entry point)
    path_counts = {"sample_batch": counts, "serving_batch": serving.pop("serving_counts"),
                   "train_micro_step": train["train_launches_per_micro_step"],
                   "codec_step": codec["codec_launches_per_step"], **entry["entry_counts"],
                   "seg_train_step": seg["seg_launches_per_micro_step"],
                   "seg_entry": seg_entry["seg_entry_counts"]}
    for name, rec in recs.items():
        per_path = {f"launches_{p}": path_counts[p][rec.counter] if p in rec.paths else 0
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
                      "card": card}))
    print(json.dumps({"kernels": [r.entry for r in recs.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
