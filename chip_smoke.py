#!/usr/bin/env python3
"""On-card check of stedm_tpu_torch: kernels, main path, one JSON verdict.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. header: the card's name and power limit (nvidia-smi), torch's version; the
   CUDA kernels are built from ``stedm_tpu_torch/csrc`` (one nvcc per source,
   all at once) and the Triton kernel compiles at its first launch;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with the tolerance it prints, timed beside its plain
   version, a PyTorch library call computing the same function (a yardstick
   only; the port never calls it) and its bound on an H100; the forward
   kernels at the sampling and the training shapes;
   2b. the flash-attention backward kernels (dkv, dq), launched directly and
   through ``FlashAttentionFunction``, against ``attention_backward_reference``
   at the training shapes, and the forward's output and LSE against
   ``attention_reference`` and ``torch.logsumexp``;
   2c. ``GNSiLUFunction`` on the card (Triton forward, plain backward): its
   output against ``gn_silu_reference``, its gradients against autograd of
   ``gn_silu_reference`` at the 512^2 U-Net training shapes;
3. a tiny STEDM on the card against the same model on the CPU (plain
   versions), DDIM-4 with rescaled CFG;
   3b. the same tiny model (non-zero ``proj_out``, Dh 64) trained for three
   micro-steps at accumulation 2 on the card and on the CPU, same t and noise;
4. the flagship main path: ``build_flagship(batch=8)`` at 256^2, bf16,
   ``make_sample_fn`` with DDIM-50, CFG 1.5, rescale 0.7 and shared-encoder
   batched CFG, as bench.py runs it; launch counts are zeroed just before and
   read just after, and a second warm run is timed;
5. a profile of one more warm run: device time by kernel category and the
   device's idle share (full table in ``<out>/profile.txt``);
   4b. full-width training, the second main path: ``build_flagship(batch=8,
   patch=512, nonzero_init=True)``, ``make_train_step`` with AdamW lr 1e-4,
   weight decay 0.01, accumulation 4 and the EMA, as tools/bench_train.py
   runs the JAX package; launch counts of one micro-step (zeroed just before,
   read just after), gradient and update checks, samples/s over timed
   applied updates, peak memory and a profile of one micro-step
   (``<out>/profile_train.txt``);
6. a ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

fp32 matrix products and convolutions run without TF32 here (both backend
flags are set False) so the fp32 plain versions are exact references.

``--out DIR`` (default ``build/chip_smoke``, git-ignored) receives the nvcc
log and the profile table.
"""

from __future__ import annotations

import argparse
import json
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
    with CUDA events after the L2 was flushed (``flush``), after 2 warm-ups."""
    import torch

    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


class KernelRecord:
    """Per-kernel sums over the checked shapes plus each shape's numbers."""

    def __init__(self, name, route, source, replaces):
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
        ((8, 128, 128, 512), "plain", 1e-6)]
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
        got = g.gn_silu_triton(x, gamma, beta, **kw)
        ref = g.gn_silu_reference(x, gamma, beta, **kw)
        torch.cuda.synchronize()
        # bf16 output: the two may round to neighbouring bf16 values (2^-7 relative)
        err, ok = bf16_close(got, ref, rel=2 ** -7, abs_=2 ** -9)
        ms = time_ms(lambda: g.gn_silu_triton(x, gamma, beta, **kw), 10, flush)
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
    # U-Net bottleneck and VQ decoder at 256^2 (sampling), VQ encoder at 512^2
    # (training's frozen encode, batch 8)
    for shape in ((16, 8, 256, 128), (8, 1, 4096, 512), (8, 1, 16384, 512)):
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
        iters = 10 if shape[2] <= 256 else 3
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


def check_nearest(torch, rec, flush):
    from stedm_tpu_torch.ops import quantize as qz

    gen = torch.Generator(device="cuda").manual_seed(3)
    n, n_embed = 8 * 64 * 64, 8192
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
    rec.add((n, n_embed), err, ok, ms, pms, lib, 12 * n + 16 * n_embed + 4 * n,
            7 * n * n_embed, FP32_FLOPS)


def tiny_parity(torch):
    """A tiny STEDM, DDIM-4 with rescaled CFG, bf16: card (kernels) against
    CPU (plain versions), same weights and x_T."""
    from stedm_tpu_torch.core.schedules import DiffusionSchedule
    from stedm_tpu_torch.models.stedm import STEDM
    from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn

    p = 32
    cfgs = dict(
        unet_config=dict(in_channels=6, out_channels=3, model_channels=32,
                         num_res_blocks=1, channel_mult=(1, 4, 8), num_heads=4,
                         attention_resolutions=(32, 16, 8)),
        first_stage_config=dict(embed_dim=3, n_embed=256, ddconfig=dict(
            z_channels=3, resolution=p, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2, 2],
            num_res_blocks=1, attn_resolutions=[])),
        cond_stage_config=dict(n_stages=2, in_channels=2, out_channels=3),
        style_agg="mean", style_sampling="nearby", patch_size=p)
    torch.manual_seed(4)
    cpu = STEDM(dtype=torch.bfloat16, **cfgs).eval()
    with torch.no_grad():
        for prm in cpu.parameters():
            if prm.dim() == 4:
                prm.add_(0.005)
    gpu = STEDM(dtype=torch.bfloat16, **cfgs).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu.cuda()
    gen = torch.Generator().manual_seed(5)
    seg = torch.zeros(2, p, p, 2)
    seg[..., 0] = 1
    seg[:, 8:20, 4:28] = torch.tensor([0.0, 1.0])
    batch = {"segmentation": seg, "style_imgs": torch.rand(2, 1, p, p, 3, generator=gen) * 2 - 1}
    x_T = torch.randn(2, p // 4, p // 4, 3, generator=gen)
    sched = DiffusionSchedule.create("linear", 1000, 0.0015, 0.0205)
    cfg = SamplerConfig(ddim_steps=4, eta=0.0, cfg_scale=1.5, rescale_phi=0.7,
                        batched_cfg=True, downsample=4)
    ref = make_sample_fn(cpu, sched, cfg, device="cpu")(cpu, batch, x_T=x_T)
    got = make_sample_fn(gpu, sched, cfg, device="cuda")(gpu, batch, x_T=x_T).cpu()
    d = (got.float() - ref.float()).abs()
    mean_err, max_err = float(d.mean()), float(d.max())
    # bf16 activations, other conv algorithms and summation orders on the two
    # devices, through four U-Net passes and the decoder
    ok = bool(torch.isfinite(got).all()) and mean_err <= 1e-2 and max_err <= 0.125
    log(f"  tiny STEDM card vs CPU: mean_abs_err={mean_err:.3e} max_abs_err={max_err:.3e} "
        f"(tolerance mean 1e-2, max 0.125) {'ok' if ok else 'FAILED'}")
    require(ok, "tiny STEDM on the card disagrees with the CPU reference")


def _abs_bound(*pairs):
    """sum of |a| @ |b|: the magnitude a sum of products can lose to
    rounding and to its summation order."""
    return sum(a.float().abs() @ b.float().abs() for a, b in pairs)


def check_attention_backward(torch, rec_dkv, rec_dq, flush):
    """Phase 2b: dkv and dq against the plain backward, the forward's LSE
    against torch.logsumexp; times beside the plain backward and the
    autograd backward of SDPA (both compute dq, dk and dv together: compare
    them with dkv + dq)."""
    from stedm_tpu_torch.ops import blocked_attention as a

    gen = torch.Generator(device="cuda").manual_seed(6)
    # 512^2 training bottleneck, a shorter sequence, the tiny card model's Dh
    for shape in ((8, 8, 1024, 128), (4, 8, 256, 128), (2, 4, 64, 64)):
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        s = shape[-1] ** -0.5
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
        di = a._row_dot(do, o)
        dk, dv = a.flash_attention_bwd_dkv_cuda(q, k, v, lse, do, di, s)
        dq = a.flash_attention_bwd_dq_cuda(q, k, v, lse, do, di, s)
        # the same gradients through FlashAttentionFunction, as the model takes
        # them; the output gradient reaches it non-contiguous, as it does
        # behind the AttentionBlock's reshape
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out_fn = a.flash_attention(*leaves, s)
        grads_fn = torch.autograd.grad(out_fn.transpose(1, 2), leaves,
                                       do.transpose(1, 2).contiguous())
        del leaves
        ref = a.attention_backward_reference(q, k, v, o, lse, do, s)
        torch.cuda.synchronize()
        # the kernels are deterministic, so the Function's results equal the
        # direct launches bit for bit
        same = torch.equal(out_fn, o) and all(
            torch.equal(x, y) for x, y in zip(grads_fn, (dq, dk, dv)))
        del out_fn
        # P and dS round to bf16 on both sides (at most one ulp apart), the
        # sums run in other orders and the outputs round to bf16: within 2^-7
        # of the sum of |terms| plus |ref|
        p = torch.softmax(logits, -1)
        del logits
        ds = p * (do.float() @ v.float().transpose(-1, -2) - di[..., None]) * s
        errs, fn_errs = {}, {}
        for name, got, got_fn, r, bound in (
                ("dq", dq, grads_fn[0], ref[0], _abs_bound((ds, k))),
                ("dk", dk, grads_fn[1], ref[1], _abs_bound((ds.transpose(-1, -2), q))),
                ("dv", dv, grads_fn[2], ref[2], _abs_bound((p.transpose(-1, -2), do)))):
            tol = 2 ** -7 * (bound + r.float().abs())
            for out, g in ((errs, got), (fn_errs, got_fn)):
                diff = (g.float() - r.float()).abs()
                out[name] = (float(diff.max()), bool((diff <= tol).all()))
            del diff, bound, tol
        del p, ds, ref, grads_fn
        for label, e in (("kernels", errs), ("FlashAttentionFunction", fn_errs)):
            log(f"  backward {list(shape)} {label}: " + ", ".join(
                f"{n} max_abs_err={x:.3e} {'ok' if ok else 'OUT OF TOLERANCE'}"
                for n, (x, ok) in e.items()) + " (tolerance 2^-7 (sum|terms| + |ref|))")
        log(f"  FlashAttentionFunction output and gradients equal the direct launches bit "
            f"for bit: {same}")
        require(same and all(ok for _, ok in fn_errs.values()),
                f"FlashAttentionFunction's gradients disagree at {list(shape)}")
        iters = 10
        ms_dkv = time_ms(lambda: a.flash_attention_bwd_dkv_cuda(q, k, v, lse, do, di, s),
                         iters, flush)
        ms_dq = time_ms(lambda: a.flash_attention_bwd_dq_cuda(q, k, v, lse, do, di, s),
                        iters, flush)
        ms_di = time_ms(lambda: a._row_dot(do, o), iters, flush)
        pms = time_ms(lambda: a.attention_backward_reference(q, k, v, o, lse, do, s), 3, flush)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=s)
        lib = time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), iters,
                      flush)
        del out, leaves
        bh, t, dh = shape[0] * shape[1], shape[2], shape[3]
        n = bh * t * dh
        pair_bound = max((5 * n * 2 + bh * t * 4 + 3 * n * 2) / HBM_BYTES_PER_S,
                         10 * bh * t * t * dh / BF16_FLOPS) * 1e3
        log(f"  backward {list(shape)}: dkv+dq {ms_dkv + ms_dq:.4f} ms (+ Di {ms_di:.4f} ms "
            f"in torch) against the pair's bound {pair_bound:.4f} ms (10 BH T^2 Dh flops)")
        # each kernel's own function: dkv needs S, dV, dP, dK (8 BH T^2 Dh
        # flops), dq needs S, dP, dQ (6); both read q, k, v, dO, LSE and Di
        reads = 4 * n * 2 + 2 * bh * t * 4
        rec_dkv.add(shape, max(errs["dk"][0], errs["dv"][0]), errs["dk"][1] and errs["dv"][1],
                    ms_dkv, pms, lib, reads + 2 * n * 2, 8 * bh * t * t * dh, BF16_FLOPS)
        rec_dq.add(shape, errs["dq"][0], errs["dq"][1], ms_dq, pms, lib, reads + n * 2,
                   6 * bh * t * t * dh, BF16_FLOPS)


def check_gn_backward(torch, flush):
    """Phase 2c: GNSiLUFunction on the card (Triton forward, plain backward)
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
        # the Function's forward output (the Triton kernel), as check_gn holds it
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
    require(counts["flash_attention_bwd_dkv"] >= 3 and counts["flash_attention_bwd_dq"] >= 3,
            f"the card's tiny training did not launch the backward kernels: {counts}")
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


def train_flagship(torch, out_dir: Path) -> dict:
    """Phase 4b: full-width training (the second main path); returns its numbers."""
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
    for name in ("gn_silu", "flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        require(counts[name] >= 1, f"no {name} launch in a training micro-step: {counts}")
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


# device-kernel name patterns, first match wins
_CATEGORIES = (
    ("gn_silu (Triton)", r"stats_kernel|apply_kernel"),
    ("flash_attention (CUDA)", r"flash_fwd_kernel"),
    ("flash_attention_bwd_dkv (CUDA)", r"flash_bwd_dkv_kernel"),
    ("flash_attention_bwd_dq (CUDA)", r"flash_bwd_dq_kernel"),
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
                      table: str = "profile.txt") -> None:
    """Device time by kernel category over one warm main-path run
    (torch.profiler; CUDA kernel events only, so nothing counts twice). The
    idle share is also given against ``unprofiled_ms``, the wall time of the
    same run without the profiler's host overhead."""
    import re

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
        return
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
    builds = build_all(["flash_attention", "flash_attention_bwd", "nearest_code"])
    (out_dir / "nvcc.log").write_text("\n".join(f"== {k}\n{v}" for k, v in builds.items()))
    for stem, text in builds.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"  built {stem}: {'; '.join(regs) or 'ok'}")
    log(f"  build {time.time() - t0:.1f} s")

    log("== phase 2: kernels against their plain versions (bf16 unless stated)")
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB
    flush = scratch.zero_
    recs = {
        "gn_silu": KernelRecord("gn_silu", "triton", "stedm_tpu_torch/ops/gn_silu.py",
                                "stedm_tpu/ops/gn_silu.py:125"),
        "flash_attention": KernelRecord(
            "flash_attention", "cuda", "stedm_tpu_torch/csrc/flash_attention.cu",
            "stedm_tpu/ops/blocked_attention.py:99"),
        "flash_attention_bwd_dkv": KernelRecord(
            "flash_attention_bwd_dkv", "cuda", "stedm_tpu_torch/csrc/flash_attention_bwd.cu",
            f"{stock_flash}:941"),
        "flash_attention_bwd_dq": KernelRecord(
            "flash_attention_bwd_dq", "cuda", "stedm_tpu_torch/csrc/flash_attention_bwd.cu",
            f"{stock_flash}:1287"),
        "nearest_code": KernelRecord("nearest_code", "cuda",
                                     "stedm_tpu_torch/csrc/nearest_code.cu",
                                     "stedm_tpu/ops/quantize.py:62"),
    }
    check_gn(torch, recs["gn_silu"], flush)
    check_attention(torch, recs["flash_attention"], flush)
    check_nearest(torch, recs["nearest_code"], flush)
    log("== phase 2b: flash-attention backward kernels against their plain version")
    check_attention_backward(torch, recs["flash_attention_bwd_dkv"],
                             recs["flash_attention_bwd_dq"], flush)
    log("== phase 2c: GroupNorm+SiLU backward (GNSiLUFunction) against autograd")
    check_gn_backward(torch, flush)
    del scratch
    torch.cuda.empty_cache()
    log(f"  phase 2 done at {time.time() - t0:.1f} s")

    log("== phase 3: tiny STEDM, card against CPU")
    tiny_parity(torch)
    log("== phase 3b: tiny STEDM trained on the card against the CPU")
    tiny_train_parity(torch)

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
    t1 = time.time()
    img2 = sample(model, batch, generator=gen.manual_seed(0))
    torch.cuda.synchronize()
    warm_s = time.time() - t1
    log(f"  warm run vs cold run, same seed: max |diff| "
        f"{float((img.float() - img2.float()).abs().max()):.3e}")
    ips = batch_size / warm_s
    log(f"  flagship img/s (warm run, {warm_s:.3f} s): {ips:.4f} on {card}")
    more = []
    for _ in range(3):   # the spread of the host clock, for the record
        t1 = time.time()
        sample(model, batch, generator=gen.manual_seed(0))
        torch.cuda.synchronize()
        more.append(time.time() - t1)
    runs = sorted([warm_s] + more)
    median_s = (runs[1] + runs[2]) / 2
    log("  warm runs img/s: " + " ".join(f"{batch_size / t:.4f}" for t in [warm_s] + more)
        + f"; median {batch_size / median_s:.4f}")

    log("== phase 5: where the device time goes (one more warm run, profiled)")
    profile_main_path(torch, lambda: sample(model, batch, generator=gen.manual_seed(0)),
                      median_s * 1e3, out_dir)
    del model, sample, img, img2
    torch.cuda.empty_cache()

    log("== phase 4b: full-width training (512^2, batch 8, bf16, AdamW lr 1e-4, wd 0.01, "
        "accumulation 4, EMA)")
    train = train_flagship(torch, out_dir)
    # launches: each kernel's count on its main path, zeroed just before and
    # read just after (the sampler's batch; one training micro-step for the
    # backward kernels, which only training runs)
    train_counts = train["train_launches_per_micro_step"]
    for name, rec in recs.items():
        rec.entry["launches"] = counts[name] or train_counts[name]
        rec.entry["launches_sample_batch"] = counts[name]
        rec.entry["launches_train_micro_step"] = train_counts[name]

    log(f"  total {time.time() - t0:.1f} s")
    print(json.dumps({"flagship_img_per_s": ips,
                      "flagship_img_per_s_runs": [batch_size / t for t in [warm_s] + more],
                      **train, "card": card}))
    print(json.dumps({"kernels": [r.entry for r in recs.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
