"""Fused GroupNorm(+embedding add | +FiLM)(+SiLU): Triton kernel and plain version.

Replaces the TPU kernel ``_gn_silu_pallas`` (stedm_tpu/ops/gn_silu.py:125,
body ``_make_kernel`` :53). Semantics follow ``gn_silu_reference`` there
(:166-196): an optional per-sample ``[B, C]`` add goes in before the
statistics, in fp32; statistics are fp32 E[x^2] - E[x]^2 over each of the 32
groups of a sample; the affine, then FiLM ``y * (1 + scale) + shift``, then
SiLU; the output has x's dtype.

Kernel note. On the H100 the op is bound by memory bandwidth: it has to read
x once for the statistics and once more for the normalisation (the 50 MB L2
keeps some of the second read on chip) and write y once, about 3 bytes of
traffic per bf16 element against a handful of flops. The TPU kernel keeps a
whole sample in VMEM (``MAX_ELEMS_PER_SAMPLE``, :38); a Hopper block cannot
(the VQ decoder's 256^2 x 256 slab is 16.8 M elements), and nothing carries
between blocks. So the kernel is a split reduction in two launches:

1. programs over (sample, row chunk, 128-channel block) write per-channel
   fp32 sums of x and x^2 of their tile to a workspace, loads contiguous
   over C;
2. programs over (sample, row chunk, channel block) fold the workspace over
   chunks and over the channels of each group, then normalise, apply
   affine/FiLM/SiLU and write their tile. These channel blocks hold whole
   groups, so the fold stays inside one program even where C/32 is not a
   power of two.

A workspace, not atomics, keeps the summation order (and the result) fixed
from run to run.

Gradients: ``GNSiLUFunction`` runs the kernel (or, on the CPU, the plain
version) forward and ``gn_silu_backward_reference`` backward, a plain PyTorch
port of stedm_tpu's ``_gn_silu_bwd`` (gn_silu.py:239-278), which is jnp and
not a TPU kernel. ``gn_silu`` takes the Function whenever an input requires
grad, on either device, so the CPU tests exercise the ported backward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from stedm_tpu_torch.ops import LAUNCHES, PLAIN_CALLS

# programs to aim for per launch: four waves over the H100's 132 SMs
_TARGET_PROGRAMS = 4 * 132
_BLOCK_R = 64
_STATS_BLOCK_C = 128


def _forward_parts(x, gamma, beta, add, film_scale, film_shift, groups: int, eps: float):
    """stedm_tpu's ``_forward_parts`` (gn_silu.py:166-186), fp32: the
    normalised ``xhat``, ``rstd`` ``[B, 1, G, 1]``, the affine output ``z`` and
    the pre-activation ``wv`` (``z`` after FiLM)."""
    b, h, w, c = x.shape
    xf = x.float()
    if add is not None:
        xf = xf + add.float()[:, None, None, :]
    xg = xf.reshape(b, h * w, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    xhat = ((xg - mean) * rstd).reshape(b, h, w, c)
    z = xhat * gamma.float() + beta.float()
    wv = z
    if film_scale is not None:
        wv = z * (1.0 + film_scale.float()[:, None, None, :]) \
            + film_shift.float()[:, None, None, :]
    return xhat, rstd, z, wv


def gn_silu_reference(x, gamma, beta, add=None, film_scale=None, film_shift=None,
                      *, groups: int = 32, eps: float = 1e-5,
                      apply_silu: bool = True) -> torch.Tensor:
    """Plain version on NHWC ``x``; the numerics of stedm_tpu's
    ``_forward_parts`` + ``gn_silu_reference``."""
    wv = _forward_parts(x, gamma, beta, add, film_scale, film_shift, groups, eps)[3]
    y = F.silu(wv) if apply_silu else wv
    return y.to(x.dtype)


def gn_silu_backward_reference(g, x, gamma, beta, add=None, film_scale=None,
                               film_shift=None, *, groups: int = 32, eps: float = 1e-5,
                               apply_silu: bool = True):
    """The gradients of ``gn_silu`` for the output gradient ``g``: a plain port
    of stedm_tpu's ``_gn_silu_bwd`` (gn_silu.py:239-278), recomputing the
    statistics through ``_forward_parts``. Returns ``(dx, d_gamma, d_beta,
    d_add, d_film_scale, d_film_shift)``, each in its input's dtype (None for
    an absent input)."""
    b, h, w, c = x.shape
    cg = c // groups
    xhat, rstd, z, wv = _forward_parts(x, gamma, beta, add, film_scale, film_shift,
                                       groups, eps)
    gf = g.float()
    if apply_silu:
        sig = torch.sigmoid(wv)
        dw = gf * sig * (1.0 + wv * (1.0 - sig))
    else:
        dw = gf
    d_fs = d_fsh = None
    dz = dw
    if film_scale is not None:
        d_fs = (dw * z).sum(dim=(1, 2)).to(film_scale.dtype)
        d_fsh = dw.sum(dim=(1, 2)).to(film_shift.dtype)
        dz = dw * (1.0 + film_scale.float()[:, None, None, :])
    d_gamma = (dz * xhat).sum(dim=(0, 1, 2)).to(gamma.dtype)
    d_beta = dz.sum(dim=(0, 1, 2)).to(beta.dtype)
    dxhat = (dz * gamma.float()).reshape(b, h * w, groups, cg)
    xhat_g = xhat.reshape(b, h * w, groups, cg)
    m1 = dxhat.mean(dim=(1, 3), keepdim=True)
    m2 = (dxhat * xhat_g).mean(dim=(1, 3), keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat_g * m2)).reshape(b, h, w, c)
    d_add = dx.sum(dim=(1, 2)).to(add.dtype) if add is not None else None
    return dx.to(x.dtype), d_gamma, d_beta, d_add, d_fs, d_fsh


def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def stats_kernel(x_ptr, add_ptr, ws_ptr, HW, C, rows_per_chunk, n_chunks,
                     HAS_ADD: tl.constexpr, BLOCK_R: tl.constexpr,
                     BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        k = tl.program_id(1)
        r0 = k * rows_per_chunk
        r_end = tl.minimum(r0 + rows_per_chunk, HW)
        x_base = x_ptr + b.to(tl.int64) * HW * C
        ws_base = ws_ptr + (b * n_chunks + k).to(tl.int64) * 2 * C
        cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        if HAS_ADD:
            a = tl.load(add_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
        s = tl.zeros([BLOCK_C], dtype=tl.float32)
        sq = tl.zeros([BLOCK_C], dtype=tl.float32)
        for r in range(r0, r_end, BLOCK_R):
            rows = r + tl.arange(0, BLOCK_R)
            m = (rows < r_end)[:, None] & cmask[None, :]
            offs = rows[:, None].to(tl.int64) * C + cols[None, :]
            v = tl.load(x_base + offs, mask=m, other=0.0).to(tl.float32)
            if HAS_ADD:
                v = tl.where(m, v + a[None, :], 0.0)
            s += tl.sum(v, axis=0)
            sq += tl.sum(v * v, axis=0)
        tl.store(ws_base + cols, s, mask=cmask)
        tl.store(ws_base + C + cols, sq, mask=cmask)

    @triton.jit
    def apply_kernel(x_ptr, out_ptr, gamma_ptr, beta_ptr, add_ptr, fs_ptr,
                     fsh_ptr, ws_ptr, HW, C, CG, GPB, rows_per_chunk, n_chunks,
                     inv_n, eps, HAS_ADD: tl.constexpr, HAS_FILM: tl.constexpr,
                     APPLY_SILU: tl.constexpr, BLOCK_R: tl.constexpr,
                     BLOCK_C: tl.constexpr, BLOCK_K: tl.constexpr,
                     BLOCK_G: tl.constexpr):
        b = tl.program_id(0)
        k = tl.program_id(1)
        r0 = k * rows_per_chunk
        r_end = tl.minimum(r0 + rows_per_chunk, HW)
        x_base = x_ptr + b.to(tl.int64) * HW * C
        out_base = out_ptr + b.to(tl.int64) * HW * C
        ws_base = ws_ptr + (b * n_chunks).to(tl.int64) * 2 * C
        width = GPB * CG                      # whole groups per channel block
        lc = tl.arange(0, BLOCK_C)
        gl = lc // CG                         # group of each column, block-local
        gs = tl.arange(0, BLOCK_G)
        cols = tl.program_id(2) * width + lc
        cmask = (lc < width) & (cols < C)
        # fold the per-chunk partial sums of these channels
        s = tl.zeros([BLOCK_C], dtype=tl.float32)
        sq = tl.zeros([BLOCK_C], dtype=tl.float32)
        for k0 in range(0, n_chunks, BLOCK_K):
            ks = k0 + tl.arange(0, BLOCK_K)
            m = (ks < n_chunks)[:, None] & cmask[None, :]
            offs = (ks * 2 * C)[:, None] + cols[None, :]
            s += tl.sum(tl.load(ws_base + offs, mask=m, other=0.0), axis=0)
            sq += tl.sum(tl.load(ws_base + offs + C, mask=m, other=0.0), axis=0)
        # fold channels to groups and broadcast the statistics back
        gm = (gl[None, :] == gs[:, None]) & cmask[None, :]
        mean_g = tl.sum(tl.where(gm, s[None, :], 0.0), axis=1) * inv_n
        msq_g = tl.sum(tl.where(gm, sq[None, :], 0.0), axis=1) * inv_n
        rstd_g = tl.rsqrt(msq_g - mean_g * mean_g + eps)
        mean_c = tl.sum(tl.where(gm, mean_g[:, None], 0.0), axis=0)
        rstd_c = tl.sum(tl.where(gm, rstd_g[:, None], 0.0), axis=0)
        gamma = tl.load(gamma_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        beta = tl.load(beta_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        if HAS_ADD:
            a = tl.load(add_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
        if HAS_FILM:
            fs = 1.0 + tl.load(fs_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
            fsh = tl.load(fsh_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
        for r in range(r0, r_end, BLOCK_R):
            rows = r + tl.arange(0, BLOCK_R)
            m = (rows < r_end)[:, None] & cmask[None, :]
            offs = rows[:, None].to(tl.int64) * C + cols[None, :]
            v = tl.load(x_base + offs, mask=m, other=0.0).to(tl.float32)
            if HAS_ADD:
                v = v + a[None, :]
            y = (v - mean_c[None, :]) * rstd_c[None, :] * gamma[None, :] + beta[None, :]
            if HAS_FILM:
                y = y * fs[None, :] + fsh[None, :]
            if APPLY_SILU:
                y = y * tl.sigmoid(y)
            tl.store(out_base + offs, y.to(out_ptr.dtype.element_ty), mask=m)

    return triton, stats_kernel, apply_kernel


_KERNELS = None


def _launch_plan(b: int, hw: int, c: int, groups: int) -> dict:
    """Grid and block sizes; pure arithmetic so the CPU tests reach it."""
    cg = c // groups
    block_c = max(_STATS_BLOCK_C, 1 << (cg - 1).bit_length())
    gpb = min(groups, block_c // cg)
    col_blocks = math.ceil(groups / gpb)
    n_chunks = max(1, min(math.ceil(_TARGET_PROGRAMS / (b * col_blocks)),
                          math.ceil(hw / _BLOCK_R)))
    rows = math.ceil(math.ceil(hw / n_chunks) / _BLOCK_R) * _BLOCK_R
    n_chunks = math.ceil(hw / rows)
    return dict(cg=cg, block_c=block_c, gpb=gpb, block_g=1 << (gpb - 1).bit_length(),
                col_blocks=col_blocks, stats_col_blocks=math.ceil(c / _STATS_BLOCK_C),
                rows_per_chunk=rows, n_chunks=n_chunks,
                block_k=min(64, 1 << (n_chunks - 1).bit_length()))


def gn_silu_triton(x, gamma, beta, add=None, film_scale=None, film_shift=None,
                   *, groups: int = 32, eps: float = 1e-5,
                   apply_silu: bool = True) -> torch.Tensor:
    """Launch the two-pass Triton kernel on a contiguous NHWC CUDA tensor."""
    global _KERNELS
    if not x.is_cuda or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("gn_silu kernel takes a contiguous NHWC CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gn_silu kernel takes bf16 or fp32, got {x.dtype}")
    b, h, w, c = x.shape
    if c % groups:
        raise ValueError(f"C={c} is not a multiple of groups={groups}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (c,) or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA [C] tensor")
    for name, t in (("add", add), ("film_scale", film_scale), ("film_shift", film_shift)):
        if t is not None and (t.shape != (b, c) or not t.is_cuda or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA [B, C] tensor")
    if _KERNELS is None:
        _KERNELS = _kernels()
    triton, stats_kernel, apply_kernel = _KERNELS
    p = _launch_plan(b, h * w, c, groups)
    out = torch.empty_like(x)
    ws = torch.empty((b, p["n_chunks"], 2, c), device=x.device, dtype=torch.float32)
    dummy = gamma   # stands in for absent optional pointers; never read
    stats_kernel[(b, p["n_chunks"], p["stats_col_blocks"])](
        x, add if add is not None else dummy, ws, h * w, c, p["rows_per_chunk"],
        p["n_chunks"], HAS_ADD=add is not None, BLOCK_R=_BLOCK_R,
        BLOCK_C=_STATS_BLOCK_C, num_warps=4)
    apply_kernel[(b, p["n_chunks"], p["col_blocks"])](
        x, out, gamma, beta, add if add is not None else dummy,
        film_scale if film_scale is not None else dummy,
        film_shift if film_shift is not None else dummy, ws, h * w, c, p["cg"],
        p["gpb"], p["rows_per_chunk"], p["n_chunks"], 1.0 / (h * w * p["cg"]),
        eps, HAS_ADD=add is not None, HAS_FILM=film_scale is not None,
        APPLY_SILU=apply_silu, BLOCK_R=_BLOCK_R, BLOCK_C=p["block_c"],
        BLOCK_K=p["block_k"], BLOCK_G=p["block_g"], num_warps=4)
    LAUNCHES["gn_silu"] += 1
    return out


class GNSiLUFunction(torch.autograd.Function):
    """``gn_silu`` with a gradient: the Triton kernel forward on CUDA tensors
    (the plain version on CPU tensors); ``gn_silu_backward_reference``
    backward, on an output gradient made contiguous NHWC first."""

    @staticmethod
    def forward(ctx, x, gamma, beta, add, film_scale, film_shift, groups: int, eps: float,
                apply_silu: bool):
        fn = gn_silu_triton if x.is_cuda else gn_silu_reference
        ctx.save_for_backward(x, gamma, beta, add, film_scale, film_shift)
        ctx.cfg = dict(groups=groups, eps=eps, apply_silu=apply_silu)
        return fn(x, gamma, beta, add, film_scale, film_shift, **ctx.cfg)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors   # read once: checkpointing allows one unpack
        if saved[0].is_cuda:
            PLAIN_CALLS["gn_silu_bwd"] += 1
        grads = gn_silu_backward_reference(g.contiguous(), *saved, **ctx.cfg)
        return (*grads, None, None, None)


def gn_silu(x, gamma, beta, add=None, film_scale=None, film_shift=None, *,
            groups: int = 32, eps: float = 1e-5, apply_silu: bool = True):
    """GroupNorm(+add | +FiLM)(+SiLU) over NHWC ``x``; gamma/beta ``[C]``,
    add / film_scale / film_shift ``[B, C]``. CUDA tensors launch the Triton
    kernel; CPU tensors take the plain version; when an input requires grad
    the call goes through ``GNSiLUFunction``."""
    if (film_scale is None) != (film_shift is None):
        raise ValueError("film_scale and film_shift come together")
    if add is not None and film_scale is not None:
        raise ValueError("add and FiLM are exclusive")
    inputs = (x, gamma, beta, add, film_scale, film_shift)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return GNSiLUFunction.apply(*inputs, groups, eps, apply_silu)
    fn = gn_silu_triton if x.is_cuda else gn_silu_reference
    return fn(x, gamma, beta, add, film_scale, film_shift, groups=groups, eps=eps,
              apply_silu=apply_silu)
