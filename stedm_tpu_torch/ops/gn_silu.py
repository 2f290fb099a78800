"""Fused GroupNorm(+embedding add | +FiLM)(+SiLU): CUDA kernel and plain version.

Replaces the TPU kernel ``_gn_silu_pallas`` (stedm_tpu/ops/gn_silu.py:125,
body ``_make_kernel`` :53). Semantics follow ``gn_silu_reference`` there
(:166-196): an optional per-sample ``[B, C]`` add goes in before the
statistics, in fp32; statistics are fp32 E[x^2] - E[x]^2 over each of the 32
groups of a sample; the affine, then FiLM ``y * (1 + scale) + shift``, then
SiLU; the output has x's dtype.

Kernel note (``csrc/gn_silu.cu``). The op is bound by memory bandwidth: one
read of x and one write of y against a handful of flops an element. The TPU
kernel keeps a whole sample in VMEM (``MAX_ELEMS_PER_SAMPLE``, :38); a Hopper
block cannot, but a thread-block cluster can hold a (sample, channel block)
slab in its CTAs' shared memory, which they read from each other (DSMEM). So
the kernel is one launch a call: a cluster owns a (sample, channel block) of
whole groups and its CTAs split the rows; each CTA brings its tile in by TMA
and sums it as it lands, the CTAs exchange their sums through DSMEM in rank
order (the same bits on every run), and each normalises its tile from shared
memory. Where a slab does not fit (the VQ shapes), each CTA keeps what fits
and reads the rest again. ``_launch_plan`` (pure arithmetic, so the CPU tests
reach it) fixes every size.

Gradients: ``GNSiLUFunction`` runs the kernel (or, on the CPU, the plain
version) forward and ``gn_silu_backward_reference`` backward, a plain PyTorch
port of stedm_tpu's ``_gn_silu_bwd`` (gn_silu.py:239-278), which is jnp and
not a TPU kernel. ``gn_silu`` takes the Function whenever an input requires
grad, on either device, so the CPU tests exercise the ported backward.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from stedm_tpu_torch._device import ONE_PER_SM, SMEM_LIMIT, load_library, max_active_clusters
from stedm_tpu_torch.ops import LAUNCHES, PLAIN_CALLS

# Launch-plan constants (H100; the shared-memory limit and the
# one-CTA-an-SM floor are _device's): threads a CTA, the bytes a pipeline
# stage aims at, and the cost model's rates: what the kernel draws from HBM
# when reads and writes mix (below the 3.35 TB/s peak), the rate one CTA
# moves bytes at, its fixed time, the time it spends on each box of rows it
# handles, and what a cluster's exchange of sums adds
# (tools/torch_gn_plan_sweep.py).
_THREADS = 512
_STAGE_BYTES = 32768
_MAX_SLOTS = 32
_MAX_CLUSTER = 8
_HBM_BYTES_PER_US = 2.4e6
_CTA_BYTES_PER_US = 3.6e4
_CTA_US = 10.0
_BOX_US = 0.1
_CLUSTER_US = 1.3
# clusters of 1..8 such CTAs an H100 holds at once (132 SMs;
# cudaOccupancyMaxActiveClusters, tools/torch_gn_plan_sweep.py), for the CPU
# tests; the wrapper asks the device (_device.max_active_clusters)
_H100_ACTIVE = (132, 66, 39, 30, 22, 17, 15, 15)
# the order of the ints handed to the kernel (csrc/gn_silu.cu, PlanIdx)
_PLAN_KEYS = ("cg", "width", "col_blocks", "cluster", "rows_per_cta", "box_rows", "box_cols",
              "boxes_per_stage", "box_stride", "stage_stride", "slots", "row_phases",
              "groups_per_block", "red_off", "part_off", "gstat_off", "bar_off", "smem")


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


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _plan_for(b, hw, c, cg, es, width, cluster, active):
    """The sizes of one (channel-block width, cluster size) candidate, with
    its modelled time; None when its shared memory cannot hold one box."""
    vec = 16 // es                          # elements of a 16-byte vector
    row_phases = _THREADS // (width // vec)
    rows0 = -(-hw // cluster)
    target = max(1, min(256, _STAGE_BYTES // (width * es), rows0))
    box_rows = max(d for d in range(1, target + 1) if rows0 % d == 0)
    if 2 * box_rows < target:               # no good divisor: round the rows up
        box_rows = target
    rows_per_cta = _round_up(rows0, box_rows)
    box_cols = max(d for d in range(vec, min(width, 256) + 1, vec) if width % d == 0)
    boxes_per_stage = width // box_cols
    box_stride = _round_up(box_rows * box_cols * es, 128)   # TMA destinations 128-byte aligned
    stage_stride = boxes_per_stage * box_stride
    red = 2 * row_phases * width * 4        # fp32 sums of each row phase
    part = _round_up(2 * (width // cg) * 4, 16)   # the CTA's group sums, read by the other ranks
    gstat = part
    n_boxes = rows_per_cta // box_rows
    slots = min(_MAX_SLOTS, n_boxes,
                (SMEM_LIMIT - red - part - gstat - 128) // (stage_stride + 8))
    if slots < 1:
        return None
    red_off = slots * stage_stride
    part_off = red_off + red
    gstat_off = part_off + part
    bar_off = gstat_off + gstat
    smem = max(bar_off + 8 * slots + 128, ONE_PER_SM)   # 128: the kernel aligns its base
    col_blocks = c // width
    units = b * col_blocks                  # one cluster each
    waves = -(-units // active[cluster - 1])
    reread = max(0, n_boxes - slots) * box_rows * width * es
    cta_us = (_CTA_US + (2 * rows_per_cta * width * es + reread) / _CTA_BYTES_PER_US
              + 2 * n_boxes * _BOX_US     # each box is summed, then normalised
              + (_CLUSTER_US if cluster > 1 else 0.0))
    nbytes = 2 * b * hw * c * es + reread * units * cluster
    # HBM-bound, each further wave still pays a CTA's fixed time
    cost_us = max(waves * cta_us, nbytes / _HBM_BYTES_PER_US + (waves - 1) * _CTA_US)
    return dict(cg=cg, width=width, col_blocks=col_blocks, cluster=cluster,
                rows_per_cta=rows_per_cta, box_rows=box_rows, box_cols=box_cols,
                boxes_per_stage=boxes_per_stage, box_stride=box_stride,
                stage_stride=stage_stride, slots=slots, row_phases=row_phases,
                groups_per_block=width // cg, red_off=red_off, part_off=part_off,
                gstat_off=gstat_off, bar_off=bar_off, smem=smem, resident=n_boxes <= slots,
                blocks=units * cluster, waves=waves, reread_bytes=reread * units * cluster,
                cost_us=cost_us)


@functools.lru_cache(maxsize=None)
def _launch_plan(b: int, hw: int, c: int, groups: int, elem_bytes: int,
                 active: tuple = _H100_ACTIVE) -> dict:
    """Cluster layout of one call; pure arithmetic so the CPU tests reach it.

    A channel block holds whole groups and 16-byte rows (at least 128 bytes
    where C allows, for whole DRAM bursts), at most one 16-byte vector a
    thread across; a cluster of 1-8 CTAs (portable sizes) splits the rows.
    ``active``: the clusters of each size the device holds at once, one CTA
    an SM. Of all candidates the plan takes the least modelled time: the
    waves of clusters times one CTA's time (a fixed part, its bytes at one
    CTA's rate: x once, y once, plus what does not fit and is read again,
    a part for each box of rows and one for the cluster's exchange of sums
    through DSMEM), or all bytes at the HBM rate plus the fixed part of each
    further wave if that is longer; then the wider block, then the smaller
    cluster."""
    if c % groups:
        raise ValueError(f"C={c} is not a multiple of groups={groups}")
    cg = c // groups
    vec = 16 // elem_bytes
    unit = math.lcm(cg, vec)
    min_bytes = min(128, c * elem_bytes)
    widths = [w for w in range(unit, min(c, _THREADS * vec) + 1, unit)
              if c % w == 0 and w * elem_bytes >= min_bytes]
    best = None
    for width in widths:
        for cluster in range(1, min(_MAX_CLUSTER, hw) + 1):
            p = _plan_for(b, hw, c, cg, elem_bytes, width, cluster, active)
            if p is not None and (best is None or (p["cost_us"], -width, cluster) < best[0]):
                best = ((p["cost_us"], -width, cluster), p)
    if best is None:
        raise ValueError(f"no cluster layout for C={c}, groups={groups}")
    return best[1]


def _device_active(index: int) -> tuple:
    """``_H100_ACTIVE`` as device ``index`` reports it."""
    return max_active_clusters("gn_silu", tuple(range(1, _MAX_CLUSTER + 1)), SMEM_LIMIT, index)


@functools.lru_cache(maxsize=None)
def _lib():
    fn = load_library("gn_silu").gn_silu_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ints(plan: dict):
    """A plan as the ints the kernel takes."""
    return (ctypes.c_int * len(_PLAN_KEYS))(*(plan[k] for k in _PLAN_KEYS))


@functools.lru_cache(maxsize=None)
def _plan_ints(b, hw, c, groups, elem_bytes, active):
    return _ints(_launch_plan(b, hw, c, groups, elem_bytes, active))


_FLOAT_TYPES = (torch.bfloat16, torch.float32)


def gn_silu_cuda(x, gamma, beta, add=None, film_scale=None, film_shift=None,
                 *, groups: int = 32, eps: float = 1e-5, apply_silu: bool = True) -> torch.Tensor:
    """Launch the kernel on a contiguous NHWC CUDA tensor (bf16 or fp32);
    gamma and beta ``[C]``, the vectors ``[B, C]``, each bf16 or fp32."""
    if not x.is_cuda or x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("gn_silu kernel takes a contiguous, 16-byte aligned NHWC CUDA tensor")
    if x.dtype not in _FLOAT_TYPES:
        raise ValueError(f"gn_silu kernel takes bf16 or fp32, got {x.dtype}")
    b, h, w, c = x.shape
    if c % groups:
        raise ValueError(f"C={c} is not a multiple of groups={groups}")
    if (film_scale is None) != (film_shift is None) or (add is not None and film_scale is not None):
        raise ValueError("FiLM takes film_scale and film_shift together, and not with add")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.shape != (c,) or t.device != x.device or not t.is_contiguous()
                or t.dtype != gamma.dtype or t.dtype not in _FLOAT_TYPES):
            raise ValueError(f"{name} must be a contiguous [C] tensor on x's device, "
                             "gamma and beta both bf16 or both fp32")
    vecs = [t for t in (add, film_scale, film_shift) if t is not None]
    for t in vecs:
        if (t.shape != (b, c) or t.device != x.device or not t.is_contiguous()
                or t.dtype != vecs[0].dtype or t.dtype not in _FLOAT_TYPES):
            raise ValueError("add / film_scale / film_shift must be contiguous [B, C] tensors "
                             "on x's device, all bf16 or all fp32")
    ints = _plan_ints(b, h * w, c, groups, x.element_size(), _device_active(x.device.index or 0))
    return _launch(x, gamma, beta, add, film_scale, film_shift, eps, apply_silu, ints)


def _launch(x, gamma, beta, add, film_scale, film_shift, eps, apply_silu, ints):
    """One launch of the kernel on inputs ``gn_silu_cuda`` has checked, with
    the plan ``ints`` (``_ints`` of a ``_plan_for`` candidate: the card
    tests and tools/torch_gn_plan_sweep.py try plans the wrapper would not
    choose)."""
    b, h, w, c = x.shape
    vecs = [t for t in (add, film_scale, film_shift) if t is not None]
    out = torch.empty_like(x)
    mode = 1 if add is not None else 2 if film_scale is not None else 0
    v0 = add if add is not None else film_scale
    err = _lib()(x.data_ptr(), out.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 v0.data_ptr() if v0 is not None else None,
                 film_shift.data_ptr() if film_shift is not None else None,
                 int(x.dtype == torch.float32), int(gamma.dtype == torch.bfloat16),
                 int(bool(vecs) and vecs[0].dtype == torch.bfloat16), mode, int(apply_silu),
                 b, h * w, c, ints, eps, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gn_silu launch failed: cudaError {err}")
    LAUNCHES["gn_silu_film" if mode == 2 else "gn_silu"] += 1
    return out


class GNSiLUFunction(torch.autograd.Function):
    """``gn_silu`` with a gradient: the CUDA kernel forward on CUDA tensors
    (the plain version on CPU tensors); ``gn_silu_backward_reference``
    backward, on an output gradient made contiguous NHWC first."""

    @staticmethod
    def forward(ctx, x, gamma, beta, add, film_scale, film_shift, groups: int, eps: float,
                apply_silu: bool):
        fn = gn_silu_cuda if x.is_cuda else gn_silu_reference
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
    add / film_scale / film_shift ``[B, C]``. CUDA tensors launch the CUDA
    kernel; CPU tensors take the plain version; when an input requires grad
    the call goes through ``GNSiLUFunction``."""
    if (film_scale is None) != (film_shift is None):
        raise ValueError("film_scale and film_shift come together")
    if add is not None and film_scale is not None:
        raise ValueError("add and FiLM are exclusive")
    inputs = (x, gamma, beta, add, film_scale, film_shift)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return GNSiLUFunction.apply(*inputs, groups, eps, apply_silu)
    fn = gn_silu_cuda if x.is_cuda else gn_silu_reference
    return fn(x, gamma, beta, add, film_scale, film_shift, groups=groups, eps=eps,
              apply_silu=apply_silu)
