"""Scaled dot-product attention over ``[B, H, T, Dh]``: flash kernels and plain versions.

``flash_attention`` launches the CUDA forward kernel in
``csrc/flash_attention.cu`` (the port of the stock Pallas TPU flash-attention
forward that stedm_tpu/ops/blocked_attention.py:flash_sdpa and
models/vq.py:AttnBlockVQ call) on CUDA tensors, and ``attention_reference``
on CPU tensors. The forward reads q, k and v through their strides (any
16-byte-aligned batch, head and token pitch, last dimension contiguous) and
writes O in any such layout. bf16 tensors take the bf16 kernels; fp32
tensors (``diffusion.compute_dtype=float32``) take
``csrc/flash_attention_f32.cu`` and ``csrc/flash_attention_bwd_f32.cu``,
which keep fp32 accuracy (3xTF32 wgmma products over TF32 hi and lo copies
that a split pass writes into a workspace) at every head dimension the
forward takes (``KERNELS``), the head dimension split across a cluster of
``fp32_plan``'s size. When a gradient is wanted it goes through
``FlashAttentionFunction``, whose backward launches
``csrc/flash_attention_bwd.cu`` (a Di pass and one fused kernel for dQ, dK
and dV: the port of the stock kernel's ``dkv`` and ``dq`` Pallas kernels,
flash_attention.py:941 and :1287) on CUDA tensors, reading the same strided
views, and ``attention_backward_reference`` on CPU tensors. The backward
runs on compiled instances (``INSTANCES``): the forwards at Dh 32 and the
multiples of 64 up to 512, the bf16 backward at 32 (an instance of its own,
256 keys a block), 64, 128 (the U-Net's AttentionBlock in diffusion
training), 256 and 512 (the codec's AttnBlockVQ in codec fine-tuning,
where a thread-block cluster splits the head dimension), the fp32 kernels
at 32 (instances of their own: the forward's blocks persistent over
128-row work items, the backward's 128 keys a block, on split copies of
the head dimension's own columns) and the multiples of 64; above 512
every kernel at the multiples of 128 up to 1024 (``CLUSTER_HEAD_DIMS``:
one 128-column slice of the head dimension a block, over a cluster of 5
to 8 blocks; the landscape U-Net at ``num_heads: 1`` and a codec whose
mid-block is 1024 wide).
``head_dim_plan`` maps every head dimension from 1 to ``MAX_INSTANCE``
onto the smallest instance at or above it, whose tensor maps (or split
copies) declare the true columns, so the columns past them arrive as zeros
and are never stored; a head dimension whose rows are not 16 bytes apart
first goes into zero-padded copies of the next such width. Above
``MAX_INSTANCE`` every head dimension runs the band route
(``ops/flash_band.py``, ``csrc/flash_band.cu``: tiled products over bands of
rows with fused epilogues, no limit of width), its launches counted as
``flash_band`` (bf16 forward), ``flash_band_bwd``, ``flash_band_f32`` and
``flash_band_bwd_f32``; on the CPU the wrappers take its plain versions,
band by band.

``sdpa`` keeps the JAX dispatch by name. ``exact``, ``chunked``, ``flash`` and
``auto`` name TPU memory strategies for one function, so on a CUDA tensor all
four launch the kernel at any head dimension; on the CPU ``exact`` and
``chunked`` run their plain versions (``_exact`` / ``chunked_sdpa``,
stedm_tpu/ops/blocked_attention.py:73-84 and :50-70) under autograd,
``flash`` the wrapper's plain versions and ``auto`` resolves to ``chunked``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from stedm_tpu_torch._device import check_cuda_tensor, load_library
from stedm_tpu_torch.ops import LAUNCHES, flash_band

# the largest compiled instance; above it the band route (ops/flash_band.py)
MAX_INSTANCE = 1024
# above 512, every kernel's instances: one 128-column slice a cluster rank
CLUSTER_HEAD_DIMS = (640, 768, 896, 1024)
# the compiled instances of the bf16 forward and both fp32 kernels: 32, the
# multiples of 64 up to 512, then CLUSTER_HEAD_DIMS; the bf16 backward's:
# BWD_HEAD_DIMS
HEAD_DIMS = (32,) + tuple(range(64, 513, 64)) + CLUSTER_HEAD_DIMS
BWD_HEAD_DIMS = (32, 64, 128, 256, 512) + CLUSTER_HEAD_DIMS
# the fp32 kernels' head dims split 128 columns a block (Dh 32: 32, the
# others: 64)
FP32_WIDE_HEAD_DIMS = (128, 256, 512) + CLUSTER_HEAD_DIMS
_LOG2E = 1.0 / math.log(2.0)
# the kernels of each dtype: (forward, backward) sources under csrc/, each
# also the name of its LAUNCHES count
KERNELS = {torch.bfloat16: ("flash_attention", "flash_attention_bwd"),
           torch.float32: ("flash_attention_f32", "flash_attention_bwd_f32")}
# each kernel's compiled instances, by head dim
INSTANCES = {"flash_attention": HEAD_DIMS, "flash_attention_bwd": BWD_HEAD_DIMS,
             "flash_attention_f32": HEAD_DIMS, "flash_attention_bwd_f32": HEAD_DIMS}


class HeadDimPlan(NamedTuple):
    """How a kernel runs a head dimension: on its compiled ``instance``,
    reading ``width`` columns (the head dimension itself, or the width of
    the zero-padded copies that the wrapper makes when the rows are not 16
    bytes apart); above ``MAX_INSTANCE`` the band route, whose instance is
    the width (its tensor maps declare it, TMA fills the rest of a
    128-byte box)."""

    instance: int
    width: int

    @property
    def band(self) -> bool:
        return self.instance > MAX_INSTANCE


def head_dim_plan(d: int, dtype, backward: bool) -> HeadDimPlan:
    """The plan of the ``dtype`` forward (or ``backward``) kernel at head dim
    ``d``: the smallest instance at or above the width, where the width is
    ``d`` rounded up to 16 bytes (8 bf16 or 4 fp32 values: TMA and the
    16-byte copies step rows so); above ``MAX_INSTANCE`` the band route."""
    if d < 1:
        raise ValueError(f"head dim must be positive, got {d}")
    per_row = 16 // torch.empty((), dtype=dtype).element_size()
    width = -(-d // per_row) * per_row
    if width > MAX_INSTANCE:
        return HeadDimPlan(width, width)
    stem = KERNELS[dtype][int(backward)]
    return HeadDimPlan(next(i for i in INSTANCES[stem] if i >= width), width)


def launch_counter(stem: str, d: int) -> str:
    """The ``LAUNCHES`` key of a launch of ``stem`` at head dim ``d``: a head
    dim that is not one of the kernel's compiled multiples of 64 up to 512
    counts apart, as ``<stem>_dh<d>`` (Dh 32: ``<stem>_dh32``; the cluster
    instances above 512: ``<stem>_dh1024`` and so on); above
    ``MAX_INSTANCE`` the band route's counter of the same dtype and
    direction (``flash_band``, ``flash_band_bwd``, ``flash_band_f32``,
    ``flash_band_bwd_f32``)."""
    if d > MAX_INSTANCE:
        return stem.replace("flash_attention", "flash_band")
    own = d % 64 == 0 and d <= 512 and d in INSTANCES[stem]
    return stem if own else f"{stem}_dh{d}"


def _count(key: str) -> None:
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


def _padded(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` copied into a contiguous tensor of ``width`` columns, zeros past its own."""
    return F.pad(x, (0, width - x.shape[-1]))


def _largest_divisor_at_most(n: int, cap: int) -> int:
    c = min(cap, n)
    while n % c:
        c -= 1
    return c


def _exact(q, k, v, scale):
    """Reference-ordered math: q and k each scaled by ``scale`` in fp32, fp32
    softmax cast to q's dtype before P V."""
    logits = (q.float() * scale) @ (k.float() * scale).transpose(-1, -2)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return weights @ v


def chunked_sdpa(q, k, v, scale, q_chunk: int = 256):
    """``_exact`` over query chunks: each row still takes its softmax over the
    full key axis, so the math is the exact path's."""
    t = q.shape[2]
    chunk = _largest_divisor_at_most(t, q_chunk)
    if chunk == t:
        return _exact(q, k, v, scale)
    return torch.cat([_exact(q[:, :, s:s + chunk], k, v, scale)
                      for s in range(0, t, chunk)], dim=2)


def attention_reference(q, k, v, sm_scale: float, return_lse: bool = False):
    """Plain version of the forward kernel: softmax(q k^T * sm_scale) v with
    fp32 logits and softmax, P cast to q's dtype before P V; with
    ``return_lse`` also the fp32 log-sum-exp of each row's scaled logits,
    ``[B, H, T]``."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = weights @ v
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def attention_backward_reference(q, k, v, o, lse, do, sm_scale: float):
    """Plain version of the backward (Di pass and fused kernel), step by step:
    P rebuilt from the LSE in the log2 domain, Di = rowsum(dO o O), dV = P^T dO,
    dP = dO V^T, dS = P o (dP - Di) * sm_scale, dK = dS^T Q, dQ = dS K; P and
    dS rounded to q's dtype before their products, every sum fp32. Returns
    ``(dq, dk, dv)`` in the dtypes of q, k, v."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    di = _row_dot(do, o)[..., None]
    s = qf @ kf.transpose(-1, -2)
    p = torch.exp2(s * (sm_scale * _LOG2E) - lse.float()[..., None] * _LOG2E)
    dv = p.to(q.dtype).float().transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - di) * sm_scale
    ds_q = ds.to(q.dtype).float()
    dk = ds_q.transpose(-1, -2) @ qf
    dq = ds_q @ kf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_FNS: dict[str, object] = {}


def _kernel_fn(stem: str, name: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``name`` of ``csrc/<stem>.cu``, its ctypes signature set once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(load_library(stem), name)
        fn.argtypes, fn.restype = argtypes, restype
        _FNS[name] = fn
    return fn


def _fwd_lib(dtype):
    stem = KERNELS[dtype][0]
    if dtype == torch.float32:       # + the workspace pointer and the cluster size
        return _kernel_fn(stem, f"{stem}_fwd", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                          + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p])
    return _kernel_fn(stem, f"{stem}_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                      + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p])


def _bwd_lib(dtype):
    stem = KERNELS[dtype][1]
    ints = 5 if dtype == torch.float32 else 4     # fp32: + the cluster size
    return _kernel_fn(stem, stem, [ctypes.c_void_p] * 10 + [ctypes.c_int] * ints
                      + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p])


def bwd_workspace_bytes(bh: int, t: int, d: int, dtype=torch.bfloat16) -> int:
    """Device bytes the backward of ``dtype`` needs: bf16, the Di pass's
    output, the dQ turn counters and, with more than one 128-key tile, the
    fp32 sums of dQ; fp32, the TF32 hi and lo copies of Q, K, V and dO (and
    of Q and dO transposed), LSE * log2(e) and Di, the turn counters and the
    fp32 sums of dQ^T; above ``MAX_INSTANCE`` the band route's
    (``flash_band.band_plan``)."""
    if d > MAX_INSTANCE:
        return flash_band.band_plan(bh, t, d, dtype, True).workspace
    stem = KERNELS[dtype][1]
    return _kernel_fn(stem, f"{stem}_workspace", [ctypes.c_int] * 3, ctypes.c_size_t)(bh, t, d)


def fwd_workspace_bytes(bh: int, t: int, d: int) -> int:
    """Device bytes the fp32 forward needs: the TF32 hi and lo copies of Q
    and K, and of V transposed."""
    stem = KERNELS[torch.float32][0]
    return _kernel_fn(stem, f"{stem}_workspace", [ctypes.c_int] * 3, ctypes.c_size_t)(bh, t, d)


def fp32_columns(d: int) -> tuple[int, int]:
    """The head-dimension split of the fp32 kernels at head dim ``d`` (a
    multiple of 4 up to ``MAX_INSTANCE``): the columns a block of the
    instance that runs it (``head_dim_plan``: 32 at the Dh-32 instance,
    128 at ``FP32_WIDE_HEAD_DIMS``, else 64) and the thread-block cluster of
    instance / columns blocks (at most 8, the portable cluster size: Dh
    1024). The C side refuses any other cluster size."""
    run = head_dim_plan(d, torch.float32, True).instance
    cols = 32 if run == 32 else 128 if run in FP32_WIDE_HEAD_DIMS else 64
    return cols, run // cols


def fp32_plan(b: int, h: int, t: int, d: int) -> dict:
    """The fp32 kernels' launch plan for ``[B, H, T, Dh]`` (``d`` a multiple
    of 4 up to ``MAX_INSTANCE``): ``columns`` a block and the ``cluster``
    size (``fp32_columns``), the C entry points (``fwd``, ``bwd``) and the
    workspace bytes each asks for."""
    cols, cluster = fp32_columns(d)
    return {"columns": cols, "cluster": cluster,
            "fwd": _fwd_lib(torch.float32), "bwd": _bwd_lib(torch.float32),
            "fwd_workspace": fwd_workspace_bytes(b * h, t, d),
            "bwd_workspace": bwd_workspace_bytes(b * h, t, d, torch.float32)}


def check_strided(t: torch.Tensor, name: str) -> tuple[int, int, int]:
    """What the flash kernels take of a ``[B, H, T, Dh]`` tensor's layout:
    bf16 or fp32, the last dimension contiguous, every row on a 16-byte
    boundary (the base and the batch, head and token pitches; a TMA tensor
    map, or the fp32 kernels' 16-byte copies, carry any such strides).
    Returns the element strides ``(batch, head, token)``; a dimension of size
    1 is never stepped over, so it reports the row length."""
    if t.dim() != 4:
        raise ValueError(f"{name} must have 4 dims, got {tuple(t.shape)}")
    if t.dtype not in KERNELS:
        raise ValueError(f"{name} must be {torch.bfloat16} or {torch.float32}, got {t.dtype}")
    d = t.shape[-1]
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s last dimension must be contiguous, got stride "
                         f"{t.stride(-1)}")
    strides = tuple(t.stride(i) if t.shape[i] > 1 else d for i in range(3))
    per_row = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % per_row or s <= 0 for s in strides):
        raise ValueError(f"{name}'s rows must start on 16-byte boundaries: data_ptr "
                         f"{t.data_ptr():#x}, strides {tuple(t.stride())}")
    return strides


def _check_dtypes(named) -> torch.dtype:
    """The dtype that every tensor of ``named`` shares, one the kernels take."""
    dtype = named[0][1].dtype
    for name, x in named:
        if x.dtype != dtype:
            raise ValueError(f"{name} is {x.dtype}, {named[0][0]} {dtype}: the kernels take "
                             "one dtype")
    if dtype not in KERNELS:
        raise ValueError(f"the flash kernels take {torch.bfloat16} or {torch.float32}, got "
                         f"{dtype}")
    return dtype


def _check_launchable(named, strided: bool = True) -> list:
    """Each ``(name, tensor)`` on the first one's CUDA device, and (``strided``)
    the element strides of each (``check_strided``)."""
    strides = []
    for name, x in named:
        if not x.is_cuda or x.device != named[0][1].device:
            raise ValueError(f"{name} must be a CUDA tensor on q's device")
        if strided:
            strides += check_strided(x, name)
    return strides


def flash_attention_cuda(q, k, v, sm_scale: float, return_lse: bool = False, out=None):
    """Launch the forward kernel of q's dtype (bf16 or fp32, ``KERNELS``) on
    ``[B, H, T, Dh]`` CUDA tensors whose last dimension is contiguous (any
    16-byte-aligned batch, head and token strides), at any Dh
    (``head_dim_plan``; above ``MAX_INSTANCE`` the band route). ``out`` is where O is written, in
    any such layout (default: a new contiguous tensor); with ``return_lse``
    also returns the fp32 ``[B, H, T]`` LSE."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    b, h, t, d = q.shape
    if out is not None and out.shape != q.shape:
        raise ValueError(f"out must have q's shape {tuple(q.shape)}, got {tuple(out.shape)}")
    named = (("q", q), ("k", k), ("v", v)) + ((("out", out),) if out is not None else ())
    dtype = _check_dtypes(named)
    plan = head_dim_plan(d, dtype, backward=False)
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if plan.width != d:                 # rows not 16 bytes apart: zero-padded copies
        _check_launchable((("q", q), ("k", k), ("v", v), ("out", out)), strided=False)
        run = [_padded(x, plan.width) for x in (q, k, v)]
        run.append(torch.empty_like(run[0]))
    else:
        run = [q, k, v, out]
    strides = _check_launchable(tuple(zip(("q", "k", "v", "out"), run)))
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32) if return_lse else None
    stem = KERNELS[dtype][0]
    if plan.band:
        flash_band.forward_cuda(*run[:3], sm_scale, run[3], lse,
                                _named_strides(("q", "k", "v", "out"), strides))
    else:
        ptrs = tuple(x.data_ptr() for x in run) + (None if lse is None else lse.data_ptr(),)
        tail = ((ctypes.c_int64 * 12)(*strides), float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
        if dtype == torch.float32:
            fplan = fp32_plan(b, h, t, plan.width)
            ws = torch.empty(fplan["fwd_workspace"], device=q.device, dtype=torch.uint8)
            err = fplan["fwd"](*ptrs, ws.data_ptr(), b, h, t, plan.width, fplan["cluster"],
                               *tail)
        else:
            err = _fwd_lib(dtype)(*ptrs, b, h, t, plan.width, *tail)
        if err:
            raise RuntimeError(f"{stem} launch failed: cudaError {err}")
    if run[3] is not out:
        out.copy_(run[3][..., :d])
    _count(launch_counter(stem, d))
    return (out, lse) if return_lse else out


def _named_strides(names, strides) -> dict:
    """``_check_launchable``'s strides, three a tensor, by name."""
    return {n: tuple(strides[3 * i:3 * i + 3]) for i, n in enumerate(names)}


def _row_dot(do, o):
    """Di = rowsum(dO o O) in fp32, ``[B, H, T]``: the plain version of the
    backward's Di pass (jnp outside the stock kernels,
    flash_attention.py:273-275)."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_bwd_cuda(q, k, v, o, lse, do, sm_scale: float, workspace=None):
    """Launch the backward of q's dtype on the forward's inputs, its output
    ``o`` and LSE (fp32 ``[B, H, T]``, contiguous) and the output gradient
    ``do``, at any Dh (``head_dim_plan``). bf16
    (``csrc/flash_attention_bwd.cu``): a small pass computes Di = rowsum(do
    * o) on the card, then one fused kernel computes all three gradients.
    fp32 (``csrc/flash_attention_bwd_f32.cu``): a stats pass (LSE * log2(e),
    Di), a split pass (TF32 hi and lo copies), one fused kernel computing
    each of the five products once (the head dimension split across a
    cluster, ``fp32_plan``) and a pass that writes dQ. Above ``MAX_INSTANCE``
    the band route (``flash_band.backward_cuda``: a Di pass, a query sweep
    and a key sweep of tiled products).
    q, k, v, o and do are ``[B, H, T, Dh]`` CUDA tensors of one dtype in any
    layout ``check_strided`` takes.
    Returns contiguous ``(dq, dk, dv)``; ``LAUNCHES`` counts the call's
    launches once, under the backward's name (``KERNELS``, ``launch_counter``).
    ``workspace``, a uint8 CUDA tensor of at least
    ``bwd_workspace_bytes(B * H, T, Dh, dtype)`` bytes, is used instead of a
    new one when given; bf16: it starts with the Di pass's output, fp32
    ``[B * H, ceil(T / 64), 2, 64]``: LSE * log2(e) (+inf past T), then Di (0
    past T); fp32: the layout of ``flash_attention_bwd_f32_workspace``
    (csrc/flash_attention_bwd_f32.cu); the band route: ``flash_band.band_plan``'s
    layout, starting with LSE * log2(e) and Di, fp32 ``[B * H, T]`` each."""
    if not (q.shape == k.shape == v.shape == o.shape == do.shape):
        raise ValueError(f"q, k, v, o, do shapes differ: {q.shape}, {k.shape}, {v.shape}, "
                         f"{o.shape}, {do.shape}")
    b, h, t, d = q.shape
    names = ("q", "k", "v", "o", "do")
    named = tuple(zip(names, (q, k, v, o, do)))
    dtype = _check_dtypes(named)
    plan = head_dim_plan(d, dtype, backward=True)
    if plan.width != d:                 # rows not 16 bytes apart: zero-padded copies
        _check_launchable(named, strided=False)
        named = tuple((n, _padded(x, plan.width)) for n, x in named)
    strides = _check_launchable(named)
    check_cuda_tensor(lse, "lse", torch.float32, 3)
    if tuple(lse.shape) != (b, h, t) or lse.device != q.device:
        raise ValueError(f"lse must be [B, H, T] = {(b, h, t)} on q's device, got "
                         f"{tuple(lse.shape)}")
    stem = KERNELS[dtype][1]
    if plan.band:
        dq, dk, dv = flash_band.backward_cuda(*(x for _, x in named[:4]), lse, named[4][1],
                                              sm_scale, _named_strides(names, strides), workspace)
        return _unpadded(stem, d, dq, dk, dv)
    shape = (b, h, t, plan.width)
    dq, dk, dv = (torch.empty(shape, device=q.device, dtype=q.dtype) for _ in range(3))
    fplan = fp32_plan(b, h, t, plan.width) if dtype == torch.float32 else None
    nbytes = (fplan["bwd_workspace"] if fplan
              else bwd_workspace_bytes(b * h, t, plan.width, dtype))
    if workspace is None:
        workspace = torch.empty(nbytes, device=q.device, dtype=torch.uint8)
    elif (workspace.device != q.device or workspace.dtype != torch.uint8
          or workspace.numel() < nbytes or workspace.data_ptr() % 256):
        raise ValueError(f"workspace must be {nbytes} bytes (uint8) on q's device, "
                         "256-byte aligned")
    ptrs = tuple(x.data_ptr() for _, x in named[:5])
    ptrs = ptrs + (lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                   workspace.data_ptr())
    tail = ((ctypes.c_int64 * 15)(*strides), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if fplan:
        err = fplan["bwd"](*ptrs, b, h, t, plan.width, fplan["cluster"], *tail)
    else:
        err = _bwd_lib(dtype)(*ptrs, b, h, t, plan.width, *tail)
    if err:
        raise RuntimeError(f"{stem} launch failed: cudaError {err}")
    return _unpadded(stem, d, dq, dk, dv)


def _unpadded(stem: str, d: int, *grads) -> tuple:
    """Counts the backward's launch; the gradients cut to the head dimension."""
    _count(launch_counter(stem, d))
    if grads[0].shape[-1] != d:
        grads = tuple(x[..., :d].contiguous() for x in grads)
    return grads


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read its layout (``check_strided``),
    else a contiguous copy (an output gradient may arrive expanded, with
    stride 0, or with a non-contiguous last dimension)."""
    try:
        check_strided(t, "t")
    except ValueError:
        return t.contiguous()
    return t


class FlashAttentionFunction(torch.autograd.Function):
    """softmax(q k^T * sm_scale) v with the flash kernels on CUDA tensors and
    the plain versions on CPU tensors; saves q, k, v, the output and the LSE.
    On the card both kernels read q, k, v and the output gradient through
    their strides (views of a packed projection need no copy), and the
    output is laid out ``[B, T, H, Dh]``, as ``flash_attention`` lays it out
    without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float):
        if q.is_cuda:
            b, h, t, d = q.shape
            q, k, v = _readable(q), _readable(k), _readable(v)
            out = torch.empty((b, t, h, d), device=q.device, dtype=q.dtype).permute(0, 2, 1, 3)
            out, lse = flash_attention_cuda(q, k, v, sm_scale, return_lse=True, out=out)
        elif q.shape[-1] > MAX_INSTANCE:
            out, lse = flash_band.forward_plain(q, k, v, sm_scale, return_lse=True)
        else:
            out, lse = attention_reference(q, k, v, sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, _readable(do), ctx.sm_scale)
        elif q.shape[-1] > MAX_INSTANCE:
            dq, dk, dv = flash_band.backward_plain(q, k, v, out, lse, do, ctx.sm_scale)
        else:
            dq, dk, dv = attention_backward_reference(q, k, v, out, lse, do, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, sm_scale: float):
    """softmax(q k^T * sm_scale) v over ``[B, H, T, Dh]``; differentiable
    through ``FlashAttentionFunction`` whenever an input requires grad.
    q, k and v may be strided views (see ``check_strided``), and on a CUDA
    tensor the result is laid out ``[B, T, H, Dh]`` in memory, so that
    merging the heads behind it (``out.transpose(1, 2).reshape(B, T, H *
    Dh)``) is a view."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, float(sm_scale))
    if q.is_cuda:
        b, h, t, d = q.shape
        out = torch.empty((b, t, h, d), device=q.device, dtype=q.dtype).permute(0, 2, 1, 3)
        return flash_attention_cuda(q, k, v, sm_scale, out=out)
    if q.shape[-1] > MAX_INSTANCE:
        return flash_band.forward_plain(q, k, v, sm_scale)
    return attention_reference(q, k, v, sm_scale)


def sdpa(q, k, v, scale, *, impl: str = "exact", q_chunk: int = 256):
    """Dispatch by implementation name; ``scale`` is the reference's
    per-operand ``dh ** -0.25`` (the kernel takes its square)."""
    if impl not in ("exact", "chunked", "flash", "auto"):
        raise ValueError(f"unknown attn impl {impl!r}")
    if q.is_cuda or impl == "flash":
        return flash_attention(q, k, v, float(scale) ** 2)
    if impl == "exact":
        return _exact(q, k, v, scale)
    return chunked_sdpa(q, k, v, scale, q_chunk=q_chunk)
