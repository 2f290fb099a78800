"""Scaled dot-product attention over ``[B, H, T, Dh]``: flash kernels and plain versions.

``flash_attention`` launches the CUDA forward kernel in
``csrc/flash_attention.cu`` (the port of the stock Pallas TPU flash-attention
forward that stedm_tpu/ops/blocked_attention.py:flash_sdpa and
models/vq.py:AttnBlockVQ call) on CUDA tensors, and ``attention_reference``
on CPU tensors. The forward reads q, k and v through their strides (any
16-byte-aligned batch, head and token pitch, last dimension contiguous) and
writes O in any such layout. When a gradient is wanted it goes through
``FlashAttentionFunction``, whose backward launches the two kernels of
``csrc/flash_attention_bwd.cu`` (the ports of the stock kernel's ``dkv`` and
``dq`` Pallas kernels, flash_attention.py:941 and :1287) on CUDA tensors and
``attention_backward_reference`` on CPU tensors. The backward takes head
dimensions 64 and 128; the VQ attention (Dh 512) runs only without gradient.

``sdpa`` keeps the JAX dispatch by name. ``exact``, ``chunked``, ``flash`` and
``auto`` name TPU memory strategies for one function, so on a CUDA tensor all
four launch the kernel; on the CPU ``exact`` and ``chunked`` run their plain
versions (``_exact`` / ``chunked_sdpa``, stedm_tpu/ops/blocked_attention.py
:73-84 and :50-70) under autograd, ``flash`` the wrapper's plain versions and
``auto`` resolves to ``chunked``. The kernels' only gate is the head dimension.
"""

from __future__ import annotations

import ctypes
import math

import torch

from stedm_tpu_torch._device import check_cuda_tensor, load_library
from stedm_tpu_torch.ops import LAUNCHES

MAX_HEAD_DIM = 512
BWD_HEAD_DIMS = (64, 128)
_LOG2E = 1.0 / math.log(2.0)


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
    """Plain version of the two backward kernels, step by step: P rebuilt from
    the LSE in the log2 domain, Di = rowsum(dO o O), dV = P^T dO,
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


def _kernel_fn(stem: str, name: str, argtypes):
    """The C entry point ``name`` of ``csrc/<stem>.cu``, its ctypes signature set once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(load_library(stem), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[name] = fn
    return fn


def _fwd_lib():
    return _kernel_fn("flash_attention", "flash_attention_fwd",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                      + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p])


def _bwd_lib(name: str, n_ptrs: int):
    return _kernel_fn("flash_attention_bwd", name,
                      [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3
                      + [ctypes.c_float, ctypes.c_void_p])


def _check_qkv(q, k, v):
    """The backward kernels' demands: contiguous bf16 CUDA tensors of one shape."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(t, name, torch.bfloat16, 4)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (cp.async)")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v shapes differ: {q.shape}, {k.shape}, {v.shape}")


def check_strided(t: torch.Tensor, name: str) -> tuple[int, int, int]:
    """What the forward kernel takes of a ``[B, H, T, Dh]`` tensor's layout:
    the last dimension contiguous, every row on a 16-byte boundary (the base
    and the batch, head and token pitches; a TMA tensor map carries any such
    strides). Returns the element strides ``(batch, head, token)``; a
    dimension of size 1 is never stepped over, so it reports the row length."""
    if t.dim() != 4:
        raise ValueError(f"{name} must have 4 dims, got {tuple(t.shape)}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be {torch.bfloat16}, got {t.dtype}")
    d = t.shape[-1]
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s last dimension must be contiguous, got stride "
                         f"{t.stride(-1)}")
    strides = tuple(t.stride(i) if t.shape[i] > 1 else d for i in range(3))
    if t.data_ptr() % 16 or any(s % 8 or s <= 0 for s in strides):
        raise ValueError(f"{name}'s rows must start on 16-byte boundaries: data_ptr "
                         f"{t.data_ptr():#x}, strides {tuple(t.stride())}")
    return strides


def flash_attention_cuda(q, k, v, sm_scale: float, return_lse: bool = False, out=None):
    """Launch the forward kernel on bf16 ``[B, H, T, Dh]`` CUDA tensors whose
    last dimension is contiguous (any 16-byte-aligned batch, head and token
    strides). ``out`` is where O is written, in any such layout (default: a
    new contiguous tensor); with ``return_lse`` also returns the fp32
    ``[B, H, T]`` LSE."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    b, h, t, d = q.shape
    if d % 64 or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of 64 and at most "
                         f"{MAX_HEAD_DIM}")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    elif out.shape != q.shape:
        raise ValueError(f"out must have q's shape {tuple(q.shape)}, got {tuple(out.shape)}")
    strides = []
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on q's device")
        strides += check_strided(x, name)
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32) if return_lse else None
    err = _fwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(), b, h, t, d,
                     (ctypes.c_int64 * 12)(*strides), float(sm_scale),
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def _row_dot(do, o):
    """Di = rowsum(dO o O) in fp32, ``[B, H, T]``; computed outside the stock
    kernels too (flash_attention.py:273-275)."""
    return (do.float() * o.float()).sum(-1)


def _check_bwd(q, k, v, lse, do, di):
    _check_qkv(q, k, v)
    check_cuda_tensor(do, "do", torch.bfloat16, 4)
    if do.shape != q.shape or do.data_ptr() % 16:
        raise ValueError(f"do must be q's shape {tuple(q.shape)} on a 16-byte boundary")
    b, h, t, d = q.shape
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"the flash-attention backward kernels take head dims "
                         f"{BWD_HEAD_DIMS}, got {d} (Dh 512 comes with codec "
                         "fine-tuning)")
    for name, r in (("lse", lse), ("di", di)):
        check_cuda_tensor(r, name, torch.float32, 3)
        if tuple(r.shape) != (b, h, t):
            raise ValueError(f"{name} must be [B, H, T] = {(b, h, t)}, got {tuple(r.shape)}")
    return b, h, t, d


def flash_attention_bwd_dkv_cuda(q, k, v, lse, do, di, sm_scale: float):
    """Launch the dkv kernel on the forward's inputs, its LSE, the output
    gradient ``do`` and ``di`` = rowsum(do * o) (fp32 ``[B, H, T]``);
    returns ``(dk, dv)``."""
    b, h, t, d = _check_bwd(q, k, v, lse, do, di)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _bwd_lib("flash_attention_bwd_dkv", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, t, d, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: cudaError {err}")
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd_dq_cuda(q, k, v, lse, do, di, sm_scale: float):
    """Launch the dq kernel on the same inputs; returns ``dq``."""
    b, h, t, d = _check_bwd(q, k, v, lse, do, di)
    dq = torch.empty_like(q)
    err = _bwd_lib("flash_attention_bwd_dq", 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), b * h, t, d, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: cudaError {err}")
    LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq


def flash_attention_bwd_cuda(q, k, v, o, lse, do, sm_scale: float):
    """Both backward kernels on one Di; returns ``(dq, dk, dv)``."""
    di = _row_dot(do, o)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, lse, do, di, sm_scale)
    return flash_attention_bwd_dq_cuda(q, k, v, lse, do, di, sm_scale), dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """softmax(q k^T * sm_scale) v with the flash kernels on CUDA tensors and
    the plain versions on CPU tensors; saves q, k, v, the output and the LSE.
    q, k and v are made contiguous first: the backward kernels take nothing
    else."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        fwd = flash_attention_cuda if q.is_cuda else attention_reference
        out, lse = fwd(q, k, v, sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_cuda if q.is_cuda else attention_backward_reference
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, sm_scale: float):
    """softmax(q k^T * sm_scale) v over ``[B, H, T, Dh]``; differentiable
    through ``FlashAttentionFunction`` whenever an input requires grad.
    Without a gradient, q, k and v may be strided views (see
    ``check_strided``), and on a CUDA tensor the result is laid out
    ``[B, T, H, Dh]`` in memory, so that merging the heads behind it
    (``out.transpose(1, 2).reshape(B, T, H * Dh)``) is a view."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, float(sm_scale))
    if q.is_cuda:
        b, h, t, d = q.shape
        out = torch.empty((b, t, h, d), device=q.device, dtype=q.dtype).permute(0, 2, 1, 3)
        return flash_attention_cuda(q, k, v, sm_scale, out=out)
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
