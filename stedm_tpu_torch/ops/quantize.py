"""Nearest-codebook-entry search for the VQ decode path.

``nearest_code`` launches the CUDA kernel in ``csrc/nearest_code.cu`` (the
port of stedm_tpu/ops/quantize.py:_nearest_code_pallas) on CUDA tensors and
the plain version on CPU tensors, at any embedding width and codebook size:
a 3-wide codebook whose cluster slice fits a CTA's shared memory takes the
kernel that holds it there (the shipped 3 x 8192), every other one the
kernel that streams a packed codebook in chunks (``_launch_plan``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from stedm_tpu_torch._device import (ONE_PER_SM, SMEM_LIMIT, check_cuda_tensor, load_library,
                                     max_active_clusters)
from stedm_tpu_torch.ops import LAUNCHES


def nearest_code_reference(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain version (materialises [N, n_embed]); stedm_tpu's
    ``nearest_code_reference`` (quantize.py:90-96). Ties go to the lowest
    index (``torch.argmin`` returns the first minimum)."""
    z = z_flat.float()
    cb = codebook.float()
    d = ((z ** 2).sum(dim=1, keepdim=True) + (cb ** 2).sum(dim=1)[None, :]
         - 2.0 * z @ cb.T)
    return torch.argmin(d, dim=1).to(torch.int32)


_TILE = 512               # tokens a CTA (csrc/nearest_code.cu, TILE)
_SPLITS = (1, 2, 4, 8)    # CTAs of a cluster sharing a tile: portable sizes
# clusters of 1, 2, 4 and 8 CTAs an H100 holds at once, one CTA an SM (132
# SMs; cudaOccupancyMaxActiveClusters, tools/torch_nearest_code_variants.py),
# for the CPU tests; the wrapper asks the device (_device.max_active_clusters)
_H100_ACTIVE = (132, 66, 30, 15)
_CHUNK_FLOATS = 8192      # a streaming buffer: 32 KB of packed codes (CHUNK_FLOATS)


def packed_width(width: int) -> int:
    """Floats a packed code takes in the streaming kernel: its ``width``
    coordinates and ||c||^2, padded to 4 (width <= 3) or a multiple of 8."""
    return 4 if width <= 3 else -(-(width + 1) // 8) * 8


@functools.lru_cache(maxsize=None)
def _launch_plan(n: int, n_embed: int, width: int = 3, active: tuple = _H100_ACTIVE) -> dict:
    """Which kernel runs and how the codebook is split across a cluster;
    pure arithmetic so the CPU tests reach it, and it takes every ``n``,
    ``n_embed`` and ``width`` >= 1. ``active``: the clusters of each size in
    ``_SPLITS`` the device holds at once. The split is the largest whose
    clusters, one a tile of tokens, all run at once (so the grid is one wave
    that fills the SMs); at least 1.

    ``kernel == "resident"`` (width 3, when the slice fits): rank r of a
    cluster takes codes [r * codes_per_cta, (r + 1) * codes_per_cta) (code
    order), packed in shared memory as float4 (c0, c1, c2, ||c||^2) at
    offset 0; the scratch behind it holds the slice as it lies, then the
    CTA's (min, argmin) a token; the bulk copy's mbarrier comes last.

    ``kernel == "stream"`` (any other width, or a slice too large): the
    codebook is packed at ``w`` floats a code (``packed_width``) into
    ``n_chunks`` chunks of ``chunk`` codes; rank r takes chunks [r *
    chunks_per_cta, ...) and streams them through two buffers at offset 0;
    the CTA's (min, argmin) a token at ``res_off``, two mbarriers at
    ``bar_off``. Its shared memory is held at one CTA an SM, as the resident
    kernel's, so ``active`` counts its clusters too."""
    tiles = -(-n // _TILE)
    top = max([s for s, a in zip(_SPLITS, active) if tiles <= a] or [1])
    if width == 3:
        split = top
        while split > 1 and -(-n_embed // split) < 4:
            split //= 2
        codes_per_cta = -(-(-(-n_embed // split)) // 4) * 4   # a multiple of 4: 48-byte copies
        scratch_off = 16 * codes_per_cta
        bar_off = scratch_off + max(12 * codes_per_cta, 8 * _TILE)
        if bar_off + 16 <= SMEM_LIMIT:
            return dict(kernel="resident", split=split, codes_per_cta=codes_per_cta,
                        tiles=tiles, scratch_off=scratch_off, bar_off=bar_off,
                        smem=max(bar_off + 16, ONE_PER_SM))
    w = packed_width(width)
    chunk = _CHUNK_FLOATS // w
    n_chunks = -(-n_embed // chunk)
    split = top
    while split > n_chunks:
        split //= 2
    res_off = 2 * chunk * w * 4
    bar_off = res_off + 8 * _TILE
    return dict(kernel="stream", split=split, tiles=tiles, w=w, chunk=chunk, n_chunks=n_chunks,
                chunks_per_cta=-(-n_chunks // split), res_off=res_off, bar_off=bar_off,
                smem=max(bar_off + 16, ONE_PER_SM))


def _device_active(index: int) -> tuple:
    """``_H100_ACTIVE`` as device ``index`` reports it."""
    return max_active_clusters("nearest_code", _SPLITS, ONE_PER_SM, index)


@functools.lru_cache(maxsize=None)
def _lib():
    fn = load_library("nearest_code").nearest_code_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _stream_lib():
    fn = load_library("nearest_code").nearest_code_stream_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nearest_code_cuda(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Launch a kernel (``_launch_plan``): z ``[N, E]`` fp32, codebook
    ``[n_embed, E]`` fp32, any E >= 1 and any n_embed."""
    check_cuda_tensor(z_flat, "z_flat", torch.float32, 2)
    check_cuda_tensor(codebook, "codebook", torch.float32, 2)
    width = codebook.shape[1]
    if z_flat.shape[1] != width or width < 1 or codebook.shape[0] < 1:
        raise ValueError(f"z_flat {tuple(z_flat.shape)} and codebook {tuple(codebook.shape)} "
                         "must share a width >= 1, with at least one code")
    if codebook.device != z_flat.device:
        raise ValueError("codebook and z_flat must share a device")
    n, n_embed = z_flat.shape[0], codebook.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=z_flat.device)
    if n == 0:
        return out
    p = _launch_plan(n, n_embed, width, _device_active(z_flat.device.index or 0))
    stream = torch.cuda.current_stream(z_flat.device).cuda_stream
    if p["kernel"] == "resident":
        if codebook.data_ptr() % 16:
            raise ValueError("the codebook must be 16-byte aligned (its bulk copy)")
        err = _lib()(z_flat.data_ptr(), codebook.data_ptr(), out.data_ptr(), n, n_embed,
                     p["split"], p["codes_per_cta"], p["scratch_off"], p["bar_off"], p["smem"],
                     stream)
        name = "nearest_code"
    else:
        packed = torch.empty(p["n_chunks"] * p["chunk"] * p["w"], dtype=torch.float32,
                             device=z_flat.device)
        err = _stream_lib()(z_flat.data_ptr(), codebook.data_ptr(), packed.data_ptr(),
                            out.data_ptr(), n, n_embed, width, p["w"], p["chunk"],
                            p["n_chunks"], p["split"], p["chunks_per_cta"], p["res_off"],
                            p["bar_off"], p["smem"], stream)
        name = "nearest_code_stream"
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out


def nearest_code(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codebook row for each token; ``[N]`` int32."""
    if z_flat.is_cuda:
        return nearest_code_cuda(z_flat, codebook)
    return nearest_code_reference(z_flat, codebook)
