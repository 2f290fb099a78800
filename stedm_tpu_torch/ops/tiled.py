"""Tiled application over canvases larger than a training patch, with
weighted stitching (stedm_tpu/ops/tiled.py).

Overlapping tiles cover the canvas, the last one flush right; each tile's
output is weighted by a triangle window and accumulated, and the sum is
divided by the accumulated weights. ``scale`` covers functions that change
the resolution (the VQ decode of latent tiles: 4).

Tiles run one after another in row-major order, as the JAX scan runs them,
so the accumulation adds the tiles in the same order and the stitching
itself costs no tolerance against it. Each tile is one call of ``fn`` at the
batch of the canvas.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _positions(size: int, patch: int, stride: int) -> np.ndarray:
    """Tile start offsets covering [0, size) with a final flush-right tile."""
    if size <= patch:
        return np.array([0])
    pos = list(range(0, size - patch + 1, stride))
    if pos[-1] != size - patch:
        pos.append(size - patch)
    return np.array(pos)


def _weight_window(patch: int, device=None) -> torch.Tensor:
    """The triangle blending window over a tile (the reference's 'weighting',
    ddpm.py:604-633), normalised to a peak of 1. Computed on ``device`` in
    float64, the JAX function's numpy arithmetic, then cast to fp32: device
    ops only, so a CUDA graph can capture it."""
    ramp = (torch.arange(patch, dtype=torch.float64, device=device) + 0.5) / patch
    w1 = torch.minimum(ramp, 1.0 - ramp) + 0.5 / patch
    w = torch.outer(w1, w1)
    return (w / w.max()).float()


def tile_grid(h: int, w: int, patch: int, stride: int) -> list[tuple[int, int]]:
    """The (y, x) starts of the tiles, row-major."""
    return [(int(y), int(x)) for y in _positions(h, patch, stride)
            for x in _positions(w, patch, stride)]


def tiled_apply(fn: Callable, x: torch.Tensor, patch: int, stride: int, *,
                out_channels: int | None = None, scale: int = 1) -> torch.Tensor:
    """Apply ``fn`` (NHWC ``[B, patch, patch, C]`` -> ``[B, patch*scale,
    patch*scale, C']``) over overlapping tiles of ``x`` and blend; fp32."""
    b, h, w, c = x.shape
    out_c = out_channels or c
    ps = patch * scale
    weight = _weight_window(ps, x.device)[None, :, :, None]
    acc = torch.zeros((b, h * scale, w * scale, out_c), dtype=torch.float32, device=x.device)
    norm = torch.zeros((1, h * scale, w * scale, 1), dtype=torch.float32, device=x.device)
    for y0, x0 in tile_grid(h, w, patch, stride):
        out = fn(x[:, y0:y0 + patch, x0:x0 + patch]).float() * weight
        ys, xs = slice(y0 * scale, y0 * scale + ps), slice(x0 * scale, x0 * scale + ps)
        acc[:, ys, xs] += out
        norm[:, ys, xs] += weight
    return acc / torch.clamp(norm, min=1e-8)
