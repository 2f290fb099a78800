"""Shared building blocks (NCHW-logical tensors in channels_last memory).

Precision policy, as in stedm_tpu/models/layers.py: parameters live in fp32;
layers compute in the dtype of the activations that reach them (the model
casts its input to the compute dtype once), casting their weights to it;
GroupNorm statistics are always fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from stedm_tpu_torch.ops.gn_silu import gn_silu
from stedm_tpu_torch.parallel import dist


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """x in channels_last memory format (no copy when it already is)."""
    return x.contiguous(memory_format=torch.channels_last)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, cos first (stedm_tpu layers.py:20-30)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _cast(p: torch.Tensor | None, dtype) -> torch.Tensor | None:
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    """Conv2d computing in its input's dtype from fp32 parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Linear(nn.Linear):
    """Linear computing in its input's dtype from fp32 parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class TokenConv1d(nn.Conv1d):
    """A kernel-1 Conv1d (the reference's attention qkv/proj layout,
    ``[out, in, 1]``) applied as a Linear over ``[B, T, C]`` tokens."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0].to(x.dtype), _cast(self.bias, x.dtype))


def conv3x3(cin: int, cout: int, stride: int = 1, zero_init: bool = False) -> Conv2d:
    conv = Conv2d(cin, cout, 3, stride=stride, padding=1)
    if zero_init:
        nn.init.zeros_(conv.weight)
        nn.init.zeros_(conv.bias)
    return conv


def conv1x1(cin: int, cout: int, bias: bool = True) -> Conv2d:
    return Conv2d(cin, cout, 1, bias=bias)


class GNSiLU(nn.Module):
    """GroupNorm(+embedding add | +FiLM)(+SiLU) (stedm_tpu layers.py:63-102)
    through ``ops.gn_silu``; parameters are torch GroupNorm's ``weight`` and
    ``bias``; ``add``, ``film_scale`` and ``film_shift`` are ``[B, C]``."""

    def __init__(self, channels: int, eps: float = 1e-5, apply_silu: bool = True):
        super().__init__()
        self.eps, self.apply_silu = eps, apply_silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, add: torch.Tensor | None = None,
                film_scale: torch.Tensor | None = None,
                film_shift: torch.Tensor | None = None) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1).contiguous()      # a view for channels_last x
        vec = lambda v: None if v is None else v.contiguous()
        y = gn_silu(xh, self.weight, self.bias, add=vec(add), film_scale=vec(film_scale),
                    film_shift=vec(film_shift), eps=self.eps, apply_silu=self.apply_silu)
        return y.permute(0, 3, 1, 2)


def dropout_mask(shape, rate: float, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """Flax ``nn.Dropout``'s keep mask (probability ``1 - rate``), drawn from
    ``generator``; across ranks, this rank's rows of the global batch's mask
    (the leading axis is the batch)."""
    if generator is None:
        raise ValueError("dropout in train mode needs the step's generator")
    return dist.rank_rows(torch.rand, shape, generator=generator, device=device) < 1.0 - rate


def apply_dropout(x: torch.Tensor, mask: torch.Tensor, rate: float) -> torch.Tensor:
    """The kept values scaled by ``1 / (1 - rate)``, the others 0."""
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Flax's ``nn.Dropout``: keep with probability ``1 - rate``, scaled by
    ``1 / (1 - rate)``; identity outside training or at rate 0."""
    if not train or rate <= 0:
        return x
    return apply_dropout(x, dropout_mask(x.shape, rate, generator, x.device), rate)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return channels_last(F.interpolate(x, scale_factor=2, mode="nearest"))


class Upsample(nn.Module):
    """Nearest 2x upsample + 3x3 conv, or the upsample alone at
    ``use_conv=False`` (reference openaimodel.py:104-132; stedm_tpu
    layers.py:127-139)."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        self.conv = conv3x3(channels, channels) if use_conv else None

    def forward(self, x):
        x = upsample_nearest_2x(x)
        return x if self.conv is None else self.conv(x)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2 (flax ``nn.avg_pool(x, (2, 2), strides=(2, 2))``)."""
    return channels_last(F.avg_pool2d(x, 2, 2))


class Downsample(nn.Module):
    """Stride-2 3x3 conv downsample, or a 2x2 average pool at
    ``use_conv=False`` (reference openaimodel.py:147-173; stedm_tpu
    layers.py:142-155)."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        self.op = conv3x3(channels, channels, stride=2) if use_conv else None

    def forward(self, x):
        return avg_pool_2x(x) if self.op is None else self.op(x)
