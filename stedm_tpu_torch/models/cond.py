"""Layout-conditioning encoder (stedm_tpu/models/cond.py:21-48)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stedm_tpu_torch.models.layers import channels_last, conv1x1


class SpatialRescaler(nn.Module):
    """``n_stages`` of bilinear 0.5x downsampling, then an optional bias-free
    1x1 channel mapper. Torch's bilinear 0.5x (align_corners=False, no
    antialias) samples exactly between pixel pairs, i.e. 2x2 average pooling,
    in fp32. Takes and returns NHWC.

    ``in_channels`` is the width of the one-hot layout it is fed: flax's
    ``nn.Conv`` takes the mapper's width from the layout it is initialised
    on (stedm_tpu/models/cond.py:45-47) and never reads the config's
    ``in_channels``; torch has to be told it."""

    def __init__(self, n_stages: int = 2, method: str = "bilinear",
                 multiplier: float = 0.5, in_channels: int = 2,
                 out_channels: int | None = 3, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if method != "bilinear" or multiplier != 0.5:
            raise NotImplementedError("only the shipped bilinear 0.5x rescaler is "
                                      "ported")
        self.n_stages, self.dtype = n_stages, dtype
        self.channel_mapper = (conv1x1(in_channels, out_channels, bias=bias)
                               if out_channels is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = channels_last(x.permute(0, 3, 1, 2).float())
        for _ in range(self.n_stages):
            x = F.avg_pool2d(x, 2)
        x = x.to(self.dtype)
        if self.channel_mapper is not None:
            x = self.channel_mapper(x)
        return x.permute(0, 2, 3, 1)
