"""The U-Net bottleneck self-attention (stedm_tpu/models/attention.py:34-72)."""

from __future__ import annotations

import torch
from torch import nn

from stedm_tpu_torch.models.layers import GNSiLU, TokenConv1d
from stedm_tpu_torch.ops.blocked_attention import sdpa


class AttentionBlock(nn.Module):
    """Legacy-layout QKV self-attention over flattened spatial positions.

    The qkv output channels are head-major with ``[q|k|v]`` per head, as the
    reference's ``reshape(bs*heads, 3*dh, T).split(dh)``; q and k are each
    scaled by ``dh ** -0.25``. ``qkv`` and ``proj_out`` keep the reference's
    conv1d ``[out, in, 1]`` weights; ``proj_out`` starts at zero."""

    def __init__(self, channels: int, num_heads: int = 8, attn_impl: str = "exact"):
        super().__init__()
        self.num_heads, self.attn_impl = num_heads, attn_impl
        self.norm = GNSiLU(channels, apply_silu=False)
        self.qkv = TokenConv1d(channels, 3 * channels)
        self.proj_out = TokenConv1d(channels, channels)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        heads = self.num_heads
        dh = c // heads
        xs = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        # q, k, v as [B, heads, T, dh] views of the packed projection: the
        # forward kernel reads them in place, and its output comes back laid
        # out [B, T, heads, dh], so merging the heads below is a view too
        qkv = self.qkv(xs).reshape(b, h * w, heads, 3, dh).permute(0, 2, 3, 1, 4)
        q, k, v = qkv.unbind(2)
        out = sdpa(q, k, v, float(dh) ** -0.25, impl=self.attn_impl)
        out = self.proj_out(out.transpose(1, 2).reshape(b, h * w, c))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)
