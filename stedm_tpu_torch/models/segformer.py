"""Segmentation network: SegFormer MiT-B2 encoder + U-Net decoder
(stedm_tpu/models/segformer.py).

``SegUNet`` takes NHWC images and returns NHWC per-pixel class logits at
the input's resolution, in the input's dtype, as the JAX module does.
Inside, feature maps are NCHW-logical tensors in channels_last memory and
the transformer works on ``[B, h*w, C]`` tokens in row-major order (the
JAX module's NHWC reshape), so moving between the two is a view.

Module names follow the JAX parameter tree (``encoder.patch_embed_0``,
``encoder.stage0_block0.attn.k``, ``decoder_0.bn1``, ``seg_head``); k and
v are separate Linears as in the JAX module, so the weight bridge is a
layout change only, and the MiT-B2 importer splits the published fused
``attn.kv`` (utils/weights.py).

Numerics of the JAX module, where flax and torch defaults differ:

* LayerNorm: eps 1e-6, two-pass variance, computed in fp32 and cast back
  to the compute dtype;
* attention logits: products of the compute-dtype q and k summed in fp32
  with an fp32 result (``preferred_element_type``), scaled by dh^-0.5, an
  fp32 softmax cast to the compute dtype before ``P V``;
* BatchNorm (``BatchNorm``): flax's momentum 0.99 and eps 1e-5; in train
  mode the batch statistics (variance E[x^2] - E[x]^2, flax's fast form)
  normalise, with gradients through them, and the running statistics move
  to ``0.99 old + 0.01 batch`` with the batch's biased variance; in eval
  mode the running statistics normalise; fp32 throughout;
* padding: flax's SAME (none for the spatial-reduction conv, whose kernel
  is its stride; 1 for the 3x3 convs), the patch embeds' explicit 3 and 1;
  decoder convs have no bias; GELU is exact (erf); the decoder upsamples
  by nearest repetition.

Parameters live in fp32 and layers compute in the dtype of the
activations (``dtype``, bf16 or fp32); initialisation draws from flax's
distributions (lecun-normal kernels, zero biases, unit norm scales).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stedm_tpu_torch.models.layers import Conv2d, Linear, channels_last

LN_EPS, BN_EPS, BN_MOMENTUM = 1e-6, 1e-5, 0.99


def _lecun_normal_(weight: torch.Tensor, fan_in: int) -> None:
    """flax's ``lecun_normal``: a normal truncated at two deviations, scaled
    so that its variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std)


def _dense(n_in: int, n_out: int) -> Linear:
    layer = Linear(n_in, n_out)
    _lecun_normal_(layer.weight, n_in)
    nn.init.zeros_(layer.bias)
    return layer


def _conv(n_in: int, n_out: int, k: int, stride: int = 1, padding: int = 0,
          groups: int = 1, bias: bool = True) -> Conv2d:
    layer = Conv2d(n_in, n_out, k, stride, padding, groups=groups, bias=bias)
    _lecun_normal_(layer.weight, k * k * n_in // groups)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(use_fast_variance=False, dtype=float32)``: fp32
    statistics and output, returned in the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(dtype=float32)`` over the channels of an NCHW map;
    fp32 output. See the module docstring for its statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.momentum = BN_MOMENTUM

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean((0, 2, 3))
            var = torch.clamp(x.square().mean((0, 2, 3)) - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]


def _to_map(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``[B, h*w, C]`` tokens -> an NCHW-logical channels_last map (a view)."""
    b, _, c = t.shape
    return t.reshape(b, h, w, c).permute(0, 3, 1, 2)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    """An NCHW-logical map -> ``[B, h*w, C]`` tokens (a view when channels_last)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


class EfficientAttention(nn.Module):
    """Self-attention with spatial reduction of K/V (SegFormer eq. 2)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = _dense(dim, dim)
        if sr_ratio > 1:
            self.sr = _conv(dim, dim, sr_ratio, sr_ratio)
            self.sr_norm = LayerNorm(dim)
        self.k = _dense(dim, dim)
        self.v = _dense(dim, dim)
        self.proj = _dense(dim, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        heads = self.num_heads
        dh = c // heads
        q = self.q(x)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.sr_norm(_to_tokens(self.sr(_to_map(x, h, w))))
        k, v = self.k(kv_in), self.v(kv_in)

        def split(a):
            return a.reshape(b, -1, heads, dh).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        # products of the compute-dtype values, summed and returned in fp32
        logits = (q.float() @ k.float().transpose(-1, -2)) * (dh ** -0.5)
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        out = (weights @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class MixFFN(nn.Module):
    """fc1 -> 3x3 depthwise conv -> exact GELU -> fc2 (SegFormer eq. 3)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = _dense(dim, hidden)
        self.dwconv = _conv(hidden, hidden, 3, 1, 1, groups=hidden)
        self.fc2 = _dense(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        y = _to_tokens(self.dwconv(_to_map(self.fc1(x), h, w)))
        return self.fc2(F.gelu(y))


class MiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim)
        self.ffn = MixFFN(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.ffn(self.norm2(x), h, w)


class MiTEncoder(nn.Module):
    """Mix-Transformer encoder; returns the 4 stage feature maps (strides
    4..32) as NCHW-logical channels_last maps in the input's dtype."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 depths: Sequence[int] = (3, 4, 6, 3), num_heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1), in_channels: int = 3):
        super().__init__()
        self.depths = tuple(depths)
        ch = in_channels
        for s, (dim, depth, heads, sr) in enumerate(zip(embed_dims, depths, num_heads,
                                                        sr_ratios)):
            embed = _conv(ch, dim, 7, 4, 3) if s == 0 else _conv(ch, dim, 3, 2, 1)
            self.add_module(f"patch_embed_{s}", embed)
            self.add_module(f"embed_norm_{s}", LayerNorm(dim))
            for i in range(depth):
                self.add_module(f"stage{s}_block{i}", MiTBlock(dim, heads, sr))
            self.add_module(f"stage_norm_{s}", LayerNorm(dim))
            ch = dim

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for s, depth in enumerate(self.depths):
            x = getattr(self, f"patch_embed_{s}")(x)
            h, w = x.shape[2:]
            t = getattr(self, f"embed_norm_{s}")(_to_tokens(x))
            for i in range(depth):
                t = getattr(self, f"stage{s}_block{i}")(t, h, w)
            x = _to_map(getattr(self, f"stage_norm_{s}")(t), h, w)
            feats.append(x)
        return feats


class DecoderBlock(nn.Module):
    """Upsample 2x, concat skip, two conv-BN-ReLU (smp UnetDecoder block)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = _conv(in_channels, out_channels, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm(out_channels)
        self.conv2 = _conv(out_channels, out_channels, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        x = channels_last(x)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = torch.relu(bn(conv(x)).to(x.dtype))
        return x


class SegUNet(nn.Module):
    """MiT-B2 encoder + U-Net decoder -> per-pixel class logits at input res.

    ``encoder_config`` overrides the encoder's ``embed_dims`` / ``depths`` /
    ``num_heads`` / ``sr_ratios`` for tiny variants (the decoder takes all
    four stages); None keeps MiT-B2 (reference modules/segmentation.py:39-42).
    ``forward(x, train=None)``: ``train`` sets the module's mode first (the
    JAX module's ``train`` argument); None keeps the current mode."""

    def __init__(self, classes: int = 2,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 dtype: torch.dtype = torch.float32, encoder_config: dict | None = None):
        super().__init__()
        self.dtype = dtype
        self.encoder = MiTEncoder(**(encoder_config or {}))
        dims = list((encoder_config or {}).get("embed_dims", (64, 128, 320, 512)))
        skips = [dims[2], dims[1], dims[0], 0, 0]
        ch = dims[3]
        for i, (skip, out) in enumerate(zip(skips, decoder_channels)):
            self.add_module(f"decoder_{i}", DecoderBlock(ch + skip, out))
            ch = out
        self.n_decoder = len(decoder_channels)
        self.seg_head = _conv(ch, classes, 3, 1, 1)

    def forward(self, x: torch.Tensor, train: bool | None = None) -> torch.Tensor:
        """NHWC images ``[B, H, W, 3]`` -> NHWC logits ``[B, H, W, classes]``."""
        if train is not None:
            self.train(train)
        in_dtype = x.dtype
        feats = self.encoder(channels_last(x.to(self.dtype).permute(0, 3, 1, 2)))
        h = feats[-1]
        skips = [feats[2], feats[1], feats[0], None, None]
        for i, skip in zip(range(self.n_decoder), skips):
            h = getattr(self, f"decoder_{i}")(h, skip)
        logits = self.seg_head(h)
        return logits.permute(0, 2, 3, 1).to(in_dtype)
