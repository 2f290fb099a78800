"""The STEDM denoising U-Net (stedm_tpu/models/unet.py), exact path.

Module and parameter names follow the reference torch U-Net
(openaimodel.py), which is the layout stedm_tpu/utils/torch_import.py:map_unet
reads: ``time_embed.{0,2}``, ``input_blocks.{i}.{j}``, ``middle_block.{0..3}``
(ResBlockStyle nested as ``middle_block.1.block``), ``output_blocks.{i}.{j}``,
``out.{0,2}``. ResBlock keeps ``in_layers.{0,2}``, ``emb_layers.1``,
``out_layers.{0,3}`` and ``skip_connection``.

``use_checkpoint`` recomputes every ResBlock and AttentionBlock in the
backward pass (``torch.utils.checkpoint``) instead of keeping their
activations, as the JAX U-Net's ``nn.remat`` (unet.py:117-121, :145,
:191-195); off by default, as there.

The deep-feature cache of the serving mode (stedm_tpu unet.py:150-175,
:200-288): ``return_cache=True`` also returns the post-upsample state that
enters decoder level ``cache_levels - 1``; ``cache=`` runs only the levels
below ``cache_levels`` and splices that state in. The cache is NCHW in
channels_last memory (NHWC in the JAX U-Net).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from stedm_tpu_torch.models.attention import AttentionBlock
from stedm_tpu_torch.models.layers import (
    Downsample,
    GNSiLU,
    Linear,
    Upsample,
    channels_last,
    conv1x1,
    conv3x3,
    timestep_embedding,
)


class ResBlock(nn.Module):
    """Residual block with additive embedding injection (stedm_tpu
    unet.py:47-94; the landscape config's use_scale_shift_norm=False)."""

    def __init__(self, ch: int, out_ch: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.ModuleDict({"0": GNSiLU(ch), "2": conv3x3(ch, out_ch)})
        self.emb_layers = nn.ModuleDict({"1": Linear(emb_dim, out_ch)})
        self.out_layers = nn.ModuleDict({"0": GNSiLU(out_ch),
                                         "3": conv3x3(out_ch, out_ch, zero_init=True)})
        self.skip_connection = nn.Identity() if out_ch == ch else conv1x1(ch, out_ch)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers["2"](self.in_layers["0"](x))
        emb_out = self.emb_layers["1"](F.silu(emb.to(x.dtype)))
        # the embedding add is fused into the norm, before its statistics
        h = self.out_layers["3"](self.out_layers["0"](h, add=emb_out))
        return self.skip_connection(x) + h


class ResBlockStyle(nn.Module):
    """The bottleneck block whose embedding input is the style vector
    (reference openaimodel.py:291-297); the ResBlock sits under ``block``."""

    def __init__(self, ch: int, context_dim: int):
        super().__init__()
        self.block = ResBlock(ch, ch, context_dim)

    def forward(self, x, context):
        return self.block(x, context)


# options of the JAX U-Net (stedm_tpu/models/unet.py:97-126) that the port
# takes only at the value every shipped config gives them
_SHIPPED = {"dropout": 0.0, "use_scale_shift_norm": False, "resblock_updown": False,
            "use_spatial_transformer": False, "transformer_depth": 1,
            "conv_resample": True, "num_head_channels": -1, "num_classes": None}
ATTN_IMPLS = ("exact", "chunked", "flash", "auto")


class UNet(nn.Module):
    """Style- and layout-conditioned denoising U-Net on NCHW input.

    Takes the JAX U-Net's keywords: ``image_size`` is ignored (shapes follow
    the input, as there); the options in ``_SHIPPED`` are accepted at their
    shipped value and raise ``NotImplementedError`` at any other."""

    def __init__(self, in_channels: int = 6, model_channels: int = 128,
                 out_channels: int = 3, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (32, 16, 8),
                 channel_mult: Sequence[int] = (1, 4, 8), num_heads: int = 8,
                 context_dim: int = 512, attn_impl: str = "exact",
                 use_checkpoint: bool = False, dtype: torch.dtype = torch.float32,
                 image_size: int | None = None, **options):
        super().__init__()
        for key, value in options.items():
            if key not in _SHIPPED:
                raise TypeError(f"UNet got an unexpected keyword argument {key!r}")
            if value != _SHIPPED[key]:
                raise NotImplementedError(f"U-Net {key}={value!r} is not ported (ROADMAP "
                                          f"§1: the rest); the port takes {_SHIPPED[key]!r}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        mc = model_channels
        self.model_channels, self.context_dim, self.dtype = mc, context_dim, dtype
        self.use_checkpoint = use_checkpoint
        self.num_res_blocks, self.n_levels = num_res_blocks, len(channel_mult)
        temb = 4 * mc

        def attn(ch):
            return AttentionBlock(ch, num_heads, attn_impl)

        self.time_embed = nn.ModuleDict({"0": Linear(mc, temb), "2": Linear(temb, temb)})
        self.input_blocks = nn.ModuleList([nn.ModuleList([conv3x3(in_channels, mc)])])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                blk = [ResBlock(ch, mult * mc, temb)]
                ch = mult * mc
                if ds in attention_resolutions:
                    blk.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(blk))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([
            ResBlock(ch, ch, temb), ResBlockStyle(ch, context_dim), attn(ch),
            ResBlock(ch, ch, temb)])
        self.output_blocks = nn.ModuleList()
        for level in range(len(channel_mult) - 1, -1, -1):
            mult = channel_mult[level]
            ds = 2 ** level
            for i in range(num_res_blocks + 1):
                blk = [ResBlock(ch + chans.pop(), mult * mc, temb)]
                ch = mult * mc
                if ds in attention_resolutions:
                    blk.append(attn(ch))
                if level and i == num_res_blocks:
                    blk.append(Upsample(ch))
                self.output_blocks.append(nn.ModuleList(blk))
        self.out = nn.ModuleDict({"0": GNSiLU(ch), "2": conv3x3(ch, out_channels,
                                                                zero_init=True)})

    def zero_init_layers(self) -> list[nn.Module]:
        """The layers that start at zero: every ``AttentionBlock.proj_out``,
        the ResBlock output convs and the ``out`` conv."""
        layers = [m.proj_out for m in self.modules() if isinstance(m, AttentionBlock)]
        layers += [m.out_layers["3"] for m in self.modules() if isinstance(m, ResBlock)]
        return layers + [self.out["2"]]

    def _call(self, layer: nn.Module, *args):
        if self.use_checkpoint and torch.is_grad_enabled() and \
                isinstance(layer, (ResBlock, ResBlockStyle, AttentionBlock)):
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def _run(self, block: nn.ModuleList, h, emb):
        for layer in block:
            h = self._call(layer, h, emb) if isinstance(layer, ResBlock) else self._call(layer, h)
        return h

    def shallow_blocks(self, cache_levels: int) -> int:
        """How many of ``input_blocks`` (from the front), and as many of
        ``output_blocks`` (from the back), a cached pass runs: the levels
        below ``cache_levels``, without the downsample into level
        ``cache_levels`` (stedm_tpu unet.py:213-235)."""
        return cache_levels * (self.num_res_blocks + 1)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor | None = None, *, cache: torch.Tensor | None = None,
                return_cache: bool = False, cache_levels: int = 1):
        """x ``[B, C, H, W]``; a context of batch ``k * B`` fans the bottleneck
        and decoder out ``k`` ways (shared-encoder CFG, stedm_tpu
        unet.py:236-249). ``return_cache`` returns ``(out, cache)``; a
        ``cache`` of batch ``k * B`` fans the shallow levels out ``k`` ways."""
        shallow = cache is not None
        if shallow or return_cache:
            assert not (shallow and return_cache), "cache in and out are exclusive"
            assert 1 <= cache_levels < self.n_levels, \
                f"cache_levels must be in [1, {self.n_levels - 1}]"
        in_dtype = x.dtype
        x = channels_last(x.to(self.dtype))
        t_emb = timestep_embedding(timesteps, self.model_channels).to(self.dtype)
        emb = self.time_embed["2"](F.silu(self.time_embed["0"](t_emb)))

        n_shallow = self.shallow_blocks(cache_levels)
        hs = []
        h = x
        for block in self.input_blocks[:n_shallow] if shallow else self.input_blocks:
            h = self._run(block, h, emb)
            hs.append(h)

        if shallow:
            if cache.shape[0] != h.shape[0]:
                k = cache.shape[0] // h.shape[0]
                emb = torch.cat([emb] * k)
                hs = [channels_last(torch.cat([s] * k)) for s in hs]
            h = channels_last(cache.to(self.dtype))
        else:
            mid = self.middle_block
            h = self._call(mid[0], h, emb)
            if context is None:
                context = torch.zeros((x.shape[0], self.context_dim), dtype=self.dtype,
                                      device=x.device)
            if context.shape[0] != h.shape[0]:
                k = context.shape[0] // h.shape[0]
                h = channels_last(torch.cat([h] * k))
                emb = torch.cat([emb] * k)
                hs = [channels_last(torch.cat([s] * k)) for s in hs]
            h = self._call(mid[1], h, context.to(self.dtype))
            h = self._call(mid[2], h)
            h = self._call(mid[3], h, emb)

        blocks = self.output_blocks[-n_shallow:] if shallow else self.output_blocks
        deep = len(self.output_blocks) - n_shallow
        cache_out = None
        for i, block in enumerate(blocks):
            h = channels_last(torch.cat([h, hs.pop()], dim=1))
            h = self._run(block, h, emb)
            if return_cache and i == deep - 1:
                cache_out = h   # post-upsample state entering level cache_levels - 1
        h = self.out["2"](self.out["0"](h))
        out = h.to(in_dtype)
        return (out, cache_out) if return_cache else out
