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

The deep-feature cache in/out of the JAX U-Net (unet.py:154-175, :255-283)
belongs to the serving slice and is not here.
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


class UNet(nn.Module):
    """Style- and layout-conditioned denoising U-Net on NCHW input."""

    def __init__(self, in_channels: int = 6, model_channels: int = 128,
                 out_channels: int = 3, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (32, 16, 8),
                 channel_mult: Sequence[int] = (1, 4, 8), num_heads: int = 8,
                 context_dim: int = 512, attn_impl: str = "exact",
                 use_checkpoint: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        mc = model_channels
        self.model_channels, self.context_dim, self.dtype = mc, context_dim, dtype
        self.use_checkpoint = use_checkpoint
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

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        """x ``[B, C, H, W]``; a context of batch ``k * B`` fans the bottleneck
        and decoder out ``k`` ways (shared-encoder CFG, stedm_tpu
        unet.py:236-249)."""
        in_dtype = x.dtype
        x = channels_last(x.to(self.dtype))
        t_emb = timestep_embedding(timesteps, self.model_channels).to(self.dtype)
        emb = self.time_embed["2"](F.silu(self.time_embed["0"](t_emb)))

        hs = []
        h = x
        for block in self.input_blocks:
            h = self._run(block, h, emb)
            hs.append(h)

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

        for block in self.output_blocks:
            h = channels_last(torch.cat([h, hs.pop()], dim=1))
            h = self._run(block, h, emb)
        h = self.out["2"](self.out["0"](h))
        return h.to(in_dtype)
