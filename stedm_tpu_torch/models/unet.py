"""The STEDM denoising U-Net (stedm_tpu/models/unet.py) with every option
of the JAX U-Net.

Module and parameter names follow the reference torch U-Net
(openaimodel.py), which is the layout stedm_tpu/utils/torch_import.py:map_unet
reads: ``time_embed.{0,2}``, ``input_blocks.{i}.{j}``, ``middle_block.{0..3}``
(ResBlockStyle nested as ``middle_block.1.block``), ``output_blocks.{i}.{j}``,
``out.{0,2}``, ``label_emb``. ResBlock keeps ``in_layers.{0,2}``,
``emb_layers.1``, ``out_layers.{0,3}`` and ``skip_connection``; a
``SpatialTransformer`` keeps the flax names (``proj_in``, ``block_0``, ...).

Options (stedm_tpu unet.py:97-131): ``use_scale_shift_norm`` (FiLM through
the GN kernel: the embedding projects to ``2 * out`` channels, scale first),
``resblock_updown`` (ResBlocks with ``down`` / ``up`` in place of the
Downsample / Upsample layers), ``conv_resample`` (False: pool and nearest
upsample without their convs), ``num_head_channels`` (heads of that width),
``use_spatial_transformer`` with ``transformer_depth`` at every attention
site, ``num_classes`` (``label_emb`` for integer labels ``y``) and
``dropout`` in every ResBlock, drawn in training (``train=True``) from the
``generator`` that ``forward`` gets. As in the JAX U-Net (unet.py:217, 253, 275), the spatial
transformers are called without the context and without ``train``: their
cross-attention attends over the tokens themselves and their dropout is
never drawn (ROADMAP §3, mirrored).

``use_checkpoint`` recomputes every ResBlock and attention block in the
backward pass (``torch.utils.checkpoint``) instead of keeping their
activations, as the JAX U-Net's ``nn.remat`` (unet.py:117-121, :145,
:191-195); off by default, as there. A ResBlock's dropout mask is drawn
before the block runs, so the recomputation reuses it.

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

from stedm_tpu_torch.models.attention import AttentionBlock, SpatialTransformer
from stedm_tpu_torch.models.layers import (
    Downsample,
    GNSiLU,
    Linear,
    Upsample,
    apply_dropout,
    avg_pool_2x,
    channels_last,
    conv1x1,
    conv3x3,
    dropout_mask,
    timestep_embedding,
    upsample_nearest_2x,
)


class ResBlock(nn.Module):
    """Residual block with additive or scale-shift (FiLM) embedding
    injection, optionally resampling (``up``: nearest 2x, ``down``: 2x2
    average pool, both paths after the first norm), with dropout before the
    output conv (stedm_tpu unet.py:47-94)."""

    def __init__(self, ch: int, out_ch: int, emb_dim: int, dropout: float = 0.0,
                 use_scale_shift_norm: bool = False, up: bool = False, down: bool = False):
        super().__init__()
        self.out_ch, self.dropout = out_ch, dropout
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.in_layers = nn.ModuleDict({"0": GNSiLU(ch), "2": conv3x3(ch, out_ch)})
        emb_out = 2 * out_ch if use_scale_shift_norm else out_ch
        self.emb_layers = nn.ModuleDict({"1": Linear(emb_dim, emb_out)})
        self.out_layers = nn.ModuleDict({"0": GNSiLU(out_ch),
                                         "3": conv3x3(out_ch, out_ch, zero_init=True)})
        self.skip_connection = nn.Identity() if out_ch == ch else conv1x1(ch, out_ch)

    def mask_shape(self, x: torch.Tensor) -> tuple:
        """The shape of the dropout mask for input ``x``."""
        b, _, h, w = x.shape
        f = 2.0 if self.up else 0.5 if self.down else 1.0
        return (b, self.out_ch, int(h * f), int(w * f))

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """``mask``: the dropout's keep mask (``dropout_mask``), or None."""
        h = self.in_layers["0"](x)
        if self.up:
            h, x = upsample_nearest_2x(h), upsample_nearest_2x(x)
        elif self.down:
            h, x = avg_pool_2x(h), avg_pool_2x(x)
        h = self.in_layers["2"](h)
        emb_out = self.emb_layers["1"](F.silu(emb.to(x.dtype)))
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_layers["0"](h, film_scale=scale, film_shift=shift)
        else:
            # the embedding add is fused into the norm, before its statistics
            h = self.out_layers["0"](h, add=emb_out)
        if mask is not None:
            h = apply_dropout(h, mask, self.dropout)
        h = self.out_layers["3"](h)
        return self.skip_connection(x) + h


class ResBlockStyle(nn.Module):
    """The bottleneck block whose embedding input is the style vector
    (reference openaimodel.py:291-297); the ResBlock sits under ``block``."""

    def __init__(self, ch: int, context_dim: int, **options):
        super().__init__()
        self.block = ResBlock(ch, ch, context_dim, **options)

    def mask_shape(self, x):
        return self.block.mask_shape(x)

    def forward(self, x, context, mask=None):
        return self.block(x, context, mask)


ATTN_IMPLS = ("exact", "chunked", "flash", "auto")
_RES = (ResBlock, ResBlockStyle)
_ATTN = (AttentionBlock, SpatialTransformer)


class UNet(nn.Module):
    """Style- and layout-conditioned denoising U-Net on NCHW input; takes
    the JAX U-Net's keywords (``image_size`` is ignored: shapes follow the
    input, as there)."""

    def __init__(self, in_channels: int = 6, model_channels: int = 128,
                 out_channels: int = 3, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (32, 16, 8),
                 channel_mult: Sequence[int] = (1, 4, 8), num_heads: int = 8,
                 context_dim: int = 512, attn_impl: str = "exact",
                 use_checkpoint: bool = False, dtype: torch.dtype = torch.float32,
                 image_size: int | None = None, dropout: float = 0.0,
                 conv_resample: bool = True, num_head_channels: int = -1,
                 use_scale_shift_norm: bool = False, resblock_updown: bool = False,
                 use_spatial_transformer: bool = False, transformer_depth: int = 1,
                 num_classes: int | None = None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        mc = model_channels
        self.model_channels, self.context_dim, self.dtype = mc, context_dim, dtype
        self.use_checkpoint, self.dropout = use_checkpoint, dropout
        self.use_spatial_transformer, self.num_classes = use_spatial_transformer, num_classes
        self.num_res_blocks, self.n_levels = num_res_blocks, len(channel_mult)
        temb = 4 * mc
        opts = dict(dropout=dropout, use_scale_shift_norm=use_scale_shift_norm)

        def heads(ch):   # stedm_tpu unet.py:128-131
            if num_head_channels == -1:
                return num_heads, ch // num_heads
            return ch // num_head_channels, num_head_channels

        def attn(ch):
            n, dim_head = heads(ch)
            if use_spatial_transformer:
                return SpatialTransformer(ch, n, dim_head, transformer_depth, dropout=dropout)
            return AttentionBlock(ch, n, attn_impl)

        self.time_embed = nn.ModuleDict({"0": Linear(mc, temb), "2": Linear(temb, temb)})
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, temb)
        self.input_blocks = nn.ModuleList([nn.ModuleList([conv3x3(in_channels, mc)])])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                blk = [ResBlock(ch, mult * mc, temb, **opts)]
                ch = mult * mc
                if ds in attention_resolutions:
                    blk.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(blk))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                down = (ResBlock(ch, ch, temb, down=True, **opts) if resblock_updown
                        else Downsample(ch, conv_resample))
                self.input_blocks.append(nn.ModuleList([down]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([
            ResBlock(ch, ch, temb, **opts), ResBlockStyle(ch, context_dim, **opts), attn(ch),
            ResBlock(ch, ch, temb, **opts)])
        self.output_blocks = nn.ModuleList()
        for level in range(len(channel_mult) - 1, -1, -1):
            mult = channel_mult[level]
            ds = 2 ** level
            for i in range(num_res_blocks + 1):
                blk = [ResBlock(ch + chans.pop(), mult * mc, temb, **opts)]
                ch = mult * mc
                if ds in attention_resolutions:
                    blk.append(attn(ch))
                if level and i == num_res_blocks:
                    blk.append(ResBlock(ch, ch, temb, up=True, **opts) if resblock_updown
                               else Upsample(ch, conv_resample))
                self.output_blocks.append(nn.ModuleList(blk))
        self.out = nn.ModuleDict({"0": GNSiLU(ch), "2": conv3x3(ch, out_channels,
                                                                zero_init=True)})

    def zero_init_layers(self) -> list[nn.Module]:
        """The layers that start at zero: every attention block's
        ``proj_out``, the ResBlock output convs and the ``out`` conv."""
        layers = [m.proj_out for m in self.modules() if isinstance(m, _ATTN)]
        layers += [m.out_layers["3"] for m in self.modules() if isinstance(m, ResBlock)]
        return layers + [self.out["2"]]

    def _call(self, layer: nn.Module, *args):
        if self.use_checkpoint and torch.is_grad_enabled() and isinstance(layer, _RES + _ATTN):
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def _res(self, layer: nn.Module, h, emb, generator):
        """A ResBlock (or ResBlockStyle) with its dropout mask drawn now
        from ``generator`` (training: not None), or none."""
        mask = None
        if generator is not None:
            mask = dropout_mask(layer.mask_shape(h), self.dropout, generator, h.device)
        return self._call(layer, h, emb, mask)

    def _run(self, block: nn.ModuleList, h, emb, generator):
        for layer in block:
            h = (self._res(layer, h, emb, generator) if isinstance(layer, _RES)
                 else self._call(layer, h))
        return h

    def shallow_blocks(self, cache_levels: int) -> int:
        """How many of ``input_blocks`` (from the front), and as many of
        ``output_blocks`` (from the back), a cached pass runs: the levels
        below ``cache_levels``, without the downsample into level
        ``cache_levels`` (stedm_tpu unet.py:213-235)."""
        return cache_levels * (self.num_res_blocks + 1)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor | None = None, y: torch.Tensor | None = None,
                train: bool = False, *, generator: torch.Generator | None = None,
                cache: torch.Tensor | None = None,
                return_cache: bool = False, cache_levels: int = 1):
        """x ``[B, C, H, W]``; a context of batch ``k * B`` fans the bottleneck
        and decoder out ``k`` ways (shared-encoder CFG, stedm_tpu
        unet.py:236-249; refused with the spatial transformer, as there).
        ``y``: integer class labels ``[B]`` when ``num_classes`` is set
        (ignored otherwise, as there). ``train`` with a ``dropout``: the
        ResBlocks' masks drawn from ``generator`` (required) in the order
        the blocks run. ``return_cache`` returns ``(out, cache)``; a ``cache`` of
        batch ``k * B`` fans the shallow levels out ``k`` ways."""
        shallow = cache is not None
        if shallow or return_cache:
            assert not (shallow and return_cache), "cache in and out are exclusive"
            assert 1 <= cache_levels < self.n_levels, \
                f"cache_levels must be in [1, {self.n_levels - 1}]"
        if train and self.dropout > 0 and generator is None:
            raise ValueError("dropout in train mode needs the step's generator")
        generator = generator if train and self.dropout > 0 else None
        in_dtype = x.dtype
        x = channels_last(x.to(self.dtype))
        t_emb = timestep_embedding(timesteps, self.model_channels).to(self.dtype)
        emb = self.time_embed["2"](F.silu(self.time_embed["0"](t_emb)))
        if self.num_classes is not None and y is not None:
            if torch.is_floating_point(y) or torch.is_complex(y):
                # flax nn.Embed's refusal (stedm_tpu stedm.py:132 passes the
                # float style vector as y under conditioning_key adm)
                raise ValueError("Input type must be an integer or unsigned integer.")
            emb = emb + self.label_emb(y).to(self.dtype)

        n_shallow = self.shallow_blocks(cache_levels)
        hs = []
        h = x
        for block in self.input_blocks[:n_shallow] if shallow else self.input_blocks:
            h = self._run(block, h, emb, generator)
            hs.append(h)

        if shallow:
            if cache.shape[0] != h.shape[0]:
                k = cache.shape[0] // h.shape[0]
                emb = torch.cat([emb] * k)
                hs = [channels_last(torch.cat([s] * k)) for s in hs]
            h = channels_last(cache.to(self.dtype))
        else:
            mid = self.middle_block
            h = self._res(mid[0], h, emb, generator)
            if context is None:
                context = torch.zeros((x.shape[0], self.context_dim), dtype=self.dtype,
                                      device=x.device)
            if context.shape[0] != h.shape[0]:
                assert not self.use_spatial_transformer, \
                    "shared-encoder CFG requires bottleneck-only conditioning"
                k = context.shape[0] // h.shape[0]
                h = channels_last(torch.cat([h] * k))
                emb = torch.cat([emb] * k)
                hs = [channels_last(torch.cat([s] * k)) for s in hs]
            h = self._res(mid[1], h, context.to(self.dtype), generator)
            h = self._call(mid[2], h)
            h = self._res(mid[3], h, emb, generator)

        blocks = self.output_blocks[-n_shallow:] if shallow else self.output_blocks
        deep = len(self.output_blocks) - n_shallow
        cache_out = None
        for i, block in enumerate(blocks):
            h = channels_last(torch.cat([h, hs.pop()], dim=1))
            h = self._run(block, h, emb, generator)
            if return_cache and i == deep - 1:
                cache_out = h   # post-upsample state entering level cache_levels - 1
        h = self.out["2"](self.out["0"](h))
        out = h.to(in_dtype)
        return (out, cache_out) if return_cache else out
