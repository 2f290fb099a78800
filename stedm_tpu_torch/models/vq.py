"""VQGAN-f4 first-stage codec (stedm_tpu/models/vq.py): the frozen codec of
the diffusion path (``encode``, ``decode``) and the training forward of codec
fine-tuning (``training_recon``, with the taming codebook loss), whose
gradient runs through every layer here, the mid-block attention included.

Names follow the CompVis/taming torch modules that
stedm_tpu/utils/torch_import.py:map_vq reads: ``encoder`` / ``decoder`` with
``conv_in``, ``mid.block_1``, ``mid.attn_1``, ``mid.block_2``,
``down.{l}.block.{b}`` / ``up.{l}.block.{b}``, ``down.{l}.downsample.conv``,
``up.{l}.upsample.conv``, ``norm_out``, ``conv_out``; ``quantize.embedding``,
``quant_conv``, ``post_quant_conv``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stedm_tpu_torch.models.layers import (
    Conv2d,
    GNSiLU,
    channels_last,
    conv1x1,
    conv3x3,
    upsample_nearest_2x,
)
from stedm_tpu_torch.ops.blocked_attention import flash_attention
from stedm_tpu_torch.ops.quantize import nearest_code

_EPS = 1e-6   # the codec's GroupNorm eps (reference model.py:37-39)


class ResnetBlockVQ(nn.Module):
    """GN-swish-conv x2 with a 1x1 nin shortcut (stedm_tpu vq.py:48-66)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GNSiLU(cin, _EPS)
        self.conv1 = conv3x3(cin, cout)
        self.norm2 = GNSiLU(cout, _EPS)
        self.conv2 = conv3x3(cout, cout)
        self.nin_shortcut = conv1x1(cin, cout) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlockVQ(nn.Module):
    """Single-head spatial self-attention, ``sm_scale = C ** -0.5`` after the
    matmul (stedm_tpu vq.py:69-103). Runs through ``flash_attention`` at
    every T: the kernels on the card (the forward and, when a gradient is
    wanted, the backward, at any width; above 1024 channels the band route),
    their plain versions on the CPU."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GNSiLU(channels, _EPS, apply_silu=False)
        self.q = conv1x1(channels, channels)
        self.k = conv1x1(channels, channels)
        self.v = conv1x1(channels, channels)
        self.proj_out = conv1x1(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        tok = self.norm(x).permute(0, 2, 3, 1).reshape(b, 1, h * w, c)

        def proj(conv):
            return F.linear(tok, conv.weight[:, :, 0, 0].to(tok.dtype),
                            conv.bias.to(tok.dtype)).contiguous()

        out = flash_attention(proj(self.q), proj(self.k), proj(self.v), float(c) ** -0.5)
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + self.proj_out(out)


class DownsampleVQ(nn.Module):
    """Asymmetric-pad stride-2 conv (reference model.py:60-78: pad (0,1,0,1))."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(channels_last(F.pad(x, (0, 1, 0, 1))))


class UpsampleVQ(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class _Level(nn.Module):
    """One resolution level: ``block``, ``attn`` and an optional resampler."""

    def __init__(self, blocks, attns, resample_name=None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        if resample_name is not None:
            self.add_module(resample_name, resample)


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlockVQ(ch, ch)
        self.attn_1 = AttnBlockVQ(ch)
        self.block_2 = ResnetBlockVQ(ch, ch)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class VQEncoder(nn.Module):
    """(reference model.py:368-459); ``double_z`` doubles the output
    channels (the KL codec's mean and log-variance). ``dropout`` is taken
    and never drawn: the JAX codec's ResnetBlocks apply it only in train
    mode, which no caller of the JAX codec passes (stedm_tpu vq.py:288,
    ``training_recon`` -> ``encode``; ROADMAP §3, mirrored); so here too in
    the decoder."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 resolution: int = 512, z_channels: int = 3, in_channels: int = 3,
                 double_z: bool = False, dropout: float = 0.0):
        super().__init__()
        self.conv_in = conv3x3(in_channels, ch)
        in_mult = (1,) + tuple(ch_mult)
        curr_res = resolution
        levels = []
        block_in = ch
        for i, mult in enumerate(ch_mult):
            block_in = ch * in_mult[i]
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlockVQ(block_in, ch * mult))
                block_in = ch * mult
                if curr_res in attn_resolutions:
                    attns.append(AttnBlockVQ(block_in))
            if i != len(ch_mult) - 1:
                levels.append(_Level(blocks, attns, "downsample", DownsampleVQ(block_in)))
                curr_res //= 2
            else:
                levels.append(_Level(blocks, attns))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in)
        self.norm_out = GNSiLU(block_in, _EPS)
        self.conv_out = conv3x3(block_in, 2 * z_channels if double_z else z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for lvl in self.down:
            for i, blk in enumerate(lvl.block):
                h = blk(h)
                if len(lvl.attn):
                    h = lvl.attn[i](h)
            if hasattr(lvl, "downsample"):
                h = lvl.downsample(h)
        return self.conv_out(self.norm_out(self.mid(h)))


class VQDecoder(nn.Module):
    """(reference model.py:462-568)"""

    def __init__(self, ch: int = 128, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 resolution: int = 512, z_channels: int = 3, dropout: float = 0.0):
        super().__init__()
        n = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (n - 1)
        self.conv_in = conv3x3(z_channels, block_in)
        self.mid = _Mid(block_in)
        levels = [None] * n
        for i in reversed(range(n)):
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlockVQ(block_in, ch * ch_mult[i]))
                block_in = ch * ch_mult[i]
                if curr_res in attn_resolutions:
                    attns.append(AttnBlockVQ(block_in))
            if i != 0:
                levels[i] = _Level(blocks, attns, "upsample", UpsampleVQ(block_in))
                curr_res *= 2
            else:
                levels[i] = _Level(blocks, attns)
        self.up = nn.ModuleList(levels)
        self.norm_out = GNSiLU(block_in, _EPS)
        self.conv_out = conv3x3(block_in, out_ch)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for lvl in reversed(self.up):
            for i, blk in enumerate(lvl.block):
                h = blk(h)
                if len(lvl.attn):
                    h = lvl.attn[i](h)
            if hasattr(lvl, "upsample"):
                h = lvl.upsample(h)
        return self.conv_out(self.norm_out(h))


class VectorQuantizer(nn.Module):
    """Nearest codebook entry with the straight-through value
    (stedm_tpu vq.py:202-240) on NHWC latents: the gradient reaches ``z``
    unchanged and the codebook not at all. ``with_loss`` also returns the
    taming legacy codebook loss ``mean((sg(z_q) - z)^2) + beta mean((z_q -
    sg(z))^2)`` and the code indices ``[B, H, W]``."""

    def __init__(self, n_embed: int = 8192, embed_dim: int = 3, beta: float = 0.25):
        super().__init__()
        self.embed_dim, self.beta = embed_dim, beta
        self.embedding = nn.Embedding(n_embed, embed_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_embed, 1.0 / n_embed)

    def forward(self, z: torch.Tensor, with_loss: bool = False):
        flat = z.reshape(-1, self.embed_dim).float().contiguous()
        cb = self.embedding.weight.float()
        idx = nearest_code(flat.detach(), cb.detach()).long()
        z_q = cb[idx].reshape(z.shape)
        z32 = z.float()
        z_st = z32 + (z_q - z32).detach()
        if not with_loss:
            return z_st
        emb_loss = (torch.mean(torch.square(z_q.detach() - z32))
                    + self.beta * torch.mean(torch.square(z_q - z32.detach())))
        return z_st, emb_loss, idx.reshape(z.shape[:-1])


_DD_KEYS = ("ch", "ch_mult", "num_res_blocks", "attn_resolutions", "resolution", "z_channels",
            "dropout")


def codec_args(ddconfig: dict | None, double_z: bool) -> tuple[dict, dict]:
    """The encoder's and the decoder's arguments from a ``ddconfig``; raises
    on a key the codec does not take and on a ``double_z`` other than the
    codec's own (JAX's VQ interface drops the key, its KL codec forces it
    true)."""
    dd = dict(ddconfig or {})
    unknown = set(dd) - set(_DD_KEYS) - {"double_z", "in_channels", "out_ch"}
    if unknown:
        raise ValueError(f"unknown ddconfig keys {sorted(unknown)}")
    if bool(dd.get("double_z", double_z)) != double_z:
        raise ValueError(f"ddconfig double_z {dd['double_z']} where this codec's encoder "
                         f"has double_z {double_z}")
    args = {k: dd[k] for k in _DD_KEYS if k in dd}
    enc = dict(args, in_channels=dd.get("in_channels", 3), double_z=double_z)
    return enc, dict(args, out_ch=dd.get("out_ch", 3))


class VQModelInterface(nn.Module):
    """Pre-quant encode / quantize-then-decode (stedm_tpu vq.py:242-290).
    ``encode``, ``decode`` and ``training_recon`` take and return NHWC.
    ``ddconfig`` takes the shipped keys: ``double_z`` must be false;
    ``dropout`` is never drawn, as in the JAX codec (``VQEncoder``). ``monitor`` is ignored, as in
    the JAX package. A ``ckpt_path`` is loaded at construction by
    ``utils.weights.load_first_stage``: a torch state dict through
    ``map_vq``, or this package's ``ae_state`` / ``params`` file."""

    def __init__(self, embed_dim: int = 3, n_embed: int = 8192, ddconfig: dict | None = None,
                 dtype: torch.dtype = torch.float32, ckpt_path: str | None = None,
                 monitor: str | None = None):
        super().__init__()
        enc, dec = codec_args(ddconfig, double_z=False)
        dd = dict(ddconfig or {})
        self.dtype, self.n_embed = dtype, n_embed
        self.encoder = VQEncoder(**enc)
        self.decoder = VQDecoder(**dec)
        z_ch = dd.get("z_channels", 3)
        self.quant_conv = conv1x1(z_ch, embed_dim)
        self.post_quant_conv = conv1x1(embed_dim, z_ch)
        self.quantize = VectorQuantizer(n_embed, embed_dim)
        if ckpt_path is not None:
            from stedm_tpu_torch.utils.weights import load_first_stage
            load_first_stage(self, ckpt_path)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = channels_last(x.permute(0, 3, 1, 2).to(self.dtype))
        return self.quant_conv(self.encoder(h)).permute(0, 2, 3, 1)

    def decode(self, h: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        return self._decode(h if force_not_quantize else self.quantize(h))

    def _decode(self, quant: torch.Tensor) -> torch.Tensor:
        q = channels_last(quant.permute(0, 3, 1, 2).to(self.dtype))
        return self.decoder(self.post_quant_conv(q)).permute(0, 2, 3, 1)

    def training_recon(self, x: torch.Tensor):
        """Image -> encode -> quantize (with the codebook loss) -> decode, the
        codec fine-tuning forward (stedm_tpu vq.py:281-290): returns
        ``(reconstruction, emb_loss, code_indices)``."""
        quant, emb_loss, idx = self.quantize(self.encode(x), with_loss=True)
        return self._decode(quant), emb_loss, idx
