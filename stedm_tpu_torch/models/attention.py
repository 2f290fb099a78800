"""The U-Net's attention blocks (stedm_tpu/models/attention.py).

``AttentionBlock`` is the bottleneck self-attention (:34-72), through the
flash kernels on the card. ``SpatialTransformer`` (:75-164), selected by
``use_spatial_transformer``, runs plain torch matmuls, as JAX runs it through
its einsum ``_sdpa`` and no Pallas kernel, with flax's numerics: LayerNorm
at eps 1e-6 in fp32 (two-pass variance, as ``use_fast_variance=False``),
the tanh GELU, q and k each scaled by ``dim_head ** -0.25`` in the compute
dtype and the fp32 softmax cast to it before the product with V. Its
modules carry the flax names (``proj_in``, ``block_{d}/attn1/to_q``, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stedm_tpu_torch.models.layers import GNSiLU, Linear, TokenConv1d
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


def _sdpa(q, k, v, scale: float) -> torch.Tensor:
    """softmax((q s)(k s)^T) v over ``[B, H, T, Dh]`` (stedm_tpu
    attention.py:25-31): q and k scaled in their dtype, fp32 logits and
    softmax, the weights cast back before the product with V."""
    logits = (q * scale).float() @ (k * scale).float().transpose(-1, -2)
    return torch.softmax(logits, dim=-1).to(q.dtype) @ v


class CrossAttention(nn.Module):
    """Multi-head attention over ``context`` (``x`` itself when None;
    stedm_tpu attention.py:75-99). ``context_dim`` is the context's width
    (None: ``x``'s, as the U-Net builds it). ``dropout`` is kept for the
    config but never drawn: the U-Net calls its transformers without
    ``train``, as the JAX U-Net does (ROADMAP §3)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None, dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = Linear(inner, query_dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        ctx = x if context is None else context

        def split(a):
            return a.reshape(*a.shape[:2], self.heads, self.dim_head).transpose(1, 2)

        out = _sdpa(split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)),
                    float(self.dim_head) ** -0.25)
        return self.to_out(out.transpose(1, 2).reshape(*x.shape[:2], -1))


class GEGLU(nn.Module):
    """x * gelu(gate) from one projection (stedm_tpu attention.py:102-110);
    flax's ``nn.gelu`` is the tanh approximation."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim, 2 * dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)``: fp32 statistics and output, cast
    back to the compute dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(x.dtype)


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention and a GEGLU feed-forward, each
    pre-LayerNormed with a residual (stedm_tpu attention.py:113-133)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int | None = None,
                 dropout: float = 0.0):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head, dropout=dropout)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, dropout)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim, eps=1e-6) for _ in range(3))
        self.ff_geglu = GEGLU(dim, 4 * dim)
        self.ff_out = Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        x = self.attn1(_layer_norm(self.norm1, x)) + x
        x = self.attn2(_layer_norm(self.norm2, x), context) + x
        return self.ff_out(self.ff_geglu(_layer_norm(self.norm3, x))) + x


class SpatialTransformer(nn.Module):
    """A transformer over the spatial tokens between a GroupNorm + Dense
    projection in and a zero-initialised Dense projection out, added to the
    input (stedm_tpu attention.py:136-164); a ``[B, C]`` context becomes one
    token. NCHW (channels_last) in and out."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: int | None = None, dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.norm = GNSiLU(channels, apply_silu=False)
        self.proj_in = Linear(channels, inner)
        self.blocks = [f"block_{d}" for d in range(depth)]
        for name in self.blocks:
            self.add_module(name, BasicTransformerBlock(inner, heads, dim_head, context_dim,
                                                        dropout))
        self.proj_out = Linear(inner, channels)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        b, c, h, w = x.shape
        if context is not None and context.dim() == 2:
            context = context[:, None, :]
        t = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for name in self.blocks:
            t = getattr(self, name)(t, context)
        out = self.proj_out(t).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + out
