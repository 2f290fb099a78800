"""Set-ViT (sViT) style encoder (stedm_tpu/models/svit.py; the reference's
networks/vit_set.py).

A ViT over *sets* of images: the N members are stacked channel-wise before
patch embedding (``SPT``), attention scales by a learnable log-temperature
and masks each token's attention to itself (``LSA``), and a CLS token and a
time-embedding token are prepended before the transformer. On the active
path it sees only the style set, so the time token is zeros; the projected
time token is built only with ``time_embedding=True``, as flax creates
``to_time_embedding`` only when it is called with one.

Module names are the JAX tree's. Parameters are fp32; the layers compute
in the model's dtype, the LayerNorms (eps 1e-6) and the
attention logits and softmax in fp32. The attention is plain matmul +
softmax, as it is plain jnp in the JAX module. GELU is the tanh form,
flax's default.

Dropout (the shipped config sets 0.1 on the attention weights and outputs,
the feed-forward and the embeddings) is drawn from an explicit
``torch.Generator`` in train mode, with flax's rule: keep with probability
1 - p and scale the kept values by 1 / (1 - p).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from stedm_tpu_torch.models.layers import Linear, dropout
from stedm_tpu_torch.models.swin import LayerNorm32


def _norm(dim: int) -> LayerNorm32:
    """flax's LayerNorm: eps 1e-6, computed in fp32."""
    return LayerNorm32(dim, eps=1e-6)


class LSA(nn.Module):
    """Locality-aware self-attention: logits scaled by exp(temperature), the
    diagonal masked out (vit_set.py:35-67)."""

    def __init__(self, dim: int, heads: int = 12, dim_head: int = 64, dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head, self.rate = heads, dim_head, dropout
        inner = heads * dim_head
        self.to_qkv = Linear(dim, inner * 3, bias=False)
        self.temperature = nn.Parameter(torch.tensor(math.log(dim_head ** -0.5)))
        self.to_out = Linear(inner, dim)

    def forward(self, x, train: bool = False, generator=None):
        b, n, _ = x.shape
        qkv = self.to_qkv(x).reshape(b, n, 3, self.heads, self.dim_head).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * torch.exp(
            self.temperature)
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        logits = logits.masked_fill(eye, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        weights = dropout(weights, self.rate, train, generator)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, n, -1)
        return dropout(self.to_out(out), self.rate, train, generator)


class SViTFeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.rate = dropout
        self.fc1 = Linear(dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, dim)

    def forward(self, x, train: bool = False, generator=None):
        h = dropout(F.gelu(self.fc1(x), approximate="tanh"), self.rate, train, generator)
        return dropout(self.fc2(h), self.rate, train, generator)


class SPT(nn.Module):
    """Set patch tokenizer: the set stacked channel-wise, patchified,
    LayerNorm, projected (vit_set.py:84-107). Its input width is
    ``patch_size**2 * channels * set size``."""

    def __init__(self, dim: int, patch_size: int, in_width: int):
        super().__init__()
        self.patch_size = patch_size
        self.patch_norm = _norm(in_width)
        self.patch_proj = Linear(in_width, dim)

    def forward(self, x_set: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``[B, N, H, W, C]`` -> tokens ``[B, (H/p)(W/p), dim]``."""
        b, n, h, w, c = x_set.shape
        p = self.patch_size
        x = x_set.permute(0, 2, 3, 1, 4).reshape(b, h, w, n * c)
        x = x.reshape(b, h // p, p, w // p, p, n * c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * n * c)
        return self.patch_proj(self.patch_norm(x).to(dtype))


class SViT(nn.Module):
    """Set-ViT (vit_set.py:110-208) on NHWC style sets ``[B, N, H, W, C]``."""

    def __init__(self, image_size: int = 512, patch_size: int = 8, num_classes: int = 512,
                 dim: int = 256, depth: int = 6, heads: int = 12, mlp_dim: int = 256,
                 pool: str = "mean", channels: int = 3, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, ns: int = 1,
                 t_dim: int = 256, time_embedding: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pool not in ("mean", "sum", "cls"):
            raise ValueError(f"unknown pool {pool!r}")
        self.dim, self.depth, self.pool, self.ns = dim, depth, pool, ns
        self.emb_rate, self.dtype = emb_dropout, dtype
        num_patches = (image_size // patch_size) ** 2
        self.to_patch_embedding = SPT(dim, patch_size, patch_size ** 2 * channels * ns)
        self.pos_embedding = nn.Parameter(torch.randn(1, num_patches + 2, dim))
        self.cls_token = nn.Parameter(torch.randn(1, 1, dim))
        self.to_time_embedding = Linear(t_dim, dim) if time_embedding else None
        for i in range(depth):
            setattr(self, f"block{i}_norm_attn", _norm(dim))
            setattr(self, f"block{i}_attn", LSA(dim, heads, dim_head, dropout))
            setattr(self, f"block{i}_norm_ff", _norm(dim))
            setattr(self, f"block{i}_ff", SViTFeedForward(dim, mlp_dim, dropout))
        self.head_norm = _norm(dim)
        self.head = Linear(dim, num_classes)

    def forward(self, img_set: torch.Tensor, t_emb: torch.Tensor | None = None,
                train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        b, dt = img_set.shape[0], self.dtype
        patches = self.to_patch_embedding(img_set.float(), dt)
        n = patches.shape[1]
        cls = self.cls_token.to(dt).expand(b, 1, self.dim)
        if t_emb is None:
            t_tok = torch.zeros((b, 1, self.dim), dtype=dt, device=img_set.device)
        else:
            if self.to_time_embedding is None:
                raise ValueError("a time embedding needs SViT(time_embedding=True)")
            t_tok = self.to_time_embedding(t_emb.to(dt)).reshape(b, self.ns, -1)[:, :1]
        x = torch.cat([cls, t_tok, patches], dim=1) + self.pos_embedding[:, :n + 2].to(dt)
        x = dropout(x, self.emb_rate, train, generator)
        for i in range(self.depth):
            h = getattr(self, f"block{i}_norm_attn")(x).to(dt)
            x = x + getattr(self, f"block{i}_attn")(h, train, generator)
            h = getattr(self, f"block{i}_norm_ff")(x).to(dt)
            x = x + getattr(self, f"block{i}_ff")(h, train, generator)
        if self.pool == "mean":
            x = x.mean(dim=1)
        elif self.pool == "sum":
            x = x.sum(dim=1)
        else:
            x = x[:, 0]
        return self.head(self.head_norm(x).to(dt))
