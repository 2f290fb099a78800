"""LPIPS perceptual distance (stedm_tpu/models/lpips.py): a VGG16 trunk and
five learned 1x1 heads (Zhang et al., arXiv 1801.03924), the perceptual term
of codec fine-tuning.

Module names are taming's ``LPIPS`` (``scaling_layer.{shift,scale}``,
``net.slice{n}.{idx}`` with torchvision's VGG16 ``features`` indices,
``lin{k}.model.1``), so a taming state_dict loads with ``load_state_dict``.
Inputs are NHWC in [-1, 1]; the distance is ``[B, 1, 1, 1]`` fp32, as in
the JAX package. The trunk and heads are frozen (``requires_grad=False``);
the gradient reaches the inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# taming ScalingLayer: [-1, 1] onto the ImageNet-normalised range VGG expects
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# torchvision VGG16 ``features`` conv indices by taming's five slices
# (slice ends 4 / 9 / 16 / 23 / 30, the max-pool positions)
_SLICES = (
    ((0, 64), (2, 64)),
    ((5, 128), (7, 128)),
    ((10, 256), (12, 256), (14, 256)),
    ((17, 512), (19, 512), (21, 512)),
    ((24, 512), (26, 512), (28, 512)),
)
CHNS = (64, 128, 256, 512, 512)


class _ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))


class VGG16Features(nn.Module):
    """The five LPIPS slices (relu1_2 .. relu5_3); each ``slice{n}`` holds
    its convolutions under their torchvision indices."""

    def __init__(self):
        super().__init__()
        for si, convs in enumerate(_SLICES):
            sl = nn.Module()
            cin = 3 if si == 0 else _SLICES[si - 1][-1][1]
            for idx, ch in convs:
                sl.add_module(str(idx), nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch
            self.add_module(f"slice{si + 1}", sl)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        outs = []
        for si in range(len(_SLICES)):
            if si:
                x = F.max_pool2d(x, 2, 2)
            for conv in getattr(self, f"slice{si + 1}").children():
                x = F.relu(conv(x))
            outs.append(x)
        return outs


class _NetLinLayer(nn.Module):
    """taming NetLinLayer: ``model`` = (Dropout, 1x1 conv without bias);
    the dropout is inactive (eval)."""

    def __init__(self, cin: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(p=0.0), nn.Conv2d(cin, 1, 1, bias=False))


def _normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """taming ``normalize_tensor``: unit norm across channels."""
    return feat / (torch.sqrt(torch.sum(feat.square(), dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Per-sample perceptual distance ``[B, 1, 1, 1]`` between NHWC images."""

    def __init__(self):
        super().__init__()
        self.scaling_layer = _ScalingLayer()
        self.net = VGG16Features()
        for k, ch in enumerate(CHNS):
            self.add_module(f"lin{k}", _NetLinLayer(ch))
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        sc = self.scaling_layer
        both = torch.cat([x.float(), y.float()]).permute(0, 3, 1, 2)
        feats = self.net((both - sc.shift) / sc.scale)
        total = 0.0
        for k, f in enumerate(feats):
            fx, fy = f.chunk(2)
            diff = (_normalize(fx) - _normalize(fy)).square()
            head = getattr(self, f"lin{k}").model[1](diff)
            total = total + head.mean(dim=(2, 3), keepdim=True)
        return total.permute(0, 2, 3, 1)

