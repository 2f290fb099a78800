"""PatchGAN discriminator of codec fine-tuning (stedm_tpu/models/discriminator.py).

The taming ``NLayerDiscriminator`` (``main``, an ``nn.Sequential``:
``main.{i}`` convolutions, BatchNorm2d or ``ActNorm``, LeakyReLU 0.2), so a
taming state_dict loads with ``load_state_dict``. Images in, patch logits
out, both NHWC as in the JAX package; the discriminator computes in fp32.

BatchNorm runs with batch statistics (the JAX steps always call it in train
mode) and follows flax's ``BatchNorm(momentum=0.9)``, not torch's: the
forward takes the running statistics as an argument and returns updated
ones, ``0.9 * old + 0.1 * batch`` with the batch's biased variance, and
never writes the module's buffers (``set_running_stats`` does). A step can
so thread them through several calls (the discriminator step: real, then
fake) or discard them (the generator step). ``ActNorm`` starts at loc 0,
scale 1, as the JAX module does (taming initialises it from the first batch).
Across ranks (parallel/dist.py) the batch statistics are the global
batch's, summed over ranks with their gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stedm_tpu_torch.parallel import dist

_BN_EPS, _BN_MOMENTUM = 1e-5, 0.9


class ActNorm(nn.Module):
    """Per-channel ``(x + loc) * scale`` (taming ActNorm, logdet-free path)."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, channels, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.register_buffer("initialized", torch.tensor(1, dtype=torch.uint8))

    def forward(self, x):
        return (x + self.loc) * self.scale


def _init_conv(conv: nn.Conv2d) -> nn.Conv2d:
    """taming ``weights_init``: N(0, 0.02) kernels (biases zero, as flax's)."""
    nn.init.normal_(conv.weight, 0.0, 0.02)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
    return conv


class NLayerDiscriminator(nn.Module):
    """``[B, H, W, input_nc]`` -> ``[B, H', W', 1]`` fp32 patch logits."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        super().__init__()
        self.use_actnorm = use_actnorm
        layers = [_init_conv(nn.Conv2d(input_nc, ndf, 4, 2, 1)), nn.LeakyReLU(0.2)]
        ch = ndf
        for n in range(1, n_layers + 1):
            out = ndf * min(2 ** n, 8)
            layers.append(_init_conv(nn.Conv2d(ch, out, 4, 2 if n < n_layers else 1, 1,
                                               bias=use_actnorm)))
            if use_actnorm:
                layers.append(ActNorm(out))
            else:
                bn = nn.BatchNorm2d(out, eps=_BN_EPS)
                nn.init.normal_(bn.weight, 1.0, 0.02)
                layers.append(bn)
            layers.append(nn.LeakyReLU(0.2))
            ch = out
        layers.append(_init_conv(nn.Conv2d(ch, 1, 4, 1, 1)))
        self.main = nn.Sequential(*layers)

    def _norms(self) -> list[nn.BatchNorm2d]:
        return [m for m in self.main if isinstance(m, nn.BatchNorm2d)]

    def running_stats(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The BatchNorm layers' running (mean, var), in order (copies)."""
        return [(bn.running_mean.clone(), bn.running_var.clone()) for bn in self._norms()]

    @torch.no_grad()
    def set_running_stats(self, stats) -> None:
        for bn, (mean, var) in zip(self._norms(), stats, strict=True):
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)

    def forward(self, x: torch.Tensor, stats=None):
        """Logits of NHWC ``x`` with batch statistics, and the running
        statistics updated from ``stats`` (default: the module's buffers) as
        flax updates them; the buffers are left as they are."""
        if stats is None:
            stats = self.running_stats()
        h = x.float().permute(0, 3, 1, 2)
        new, norms = [], iter(stats)
        for layer in self.main:
            if isinstance(layer, nn.BatchNorm2d):
                mean, var = next(norms)
                if dist.world_size() == 1:
                    flat = h.detach().transpose(0, 1).reshape(h.shape[1], -1)
                    b_mean = flat.mean(1)
                    b_var = (flat.square().mean(1) - b_mean.square()).clamp(min=0)
                    h_next = F.batch_norm(h, None, None, layer.weight, layer.bias,
                                          training=True, eps=layer.eps)
                else:   # the global batch's statistics, summed over ranks with gradients
                    b_mean, b_var = dist.batch_moments(h, (0, 2, 3))
                    scale = torch.rsqrt(b_var + layer.eps) * layer.weight
                    h_next = (h - b_mean[None, :, None, None]) * scale[None, :, None, None] \
                        + layer.bias[None, :, None, None]
                    b_mean, b_var = b_mean.detach(), b_var.detach()
                new.append((_BN_MOMENTUM * mean + (1 - _BN_MOMENTUM) * b_mean,
                            _BN_MOMENTUM * var + (1 - _BN_MOMENTUM) * b_var))
                h = h_next
            else:
                h = layer(h)
        return h.permute(0, 2, 3, 1), new
