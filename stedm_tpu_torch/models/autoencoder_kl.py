"""KL-regularised autoencoder (stedm_tpu/models/autoencoder_kl.py).

``AutoencoderKL`` is the VQ codec's encoder with ``double_z`` (mean and
log-variance of a diagonal Gaussian), ``quant_conv`` to ``2 * embed_dim``
moments, and the VQ decoder; ``DiagonalGaussian`` holds the posterior. Images
and latents are NHWC, as in the JAX package. Sampling takes its standard
normal ``noise`` from the caller (the JAX package draws it from a key), so a
test can hand both sides the same draw.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from stedm_tpu_torch.models.layers import channels_last, conv1x1
from stedm_tpu_torch.models.vq import VQDecoder, VQEncoder, codec_args


class DiagonalGaussian:
    """Moments over a ``[..., 2 z]`` channel split, fp32, log-variance clipped
    to [-30, 20] (stedm_tpu autoencoder_kl.py:22-68)."""

    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        self.parameters = parameters
        self.mean, logvar = parameters.float().chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.deterministic = deterministic
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        if self.deterministic:
            return self.mean
        return self.mean + self.std * noise.to(self.mean)

    def mode(self) -> torch.Tensor:
        return self.mean

    def _axes(self):
        return tuple(range(1, self.mean.dim()))

    def kl(self, other: "DiagonalGaussian | None" = None) -> torch.Tensor:
        """Per-sample KL divergence to N(0, I) or to ``other``."""
        if self.deterministic:
            return torch.zeros((), device=self.mean.device)
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar,
                                   dim=self._axes())
        return 0.5 * torch.sum((self.mean - other.mean) ** 2 / other.var
                               + self.var / other.var - 1.0 - self.logvar + other.logvar,
                               dim=self._axes())

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros((), device=self.mean.device)
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean) ** 2 / self.var, dim=self._axes())


class AutoencoderKL(nn.Module):
    """(stedm_tpu autoencoder_kl.py:71-125) with the VQ codec's module names
    (``encoder``, ``decoder``, ``quant_conv``, ``post_quant_conv``).
    ``ddconfig`` takes the shipped keys: ``double_z`` must be true;
    ``dropout`` is never drawn, as in the JAX codec (``VQEncoder``)."""

    def __init__(self, embed_dim: int = 4, ddconfig: dict | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        enc, dec = codec_args(ddconfig, double_z=True)
        # without a z_channels key the JAX module's encoder keeps its default
        # (3) and its post_quant_conv makes 4 channels for the decoder
        z_ch = dict(ddconfig or {}).get("z_channels", 4)
        dec["z_channels"] = z_ch
        self.dtype, self.embed_dim = dtype, embed_dim
        self.encoder = VQEncoder(**enc)
        self.decoder = VQDecoder(**dec)
        self.quant_conv = conv1x1(2 * enc.get("z_channels", 3), 2 * embed_dim)
        self.post_quant_conv = conv1x1(embed_dim, z_ch)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Image -> the ``[..., 2 embed_dim]`` Gaussian moments (NHWC)."""
        h = channels_last(x.permute(0, 3, 1, 2).to(self.dtype))
        return self.quant_conv(self.encoder(h)).permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        q = channels_last(z.permute(0, 3, 1, 2).to(self.dtype))
        return self.decoder(self.post_quant_conv(q)).permute(0, 2, 3, 1)

    def latent_shape(self, image_shape) -> tuple[int, ...]:
        """The posterior sample's NHWC shape for NHWC images of this shape."""
        f = 2 ** (len(self.decoder.up) - 1)
        b, h, w, _ = image_shape
        return (b, h // f, w // f, self.embed_dim)

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None) -> torch.Tensor:
        dist = DiagonalGaussian(self.encode(x), deterministic=noise is None)
        return self.decode(dist.mode() if noise is None else dist.sample(noise))

    def training_recon(self, x: torch.Tensor, noise: torch.Tensor):
        """The KL training forward (stedm_tpu autoencoder_kl.py:113-120): the
        posterior sampled with ``noise`` (standard normal, the moments' shape
        halved), decoded; returns ``(reconstruction, posterior)``."""
        posterior = DiagonalGaussian(self.encode(x))
        return self.decode(posterior.sample(noise)), posterior
