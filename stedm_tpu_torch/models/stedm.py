"""The composite style-extracting latent diffusion model (stedm_tpu/models/stedm.py:46-178).

Sub-modules mirror the JAX parameter tree's top level: ``unet``,
``first_stage`` (the frozen VQ-f4 codec), ``cond_stage`` (SpatialRescaler)
and ``agg`` (Swin-V2-T + aggregation). All methods take and return NHWC.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from stedm_tpu_torch._device import resolve_device
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.models.agg import AggLinear, AggMax, AggMean, AggNone
from stedm_tpu_torch.models.cond import SpatialRescaler
from stedm_tpu_torch.models.swin import swin_v2_tiny
from stedm_tpu_torch.models.unet import UNet
from stedm_tpu_torch.models.vq import VQModelInterface


class STEDM(nn.Module):
    def __init__(self, unet_config: dict, first_stage_config: dict,
                 cond_stage_config: dict, style_agg: str = "linear",
                 style_sampling: str = "nearby", num_style_patches: int = 1,
                 patch_size: int = 512, scale_factor: float = 1.0,
                 conditioning_key: str = "hybrid", dtype: torch.dtype = torch.float32):
        super().__init__()
        if conditioning_key not in ("hybrid", "concat"):
            raise NotImplementedError(f"conditioning_key={conditioning_key!r} comes "
                                      "in a later slice")
        self.scale_factor, self.conditioning_key = scale_factor, conditioning_key
        self.patch_size, self.dtype = patch_size, dtype
        self.unet = UNet(dtype=dtype, **unet_config)
        self.first_stage = VQModelInterface(dtype=dtype, **first_stage_config)
        self.cond_stage = SpatialRescaler(dtype=dtype, **cond_stage_config)
        if style_sampling == "none":
            self.agg = AggNone()
        else:
            emb = swin_v2_tiny(512, dtype=dtype)
            blocks = {"linear": lambda: AggLinear(emb, num_style_patches),
                      "max": lambda: AggMax(emb), "mean": lambda: AggMean(emb)}
            if style_agg not in blocks:
                raise NotImplementedError(f"style_agg={style_agg!r} is not ported")
            self.agg = blocks[style_agg]()

    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        """Image -> scaled pre-quant latent, without gradient: the frozen codec
        runs under ``no_grad`` and the latent is detached, as the reference's
        ``stop_gradient`` (stedm_tpu stedm.py:94-98)."""
        with torch.no_grad():
            z = self.first_stage.encode(x)
            return (self.scale_factor * z.float()).detach()

    def decode_first_stage(self, z: torch.Tensor, force_not_quantize: bool = False):
        """Latent -> image (stedm_tpu stedm.py:100-104)."""
        return self.first_stage.decode(z.float() / self.scale_factor, force_not_quantize)

    def cond_encode(self, seg_onehot: torch.Tensor) -> torch.Tensor:
        return self.cond_stage(seg_onehot)

    def style_encode(self, style_imgs: torch.Tensor) -> torch.Tensor:
        return self.agg(style_imgs)

    def eps(self, z_noisy: torch.Tensor, t: torch.Tensor, seg_cond: torch.Tensor,
            style: torch.Tensor) -> torch.Tensor:
        """Layout channel-concatenated to the noisy latent; in 'hybrid' mode
        the style rides the U-Net context (stedm_tpu stedm.py:119-135)."""
        x = torch.cat([z_noisy.to(self.dtype), seg_cond.to(self.dtype)], dim=-1)
        ctx = style if self.conditioning_key == "hybrid" else None
        out = self.unet(x.permute(0, 3, 1, 2), t, context=ctx)
        return out.permute(0, 2, 3, 1).float()


FLAGSHIP_PATCH = 256


def flagship_configs(patch: int = FLAGSHIP_PATCH) -> dict:
    """The landscape-config flagship of bench.py:199-212 at ``patch``² (256 for
    sampling, 512 for training as tools/bench_train.py runs it)."""
    return dict(
        unet_config=dict(in_channels=6, out_channels=3, model_channels=128,
                         num_res_blocks=2, channel_mult=(1, 4, 8), num_heads=8,
                         attention_resolutions=(32, 16, 8)),
        first_stage_config=dict(embed_dim=3, n_embed=8192, ddconfig=dict(
            double_z=False, z_channels=3, resolution=patch, in_channels=3, out_ch=3,
            ch=128, ch_mult=[1, 2, 4], num_res_blocks=2, attn_resolutions=[],
            dropout=0.0)),
        cond_stage_config=dict(n_stages=2, in_channels=2, out_channels=3),
        style_agg="mean", style_sampling="nearby", patch_size=patch)


def build_flagship(batch: int = 8, device=None, dtype: torch.dtype = torch.bfloat16,
                   seed: int = 0, patch: int = FLAGSHIP_PATCH, nonzero_init: bool = False):
    """Flagship model with random weights from ``seed``, a bench batch and the
    schedule, mirroring bench.py:190-227: bf16 compute, fp32 parameters and
    GroupNorm statistics, and +0.005 on every 4-D parameter (the zero-init
    output convs would otherwise make the CFG rescale divide 0 by 0).

    ``nonzero_init`` first gives the zero-initialised layers (every
    ``AttentionBlock.proj_out``, the ResBlock output convs and the U-Net
    ``out`` conv) PyTorch's default random init, as a training run needs: a
    zero ``proj_out`` makes the gradient reaching the attention exactly zero.

    Runs on ``cuda`` unless ``device`` says otherwise (``"meta"`` builds the
    structure only). Returns ``(model, batch_dict, schedule)``; the batch is
    NHWC: an all-background one-hot layout, uniform(-1, 1) style images and
    then uniform(-1, 1) images (``image``, for training), drawn with numpy
    from ``seed``."""
    dev = resolve_device(device)
    cuda_devs = [dev.index or 0] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda_devs), torch.device(dev):
        torch.manual_seed(seed)
        model = STEDM(dtype=dtype, **flagship_configs(patch)).eval()
        if nonzero_init:
            for layer in model.unet.zero_init_layers():
                layer.reset_parameters()
    with torch.no_grad():
        for prm in model.parameters():
            if prm.dim() == 4:
                prm.add_(0.005)
    seg = torch.zeros((batch, patch, patch, 2), device=dev)
    seg[..., 0] = 1.0
    rng = np.random.default_rng(seed)
    style = rng.uniform(-1, 1, (batch, 1, patch, patch, 3))
    image = rng.uniform(-1, 1, (batch, patch, patch, 3))
    batch_dict = {"segmentation": seg,
                  "style_imgs": torch.as_tensor(style, dtype=torch.float32).to(dev),
                  "image": torch.as_tensor(image, dtype=torch.float32).to(dev)}
    schedule = DiffusionSchedule.create("linear", 1000, 0.0015, 0.0205)
    return model, batch_dict, schedule
