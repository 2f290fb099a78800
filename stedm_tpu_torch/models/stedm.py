"""The composite style-extracting latent diffusion model (stedm_tpu/models/stedm.py:46-178).

Sub-modules mirror the JAX parameter tree's top level: ``unet``,
``first_stage`` (the frozen VQ-f4 codec), ``cond_stage`` (SpatialRescaler)
and ``agg`` (Swin-V2-T + aggregation, or the set-ViT). All methods take and
return NHWC.

``conditioning_key`` (stedm_tpu stedm.py:120-135): ``hybrid`` concatenates
the layout to the noisy latent and hands the style to the U-Net as its
context, ``concat`` the layout only, ``crossattn`` the style only, ``none``
neither, and ``adm`` passes the style as the U-Net's class labels ``y``
(which a U-Net with ``num_classes`` refuses, the style being a float vector,
and one without ignores, as there). Where the layout is not concatenated,
the U-Net's first conv takes the latent's channels (``embed_dim``), the
width flax infers from the input.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from stedm_tpu_torch._device import resolve_device
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.models.agg import AggLinear, AggMax, AggMean, AggNone
from stedm_tpu_torch.models.cond import SpatialRescaler
from stedm_tpu_torch.models.svit import SViT
from stedm_tpu_torch.models.swin import swin_v2_tiny
from stedm_tpu_torch.models.unet import UNet
from stedm_tpu_torch.models.vq import VQModelInterface


CONDITIONING_KEYS = ("hybrid", "concat", "crossattn", "adm", "none", None)


class STEDM(nn.Module):
    def __init__(self, unet_config: dict, first_stage_config: dict,
                 cond_stage_config: dict, style_agg: str = "linear",
                 style_sampling: str = "nearby", num_style_patches: int = 1,
                 patch_size: int = 512, svit_config: dict | None = None,
                 scale_factor: float = 1.0, conditioning_key: str = "hybrid",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if conditioning_key not in CONDITIONING_KEYS:
            raise ValueError(f"unknown conditioning_key {conditioning_key!r}")
        self.scale_factor, self.conditioning_key = scale_factor, conditioning_key
        self.patch_size, self.dtype = patch_size, dtype
        if conditioning_key not in ("hybrid", "concat"):
            unet_config = {**unet_config, "in_channels": first_stage_config["embed_dim"]}
        self.unet = UNet(dtype=dtype, **unet_config)
        self.first_stage = VQModelInterface(dtype=dtype, **first_stage_config)
        self.cond_stage = SpatialRescaler(dtype=dtype, **cond_stage_config)
        if style_sampling == "none":
            self.agg = AggNone()
        elif style_agg == "svit":   # stedm_tpu stedm.py:75-80
            svit_args = {k: v for k, v in dict(svit_config or {}).items() if k != "name"}
            self.agg = SViT(image_size=patch_size, num_classes=512, ns=num_style_patches,
                            dtype=dtype, **svit_args)
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

    def style_encode(self, style_imgs: torch.Tensor, train: bool = False,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """Style set ``[B, N, P, P, 3]`` -> the 512-d style vector; ``train``
        turns on the set-ViT's dropout, drawn from ``generator``."""
        if isinstance(self.agg, SViT):
            return self.agg(style_imgs, train=train, generator=generator)
        return self.agg(style_imgs)

    @property
    def bottleneck_only(self) -> bool:
        """The style enters only at the bottleneck, so CFG's two branches can
        share the encoder (stedm_tpu steps.py:178, :319): hybrid
        conditioning without the spatial transformer."""
        return self.conditioning_key == "hybrid" and not self.unet.use_spatial_transformer

    def eps(self, z_noisy: torch.Tensor, t: torch.Tensor, seg_cond: torch.Tensor,
            style: torch.Tensor, train: bool = False,
            generator: torch.Generator | None = None) -> torch.Tensor:
        """The conditioning dispatch (stedm_tpu stedm.py:119-135; see the
        module docstring). ``train``: the U-Net's dropout drawn from
        ``generator``."""
        key = self.conditioning_key
        x = z_noisy.to(self.dtype)
        if key in ("hybrid", "concat"):
            x = torch.cat([x, seg_cond.to(self.dtype)], dim=-1)
        kw = ({"context": style} if key in ("hybrid", "crossattn")
              else {"y": style} if key == "adm" else {})
        out = self.unet(x.permute(0, 3, 1, 2), t, train=train, generator=generator, **kw)
        return out.permute(0, 2, 3, 1).float()

    def _check_caching(self) -> None:
        if self.conditioning_key not in ("hybrid", "concat"):
            raise ValueError("deep-feature caching requires hybrid/concat conditioning")

    def eps_full(self, z_noisy: torch.Tensor, t: torch.Tensor, seg_cond: torch.Tensor,
                 style: torch.Tensor, cache_levels: int = 1):
        """Full eps plus the deep-feature cache of the serving mode (stedm_tpu
        stedm.py:137-151); the cache is NCHW channels_last."""
        self._check_caching()
        x = torch.cat([z_noisy.to(self.dtype), seg_cond.to(self.dtype)], dim=-1)
        ctx = style if self.conditioning_key == "hybrid" else None
        out, cache = self.unet(x.permute(0, 3, 1, 2), t, context=ctx, return_cache=True,
                               cache_levels=cache_levels)
        return out.permute(0, 2, 3, 1).float(), cache

    def eps_cached(self, z_noisy: torch.Tensor, t: torch.Tensor, seg_cond: torch.Tensor,
                   cache: torch.Tensor, cache_levels: int = 1) -> torch.Tensor:
        """Shallow eps reusing a cache from ``eps_full`` (stedm_tpu
        stedm.py:153-163); a CFG fan-out rides in through the cache's batch."""
        self._check_caching()
        x = torch.cat([z_noisy.to(self.dtype), seg_cond.to(self.dtype)], dim=-1)
        out = self.unet(x.permute(0, 3, 1, 2), t, cache=cache, cache_levels=cache_levels)
        return out.permute(0, 2, 3, 1).float()


_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_stedm(cfg, device=None, seed: int = 0) -> STEDM:
    """The composite model of a composed config (stedm_tpu/models/stedm.py:181-213),
    its weights initialised from ``seed``, in eval mode.

    As the JAX function does, it ignores each sub-config's ``target`` and
    ``unet_config.params.image_size``, maps ``diffusion.compute_dtype`` and
    takes ``num_style_patches`` from ``style_sampling`` (``mp`` only) and,
    for ``style_agg: svit``, the set-ViT's keys from ``style_agg`` (all but
    ``name``). The first stage's ``ckpt_path`` is dropped, as there: the
    entry points load it. The layout mapper is two channels wide, the width
    of the one-hot the entry points feed, as flax takes it from the init
    batch; the config's ``cond_stage_config.params.in_channels`` is not
    read, as there. The U-Net and the codec raise on a key the JAX modules
    do not take. Runs on ``cuda`` unless ``device`` says otherwise
    (``"meta"`` builds the structure only)."""
    diff = cfg.diffusion
    dtype = _COMPUTE_DTYPES[diff.get("compute_dtype", "float32")]
    sampling = cfg.style_sampling
    num_patches = sampling.get("num_patches", 1) if sampling.name == "mp" else 1
    style_agg = cfg.style_agg.name if cfg.get("style_agg") else "linear"
    svit_cfg = ({k: v for k, v in dict(cfg.style_agg).items() if k != "name"}
                if style_agg == "svit" else None)
    fs_params = {k: v for k, v in dict(diff.first_stage_config.params).items()
                 if k != "ckpt_path"}
    dev = resolve_device(device)
    cuda_devs = [dev.index or 0] if dev.type == "cuda" else []
    # the layout's width on the entry points: the one-hot collapsed to
    # background vs any foreground (train_diff.batch_to_ldm, predict's
    # two-class layouts), the width the JAX entry points initialise the model
    # on (train_diff.py:87-91)
    cond_stage_config = {**diff.cond_stage_config.params, "in_channels": 2}
    with torch.random.fork_rng(devices=cuda_devs), torch.device(dev):
        torch.manual_seed(seed)
        return STEDM(unet_config=dict(diff.unet_config.params),
                     first_stage_config=fs_params,
                     cond_stage_config=cond_stage_config,
                     style_agg=style_agg, style_sampling=sampling.name,
                     num_style_patches=num_patches, patch_size=cfg.data.patch_size,
                     svit_config=svit_cfg,
                     scale_factor=diff.get("scale_factor", 1.0),
                     conditioning_key=diff.get("conditioning_key", "hybrid"),
                     dtype=dtype).eval()


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
                   seed: int = 0, patch: int = FLAGSHIP_PATCH, nonzero_init: bool = False,
                   unet_options: dict | None = None):
    """Flagship model with random weights from ``seed``, a bench batch and the
    schedule, mirroring bench.py:190-227: bf16 compute, fp32 parameters and
    GroupNorm statistics, and +0.005 on every 4-D parameter (the zero-init
    output convs would otherwise make the CFG rescale divide 0 by 0).

    ``nonzero_init`` first gives the zero-initialised layers (every
    ``AttentionBlock.proj_out``, the ResBlock output convs and the U-Net
    ``out`` conv) PyTorch's default random init, as a training run needs: a
    zero ``proj_out`` makes the gradient reaching the attention exactly zero.

    ``unet_options``: U-Net keywords added to the landscape config (e.g.
    ``use_scale_shift_norm``, ``num_head_channels``).

    Runs on ``cuda`` unless ``device`` says otherwise (``"meta"`` builds the
    structure only). Returns ``(model, batch_dict, schedule)``; the batch is
    NHWC: an all-background one-hot layout, uniform(-1, 1) style images and
    then uniform(-1, 1) images (``image``, for training), drawn with numpy
    from ``seed``."""
    dev = resolve_device(device)
    cuda_devs = [dev.index or 0] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda_devs), torch.device(dev):
        torch.manual_seed(seed)
        cfg = flagship_configs(patch)
        cfg["unet_config"].update(unet_options or {})
        model = STEDM(dtype=dtype, **cfg).eval()
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
