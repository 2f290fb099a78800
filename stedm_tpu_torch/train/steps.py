"""Train and sample steps of the diffusion model (stedm_tpu/train/steps.py).

``make_train_step`` (steps.py:36-142) returns ``train_step(state, batch,
generator=None, *, t=None, noise=None)``: frozen VQ encode, layout and style
encoding (the style gradient cut for constant style sets), the denoising
loss through the U-Net, backward, the optimizer's micro-batch update
(AdamW every k-th call) and the EMA of the U-Net. The port's state lives in
the model and in ``TrainState`` and is updated in place; the step returns
``(state, metrics)`` as the JAX step does.

``make_sample_fn`` returns ``sample(model, batch, x_T=None, generator=None)``
producing images in [-1, 1], NHWC ``[B, P, P, 3]`` (steps.py:146-167,
:258-446), exact DDIM. The unconditional branch uses the same layout with
dropped (constant -2) style images. Ported branches: no CFG; shared-encoder
batched CFG (the style enters only at the bottleneck, so the encoder runs
once at batch B and the bottleneck and decoder fan out over cond/uncond);
batched CFG without sharing; two calls.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from stedm_tpu_torch._device import resolve_device
from stedm_tpu_torch.core.ddim import DDIMParams, ddim_sample
from stedm_tpu_torch.core.diffusion import p_losses
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.train.ema import ema_update
from stedm_tpu_torch.train.optim import Optimizer, OptState


@dataclasses.dataclass
class TrainState:
    """What the JAX ``TrainState`` carries besides the parameters, which live
    in ``model``: the optimizer and its state, the EMA shadow of the U-Net
    (fp32, keyed like ``model.unet.named_parameters()``), the counters, and
    the learned ``logvar`` when there is one."""

    model: torch.nn.Module
    tx: Optimizer
    opt_state: OptState
    ema_params: dict[str, torch.Tensor]
    ema_updates: int = 0
    step: int = 0
    logvar: torch.nn.Parameter | None = None


def create_train_state(model: torch.nn.Module, tx: Optimizer,
                       logvar: torch.nn.Parameter | None = None) -> TrainState:
    """Freeze the frozen groups, build the optimizer over the rest and copy
    the U-Net into the EMA shadow. The groups are the JAX tree's top level:
    ``unet``, ``first_stage``, ``cond_stage``, ``agg`` and, when given,
    ``logvar``."""
    groups = {name: list(child.parameters()) for name, child in model.named_children()}
    if logvar is not None:
        groups["logvar"] = [logvar]
    opt_state = tx.init(groups)
    ema = {n: p.detach().float().clone() for n, p in model.unet.named_parameters()}
    return TrainState(model=model, tx=tx, opt_state=opt_state, ema_params=ema,
                      logvar=logvar)


def init_logvar(num_timesteps: int, logvar_init: float = 0.0,
                device=None) -> torch.nn.Parameter:
    """The per-timestep log-variance as a trainable group (stedm_tpu
    steps.py:56-61); pass it to ``create_train_state``."""
    return torch.nn.Parameter(torch.full((num_timesteps,), float(logvar_init),
                                         dtype=torch.float32, device=resolve_device(device)))


def compute_scale_by_std(model: torch.nn.Module, images: torch.Tensor) -> float:
    """``1 / std(z)`` over the encoded first batch (stedm_tpu
    steps.py:64-73); the caller sets ``model.scale_factor`` to it."""
    if float(model.scale_factor) != 1.0:
        raise ValueError("rather not use custom rescaling and std-rescaling "
                         "simultaneously (reference ddpm.py:483)")
    z = model.encode_first_stage(images)
    return float(1.0 / z.std(unbiased=False))


def make_train_step(model: torch.nn.Module, schedule: DiffusionSchedule, tx: Optimizer, *,
                    loss_type: str = "l1", use_ema: bool = True,
                    learn_logvar: bool = False, logvar_init: float = 0.0,
                    device=None) -> Callable:
    """Build the train step; it runs on ``cuda`` unless ``device`` says
    otherwise, and the model must already live there.

    ``batch``: ``image`` [B,P,P,3], ``segmentation`` [B,P,P,2] one-hot,
    ``style_imgs`` [B,N,P,P,3] (style drop already applied). t and the noise
    are drawn from ``generator`` (t first), unless ``t`` and ``noise`` are
    given. ``learn_logvar``: the state's ``logvar`` receives gradients;
    otherwise a static buffer of ``logvar_init`` (None when 0)."""
    dev = resolve_device(device)
    n_t = schedule.num_timesteps
    static_logvar = (torch.full((n_t,), float(logvar_init), dtype=torch.float32, device=dev)
                     if logvar_init else None)

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None = None,
                   *, t: torch.Tensor | None = None, noise: torch.Tensor | None = None):
        param_dev = next(model.parameters()).device
        if param_dev.type != dev.type:
            raise ValueError(f"model lives on {param_dev}, the train step on {dev}")
        if learn_logvar and state.logvar is None:
            raise ValueError("learn_logvar needs a state made with init_logvar")
        image, seg, style_imgs = (torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
                                  for k in ("image", "segmentation", "style_imgs"))
        z = model.encode_first_stage(image)
        seg_cond = model.cond_encode(seg)
        style = model.style_encode(style_imgs)
        # constant style sets (the style-drop fill) make every LayerNorm of
        # the style encoder see zero variance, and its backward overflows;
        # their style vector passes through without a gradient (steps.py:104-113)
        s = style_imgs.reshape(style.shape[0], -1)
        constant = (s.amax(dim=1) - s.amin(dim=1)) < 1e-6
        style = torch.where(constant[:, None], style.detach(), style)
        if t is None:
            t = torch.randint(0, n_t, (z.shape[0],), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(z.shape, generator=generator, device=dev)
        t = torch.as_tensor(t, dtype=torch.long, device=dev)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)

        def eps_fn(z_noisy, t_):
            return model.eps(z_noisy, t_, seg_cond, style)

        logvar = state.logvar if learn_logvar else static_logvar
        loss, aux = p_losses(eps_fn, schedule, z, t, noise, loss_type=loss_type,
                             logvar=logvar)
        loss.backward()
        state.tx.update(state.opt_state)
        if use_ema:
            # every micro-batch, like the reference (ldm_diffusion.py:114-115)
            state.ema_updates = ema_update(state.ema_params, dict(model.unet.named_parameters()),
                                           state.ema_updates)
        state.step += 1
        metrics = {k: aux[k].detach() for k in ("loss", "loss_simple", "loss_vlb")}
        return state, metrics

    return train_step


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    ddim_steps: int = 128
    eta: float = 0.0
    cfg_scale: float = 1.5
    rescale_phi: float = 0.7
    batched_cfg: bool = True
    use_cfg: bool = True          # False when cfg_scale==1 or style_sampling==none
    latent_channels: int = 3
    downsample: int = 4           # VQ-f4
    method: str = "ddim"          # ddim | plms | dpm
    cache_interval: int = 1       # >1: deep-feature reuse (serving mode)
    cache_schedule: tuple = None
    cfg_interval: tuple = None    # (lo_frac, hi_frac) guidance window


def _check_ported(cfg: SamplerConfig) -> None:
    if cfg.method != "ddim":
        raise NotImplementedError(f"method={cfg.method!r} (PLMS, DPM-Solver) comes "
                                  "with the samplers slice")
    if cfg.cache_interval > 1 or cfg.cache_schedule is not None:
        raise NotImplementedError("deep-feature caching comes with the serving slice")
    if cfg.cfg_interval is not None:
        raise NotImplementedError("the guidance window comes with the serving slice")


def make_sample_fn(model, schedule: DiffusionSchedule, cfg: SamplerConfig,
                   device=None) -> Callable:
    """Build the sampler; it runs on ``cuda`` unless ``device`` says otherwise,
    and the model must already live there."""
    _check_ported(cfg)
    dev = resolve_device(device)
    ddim = DDIMParams.create(schedule, cfg.ddim_steps, cfg.eta)
    use_cfg = cfg.use_cfg and cfg.cfg_scale != 1.0
    bottleneck_only = model.conditioning_key == "hybrid"

    @torch.inference_mode()
    def sample(model, batch: dict, x_T: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        param_dev = next(model.parameters()).device
        if param_dev.type != dev.type or (dev.index is not None and param_dev != dev):
            raise ValueError(f"model lives on {param_dev}, the sampler on {dev}")
        seg = torch.as_tensor(batch["segmentation"], dtype=torch.float32, device=dev)
        style_imgs = torch.as_tensor(batch["style_imgs"], dtype=torch.float32,
                                     device=dev)
        b, p = seg.shape[0], seg.shape[1]
        if p > model.patch_size:
            raise NotImplementedError("tiled canvases come in a later slice")
        seg_cond = model.cond_encode(seg)
        style_c = model.style_encode(style_imgs)

        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if x_T is None:
            latent = (b, p // cfg.downsample, p // cfg.downsample, cfg.latent_channels)
            x_T = torch.randn(latent, generator=generator, device=dev)
        x_T = torch.as_tensor(x_T, dtype=torch.float32, device=dev)

        if not use_cfg:
            def eps_fn(x, t):
                return model.eps(x, t, seg_cond, style_c)
        else:
            style_u = model.style_encode(torch.zeros_like(style_imgs) - 2.0)
            if cfg.batched_cfg and bottleneck_only:
                ctx2 = torch.cat([style_c, style_u])

                def eps_fn(x, t):
                    e = model.eps(x, t, seg_cond, ctx2)
                    return e[:b], e[b:]
            elif cfg.batched_cfg:
                seg2 = torch.cat([seg_cond, seg_cond])
                ctx2 = torch.cat([style_c, style_u])

                def eps_fn(x, t):
                    e = model.eps(torch.cat([x, x]), torch.cat([t, t]), seg2, ctx2)
                    return e[:b], e[b:]
            else:
                def eps_fn(x, t):
                    return (model.eps(x, t, seg_cond, style_c),
                            model.eps(x, t, seg_cond, style_u))

        z_0 = ddim_sample(eps_fn, x_T, ddim, cfg_scale=cfg.cfg_scale if use_cfg else 1.0,
                          rescale_phi=cfg.rescale_phi,
                          generator=generator if cfg.eta > 0 else None)
        return torch.clamp(model.decode_first_stage(z_0), -1.0, 1.0)

    return sample
