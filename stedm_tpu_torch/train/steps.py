"""Train and sample steps of the diffusion model (stedm_tpu/train/steps.py).

``make_train_step`` (steps.py:36-142) returns ``train_step(state, batch,
generator=None, *, t=None, noise=None)``: frozen VQ encode, layout and style
encoding (the style gradient cut for constant style sets), the denoising
loss through the U-Net, backward, the optimizer's micro-batch update
(AdamW every k-th call) and the EMA of the U-Net. The port's state lives in
the model and in ``TrainState`` and is updated in place; the step returns
``(state, metrics)`` as the JAX step does.

``make_sample_fn`` returns ``sample(model, batch, x_T=None, generator=None)``
producing images in [-1, 1], NHWC ``[B, P, P, 3]`` (steps.py:146-446) with
DDIM, PLMS or DPM-Solver++(2M). The unconditional branch uses the same
layout with dropped (constant -2) style images. CFG modes: none;
shared-encoder batched CFG (the style enters only at the bottleneck, so the
encoder runs once at batch B and the bottleneck and decoder fan out over
cond/uncond); batched CFG without sharing; two calls. The serving mode's
knobs, alone or composed: deep-feature reuse every ``cache_interval`` steps
or on the refresh positions ``cache_schedule``, at ``cache_levels``, and a
guidance window ``cfg_interval``. A layout larger than the model's patch is
a canvas (exact DDIM only, steps.py:170-255): every eps evaluation and the
decode run over overlapping latent tiles stitched with a triangle window
(``ops/tiled.py``), the CFG pair packed in the channel axis under the
shared-encoder fan-out.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from stedm_tpu_torch._device import resolve_device
from stedm_tpu_torch.core.ddim import (
    DDIMParams,
    ddim_sample,
    ddim_sample_guided,
    ddim_sample_scheduled_guided,
    guided_range,
    serving_refresh,
)
from stedm_tpu_torch.core.diffusion import p_losses
from stedm_tpu_torch.core.dpm_solver import dpm_solver_pp_sample
from stedm_tpu_torch.core.plms import plms_sample
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.ops.tiled import tiled_apply
from stedm_tpu_torch.parallel import dist
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
    steps.py:64-73); the caller sets ``model.scale_factor`` to it. Across
    ranks ``images`` are this rank's rows and the std is the global
    batch's."""
    if float(model.scale_factor) != 1.0:
        raise ValueError("rather not use custom rescaling and std-rescaling "
                         "simultaneously (reference ddpm.py:483)")
    z = model.encode_first_stage(images).double()
    # the moments in float64, summed over every rank's rows
    n = z.numel() * dist.world_size()
    s = dist.all_reduce_sum(torch.stack([z.sum(), z.square().sum()]))
    mean = s[0] / n
    return float(1.0 / torch.sqrt(s[1] / n - mean * mean).float())


def make_train_step(model: torch.nn.Module, schedule: DiffusionSchedule, tx: Optimizer, *,
                    loss_type: str = "l1", use_ema: bool = True,
                    learn_logvar: bool = False, logvar_init: float = 0.0,
                    device=None) -> Callable:
    """Build the train step; it runs on ``cuda`` unless ``device`` says
    otherwise, and the model must already live there.

    ``batch``: ``image`` [B,P,P,3], ``segmentation`` [B,P,P,2] one-hot,
    ``style_imgs`` [B,N,P,P,3] (style drop already applied). t and the noise
    are drawn from ``generator`` (t first), unless ``t`` and ``noise`` are
    given; then the set-ViT's dropout (``style_agg: svit``), then the
    U-Net's ResBlock dropout (``unet_config.params.dropout``), neither of
    which the JAX step can draw (ROADMAP §3). ``learn_logvar``: the state's ``logvar``
    receives gradients; otherwise a static buffer of ``logvar_init`` (None
    when 0)."""
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
        # across ranks, each rank keeps its rows of the global batch's draws
        # (parallel/dist.py:rank_rows), as one process draws them
        if t is None:
            t = dist.rank_rows(lambda shape, **kw: torch.randint(0, n_t, shape, **kw),
                               (z.shape[0],), generator=generator, device=dev)
        if noise is None:
            noise = dist.rank_rows(torch.randn, z.shape, generator=generator, device=dev)
        seg_cond = model.cond_encode(seg)
        # the set-ViT's dropout draws from the generator after t and noise
        style = model.style_encode(style_imgs, train=True, generator=generator)
        # constant style sets (the style-drop fill) make every LayerNorm of
        # the style encoder see zero variance, and its backward overflows;
        # their style vector passes through without a gradient (steps.py:104-113)
        s = style_imgs.reshape(style.shape[0], -1)
        constant = (s.amax(dim=1) - s.amin(dim=1)) < 1e-6
        style = torch.where(constant[:, None], style.detach(), style)
        t = torch.as_tensor(t, dtype=torch.long, device=dev)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)

        def eps_fn(z_noisy, t_):
            # the U-Net's dropout draws from the generator after the set-ViT's
            return model.eps(z_noisy, t_, seg_cond, style, train=True, generator=generator)

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
    cache_interval: int = 1       # >1: deep-feature reuse every N steps (serving mode)
    cache_levels: int = 1         # U-Net levels the cached passes recompute
    cache_schedule: tuple = None  # refresh positions (scan order, with 0); exclusive
                                  # with cache_interval > 1 (core/cache_schedule.py)
    cfg_interval: tuple = None    # (lo_frac, hi_frac): CFG only on scan positions
                                  # [lo*S, hi*S); None = every step
    tile_stride_frac: float = 0.75  # latent tile stride on a canvas (fraction of
                                    # the latent patch)


@dataclasses.dataclass(frozen=True)
class SamplerPlan:
    """What a ``SamplerConfig`` resolves to for a model: the DDIM constants,
    whether CFG is on, the guidance window as scan positions (None when it
    covers every step, which is then the unrestricted sampler, stedm_tpu
    steps.py:281-289), the positions that run a full pass (None when the
    trunk cache is off; with the window's forced refresh) and whether the
    CFG fan-out shares the encoder."""

    cfg: SamplerConfig
    ddim: DDIMParams
    use_cfg: bool
    cfg_interval: tuple | None
    refresh: frozenset | None
    shared_enc: bool

    @property
    def scale(self) -> float:
        return self.cfg.cfg_scale if self.use_cfg else 1.0

    @property
    def caching(self) -> bool:
        return self.refresh is not None

    @property
    def window(self) -> tuple[int, int]:
        """The guided scan positions ``[lo, hi)``."""
        return self.cfg_interval or (0, self.ddim.num_steps)


def plan_sampler(model, schedule: DiffusionSchedule, cfg: SamplerConfig) -> SamplerPlan:
    """Resolve ``cfg`` with stedm_tpu's refusals (steps.py:270-289, :348-358),
    all raised here, before the first sample: eta > 0 or a guidance window
    with a method other than DDIM; caching with another method, with
    ``cache_interval > 1`` and ``cache_schedule`` together, or with CFG
    without ``batched_cfg`` and bottleneck-only conditioning. A method other
    than ddim, plms and dpm raises ``NotImplementedError``."""
    ddim = DDIMParams.create(schedule, cfg.ddim_steps, cfg.eta)
    use_cfg = cfg.use_cfg and cfg.cfg_scale != 1.0
    if cfg.eta > 0 and cfg.method != "ddim":
        raise ValueError(f"eta={cfg.eta} requires method='ddim' (the reference's "
                         f"PLMS asserts ddim_eta == 0 and DPM-Solver ignores eta)")
    glo, ghi = guided_range(ddim.num_steps, cfg.cfg_interval)
    cfg_interval = ((glo, ghi) if use_cfg and cfg.cfg_interval is not None
                    and (glo > 0 or ghi < ddim.num_steps) else None)
    if cfg_interval is not None and cfg.method != "ddim":
        raise ValueError("cfg_interval is only supported for method='ddim'")
    caching = cfg.cache_interval > 1 or cfg.cache_schedule is not None
    shared_enc = use_cfg and cfg.batched_cfg and model.bottleneck_only
    if caching:
        if cfg.cache_interval > 1 and cfg.cache_schedule is not None:
            raise ValueError("cache_interval > 1 and cache_schedule are mutually "
                             "exclusive refresh placements")
        if cfg.method != "ddim":
            raise ValueError("deep-feature caching is only supported for DDIM")
        if use_cfg and not shared_enc:
            raise ValueError("deep-feature caching with CFG requires batched_cfg and "
                             "bottleneck-only conditioning (shared-encoder fan-out)")
    if cfg.method not in ("ddim", "plms", "dpm"):
        raise NotImplementedError(f"unknown sampler method {cfg.method!r}")
    refresh = None
    if caching:
        positions = (cfg.cache_schedule if cfg.cache_schedule is not None
                     else range(0, ddim.num_steps, cfg.cache_interval))
        refresh = serving_refresh(positions, ddim.num_steps,
                                  *(cfg_interval or (0, ddim.num_steps)))
    return SamplerPlan(cfg, ddim, use_cfg, cfg_interval, refresh, shared_enc)


def prepare_conditioning(model, batch: dict, plan: SamplerPlan, dev):
    """The layout encoding ``[B, h, w, c]`` and the style context: ``[B, 512]``,
    or under CFG the cond and the dropped (constant -2) style stacked
    ``[2B, 512]``."""
    seg = torch.as_tensor(batch["segmentation"], dtype=torch.float32, device=dev)
    style_imgs = torch.as_tensor(batch["style_imgs"], dtype=torch.float32, device=dev)
    seg_cond = model.cond_encode(seg)
    ctx = model.style_encode(style_imgs)
    if plan.use_cfg:
        ctx = torch.cat([ctx, model.style_encode(torch.zeros_like(style_imgs) - 2.0)])
    return seg_cond, ctx


def check_model_device(model, dev: torch.device) -> None:
    param_dev = next(model.parameters()).device
    if param_dev.type != dev.type or (dev.index is not None and param_dev != dev):
        raise ValueError(f"model lives on {param_dev}, the sampler on {dev}")


def initial_latent(batch: dict, cfg: SamplerConfig, x_T, generator, dev) -> torch.Tensor:
    """``x_T`` on the device, drawn from ``generator`` when not given."""
    if x_T is None:
        b, p = tuple(batch["segmentation"].shape[:2])
        latent = (b, p // cfg.downsample, p // cfg.downsample, cfg.latent_channels)
        x_T = torch.randn(latent, generator=generator, device=dev)
    return torch.as_tensor(x_T, dtype=torch.float32, device=dev)


def is_canvas(model, batch: dict) -> bool:
    """A layout larger than the model's patch: a canvas."""
    return tuple(batch["segmentation"].shape)[1] > model.patch_size


def check_tiled_supported(plan: SamplerPlan) -> None:
    """The canvas path's refusals (stedm_tpu steps.py:170-182, :300-303): a
    guidance window, caching or CFG without the shared-encoder fan-out
    (ValueError); a method other than DDIM (NotImplementedError)."""
    if plan.cfg_interval is not None:
        raise ValueError("cfg_interval is not supported on the tiled canvas path")
    if plan.cfg.method != "ddim":
        raise NotImplementedError("tiled canvases support DDIM only "
                                  f"(got method={plan.cfg.method!r})")
    if plan.caching:
        raise ValueError("deep-feature caching is not supported on the tiled canvas path")
    if plan.use_cfg and not plan.shared_enc:
        raise ValueError("tiled canvases with CFG require batched_cfg and bottleneck-only "
                         "conditioning (shared-encoder fan-out)")


def _tiles(model, cfg: SamplerConfig) -> tuple[int, int]:
    """The latent tile and its stride."""
    lat = model.patch_size // cfg.downsample
    return lat, max(1, int(lat * cfg.tile_stride_frac))


def make_tiled_eps(model, plan: SamplerPlan, seg_cond: torch.Tensor,
                   ctx: torch.Tensor) -> Callable:
    """Canvas eps (stedm_tpu steps.py:185-226): every evaluation runs over
    overlapping latent tiles stitched with the window. Under CFG ``ctx`` is
    the ``[2B]`` cond/uncond style (shared-encoder fan-out) and the pair is
    packed in the tile's channel axis, so both branches stitch in one pass;
    returns eps, or the pair under CFG."""
    lat, stride = _tiles(model, plan.cfg)
    c_lat, b, pair = plan.cfg.latent_channels, seg_cond.shape[0], plan.use_cfg

    def eps_fn(x, t):
        canvas = torch.cat([x, seg_cond.to(x.dtype)], dim=-1)

        def tile_fn(tile):
            e = model.eps(tile[..., :c_lat], t, tile[..., c_lat:], ctx)
            return torch.cat([e[:b], e[b:]], dim=-1) if pair else e

        out = tiled_apply(tile_fn, canvas, lat, stride, out_channels=(1 + pair) * c_lat)
        return (out[..., :c_lat], out[..., c_lat:]) if pair else out

    return eps_fn


def decode_latent(model, cfg: SamplerConfig, z: torch.Tensor) -> torch.Tensor:
    """Latent -> images in [-1, 1]; a canvas latent decodes tile by tile
    (stedm_tpu steps.py:229-237)."""
    lat, stride = _tiles(model, cfg)
    if z.shape[1] > lat:
        img = tiled_apply(model.decode_first_stage, z, lat, stride, out_channels=3,
                          scale=cfg.downsample)
    else:
        img = model.decode_first_stage(z)
    return torch.clamp(img, -1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class EpsFns:
    """The model evaluations of a sampler, each ``(x, t[, cache])``: ``pair``
    is eps, or under CFG the ``(e_cond, e_uncond)`` pair by the config's CFG
    mode; ``cond`` the conditional branch alone at batch B; ``full`` /
    ``cached`` the serving mode's passes (under CFG on the shared-encoder
    fan-out, the pair), ``full_cond`` / ``cached_cond`` their conditional
    twins. A full pass also returns the cache."""

    pair: Callable
    cond: Callable
    full: Callable
    cached: Callable
    full_cond: Callable
    cached_cond: Callable


def eps_functions(model, plan: SamplerPlan, seg_cond: torch.Tensor,
                  ctx: torch.Tensor) -> EpsFns:
    """The sampler's model evaluations on the conditioning that
    ``prepare_conditioning`` made (stedm_tpu steps.py:318-393); on a canvas
    the tiled eps (``make_tiled_eps``) and nothing else."""
    if seg_cond.shape[1] > model.patch_size // plan.cfg.downsample:
        tiled = make_tiled_eps(model, plan, seg_cond, ctx)
        return EpsFns(tiled, tiled, None, None, None, None)
    b, levels = seg_cond.shape[0], plan.cfg.cache_levels
    style_c = ctx[:b]
    split = lambda e: (e[:b], e[b:])

    def cond(x, t):
        return model.eps(x, t, seg_cond, style_c)

    def full_cond(x, t):
        return model.eps_full(x, t, seg_cond, style_c, levels)

    def cached_cond(x, t, cache):
        return model.eps_cached(x, t, seg_cond, cache, levels)

    if not plan.use_cfg:
        return EpsFns(cond, cond, full_cond, cached_cond, full_cond, cached_cond)
    if plan.shared_enc:
        def pair(x, t):
            return split(model.eps(x, t, seg_cond, ctx))
    elif plan.cfg.batched_cfg:
        seg2 = torch.cat([seg_cond, seg_cond])

        def pair(x, t):
            return split(model.eps(torch.cat([x, x]), torch.cat([t, t]), seg2, ctx))
    else:
        def pair(x, t):
            return cond(x, t), model.eps(x, t, seg_cond, ctx[b:])

    def full(x, t):
        e, cache = model.eps_full(x, t, seg_cond, ctx, levels)
        return split(e), cache

    def cached(x, t, cache):
        return split(model.eps_cached(x, t, seg_cond, cache, levels))

    return EpsFns(pair, cond, full, cached, full_cond, cached_cond)


def make_sample_fn(model, schedule: DiffusionSchedule, cfg: SamplerConfig,
                   device=None) -> Callable:
    """Build the sampler; it runs on ``cuda`` unless ``device`` says otherwise,
    and the model must already live there."""
    plan = plan_sampler(model, schedule, cfg)
    dev = resolve_device(device)
    ddim = plan.ddim

    @torch.inference_mode()
    def sample(model, batch: dict, x_T: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        check_model_device(model, dev)
        if is_canvas(model, batch):
            check_tiled_supported(plan)
        seg_cond, ctx = prepare_conditioning(model, batch, plan, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        x_T = initial_latent(batch, cfg, x_T, generator, dev)
        f = eps_functions(model, plan, seg_cond, ctx)
        kw = dict(cfg_scale=plan.scale, rescale_phi=cfg.rescale_phi,
                  generator=generator if cfg.eta > 0 else None)
        glo, ghi = plan.window
        if cfg.method == "plms":
            z_0 = plms_sample(f.pair, x_T, ddim, cfg_scale=plan.scale,
                              rescale_phi=cfg.rescale_phi)
        elif cfg.method == "dpm":
            z_0 = dpm_solver_pp_sample(f.pair, x_T, schedule, cfg.ddim_steps,
                                       cfg_scale=plan.scale, rescale_phi=cfg.rescale_phi)
        elif plan.caching:
            z_0 = ddim_sample_scheduled_guided(
                f.full, f.cached, f.full_cond, f.cached_cond, x_T, ddim,
                refresh_positions=plan.refresh, guided_lo=glo, guided_hi=ghi, **kw)
        elif plan.cfg_interval is not None:
            z_0 = ddim_sample_guided(f.pair, f.cond, x_T, ddim, guided_lo=glo,
                                     guided_hi=ghi, **kw)
        else:
            z_0 = ddim_sample(f.pair, x_T, ddim, **kw)
        return decode_latent(model, cfg, z_0)

    return sample
