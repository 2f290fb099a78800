"""Serving-mode calibration: the per-step drift of the cached trunk
(stedm_tpu/train/calibrate.py:30-122).

One exact DDIM trajectory runs through the caching split (``model.eps_full``)
at every step and records how far the deep-trunk output, the cache, moves
between consecutive steps. The profile feeds
:func:`stedm_tpu_torch.core.cache_schedule.optimal_positions`, which places
the serving mode's refreshes (``"auto:R"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stedm_tpu_torch._device import resolve_device
from stedm_tpu_torch.core.ddim import ddim_sample_scheduled
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.train.steps import (
    SamplerConfig,
    check_model_device,
    eps_functions,
    initial_latent,
    plan_sampler,
    prepare_conditioning,
)


def _relative_l1(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((b - a).abs().mean() / (a.abs().mean() + 1e-8))


@torch.inference_mode()
def measure_cache_drift(model, schedule: DiffusionSchedule, cfg: SamplerConfig, batch: dict,
                        x_T: torch.Tensor | None = None,
                        generator: torch.Generator | None = None, device=None) -> np.ndarray:
    """Per-step relative drift of the cached trunk along one exact trajectory.

    Returns ``drift`` of length ``cfg.ddim_steps - 1`` in scan order:
    ``drift[k]`` is the mean absolute change of the cache between steps k and
    k+1 over the mean absolute cache at step k. ``cfg.cache_levels`` picks the
    cache split; ``cache_interval``, ``cache_schedule`` and ``cfg_interval``
    are ignored. ``x_T`` and the eta > 0 noise come from ``generator`` as in
    ``make_sample_fn``. Runs on ``cuda`` unless ``device`` says otherwise."""
    if cfg.method != "ddim":
        raise ValueError("calibration runs the DDIM trajectory only")
    plan = plan_sampler(model, schedule, dataclasses.replace(
        cfg, cache_interval=1, cache_schedule=None, cfg_interval=None))
    if plan.use_cfg and not plan.shared_enc:
        raise ValueError("calibration (like the serving mode) requires batched_cfg and "
                         "bottleneck-only conditioning")
    dev = resolve_device(device)
    check_model_device(model, dev)
    seg_cond, ctx = prepare_conditioning(model, batch, plan, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    x_T = initial_latent(batch, cfg, x_T, generator, dev)
    full = eps_functions(model, plan, seg_cond, ctx).full
    drifts, prev = [], []

    def full_recorded(x, t):
        out, cache = full(x, t)
        if prev:
            drifts.append(_relative_l1(prev.pop(), cache))
        prev.append(cache)
        return out, cache

    # every step refreshed: the exact trajectory, through the caching split
    ddim_sample_scheduled(full_recorded, None, x_T, plan.ddim,
                          refresh_positions=range(plan.ddim.num_steps), cfg_scale=plan.scale,
                          rescale_phi=cfg.rescale_phi,
                          generator=generator if cfg.eta > 0 else None)
    return np.asarray(drifts, np.float64)
