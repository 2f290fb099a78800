"""DDIM sampling (stedm_tpu/core/ddim.py) as Python loops: the exact
trajectory and the serving mode's samplers (a guidance window, deep-feature
reuse on a refresh schedule, and both composed).

Guidance is the reference's rescaled CFG: the guided noise is renormalised
to the conditional branch's standard deviation over (channel, height) with
Bessel's correction, the torch ``std(dim=(1, 2))`` on NCHW, which is
``std(dim=(1, 3))`` on the NHWC tensors here, then blended with
``rescale_phi``. Per-step constants are float32, as in the JAX sampler.

Every sampler here walks the steps in scan order (position 0 = the
highest-noise step) and, given a ``generator``, draws the eta > 0 noise of a
step right after its eps, so all of them consume one noise sequence: with
every step refreshed and guided they are the same trajectory as
``ddim_sample``. Where the JAX samplers branch with ``lax.cond`` and mask a
padded last block, these branch with ``if`` and run a shorter last block.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from stedm_tpu_torch.core.cache_schedule import validate_positions
from stedm_tpu_torch.core.schedules import (
    DiffusionSchedule,
    make_ddim_sampling_parameters,
    make_ddim_timesteps,
)


@dataclasses.dataclass(frozen=True)
class DDIMParams:
    """Per-step DDIM constants, index 0 = lowest-noise step; numpy arrays."""

    timesteps: np.ndarray               # [S] int32
    alphas: np.ndarray                  # [S] float32
    alphas_prev: np.ndarray
    sigmas: np.ndarray
    sqrt_one_minus_alphas: np.ndarray

    @classmethod
    def create(cls, schedule: DiffusionSchedule, num_steps: int, eta: float = 0.0,
               method: str = "uniform") -> "DDIMParams":
        ddim_ts = make_ddim_timesteps(method, num_steps, schedule.num_timesteps)
        alphacums = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
        sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(alphacums, ddim_ts,
                                                                    eta)
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return cls(timesteps=ddim_ts.astype(np.int32), alphas=f32(alphas),
                   alphas_prev=f32(alphas_prev), sigmas=f32(sigmas),
                   sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)))

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def rescaled_cfg(e_t: torch.Tensor, e_t_uncond: torch.Tensor, scale: float,
                 rescale_phi: float = 0.7) -> torch.Tensor:
    """Rescaled classifier-free guidance on NHWC eps (reference ddim.py:179-184)."""
    e_t = e_t.float()
    e_t_uncond = e_t_uncond.float()
    e_t_w = e_t_uncond + scale * (e_t - e_t_uncond)
    std_c = torch.std(e_t, dim=(1, 3), keepdim=True, correction=1)
    std_w = torch.std(e_t_w, dim=(1, 3), keepdim=True, correction=1)
    rescaled = e_t_w * (std_c / std_w)
    return rescaled * rescale_phi + (1.0 - rescale_phi) * e_t


def guided_eps(eps_fn: Callable, cfg_scale: float, rescale_phi: float) -> Callable:
    """``eval(x, ts) -> eps``: the CFG pair resolved by ``rescaled_cfg``
    when ``cfg_scale != 1``."""
    use_cfg = cfg_scale != 1.0

    def evaluate(x, ts):
        out = eps_fn(x, ts)
        if use_cfg:
            return rescaled_cfg(out[0], out[1], cfg_scale, rescale_phi)
        return out[0] if isinstance(out, tuple) else out

    return evaluate


def ddim_step(x, e_t, a_t, a_prev, sigma_t, sqrt_one_minus_at, noise=None):
    """One DDIM update x_t -> x_{t-1} (reference ddim.py:200-210); the scalar
    constants are float32 values."""
    f32 = np.float32
    x = x.float()
    e_t = e_t.float()
    pred_x0 = (x - float(sqrt_one_minus_at) * e_t) / float(np.sqrt(f32(a_t)))
    dir_coef = np.sqrt(f32(1.0) - f32(a_prev) - f32(sigma_t) ** 2)
    x_prev = float(np.sqrt(f32(a_prev))) * pred_x0 + float(dir_coef) * e_t
    if noise is not None:
        x_prev = x_prev + float(sigma_t) * noise
    return x_prev, pred_x0


def ddim_update(x, out, params: DDIMParams, k: int, *, guided: bool, cfg_scale: float,
                rescale_phi: float, noise=None):
    """The step at scan position ``k`` on a model output: ``out`` is the
    ``(e_t_cond, e_t_uncond)`` pair on a guided step, else eps (or a pair
    whose first member is eps)."""
    if guided:
        e_t = rescaled_cfg(out[0], out[1], cfg_scale, rescale_phi)
    else:
        e_t = out[0] if isinstance(out, tuple) else out
    i = params.num_steps - 1 - k
    return ddim_step(x, e_t, params.alphas[i], params.alphas_prev[i], params.sigmas[i],
                     params.sqrt_one_minus_alphas[i], noise=noise)[0]


def step_timesteps(params: DDIMParams, k: int, batch: int, device) -> torch.Tensor:
    """The ``[batch]`` timesteps of scan position ``k``."""
    return torch.full((batch,), int(params.timesteps[params.num_steps - 1 - k]),
                      dtype=torch.int64, device=device)


def _noise_of(generator: torch.Generator | None) -> Callable | None:
    """A step's eta > 0 noise drawn from ``generator`` when the step asks."""
    if generator is None:
        return None
    return lambda k, x: torch.randn(x.shape, generator=generator, device=x.device)


def _drive(x: torch.Tensor, params: DDIMParams, evaluate: Callable, *, cfg_scale: float,
           rescale_phi: float, noise: Callable | None, start: int = 0, stop: int | None = None,
           cache=None):
    """Run scan positions ``[start, stop)`` (default: every one):
    ``evaluate(k, x, ts, cache) -> (out, guided, cache)``; ``noise(k, x)``
    gives step k's eta > 0 noise, asked for after its eps. Returns the
    latent and the cache."""
    x = x.float()
    for k in range(start, params.num_steps if stop is None else stop):
        out, guided, cache = evaluate(k, x, step_timesteps(params, k, x.shape[0], x.device),
                                      cache)
        x = ddim_update(x, out, params, k, guided=guided, cfg_scale=cfg_scale,
                        rescale_phi=rescale_phi, noise=None if noise is None else noise(k, x))
    return x, cache


def ddim_sample(eps_fn: Callable, x_T: torch.Tensor, params: DDIMParams, *,
                cfg_scale: float = 1.0, rescale_phi: float = 0.7,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """The DDIM trajectory from step S-1 down to 0 (reference ddim.py:112-162).

    ``eps_fn(x, t)`` returns eps for an NHWC latent and a ``[B]`` timestep
    batch, or the pair ``(e_t_cond, e_t_uncond)`` when ``cfg_scale != 1``.
    A ``generator`` turns on the eta > 0 noise of every step."""
    return guided_steps(eps_fn, eps_fn, x_T, params, guided_lo=0, guided_hi=params.num_steps,
                        use_cfg=cfg_scale != 1.0, cfg_scale=cfg_scale, rescale_phi=rescale_phi,
                        noise=_noise_of(generator))


def guided_range(num_steps: int, cfg_interval) -> tuple[int, int]:
    """A ``(lo_frac, hi_frac)`` guidance window as scan positions ``[lo, hi)``
    (stedm_tpu ddim.py:147-163); ``None`` means every step. Python's
    ``round`` takes halves to even: 50 steps of (0.35, 0.65) are (18, 32)."""
    if cfg_interval is None:
        return 0, num_steps
    lo_f, hi_f = float(cfg_interval[0]), float(cfg_interval[1])
    if not 0.0 <= lo_f <= hi_f <= 1.0:
        raise ValueError(f"cfg_interval must satisfy 0 <= lo <= hi <= 1, "
                         f"got {cfg_interval}")
    lo = int(round(lo_f * num_steps))
    hi = int(round(hi_f * num_steps))
    return max(0, min(lo, num_steps)), max(lo, min(hi, num_steps))


def guided_steps(eps_fn: Callable, eps_cond_fn: Callable, x: torch.Tensor,
                 params: DDIMParams, *, guided_lo: int, guided_hi: int, use_cfg: bool,
                 cfg_scale: float, rescale_phi: float, noise: Callable | None = None,
                 start: int = 0, stop: int | None = None) -> torch.Tensor:
    """Scan positions ``[start, stop)`` of exact DDIM: ``eps_fn`` on the
    window ``[guided_lo, guided_hi)`` (the CFG pair when ``use_cfg``),
    ``eps_cond_fn`` outside it. ``noise(k, x)``: step k's eta > 0 noise."""
    def evaluate(k, x, ts, cache):
        if guided_lo <= k < guided_hi:
            return eps_fn(x, ts), use_cfg, cache
        return eps_cond_fn(x, ts), False, cache

    return _drive(x, params, evaluate, cfg_scale=cfg_scale, rescale_phi=rescale_phi,
                  noise=noise, start=start, stop=stop)[0]


def ddim_sample_guided(eps_fn: Callable, eps_cond_fn: Callable, x_T: torch.Tensor,
                       params: DDIMParams, *, guided_lo: int, guided_hi: int,
                       cfg_scale: float, rescale_phi: float = 0.7,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """Exact DDIM with CFG on scan positions ``[guided_lo, guided_hi)`` only
    (stedm_tpu ddim.py:166-218); outside, ``eps_cond_fn(x, t) -> eps`` runs
    the conditional branch alone."""
    return guided_steps(eps_fn, eps_cond_fn, x_T, params, guided_lo=guided_lo,
                        guided_hi=guided_hi, use_cfg=True, cfg_scale=cfg_scale,
                        rescale_phi=rescale_phi, noise=_noise_of(generator))


def serving_refresh(refresh_positions, num_steps: int, guided_lo: int,
                    guided_hi: int) -> frozenset:
    """The positions that run a full pass: the schedule's, and the guidance
    window's entry when the window is not empty (stedm_tpu ddim.py:331-333),
    so that a guided shallow step always sees a cond/uncond fan-out cache."""
    refresh = set(validate_positions(refresh_positions, num_steps))
    if guided_hi > guided_lo and guided_lo < num_steps:
        refresh.add(int(guided_lo))
    return frozenset(refresh)


def scheduled_guided_steps(eps_full_fn: Callable, eps_cached_fn: Callable,
                           eps_full_cond_fn: Callable | None,
                           eps_cached_cond_fn: Callable | None, x: torch.Tensor,
                           params: DDIMParams, *, refresh: frozenset, guided_lo: int,
                           guided_hi: int, cfg_scale: float, rescale_phi: float,
                           noise: Callable | None = None, start: int = 0,
                           stop: int | None = None, cache=None):
    """Scan positions ``[start, stop)`` of the serving mode, the step rule
    of every serving sampler: positions in ``refresh`` (from
    ``serving_refresh``) run a full pass and replace the cache, the others
    a cached pass on it; guided positions run ``eps_full_fn`` /
    ``eps_cached_fn`` (the cond/uncond fan-out), the others the
    ``*_cond_fn`` twins at batch B; at the window's end the cache keeps its
    first B (cond) rows (stedm_tpu ddim.py:404-407). ``cache`` is the one
    that enters ``start`` (None when ``start`` refreshes). Returns the
    latent and the cache that leaves ``stop``."""
    glo, ghi = int(guided_lo), int(guided_hi)
    use_cfg = cfg_scale != 1.0

    def evaluate(k, x, ts, cache):
        guided = glo <= k < ghi
        full, shallow = ((eps_full_fn, eps_cached_fn) if guided
                         else (eps_full_cond_fn, eps_cached_cond_fn))
        if k in refresh:
            out, cache = full(x, ts)
            return out, use_cfg and guided, cache
        if k == ghi:
            cache = cache[:x.shape[0]]
        return shallow(x, ts, cache), use_cfg and guided, cache

    return _drive(x, params, evaluate, cfg_scale=cfg_scale, rescale_phi=rescale_phi,
                  noise=noise, start=start, stop=stop, cache=cache)


def ddim_sample_scheduled(eps_full_fn: Callable, eps_cached_fn: Callable,
                          x_T: torch.Tensor, params: DDIMParams, *, refresh_positions,
                          cfg_scale: float = 1.0, rescale_phi: float = 0.7,
                          generator: torch.Generator | None = None) -> torch.Tensor:
    """DDIM with deep-feature reuse on any refresh schedule (stedm_tpu
    ddim.py:221-300): the scan positions in ``refresh_positions`` (which
    include 0) run ``eps_full_fn(x, t) -> (out, cache)``, every other one
    ``eps_cached_fn(x, t, cache) -> out`` on the latest cache."""
    return ddim_sample_scheduled_guided(
        eps_full_fn, eps_cached_fn, None, None, x_T, params,
        refresh_positions=refresh_positions, guided_lo=0, guided_hi=params.num_steps,
        cfg_scale=cfg_scale, rescale_phi=rescale_phi, generator=generator)


def ddim_sample_scheduled_guided(eps_full_fn: Callable, eps_cached_fn: Callable,
                                 eps_full_cond_fn: Callable | None,
                                 eps_cached_cond_fn: Callable | None,
                                 x_T: torch.Tensor, params: DDIMParams, *,
                                 refresh_positions, guided_lo: int, guided_hi: int,
                                 cfg_scale: float, rescale_phi: float = 0.7,
                                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Scheduled deep-feature reuse composed with a guidance window
    (stedm_tpu ddim.py:303-408), every step by ``scheduled_guided_steps``;
    the window's entry is a forced refresh (``serving_refresh``)."""
    refresh = serving_refresh(refresh_positions, params.num_steps, guided_lo, guided_hi)
    return scheduled_guided_steps(
        eps_full_fn, eps_cached_fn, eps_full_cond_fn, eps_cached_cond_fn, x_T, params,
        refresh=refresh, guided_lo=guided_lo, guided_hi=guided_hi, cfg_scale=cfg_scale,
        rescale_phi=rescale_phi, noise=_noise_of(generator))[0]


def ddim_sample_cached(eps_full_fn: Callable, eps_cached_fn: Callable, x_T: torch.Tensor,
                       params: DDIMParams, *, cache_interval: int, cfg_scale: float = 1.0,
                       rescale_phi: float = 0.7,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """Deep-feature reuse in blocks of ``cache_interval`` steps (stedm_tpu
    ddim.py:411-488): the first step of each block refreshes, and a step
    count that the interval does not divide ends in a shorter block."""
    interval = int(cache_interval)
    assert interval >= 1
    return ddim_sample_scheduled(
        eps_full_fn, eps_cached_fn, x_T, params,
        refresh_positions=range(0, params.num_steps, interval), cfg_scale=cfg_scale,
        rescale_phi=rescale_phi, generator=generator)
