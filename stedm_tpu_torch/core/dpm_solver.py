"""DPM-Solver++(2M) sampling (stedm_tpu/core/dpm_solver.py) as a Python loop.

The multistep second-order data-prediction solver of Lu et al. 2022 on the
discrete VP schedule:

    lambda_t = log(alpha_t / sigma_t),  x0 = (x - sigma_t eps) / alpha_t
    x_{t-1} = (sigma_{t-1} / sigma_t) x - alpha_{t-1} expm1(-h) D,
    D = (1 + 1/(2r)) x0_t - (1/(2r)) x0_{t-1},  r = h_prev / h
    (first step: D = x0_t)

The time grid ``linspace(T-1, 0, n+1).round()``, alpha, sigma and lambda
are built in float64 numpy as the JAX sampler builds them and cast to fp32;
the step sizes and coefficients are then fp32 arithmetic on those values,
as the JAX scan computes them on the device. The previous x0 lives in a
buffer that each step updates by a copy (``dpm_steps``), so the block
sampler's CUDA graphs can keep it as a static buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from stedm_tpu_torch.core.ddim import guided_eps
from stedm_tpu_torch.core.schedules import DiffusionSchedule


@dataclasses.dataclass(frozen=True)
class DPMTables:
    """Per-step constants, index = scan position: the timestep the model
    sees, alpha and sigma at it, sigma_next / sigma, alpha_next expm1(-h)
    and the multistep weights ``c1 = 1 + 1/(2r)``, ``c2 = 1/(2r)``; fp32."""

    ts: np.ndarray
    alpha: np.ndarray
    sigma: np.ndarray
    ratio: np.ndarray
    coef: np.ndarray
    c1: np.ndarray
    c2: np.ndarray

    @classmethod
    def create(cls, schedule: DiffusionSchedule, num_steps: int) -> "DPMTables":
        ac = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
        t_grid = np.linspace(schedule.num_timesteps - 1, 0, num_steps + 1).round().astype(np.int64)
        alpha = np.sqrt(ac[t_grid]).astype(np.float32)
        sigma = np.sqrt(1.0 - ac[t_grid]).astype(np.float32)
        lam = (np.log(np.sqrt(ac[t_grid])) - np.log(np.sqrt(1.0 - ac[t_grid]))).astype(np.float32)
        h = lam[1:] - lam[:-1]
        h_prev = np.concatenate([np.ones(1, np.float32), h[:-1]])   # unused at step 0
        r = h_prev / h
        c2 = np.float32(1.0) / (np.float32(2.0) * r)
        return cls(ts=t_grid[:-1], alpha=alpha[:-1], sigma=sigma[:-1],
                   ratio=sigma[1:] / sigma[:-1], coef=alpha[1:] * np.expm1(-h),
                   c1=np.float32(1.0) + c2, c2=c2)

    @property
    def num_steps(self) -> int:
        return int(self.ts.shape[0])


def dpm_steps(evaluate: Callable, x: torch.Tensor, x0_prev: torch.Tensor, tables: DPMTables,
              start: int = 0, stop: int | None = None) -> torch.Tensor:
    """Scan positions ``[start, stop)``. ``evaluate(x, ts)`` is the guided
    eps (``plms.guided_eps``); ``x0_prev`` is an fp32 buffer shaped like
    ``x``, updated in place by a copy."""
    x = x.float()
    batch = x.shape[0]
    for i in range(start, tables.num_steps if stop is None else stop):
        ts = torch.full((batch,), int(tables.ts[i]), dtype=torch.int64, device=x.device)
        e = evaluate(x, ts).float()
        x0 = (x - float(tables.sigma[i]) * e) / float(tables.alpha[i])
        d = x0 if i == 0 else float(tables.c1[i]) * x0 - float(tables.c2[i]) * x0_prev
        x = float(tables.ratio[i]) * x - float(tables.coef[i]) * d
        x0_prev.copy_(x0)
    return x


def dpm_solver_pp_sample(eps_fn: Callable, x_T: torch.Tensor, schedule: DiffusionSchedule,
                         num_steps: int, *, cfg_scale: float = 1.0,
                         rescale_phi: float = 0.7) -> torch.Tensor:
    """The DPM-Solver++(2M) trajectory from x_T (stedm_tpu dpm_solver.py:27-75)."""
    x = x_T.float()
    return dpm_steps(guided_eps(eps_fn, cfg_scale, rescale_phi), x, torch.zeros_like(x),
                     DPMTables.create(schedule, num_steps))
