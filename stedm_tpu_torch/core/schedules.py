"""Diffusion noise schedules and DDIM step selection.

A copy of the numpy parts of stedm_tpu/core/schedules.py (the port imports
nothing from the JAX package): schedules are computed in float64 on the host
and frozen to float32, as the reference does. Only the linear schedule and
the buffers the sampler and the training loss read are kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2) -> np.ndarray:
    """Beta schedule in float64 (reference diffusionmodules/util.py:21-43);
    "linear" is linear in sqrt space. The other schedules come when a
    configuration needs them."""
    if schedule != "linear":
        raise NotImplementedError(f"schedule {schedule!r} is not ported")
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                       dtype=np.float64) ** 2


def make_ddim_timesteps(ddim_discr_method: str, num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    """DDPM timesteps used by DDIM (reference util.py:46-60); the +1 shift is
    the reference's. ``uniform`` keeps the ragged stride: S=128 runs 143 steps."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.arange(0, num_ddpm_timesteps, c)
    elif ddim_discr_method == "quad":
        ddim_timesteps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                                      num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(
            f'There is no ddim discretization method called "{ddim_discr_method}"')
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(alphacums: np.ndarray, ddim_timesteps: np.ndarray,
                                  eta: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-step (sigma, alpha, alpha_prev) (reference util.py:63-74)."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.concatenate([alphacums[:1], alphacums[ddim_timesteps[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The DDPM buffers the sampler and the loss read, float32 numpy arrays of
    shape [T] (stedm_tpu schedules.py:70-149). ``lvlb_weights`` has its t=0
    entry overwritten by the t=1 entry, as the reference does."""

    num_timesteps: int
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    lvlb_weights: np.ndarray

    @classmethod
    def create(cls, beta_schedule: str = "linear", timesteps: int = 1000,
               linear_start: float = 1e-4, linear_end: float = 2e-2) -> "DiffusionSchedule":
        betas = make_beta_schedule(beta_schedule, timesteps, linear_start=linear_start,
                                   linear_end=linear_end)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        # the eps parameterization's weights (the shipped config's);
        # posterior_variance[0] == 0 makes lvlb[0] inf, overwritten as the
        # reference does (ddpm.py:163-171)
        with np.errstate(divide="ignore"):
            lvlb = betas ** 2 / (2 * posterior_variance * alphas * (1 - alphas_cumprod))
        lvlb[0] = lvlb[1]
        f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
        return cls(num_timesteps=int(betas.shape[0]),
                   alphas_cumprod=f32(alphas_cumprod),
                   sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
                   sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
                   lvlb_weights=f32(lvlb))

    @staticmethod
    def gather(buf: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """``buf[t]`` on t's device, shaped to broadcast over ``ndim - 1``
        trailing axes."""
        return torch.as_tensor(buf, device=t.device)[t].reshape((-1,) + (1,) * (ndim - 1))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Forward-process sample x_t ~ q(x_t | x_0) in fp32 (stedm_tpu
        schedules.py:139-149); ``t`` is an int tensor of shape [B]."""
        a = self.gather(self.sqrt_alphas_cumprod, t, x_start.dim())
        s = self.gather(self.sqrt_one_minus_alphas_cumprod, t, x_start.dim())
        return a * x_start.float() + s * noise
