"""The latent-diffusion training loss (stedm_tpu/core/diffusion.py:19-57).

Model application is injected as ``eps_fn`` so the same math serves training
(under autograd) and evaluation. The ancestral sampler of the JAX module
comes with the samplers slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from stedm_tpu_torch.core.schedules import DiffusionSchedule


def simple_loss(pred: torch.Tensor, target: torch.Tensor,
                loss_type: str = "l1") -> torch.Tensor:
    """Per-sample reconstruction loss in fp32, mean over all non-batch axes."""
    diff = target.float() - pred.float()
    dims = tuple(range(1, diff.dim()))
    if loss_type == "l1":
        return diff.abs().mean(dim=dims)
    if loss_type == "l2":
        return diff.square().mean(dim=dims)
    raise NotImplementedError(f"unknown loss type '{loss_type}'")


def p_losses(eps_fn: Callable, schedule: DiffusionSchedule, x_start: torch.Tensor,
             t: torch.Tensor, noise: torch.Tensor, *, loss_type: str = "l1",
             parameterization: str = "eps", logvar: torch.Tensor | None = None,
             l_simple_weight: float = 1.0, original_elbo_weight: float = 0.0
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Conditional denoising loss (reference ddpm.py:1015-1048).

    ``eps_fn(x_noisy, t)`` applies the conditioned model; with the ``eps``
    parameterization it predicts the noise, otherwise (``x0``) ``x_start``.
    ``logvar`` is the per-timestep log-variance buffer ``[T]`` (None: zeros,
    the shipped config). Returns ``(loss, {"loss_simple", "loss_vlb",
    "loss"})``."""
    x_noisy = schedule.q_sample(x_start, t, noise)
    target = noise if parameterization == "eps" else x_start
    loss_per_sample = simple_loss(eps_fn(x_noisy, t), target, loss_type)

    loss_simple = loss_per_sample.mean()
    logvar_t = torch.zeros_like(loss_per_sample) if logvar is None else logvar[t]
    loss = (loss_per_sample / torch.exp(logvar_t) + logvar_t).mean() * l_simple_weight

    lvlb = schedule.gather(schedule.lvlb_weights, t, 1)
    loss_vlb = (lvlb * loss_per_sample).mean()
    loss = loss + original_elbo_weight * loss_vlb
    return loss, {"loss_simple": loss_simple, "loss_vlb": loss_vlb, "loss": loss}
