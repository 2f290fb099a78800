"""AdamW with the reference's trainability policy (stedm_tpu/train/optim.py:24-84).

A flat learning rate; trainable groups are the U-Net, the cond stage, the
learned ``logvar`` when there is one, and the style branch (``agg``) unless
``style_encoder_trainable=False`` (the reference's accidental omission,
kept for parity runs). The frozen VQ first stage, and a frozen style branch,
get ``requires_grad=False`` and stay out of the optimizer: the JAX package
gives them zero updates (``optax.set_to_zero``), which leaves them as they
are too.

``torch.optim.AdamW`` gives ``optax.adamw``'s update (b1 0.9, b2 0.999, eps
1e-8, decoupled weight decay on every trainable tensor). Gradient
accumulation mirrors ``optax.MultiSteps``: the gradients of k micro-batches
are averaged and applied on every k-th call; parameters do not move on the
others. ``clip_grad_norm`` clips the global norm of the averaged gradients
as ``optax.clip_by_global_norm`` does.
"""

from __future__ import annotations

import dataclasses

import torch

FROZEN_PARAM_GROUPS = ("first_stage",)


def scaled_lr(base_lr: float, batch_base: int, batch_mul: int, n_devices: int,
              lr_override: float | None = None) -> float:
    """The reference's lr rule (train_diff.py:36-39)."""
    if lr_override is not None:
        return float(lr_override)
    return float(base_lr) * batch_base * batch_mul * n_devices


@dataclasses.dataclass
class OptState:
    """The torch optimizer over the trainable tensors and the accumulation
    counters of ``optax.MultiSteps`` (``mini_step`` counts micro-batches since
    the last update, ``gradient_step`` the updates applied)."""

    adamw: torch.optim.AdamW
    params: list[torch.nn.Parameter]
    mini_step: int = 0
    gradient_step: int = 0


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The optimizer's settings; ``init`` builds its state over named
    parameter groups, ``update`` runs once per micro-batch after backward."""

    lr: float
    style_encoder_trainable: bool = True
    accumulate_grad_batches: int = 1
    weight_decay: float = 0.01
    clip_grad_norm: float | None = None
    fused: bool = False

    def label(self, group: str) -> str:
        if group in FROZEN_PARAM_GROUPS or (group == "agg" and not self.style_encoder_trainable):
            return "frozen"
        return "train"

    def init(self, groups: dict[str, list[torch.nn.Parameter]]) -> OptState:
        """Freeze the frozen groups (``requires_grad=False``) and build AdamW
        over the others."""
        params = []
        for name, ps in groups.items():
            train = self.label(name) == "train"
            for p in ps:
                p.requires_grad_(train)
            if train:
                params.extend(ps)
        adamw = torch.optim.AdamW(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=self.weight_decay,
                                  fused=True if self.fused else None)
        return OptState(adamw=adamw, params=params)

    @torch.no_grad()
    def update(self, state: OptState) -> bool:
        """Count one micro-batch whose gradients ``backward`` has accumulated
        into ``.grad``; on every k-th, average them, clip, step AdamW and
        clear them. Returns whether parameters moved."""
        state.mini_step += 1
        if state.mini_step < self.accumulate_grad_batches:
            return False
        state.mini_step = 0
        grads = [p.grad for p in state.params if p.grad is not None]
        if self.accumulate_grad_batches > 1:
            torch._foreach_div_(grads, float(self.accumulate_grad_batches))
        if self.clip_grad_norm:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            # optax: g * max_norm / max(norm, max_norm)
            torch._foreach_mul_(grads, self.clip_grad_norm / torch.clamp(norm, min=self.clip_grad_norm))
        state.adamw.step()
        state.adamw.zero_grad(set_to_none=True)
        state.gradient_step += 1
        return True


def make_optimizer(lr: float, *, style_encoder_trainable: bool = True,
                   accumulate_grad_batches: int = 1, weight_decay: float = 0.01,
                   clip_grad_norm: float | None = None, fused: bool = False,
                   m_dtype=None) -> Optimizer:
    """AdamW over the trainable groups; ``fused=True`` maps to
    ``AdamW(fused=True)`` (stedm_tpu's ``train/fused_adamw.py`` is jnp, not a
    TPU kernel). ``m_dtype`` (a bf16 first moment) has no counterpart in
    ``torch.optim.AdamW`` and raises."""
    if m_dtype is not None:
        raise NotImplementedError("m_dtype (a low-precision first moment) has no "
                                  "counterpart in torch.optim.AdamW")
    if accumulate_grad_batches < 1:
        raise ValueError(f"accumulate_grad_batches must be >= 1, got {accumulate_grad_batches}")
    return Optimizer(lr=lr, style_encoder_trainable=style_encoder_trainable,
                     accumulate_grad_batches=accumulate_grad_batches,
                     weight_decay=weight_decay, clip_grad_norm=clip_grad_norm, fused=fused)
