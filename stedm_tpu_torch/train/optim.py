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

``m_dtype`` (``+adamw_m_bf16``: ``torch.bfloat16``) stores the first moment
in that dtype (``AdamWLowFirstMoment``), as ``optax.adamw(mu_dtype=...)``
and the JAX package's ``fused_adamw(m_dtype=...)`` do: the update is
computed in fp32 from the stored moment and the moment is rounded after
the update that used it; the second moment stays fp32. ``fused`` picks
which of the two JAX forms it follows (they round b1 m differently).

With several processes (parallel/dist.py) the gradients are averaged over
ranks on every k-th call, before the division by k, the clip and the step:
the global mean that XLA's all-reduce gives the JAX step
(train_diff.py:186-193). The call is made here rather than through
``DistributedDataParallel``: the optimizer accumulates the k micro-batches
itself, so one all-reduce an update is enough (DDP reduces on every
backward unless each one is wrapped in ``no_sync``), and the model keeps
its own module names, so checkpoints are the same files on one process and
on many.
"""

from __future__ import annotations

import dataclasses

import torch

from stedm_tpu_torch.parallel import dist

FROZEN_PARAM_GROUPS = ("first_stage",)


def scaled_lr(base_lr: float, batch_base: int, batch_mul: int, n_devices: int,
              lr_override: float | None = None) -> float:
    """The reference's lr rule (train_diff.py:36-39)."""
    if lr_override is not None:
        return float(lr_override)
    return float(base_lr) * batch_base * batch_mul * n_devices


class AdamWLowFirstMoment(torch.optim.Optimizer):
    """AdamW (optax's: b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay)
    over plain ``_foreach`` ops with the first moment stored in ``m_dtype``
    (stedm_tpu train/optim.py:69-72, train/fused_adamw.py:95-112): per step
    m = (1 - b1) g + b1 m and v = (1 - b2) g^2 + b2 v, p += -lr (m / (1 -
    b1^c) / (sqrt(v / (1 - b2^c)) + eps) + wd p), all fp32, then m is stored
    rounded to ``m_dtype``. The two JAX forms differ in one rounding:
    ``optax.adamw(mu_dtype=...)`` (``decay_in_m_dtype``) computes b1 m in
    ``m_dtype``, b1 itself rounded to it (0.8984375 in bf16), as JAX's weak
    typing makes ``decay * mu`` there; ``fused_adamw`` reads m back to fp32
    first. The JAX package has no TPU kernel here either."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, m_dtype: torch.dtype = torch.bfloat16,
                 decay_in_m_dtype: bool = True):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.m_dtype, self.decay_in_m_dtype = m_dtype, decay_in_m_dtype

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            b1, b2 = group["betas"]
            states = [self.state[p] for p in ps]
            for p, st in zip(ps, states):
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.m_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
            c = float(states[0]["step"])
            grads = [p.grad.float() for p in ps]
            # a restored moment comes back in the parameter's dtype
            # (Optimizer.load_state_dict casts it): read it as m_dtype
            if self.decay_in_m_dtype:
                b1_m = float(torch.tensor(b1, dtype=self.m_dtype))
                m = [(st["exp_avg"].to(self.m_dtype) * b1_m).float() for st in states]
            else:
                m = [st["exp_avg"].to(self.m_dtype).float() for st in states]
                torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - b1))
            v = [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            denom = torch._foreach_div(v, float(1.0 - torch.tensor(b2) ** c))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(m, float(1.0 - torch.tensor(b1) ** c))
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(upd, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_add_(ps, torch._foreach_mul(upd, -group["lr"]))
            for st, mm in zip(states, m):
                st["exp_avg"] = mm.to(self.m_dtype)   # rounded after its use
        return None


@dataclasses.dataclass
class OptState:
    """The torch optimizer over the trainable tensors and the accumulation
    counters of ``optax.MultiSteps`` (``mini_step`` counts micro-batches since
    the last update, ``gradient_step`` the updates applied)."""

    adamw: torch.optim.Optimizer    # torch.optim.AdamW, or AdamWLowFirstMoment
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
    m_dtype: torch.dtype | None = None

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
        if self.m_dtype is not None:
            adamw = AdamWLowFirstMoment(params, lr=self.lr, weight_decay=self.weight_decay,
                                        m_dtype=self.m_dtype, decay_in_m_dtype=not self.fused)
        else:
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
        # across ranks: the accumulated gradients averaged once an update
        dist.reduce_grads_(state.params)
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
    TPU kernel); ``m_dtype`` (e.g. ``torch.bfloat16``) to
    ``AdamWLowFirstMoment``, with or without ``fused``."""
    if accumulate_grad_batches < 1:
        raise ValueError(f"accumulate_grad_batches must be >= 1, got {accumulate_grad_batches}")
    return Optimizer(lr=lr, style_encoder_trainable=style_encoder_trainable,
                     accumulate_grad_batches=accumulate_grad_batches,
                     weight_decay=weight_decay, clip_grad_norm=clip_grad_norm, fused=fused,
                     m_dtype=m_dtype)
