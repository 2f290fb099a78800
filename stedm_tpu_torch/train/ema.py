"""Exponential moving average of the denoiser's parameters (stedm_tpu/train/ema.py).

The reference's ``LitEma``: the decay ramps as ``min(max_decay, (1 + n) /
(10 + n))`` with ``n`` the number of updates, and the shadow update is
``shadow -= (1 - decay) * (shadow - param)``, after every micro-batch
(gradient-accumulation steps included). The decay is computed in float32 as
the JAX package computes it. The shadow is a dict of fp32 tensors updated in
place (the JAX function returns a new tree).
"""

from __future__ import annotations

import numpy as np
import torch


def ema_decay(num_updates: int, max_decay: float = 0.9999) -> float:
    n = np.float32(num_updates)
    return float(np.minimum(np.float32(max_decay), (np.float32(1.0) + n) / (np.float32(10.0) + n)))


@torch.no_grad()
def ema_update(shadow: dict[str, torch.Tensor], params: dict[str, torch.Tensor],
               num_updates: int, max_decay: float = 0.9999) -> int:
    """One EMA step over ``shadow``'s keys, in place; returns ``num_updates + 1``."""
    one_minus = float(np.float32(1.0) - np.float32(ema_decay(num_updates, max_decay)))
    s = list(shadow.values())
    p = [params[name].detach().to(t.dtype) for name, t in shadow.items()]
    torch._foreach_add_(s, torch._foreach_sub(s, p), alpha=-one_minus)
    return num_updates + 1
