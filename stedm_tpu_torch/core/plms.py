"""PLMS, pseudo linear multistep sampling (stedm_tpu/core/plms.py) as a
Python loop.

DDIM's deterministic update driven by an Adams-Bashforth combination of the
newest eps predictions. The first step is the reference's 2-evaluation
trapezoid bootstrap: eps at (x, t) and at the provisional x_prev with the
*next* timestep (t = 0 pairs with the last step), averaged. Later steps use
orders 1-3 from a newest-first history of three eps; the order at scan
position k is min(k, 3), a function of the position alone, so the host
block sampler fixes it per block. 50 steps make 51 model evaluations.

The state is fp32. The history lives in three buffers that each step
updates by copies (``plms_steps``), so the CUDA graphs of the block sampler
can keep them as static buffers. ``eps_fn`` follows ``ddim_sample``'s
contract: eps, or the (cond, uncond) pair under rescaled CFG.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from stedm_tpu_torch.core.ddim import DDIMParams, ddim_step, guided_eps


def plms_tables(params: DDIMParams) -> tuple[np.ndarray, ...]:
    """In scan order (position 0 = the highest-noise step): the timestep,
    the next one (0 after the last) and the DDIM table index."""
    idx = np.arange(params.num_steps - 1, -1, -1)
    ts_seq = params.timesteps[idx]
    ts_next = np.concatenate([ts_seq[1:], np.zeros(1, ts_seq.dtype)])
    return ts_seq, ts_next, idx


def plms_steps(evaluate: Callable, x: torch.Tensor, hist: list[torch.Tensor],
               params: DDIMParams, start: int = 0, stop: int | None = None) -> torch.Tensor:
    """Scan positions ``[start, stop)`` of PLMS. ``evaluate(x, ts)`` is the
    guided eps (``guided_eps``); ``hist`` holds three fp32 buffers shaped
    like ``x``, newest first, updated in place by copies."""
    ts_seq, ts_next, idx = plms_tables(params)
    x = x.float()
    batch = x.shape[0]
    for k in range(start, params.num_steps if stop is None else stop):
        i = int(idx[k])
        consts = (params.alphas[i], params.alphas_prev[i], params.sigmas[i],
                  params.sqrt_one_minus_alphas[i])
        ts = torch.full((batch,), int(ts_seq[k]), dtype=torch.int64, device=x.device)
        e_t = evaluate(x, ts).float()
        order = min(k, 3)
        if order == 0:
            x_prev0 = ddim_step(x, e_t, *consts)[0]
            tsn = torch.full((batch,), int(ts_next[k]), dtype=torch.int64, device=x.device)
            e_prime = (e_t + evaluate(x_prev0, tsn).float()) / 2.0
        elif order == 1:
            e_prime = (3.0 * e_t - hist[0]) / 2.0
        elif order == 2:
            e_prime = (23.0 * e_t - 16.0 * hist[0] + 5.0 * hist[1]) / 12.0
        else:
            e_prime = (55.0 * e_t - 59.0 * hist[0] + 37.0 * hist[1] - 9.0 * hist[2]) / 24.0
        x = ddim_step(x, e_prime, *consts)[0]
        hist[2].copy_(hist[1])
        hist[1].copy_(hist[0])
        hist[0].copy_(e_t)
    return x


def plms_sample(eps_fn: Callable, x_T: torch.Tensor, params: DDIMParams, *,
                cfg_scale: float = 1.0, rescale_phi: float = 0.7) -> torch.Tensor:
    """The PLMS trajectory from x_T (stedm_tpu plms.py:24-73)."""
    x = x_T.float()
    hist = [torch.zeros_like(x) for _ in range(3)]
    return plms_steps(guided_eps(eps_fn, cfg_scale, rescale_phi), x, hist, params)
