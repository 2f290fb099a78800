"""Block sampling: the counterpart of stedm_tpu/train/host_sampler.py:87-615
for DDIM (exact, cached and composed with a guidance window), PLMS and
DPM-Solver++(2M), and for exact DDIM on a canvas.

The trajectory is cut into blocks of consecutive steps with the JAX
sampler's partition: ``unroll``-step blocks in exact mode and for PLMS and
DPM-Solver; in the cached serving mode blocks that start on a refresh
(``coalesce_blocks``), or, with ``carry_cache``, uniform blocks with the
deep-feature cache carried from one block into the next. Each step runs the
same per-step math as ``make_sample_fn``. PLMS's Adams-Bashforth order is a
function of the position, so each block's order pattern is fixed when it is
captured; its three eps slots, and DPM-Solver's previous x0, are static
buffers that the steps update by copies, never rebound between replays. On
a canvas the tiled eps and the tiled decode run (``steps.make_tiled_eps``),
the eps inside the blocks.

On the card each block is captured once as a CUDA graph
(``torch.cuda.CUDAGraph``) for each latent shape and replayed: one replay
launches the block's several thousand kernels without the host's path
through PyTorch and the kernel wrappers. The latent, the conditioning and
the eta > 0 noise go in through static buffers (copied in, never rebound:
the GroupNorm kernel's TMA descriptor carries the captured address); the
latent and the cache pass from block to block in the graphs' shared memory
pool, which is safe because the blocks replay in the order they were
captured. A step's constants (its timestep and DDIM coefficients) are
Python floats baked into its block's graph, so every block has a graph of
its own. The first call for a shape runs the blocks once eagerly (the
warm-up that lazy library set-up needs), captures them, then replays them.
The capture runs with Python's garbage collection off: the collector
freeing an earlier sampler's graphs would invalidate it. A capture that
fails raises; nothing falls back to the eager loop.
``ops.LAUNCHES`` counts wrapper calls, which happen at the warm-up and the
capture only: ``sample.capture_launches`` holds what the capture counted,
and a replay's kernels are seen by the profiler, not by the counters.

On the CPU the same blocks run eagerly: that is how the tests hold the
partition and the cache carry against the JAX sampler.
"""

from __future__ import annotations

import gc
from typing import Callable

import torch

from stedm_tpu_torch._device import resolve_device
from stedm_tpu_torch.core.cache_schedule import coalesce_blocks
from stedm_tpu_torch.core.ddim import guided_eps, guided_steps, scheduled_guided_steps
from stedm_tpu_torch.core.dpm_solver import DPMTables, dpm_steps
from stedm_tpu_torch.core.plms import plms_steps
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.ops import LAUNCHES
from stedm_tpu_torch.train.steps import (
    SamplerConfig,
    SamplerPlan,
    check_model_device,
    check_tiled_supported,
    decode_latent,
    eps_functions,
    initial_latent,
    is_canvas,
    plan_sampler,
    prepare_conditioning,
)


def _partition(steps: int, k: int) -> list[int]:
    return [min(k, steps - s) for s in range(0, steps, k)]


def _default_unroll(steps: int, unroll: int | None) -> int:
    if unroll:
        return int(unroll)
    return next((k for k in (5, 4, 3, 2) if steps % k == 0), min(5, steps))


def block_partition(plan: SamplerPlan, unroll: int | None, carry_cache: bool) -> list[int]:
    """The block sizes, as stedm_tpu host_sampler.py:284-336 partitions the
    steps; in the cached mode without ``carry_cache`` every block starts on
    one of ``plan.refresh``."""
    steps = plan.cfg.ddim_steps if plan.cfg.method == "dpm" else plan.ddim.num_steps
    if not plan.caching:
        return _partition(steps, _default_unroll(steps, unroll))
    budget = int(unroll) if unroll else 10
    if plan.cfg.cache_schedule is not None:
        starts = (list(range(0, steps, budget)) if carry_cache
                  else coalesce_blocks(sorted(plan.refresh), steps, budget))
    else:
        interval = int(plan.cfg.cache_interval)
        m = max(1, int(unroll) // interval) if unroll else 1
        starts = list(range(0, steps, budget if carry_cache else interval * m))
    return [b - a for a, b in zip(starts, starts[1:] + [steps])]


class _Graphs:
    """The captured blocks of one latent shape and their static inputs."""

    def __init__(self, x_T, seg_cond, ctx, noise, n_slots: int):
        self.x_in, self.seg, self.ctx = x_T.clone(), seg_cond.clone(), ctx.clone()
        self.noise = None if noise is None else noise.clone()
        self.slots = [torch.zeros_like(x_T, dtype=torch.float32) for _ in range(n_slots)]
        self.graphs: list[torch.cuda.CUDAGraph] = []
        self.x_out = None

    def load(self, x_T, seg_cond, ctx, noise) -> None:
        self.x_in.copy_(x_T)
        self.seg.copy_(seg_cond)
        self.ctx.copy_(ctx)
        if noise is not None:
            self.noise.copy_(noise)
        for slot in self.slots:
            slot.zero_()

    def replay(self) -> torch.Tensor:
        for g in self.graphs:
            g.replay()
        return self.x_out


def make_host_sample_fn(model, schedule: DiffusionSchedule, cfg: SamplerConfig,
                        unroll: int | None = None, carry_cache: bool = False,
                        device=None) -> Callable:
    """The block sampler with ``make_sample_fn``'s semantics and its
    ``sample(model, batch, x_T=None, generator=None)``: CUDA graphs on the
    card (the default device), eager blocks on the CPU (``device="cpu"``).

    ``unroll``: the steps of a block in exact mode (default: the largest of
    5..2 that divides the step count), the budget of a block in the cached
    mode (default 10). ``carry_cache``: carry the cache between blocks, so
    that blocks need not start on a refresh. ``sample.block_sizes`` is the
    partition."""
    if cfg.method not in ("ddim", "plms", "dpm"):
        raise NotImplementedError(f"unknown sampler method {cfg.method!r}")
    plan = plan_sampler(model, schedule, cfg)
    dev = resolve_device(device)
    carry = bool(carry_cache) and plan.caching
    sizes = block_partition(plan, unroll, carry)
    glo, ghi = plan.window
    n_slots = {"plms": 3, "dpm": 1}.get(cfg.method, 0)
    tables = DPMTables.create(schedule, cfg.ddim_steps) if cfg.method == "dpm" else None

    def run_block(s0, k, x, cache, seg_cond, ctx, noise, slots):
        """Steps [s0, s0 + k) by the step rules of core/ddim.py, plms.py
        and dpm_solver.py; ``slots`` are the multistep buffers."""
        f = eps_functions(model, plan, seg_cond, ctx)
        if cfg.method != "ddim":
            evaluate = guided_eps(f.pair, plan.scale, cfg.rescale_phi)
            if cfg.method == "plms":
                return plms_steps(evaluate, x, slots, plan.ddim, s0, s0 + k), None
            return dpm_steps(evaluate, x, slots[0], tables, s0, s0 + k), None
        kw = dict(guided_lo=glo, guided_hi=ghi, cfg_scale=plan.scale,
                  rescale_phi=cfg.rescale_phi, start=s0, stop=s0 + k,
                  noise=None if noise is None else lambda s, _: noise[s])
        if not plan.caching:
            return guided_steps(f.pair, f.cond, x, plan.ddim, use_cfg=plan.use_cfg, **kw), None
        return scheduled_guided_steps(f.full, f.cached, f.full_cond, f.cached_cond, x,
                                      plan.ddim, refresh=plan.refresh, cache=cache, **kw)

    def blocks(x, seg_cond, ctx, noise, slots, captured: list | None = None):
        """Run every block, or capture each into a CUDA graph appended to
        ``captured`` (all in the first graph's memory pool)."""
        cache, s0 = None, 0
        for k in sizes:
            args = (s0, k, x, cache if carry else None, seg_cond, ctx, noise, slots)
            if captured is None:
                x, cache = run_block(*args)
            else:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=captured[0].pool() if captured else None):
                    x, cache = run_block(*args)
                captured.append(g)
            s0 += k
        return x

    def capture(state: _Graphs) -> dict:
        """Warm up on a side stream, then capture every block; returns the
        launches that the capture counted."""
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            blocks(state.x_in, state.seg, state.ctx, state.noise, state.slots)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(LAUNCHES)
        # no garbage collection while capturing: a block sampler that went out
        # of use is held by its own closure, so the collector frees its
        # graphs, and destroying a captured graph during a capture
        # invalidates the capture (tools/torch_capture_gc_probe.py)
        gc.collect()
        gc.disable()
        try:
            state.x_out = blocks(state.x_in, state.seg, state.ctx, state.noise, state.slots,
                                 state.graphs)
        finally:
            gc.enable()
        return {k: LAUNCHES[k] - before[k] for k in LAUNCHES}

    graphs: dict[tuple, _Graphs] = {}

    @torch.inference_mode()
    def sample(model_, batch: dict, x_T: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        if model_ is not model:
            raise ValueError("the block sampler runs the model it was built for")
        check_model_device(model, dev)
        if is_canvas(model, batch):
            check_tiled_supported(plan)
        seg_cond, ctx = prepare_conditioning(model, batch, plan, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        x_T = initial_latent(batch, cfg, x_T, generator, dev)
        noise = None
        if cfg.eta > 0:   # the draws of make_sample_fn's steps, in their order
            noise = torch.stack([torch.randn(x_T.shape, generator=generator, device=dev)
                                 for _ in range(plan.ddim.num_steps)])
        if dev.type != "cuda":
            slots = [torch.zeros_like(x_T) for _ in range(n_slots)]
            z_0 = blocks(x_T, seg_cond, ctx, noise, slots)
        else:
            key = (tuple(x_T.shape), tuple(seg_cond.shape), tuple(ctx.shape))
            state = graphs.get(key)
            if state is None:   # kept only once every block is captured
                state = _Graphs(x_T, seg_cond, ctx, noise, n_slots)
                sample.capture_launches = capture(state)
                graphs[key] = state
            state.load(x_T, seg_cond, ctx, noise)
            z_0 = state.replay()
        return decode_latent(model, cfg, z_0)

    sample.block_sizes = list(sizes)
    sample.capture_launches = None
    return sample
