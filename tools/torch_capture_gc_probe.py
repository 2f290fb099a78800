#!/usr/bin/env python3
"""Whether a CUDA graph capture survives Python's cyclic garbage collector
freeing CUDA objects while it runs, in the "global" and "thread_local"
capture modes.

A block sampler (``train/host_sampler.make_host_sample_fn``) holds its
captured graphs in a closure that refers to itself, so a sampler that goes
out of use is freed by the cyclic collector, at whatever allocation
triggers it: possibly inside the next sampler's capture. Each trial runs in
a process of its own (a failed capture can leave the allocator's capture
state behind), makes one kind of cyclic garbage with the collector off,
then captures a small graph and calls ``gc.collect()`` inside the capture
(or just before it), and reports whether the capture and its replay
worked:

* ``sampler``: a tiny-model PLMS block sampler after its capture;
* ``graph``: a bare captured ``torch.cuda.CUDAGraph``;
* ``pinned``: a pinned host tensor that a copy to the card used;
* ``none``: no garbage (the control).

    python3 tools/torch_capture_gc_probe.py [--out DIR]

Needs the card. Prints one line a trial, the card's name and power limit,
and writes the table to ``<out>/capture_gc_probe.json``.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import weakref
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

TRIALS = (  # (garbage, capture mode, where the collector runs)
    ("none", "global", "inside"),
    ("graph", "global", "inside"),
    ("pinned", "global", "inside"),
    ("sampler", "global", "inside"),
    ("sampler", "thread_local", "inside"),
    ("sampler", "global", "before"),
)


class _Cycle:
    """Holds an object in a reference cycle, so only the collector frees it."""

    def __init__(self, obj):
        self.obj, self.me = obj, self


def _garbage(torch, kind: str):
    """A weak reference to cyclic garbage holding ``kind``, or None."""
    if kind == "none":
        return None
    if kind == "graph":
        x = torch.zeros(1024, device="cuda")
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            x.add_(1)
        held = _Cycle(g)
    elif kind == "pinned":
        h = torch.ones(1 << 20, pin_memory=True)
        h.to("cuda", non_blocking=True)
        held = _Cycle(h)
    else:
        import chip_smoke
        from stedm_tpu_torch.train.host_sampler import make_host_sample_fn
        from stedm_tpu_torch.train.steps import SamplerConfig

        _, gpu, batch, x_T, sched = chip_smoke._tiny_sampling_models(torch)
        cfg = SamplerConfig(method="plms", ddim_steps=6, eta=0.0, cfg_scale=1.5,
                            rescale_phi=0.7, batched_cfg=True, downsample=4)
        held = make_host_sample_fn(gpu, sched, cfg, unroll=3)
        held(gpu, batch, x_T=x_T)      # warm-up, capture, replay
    torch.cuda.synchronize()
    ref = weakref.ref(held)
    del held
    return ref


def trial(kind: str, mode: str, where: str) -> dict:
    import torch

    gc.collect()
    gc.disable()
    ref = _garbage(torch, kind)
    gc.disable()     # the sampler's own capture turns the collector back on
    alive = ref is not None and ref() is not None
    x = torch.randn(4096, device="cuda")
    g = torch.cuda.CUDAGraph()
    err = None
    try:
        if where == "before":
            gc.collect()
        with torch.cuda.graph(g, capture_error_mode=mode):
            y = x * 2
            if where == "inside":
                gc.collect()
            y = y + 1
        g.replay()
        torch.cuda.synchronize()
        if not torch.equal(y, x * 2 + 1):
            err = "the replay gave a wrong result"
    except Exception as e:   # noqa: BLE001 - the error is the finding
        err = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    gc.enable()
    return {"garbage": kind, "mode": mode, "collect": where,
            "garbage_alive_at_capture": alive,
            "freed": ref is None or ref() is None, "ok": err is None, "error": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=REPO / "chiprun_out")
    ap.add_argument("--trial", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.trial is not None:
        print(json.dumps(trial(*TRIALS[args.trial])))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from stedm_tpu_torch._device import build_all

    build_all(["gn_silu", "flash_attention", "nearest_code"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    rows = []
    for i in range(len(TRIALS)):
        p = subprocess.run([sys.executable, __file__, "--trial", str(i)],
                           capture_output=True, text=True, cwd=REPO)
        last = (p.stdout.strip().splitlines() or [""])[-1]
        try:
            row = json.loads(last)
        except json.JSONDecodeError:
            row = dict(zip(("garbage", "mode", "collect"), TRIALS[i]), ok=False,
                       error=f"the trial process exited {p.returncode}: "
                             f"{p.stderr.strip().splitlines()[-1:]}")
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(card.strip())
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "capture_gc_probe.json").write_text(json.dumps(
        {"card": card.strip(), "trials": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
