#!/usr/bin/env python3
"""What holds the nearest-code kernel back: warps an SM, tokens a thread, the
codebook split, and the SM clock while it runs.

``stedm_tpu_torch/csrc/nearest_code.cu`` fixes the threads of a CTA
(``THREADS``) and the tokens a thread holds in registers (``TPT``). This
script builds variants of that source with other values by text
substitution, one nvcc each, all started together, and times each at the
flagship decode's [32768 x 8192] for every codebook split (clusters of 1, 2,
4, 8 CTAs) with two shared-memory sizes: the shipped floor that keeps one CTA
on an SM, and the layout's own size, which lets several CTAs share an SM.
Every variant must give the shipped kernel's indices bit for bit. Then it
runs the fastest configuration and the shipped one back to back for a few
seconds each while ``nvidia-smi`` samples the SM clock, and prints the
kernel's issue-slot floor at the clock it read. ``--select-loop`` builds
the variants with the kernel's earlier argmin in place of the two passes,
a running (min, argmin) with a compare and two selects a pair, to compare
the two in one call:

    python3 tools/torch_nearest_code_variants.py [--out DIR] [--select-loop]

Times are CUDA-event means with the L2 flushed before each launch
(``chip_smoke.time_ms``). The variants are built under
``build/kernels/variants/`` and are not part of the port; ``--out``
receives each variant's SASS (cuobjdump). Prints the card's name and power
limit beside the times.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

N, N_EMBED = 32768, 8192
# (threads a CTA, tokens a thread); what the source ships is timed first
VARIANTS = [(128, 4), (128, 8), (256, 2), (256, 4), (512, 1), (512, 2), (512, 4), (64, 8)]

# the running (min, argmin) that replaces the two passes under --select-loop
SELECT_LOOP = """  float best[TPT];
  int best_i[TPT];
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    best[k] = INFINITY;
    best_i[k] = code0;
  }
#pragma unroll 4
  for (int j = 0; j < count; ++j) {
    const float4 c = codes[j];
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const float d = distance(z0[k], z1[k], z2[k], c);
      if (d < best[k]) {
        best[k] = d;
        best_i[k] = code0 + j;
      }
    }
  }

"""
PASSES = ("  // pass 1: the minimum of each block", "  // the slice is packed: its scratch holds")


def _select_loop(src: str) -> str:
    if any(src.count(m) != 1 for m in PASSES):
        raise SystemExit("the shipped source no longer has the two passes to replace")
    i, j = src.index(PASSES[0]), src.index(PASSES[1])
    return src[:i] + SELECT_LOOP + src[j:]


def _substitute(src: str, threads: int, tpt: int) -> str:
    for name, val in (("THREADS", threads), ("TPT", tpt)):
        lines = [ln for ln in src.splitlines() if ln.startswith(f"constexpr int {name} = ")]
        if len(lines) != 1:
            raise SystemExit(f"the shipped source no longer defines {name} on one line")
        src = src.replace(lines[0], f"constexpr int {name} = {val};")
    return src


def _shipped(src: str) -> tuple[int, int]:
    vals = {}
    for ln in src.splitlines():
        for name in ("THREADS", "TPT"):
            if ln.startswith(f"constexpr int {name} = "):
                vals[name] = int(ln.split("=")[1].split(";")[0])
    return vals["THREADS"], vals["TPT"]


def build_variants(tag: str, select_loop: bool, out_dir: Path) -> tuple[tuple[int, int], dict]:
    """One library a (threads, tokens a thread) of the shipped source (with
    the select loop if asked), compiled in parallel; the shipped pair first."""
    from stedm_tpu_torch import _device

    src = (_device.CSRC / "nearest_code.cu").read_text()
    if select_loop:
        src = _select_loop(src)
    shipped = _shipped(src)
    variants = [shipped] + [v for v in VARIANTS if v != shipped]
    vdir = _device.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for threads, tpt in variants:
        stem = f"{tag}_{threads}x{tpt}"
        cu, lib = vdir / f"{stem}.cu", vdir / f"lib{stem}.so"
        cu.write_text(_substitute(src, threads, tpt))
        procs[(threads, tpt)] = (subprocess.Popen(
            [_device._nvcc(), *_device.NVCC_FLAGS, "-I", str(_device.CSRC), "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    cuobjdump = Path(_device._nvcc()).with_name("cuobjdump")
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {key}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"variant {key[0]} threads x {key[1]} tokens: {regs[-1] if regs else log}")
        libs[key] = ctypes.CDLL(str(lib))
        if cuobjdump.exists():
            sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                                  text=True).stdout
            (out_dir / f"{tag}_{key[0]}x{key[1]}.sass").write_text(sass)
    return shipped, libs


def layout(split: int, tile: int, floor: int) -> dict:
    """``ops/quantize._launch_plan``'s shared-memory layout for a tile of
    ``tile`` tokens, with ``floor`` as the least shared memory a CTA asks for."""
    cpc = -(-(-(-N_EMBED // split)) // 4) * 4
    scratch_off = 16 * cpc
    bar_off = scratch_off + max(12 * cpc, 8 * tile)
    return dict(split=split, codes_per_cta=cpc, scratch_off=scratch_off, bar_off=bar_off,
                smem=max(bar_off + 16, floor))


def sm_clock_while(torch, fn, seconds: float) -> tuple[float, float, float]:
    """Median SM clock and power (nvidia-smi, every 100 ms) while ``fn`` runs
    back to back for ``seconds``, and the mean ms a launch over that run."""
    mon = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        launches, t0 = 0, time.perf_counter()
        start.record()
        while time.perf_counter() - t0 < seconds:
            for _ in range(100):
                fn()
            launches += 100
            torch.cuda.current_stream().synchronize()
        end.record()
        end.synchronize()
    finally:
        mon.terminate()
        text, _ = mon.communicate(timeout=30)
    rows = [ln.split(",") for ln in text.splitlines() if ln.count(",") == 1]
    # the first readings may predate the load
    clocks = [float(r[0]) for r in rows[2:]] or [float("nan")]
    power = [float(r[1]) for r in rows[2:]] or [float("nan")]
    return statistics.median(clocks), statistics.median(power), start.elapsed_time(end) / launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=REPO / "build" / "nearest_code_variants",
                    help="directory for the variants' SASS")
    ap.add_argument("--select-loop", action="store_true",
                    help="vary the kernel with a running (min, argmin) in place of the two passes")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from stedm_tpu_torch._device import ONE_PER_SM
    from stedm_tpu_torch.ops import quantize as qz

    args.out.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    print(f"card: {card}")
    tag = "nearest_code_select" if args.select_loop else "nearest_code"
    print(f"kernel: csrc/nearest_code.cu{' with the select loop' if args.select_loop else ''}")
    shipped, libs = build_variants(tag, args.select_loop, args.out)
    gen = torch.Generator(device="cuda").manual_seed(3)
    z = torch.randn(N, 3, generator=gen, device="cuda")
    cb = torch.randn(N_EMBED, 3, generator=gen, device="cuda")
    want = qz.nearest_code_cuda(z, cb)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda").zero_
    stream = torch.cuda.current_stream().cuda_stream
    props = torch.cuda.get_device_properties(0)
    rows = []
    for (threads, tpt), lib in libs.items():
        launch = lib.nearest_code_launch
        launch.argtypes = qz._lib().argtypes
        launch.restype = ctypes.c_int
        active = lib.nearest_code_max_active_clusters
        active.argtypes, active.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        tile = threads * tpt
        tiles = -(-N // tile)
        for floor_name, floor in (("one CTA an SM", ONE_PER_SM), ("own size", 0)):
            for split in (1, 2, 4, 8):
                if tile % split:
                    continue
                p = layout(split, tile, floor)
                out = torch.empty(N, dtype=torch.int32, device="cuda")

                def run(launch=launch, p=p, out=out):
                    err = launch(z.data_ptr(), cb.data_ptr(), out.data_ptr(), N, N_EMBED,
                                 p["split"], p["codes_per_cta"], p["scratch_off"], p["bar_off"],
                                 p["smem"], stream)
                    if err:
                        raise RuntimeError(f"launch failed: cudaError {err}")

                run()
                torch.cuda.synchronize()
                same = bool(torch.equal(out, want))
                ms = cs.time_ms(run, 20, flush)
                held = active(split, p["smem"])
                per_sm = min(props.max_threads_per_multi_processor // threads,
                             228 * 1024 // (p["smem"] + 1024))
                warps = min(tiles * split, held * split) * threads // 32 / props.multi_processor_count
                rows.append((ms, threads, tpt, floor_name, split, run))
                print(f"  {threads:3d} threads x {tpt} tokens (tile {tile:4d}), {floor_name:13s}, "
                      f"split {split}: {ms:.4f} ms; {tiles * split:4d} CTAs, {p['smem']:6d} B "
                      f"each, <= {per_sm} an SM, clusters held at once {held:3d}, "
                      f"warps an SM in the first wave {warps:5.1f}; indices "
                      f"{'equal the shipped kernel' if same else 'DIFFER'}")
                if not same:
                    return 1
    rows.sort(key=lambda r: r[0])
    print("fastest five:")
    for ms, threads, tpt, floor_name, split, _ in rows[:5]:
        print(f"  {ms:.4f} ms  {threads} threads x {tpt} tokens, {floor_name}, split {split}")
    shipped_run = lambda: qz.nearest_code_cuda(z, cb)
    best = rows[0]
    for name, fn in (("shipped kernel and plan", shipped_run),
                     (f"fastest of {tag} ({best[1]} x {best[2]}, {best[3]}, split "
                      f"{best[4]})", best[5]),
                     ("shipped kernel and plan", shipped_run)):
        mhz, watts, ms = sm_clock_while(torch, fn, 3.0)
        # one warp instruction a clock on each of an SM's 4 schedulers
        floor = {k: k * N * N_EMBED / (props.multi_processor_count * 4 * 32 * mhz * 1e6) * 1e3
                 for k in (9, 7)}
        print(f"{name}: {ms:.4f} ms a launch back to back (L2 warm), SM clock {mhz:.0f} MHz "
              f"(median of nvidia-smi readings), {watts:.0f} W; issue-slot floor at that clock "
              f"({props.multi_processor_count} SMs): {floor[9]:.4f} ms at 9 slots a pair, "
              f"{floor[7]:.4f} ms at 7")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
