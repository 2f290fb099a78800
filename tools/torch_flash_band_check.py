"""Build the band route's kernels (csrc/flash_band.cu) on the card and hold
them against their plain versions, then time them.

    python3 tools/torch_flash_band_check.py [--shapes B,H,T,Dh ...] [--no-time]
        [--compare-1024]

Prints ptxas's registers and spills of every kernel of the source, runs a
small check in a child process first (a hang there costs its timeout, not
the call), then at each shape the four kernels (bf16 and fp32, forward and
backward) against their plain versions with chip_smoke.py's tolerances
(bf16 2^-7, fp32 2^-16 against float64), each timed beside the plain
version and SDPA. ``--compare-1024`` times the band route against the
Dh-1024 cluster instances at [2, 1, 16384, 1024], in turns.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def build() -> None:
    from stedm_tpu_torch._device import build_all

    out = build_all(["flash_band"]).get("flash_band", "")
    lines = [ln.strip() for ln in out.splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln
             or "C75" in ln]
    print("\n".join(lines) or "flash_band: up to date", flush=True)


def run_shape(shape, time_it: bool) -> None:
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    recs = {n: cs.KernelRecord(n, "cuda", "stedm_tpu_torch/csrc/flash_band.cu", "-")
            for n in ("flash_band", "flash_band_bwd", "flash_band_f32", "flash_band_bwd_f32")}
    for row in cs.band_kernel_checks(torch, recs, scratch.zero_ if time_it else None, (shape,),
                                     time_it=time_it):
        print(row, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="*", default=["1,2,200,1152", "2,4,320,1100",
                                                     "2,1,1024,2048"])
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--compare-1024", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        run_shape(tuple(int(x) for x in args.child.split(",")), time_it=False)
        return 0
    import torch

    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    build()
    first = args.shapes[0]
    print(f"-- a child process first, at {first}", flush=True)
    subprocess.run([sys.executable, __file__, "--child", first], check=True, timeout=300)
    for s in args.shapes:
        print(f"-- {s}", flush=True)
        run_shape(tuple(int(x) for x in s.split(",")), time_it=not args.no_time)
    if args.compare_1024:
        import chip_smoke as cs

        print(cs.band_at_1024(torch), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
