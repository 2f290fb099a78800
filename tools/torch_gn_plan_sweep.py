#!/usr/bin/env python3
"""Times every launch plan of the GroupNorm+SiLU kernel at chip_smoke.py's
phase-2 shapes on one CUDA card; prints the device's active-cluster counts
the plans rely on (nearest code's splits: tools/torch_nearest_code_variants.py).

    python3 tools/torch_gn_plan_sweep.py [--shapes N]

For each shape: every (channel-block width, cluster size) candidate of
``ops/gn_silu._plan_for``, its kernel time from torch.profiler (L2 flushed
before each launch), whether it matches ``gn_silu_reference``, and the plan
``_launch_plan`` chose. The cost model's constants in ``ops/gn_silu.py``
come from this table.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", type=int, default=11, help="the first N phase-2 shapes")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from torch.profiler import ProfilerActivity, profile

    from stedm_tpu_torch._device import build_all, max_active_clusters
    from stedm_tpu_torch.ops import gn_silu as g

    build_all(["gn_silu"])
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda").zero_

    def kernel_us(fn, name, n=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush()
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if name in e.key]
        return sum(e.self_device_time_total for e in evs) / max(1, sum(e.count for e in evs))

    card = torch.cuda.get_device_name(0)
    print(f"card: {card}, {torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    for smem in (60000, 120000, 230000):
        print(f"gn_silu: clusters of 1..8 CTAs with {smem} B each held at once:",
              max_active_clusters("gn_silu", tuple(range(1, 9)), smem, 0))

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [((8, 64, 64, 128), "add", 1e-5), ((16, 64, 64, 640), "add", 1e-5),
             ((16, 16, 16, 1536), "add", 1e-5), ((16, 8, 8, 2048), "add", 1e-5),
             ((16, 8, 8, 1024), "film", 1e-5), ((8, 256, 256, 256), "plain", 1e-6),
             ((8, 128, 128, 128), "add", 1e-5), ((8, 32, 32, 1024), "add", 1e-5),
             ((8, 32, 32, 1024), "film", 1e-5), ((8, 512, 512, 128), "plain", 1e-6),
             ((8, 128, 128, 512), "plain", 1e-6)][:args.shapes]
    active = g._device_active(0)
    for shape, mode, eps in cases:
        b, h, w, c = shape
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
        vecs = [(0.5 * torch.randn(b, c, generator=gen, device="cuda")).to(torch.bfloat16)
                for _ in range({"plain": 0, "add": 1, "film": 2}[mode])]
        kw = dict(zip({"plain": [], "add": ["add"], "film": ["film_scale", "film_shift"]}[mode],
                      vecs))
        args = [kw.get(k) for k in ("add", "film_scale", "film_shift")]
        ref = g.gn_silu_reference(x, gamma, beta, eps=eps, **kw)
        chosen = g._launch_plan(b, h * w, c, 32, 2, active)
        print(f"{list(shape)} {mode}: chosen width {chosen['width']} cluster {chosen['cluster']} "
              f"(modelled {chosen['cost_us']:.1f} us)")
        cg = c // 32
        widths = [wd for wd in range(1, c + 1) if c % wd == 0 and wd % cg == 0 and wd % 8 == 0
                  and wd * 2 >= min(128, 2 * c) and wd <= 8 * g._THREADS]
        rows = []
        for width in widths:
            for k in range(1, 9):
                p = g._plan_for(b, h * w, c, cg, 2, width, k, active)
                if p is None:
                    continue
                out = None

                def run():
                    nonlocal out
                    out = g._launch(x, gamma, beta, *args, eps, True, g._ints(p))

                run()
                torch.cuda.synchronize()
                d = (out.float() - ref.float()).abs()
                ok = bool((d <= 2 ** -7 * ref.float().abs() + 2 ** -9).all())
                rows.append((kernel_us(run, "gn_silu_kernel"), p, ok))
        for us, p, ok in sorted(rows, key=lambda r: r[0])[:6]:
            print(f"    {us:9.1f} us  width {p['width']:4d} cluster {p['cluster']} blocks "
                  f"{p['blocks']:4d} waves {p['waves']} rows/CTA {p['rows_per_cta']:6d} "
                  f"resident {p['resident']} modelled {p['cost_us']:.1f} {'ok' if ok else 'WRONG'}")
        got = [us for us, p, _ in rows if (p["width"], p["cluster"]) ==
               (chosen["width"], chosen["cluster"])]
        print(f"    chosen: {got[0] if got else float('nan'):.1f} us; all match the plain "
              f"version: {all(ok for _, _, ok in rows)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
