#!/usr/bin/env python3
"""Whether the fp32 flash kernels need their short wgmma chains: variants with
long chains, made from the shipped sources by text substitution, held to
phase 10a's tolerances against float64 and timed against the shipped kernels.

The tensor cores truncate as they accumulate (measured on mma.sync for the
first fp32 kernels), so the shipped kernels start a fresh accumulator every
4 k-steps (12 wgmma) and add it to the fp32 sum in registers with one
rounding to nearest. The ``long`` variants drop that:

* forward (``csrc/flash_attention_f32.cu``): S in one chain over the block's
  columns, and O accumulated by the wgmmas across all key tiles (O rescaled
  in registers before each tile's P V);
* backward (``csrc/flash_attention_bwd_f32.cu``): S^T and dP^T in one chain
  over the block's columns, and dK and dV accumulated by the wgmmas across
  all query tiles.

Each variant is built again under ``build/kernels/variants/`` (each old text
must occur exactly once). For each shape the script prints, for the shipped
kernel and the variant, the worst error against the plain version's steps in
float64 as a share of phase 10a's tolerance (2^-16 (P|V| + |ref|) forward,
2^-16 (sqrt(sum terms^2) + |ref|) for each gradient) and the times in turns
(shipped, variant, variant, shipped), with the card's name and power limit::

    python3 tools/torch_flash_f32_variants.py [--kernel fwd|bwd ...]

The variants are not part of the port.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

FWD_LONG = [
    ("""    s_chain(0, pa);
#pragma unroll
    for (int ch = 1; ch < NCH; ++ch) {
      if (ch % 2) s_chain(ch, pb); else s_chain(ch, pa);
      wgmma::wait<1>();
      if (ch % 2) s_fold(ch - 1, pa); else s_fold(ch - 1, pb);
    }
    wgmma::wait<0>();
    s_fold(NCH - 1, pb);
""", """    (void)pa;
    (void)pb;
    fresh(s);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int item = it + ch / 2;
      if (ch % 2 == 0) wait_item(item);
      const uint32_t a = dbase + ch * SUBB;
      const uint32_t b = slot_addr(item) + (ch % 2) * SUBB + CW * 32 * 128;
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss3(s, a + kk * 32, C::Q_PART, b + kk * 32, ITEM_PART, false);
      wgmma::commit();
    }
    wgmma::wait<0>();
    fence_operand(s);
    for (int c = 0; c < NC; ++c) mbar_arrive(empty((it + c) % NSLOT));
"""),
    ("""    pv_chain(0, qa);
#pragma unroll
    for (int c = 1; c < NC; ++c) {
      if (c % 2) pv_chain(c, qb); else pv_chain(c, qa);
      wgmma::wait<1>();
      if (c % 2) pv_fold(c - 1, qa); else pv_fold(c - 1, qb);
    }
    wgmma::wait<0>();
    if (NC % 2) pv_fold(NC - 1, qa); else pv_fold(NC - 1, qb);
""", """    (void)qa;
    (void)qb;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];
      const int item = it + c;
      wait_item(item);
      const uint32_t b = slot_addr(item) + CW * SUBB;
      fence_operand(o[c]);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) rs3(o[c], ph[kk], pl[kk], b + kk * 32, ITEM_PART, false);
      wgmma::commit();
    }
    wgmma::wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      fence_operand(o[c]);
      mbar_arrive(empty((it + c) % NSLOT));
    }
"""),
]

BWD_LONG = [
    ("""    x_chain(0, pa);
#pragma unroll
    for (int ch = 1; ch < NX; ++ch) {
      if (ch % 2) x_chain(ch, pb); else x_chain(ch, pa);
      wgmma::wait<1>();
      if (ch % 2) x_fold(ch - 1, pa); else x_fold(ch - 1, pb);
    }
    wgmma::wait<0>();
    x_fold(NX - 1, pb);
""", """    fresh(x);
#pragma unroll
    for (int ch = 0; ch < NX; ++ch) {
      const int item = it + CW * NC + ch / 2;
      if (ch % 2 == 0) wait_item(item);
      const uint32_t a = dbase + CW * C::V_OFF + ch * BKV * 128;
      const uint32_t b = slot_addr(item) + (ch % 2) * BQ * 128;
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss3(x, a + kk * 32, C::KV_PART, b + kk * 32, ITEM_PART, false);
      wgmma::commit();
    }
    wgmma::wait<0>();
    fence_operand(x);
    for (int c = 0; c < NC; ++c) free_item(it + CW * NC + c);
"""),
    ("""    g_chain(0, pa);
#pragma unroll
    for (int c = 1; c < 2 * NC; ++c) {
      if (c % 2) g_chain(c, pb); else g_chain(c, pa);
      wgmma::wait<1>();
      if (c % 2) g_fold(c - 1, pa); else g_fold(c - 1, pb);
    }
    wgmma::wait<0>();
    g_fold(2 * NC - 1, pb);
""", """#pragma unroll
    for (int c = 0; c < 2 * NC; ++c) {
      const int item = it + (2 + CW) * NC + c / 2;
      if (c % 2 == 0) wait_item(item);
      const uint32_t b = slot_addr(item) + (c % 2) * 32 * 128;
      fence_operand(dg[c]);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) rs3(dg[c], ah[kk], al[kk], b + kk * 32, ITEM_PART, false);
      wgmma::commit();
    }
    wgmma::wait<0>();
#pragma unroll
    for (int c = 0; c < 2 * NC; ++c) fence_operand(dg[c]);
    for (int c = 0; c < NC; ++c) free_item(it + (2 + CW) * NC + c);
"""),
]

# kernel: (source stem, substitutions, shapes [B, H, T, Dh] of phase 10a)
KERNELS = {
    "fwd": ("flash_attention_f32", FWD_LONG, ((8, 8, 1024, 128), (2, 1, 16384, 512),
                                             (1, 1, 2500, 512))),
    "bwd": ("flash_attention_bwd_f32", BWD_LONG, ((2, 8, 1024, 128), (2, 1, 4096, 512),
                                                 (2, 1, 16384, 512))),
}


def build_variant(kernel: str) -> ctypes.CDLL:
    from stedm_tpu_torch import _device

    stem, subs, _ = KERNELS[kernel]
    src = (_device.CSRC / f"{stem}.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"the shipped source no longer has the text to replace:\n{old}")
        src = src.replace(old, new)
    out = _device.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / f"{stem}_long.cu", out / f"lib{stem}_long.so"
    cu.write_text(src)
    res = subprocess.run([_device._nvcc(), *_device.NVCC_FLAGS, "-I", str(_device.CSRC), "-o",
                          str(lib), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for the {kernel} variant:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib))


def variant_fn(kernel: str):
    """The long variant's C entry point with the shipped one's signature."""
    import torch

    from stedm_tpu_torch.ops import blocked_attention as a

    lib = build_variant(kernel)
    if kernel == "fwd":
        fn = lib.flash_attention_f32_fwd
        fn.argtypes, fn.restype = a._fwd_lib(torch.float32).argtypes, ctypes.c_int
    else:
        fn = lib.flash_attention_bwd_f32
        fn.argtypes, fn.restype = a._bwd_lib(torch.float32).argtypes, ctypes.c_int
    return fn


def fwd_errors(torch, got, q, k, v, s) -> float:
    """The worst |got - ref| / 2^-16 (P|V| + |ref|) over the batch, ref in float64."""
    worst = 0.0
    for i in range(q.shape[0]):
        Q, K, V = (x[i:i + 1].double() for x in (q, k, v))
        P = torch.softmax((Q @ K.transpose(-1, -2)) * s, -1)
        ref = P @ V
        tol = 2 ** -16 * (P @ V.abs() + ref.abs())
        worst = max(worst, float(((got[i:i + 1].double() - ref).abs() / tol).max()))
        del P, ref, tol
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", action="append", choices=sorted(KERNELS),
                    help="kernels to run (default: both)")
    names = ap.parse_args().kernel or list(KERNELS)
    import torch

    import chip_smoke as cs
    from stedm_tpu_torch.ops import blocked_attention as a

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda").zero_
    gen = torch.Generator(device="cuda").manual_seed(13)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    print(f"card: {card}")
    for name in names:
        fn = variant_fn(name)
        for shape in KERNELS[name][2]:
            b, h, t, d = shape
            plan = a.fp32_plan(b, h, t, d)
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
            s = d ** -0.5
            strides = [x for y in (q, k, v, q) for x in a.check_strided(y, "x")]
            if name == "fwd":
                ws = torch.empty(plan["fwd_workspace"], device="cuda", dtype=torch.uint8)
                out = torch.empty_like(q)

                def var():
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                             ws.data_ptr(), b, h, t, d, plan["cluster"],
                             (ctypes.c_int64 * 12)(*strides), float(s), stream())
                    if err:
                        raise RuntimeError(f"long forward: cudaError {err}")
                    return out

                shipped = lambda: a.flash_attention_cuda(q, k, v, s)
                e_s, e_v = fwd_errors(torch, shipped(), q, k, v, s), fwd_errors(torch, var(), q, k,
                                                                                v, s)
                errs = f"O {e_s:.3f} {e_v:.3f}"
            else:
                o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
                ws = torch.empty(plan["bwd_workspace"], device="cuda", dtype=torch.uint8)
                grads = [torch.empty_like(q) for _ in range(3)]
                bstrides = strides[:9] + [x for y in (o, do) for x in a.check_strided(y, "x")]

                def var():
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             do.data_ptr(), lse.data_ptr(), *(g.data_ptr() for g in grads),
                             ws.data_ptr(), b, h, t, d, plan["cluster"],
                             (ctypes.c_int64 * 15)(*bstrides), float(s), stream())
                    if err:
                        raise RuntimeError(f"long backward: cudaError {err}")
                    return grads

                shipped = lambda: a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
                worst = {}
                for tag, got in (("shipped", shipped()), ("long", [g.clone() for g in var()])):
                    for i in range(b):
                        sl = slice(i, i + 1)
                        ref, bounds = cs._f64_backward(torch, q[sl], k[sl], v[sl], o[sl], lse[sl],
                                                       do[sl], s)
                        for j, n in enumerate(("dq", "dk", "dv")):
                            r = cs._ratio(torch, got[j][sl], ref[j],
                                          cs.F32_REL * (bounds[j] + ref[j].abs()))
                            worst[(tag, n)] = max(worst.get((tag, n), 0.0), r)
                        del ref, bounds
                errs = ", ".join(f"{n} {worst[('shipped', n)]:.3f} {worst[('long', n)]:.3f}"
                                 for n in ("dq", "dk", "dv"))
            torch.cuda.synchronize()
            iters = 10 if t <= 4096 else 3
            times = [cs.time_ms(f, iters, flush) for f in (shipped, var, var, shipped)]
            t_s, t_v = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
            print(f"{name} {list(shape)}: of the tolerance against float64 (shipped, long): "
                  f"{errs}; shipped {t_s:.4f} ms, long {t_v:.4f} ms", flush=True)
            del q, k, v, do
            torch.cuda.empty_cache()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
