#!/usr/bin/env python3
"""Variants of the flash-attention backward, made from the shipped source by
text substitution, held by phase 2b's test and timed against the shipped kernel.

``stedm_tpu_torch/csrc/flash_attention_bwd.cu`` is built again under
``build/kernels/variants/`` with one named table of substitutions applied
(each old text must occur exactly once in the source):

* ``unordered``: every key tile reduce-adds its dQ part at once into a
  workspace cleared by a memset, with no turns: what the fixed order that
  keeps dQ the same bits on every run costs. Its gradients are right (its
  dQ's bits vary run to run);
* ``local``: at Dh 256, 512 and 1024 each block of the cluster makes P and
  dS from its own 128-column partials of S and dP, with no exchange through
  distributed shared memory: what the exchange costs. Its gradients are
  wrong, and phase 2b's test (``chip_smoke.backward_errors``) must reject them.

For each variant and shape the script checks the shipped kernel and the
variant against the plain backward with phase 2b's tolerance, and times both
in turns (shipped, variant, variant, shipped) with CUDA events. It exits
non-zero if the test rejects the shipped kernel or the right variant, or
accepts the wrong one::

    python3 tools/torch_flash_bwd_variants.py [--variant unordered|local ...]

Prints the card's name and power limit beside the times. The variants are
not part of the port.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# name: (substitutions, whether its gradients are right, shapes [B, H, T, Dh])
VARIANTS = {
    "unordered": ([
        ("""          if (kt > 0) {
            while (ld_acquire(turn) < kt) {
            }
            asm volatile("fence.proxy.async.global;\\n" ::: "memory");
          }
          if (kt == 0)   // the first part is stored, the others are added to it
            bulk_store(acc, dq_s + c * C::DQ_BYTES, C::DQ_BYTES);
          else
            bulk_reduce_add_f32(acc, dq_s + c * C::DQ_BYTES, C::DQ_BYTES);
""", """          (void)turn;
          bulk_reduce_add_f32(acc, dq_s + c * C::DQ_BYTES, C::DQ_BYTES);
"""),
        ("""          if (kt + 1 < p.nk) {
            bulk_wait();                           // the sums are written: pass the turn on
            asm volatile("fence.proxy.async.global;\\n" ::: "memory");
            __threadfence();
            atomicAdd(turn, 1);
          }
""", ""),
        ("""  const dim3 tiles(l.nq, b * h);
""", """  const dim3 tiles(l.nq, b * h);
  cudaMemsetAsync(acc, 0, l.bytes - l.acc_off, stream);
"""),
    ], True, ((8, 8, 1024, 128), (4, 8, 256, 128), (2, 4, 64, 64), (2, 1, 4096, 512),
              (2, 1, 16384, 512))),
    "local": ([
        ("""      if constexpr (CL > 1) {
        exchange(i, st, dp, lse2, di, pa, dsa);
      } else {
""", """      {
"""),
    ], False, ((2, 1, 4096, 512), (1, 1, 2500, 512), (2, 1, 16384, 512), (2, 2, 4096, 256),
               (2, 1, 16384, 1024))),
}


def build_variant(name: str) -> ctypes.CDLL:
    from stedm_tpu_torch import _device

    src = (_device.CSRC / "flash_attention_bwd.cu").read_text()
    for old, new in VARIANTS[name][0]:
        if src.count(old) != 1:
            raise SystemExit(f"the shipped source no longer has the text to replace:\n{old}")
        src = src.replace(old, new)
    out = _device.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / f"flash_attention_bwd_{name}.cu", out / f"libflash_attention_bwd_{name}.so"
    cu.write_text(src)
    subprocess.run([_device._nvcc(), *_device.NVCC_FLAGS, "-I", str(_device.CSRC), "-o", str(lib),
                    str(cu)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def launcher(name: str):
    """The variant's backward with flash_attention_bwd_cuda's signature."""
    import torch

    from stedm_tpu_torch.ops import blocked_attention as a

    fn = build_variant(name).flash_attention_bwd
    fn.argtypes, fn.restype = a._bwd_lib(torch.bfloat16).argtypes, ctypes.c_int

    def run(q, k, v, o, lse, do, s):
        b, h, t, d = q.shape
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        ws = torch.empty(a.bwd_workspace_bytes(b * h, t, d), device="cuda", dtype=torch.uint8)
        strides = [x for y in (q, k, v, o, do) for x in a.check_strided(y, "x")]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
                 b, h, t, d, (ctypes.c_int64 * 15)(*strides), float(s),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} variant: cudaError {err}")
        return dq, dk, dv

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", choices=sorted(VARIANTS),
                    help="variants to run (default: all)")
    names = ap.parse_args().variant or list(VARIANTS)
    import torch

    import chip_smoke as cs
    from stedm_tpu_torch.ops import blocked_attention as a

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda").zero_
    gen = torch.Generator(device="cuda").manual_seed(11)
    print(f"card: {card}")
    failed = []
    for name in names:
        _, right, shapes = VARIANTS[name]
        variant = launcher(name)
        for shape in shapes:
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                           for _ in range(4))
            s = shape[-1] ** -0.5
            o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
            shipped = lambda: a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
            var = lambda: variant(q, k, v, o, lse, do, s)
            got_s, got_v, again_v = shipped(), var(), var()
            err_s, err_v = cs.backward_errors(torch, q, k, v, o, lse, do, s, got_s, got_v)
            worst_s, worst_v = (max(r for _, r in e.values()) for e in (err_s, err_v))
            runs_v = float((got_v[0].float() - again_v[0].float()).abs().max())
            del got_s, got_v, again_v
            if worst_s > 1 or (worst_v <= 1) != right:
                failed.append(f"{name} {list(shape)}")
            iters = 20 if shape[2] <= 4096 else 5
            times = [cs.time_ms(f, iters, flush) for f in (shipped, var, var, shipped)]
            t_s, t_v = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
            print(f"{name} {list(shape)}: shipped {t_s:.4f} ms ({times[0]:.4f}, {times[3]:.4f}), "
                  f"variant {t_v:.4f} ms ({times[1]:.4f}, {times[2]:.4f}): variant / shipped "
                  f"{t_v / t_s:.3f}; phase 2b's test (max |err| / tolerance, shipped, variant) "
                  + ", ".join(f"{n} {err_s[n][1]:.3f} {err_v[n][1]:.3f}" for n in err_s)
                  + f": variant {'accepted' if worst_v <= 1 else 'rejected'} (its gradients are "
                  f"{'right' if right else 'wrong'}); variant dq run to run {runs_v:.3e}")
    print(f"card: {card}")
    if failed:
        print("phase 2b's test judged wrongly: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
