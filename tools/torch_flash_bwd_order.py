#!/usr/bin/env python3
"""What the fixed order of the flash backward's dQ accumulation costs on the card.

``stedm_tpu_torch/csrc/flash_attention_bwd.cu`` adds each 128-key tile's dQ
part in key-tile order (a turn counter per query tile and column group), so
dQ is the same bits on every run. This script builds, beside the shipped kernel, an unordered
variant made from the same source by text substitution (every key tile
reduce-adds at once into a workspace cleared by a memset; no turns), checks
both against the plain backward, and times them in turns (ordered,
unordered, unordered, ordered) with CUDA events:

    python3 tools/torch_flash_bwd_order.py

The variant is built under ``build/kernels/variants/`` and is not part of the
port. Prints the card's name and power limit beside the times.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# (shipped text, unordered text): each must occur exactly once in the source
UNORDERED = [
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
]


def build_variant() -> ctypes.CDLL:
    from stedm_tpu_torch import _device

    src = (_device.CSRC / "flash_attention_bwd.cu").read_text()
    for old, new in UNORDERED:
        if src.count(old) != 1:
            raise SystemExit(f"the shipped source no longer has the text to replace:\n{old}")
        src = src.replace(old, new)
    out = _device.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "flash_attention_bwd_unordered.cu", out / "libflash_attention_bwd_unordered.so"
    cu.write_text(src)
    subprocess.run([_device._nvcc(), *_device.NVCC_FLAGS, "-I", str(_device.CSRC), "-o", str(lib),
                    str(cu)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch

    import chip_smoke as cs
    from stedm_tpu_torch.ops import blocked_attention as a

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    lib = build_variant()
    fn = lib.flash_attention_bwd
    fn.argtypes = a._bwd_lib().argtypes
    fn.restype = ctypes.c_int

    def unordered(q, k, v, o, lse, do, s):
        b, h, t, d = q.shape
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        ws = torch.empty(a.bwd_workspace_bytes(b * h, t, d), device="cuda", dtype=torch.uint8)
        strides = [x for y in (q, k, v, o, do) for x in a.check_strided(y, "x")]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
                 b, h, t, d, (ctypes.c_int64 * 15)(*strides), float(s),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"unordered variant: cudaError {err}")
        return dq, dk, dv

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda").zero_
    gen = torch.Generator(device="cuda").manual_seed(11)
    print(f"card: {card}")
    for shape in ((8, 8, 1024, 128), (4, 8, 256, 128), (2, 4, 64, 64)):
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        s = shape[-1] ** -0.5
        o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
        ordered = lambda: a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
        free = lambda: unordered(q, k, v, o, lse, do, s)
        got_o, got_u = ordered(), free()
        ref = a.attention_backward_reference(q, k, v, o, lse, do, s)
        again_u = free()
        diffs = {n: (float((x.float() - r.float()).abs().max()),
                     float((y.float() - r.float()).abs().max()))
                 for n, x, y, r in zip(("dq", "dk", "dv"), got_o, got_u, ref)}
        runs_u = float((got_u[0].float() - again_u[0].float()).abs().max())
        times = [cs.time_ms(f, 20, flush) for f in (ordered, free, free, ordered)]
        t_o, t_u = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        print(f"{list(shape)}: ordered {t_o:.4f} ms ({times[0]:.4f}, {times[3]:.4f}), "
              f"unordered {t_u:.4f} ms ({times[1]:.4f}, {times[2]:.4f}): ordered / unordered "
              f"{t_o / t_u:.3f}; max |diff| from the plain backward (ordered, unordered) "
              + ", ".join(f"{n} {x:.3e} {y:.3e}" for n, (x, y) in diffs.items())
              + f"; unordered dq run to run {runs_u:.3e}")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
