"""The fp32 compute path (``diffusion.compute_dtype=float32``) on the CPU:
which flash kernel each dtype selects, with nothing launched, the fp32
kernels' launch plan (the head dimension split across a cluster, the
workspaces) and the layouts they take. A CPU tensor never reaches a kernel,
so the wrappers' dispatch is read from the C entry points they resolve.

Held elsewhere, and not repeated here: the fp32 entry points against the
JAX package (``train_ae.main``: tests/test_torch_her2_entry.py::
test_train_ae_her2_matches_jax; ``train_diff.main`` and
``predict_diff.main``: tests/test_torch_entry.py, both at
``diffusion.compute_dtype=float32``); the stock fp32 backward in interpret
mode at Dh 512 (tests/test_torch_attention_bwd.py, ``float32-1-1-256-512``).
"""

import pytest
import torch

from stedm_tpu_torch.ops import LAUNCHES
from stedm_tpu_torch.ops import blocked_attention as pattn


@pytest.fixture
def resolved(monkeypatch):
    """The (source, entry point) each wrapper asks ``_kernel_fn`` for."""
    asked = []

    def fake(stem, name, argtypes, restype=None):
        asked.append((stem, name))
        return lambda *a: 0

    monkeypatch.setattr(pattn, "_kernel_fn", fake)
    return asked


@pytest.mark.parametrize("dtype,fwd,bwd", [
    (torch.bfloat16, ("flash_attention", "flash_attention_fwd"),
     ("flash_attention_bwd", "flash_attention_bwd")),
    (torch.float32, ("flash_attention_f32", "flash_attention_f32_fwd"),
     ("flash_attention_bwd_f32", "flash_attention_bwd_f32")),
])
def test_each_dtype_selects_its_kernels(resolved, dtype, fwd, bwd):
    pattn._fwd_lib(dtype)
    pattn._bwd_lib(dtype)
    pattn.bwd_workspace_bytes(4, 100, 128, dtype)
    assert resolved == [fwd, bwd, (bwd[0], bwd[0] + "_workspace")]
    # each source counts its own launches
    assert pattn.KERNELS[dtype] == (fwd[0], bwd[0])
    assert set(pattn.KERNELS[dtype]) <= set(LAUNCHES)


def test_kernels_take_bf16_and_fp32_only():
    x = torch.zeros(1, 2, 16, 64)
    named = [("q", x), ("k", x), ("v", x)]
    assert pattn._check_dtypes(named) == torch.float32
    assert pattn._check_dtypes([(n, t.bfloat16()) for n, t in named]) == torch.bfloat16
    with pytest.raises(ValueError, match="one dtype"):
        pattn._check_dtypes([("q", x), ("k", x.bfloat16())])
    with pytest.raises(ValueError, match="take"):
        pattn._check_dtypes([(n, t.half()) for n, t in named])


@pytest.mark.parametrize("dtype,dh,match", [
    (torch.bfloat16, 192, "CUDA tensor"),        # on the Dh-256 instance
    (torch.bfloat16, 128, "CUDA tensor"),
    (torch.float32, 192, "CUDA tensor"),
    (torch.float32, 448, "CUDA tensor"),
    (torch.float32, 96, "CUDA tensor"),          # on the Dh-128 instance
    (torch.float32, 20, "CUDA tensor"),          # on the Dh-32 instance
    (torch.bfloat16, 640, "CUDA tensor"),        # a cluster of 5 blocks of 128 columns
    (torch.float32, 1024, "CUDA tensor"),        # a cluster of 8
    (torch.bfloat16, 1152, "CUDA tensor"),       # the band route above 1024
    (torch.float32, 1088, "CUDA tensor"),
])
def test_backward_head_dims_by_dtype(dtype, dh, match):
    """Both backwards take every head dimension (head_dim_plan: the bf16 one
    on its instances 32, 64, 128, 256 and 512, the fp32 one on 32 and the
    multiples of 64, both on the multiples of 128 above 512 and on the band
    route above 1024); past the gates, a CPU tensor is refused before any
    launch."""
    q = torch.zeros(1, 1, 64, dh, dtype=dtype)
    lse = torch.zeros(1, 1, 64)
    with pytest.raises(ValueError, match=match):
        pattn.flash_attention_bwd_cuda(q, q, q, q, lse, q, 0.1)


def test_fp32_strided_views_of_the_attention_block():
    """The U-Net's AttentionBlock at fp32: q, k, v as views of the packed
    ``[B, T, H, 3, Dh]`` projection and O token-major, all read through
    their strides (16-byte rows: 4 floats)."""
    proj = torch.zeros(2, 16, 4, 3, 64)
    for x in proj.permute(0, 2, 3, 1, 4).unbind(2):
        assert pattn.check_strided(x, "x") == (16 * 4 * 3 * 64, 3 * 64, 4 * 3 * 64)
    out = torch.empty(2, 16, 4, 64).permute(0, 2, 1, 3)
    assert pattn.check_strided(out, "out") == (16 * 4 * 64, 64, 4 * 64)
    with pytest.raises(ValueError, match="16-byte"):
        pattn.check_strided(torch.zeros(2, 2, 16, 66)[..., :64], "q")   # a 264-byte pitch


@pytest.mark.parametrize("d", [32] + list(range(64, 513, 64)) + [640, 768, 896, 1024])
def test_fp32_launch_plan_matches_the_c_side(monkeypatch, d):
    """For every instance the fp32 kernels run: the columns a block and the
    cluster size the C entry points insist on (32 columns at Dh 32, 128 at
    Dh 128, 256, 512 and above 512, else 64; Dh / columns blocks, at most 8,
    the portable cluster size), the entry points resolved with their ctypes
    signatures (the cluster size after Dh, the workspace pointer after the
    tensors), and each workspace exactly what the C side's
    ``*_workspace(B * H, T, Dh)`` returns for the launch's shape."""
    asked = {}

    def fake(stem, name, argtypes, restype=None):
        def fn(*args):
            if name.endswith("_workspace"):
                return hash((name, args)) % 10 ** 9
            raise AssertionError("nothing is launched on the CPU")
        asked[name] = (stem, len(argtypes), fn)
        return fn

    monkeypatch.setattr(pattn, "_kernel_fn", fake)
    b, h, t = 2, 3, 100
    plan = pattn.fp32_plan(b, h, t, d)
    cols = 32 if d == 32 else 128 if d in (128, 256) or d >= 512 else 64
    assert (plan["columns"], plan["cluster"]) == (cols, d // cols)
    assert plan["cluster"] * plan["columns"] == d and 1 <= plan["cluster"] <= 8
    fwd_stem, bwd_stem = pattn.KERNELS[torch.float32]
    # the instances the wrapper resolves: the fp32 forward (6 pointers, 5
    # ints: b, h, t, d and the cluster size, strides, scale, stream) and
    # backward (10 pointers, 5 ints, ...)
    assert asked[fwd_stem + "_fwd"][:2] == (fwd_stem, 6 + 5 + 3)
    assert asked[bwd_stem][:2] == (bwd_stem, 10 + 5 + 3)
    assert plan["fwd"] is asked[fwd_stem + "_fwd"][2] and plan["bwd"] is asked[bwd_stem][2]
    assert plan["fwd_workspace"] == hash((fwd_stem + "_workspace", (b * h, t, d))) % 10 ** 9
    assert plan["bwd_workspace"] == hash((bwd_stem + "_workspace", (b * h, t, d))) % 10 ** 9
