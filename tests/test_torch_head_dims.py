"""Every head dimension up to 512 on the flash kernels, and the plain path above.

``head_dim_plan`` maps a head dimension onto the compiled instance that runs
it (the smallest at or above it, reading the true columns) and, where a
row is not 16 bytes long, onto zero-padded copies of the next such width;
above 512 there is no plan, and on the card ``sdpa`` runs the plain
attention there (``flash`` raises). On the CPU the wrappers take their
plain versions, so the tests hold those: the padding identity the kernels
rely on, the stock Pallas TPU kernels in interpret mode at the widths the
port now runs padded (the forward, and the backward through ``jax.vjp``,
with ``tests/test_torch_attention_bwd.py``'s tolerances), JAX's jnp
``sdpa`` at Dh 20 and 1024 with ``jax.grad``, and a tiny STEDM at
``num_head_channels: 16`` against JAX's. The kernels themselves run in
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phase 13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stedm_tpu.ops import blocked_attention as jattn
from stedm_tpu.ops.blocked_attention import flash_sdpa
from stedm_tpu_torch.ops import blocked_attention as pattn

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the compiled instances, by head dim, as the C entry points switch on them
INSTANCES = {(torch.bfloat16, False): (32, 64, 128, 192, 256, 320, 384, 448, 512),
             (torch.bfloat16, True): (32, 64, 128, 256, 512),
             (torch.float32, False): (64, 128, 192, 256, 320, 384, 448, 512),
             (torch.float32, True): (64, 128, 192, 256, 320, 384, 448, 512)}
PLAN_DIMS = (8, 16, 20, 32, 40, 48, 64, 96, 160, 192, 320, 384, 448, 512, 640, 1024)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", PLAN_DIMS)
def test_head_dim_plan(d, dtype, backward):
    """The width is Dh rounded up to 16 bytes (8 bf16, 4 fp32 values), the
    instance the smallest compiled one at or above it; none above 512. A
    launch counts under the kernel's own name only at its compiled
    multiples of 64."""
    tdt = DTYPES[dtype][1]
    plan = pattn.head_dim_plan(d, tdt, backward)
    stem = pattn.KERNELS[tdt][int(backward)]
    if d > 512:
        assert plan is None
        return
    per_row = 8 if tdt == torch.bfloat16 else 4
    width = -(-d // per_row) * per_row
    instances = INSTANCES[(tdt, backward)]
    assert plan == (min(i for i in instances if i >= width), width)
    assert pattn.INSTANCES[stem] == instances
    own = d % 64 == 0 and d in instances
    assert pattn.launch_counter(stem, d) == (stem if own else f"{stem}_dh{d}")


def test_every_head_dim_up_to_512_has_a_kernel():
    """Dh 1 .. 512 in both dtypes and directions: a compiled instance that
    holds the width; Dh 16 runs the bf16 kernels' Dh-32 instances, 160 the
    bf16 backward's Dh-256 one; the counters of Dh 16 and 32 exist before
    any launch."""
    from stedm_tpu_torch.ops import LAUNCHES

    for tdt in (torch.bfloat16, torch.float32):
        for backward in (False, True):
            stem = pattn.KERNELS[tdt][int(backward)]
            for d in range(1, 513):
                plan = pattn.head_dim_plan(d, tdt, backward)
                assert plan.instance in pattn.INSTANCES[stem] and plan.instance >= plan.width >= d
            assert pattn.head_dim_plan(513, tdt, backward) is None
            assert {f"{stem}_dh16", f"{stem}_dh32"} <= set(LAUNCHES)
    assert pattn.head_dim_plan(16, torch.bfloat16, True).instance == 32
    assert pattn.head_dim_plan(160, torch.bfloat16, True).instance == 256
    assert "attention_plain" in LAUNCHES


@pytest.mark.parametrize("d,width", [(16, 32), (96, 128), (20, 24)])
def test_zero_padding_identity(d, width):
    """The plain forward (O and LSE) and backward on q, k, v and dO padded
    with zero columns, sliced back, are the unpadded results bit for bit in
    fp32, and the padded columns of O, dQ, dK and dV are zeros: what the
    kernels' out-of-bounds fill and the wrapper's copies rely on. One
    exception, in the plain version and not the kernels: at Dh 20 -> 24 the
    CPU's vectorised ``sum`` behind Di = rowsum(dO o O) adds in another
    order (20 is not a multiple of its vector), so dQ and dK, which take
    Di, agree there to the last bits (1e-6)."""
    r = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(r.normal(size=(2, 3, 70, d)).astype(np.float32))
                   for _ in range(4))
    s = d ** -0.5

    def pad(x):
        return torch.nn.functional.pad(x, (0, width - d))

    o, lse = pattn.attention_reference(q, k, v, s, return_lse=True)
    grads = pattn.attention_backward_reference(q, k, v, o, lse, do, s)
    o_p, lse_p = pattn.attention_reference(pad(q), pad(k), pad(v), s, return_lse=True)
    grads_p = pattn.attention_backward_reference(pad(q), pad(k), pad(v), o_p, lse_p, pad(do), s)
    assert torch.equal(lse_p, lse)
    for name, got, want in zip(("o", "dq", "dk", "dv"), (o_p, *grads_p), (o, *grads)):
        if d % 8 == 0 or name not in ("dq", "dk"):
            assert torch.equal(got[..., :d], want), name
        else:
            torch.testing.assert_close(got[..., :d], want, rtol=1e-6, atol=1e-6)
        assert not got[..., d:].any(), name


def _stock_forward_and_grads(q, k, v, do, scale, jdt):
    """The stock Pallas TPU forward and its dq, dk, dv (interpret mode), as
    fp32 numpy, at block 512 (T 1024: two steps a grid axis)."""
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: flash_sdpa(a, b, c, scale, block=512),
                           *(jnp.asarray(x, jdt) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do, jdt))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _close(got, want, dtype):
    """tests/test_torch_attention_bwd.py's tolerances."""
    got = got.float().detach().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= 2 ** -7 * (np.abs(want) + 1)), \
            float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,dh", [(1024, 16), (1024, 96), (256, 160)])
def test_plain_attention_matches_the_stock_kernels(t, dh, dtype):
    """The port's plain forward and ``FlashAttentionFunction``'s backward
    (the plain one on the CPU) against the stock kernels at widths the
    card runs padded: Dh 16 (``num_head_channels: 16``) and 96 at T 1024
    (the kernels' multi-step body), and Dh 160 at T 256, where the stock
    kernel takes it in one step (it refuses 160 past its block)."""
    jdt, tdt = DTYPES[dtype]
    r = np.random.default_rng(t + dh)
    q, k, v, do = (r.normal(size=(1, 2, t, dh)).astype(np.float32) for _ in range(4))
    scale = dh ** -0.25                      # per operand, as the AttentionBlock passes it
    want = _stock_forward_and_grads(q, k, v, do, scale, jdt)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = pattn.flash_attention(*leaves, scale ** 2)
    _close(out, want[0], dtype)
    out.backward(torch.from_numpy(do).to(tdt))
    for leaf, w in zip(leaves, want[1:]):
        _close(leaf.grad, w, dtype)


@pytest.mark.parametrize("impl", ["exact", "chunked"])
@pytest.mark.parametrize("dh", [20, 1024])
def test_sdpa_matches_jax_at_any_head_dim(dh, impl):
    """``sdpa`` at Dh 20 (the kernels' copy route on the card) and Dh 1024
    (above every kernel: the plain path on the card too) against JAX's
    jnp ``sdpa``, the output and ``jax.grad`` of sum(out * w), fp32."""
    r = np.random.default_rng(dh)
    q, k, v, w = (r.normal(size=(2, 2, 64, dh)).astype(np.float32) for _ in range(4))
    scale = dh ** -0.25

    def jloss(a, b, c):
        return jnp.sum(jattn.sdpa(a, b, c, scale, impl=impl, q_chunk=16) * w)

    want_out = np.asarray(jattn.sdpa(*map(jnp.asarray, (q, k, v)), scale, impl=impl, q_chunk=16))
    want_grads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = pattn.sdpa(*leaves, scale, impl=impl, q_chunk=16)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5, atol=1e-5)
    (out * torch.from_numpy(w)).sum().backward()
    for leaf, g in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-4)


def test_wrappers_refuse_head_dims_above_512():
    """Above 512 the kernel wrappers raise the ValueError that names
    ROADMAP.md §2 before looking at the device; ``sdpa`` on the CPU keeps
    JAX's plain path for every impl but flash's plain version."""
    q = torch.zeros(1, 1, 64, 640)
    lse = torch.zeros(1, 1, 64)
    with pytest.raises(ValueError, match="ROADMAP.md §2"):
        pattn.flash_attention_cuda(q, q, q, 0.1)
    with pytest.raises(ValueError, match="ROADMAP.md §2"):
        pattn.flash_attention_bwd_cuda(q, q, q, q, lse, q, 0.1)
    for impl in ("exact", "chunked", "auto", "flash"):
        assert pattn.sdpa(q, q, q, 0.2, impl=impl).shape == q.shape


def test_tiny_stedm_at_16_wide_heads_matches_jax():
    """A tiny STEDM whose U-Net attends in heads of 16 (the AttentionBlock
    at Dh 16 under hybrid conditioning): eps at two timesteps against JAX's,
    fp32 on the CPU (tests/test_torch_model_options.py's pair and
    tolerance)."""
    from test_torch_model_options import REL, _rel, _stedm_pair

    jm, params, pm = _stedm_pair("hybrid", {"num_head_channels": 16}, seed=16)
    blocks = [m for m in pm.unet.modules() if type(m).__name__ == "AttentionBlock"]
    assert blocks and all(b.qkv.weight.shape[1] // b.num_heads == 16 for b in blocks)
    r = np.random.default_rng(16)
    z = r.normal(size=(2, 16, 16, 3)).astype(np.float32)
    seg = r.normal(size=(2, 16, 16, 3)).astype(np.float32)
    style = r.normal(size=(2, 512)).astype(np.float32)
    t = np.array([10, 600], np.int32)
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, (z, t, seg, style)),
                               method=jm.eps))
    with torch.no_grad():
        got = pm.eps(*map(torch.from_numpy, (z, t, seg, style))).numpy()
    assert _rel(got, want) <= REL, _rel(got, want)
