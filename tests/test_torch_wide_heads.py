"""The band route above head dimension 1024 (``ops/flash_band.py``) on the CPU.

Above the largest cluster instance (Dh 1024) every head dimension runs the
band route: ``head_dim_plan`` gives it a plan at every width, and the
wrappers take its plain versions on CPU tensors, band by band (the products
with their epilogues, the row pass), so the tests hold those: the plan's
bands and workspace, the plain forward and backward (through
``FlashAttentionFunction``) against JAX's exact ``sdpa`` with ``jax.grad``
and the stock Pallas TPU kernel in interpret mode at Dh 1152 and 2048, the
route over several bands against one band, and the codec's AttnBlockVQ at
1152 channels against JAX's through the weight bridge. The kernels
themselves run in ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``
phase 15.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_helpers import ATOL, RTOL, jax_apply, load, nhwc_to_nchw, random_params, to_numpy_nhwc
from jax.experimental.pallas import tpu as pltpu

from stedm_tpu.models import vq as jvq
from stedm_tpu.ops import blocked_attention as jattn
from stedm_tpu.ops.blocked_attention import flash_sdpa
from stedm_tpu_torch.models import vq as pvq
from stedm_tpu_torch.ops import blocked_attention as pattn
from stedm_tpu_torch.ops import flash_band
from stedm_tpu_torch.utils import weights

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BAND_COUNTERS = {"flash_attention": "flash_band", "flash_attention_bwd": "flash_band_bwd",
                 "flash_attention_f32": "flash_band_f32",
                 "flash_attention_bwd_f32": "flash_band_bwd_f32"}


def test_every_head_dim_above_1024_has_a_band_plan():
    """Dh 1025 .. 4096 in both dtypes and directions: the band route, reading
    the width (Dh rounded up to 16 bytes) as its instance; launches counted
    under the band kernels' names; 1024 stays on the cluster instance."""
    for dtype, per_row in ((torch.bfloat16, 8), (torch.float32, 4)):
        for backward in (False, True):
            stem = pattn.KERNELS[dtype][int(backward)]
            for d in range(1025, 4097):
                width = -(-d // per_row) * per_row
                plan = pattn.head_dim_plan(d, dtype, backward)
                assert plan == (width, width) and plan.band
                assert pattn.launch_counter(stem, d) == BAND_COUNTERS[stem]
            plan = pattn.head_dim_plan(1024, dtype, backward)
            assert plan == (1024, 1024) and not plan.band


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_band_plan_covers_every_row_within_the_budget(dtype, backward):
    """At the main paths' shapes (the one-head U-Net at Dh 2048, the
    2048-wide codec at 256^2 and 512^2, Dh 4096, a ragged T): the bands
    cover every (head, row) once, in copy groups of heads; a band's buffers
    fit ``BAND_BYTES``; a head split into bands of rows takes a multiple of
    128 rows a band; a copy group fits ``COPY_BYTES`` or is one head."""
    per_score = flash_band._score_bytes(dtype == torch.float32, backward)
    for bh, t, w in ((16, 256, 2048), (2, 4096, 2048), (2, 16384, 2048), (2, 1024, 4096),
                     (3, 2500, 1152)):
        plan = flash_band.band_plan(bh, t, w, dtype, backward)
        seen = np.zeros((bh, t), np.int64)
        for c0, z, g, r0, m in plan.chunks:
            assert c0 % plan.group == 0 and z + g <= plan.group and g <= plan.heads
            seen[c0 + z:c0 + z + g, r0:r0 + m] += 1
        assert (seen == 1).all()
        assert plan.tp == -(-t // 8) * 8
        assert plan.heads * plan.rows * plan.tp * per_score <= flash_band.BAND_BYTES
        assert plan.rows == t or (plan.heads == 1 and plan.rows % 128 == 0)
        per_head = flash_band._copy_bytes_a_head(t, plan.tp, w, dtype == torch.float32,
                                                 backward)
        assert plan.group == 1 or plan.group * per_head <= flash_band.COPY_BYTES


def _stock(q, k, v, do, scale, jdt):
    """The stock Pallas TPU forward and its dq, dk, dv (interpret mode), as
    fp32 numpy."""
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: flash_sdpa(a, b, c, scale, block=128),
                           *(jnp.asarray(x, jdt) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do, jdt))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _exact(q, k, v, do, scale, jdt):
    """JAX's exact sdpa and its jax.vjp, as fp32 numpy."""
    out, vjp = jax.vjp(lambda a, b, c: jattn.sdpa(a, b, c, scale, impl="exact"),
                       *(jnp.asarray(x, jdt) for x in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *vjp(jnp.asarray(do, jdt)))]


def _close(got, want, dtype):
    """tests/test_torch_attention_bwd.py's tolerances: fp32 1e-5 absolute;
    bf16 2^-7 (|want| + 1)."""
    got = got.float().detach().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= 2 ** -7 * (np.abs(want) + 1)), \
            float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [1152, 2048])
def test_band_route_matches_jax_and_the_stock_kernel(dh, dtype):
    """The port's forward and ``FlashAttentionFunction``'s backward (the band
    route's plain versions on the CPU) at one head, T 128, against JAX's
    exact sdpa with ``jax.vjp`` and the stock Pallas kernel in interpret
    mode (one 128-row block, as the JAX package's tests run it)."""
    jdt, tdt = DTYPES[dtype]
    r = np.random.default_rng(dh)
    q, k, v, do = (r.normal(size=(1, 1, 128, dh)).astype(np.float32) for _ in range(4))
    scale = dh ** -0.25                      # per operand, as the AttentionBlock passes it
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = pattn.flash_attention(*leaves, scale ** 2)
    out.backward(torch.from_numpy(do).to(tdt))
    got = [out] + [x.grad for x in leaves]
    for want in (_exact(q, k, v, do, scale, jdt), _stock(q, k, v, do, scale, jdt)):
        for g, w in zip(got, want):
            _close(g, w, dtype)


def test_several_bands_agree_with_one():
    """The plain route over bands of 128 rows and copy groups of one head
    (a small budget) against one band a call, forward and backward: each
    row's softmax sees the whole row and each output row one band, so only
    the CPU's summation order in products of other shapes moves them: fp32
    within 1e-5 of the largest value; bf16 within 2^-7 of it (a P or dS
    element rounded to bf16 the other way moves its products by up to 2^-8
    of their terms)."""
    r = np.random.default_rng(3)
    for tdt in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.from_numpy(r.normal(size=(1, 3, 300, 1032)).astype(np.float32))
                       .to(tdt) for _ in range(4))
        s = 1032 ** -0.5
        o, lse = flash_band.forward_plain(q, k, v, s, return_lse=True)
        grads = flash_band.backward_plain(q, k, v, o, lse, do, s)
        budget = flash_band.BAND_BYTES, flash_band.COPY_BYTES
        try:
            # the backward's bands hold 128 rows of 304 scores; the forward's too
            flash_band.BAND_BYTES = flash_band._score_bytes(tdt == torch.float32, True) * 304 * 128
            flash_band.COPY_BYTES = 1
            plan = flash_band.band_plan(3, 300, 1032, tdt, True)
            assert (plan.group, plan.heads, plan.rows, len(plan.chunks)) == (1, 1, 128, 9)
            o2, lse2 = flash_band.forward_plain(q, k, v, s, return_lse=True)
            grads2 = flash_band.backward_plain(q, k, v, o, lse, do, s)
        finally:
            flash_band.BAND_BYTES, flash_band.COPY_BYTES = budget
        for a, b in zip((o, lse, *grads), (o2, lse2, *grads2)):
            tol = (1e-5 if tdt == torch.float32 else 2 ** -7) * float(a.float().abs().max())
            torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)


def test_codec_attention_at_1152_channels_matches_jax():
    """The codec's AttnBlockVQ at 1152 channels (the band route on the card)
    on an 8 x 8 input against JAX's through the weight bridge (fp32,
    tests/test_torch_models.py's tolerance)."""
    x = np.random.default_rng(11).normal(size=(1, 8, 8, 1152)).astype(np.float32)
    jm = jvq.AttnBlockVQ()
    params = random_params(jm, 12, jnp.asarray(x))
    pm = load(pvq.AttnBlockVQ(1152), weights.vq_state_dict(params))
    want = jax_apply(jm, params, jnp.asarray(x))
    with torch.no_grad():
        got = to_numpy_nhwc(pm(nhwc_to_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
