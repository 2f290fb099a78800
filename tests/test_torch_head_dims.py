"""Every head dimension up to 1024 on the flash kernels' instances, and the band route above.

``head_dim_plan`` maps a head dimension onto the compiled instance that runs
it (the smallest at or above it, reading the true columns; above 512 the
multiples of 128, a cluster of Dh / 128 blocks) and, where a row is not 16
bytes long, onto zero-padded copies of the next such width; above 1024
onto the band route (``ops/flash_band.py``, held in
``tests/test_torch_wide_heads.py``). On the CPU the wrappers take
their plain versions, so the tests hold those: the padding identity the
kernels rely on, the stock Pallas TPU kernels in interpret mode at the
widths the port now runs padded and at Dh 640 and 1024 (the forward, and
the backward through ``jax.vjp``, with ``tests/test_torch_attention_bwd.py``'s
tolerances), JAX's jnp ``sdpa`` at Dh 20, 1024 and 1152 with ``jax.grad``,
a tiny STEDM at ``num_head_channels: 16`` and one whose bottleneck attends
in one head of 640, and a tiny codec whose mid-block is 640 wide (its
forward and one ``make_ae_train_step``), against JAX's. The kernels
themselves run in ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` phases 13 and 14.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_helpers import quick_jit
from jax.experimental.pallas import tpu as pltpu

from stedm_tpu.ops import blocked_attention as jattn
from stedm_tpu.ops.blocked_attention import flash_sdpa
from stedm_tpu_torch.ops import blocked_attention as pattn

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the compiled instances, by head dim, as the C entry points switch on them
# (above 512 every kernel's: one 128-column slice a cluster rank)
CLUSTERED = (640, 768, 896, 1024)
INSTANCES = {(torch.bfloat16, False): (32, 64, 128, 192, 256, 320, 384, 448, 512) + CLUSTERED,
             (torch.bfloat16, True): (32, 64, 128, 256, 512) + CLUSTERED,
             (torch.float32, False): (32, 64, 128, 192, 256, 320, 384, 448, 512) + CLUSTERED,
             (torch.float32, True): (32, 64, 128, 192, 256, 320, 384, 448, 512) + CLUSTERED}
# (fp32 Dh 4 .. 32: the Dh-32 instances at their own widths; 36: the Dh-64 ones)
PLAN_DIMS = (4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 48, 64, 96, 160, 192, 320, 384, 448, 512, 640,
             1024, 516, 520, 576, 700, 768, 1000, 1028, 1152)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", PLAN_DIMS)
def test_head_dim_plan(d, dtype, backward):
    """The width is Dh rounded up to 16 bytes (8 bf16, 4 fp32 values), the
    instance the smallest compiled one at or above it; above 1024 the band
    route, counted under its own names. A launch counts under the kernel's
    own name only at its compiled multiples of 64 up to 512. fp32 splits
    the instance into 32 columns a block at the Dh-32 instance (Dh 4 .. 32:
    a cluster of 1), else 128 or 64 (``fp32_columns``)."""
    tdt = DTYPES[dtype][1]
    plan = pattn.head_dim_plan(d, tdt, backward)
    stem = pattn.KERNELS[tdt][int(backward)]
    per_row = 8 if tdt == torch.bfloat16 else 4
    width = -(-d // per_row) * per_row
    if d > 1024:
        assert plan == (width, width) and plan.band
        assert pattn.launch_counter(stem, d) == stem.replace("flash_attention", "flash_band")
        return
    instances = INSTANCES[(tdt, backward)]
    assert plan == (min(i for i in instances if i >= width), width)
    assert pattn.INSTANCES[stem] == instances
    own = d % 64 == 0 and d <= 512 and d in instances
    assert pattn.launch_counter(stem, d) == (stem if own else f"{stem}_dh{d}")
    if tdt == torch.float32:
        cols = 32 if d <= 32 else 128 if plan.instance in (128, 256) or d > 448 else 64
        assert pattn.fp32_columns(d) == (cols, plan.instance // cols)
        assert (d <= 32) == (plan == (32, d))


def test_every_head_dim_up_to_512_has_a_kernel():
    """Dh 1 .. 512 in both dtypes and directions: a compiled instance that
    holds the width, at most 512; Dh 16 runs the bf16 kernels' Dh-32
    instances, 160 the bf16 backward's Dh-256 one, 513 the smallest cluster
    instance (640); the counters of Dh 16 and 32 exist before any launch."""
    from stedm_tpu_torch.ops import LAUNCHES

    for tdt in (torch.bfloat16, torch.float32):
        for backward in (False, True):
            stem = pattn.KERNELS[tdt][int(backward)]
            for d in range(1, 513):
                plan = pattn.head_dim_plan(d, tdt, backward)
                assert plan.instance in pattn.INSTANCES[stem] and 512 >= plan.instance >= plan.width >= d
            assert pattn.head_dim_plan(513, tdt, backward).instance == 640
            assert {f"{stem}_dh16", f"{stem}_dh32"} <= set(LAUNCHES)
    assert pattn.head_dim_plan(16, torch.bfloat16, True).instance == 32
    assert pattn.head_dim_plan(160, torch.bfloat16, True).instance == 256
    assert {"flash_band", "flash_band_bwd", "flash_band_f32", "flash_band_bwd_f32"} <= set(LAUNCHES)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_every_head_dim_up_to_1024_has_a_kernel(dtype, backward):
    """Dh 513 .. 1024: the smallest of the cluster instances (640, 768, 896,
    1024) at or above the width, so one 128-column slice a rank over 5 to 8
    ranks, counted apart as ``<kernel>_dh<Dh>``; the band route from 1025
    on. fp32 plans the same split (``fp32_plan``'s columns and cluster)."""
    stem = pattn.KERNELS[dtype][int(backward)]
    for d in range(513, 1025):
        plan = pattn.head_dim_plan(d, dtype, backward)
        assert plan.instance == next(i for i in CLUSTERED if i >= plan.width) and plan.width >= d
        assert pattn.launch_counter(stem, d) == f"{stem}_dh{d}"
        assert plan.instance // 128 <= 8
    assert pattn.head_dim_plan(1025, dtype, backward).band
    assert pattn.MAX_INSTANCE == 1024 and pattn.CLUSTER_HEAD_DIMS == CLUSTERED


WORKSPACE_DIMS = (520, 576, 640, 700, 768, 1000, 1024)


@pytest.mark.parametrize("d", WORKSPACE_DIMS)
def test_launch_plans_above_512(monkeypatch, d):
    """What the wrappers ask of the C side above 512, in both dtypes and
    directions: fp32's plan splits the instance 128 columns a block over a
    cluster of instance / 128 (5 to 8), and every workspace size is asked
    at the width the kernel reads (Dh rounded up to 16 bytes), as
    ``*_workspace(B * H, T, width)``."""
    asked = []

    def fake(stem, name, argtypes, restype=None):
        def fn(*args):
            asked.append((name, args))
            return 1000 + len(asked)
        return fn

    monkeypatch.setattr(pattn, "_kernel_fn", fake)
    b, h, t = 2, 3, 100
    for dtype in (torch.bfloat16, torch.float32):
        width = pattn.head_dim_plan(d, dtype, True).width
        assert width == pattn.head_dim_plan(d, dtype, False).width
        assert pattn.bwd_workspace_bytes(b * h, t, width, dtype) > 0
        assert asked[-1] == (pattn.KERNELS[dtype][1] + "_workspace", (b * h, t, width))
    plan = pattn.fp32_plan(b, h, t, pattn.head_dim_plan(d, torch.float32, True).width)
    run = pattn.head_dim_plan(d, torch.float32, True).instance
    assert (plan["columns"], plan["cluster"]) == (128, run // 128) and 5 <= plan["cluster"] <= 8
    width = pattn.head_dim_plan(d, torch.float32, True).width
    assert ("flash_attention_f32_workspace", (b * h, t, width)) in asked
    assert ("flash_attention_bwd_f32_workspace", (b * h, t, width)) in asked


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
@pytest.mark.parametrize("t,dh", [(1024, 16), (1024, 96), (256, 160), (256, 640), (256, 1024)])
def test_plain_attention_matches_the_stock_kernels(t, dh, dtype):
    """The port's plain forward and ``FlashAttentionFunction``'s backward
    (the plain one on the CPU) against the stock kernels at widths the
    card runs padded: Dh 16 (``num_head_channels: 16``) and 96 at T 1024
    (the kernels' multi-step body), and Dh 160 at T 256, where the stock
    kernel takes it in one step (it refuses 160 past its block); and at
    the cluster instances' Dh 640 (a 640-wide codec mid-block) and 1024
    (the landscape U-Net at ``num_heads: 1`` sampling at 256^2, T 256), one
    head."""
    jdt, tdt = DTYPES[dtype]
    r = np.random.default_rng(t + dh)
    heads = 1 if dh > 512 else 2
    q, k, v, do = (r.normal(size=(1, heads, t, dh)).astype(np.float32) for _ in range(4))
    scale = dh ** -0.25                      # per operand, as the AttentionBlock passes it
    want = _stock_forward_and_grads(q, k, v, do, scale, jdt)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = pattn.flash_attention(*leaves, scale ** 2)
    _close(out, want[0], dtype)
    out.backward(torch.from_numpy(do).to(tdt))
    for leaf, w in zip(leaves, want[1:]):
        _close(leaf.grad, w, dtype)


@pytest.mark.parametrize("impl", ["exact", "chunked"])
@pytest.mark.parametrize("dh", [20, 1024, 1152])
def test_sdpa_matches_jax_at_any_head_dim(dh, impl):
    """``sdpa`` at Dh 20 (the kernels' copy route on the card), 1024 (the
    largest cluster instance) and 1152 (the band route on the card)
    against JAX's jnp ``sdpa``, the output and
    ``jax.grad`` of sum(out * w), fp32."""
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
    """Above 512 (Dh 640, a cluster instance, and 1152, the band route) the
    kernel wrappers pass the head dimension and refuse the CPU tensor;
    ``sdpa`` under every impl and ``flash_attention`` on the CPU take their
    plain versions and count no launch."""
    from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts

    reset_launch_counts()
    for d in (640, 1152):
        q = torch.zeros(1, 1, 64, d)
        with pytest.raises(ValueError, match="CUDA tensor"):
            pattn.flash_attention_cuda(q, q, q, 0.1)
        with pytest.raises(ValueError, match="CUDA tensor"):
            pattn.flash_attention_bwd_cuda(q, q, q, q, torch.zeros(1, 1, 64), q, 0.1)
        for impl in ("exact", "chunked", "auto", "flash"):
            assert pattn.sdpa(q, q, q, 0.2, impl=impl).shape == q.shape
        assert pattn.flash_attention(q, q, q, 0.1).shape == q.shape
    assert not any(LAUNCHES.values()), LAUNCHES


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
    want = np.asarray(quick_jit(lambda p_, *a: jm.apply({"params": p_}, *a, method=jm.eps))(
        params, *map(jnp.asarray, (z, t, seg, style))))
    with torch.no_grad():
        got = pm.eps(*map(torch.from_numpy, (z, t, seg, style))).numpy()
    assert _rel(got, want) <= REL, _rel(got, want)


def test_tiny_stedm_at_one_640_wide_head_matches_jax():
    """A tiny STEDM whose U-Net attends in one head of 640 at its second
    level and in the middle block (``model_channels`` 64 x ``channel_mult``
    (1, 10), ``num_heads: 1``; the landscape U-Net at ``num_heads: 1``
    attends in one head of 1024): eps at two timesteps against JAX's, fp32
    on the CPU (tests/test_torch_model_options.py's pair and tolerance)."""
    from test_torch_model_options import REL, _rel, _stedm_pair

    jm, params, pm = _stedm_pair("hybrid", dict(model_channels=64, channel_mult=(1, 10),
                                                num_heads=1), seed=17)
    blocks = [m for m in pm.unet.modules() if type(m).__name__ == "AttentionBlock"]
    assert blocks and all(b.num_heads == 1 and b.qkv.weight.shape[1] == 640 for b in blocks)
    r = np.random.default_rng(17)
    z = r.normal(size=(2, 16, 16, 3)).astype(np.float32)
    seg = r.normal(size=(2, 16, 16, 3)).astype(np.float32)
    style = r.normal(size=(2, 512)).astype(np.float32)
    t = np.array([10, 600], np.int32)
    want = np.asarray(quick_jit(lambda p_, *a: jm.apply({"params": p_}, *a, method=jm.eps))(
        params, *map(jnp.asarray, (z, t, seg, style))))
    with torch.no_grad():
        got = pm.eps(*map(torch.from_numpy, (z, t, seg, style))).numpy()
    assert _rel(got, want) <= REL, _rel(got, want)


# a tiny VQ codec whose mid-block (and second level) is 640 wide: 64 x (1, 10)
# channels; at a 16^2 patch the mid-block attends over 64 tokens in one head
WIDE_DD = dict(z_channels=3, resolution=16, in_channels=3, out_ch=3, ch=64, ch_mult=[1, 10],
               num_res_blocks=1, attn_resolutions=[], dropout=0.0)


def test_codec_with_a_640_wide_mid_block_matches_jax():
    """The codec's AttnBlockVQ at 640 channels (the Dh-640 kernels on the
    card; ``ddconfig.ch_mult=[1,2,8]`` gives the shipped codec a 1024-wide
    one): the fine-tuning forward of the initial weights against JAX's
    ``training_recon``, then one ``make_ae_train_step`` of both packages
    (no LPIPS, before ``disc_start``): the logs, the update and the
    reconstruction by the updated codec (tests/_ae_helpers.py's tolerances)."""
    from _ae_helpers import check_logs, check_reconstruction, check_updates, run_steps

    run = run_steps("vq", 0.0, ddconfig=WIDE_DD, steps=1, patch=16)
    attn = run["pm"].decoder.mid.attn_1
    assert attn.q.weight.shape[:2] == (640, 640)
    want = quick_jit(lambda p_, a: run["jm"].apply({"params": p_}, a,
                                                   method=run["jm"].training_recon)[0])(
        run["gen0"], jnp.asarray(run["img"]))
    np.testing.assert_allclose(run["rec0"], np.asarray(want), rtol=1e-4, atol=1e-5)
    check_logs(run)
    check_updates(run, discriminator=False)
    check_reconstruction(run["precs"][0], run["jrecs"][0], run["rec0"])
    # before disc_start neither discriminator moves
    for k, v in run["p_disc"].items():
        if "running" not in k:
            assert torch.equal(v, run["d_before"][k]), k
            np.testing.assert_array_equal(run["j_disc"][k].numpy(), v.numpy())
