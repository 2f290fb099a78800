"""The port's kernel modules (GroupNorm+SiLU, attention, nearest code) on the
CPU, against the JAX package's plain functions and its Pallas kernels run in
interpret mode. On CPU tensors the port's wrappers take their plain versions,
which define the kernels' numerics."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_helpers import ATOL, RTOL  # noqa: F401  (also caps torch threads)

from stedm_tpu.ops import blocked_attention as jattn
from stedm_tpu.ops.gn_silu import _gn_silu_pallas, gn_silu_reference
from stedm_tpu.ops.quantize import _nearest_code_pallas, nearest_code_reference
from stedm_tpu_torch.ops import LAUNCHES, reset_launch_counts
from stedm_tpu_torch.ops import blocked_attention as pattn
from stedm_tpu_torch.ops import gn_silu as pgn
from stedm_tpu_torch.ops import quantize as pq

B, H, W, C, G = 2, 8, 8, 128, 32


def _gn_inputs(c=C, seed=0):
    r = np.random.default_rng(seed)
    return dict(x=r.normal(size=(B, H, W, c)).astype(np.float32),
                gamma=r.normal(1, 0.1, (c,)).astype(np.float32),
                beta=r.normal(0, 0.1, (c,)).astype(np.float32),
                add=r.normal(size=(B, c)).astype(np.float32),
                fs=r.normal(0, 0.1, (B, c)).astype(np.float32),
                fsh=r.normal(0, 0.1, (B, c)).astype(np.float32))


def _gn_args(d, mode):
    add = d["add"] if mode == "add" else None
    fs = d["fs"] if mode == "film" else None
    fsh = d["fsh"] if mode == "film" else None
    return add, fs, fsh


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("mode,silu", [("plain", True), ("add", True),
                                       ("film", True), ("plain", False)])
def test_gn_silu_matches_jax_reference_and_pallas(mode, silu, eps):
    d = _gn_inputs()
    add, fs, fsh = _gn_args(d, mode)
    got = pgn.gn_silu(torch.from_numpy(d["x"]), torch.from_numpy(d["gamma"]),
                      torch.from_numpy(d["beta"]), add=_t(add), film_scale=_t(fs),
                      film_shift=_t(fsh), eps=eps, apply_silu=silu).numpy()
    jargs = [None if a is None else jnp.asarray(a) for a in (add, fs, fsh)]
    ref = np.asarray(gn_silu_reference(jnp.asarray(d["x"]), d["gamma"], d["beta"],
                                       *jargs, groups=G, eps=eps, apply_silu=silu))
    pal = np.asarray(_gn_silu_pallas(jnp.asarray(d["x"]), jnp.asarray(d["gamma"]),
                                     jnp.asarray(d["beta"]), *jargs, groups=G, eps=eps,
                                     apply_silu=silu, interpret=True))
    # fp32 statistics summed in another order: a few ulps of the unit-scale output
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)


def test_gn_silu_group_width_not_a_power_of_two():
    # C = 640 (U-Net decoder concat 512 + 128) gives 20 channels a group
    d = _gn_inputs(c=640, seed=1)
    got = pgn.gn_silu(torch.from_numpy(d["x"]), torch.from_numpy(d["gamma"]),
                      torch.from_numpy(d["beta"]), add=torch.from_numpy(d["add"])).numpy()
    ref = np.asarray(gn_silu_reference(jnp.asarray(d["x"]), d["gamma"], d["beta"],
                                       jnp.asarray(d["add"])))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# (B, HW, C): every GN shape chip_smoke.py checks on the card, then the
# card tests' shapes (ragged HW = 35 with 3 channels a group, an empty last
# CTA, and the resident and re-read cases)
_GN_PLAN_SHAPES = [(8, 64 * 64, 128), (16, 64 * 64, 640), (16, 16 * 16, 1536), (16, 8 * 8, 2048),
                   (16, 8 * 8, 1024), (8, 256 * 256, 256), (8, 128 * 128, 128), (8, 32 * 32, 1024),
                   (8, 512 * 512, 128), (8, 128 * 128, 512), (2, 8 * 8, 128), (2, 16 * 16, 640),
                   (3, 7 * 5, 96), (3, 3 * 3, 96), (1, 128 * 128, 128), (2, 96 * 96, 256), (1, 256 * 256, 64)]
# shapes whose slab is read twice in part: a (sample, channel block) of
# 128-byte rows does not fit a cluster of at most 8 CTAs (the VQ shapes, the
# 512^2 U-Net level 0 and the card tests' re-read cases), or fits only in
# several waves of clusters, which the cost model prices above one wave that
# streams ([16, 64^2, 640]: 5.2 MB a sample); every other shape stays resident
_GN_REREAD = {(16, 64 * 64, 640), (8, 256 * 256, 256), (8, 128 * 128, 128), (8, 512 * 512, 128),
              (8, 128 * 128, 512), (1, 128 * 128, 128), (1, 256 * 256, 64)}


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("b,hw,c", _GN_PLAN_SHAPES)
def test_gn_launch_plan_covers_whole_groups(b, hw, c, elem_bytes):
    """The CUDA launch plan (pure arithmetic): channel blocks of whole groups
    and 16-byte TMA boxes, every row of a sample in exactly one CTA's boxes,
    the shared memory within the H100's limit, portable clusters, and the
    resident or re-read choice the design predicts."""
    p = pgn._launch_plan(b, hw, c, 32, elem_bytes)
    vec = 16 // elem_bytes
    assert p["width"] % p["cg"] == 0 and p["width"] * p["col_blocks"] == c
    assert p["groups_per_block"] * p["cg"] == p["width"]
    assert p["width"] % p["box_cols"] == 0 and p["box_cols"] <= 256
    assert p["box_cols"] % vec == 0 and p["box_rows"] <= 256
    assert p["boxes_per_stage"] * p["box_cols"] == p["width"]
    assert (p["width"] // vec) * p["row_phases"] <= pgn._THREADS
    assert 1 <= p["cluster"] <= 8                   # at most 16; portable sizes only
    # every row once: rank r holds rows [r * rows_per_cta, ...) in whole boxes
    seen = []
    for rank in range(p["cluster"]):
        r0 = rank * p["rows_per_cta"]
        rows = max(0, min(hw - r0, p["rows_per_cta"]))
        boxes = -(-rows // p["box_rows"])
        assert boxes * p["box_rows"] <= p["rows_per_cta"]
        seen += [r0 + j * p["box_rows"] + r for j in range(boxes) for r in range(p["box_rows"])
                 if j * p["box_rows"] + r < rows]
    assert seen == list(range(hw))
    # shared memory: the slots, the sums, the group statistics and the
    # barriers one after another, within what a block may use
    n_boxes = p["rows_per_cta"] // p["box_rows"]
    assert 1 <= p["slots"] <= min(32, n_boxes)
    assert p["box_stride"] % 128 == 0 and p["box_stride"] >= p["box_rows"] * p["box_cols"] * elem_bytes
    assert p["slots"] * p["stage_stride"] <= p["red_off"]
    assert p["red_off"] + 2 * p["row_phases"] * p["width"] * 4 <= p["part_off"]
    assert p["part_off"] + 2 * p["groups_per_block"] * 4 <= p["gstat_off"]
    assert p["gstat_off"] + 2 * p["groups_per_block"] * 4 <= p["bar_off"]
    assert p["bar_off"] + 8 * p["slots"] + 128 <= p["smem"] <= 232448
    # resident: every box has its slot; else all boxes stream through the slots
    assert p["resident"] == (n_boxes <= p["slots"])
    if elem_bytes == 2:
        assert p["resident"] == ((b, hw, c) not in _GN_REREAD)


def test_gn_launch_plan_empty_last_cta_and_fills_the_card():
    # 9 rows over 8 CTAs of 2: the last three have no rows (the card tests' case)
    p = pgn._plan_for(3, 9, 96, 3, 2, 96, 8, pgn._H100_ACTIVE)
    assert p["cluster"] == 8 and p["rows_per_cta"] == 2 and p["blocks"] == 24
    # a cluster a (sample, block) and no more clusters than the device holds
    # at once: the chosen plans run in one wave at the sampling shapes
    for b, hw, c in _GN_PLAN_SHAPES[:5]:
        assert pgn._launch_plan(b, hw, c, 32, 2)["waves"] == 1
    with pytest.raises(ValueError):
        pgn._launch_plan(2, 64, 100, 32, 2)


def test_cpu_wrappers_launch_nothing():
    reset_launch_counts()
    d = _gn_inputs()
    pgn.gn_silu(torch.from_numpy(d["x"]), torch.from_numpy(d["gamma"]),
                torch.from_numpy(d["beta"]))
    q = torch.randn(1, 1, 64, 64)
    pattn.flash_attention(q, q, q, 0.125)
    pq.nearest_code(torch.randn(16, 3), torch.randn(32, 3))
    assert set(LAUNCHES) == {"gn_silu", "flash_attention", "flash_attention_bwd",
                             "nearest_code", "flash_attention_f32", "flash_attention_bwd_f32",
                             "nearest_code_stream", "flash_attention_dh32",
                             "flash_attention_bwd_dh32", "flash_attention_f32_dh32",
                             "flash_attention_bwd_f32_dh32", "gn_silu_film",
                             "flash_attention_dh16", "flash_attention_bwd_dh16",
                             "flash_attention_f32_dh16", "flash_attention_bwd_f32_dh16",
                             "flash_band", "flash_band_bwd", "flash_band_f32",
                             "flash_band_bwd_f32"}
    assert not any(LAUNCHES.values()), LAUNCHES


def _qkv(shape, seed):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 8, 64, 32), (1, 1, 64, 64)])
def test_sdpa_exact_and_chunked_match_jax(shape):
    q, k, v = _qkv(shape, seed=shape[-1])
    scale = float(shape[-1]) ** -0.25
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ref = np.asarray(jattn._exact(jq, jk, jv, scale))
    np.testing.assert_allclose(pattn.sdpa(tq, tk, tv, scale, impl="exact").numpy(),
                               ref, rtol=RTOL, atol=ATOL)
    got = pattn.sdpa(tq, tk, tv, scale, impl="chunked", q_chunk=16).numpy()
    want = np.asarray(jattn.chunked_sdpa(jq, jk, jv, scale, q_chunk=16))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    # the kernel's plain version: sm_scale is the square of the per-operand scale
    flash = pattn.sdpa(tq, tk, tv, scale, impl="flash").numpy()
    np.testing.assert_allclose(flash, ref, rtol=RTOL, atol=ATOL)
    assert pattn.sdpa(tq, tk, tv, scale, impl="auto").shape == tq.shape


def _packed_views(b, t, h, dh, seed):
    """q, k, v as ``[B, H, T, Dh]`` views of one packed ``[B, T, H, 3, Dh]``
    projection, the layout the U-Net's AttentionBlock hands the kernel."""
    proj = np.random.default_rng(seed).normal(size=(b, t, h, 3, dh)).astype(np.float32)
    return torch.from_numpy(proj).permute(0, 2, 3, 1, 4).unbind(2)


@pytest.mark.parametrize("b,t,h,dh", [(2, 64, 4, 32), (1, 50, 2, 64)], ids=["even", "ragged"])
def test_attention_on_strided_views_equals_contiguous_and_jax(b, t, h, dh):
    q, k, v = _packed_views(b, t, h, dh, seed=t)
    assert not q.is_contiguous() and q.stride(-1) == 1
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    scale = float(dh) ** -0.25
    ref = np.asarray(jattn.sdpa(*(jnp.asarray(x.numpy()) for x in (qc, kc, vc)), scale,
                                impl="exact"))
    for impl in ("exact", "chunked", "flash", "auto"):
        got = pattn.sdpa(q, k, v, scale, impl=impl)
        assert torch.equal(got, pattn.sdpa(qc, kc, vc, scale, impl=impl)), impl
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    got = pattn.flash_attention(q, k, v, scale ** 2)
    assert torch.equal(got, pattn.flash_attention(qc, kc, vc, scale ** 2))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    # merging the heads behind the attention gives the same values either way
    merged = got.transpose(1, 2).reshape(b, t, h * dh)
    np.testing.assert_allclose(merged.numpy(), ref.transpose(0, 2, 1, 3).reshape(b, t, h * dh),
                               rtol=RTOL, atol=ATOL)


def test_attention_gradients_through_strided_views_match_contiguous():
    """Under autograd the Function makes its inputs contiguous; the gradient
    still reaches the packed projection, equal to the contiguous graph's."""
    proj = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 40, 2, 3, 64))
                            .astype(np.float32))
    grads = []
    for contiguous in (False, True):
        leaf = proj.clone().requires_grad_()
        q, k, v = leaf.permute(0, 2, 3, 1, 4).unbind(2)
        if contiguous:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        pattn.flash_attention(q, k, v, 0.125).square().sum().backward()
        grads.append(leaf.grad)
    assert torch.equal(*grads) and float(grads[0].abs().max()) > 0


def test_check_strided_accepts_the_packed_layout():
    proj = torch.zeros(2, 16, 4, 3, 64, dtype=torch.bfloat16)
    for x in proj.permute(0, 2, 3, 1, 4).unbind(2):
        assert pattn.check_strided(x, "x") == (16 * 4 * 3 * 64, 3 * 64, 4 * 3 * 64)
    out = torch.empty(2, 16, 4, 64, dtype=torch.bfloat16).permute(0, 2, 1, 3)
    assert pattn.check_strided(out, "out") == (16 * 4 * 64, 64, 4 * 64)
    # a dimension of size 1 reports the row length, whatever torch says of it
    one = torch.empty(2, 1, 16, 64, dtype=torch.bfloat16)
    assert pattn.check_strided(one, "one") == (16 * 64, 64, 64)


@pytest.mark.parametrize("case", ["last_stride", "token_pitch", "base", "dtype", "rank"])
def test_check_strided_refusals(case):
    base = torch.zeros(2, 2, 16, 72, dtype=torch.bfloat16)
    bad = {
        "last_stride": lambda: base.transpose(2, 3)[..., :64],  # last dimension strided
        "token_pitch": lambda: torch.zeros(2, 2, 16, 68, dtype=torch.bfloat16)[..., :64],
        "base": lambda: base[..., 4:68],                        # rows start 8 bytes off
        "dtype": lambda: base.half()[..., :64],                 # the kernels take bf16 and fp32
        "rank": lambda: base[0, ..., :64],
    }[case]()
    with pytest.raises(ValueError):
        pattn.check_strided(bad, "q")
    assert pattn.check_strided(base[..., :64], "q") == (2 * 16 * 72, 16 * 72, 72)
    # fp32 (the fp32 kernels): the same 16-byte rule, 4 floats
    assert pattn.check_strided(base.float()[..., :64], "q") == (2 * 16 * 72, 16 * 72, 72)
    assert pattn.check_strided(base.float()[..., 4:68], "q") == (2 * 16 * 72, 16 * 72, 72)
    with pytest.raises(ValueError):
        pattn.check_strided(base.float()[..., 2:66], "q")     # rows start 8 bytes off


def test_flash_attention_cuda_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        pattn.flash_attention_cuda(q, q, q, 0.125)


def test_sdpa_rejects_unknown_impl():
    q = torch.zeros(1, 1, 4, 64)
    with pytest.raises(ValueError):
        pattn.sdpa(q, q, q, 1.0, impl="blocked")


def _assert_codes_agree(got, ref, z, cb):
    """Equal indices, except where the two best distances tie within fp32
    rounding; there the distances (in float64) must be equal to that tolerance."""
    diff = np.nonzero(got != ref)[0]
    assert diff.size <= max(1, got.size // 1000), diff.size
    z64, cb64 = z.astype(np.float64), cb.astype(np.float64)
    for i in diff:
        d_got = np.sum((z64[i] - cb64[got[i]]) ** 2)
        d_ref = np.sum((z64[i] - cb64[ref[i]]) ** 2)
        # fp32 rounding of ||c||^2 - 2 z.c at these magnitudes
        assert abs(d_got - d_ref) <= 1e-5 * (1.0 + np.sum(z64[i] ** 2)), (i, d_got, d_ref)


def test_nearest_code_matches_jax_reference_and_pallas():
    r = np.random.default_rng(0)
    z = r.normal(size=(1500, 3)).astype(np.float32)          # not tile-aligned
    cb = r.normal(size=(4096, 3)).astype(np.float32)
    got = pq.nearest_code(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    assert got.dtype == np.int32
    ref = np.asarray(nearest_code_reference(jnp.asarray(z), jnp.asarray(cb)))
    pal = np.asarray(_nearest_code_pallas(jnp.asarray(z), jnp.asarray(cb), interpret=True))
    _assert_codes_agree(got, ref, z, cb)
    _assert_codes_agree(got, pal, z, cb)


def test_nearest_code_ties_go_to_lowest_index():
    cb = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0], [0, 1.0, 0]])
    z = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0.5, 0.5, 0]])
    assert pq.nearest_code(z, cb).tolist() == [0, 1, 0]


@pytest.mark.parametrize("n,n_embed", [(32768, 8192), (3000, 5000), (1500, 4096), (64, 256),
                                         (100, 5), (5000, 1030)])
def test_nearest_code_plan_covers_every_code_once(n, n_embed):
    """Rank r of a cluster takes codes [r * codes_per_cta, ...): the ranks'
    slices are in code order and cover the codebook once, each starting on a
    16-byte boundary for its bulk copy; every token lies in one tile."""
    p = pq._launch_plan(n, n_embed)
    assert p["split"] in (1, 2, 4, 8) and pq._TILE % p["split"] == 0
    assert p["codes_per_cta"] % 4 == 0
    slices = [range(r * p["codes_per_cta"], min((r + 1) * p["codes_per_cta"], n_embed))
              for r in range(p["split"])]
    assert [c for sl in slices for c in sl] == list(range(n_embed))
    assert all((12 * sl.start) % 16 == 0 for sl in slices if len(sl))
    assert (p["tiles"] - 1) * pq._TILE < n <= p["tiles"] * pq._TILE
    if n == 32768:        # the flagship decode: 64 tiles, clusters of 2, 128 SMs
        assert p["split"] == 2 and p["tiles"] * p["split"] == 128
    assert p["tiles"] <= dict(zip(pq._SPLITS, pq._H100_ACTIVE))[p["split"]] or p["split"] == 1


def test_packed_codebook_layout():
    """The kernel packs its slice as float4 (c0, c1, c2, ||c||^2) from offset
    0; the scratch behind it holds the slice as it lies (12 bytes a code),
    then the CTA's (min, argmin) of each of its tokens; the barrier last."""
    for n_embed in (8192, 5000, 256, 5):
        p = pq._launch_plan(4096, n_embed)
        assert p["scratch_off"] == 16 * p["codes_per_cta"]
        assert p["bar_off"] - p["scratch_off"] >= max(12 * p["codes_per_cta"], 8 * pq._TILE)
        assert p["scratch_off"] % 16 == 0 and p["bar_off"] % 8 == 0
        assert p["bar_off"] + 16 <= p["smem"] <= 232448 and p["smem"] >= 118784
    # a slice beyond a block's shared memory takes the streaming kernel
    # (tests/test_torch_nearest_code.py holds its plan)
    p = pq._launch_plan(16, 8 * 20000)
    assert p["kernel"] == "stream" and p["smem"] <= 232448
