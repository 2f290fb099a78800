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


@pytest.mark.parametrize("c", [64, 128, 640, 1536, 2048])
def test_gn_launch_plan_covers_whole_groups(c):
    """The Triton launch plan (pure arithmetic): column blocks hold whole
    groups and fit the block width; row chunks cover every row."""
    for b, hw in ((8, 256 * 256), (16, 8 * 8), (1, 7)):
        p = pgn._launch_plan(b, hw, c, 32)
        assert p["gpb"] * p["cg"] <= p["block_c"] and p["gpb"] >= 1
        assert p["col_blocks"] * p["gpb"] >= 32 > (p["col_blocks"] - 1) * p["gpb"]
        assert p["stats_col_blocks"] * 128 >= c
        assert p["block_g"] >= p["gpb"]
        assert p["rows_per_chunk"] % pgn._BLOCK_R == 0
        assert (p["n_chunks"] - 1) * p["rows_per_chunk"] < hw <= p["n_chunks"] * p["rows_per_chunk"]


def test_cpu_wrappers_launch_nothing():
    reset_launch_counts()
    d = _gn_inputs()
    pgn.gn_silu(torch.from_numpy(d["x"]), torch.from_numpy(d["gamma"]),
                torch.from_numpy(d["beta"]))
    q = torch.randn(1, 1, 64, 64)
    pattn.flash_attention(q, q, q, 0.125)
    pq.nearest_code(torch.randn(16, 3), torch.randn(32, 3))
    assert set(LAUNCHES) == {"gn_silu", "flash_attention", "flash_attention_bwd_dkv",
                             "flash_attention_bwd_dq", "nearest_code"}
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


def test_packed_codebook_layout():
    cb = torch.randn(8, 3)
    packed = pq.pack_codebook(cb)
    assert packed.shape == (8, 4)
    torch.testing.assert_close(packed[:, :3], cb)
    torch.testing.assert_close(packed[:, 3], (cb ** 2).sum(1))
