"""Nearest code at every embedding width and codebook size, the port against
the JAX package on the CPU: the plain version (which defines the CUDA
kernels' numerics and runs wherever a tensor lies on the CPU) against JAX's
Pallas kernel in interpret mode and JAX's jnp branch; the kernel choice and
shared-memory plan of the wrapper (``_launch_plan``, pure arithmetic) over
token counts, codebook sizes and widths; and a tiny VQ codec with a
4-wide codebook (CompVis vq-f8's width) encoding, quantizing and decoding
against JAX's. Indices must be equal except at fp32 near-ties: where two
indices differ, both codes' distances (in float64) lie within 1e-5 (1 +
|z|^2) of the token's least distance (``_codes_agree``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_helpers import ATOL, RTOL, jax_init, quick_compile, random_params

from stedm_tpu.models import vq as jvq
from stedm_tpu.ops.quantize import _nearest_code_pallas
from stedm_tpu.ops.quantize import nearest_code as jnearest_code
from stedm_tpu_torch._device import SMEM_LIMIT
from stedm_tpu_torch.models import vq as pvq
from stedm_tpu_torch.ops import quantize as pq
from stedm_tpu_torch.utils import weights


def _codes_agree(got, ref, z, cb):
    """Equal indices, except at near-ties of fp32 rounding: there both
    codes lie within 1e-5 (1 + |z|^2) of the least float64 distance, the
    rounding of ||c||^2 - 2 z.c at these magnitudes (as test_torch_ops's
    ``_assert_codes_agree``, which also bounds how many may differ: at width
    1 a codebook of 2048 normal codes holds many such ties)."""
    diff = np.nonzero(got != ref)[0]
    if not diff.size:
        return
    z64, cb64 = z[diff].astype(np.float64), cb.astype(np.float64)
    d = ((z64[:, None, :] - cb64[None]) ** 2).sum(-1)
    best = d.min(1)
    tol = 1e-5 * (1.0 + (z64 ** 2).sum(1))
    rows = np.arange(diff.size)
    assert np.all(d[rows, got[diff]] - best <= tol), diff
    assert np.all(d[rows, ref[diff]] - best <= tol), diff


def _codes(n, n_embed, width, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, width)).astype(np.float32),
            r.normal(size=(n_embed, width)).astype(np.float32))


# the TPU kernel's range: widths up to 8, codebooks in multiples of 2048;
# 3 x 8192 is vq-f4's, 4 x 16384 vq-f8's, 8 x 16384 vq-f16's
@pytest.mark.parametrize("width,n_embed", [(1, 2048), (3, 8192), (4, 16384), (8, 16384)])
def test_plain_version_matches_the_tpu_kernel(width, n_embed):
    z, cb = _codes(1500, n_embed, width, width)              # not tile-aligned
    got = pq.nearest_code(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    assert got.dtype == np.int32 and got.shape == (1500,)
    pal = np.asarray(_nearest_code_pallas(jnp.asarray(z), jnp.asarray(cb), interpret=True))
    _codes_agree(got, pal, z, cb)


def test_plain_version_matches_jax_beyond_the_kernel():
    """Width 16 and 5000 codes: JAX's nearest_code takes its jnp branch."""
    z, cb = _codes(700, 5000, 16, 16)
    got = pq.nearest_code(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    want = np.asarray(jnearest_code(jnp.asarray(z), jnp.asarray(cb)))
    _codes_agree(got, want, z, cb)


@pytest.mark.parametrize("n", [1, 1000, 32768, 131072, 524288])
@pytest.mark.parametrize("n_embed", [5, 8192, 16384, 65536])
def test_launch_plan_takes_every_size_and_width(n, n_embed):
    """No codebook size or width raises; each plan fits a block's shared
    memory at one CTA an SM; the ranks of a cluster cover every code once,
    in code order; every token lies in one tile. Width 3 keeps the resident
    kernel while its slice fits (the shipped 3 x 8192 always)."""
    for width in range(1, 17):
        p = pq._launch_plan(n, n_embed, width)
        assert p["split"] in pq._SPLITS and pq._TILE % p["split"] == 0
        assert 118784 <= p["smem"] <= SMEM_LIMIT
        assert (p["tiles"] - 1) * pq._TILE < n <= p["tiles"] * pq._TILE
        if p["kernel"] == "resident":
            assert width == 3
            assert p["bar_off"] + 16 <= p["smem"]
            per = p["codes_per_cta"]
            ranks = [range(r * per, min((r + 1) * per, n_embed)) for r in range(p["split"])]
        else:
            w, chunk = p["w"], p["chunk"]
            assert w > width and w % 4 == 0 and (width <= 3 or w % 8 == 0)
            assert chunk * w <= pq._CHUNK_FLOATS and (chunk * w * 4) % 16 == 0
            assert p["res_off"] >= 2 * chunk * w * 4 and p["bar_off"] >= p["res_off"] + 8 * pq._TILE
            assert p["bar_off"] % 8 == 0 and p["bar_off"] + 16 <= p["smem"]
            assert p["split"] <= p["n_chunks"] and p["split"] * p["chunks_per_cta"] >= p["n_chunks"]
            cpc = p["chunks_per_cta"]
            ranks = [range(min(r * cpc * chunk, n_embed), min((r + 1) * cpc * chunk, n_embed))
                     for r in range(p["split"])]
        assert [c for sl in ranks for c in sl] == list(range(n_embed))
        if width == 3 and n_embed == 8192:
            assert p["kernel"] == "resident"
        if n <= 32768 and n_embed <= 16384 and width == 3:
            assert p["kernel"] == "resident"
        if width == 3 and n_embed == 16384 and n > 33792:    # above 66 tiles the split is 1
            assert p["kernel"] == "stream"


def test_vq_codec_with_a_four_wide_codebook_matches_jax():
    """A tiny VQModelInterface at embed_dim 4 and 4096 codes: encode,
    quantize (indices) and decode against JAX's, fp32 on the CPU, tolerance
    rtol 1e-3 / atol 2e-4 (tests/_port_helpers.py)."""
    dd = dict(double_z=False, z_channels=4, resolution=32, in_channels=3, out_ch=3, ch=32,
              ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0)
    x = np.random.default_rng(6).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jm = jvq.VQModelInterface(embed_dim=4, n_embed=4096, ddconfig=dd)
    params = random_params(jm, 7, jnp.asarray(x))
    pm = pvq.VQModelInterface(embed_dim=4, n_embed=4096, ddconfig=dd)
    pm.load_state_dict(weights.codec_state_dict(params), strict=True)
    h = jm.apply({"params": params}, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        got_h = pm.encode(torch.from_numpy(x))
        np.testing.assert_allclose(got_h.numpy(), np.asarray(h), rtol=RTOL, atol=ATOL)
        hz = torch.from_numpy(np.array(h))
        _, _, idx = pm.quantize(hz, with_loss=True)
        got = pm.decode(hz).numpy()
    _, _, jidx = jm.apply({"params": params}, h, True, method=lambda m, a, w: m.quantize(a, w))
    flat = np.asarray(h).reshape(-1, 4)
    cb = np.asarray(params["quantize"]["embedding"])
    _codes_agree(idx.numpy().reshape(-1), np.asarray(jidx).reshape(-1), flat, cb)
    want = jm.apply({"params": params}, h, method=jm.decode)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_train_ae_with_vq_f16s_codebook_matches_jax(tmp_path, monkeypatch):
    """``train_ae.main`` with CompVis vq-f16's codebook width on a tiny codec
    (embed_dim and z_channels 8, 16384 codes), two steps and a validation
    against JAX's ``train_ae.main`` from the same initial weights, as
    tests/test_torch_her2_entry.py::test_train_ae_her2_matches_jax holds the
    3-wide codec: the epoch's mean logs at rtol 1e-4, the validation's at
    1e-3 (atol 1e-6); the count of codes used within one code."""
    import functools
    import json

    import jax
    import train_ae as jtrain_ae
    from _her2_helpers import HER2_OVERRIDES, write_her2_tree

    import stedm_tpu.data.loader as jloader
    from stedm_tpu.config import compose as jcompose
    from stedm_tpu.train.vae_losses import VAELossConfig as JLossConfig
    from stedm_tpu.train.vae_losses import build_discriminator as jbuild_disc
    from stedm_tpu_torch import train_ae
    from stedm_tpu_torch.data.loader import ConcatDataset
    from stedm_tpu_torch.train import checkpoints

    p = "diffusion.first_stage_config.params"
    args = HER2_OVERRIDES + [
        "data.samples=4", "num_epochs=1", "lr=1e-3", "diffusion.compute_dtype=float32",
        f"{p}.ddconfig.ch=32", f"{p}.ddconfig.ch_mult=[1,2]", f"{p}.ddconfig.num_res_blocks=1",
        f"{p}.embed_dim=8", f"{p}.ddconfig.z_channels=8", f"{p}.n_embed=16384",
        "loss.disc_start=1", "loss.disc_weight=0.5", "loss.disc_ndf=16", "loss.disc_num_layers=2"]
    tree = write_her2_tree(tmp_path / "data")
    jcfg = jcompose("config_ae", args)
    jmodel, _ = jtrain_ae.build_codec(jcfg, jnp.float32)
    with jax_init("memo"):   # JAX's main makes these inits again
        gen = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
        dvars = jbuild_disc(JLossConfig(**dict(jcfg.loss))).init(
            jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    build_codec, build_disc = train_ae.build_codec, train_ae.build_discriminator

    def codec_from_jax(fs, dtype):
        model, variant = build_codec(fs, dtype=dtype)
        model.load_state_dict(weights.codec_state_dict(np_tree(gen)), strict=True)
        return model, variant

    def disc_from_jax(cfg):
        disc = build_disc(cfg)
        disc.load_state_dict(weights.discriminator_state_dict(
            np_tree(dvars["params"]), np_tree(dvars["batch_stats"])), strict=True)
        return disc

    monkeypatch.setattr(jloader.ConcatDataset, "__getitem__", ConcatDataset.__getitem__)
    monkeypatch.setattr(train_ae, "build_codec", codec_from_jax)
    monkeypatch.setattr(train_ae, "build_discriminator", disc_from_jax)
    where = lambda r: [f"location.data_dir={tree}", f"location.result_dir={tmp_path / r}"]
    with quick_compile(), jax_init("memo"):
        jtrain_ae.main(args + where("jax"))
    out = train_ae.main(args + where("port"), device="cpu")
    assert out["step"] == 2 and out["variant"] == "vq"
    events = [[json.loads(line) for line in (tmp_path / r / "ae_her2" / "events.jsonl")
               .read_text().splitlines()] for r in ("jax", "port")]
    jev, pev = events
    assert [sorted(e) for e in pev] == [sorted(e) for e in jev]
    for je, pe, rtol in zip(jev, pev, (1e-4, 1e-3)):
        for key, want in je.items():
            if key.endswith("cluster_usage"):
                # the codes used, a mean over the steps: an fp32 near-tie
                # among 16384 codes spread 1e-4 apart (taming's init) may
                # move one step's count by one code
                assert abs(pe[key] - want) <= 1.0, (key, pe[key], want)
            elif key not in ("ts", "epoch_time_s", "step", "epoch"):
                np.testing.assert_allclose(pe[key], want, rtol=rtol, atol=1e-6, err_msg=key)
    saved = checkpoints.load(tmp_path / "port" / "ae_her2" / "ckpt" / "ae_her2_last")
    assert tuple(saved["params"]["quantize.embedding.weight"].shape) == (16384, 8)
