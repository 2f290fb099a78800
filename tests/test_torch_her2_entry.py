"""The port's entry points over the histopathology data, on the CPU, against
the JAX package's on the miniature trees of tests/_her2_helpers.py:

* ``train_diff.main data=her2``: a run with ``scale_by_std`` and a resume;
  the scale factor equals JAX's ``compute_scale_by_std`` on the same weights
  and first batch, and the layout mapper is [2 -> 3] (the entry points feed
  the one-hot collapsed to two channels);
* ``predict_diff.main data=her2 data/dataset=[her2_anno,her2_unanno]``
  against JAX's on the same weights and x_T: annotated layouts with styles
  from the scoring slides; seg PNGs equal, img PNGs within 1;
* ``train_ae.main data=her2``: two steps and a validation against JAX's
  ``train_ae.main`` on the same initial weights: the epoch's mean log
  values within the tolerance of tests/_ae_helpers.py:check_logs, the
  validation metrics within that of test_torch_ae_step.py's eval test.

JAX's ConcatDataset hands no generator on, and its tissue-mask coordinates
land 4x out on an ``ArraySlide`` (both ROADMAP §3); for the runs held
against the port it is given the port's repairs, the first as in
test_torch_seg_entry.py. The JAX package's files stay as they are.
``train_seg.main`` over the same data: test_torch_her2_seg_entry.py."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import _port_helpers  # noqa: F401  (caps torch threads)
from _flowers_helpers import TINY_OVERRIDES, jax_train_loader
from _her2_helpers import HER2_OVERRIDES, fix_jax_mask_step, write_her2_tree
from _her2_helpers import write_syn_folder
from _port_helpers import check_grain_loader, jax_init, quick_compile, random_params

import stedm_tpu.data.loader as jloader
from stedm_tpu.config import compose as jcompose
from stedm_tpu.data.dm import DataModule as JDataModule
from stedm_tpu.models.stedm import build_stedm as jbuild_stedm
from stedm_tpu.train import checkpoints as jcheckpoints
from stedm_tpu.train.steps import compute_scale_by_std as jcompute_scale_by_std
from stedm_tpu_torch import predict_diff, train_ae, train_diff
from stedm_tpu_torch.data.loader import ConcatDataset
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.utils.weights import (
    codec_state_dict,
    discriminator_state_dict,
    state_dict_from_jax,
)

SEED = 0
DIFF = TINY_OVERRIDES + HER2_OVERRIDES + ["style_sampling=nearby", "style_agg=mean",
                                          "diffusion.compute_dtype=float32"]
RUN = "diff_her2_nearby_mean"


@pytest.fixture(scope="module", autouse=True)
def jax_mask_step():
    """JAX's datasets given the port's scale of a tissue-mask coordinate
    (ROADMAP §3): predict's styles come from the scoring slides' masks."""
    with pytest.MonkeyPatch.context() as mp:
        fix_jax_mask_step(mp)
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = write_her2_tree(tmp_path_factory.mktemp("her2"))
    write_syn_folder(root, "her2", size=72)
    return root


def _where(data, results):
    return [f"location.data_dir={data}", f"location.result_dir={results}"]


def _events(run_dir):
    return [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]


def _jax_stedm_params(cfg, seed: int):
    model = jbuild_stedm(cfg)
    p = cfg.data.patch_size
    return model, random_params(model, seed, jnp.zeros((1, p, p, 3)), jnp.zeros((1, p, p, 2)),
                                jnp.zeros((1, 1, p, p, 3)), jnp.zeros((1,), jnp.int32))


def test_train_diff_her2_against_jax_scale_factor(tree, tmp_path, monkeypatch):
    overrides = DIFF + _where(tree, tmp_path) + ["accumulate_grad_batches=1",
                                                 "+diffusion.scale_by_std=true"]
    jcfg = jcompose("config_diff", overrides)
    jcfg.data.batch_size = jcfg.data.batch_size or jcfg.data.batch_base
    jmodel, jparams = _jax_stedm_params(jcfg, 3)
    sd = state_dict_from_jax(jparams)
    build = train_diff.build_stedm

    def build_with_jax_weights(cfg, device=None, **kw):
        model = build(cfg, device, **kw)
        model.load_state_dict(sd, strict=True)
        return model

    monkeypatch.setattr(train_diff, "build_stedm", build_with_jax_weights)
    first = train_diff.main(overrides, device="cpu")
    assert first["step"] == 3 and np.isfinite(first["epochs"][0]["loss"])
    run_dir = tmp_path / RUN
    saved = checkpoints.load(run_dir / "ckpt" / f"{RUN}_last")
    assert tuple(saved["params"]["cond_stage.channel_mapper.weight"].shape) == (3, 2, 1, 1)

    jdm = JDataModule(jcfg)
    jdm.setup()
    img = np.asarray(next(iter(jax_train_loader(jdm, SEED)))[0])
    want = jcompute_scale_by_std(jmodel, jparams, jnp.asarray(img))
    got = json.loads((run_dir / "scale_factor.json").read_text())["scale_factor"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    resumed = train_diff.main(overrides + ["+resume=true", "num_epochs=2"], device="cpu")
    assert resumed["start_step"] == 3 and resumed["step"] == 6


def _pairs(folder):
    imgs, segs = sorted(folder.glob("img_*.png")), sorted(folder.glob("seg_*.png"))
    assert [p.name[4:] for p in imgs] == [p.name[4:] for p in segs]
    return [np.array(Image.open(p)) for p in imgs], [np.array(Image.open(p)) for p in segs]


def test_predict_her2_matches_jax(tree, tmp_path):
    """Layouts of her2_anno with styles from her2_unanno's scoring slides,
    the same weights and x_T through both predict_diff.main."""
    import predict_diff as jpredict_diff

    overrides = DIFF + _where(tree, tmp_path) + [
        "data/dataset=[her2_anno,her2_unanno]", "data.ratios=[1.0,1.0]", "data.samples=1",
        "ddim_steps=4", "cfg_scale=1.5"]
    _, params = _jax_stedm_params(jcompose("config_predict", overrides), 5)
    jpath = tmp_path / "jax_ckpt"
    jcheckpoints.save(jpath, params, name="params")
    ppath = checkpoints.save(tmp_path / "port_ckpt", state_dict_from_jax(params), name="params")
    with jax_init("shapes"):   # every parameter is restored from jpath
        jpredict_diff.main(overrides + [f"+ckpt_path={jpath}", "+predict_name=jax"])

    def jax_x_T(batch_idx, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), batch_idx)
        return torch.from_numpy(np.asarray(jax.random.normal(key, shape, jnp.float32)))

    out = predict_diff.main(overrides + [f"+ckpt_path={ppath}", "+predict_name=port"],
                            device="cpu", x_T_fn=jax_x_T)
    assert out["pairs"] == 2
    want_img, want_seg = _pairs(tree / "syn_data" / "jax")
    got_img, got_seg = _pairs(tree / "syn_data" / "port")
    assert len(got_img) == len(want_img) == 2
    for g, w in zip(got_seg, want_seg):
        np.testing.assert_array_equal(g, w)
    assert any(len(np.unique(g)) == 2 for g in got_seg), "layouts without tumour"
    for g, w in zip(got_img, want_img):
        assert g.shape == (32, 32, 3) and g.dtype == np.uint8 and g.std() > 0
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


AE = HER2_OVERRIDES + [
    "data.samples=4", "num_epochs=1", "lr=1e-3", "diffusion.compute_dtype=float32",
    "diffusion.first_stage_config.params.ddconfig.ch=32",
    "diffusion.first_stage_config.params.ddconfig.ch_mult=[1,2]",
    "diffusion.first_stage_config.params.ddconfig.num_res_blocks=1",
    "diffusion.first_stage_config.params.n_embed=64",
    "loss.disc_start=1", "loss.disc_weight=0.5", "loss.disc_ndf=16", "loss.disc_num_layers=2",
]


def test_train_ae_her2_matches_jax(tree, tmp_path, monkeypatch):
    """Without ``lpips_ckpt`` both turn the perceptual term off; the GAN
    engages at the second step (``disc_start`` 1)."""
    import train_ae as jtrain_ae

    jcfg = jcompose("config_ae", AE)
    jmodel, _ = jtrain_ae.build_codec(jcfg, jnp.float32)
    from stedm_tpu.train.vae_losses import VAELossConfig as JLossConfig
    from stedm_tpu.train.vae_losses import build_discriminator as jbuild_disc

    with jax_init("memo"):   # JAX's main makes these inits again
        gen = jmodel.init(jax.random.PRNGKey(SEED), jnp.zeros((1, 32, 32, 3)))["params"]
        dvars = jbuild_disc(JLossConfig(**dict(jcfg.loss))).init(
            jax.random.PRNGKey(SEED + 1), jnp.zeros((1, 32, 32, 3)))
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    build_codec, build_disc = train_ae.build_codec, train_ae.build_discriminator

    def codec_from_jax(fs, dtype):
        model, variant = build_codec(fs, dtype=dtype)
        model.load_state_dict(codec_state_dict(np_tree(gen)), strict=True)
        return model, variant

    def disc_from_jax(cfg):
        disc = build_disc(cfg)
        disc.load_state_dict(discriminator_state_dict(np_tree(dvars["params"]),
                                                      np_tree(dvars["batch_stats"])), strict=True)
        return disc

    monkeypatch.setattr(jloader.ConcatDataset, "__getitem__", ConcatDataset.__getitem__)
    monkeypatch.setattr(train_ae, "build_codec", codec_from_jax)
    monkeypatch.setattr(train_ae, "build_discriminator", disc_from_jax)
    with quick_compile(), jax_init("memo"):
        jtrain_ae.main(AE + _where(tree, tmp_path / "jax"))
    out = train_ae.main(AE + _where(tree, tmp_path / "port"), device="cpu")
    assert out["step"] == 2 and out["variant"] == "vq" and out["lr"] == 1e-3
    jev, pev = _events(tmp_path / "jax" / "ae_her2"), _events(tmp_path / "port" / "ae_her2")
    assert [sorted(e) for e in pev] == [sorted(e) for e in jev]
    train, val = pev[0], pev[1]
    assert train["train/disc_factor"] == 0.5 and train["train/p_loss"] == 0.0
    for je, pe, rtol in zip(jev, pev, (1e-4, 1e-3)):
        for key, want in je.items():
            if key not in ("ts", "epoch_time_s", "step", "epoch"):
                np.testing.assert_allclose(pe[key], want, rtol=rtol, atol=1e-6, err_msg=key)
    assert np.isfinite(val["val/rec_loss"])
    for tag in ("last", "best"):
        saved = checkpoints.load(tmp_path / "port" / "ae_her2" / "ckpt" / f"ae_her2_{tag}")
        assert saved["format"] == "ae_state" and saved["step"] == 2
    # a warm start from the run's best codec
    warm = train_ae.main(AE + _where(tree, tmp_path / "port") + [
        "run_name=warm", "num_epochs=0",
        "diffusion.first_stage_config.params.ckpt_path=ae_her2/ckpt/ae_her2_best.pt"],
        device="cpu")
    assert warm["step"] == 0


# compvis_ckpt, once refused, now warm-starts (match None): a vq-f4 .ckpt
# under first_stage_model. goes through map_vq, every codec tensor loaded
@pytest.mark.parametrize("extra,match", [
    (["diffusion.first_stage_config.params.ckpt_path=vq-f4.ckpt"], None),
    (["diffusion.first_stage_config.params.ckpt_path=orbax_dir"], "reading a JAX orbax directory"),
    (["location.mesh.data=2"], "torch.distributed"),
    (["location.loader=grain"], None),
], ids=["compvis_ckpt", "orbax_dir", "mesh", "grain"])
def test_train_ae_refusals(tree, tmp_path, capsys, extra, match):
    (tmp_path / "orbax_dir").mkdir()
    args = AE + _where(tree, tmp_path) + extra
    if "location.loader=grain" in extra:   # once refused: the worker-process loader
        from stedm_tpu_torch.config import compose
        from stedm_tpu_torch.data.dm import DataModule

        dm = DataModule(compose("config_ae", args))
        dm.prepare_data()
        dm.setup()
        check_grain_loader(dm)
        return
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            train_ae.main(args, device="cpu")
        return
    from stedm_tpu_torch.config import compose

    codec, _ = train_ae.build_codec(_first_stage(compose("config_ae", args)))
    torch.save({"state_dict": {f"first_stage_model.{k}": v for k, v in
                               codec.state_dict().items()}}, tmp_path / "vq-f4.ckpt")
    capsys.readouterr()
    out = train_ae.main(args + ["num_epochs=0"], device="cpu")
    n = len(list(codec.parameters()))
    assert out["step"] == 0
    assert f"[torch_import] merged {n} tensors (0 left at init)" in capsys.readouterr().out


def _first_stage(cfg) -> dict:
    fs = dict(cfg.diffusion.first_stage_config)
    fs["params"] = {k: v for k, v in dict(fs["params"]).items() if k != "ckpt_path"}
    return fs


def test_train_ae_refuses_an_unstaged_tree_before_writing(tmp_path):
    with pytest.raises(NotImplementedError, match="EXACT server.*ROADMAP §1: the pull from an EXACT server"):
        train_ae.main(["data=her2", f"location.data_dir={tmp_path / 'data'}",
                       f"location.result_dir={tmp_path / 'results'}"], device="cpu")
    assert not any(tmp_path.iterdir())
