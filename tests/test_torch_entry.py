"""The port's train and predict entry points (stedm_tpu_torch/train_diff.py,
predict_diff.py) on a tiny generated Flowers tree on the CPU, held against the
JAX package's: the scale factor of a training run against JAX's
``compute_scale_by_std`` on the same weights and first batch, and the PNG
pairs of ``predict_diff.main`` against JAX's ``predict_diff.main`` on the
same weights and x_T; then the port's serving knobs and its refusals."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import _port_helpers  # noqa: F401  (caps torch threads)
from _flowers_helpers import (
    jax_train_loader,
    run_overrides,
    write_flowers_tree,
    write_preview_fixture,
)
from _port_helpers import check_grain_loader, jax_init, random_params

from stedm_tpu.config import compose as jcompose
from stedm_tpu.data.dm import DataModule as JDataModule
from stedm_tpu.models.stedm import build_stedm as jbuild_stedm
from stedm_tpu.train import checkpoints as jcheckpoints
from stedm_tpu.train.steps import compute_scale_by_std as jcompute_scale_by_std
from stedm_tpu_torch import predict_diff, train_diff
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.data.dm import DataModule
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.utils.weights import state_dict_from_jax

RUN = "diff_flowers_augmented_mean"
FP32 = ["diffusion.compute_dtype=float32"]
PREDICT = ["data.samples=1", "ddim_steps=4", "cfg_scale=1.5"]
SEED = 0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = write_flowers_tree(tmp_path_factory.mktemp("data"))
    write_preview_fixture(root)
    return root, tmp_path_factory.mktemp("results")


def _jax_params(cfg, seed: int):
    """Random JAX STEDM parameters for ``cfg`` (every layer non-zero)."""
    model = jbuild_stedm(cfg)
    p = cfg.data.patch_size
    return model, random_params(model, seed, jnp.zeros((1, p, p, 3)), jnp.zeros((1, p, p, 2)),
                                jnp.zeros((1, 1, p, p, 3)), jnp.zeros((1,), jnp.int32))


def test_train_entry_point_against_jax_scale_factor(tree, monkeypatch):
    """Two runs of train_diff.main (learn_logvar, scale_by_std, previews at
    style drop 0.25), the second resuming into epoch 2; the persisted scale
    factor equals JAX's for the same weights and first batch."""
    data, results = tree
    overrides = run_overrides(data, results / "train") + FP32 + [
        "accumulate_grad_batches=1", "+preview_ddim_steps=4",
        "+diffusion.learn_logvar=true", "+diffusion.scale_by_std=true"]
    jcfg = jcompose("config_diff", overrides)
    jcfg.data.batch_size = jcfg.data.batch_size or jcfg.data.batch_base
    jmodel, jparams = _jax_params(jcfg, 3)
    sd = state_dict_from_jax(jparams)
    build = train_diff.build_stedm

    def build_with_jax_weights(cfg, device=None, **kw):
        model = build(cfg, device, **kw)
        model.load_state_dict(sd, strict=True)
        return model

    monkeypatch.setattr(train_diff, "build_stedm", build_with_jax_weights)
    first = train_diff.main(overrides, device="cpu")
    run_dir = results / "train" / RUN
    assert first["step"] == 2 and [e["epoch"] for e in first["epochs"]] == [0]
    assert np.isfinite(first["epochs"][0]["loss"])
    previews = sorted(p.name for p in (run_dir / "previews").glob("*.png"))
    # two preview styles, and at style drop 0.25 the CFG variants at guidance
    # 3 and 5 on both (ldm_diffusion.py:195-221)
    assert len([p for p in previews if p.startswith("Sample_Images_0_")]) == 2
    assert len([p for p in previews if p.startswith("Sample_Images_CFG_0_")]) == 4

    jdm = JDataModule(jcfg)
    jdm.setup()
    img = np.asarray(next(iter(jax_train_loader(jdm, SEED)))[0])
    want = jcompute_scale_by_std(jmodel, jparams, jnp.asarray(img))
    got = json.loads((run_dir / "scale_factor.json").read_text())["scale_factor"]
    np.testing.assert_allclose(got, want, rtol=1e-5)

    saved = checkpoints.load(run_dir / "ckpt" / f"{RUN}_last")
    assert saved["step"] == 2 and saved["logvar"].shape == (1000,)
    resumed = train_diff.main(overrides + ["+resume=true", "num_epochs=2"], device="cpu")
    assert [e["epoch"] for e in resumed["epochs"]] == [1] and resumed["step"] == 4
    assert resumed["scale_factor"] == got
    events = [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in events if "Train Loss" in e] == [0, 1]
    assert checkpoints.load(run_dir / "ckpt" / f"{RUN}_last")["step"] == 4


@pytest.fixture(scope="module")
def weights(tree):
    """One random JAX parameter set written twice: as the orbax params
    checkpoint JAX's predict_diff reads, and through the weight bridge as the
    port's params-only checkpoint."""
    data, results = tree
    overrides = run_overrides(data, results) + FP32
    jcfg = jcompose("config_predict", overrides)
    _, params = _jax_params(jcfg, 5)
    jpath = results / "jax_ckpt"
    jcheckpoints.save(jpath, params, name="params")
    ppath = checkpoints.save(results / "port_ckpt", state_dict_from_jax(params), name="params")
    return overrides, str(jpath), ppath


def _pairs(folder):
    imgs, segs = sorted(folder.glob("img_*.png")), sorted(folder.glob("seg_*.png"))
    assert [p.name[4:] for p in imgs] == [p.name[4:] for p in segs]
    return ([np.array(Image.open(p)) for p in imgs], [np.array(Image.open(p)) for p in segs])


def test_predict_entry_point_matches_jax(tree, weights):
    """The same weights and x_T through both predict_diff.main: seg PNGs
    identical, img PNGs within 1 (rtol/atol 1e-3 of the sampled image before
    truncation, as test_torch_sample.py)."""
    import predict_diff as jpredict_diff

    data, _ = tree
    overrides, jpath, ppath = weights
    with jax_init("shapes"):   # every parameter is restored from jpath
        jpredict_diff.main(overrides + PREDICT + [f"+ckpt_path={jpath}", "+predict_name=jax"])

    def jax_x_T(batch_idx, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), batch_idx)
        return torch.from_numpy(np.asarray(jax.random.normal(key, shape, jnp.float32)))

    out = predict_diff.main(overrides + PREDICT + [f"+ckpt_path={ppath}", "+predict_name=port"],
                            device="cpu", x_T_fn=jax_x_T)
    assert out["pairs"] == 2
    want_img, want_seg = _pairs(data / "syn_data" / "jax")
    got_img, got_seg = _pairs(data / "syn_data" / "port")
    assert len(got_img) == len(want_img) == 2
    for g, w in zip(got_seg, want_seg):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_img, want_img):
        assert g.shape == (32, 32, 3) and g.dtype == np.uint8
        assert g.std() > 0, "a flat image would make the comparison empty"
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


@pytest.mark.parametrize("extra", [
    ["+cfg_interval=[0,0.6]"],
    ["+cache_schedule=auto:2"],
    ["+compact_transfer=true"],
    ["+cache_schedule=[0,2]", "+host_loop=true", "+block_carry=true", "+unroll=3"],
], ids=["cfg_interval", "cache_schedule_auto", "compact_transfer", "block_carry"])
def test_predict_serving_knobs(tree, weights, extra):
    data, _ = tree
    overrides, _, ppath = weights
    name = "knob_" + extra[0].split("=")[0].lstrip("+")
    out = predict_diff.main(overrides + PREDICT + extra + [f"+ckpt_path={ppath}",
                                                           f"+predict_name={name}"],
                            device="cpu")
    imgs, segs = _pairs(data / "syn_data" / name)
    assert out["pairs"] == len(imgs) == 2
    for img, seg in zip(imgs, segs):
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8
        assert seg.shape == (32, 32) and set(np.unique(seg)) <= {0, 1}


# the cases a slice of the port once refused and that now run (exc None):
# the pairs they write; canvas: four layouts mosaicked into one 64^2 canvas
_PREDICT_REFUSALS = {
    "canvas": (["+canvas_size=64", "data.samples=2", "data.batch_size=4"], None, (1, 64)),
    "plms": (["sampler=plms"], None, (2, 32)),
    "dpm": (["sampler=dpm"], None, (2, 32)),
    "mesh": (["location.mesh.data=2"], NotImplementedError, "torch.distributed"),
    "bare_cfg_interval": (["+cfg_interval=0.3"], SystemExit, "lo,hi"),
    "orbax_dir": (None, NotImplementedError, "reading a JAX orbax directory"),
    "ema_of_params": (["+use_ema=true"], ValueError, "full-state"),
    # JAX's predict reads no warm start: the run's checkpoint holds the codec
    "warm_start": (["diffusion.ckpt_path=x.ckpt",
                    "diffusion.first_stage_config.params.ckpt_path=vq.ckpt"], None, (2, 32)),
    "canvas_not_a_multiple": (["+canvas_size=48"], SystemExit, "multiple of the training"),
    "canvas_plms": (["+canvas_size=64", "data.samples=2", "data.batch_size=4",
                     "sampler=plms"], NotImplementedError, "DDIM only"),
}


@pytest.mark.parametrize("case", list(_PREDICT_REFUSALS))
def test_predict_refusals(tree, weights, case):
    data, _ = tree
    overrides, jpath, ppath = weights
    extra, exc, match = _PREDICT_REFUSALS[case]
    extra = extra or [f"+ckpt_path={jpath}"]
    args = overrides + PREDICT + [f"+ckpt_path={ppath}", f"+predict_name=case_{case}"] + extra
    if exc is not None:
        with pytest.raises(exc, match=match):
            predict_diff.main(args, device="cpu")
        return
    n, side = match
    out = predict_diff.main(args, device="cpu")
    imgs, segs = _pairs(data / "syn_data" / f"case_{case}")
    assert out["pairs"] == len(imgs) == n
    for img, seg in zip(imgs, segs):
        assert img.shape == (side, side, 3) and seg.shape == (side, side) and img.std() > 0


def test_predict_resolves_an_open_mesh_to_one_device(tree, weights):
    """location/tpu.yaml's ``data: -1`` resolves to the visible devices:
    one here, so it runs (more than one raises: the "mesh" refusal)."""
    data, results = tree
    overrides, _, ppath = weights
    out = predict_diff.main(overrides + PREDICT + [
        "location=tpu", f"location.data_dir={data}", f"location.result_dir={results}",
        f"+ckpt_path={ppath}", "+predict_name=tpu"], device="cpu")
    assert out["pairs"] == 2


def _write_compvis(path, groups):
    """A random-weight torch checkpoint in CompVis key names (the port's
    keys under each group's CompVis root) for a tiny model."""
    data = path.parent
    model = train_diff.build_stedm(compose("config_diff", run_overrides(data, data)),
                                   device="cpu", seed=4)
    sd = {root + k[len(g) + 1:]: v for g, root in groups.items()
          for k, v in model.state_dict().items() if k.startswith(g + ".")}
    torch.save({"state_dict": sd}, path)


# the cases a slice of the port once refused and that now run (match None)
@pytest.mark.parametrize("extra,match", [
    (["diffusion.ckpt_path=unet.ckpt"], None),
    (["diffusion.first_stage_config.params.ckpt_path=vq.ckpt"], None),
    (["+adamw_m_bf16=true"], None),
    (["location.mesh.data=4"], "torch.distributed"),
    (["location.loader=grain", "location.n_workers=2"], None),
    (["style_agg=svit"], None),
], ids=["unet_warm_start", "codec_warm_start", "adamw_m_bf16", "mesh", "grain", "svit"])
def test_train_refusals(tree, extra, match):
    data, results = tree
    # (the epoch-end previews at 4 DDIM steps, not 128: these runs check the
    # steps and the warm starts, not the previews)
    args = run_overrides(data, results / "refused") + ["+preview_ddim_steps=4"] + extra
    if "location.loader=grain" in extra:   # now the worker-process loader
        dm = DataModule(compose("config_diff", args))
        dm.prepare_data()
        dm.setup()
        check_grain_loader(dm)
        return
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            train_diff.main(args, device="cpu")
        return
    (results / "refused").mkdir(exist_ok=True)
    if "unet.ckpt" in extra[0]:
        _write_compvis(results / "refused" / "unet.ckpt", {"unet": "model.diffusion_model."})
    elif "vq.ckpt" in extra[0]:
        _write_compvis(results / "refused" / "vq.ckpt", {"first_stage": "first_stage_model."})
    out = train_diff.main(args, device="cpu")
    assert out["step"] == 2 and np.isfinite(out["epochs"][0]["loss"])
    if "ckpt" in extra[0]:
        (n_loaded, n_left), = out["warm_start"].values()
        assert n_loaded > 0

