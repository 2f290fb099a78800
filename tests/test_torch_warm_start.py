"""Warm starts and the codec hand-off, the port against the JAX package.

* ``flax_paths`` names every port parameter by its path in the JAX tree
  (tiny and at the shipped widths), the inverse of the weight bridge;
* one random-weight CompVis ``.ckpt`` handed to both ``train_diff.main``s as
  ``diffusion.ckpt_path``, with ``load_only_unet`` true and false and with
  ``ignore_keys``: the same tensors loaded, bit for bit, and the same
  printed ``merged N tensors (M left at init)``;
* the same for a first-stage ``.ckpt`` (``map_vq``, bare and under
  ``first_stage_model.``);
* the port's own hand-off: ``train_ae.main`` writes ``<run>_best.pt``,
  ``train_diff.main`` takes it as its first stage (loaded bit for bit, and
  frozen through the steps), ``predict_diff.main`` samples from that run;
* ROADMAP §3's question, settled: JAX's ``train_diff`` does not take a JAX
  ``train_ae`` output directory (its strict orbax restore refuses the AE
  state), and the port refuses any directory.

The runs are at ``num_epochs=0`` where only the loads are compared: neither
side compiles or runs a step."""

import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_helpers  # noqa: F401  (caps torch threads)
from _flowers_helpers import run_overrides, write_flowers_tree
from _port_helpers import init_shapes, jax_init, random_params

import stedm_tpu.utils.torch_import as jimport
from stedm_tpu.config import compose as jcompose
from stedm_tpu.models.stedm import build_stedm as jbuild_stedm
from stedm_tpu_torch import predict_diff, train_ae, train_diff
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.models.stedm import build_stedm
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.utils import weights
from stedm_tpu_torch.utils.weights import state_dict_from_jax

FP32 = ["diffusion.compute_dtype=float32", "num_epochs=0"]
_MERGED = re.compile(r"\[torch_import\] merged (\d+) tensors \((\d+) left at init\)")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_flowers_tree(tmp_path_factory.mktemp("data")), tmp_path_factory.mktemp("res")


def _jax_tree_paths(params) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.mark.parametrize("agg", ["mean", "linear", "svit"])
@pytest.mark.parametrize("width", ["tiny", "shipped"])
def test_flax_paths_name_the_jax_tree(tree, agg, width):
    """Every port parameter's flax path is a leaf of the JAX tree and back,
    with its shape; the bridge maps the paths onto the port's names."""
    data, results = tree
    overrides = (run_overrides(data, results) if width == "tiny" else
                 ["location=pc", "diffusion.compute_dtype=float32"]) + [f"style_agg={agg}"]
    jcfg = jcompose("config_diff", overrides)
    jm = jbuild_stedm(jcfg)
    p = jcfg.data.patch_size
    shapes = init_shapes(jm.init, jnp.zeros((1, p, p, 3)), jnp.zeros((1, p, p, 2)),
                         jnp.zeros((1, 1, p, p, 3)), jnp.zeros((1,), jnp.int32))["params"]
    leaves = _jax_tree_paths(shapes)
    model = build_stedm(compose("config_diff", overrides), device="meta")
    names = weights.flax_paths(model)
    assert sorted(names.values()) == sorted(leaves)
    prms = dict(model.named_parameters())
    skeleton = {}
    for key, path in names.items():
        node = skeleton
        for part in path.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[path.split("/")[-1]] = np.broadcast_to(np.float32(0), leaves[path].shape)
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # from_numpy of read-only views
        mp.setattr(weights.np, "ascontiguousarray", lambda a: a)
        bridged = {k: tuple(v.shape) for k, v in state_dict_from_jax(skeleton).items()}
    assert bridged == {k: tuple(v.shape) for k, v in prms.items()}


def _compvis_file(path, sd: dict, groups: dict, wrap: bool = True) -> None:
    """A torch checkpoint in CompVis key names: each port group under its
    CompVis root (the port's keys are the reference torch names)."""
    out = {}
    for group, root in groups.items():
        out.update({root + k[len(group) + 1:]: v.clone() for k, v in sd.items()
                    if k.startswith(group + ".")})
    torch.save({"state_dict": out} if wrap else out, path)
    return out


def _random_sd(cfg, seed):
    jm = jbuild_stedm(cfg)
    p = cfg.data.patch_size
    params = random_params(jm, seed, jnp.zeros((1, p, p, 3)), jnp.zeros((1, p, p, 2)),
                           jnp.zeros((1, 1, p, p, 3)), jnp.zeros((1,), jnp.int32))
    return state_dict_from_jax(params)


def _run_both(monkeypatch, capsys, overrides):
    """Both train_diff.main at zero epochs; returns each side's parameters
    after the loads (as port state_dicts) and printed merge counts."""
    import train_diff as jtrain_diff

    got = {}
    orig = jimport.load_into_params

    def spy(*args, **kw):
        got.setdefault("jax", []).append(orig(*args, **kw))
        return got["jax"][-1]

    monkeypatch.setattr(jimport, "load_into_params", spy)
    capsys.readouterr()
    with jax_init("shapes"):   # no check reads JAX's values left at init
        jtrain_diff.main(overrides)
    jcounts = _MERGED.findall(capsys.readouterr().out)
    build = train_diff.build_stedm

    def keep(cfg, device=None, **kw):
        got["port"] = build(cfg, device, **kw)
        return got["port"]

    monkeypatch.setattr(train_diff, "build_stedm", keep)
    out = train_diff.main(overrides, device="cpu")
    pcounts = _MERGED.findall(capsys.readouterr().out)
    jsd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, got["jax"][-1]))
    return jsd, jcounts, got["port"].state_dict(), pcounts, out


def _loaded(after: dict, file_sd: dict, roots: dict) -> set:
    """The port keys whose value equals the file's tensor bit for bit."""
    hit = set()
    for key, val in after.items():
        for group, root in roots.items():
            if key.startswith(group + "."):
                src = file_sd.get(root + key[len(group) + 1:])
                if src is not None and src.shape == val.shape and torch.equal(src, val):
                    hit.add(key)
    return hit


CKPT_CASES = {
    "load_only_unet": ["diffusion.load_only_unet=true"],
    "whole_model": ["diffusion.load_only_unet=false"],
    "ignore_keys": ["diffusion.load_only_unet=false",
                    "diffusion.ignore_keys=[input_blocks_1,first_stage/encoder/mid,quant_conv]"],
}
ROOTS = {"unet": "model.diffusion_model.", "first_stage": "first_stage_model.",
         "cond_stage": "cond_stage_model."}


@pytest.mark.parametrize("case", list(CKPT_CASES))
def test_diffusion_ckpt_path_loads_what_jax_loads(tree, monkeypatch, capsys, case):
    data, results = tree
    base = run_overrides(data, results / case) + FP32
    file_sd = _compvis_file(results / f"{case}.ckpt", _random_sd(jcompose("config_diff", base), 9),
                            ROOTS)
    overrides = base + [f"diffusion.ckpt_path=../{case}.ckpt"] + CKPT_CASES[case]
    jsd, jcounts, psd, pcounts, out = _run_both(monkeypatch, capsys, overrides)
    assert jcounts == pcounts and len(pcounts) == 1
    n_loaded, n_left = map(int, pcounts[0])
    assert out["warm_start"]["diffusion"] == (n_loaded, n_left)
    jhit, phit = _loaded(jsd, file_sd, ROOTS), _loaded(psd, file_sd, ROOTS)
    assert jhit == phit and len(phit) == n_loaded > 0
    for key in phit:
        assert torch.equal(psd[key], jsd[key])
    groups = {k.split(".")[0] for k in phit}
    if case == "load_only_unet":
        assert groups == {"unet"}
    else:
        assert groups == {"unet", "first_stage", "cond_stage"}
    if case == "ignore_keys":
        assert not any(k.startswith(("unet.input_blocks.1.", "first_stage.encoder.mid.",
                                     "first_stage.quant_conv.")) for k in phit)


@pytest.mark.parametrize("root", ["first_stage_model.", ""], ids=["ldm_rooted", "bare_vq"])
def test_first_stage_ckpt_path_loads_what_jax_loads(tree, monkeypatch, capsys, root):
    data, results = tree
    name = f"vq_{root or 'bare'}"
    base = run_overrides(data, results / name) + FP32
    file_sd = _compvis_file(results / f"{name}.ckpt",
                            _random_sd(jcompose("config_diff", base), 11),
                            {"first_stage": root}, wrap=bool(root))
    overrides = base + [f"diffusion.first_stage_config.params.ckpt_path=../{name}.ckpt"]
    jsd, jcounts, psd, pcounts, out = _run_both(monkeypatch, capsys, overrides)
    assert jcounts == pcounts and len(pcounts) == 1
    n_loaded, n_left = map(int, pcounts[0])
    assert n_left == 0 and out["warm_start"]["first_stage"] == (n_loaded, 0)
    roots = {"first_stage": root}
    jhit, phit = _loaded(jsd, file_sd, roots), _loaded(psd, file_sd, roots)
    assert jhit == phit == {k for k in psd if k.startswith("first_stage.")}
    assert len(phit) == n_loaded


def test_the_codec_hand_off(tree):
    """train_ae -> train_diff -> predict_diff on the port: the codec that
    train_ae keeps as its best is the one train_diff loads, bit for bit,
    and it stays frozen through the steps; predict samples from that run."""
    data, results = tree
    base = run_overrides(data, results / "handoff") + ["diffusion.compute_dtype=float32"]
    ae = train_ae.main(base + ["loss.disc_start=1", "loss.disc_ndf=8", "loss.disc_num_layers=1",
                               "lr=1e-3"], device="cpu")
    best = checkpoints.load(f"{ae['run_dir']}/ckpt/ae_flowers_best")
    assert best["format"] == "ae_state" and ae["step"] > 0
    fs = "diffusion.first_stage_config.params.ckpt_path=ae_flowers/ckpt/ae_flowers_best.pt"
    out = train_diff.main(base + [fs, "accumulate_grad_batches=1"], device="cpu")
    n = len(best["params"])
    assert out["warm_start"]["first_stage"] == (n, 0) and out["step"] > 0
    run = checkpoints.load(f"{out['run_dir']}/ckpt/{out['run_dir'].rsplit('/', 1)[1]}_last")
    for k, v in best["params"].items():
        assert torch.equal(run["params"][f"first_stage.{k}"], v), k
    pred = predict_diff.main(base + [fs, "data.samples=1", "ddim_steps=4",
                                     "+predict_name=handoff"], device="cpu")
    assert pred["pairs"] == 2


def test_jax_train_diff_does_not_take_a_jax_train_ae_directory(tree, monkeypatch):
    """JAX's train_ae saves its whole AE state (train_ae.py:221-227);
    JAX's train_diff restores a directory strictly into the STEDM tree
    (torch_import.py:716-719), and orbax refuses. The port raises on any
    directory, naming the reader that is still to come."""
    import train_diff as jtrain_diff

    from stedm_tpu.train import checkpoints as jcheckpoints
    from stedm_tpu.train.ae_steps import ae_optimizers, create_ae_state
    from stedm_tpu.train.vae_losses import VAELossConfig, build_discriminator
    from train_ae import build_codec as jbuild_codec

    data, results = tree
    base = run_overrides(data, results / "jax_ae") + FP32
    cfg = jcompose("config_ae", base)
    codec, _ = jbuild_codec(cfg, jnp.float32)
    p = cfg.data.patch_size
    gen = random_params(codec, 0, jnp.zeros((1, p, p, 3)))
    loss_cfg = VAELossConfig(**dict(cfg.loss))
    disc = build_discriminator(loss_cfg)
    disc_vars = init_shapes(disc.init, jnp.zeros((1, p, p, 3)))
    disc_vars = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), disc_vars)
    state = create_ae_state(gen, disc_vars, *ae_optimizers(1e-4))
    ckpt = results / "jax_ae" / "ae_flowers" / "ckpt"
    jcheckpoints.save(ckpt, state, name="ae_flowers_best")
    fs = "diffusion.first_stage_config.params.ckpt_path=ae_flowers/ckpt/ae_flowers_best"
    with pytest.raises(ValueError, match="tree structures do not match"), jax_init("shapes"):
        jtrain_diff.main(base + [fs])
    with pytest.raises(NotImplementedError, match="reading a JAX orbax directory"):
        train_diff.main(base + [fs], device="cpu")
