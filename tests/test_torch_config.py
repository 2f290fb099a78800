"""The port's config composition (a copy of stedm_tpu/config/compose.py) and
``build_stedm`` against the JAX package's: composed configs equal, the
model's state_dict names and shapes equal the weight bridge's conversion of
the JAX model's parameters (tiny, and the shipped widths by shape), and
every non-shipped U-Net or codec value raises."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_helpers  # noqa: F401  (caps torch threads)
from _flowers_helpers import CLASS_OVERRIDES, TINY_OVERRIDES
from _port_helpers import init_shapes, random_params

from stedm_tpu.config import compose as jcompose
from stedm_tpu.config import to_container as jto_container
from stedm_tpu.models.stedm import build_stedm as jbuild_stedm
from stedm_tpu_torch.config import compose, to_container
from stedm_tpu_torch.models.stedm import build_stedm
from stedm_tpu_torch.utils import weights

README_TRAIN = ["data=flowers", "style_sampling=augmented", "style_agg=mean",
                "location.data_dir=/data", "location.result_dir=/results"]
README_PREDICT = ["data=flowers", "data/dataset=[flowers_anno,flowers_unanno]",
                  "data.ratios=[1.0,1.0]", "cfg_scale=1.5", "location.data_dir=/data"]
README_SEG = ["data=her2", "data/dataset=[her2_anno,her2_syn]", "data.ratios=[0.2,0.8]",
              "location.data_dir=/data"]
README_AE = ["data=her2", "location.data_dir=/data",
             "+lpips_ckpt=/weights/vgg16.pth,/weights/vgg_lpips.pth"]

CASES = {
    "diff_default": ("config_diff", []),
    "predict_default": ("config_predict", []),
    "seg_default": ("config_seg", []),
    "ae_default": ("config_ae", []),
    "readme_train": ("config_diff", README_TRAIN),
    "readme_predict": ("config_predict", README_PREDICT),
    "readme_seg": ("config_seg", README_SEG),
    "readme_ae": ("config_ae", README_AE),
    "tiny_e2e": ("config_diff", TINY_OVERRIDES + CLASS_OVERRIDES),
    "group_and_plus": ("config_predict", [
        "diffusion/first_stage_config=kl-f4", "data/dataset=[flowers_syn]",
        "+cache_schedule=auto:5", "+cfg_interval=[0.35,0.65]", "+diffusion.learn_logvar=true",
        "location=cluster", "style_agg=svit"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compose_equals_jax(case):
    name, overrides = CASES[case]
    got = to_container(compose(name, overrides))
    assert got == jto_container(jcompose(name, overrides))
    assert type(compose(name, overrides)).__module__ == "stedm_tpu_torch.config.compose"


def _tiny_cfg():
    return compose("config_diff", TINY_OVERRIDES + CLASS_OVERRIDES +
                   ["diffusion.compute_dtype=float32"])


def _jax_init_args(p: int):
    return (jnp.zeros((1, p, p, 3)), jnp.zeros((1, p, p, 2)), jnp.zeros((1, 1, p, p, 3)),
            jnp.zeros((1,), jnp.int32))


def test_build_stedm_tiny_matches_the_bridge():
    """Every state_dict name and shape of the port's model is the bridge's
    conversion of JAX build_stedm's parameters, and loads strictly."""
    cfg = _tiny_cfg()
    jmodel = jbuild_stedm(jcompose("config_diff", TINY_OVERRIDES + CLASS_OVERRIDES +
                                   ["diffusion.compute_dtype=float32"]))
    sd = weights.state_dict_from_jax(random_params(jmodel, 0, *_jax_init_args(32)))
    model = build_stedm(cfg, device="cpu")
    assert model.dtype == torch.float32 and model.patch_size == 32
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)


def test_build_stedm_seeded():
    cfg = _tiny_cfg()
    a, b = (build_stedm(cfg, device="cpu", seed=s) for s in (1, 1))
    c = build_stedm(cfg, device="cpu", seed=2)
    wa, wb, wc = (m.unet.input_blocks[0][0].weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)


def test_build_stedm_shipped_widths_by_shape(monkeypatch):
    """The shipped config_diff (landscape U-Net, VQ-f4, Swin-V2-T at 512²):
    the JAX parameters by ``eval_shape`` (no memory) through the bridge
    against a port model on the meta device."""
    overrides = ["data=flowers", "style_sampling=augmented", "style_agg=mean"]
    jmodel = jbuild_stedm(jcompose("config_diff", overrides))
    shapes = init_shapes(jmodel.init, *_jax_init_args(512))
    # zero-stride stand-ins; the bridge's transposes keep them views
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                  shapes["params"])
    monkeypatch.setattr(weights.np, "ascontiguousarray", lambda a: a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # from_numpy of read-only views
        want = {k: tuple(v.shape) for k, v in weights.state_dict_from_jax(tree).items()}
    model = build_stedm(compose("config_diff", overrides), device="meta")
    assert model.dtype == torch.bfloat16
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert sum(int(np.prod(s)) for s in want.values()) == 317_934_225


def test_build_stedm_svit_shipped_widths_by_shape(monkeypatch):
    """``style_agg: svit`` at configs/style_agg/svit.yaml's widths (patch 8,
    dim 256, depth 6: 4098 position embeddings at 512²): the JAX parameters
    by ``eval_shape`` through the bridge against a meta port model."""
    overrides = ["data=flowers", "style_sampling=augmented", "style_agg=svit"]
    jmodel = jbuild_stedm(jcompose("config_diff", overrides))
    shapes = init_shapes(jmodel.init, *_jax_init_args(512))
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                  shapes["params"])
    monkeypatch.setattr(weights.np, "ascontiguousarray", lambda a: a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # from_numpy of read-only views
        want = {k: tuple(v.shape) for k, v in weights.state_dict_from_jax(tree).items()}
    model = build_stedm(compose("config_diff", overrides), device="meta")
    assert type(model.agg).__name__ == "SViT" and want["agg.pos_embedding"] == (1, 4098, 256)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


UNET = "diffusion.unet_config.params."
VQ = "diffusion.first_stage_config.params."
NON_SHIPPED = {
    "attn_impl": (UNET + "attn_impl=fast", ValueError),
    "unknown_unet_key": ("+" + UNET + "legacy=false", TypeError),
    "double_z": (VQ + "ddconfig.double_z=true", ValueError),
    # once refused, now built: build_stedm drops the first stage's ckpt_path
    # as JAX's does (train_diff loads it), and builds the set-ViT and every
    # option of the U-Net and the codec (tests/test_torch_model_options.py
    # holds each against JAX)
    "vq_ckpt_path": (VQ + "ckpt_path=vq-f4.ckpt", None),
    "svit": ("style_agg=svit", None),
    "unet_dropout": (UNET + "dropout=0.1", None),
    "use_scale_shift_norm": (UNET + "use_scale_shift_norm=true", None),
    "resblock_updown": (UNET + "resblock_updown=true", None),
    "use_spatial_transformer": (UNET + "use_spatial_transformer=true", None),
    "transformer_depth": (UNET + "transformer_depth=2", None),
    "num_head_channels": ("+" + UNET + "num_head_channels=32", None),
    "num_classes": ("+" + UNET + "num_classes=10", None),
    "vq_dropout": (VQ + "ddconfig.dropout=0.1", None),
}


@pytest.mark.parametrize("case", list(NON_SHIPPED))
def test_non_shipped_values_raise(case):
    override, exc = NON_SHIPPED[case]
    cfg = compose("config_diff", TINY_OVERRIDES + CLASS_OVERRIDES + [override])
    if exc is None:
        model = build_stedm(cfg, device="meta")
        assert type(model.agg).__name__ == ("SViT" if case == "svit" else "AggMean")
        return
    with pytest.raises(exc):
        build_stedm(cfg, device="meta")


@pytest.mark.parametrize("override", [
    UNET + "image_size=64", VQ + "monitor=val/rec_loss", UNET + "attn_impl=flash"])
def test_ignored_or_equivalent_values_build(override):
    cfg = compose("config_diff", TINY_OVERRIDES + CLASS_OVERRIDES + [override])
    assert build_stedm(cfg, device="meta").unet is not None
