"""The port's codec fine-tuning entry: its Python copies of the yaml
configs, the codec it builds from a first-stage config, the lr rule and
the epochs of ``main`` on a tiny codec (CPU)."""

import tempfile
from pathlib import Path

import pytest
import torch
import yaml

from stedm_tpu_torch import train_ae
from stedm_tpu_torch.models.autoencoder_kl import AutoencoderKL
from stedm_tpu_torch.models.vq import VQModelInterface
from stedm_tpu_torch.train.vae_losses import VAELossConfig

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _yaml(*parts):
    return yaml.safe_load((CONFIGS.joinpath(*parts)).read_text())


def test_loss_block_and_base_lr_equal_config_ae_yaml():
    cfg = _yaml("config_ae.yaml")
    assert train_ae.AE_LOSS == cfg["loss"]
    assert train_ae.BASE_LR == cfg["base_lr"]
    VAELossConfig(**train_ae.AE_LOSS)             # every key is a loss setting


@pytest.mark.parametrize("name", ["vq-f4", "kl-f4"])
def test_first_stage_copies_equal_the_yaml(name):
    copy = {"vq-f4": train_ae.VQ_F4, "kl-f4": train_ae.KL_F4}[name]
    assert copy == _yaml("diffusion", "first_stage_config", f"{name}.yaml")


def test_build_codec_from_the_shipped_configs():
    vq, variant = train_ae.build_codec(train_ae.VQ_F4)
    assert variant == "vq" and isinstance(vq, VQModelInterface)
    assert sum(p.numel() for p in vq.parameters()) == 55_322_782
    kl, variant = train_ae.build_codec(train_ae.KL_F4, dtype=torch.bfloat16)
    assert variant == "kl" and isinstance(kl, AutoencoderKL) and kl.dtype == torch.bfloat16
    # a ckpt_path is loaded into the codec (once refused): a torch state
    # dict in vq-f4.ckpt's bare key names, through map_vq
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/vq-f4.ckpt"
        torch.save({"state_dict": {k: torch.full_like(v, 0.5) for k, v in vq.state_dict().items()}},
                   path)
        loaded, _ = train_ae.build_codec({**train_ae.VQ_F4, "params": {
            **train_ae.VQ_F4["params"], "ckpt_path": path}})
    assert all(bool((p == 0.5).all()) for p in loaded.parameters())


def test_lr_rule_is_train_ae_py_s():
    # train_ae.py:112: base_lr * accumulate * global batch, unless lr is set
    assert train_ae.scaled_lr(4.5e-6, 1, 2) == 4.5e-6 * 2
    assert train_ae.scaled_lr(4.5e-6, 3, 8) == 4.5e-6 * 3 * 8
    assert train_ae.scaled_lr(4.5e-6, 1, 2, lr=1e-4) == 1e-4


def test_fit_runs_epochs_and_keeps_the_best_on_val(tmp_path):
    """``train_ae.main``, which took over ``fit``'s loop: two epochs of train
    steps and validation on a tiny codec and HER2 tree, each epoch's mean
    logs, ``_last`` after the last epoch and ``_best`` at the lowest
    ``val/rec_loss``."""
    from _her2_helpers import HER2_OVERRIDES, write_her2_tree

    from stedm_tpu_torch.train import checkpoints

    tree = write_her2_tree(tmp_path / "data")
    out = train_ae.main(HER2_OVERRIDES + [
        f"location.data_dir={tree}", f"location.result_dir={tmp_path / 'results'}",
        "data.samples=4", "num_epochs=2", "lr=1e-3", "diffusion.compute_dtype=float32",
        "diffusion.first_stage_config.params.ddconfig.ch=32",
        "diffusion.first_stage_config.params.ddconfig.ch_mult=[1,2]",
        "diffusion.first_stage_config.params.ddconfig.num_res_blocks=1",
        "diffusion.first_stage_config.params.n_embed=32", "loss.disc_start=1",
        "loss.disc_ndf=8", "loss.disc_num_layers=1"], device="cpu")
    assert out["step"] == 4 and [e["steps"] for e in out["epochs"]] == [2, 2]
    for epoch in out["epochs"]:
        assert {"train/total_loss", "train/disc_loss", "train/perplexity"} <= set(epoch["train"])
        assert set(epoch["val"]) == {"val/rec_loss", "val/quant_loss", "val/p_loss",
                                     "val/perplexity", "val/cluster_usage"}
    losses = [e["val"]["val/rec_loss"] for e in out["epochs"]]
    ckpt = tmp_path / "results" / "ae_her2" / "ckpt"
    assert checkpoints.load(ckpt / "ae_her2_last")["step"] == 4
    assert checkpoints.load(ckpt / "ae_her2_best")["step"] == 2 * (1 + losses.index(min(losses)))


def test_lpips_ckpt_loads_the_files_jax_loads(tmp_path):
    """``lpips_ckpt`` naming two torch files, taming's ``vgg.pth`` heads and a
    torchvision VGG16, through ``train_ae.maybe_load_lpips`` and the JAX
    entry point's: the same weights (exactly); without it, no LPIPS."""
    import jax
    import numpy as np
    import train_ae as jtrain_ae

    from stedm_tpu.config import compose as jcompose
    from stedm_tpu_torch.config import compose
    from stedm_tpu_torch.utils.weights import lpips_state_dict

    gen = torch.Generator().manual_seed(0)
    vgg, cin = {"classifier.0.weight": torch.zeros(4, 4)}, 3    # the classifier is ignored
    for i, cout in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
                       (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)):
        vgg[f"features.{i}.weight"] = torch.randn(cout, cin, 3, 3, generator=gen) * 0.1
        vgg[f"features.{i}.bias"] = torch.randn(cout, generator=gen) * 0.1
        cin = cout
    heads = {f"lin{k}.model.1.weight": torch.rand(1, c, 1, 1, generator=gen)
             for k, c in enumerate((64, 128, 256, 512, 512))}
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save({"state_dict": heads}, tmp_path / "vgg.pth")
    args = [f"lpips_ckpt={tmp_path / 'vgg.pth'},{tmp_path / 'vgg16.pth'}"]
    got = train_ae.maybe_load_lpips(compose("config_ae", args), "cpu").state_dict()
    _, params = jtrain_ae.maybe_load_lpips(jcompose("config_ae", args))
    want = lpips_state_dict(jax.tree_util.tree_map(np.asarray, params))
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert train_ae.maybe_load_lpips(compose("config_ae", []), "cpu") is None
