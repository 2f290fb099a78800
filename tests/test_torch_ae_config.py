"""The port's codec fine-tuning entry: its Python copies of the yaml
configs, the codec it builds from a first-stage config, the lr rule and
``fit`` on a tiny codec (CPU)."""

from pathlib import Path

import pytest
import torch
import yaml

from stedm_tpu_torch import train_ae
from stedm_tpu_torch.models.autoencoder_kl import AutoencoderKL
from stedm_tpu_torch.models.vq import VQModelInterface
from stedm_tpu_torch.train.ae_steps import (ae_optimizers, create_ae_state, make_ae_eval_step,
                                            make_ae_train_step)
from stedm_tpu_torch.train.vae_losses import VAELossConfig, build_discriminator

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
    with pytest.raises(NotImplementedError, match="ckpt_path"):
        train_ae.build_codec({**train_ae.VQ_F4, "params": {**train_ae.VQ_F4["params"],
                                                            "ckpt_path": "x.ckpt"}})


def test_lr_rule_is_train_ae_py_s():
    # train_ae.py:112: base_lr * accumulate * global batch, unless lr is set
    assert train_ae.scaled_lr(4.5e-6, 1, 2) == 4.5e-6 * 2
    assert train_ae.scaled_lr(4.5e-6, 3, 8) == 4.5e-6 * 3 * 8
    assert train_ae.scaled_lr(4.5e-6, 1, 2, lr=1e-4) == 1e-4


def test_fit_runs_epochs_and_keeps_the_best_on_val():
    torch.manual_seed(0)
    fs = {"target": "VQModelInterface", "params": dict(
        embed_dim=3, n_embed=32, ddconfig=dict(double_z=False, z_channels=3, resolution=16,
                                               ch=32, ch_mult=[1, 2], num_res_blocks=1,
                                               attn_resolutions=[], dropout=0.0))}
    model, variant = train_ae.build_codec(fs)
    cfg = VAELossConfig(disc_start=1, perceptual_weight=0.0, disc_ndf=8, disc_num_layers=1)
    state = create_ae_state(model, build_discriminator(cfg), *ae_optimizers(1e-3))
    step = make_ae_train_step(model, cfg, variant=variant, device="cpu")
    evals = make_ae_eval_step(model, cfg, variant=variant, device="cpu")
    gen = torch.Generator().manual_seed(1)
    train = [torch.rand(2, 16, 16, 3, generator=gen) * 2 - 1 for _ in range(3)]
    val = [torch.rand(2, 16, 16, 3, generator=gen) * 2 - 1]
    state, hist = train_ae.fit(state, step, evals, train, val, num_epochs=2)
    assert state.step == 6 and len(hist["epochs"]) == 2
    for epoch in hist["epochs"]:
        assert {"train/total_loss", "train/disc_loss", "train/perplexity"} <= set(epoch["train"])
        assert set(epoch["val"]) == {"val/rec_loss", "val/quant_loss", "val/p_loss",
                                     "val/perplexity", "val/cluster_usage"}
    best = hist["best"]
    assert best["val/rec_loss"] == min(e["val"]["val/rec_loss"] for e in hist["epochs"])
    assert set(best["state_dict"]) == set(model.state_dict())
