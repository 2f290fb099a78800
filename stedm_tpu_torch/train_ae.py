"""Codec fine-tuning (the counterpart of train_ae.py): the codec named by a
``first_stage_config``, the loss settings of ``configs/config_ae.yaml``, the
lr rule, and ``fit``, which runs the combined generator + discriminator step
(``train/ae_steps.py``) over any iterable of NHWC image batches in [-1, 1],
with the eval step and the best validation reconstruction kept in memory.

The repository's configs are yaml; this package keeps Python copies of the
pieces it needs (``AE_LOSS``: config_ae.yaml's ``loss`` block and its
``base_lr``; ``VQ_F4`` and ``KL_F4``: the first-stage configs), which a test
holds equal to the files. Left for the entry points still to be ported: the
data module, config composition, the device mesh, checkpoints, logging and a
warm start from a checkpoint.

Typical use, on the card::

    model, variant = build_codec(VQ_F4, dtype=torch.bfloat16)
    cfg = VAELossConfig(**AE_LOSS)
    disc = build_discriminator(cfg).cuda()
    gen_tx, disc_tx = ae_optimizers(scaled_lr(BASE_LR, 1, batch))
    state = create_ae_state(model.cuda(), disc, gen_tx, disc_tx)
    step = make_ae_train_step(model, cfg, lpips=None, variant=variant)
    state, history = fit(state, step, make_ae_eval_step(model, cfg, variant=variant),
                         train_batches, val_batches, num_epochs=1)
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Iterable

import torch

from stedm_tpu_torch.models.autoencoder_kl import AutoencoderKL
from stedm_tpu_torch.models.vq import VQModelInterface

# configs/config_ae.yaml
BASE_LR = 4.5e-6
AE_LOSS = dict(disc_start=1000, codebook_weight=1.0, pixelloss_weight=1.0, disc_num_layers=3,
               disc_in_channels=3, disc_factor=1.0, disc_weight=0.75, perceptual_weight=1.0,
               use_actnorm=False, disc_ndf=64, disc_loss="hinge", pixel_loss="l1",
               kl_weight=1.0e-6, logvar_init=0.0)

_DDCONFIG = dict(z_channels=3, resolution=512, in_channels=3, out_ch=3, ch=128,
                 ch_mult=[1, 2, 4], num_res_blocks=2, attn_resolutions=[], dropout=0.0)
# configs/diffusion/first_stage_config/vq-f4.yaml and kl-f4.yaml
VQ_F4 = dict(target="stedm_tpu.models.vq.VQModelInterface",
             params=dict(embed_dim=3, n_embed=8192, ckpt_path=None,
                         ddconfig=dict(double_z=False, **_DDCONFIG)))
KL_F4 = dict(target="stedm_tpu.models.autoencoder_kl.AutoencoderKL",
             params=dict(embed_dim=3, ckpt_path=None, ddconfig=dict(double_z=True, **_DDCONFIG)))


def scaled_lr(base_lr: float, accumulate: int, global_batch: int,
              lr: float | None = None) -> float:
    """The taming lr rule of train_ae.py: ``base_lr * accumulate * global
    batch``, unless ``lr`` is set."""
    return float(lr) if lr else float(base_lr) * accumulate * global_batch


def build_codec(first_stage_config: dict, dtype: torch.dtype = torch.float32):
    """``(model, variant)`` for a first-stage config (``target`` and
    ``params``): ``AutoencoderKL`` -> ``"kl"``, anything else the VQ codec ->
    ``"vq"``. A ``ckpt_path`` is refused: loading it is not ported."""
    params = dict(first_stage_config["params"])
    if params.pop("ckpt_path", None):
        raise NotImplementedError("a codec checkpoint (ckpt_path) cannot be loaded yet")
    params.pop("monitor", None)
    params.pop("lossconfig", None)
    params["ddconfig"] = dict(params["ddconfig"])
    if str(first_stage_config["target"]).rsplit(".", 1)[-1] == "AutoencoderKL":
        params.pop("n_embed", None)
        return AutoencoderKL(dtype=dtype, **params), "kl"
    return VQModelInterface(dtype=dtype, **params), "vq"


def _mean(logs: list[dict]) -> dict[str, float]:
    return {k: float(torch.stack([torch.as_tensor(log[k]).float().cpu() for log in logs]).mean())
            for k in logs[0]}


def fit(state, train_step: Callable, eval_step: Callable | None,
        train_batches: Iterable, val_batches: Iterable = (), num_epochs: int = 1):
    """Run ``num_epochs`` passes of ``train_step`` over ``train_batches`` (NHWC
    image tensors), then ``eval_step`` over ``val_batches``; returns the state
    and a history: per epoch the mean train log, the mean validation metrics
    and the epoch's seconds, and ``best`` (the codec's state_dict, on the
    CPU, at the lowest ``val/rec_loss``, and that loss)."""
    history = {"epochs": [], "best": None}
    best = float("inf")
    for epoch in range(num_epochs):
        t0 = time.time()
        logs = [train_step(state, img)[1] for img in train_batches]
        entry = {"epoch": epoch, "step": state.step,
                 "train": _mean(logs) if logs else {}}
        vals = [eval_step(img)[0] for img in val_batches] if eval_step else []
        entry["val"] = _mean(vals) if vals else {}
        entry["seconds"] = time.time() - t0
        history["epochs"].append(entry)
        if vals and entry["val"]["val/rec_loss"] < best:
            best = entry["val"]["val/rec_loss"]
            history["best"] = {"val/rec_loss": best, "epoch": epoch,
                               "state_dict": copy.deepcopy({k: v.detach().cpu() for k, v in
                                                            state.model.state_dict().items()})}
    return state, history
