"""Train the downstream segmentation net on real + synthetic pairs on one
card (the counterpart of train_seg.py:87-240).

* the MiT-B2 U-Net (models/segformer.py) at ``compute_dtype`` (bf16 unless
  set), loss = ce_ratio * CE + dice_ratio * Dice on border-cropped logits;
* lr = base_lr * batch_base * batch_mul * n_devices unless ``lr`` is set,
  AdamW (optax's weight decay 1e-4) with ``accumulate_grad_batches``;
* the run name defaults to ``seg_<first *_syn dataset>`` (reference
  train_seg.py:41-45);
* per epoch: train, then val, saving ``<run>_last`` and, on a new lowest
  Val Loss, ``<run>_best`` (``<result_dir>/<run>/ckpt/``); after the last
  epoch, test on the last weights and on the best (reference
  train_seg.py:74-93);
* tumor IoU, subtype variance, patient IoU mean and variance per epoch
  from the confusion matrices, and the normalised matrix as a PNG drawn
  with PIL (the JAX entry point draws it with matplotlib, which the H100
  machine lacks; reference segmentation.py:135-334);
* ``+encoder_ckpt=<file>`` loads a published MiT-B2 state_dict into the
  encoder (utils/weights.py:load_seg_encoder).

Usage, from the repository root, on a machine with one CUDA card
(README's mix)::

    python -m stedm_tpu_torch.train_seg data/dataset=[flowers_anno,flowers_syn] \\
        data.ratios=[0.2,0.8] location.data_dir=/data location.result_dir=/results

``main(argv, device=None)`` runs on ``cuda``; tests pass ``device="cpu"``.
Not ported, and refused: a mesh of more than one device, the HER2 and
CATCH data and the grain loader (ROADMAP item 12).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from stedm_tpu_torch._device import resolve_device
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.data.dm import DataModule
from stedm_tpu_torch.data.prefetch import prefetch_to_device
from stedm_tpu_torch.models.segformer import SegUNet
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.train.optim import scaled_lr
from stedm_tpu_torch.train.seg_steps import (
    create_seg_state,
    make_seg_eval_step,
    make_seg_optimizer,
    make_seg_train_step,
)
from stedm_tpu_torch.train_diff import single_device
from stedm_tpu_torch.utils import metrics as M
from stedm_tpu_torch.utils.logging import EventLogger
from stedm_tpu_torch.utils.weights import load_seg_encoder


def build_seg_model(cfg, device=None, seed: int = 0) -> SegUNet:
    """``SegUNet(classes=2)`` at ``compute_dtype``, initialised from ``seed``."""
    dtype = torch.bfloat16 if cfg.get("compute_dtype", "bfloat16") == "bfloat16" \
        else torch.float32
    dev = resolve_device(device)
    cuda_devs = [dev.index or 0] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda_devs), torch.device(dev):
        torch.manual_seed(seed)
        return SegUNet(classes=2, dtype=dtype)


def _epoch_metrics(prefix: str, cm: np.ndarray, inst_cms: np.ndarray | None,
                   logger: EventLogger, step: int, *, subtype_names=None,
                   image_list=None, name_idx: int = 0, class_names=None) -> dict:
    """(train_seg.py:48-84)"""
    out = {f"{prefix} IoU Score": M.tumor_iou(cm),
           f"{prefix} Subtype Var": M.subtype_variance(cm)}
    if class_names is not None and cm.sum() > 0:
        # BG-vs-tumor prediction columns against the full label rows
        # (reference segmentation.py:159-160)
        norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1e-10)
        M.confusion_matrix_png(norm[:, :2], ["BG", "Tumor"], class_names,
                               logger.run_dir / f"{prefix.lower().replace(' ', '_')}_cm_{step}.png",
                               title=f"{prefix} Conf Matrix")
    if inst_cms is not None:
        patient_ious = [M.tumor_iou(c) for c in inst_cms if c.sum() > 0]
        if patient_ious:
            out[f"{prefix} Patient IoU Score"] = float(np.mean(patient_ious))
            out[f"{prefix} Patient IoU Var"] = float(np.var(patient_ious))
        # subtype IoU: patient CMs grouped by subtype substring in the image
        # list (reference segmentation.py:292-334)
        if subtype_names and image_list is not None:
            subtype_iou = []
            for subtype in subtype_names[1:]:
                cms = [inst_cms[i] for i, tup in enumerate(image_list)
                       if subtype in str(tup[name_idx])]
                if cms:
                    subtype_iou.append(M.tumor_iou(np.sum(cms, axis=0)))
            if subtype_iou:
                out[f"{prefix} Subtype IoU Score"] = float(np.mean(subtype_iou))
                out[f"{prefix} Subtype IoU Var"] = float(np.var(subtype_iou))
    logger.log(out, step=step)
    return out


def _train_batch(np_batch: tuple) -> dict:
    return {"img": np_batch[0], "seg": np_batch[2]}


def _eval_batch(np_batch: tuple) -> dict:
    img, _one_hot, seg, cuts, wsi_nr = np_batch[:5]
    return {"img": img, "seg": seg, "cut_y": np.asarray(cuts[0]),
            "cut_x": np.asarray(cuts[1]), "wsi_nr": np.asarray(wsi_nr)}


def main(argv: list[str], device=None) -> dict:
    """Train, validate and test as configured; returns the run's numbers:
    per epoch the train loss, seconds, micro-steps and samples, the val
    loss; the test metrics by tag; the step training ended at and the run
    directory."""
    cfg = compose("config_seg", argv)
    dev = resolve_device(device)

    if cfg.data.batch_size is None:
        cfg.data.batch_size = cfg.data.batch_base * cfg.location.batch_mul
    n_devices = single_device(cfg, dev)
    lr = scaled_lr(cfg.base_lr, cfg.data.batch_base, cfg.location.batch_mul,
                   n_devices, cfg.lr)
    global_batch = cfg.data.batch_size * n_devices
    seed = cfg.get("seed", 0)

    run_name = cfg.get("run_name") or None
    if run_name is None:
        syn = [n for n in cfg.data.dataset if n.endswith("_syn")]
        run_name = f"seg_{syn[0] if syn else cfg.data.name}"
    # first, so that the data modules still to port (HER2, CATCH) and the
    # grain loader refuse before anything is written (ROADMAP item 12)
    dm = DataModule(cfg)
    result_dir = f"{cfg.location.result_dir}/{run_name}"
    logger = EventLogger(result_dir, run_name, use_wandb=cfg.location.get("wandb", False),
                         config=dict(cfg))
    print(f"devices={n_devices} global_batch={global_batch} lr={lr:.3e}")
    dm.prepare_data()
    dm.setup()

    num_classes = cfg.data.num_classes
    model = build_seg_model(cfg, dev, seed=seed)
    # pretrained MiT-B2 encoder (reference modules/segmentation.py:41
    # ``encoder_weights="imagenet"``): ``+encoder_ckpt=<path>`` names a staged
    # NVlabs mit_b2 / smp / Lightning torch checkpoint
    if cfg.get("encoder_ckpt"):
        load_seg_encoder(model, cfg.encoder_ckpt)
    tx = make_seg_optimizer(lr, cfg.get("accumulate_grad_batches", 4))
    state = create_seg_state(model, tx)
    losses_kw = dict(ce_ratio=cfg.ce_ratio, dice_ratio=cfg.dice_ratio)
    train_step = make_seg_train_step(model, num_classes=num_classes,
                                     overlap=cfg.data.overlap_train, device=dev, **losses_kw)
    eval_steps = {split: make_seg_eval_step(model, num_classes=num_classes,
                                            num_inst=cfg.data[f"num_{split}_inst"],
                                            overlap=cfg.data.overlap_val, device=dev,
                                            **losses_kw)
                  for split in ("val", "test")}
    prefetch = cfg.location.get("prefetch", 2)

    def run_eval(loader, split: str):
        num_inst = cfg.data[f"num_{split}_inst"]
        cm = torch.zeros((num_classes, num_classes), dtype=torch.float64, device=dev)
        inst = torch.zeros((num_inst, num_classes, num_classes), dtype=torch.float64,
                           device=dev)
        losses = []
        for batch in prefetch_to_device(loader, size=prefetch, transform=_eval_batch,
                                        device=dev):
            out = eval_steps[split](batch["img"], batch["seg"], batch["cut_y"],
                                    batch["cut_x"], batch["wsi_nr"])
            losses.append(out["loss"])
            cm += out["cm"]
            inst += out["inst_cm"]
        loss = float(torch.stack(losses).double().mean()) if losses else float("nan")
        return loss, cm.cpu().numpy(), inst.cpu().numpy()

    loader = dm.train_loader(seed=seed)
    loader.batch_size = global_batch
    val_loader = dm.val_loader()
    val_loader.batch_size = global_batch
    ckpt_dir = result_dir + "/ckpt"

    best_val, epochs = float("inf"), []
    for epoch in range(cfg.num_epochs):
        t0 = time.time()
        losses = []
        cm_train = torch.zeros((num_classes, num_classes), dtype=torch.float64, device=dev)
        for batch in prefetch_to_device(loader, size=prefetch, transform=_train_batch,
                                        device=dev):
            state, metrics_out = train_step(state, batch["img"], batch["seg"])
            losses.append(metrics_out["loss"])
            cm_train += metrics_out["cm"]
        train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
        seconds = time.time() - t0
        logger.log({"Train Loss": train_loss, "epoch": epoch, "epoch_time_s": seconds},
                   step=state.step)
        _epoch_metrics("Train", cm_train.cpu().numpy(), None, logger, state.step,
                       class_names=list(cfg.data.classes))
        record = {"epoch": epoch, "loss": train_loss, "seconds": seconds,
                  "micro_steps": len(losses), "samples": len(losses) * global_batch}

        if len(val_loader) > 0:
            val_loss, cm_val, inst_val = run_eval(val_loader, "val")
            logger.log({"Val Loss": val_loss}, step=state.step)
            record["val"] = {"loss": val_loss, **_epoch_metrics(
                "Val", cm_val, inst_val, logger, state.step,
                class_names=list(cfg.data.classes))}
            checkpoints.save(ckpt_dir, state, name=f"{run_name}_last")
            if val_loss < best_val:
                best_val = val_loss
                checkpoints.save(ckpt_dir, state, name=f"{run_name}_best")
        epochs.append(record)

    final_step = state.step
    # test twice: last weights, then best (reference train_seg.py:90-93);
    # without a val split no checkpoint was written and there is no test
    test_loader = dm.test_loader()
    test_loader.batch_size = global_batch
    tests = {}
    if len(test_loader) > 0:
        for tag in ("last", "best"):
            name = f"{run_name}_{tag}"
            if not checkpoints.checkpoint_file(ckpt_dir, name).is_file():
                continue
            state = checkpoints.restore(ckpt_dir, state, name=name)
            _loss, cm_test, inst_test = run_eval(test_loader, "test")
            tests[tag] = _epoch_metrics(f"Test ({tag})", cm_test, inst_test, logger,
                                        state.step)

    logger.close()
    return {"epochs": epochs, "tests": tests, "step": final_step, "run_dir": result_dir,
            "lr": lr}


if __name__ == "__main__":
    main(sys.argv[1:])
