"""Train and eval steps of the downstream segmentation net
(stedm_tpu/train/seg_steps.py).

CE + Dice on border-cropped logits, confusion matrices on the cropped
argmax in training and under each sample's border mask in evaluation, the
per-instance matrices scatter-added by ``wsi_nr`` into ``[num_inst, C, C]``
(reference modules/segmentation.py:77-132). The parameters and the
BatchNorm running statistics live in the model and the state is updated in
place; the steps return what the JAX steps return.

The optimizer is the JAX entry point's ``optax.MultiSteps(optax.adamw(lr),
every_k)`` (train_seg.py:135-136): ``make_seg_optimizer`` gives the port's
``Optimizer`` with optax's default weight decay, 1e-4, on every parameter,
norms and biases included. The running statistics move on every
micro-step, the parameters on every k-th; ``step`` counts micro-steps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from stedm_tpu_torch._device import resolve_device
from stedm_tpu_torch.train.optim import Optimizer, OptState, make_optimizer
from stedm_tpu_torch.utils.metrics import border_mask, confusion_matrix, seg_loss

OPTAX_WEIGHT_DECAY = 1e-4


@dataclasses.dataclass
class SegTrainState:
    """The JAX ``SegTrainState``: the parameters and the BatchNorm running
    statistics live in ``model``, the optimizer's state in ``opt_state``."""

    model: torch.nn.Module
    tx: Optimizer
    opt_state: OptState
    step: int = 0


def make_seg_optimizer(lr: float, accumulate_grad_batches: int = 1) -> Optimizer:
    """``optax.MultiSteps(optax.adamw(lr), every_k_schedule=k)``."""
    return make_optimizer(lr, accumulate_grad_batches=accumulate_grad_batches,
                          weight_decay=OPTAX_WEIGHT_DECAY)


def create_seg_state(model: torch.nn.Module, tx: Optimizer) -> SegTrainState:
    return SegTrainState(model=model, tx=tx,
                         opt_state=tx.init({"seg": list(model.parameters())}))


def _binary_one_hot(seg: torch.Tensor) -> torch.Tensor:
    """Foreground against background, ``[..., 2]`` fp32."""
    fg = (seg > 0).float()
    return torch.stack([1.0 - fg, fg], dim=-1)


def _check_device(model: torch.nn.Module, dev: torch.device) -> None:
    param_dev = next(model.parameters()).device
    if param_dev.type != dev.type:
        raise ValueError(f"model lives on {param_dev}, the step on {dev}")


def make_seg_train_step(model: torch.nn.Module, *, num_classes: int, overlap: int,
                        ce_ratio: float = 0.1, dice_ratio: float = 0.9,
                        device=None) -> Callable:
    """``train_step(state, img [B,P,P,3], seg [B,P,P] int) -> (state,
    {"loss", "cm"})``; it runs on ``cuda`` unless ``device`` says
    otherwise, and the model must already live there."""
    dev = resolve_device(device)
    o = overlap
    crop = (slice(None), slice(o, -o), slice(o, -o))

    def train_step(state: SegTrainState, img, seg):
        _check_device(model, dev)
        img = torch.as_tensor(img, dtype=torch.float32, device=dev)
        seg = torch.as_tensor(seg, device=dev)
        logits = model(img, train=True)
        loss = seg_loss(logits[crop], _binary_one_hot(seg)[crop],
                        ce_ratio=ce_ratio, dice_ratio=dice_ratio)
        loss.backward()
        state.tx.update(state.opt_state)
        state.step += 1
        pred = logits.detach().argmax(-1)
        cm = confusion_matrix(pred[crop], seg[crop], num_classes)
        return state, {"loss": loss.detach(), "cm": cm}

    return train_step


def make_seg_eval_step(model: torch.nn.Module, *, num_classes: int, num_inst: int,
                       overlap: int, ce_ratio: float = 0.1, dice_ratio: float = 0.9,
                       device=None) -> Callable:
    """``eval_step(img, seg, cut_y, cut_x, wsi_nr) -> {"loss", "cm",
    "inst_cm"}`` with the model's current parameters and running statistics:
    the batch's loss, its masked ``[C, C]`` matrix and the per-instance
    increments ``[num_inst, C, C]``."""
    dev = resolve_device(device)
    o = overlap
    crop = (slice(None), slice(o, -o), slice(o, -o))

    @torch.no_grad()
    def eval_step(img, seg, cut_y, cut_x, wsi_nr):
        _check_device(model, dev)
        img = torch.as_tensor(img, dtype=torch.float32, device=dev)
        seg = torch.as_tensor(seg, device=dev)
        logits = model(img, train=False)
        loss = seg_loss(logits[crop], _binary_one_hot(seg)[crop],
                        ce_ratio=ce_ratio, dice_ratio=dice_ratio)
        pred = logits.argmax(-1)
        mask = border_mask(tuple(pred.shape[1:]), overlap, torch.as_tensor(cut_y, device=dev),
                           torch.as_tensor(cut_x, device=dev))
        cms = confusion_matrix(pred, seg, num_classes, mask=mask, per_sample=True)
        inst_cm = torch.zeros((num_inst, num_classes, num_classes), dtype=torch.float32,
                              device=dev).index_add_(0, torch.as_tensor(wsi_nr, device=dev)
                                                     .long(), cms)
        return {"loss": loss, "cm": cms.sum(0), "inst_cm": inst_cm}

    return eval_step
