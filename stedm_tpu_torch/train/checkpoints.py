"""Checkpoint save/restore with ``torch.save`` (stedm_tpu/train/checkpoints.py).

A checkpoint is one file, ``<ckpt_dir>/<name>.pt``, holding a dict:

* a full training state (``save`` of a ``TrainState``): ``format`` is
  ``"train_state"``; ``params`` is the model's fp32 state_dict; ``logvar``
  the learned log-variance or None; ``ema`` the EMA shadow of the U-Net
  (fp32, keyed as ``model.unet.named_parameters()``) and ``ema_updates``;
  ``step``; ``opt`` the AdamW state_dict (its first and second moments and
  step counts), the accumulation counters ``mini_step`` and
  ``gradient_step``, and ``acc_grads``, the gradients summed since the last
  applied update (``optax.MultiSteps``' ``acc_grads``; empty right after an
  update);
* a segmentation training state (``save`` of a ``SegTrainState``, saved by
  train_seg under ``{run_name}_last`` and ``{run_name}_best``):
  ``format`` is ``"seg_state"``; ``params`` the model's state_dict (the
  BatchNorm running statistics included), ``step`` and ``opt`` as above;
* a codec fine-tuning state (``save`` of an ``AEState``, saved by train_ae
  under ``{run_name}_last`` and ``{run_name}_best``): ``format`` is
  ``"ae_state"``; ``params`` the codec's state_dict, ``disc`` the
  discriminator's (its running statistics included), ``logvar`` the KL
  variant's output log-variance or None, ``step``, and ``opt`` both Adam
  state_dicts (``gen``, ``disc``);
* parameters alone (``save`` of a state_dict): ``format`` is ``"params"``.

``partial_restore`` keeps the JAX function's matching rule
(checkpoints.py:43-66) on the port's dotted state_dict names. The JAX
package's orbax directories are not read yet (ROADMAP §1: reading a JAX
orbax directory): given a
directory, ``load`` raises and says so.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import torch

from stedm_tpu_torch.train.ae_steps import AEState
from stedm_tpu_torch.train.optim import OptState
from stedm_tpu_torch.train.seg_steps import SegTrainState
from stedm_tpu_torch.train.steps import TrainState

SUFFIX = ".pt"


def checkpoint_file(ckpt_dir: str | Path, name: str = "last") -> Path:
    return Path(ckpt_dir) / f"{name}{SUFFIX}"


def _cpu(tensors: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _opt_payload(opt: OptState) -> dict:
    return {"adamw": opt.adamw.state_dict(), "mini_step": int(opt.mini_step),
            "gradient_step": int(opt.gradient_step),
            "acc_grads": [None if p.grad is None else p.grad.detach().cpu().clone()
                          for p in opt.params]}


def _state_payload(state: TrainState | SegTrainState | AEState) -> dict:
    if isinstance(state, AEState):
        return {"format": "ae_state", "params": _cpu(state.model.state_dict()),
                "disc": _cpu(state.disc.state_dict()),
                "logvar": None if state.logvar is None else state.logvar.detach().cpu().clone(),
                "step": int(state.step),
                "opt": {"gen": state.gen_opt.state_dict(), "disc": state.disc_opt.state_dict()}}
    if isinstance(state, SegTrainState):
        return {"format": "seg_state", "params": _cpu(state.model.state_dict()),
                "step": int(state.step), "opt": _opt_payload(state.opt_state)}
    return {
        "format": "train_state",
        "params": _cpu(state.model.state_dict()),
        "logvar": None if state.logvar is None else state.logvar.detach().cpu().clone(),
        "ema": _cpu(state.ema_params),
        "ema_updates": int(state.ema_updates),
        "step": int(state.step),
        "opt": _opt_payload(state.opt_state),
    }


@torch.no_grad()
def _restore_opt(opt_state: OptState, opt: dict) -> None:
    opt_state.adamw.load_state_dict(opt["adamw"])
    if len(opt["acc_grads"]) != len(opt_state.params):
        raise ValueError("the checkpoint's optimizer covers other parameters")
    for p, g in zip(opt_state.params, opt["acc_grads"]):
        p.grad = None if g is None else g.to(p.device)
    opt_state.mini_step = opt["mini_step"]
    opt_state.gradient_step = opt["gradient_step"]


def save(ckpt_dir: str | Path,
         state: TrainState | SegTrainState | AEState | Mapping[str, torch.Tensor],
         name: str = "last") -> str:
    """Write a ``TrainState``, a ``SegTrainState``, an ``AEState`` or a bare
    state_dict; returns the file's path.
    The file is written beside its target and then renamed over it, so an
    interrupted save leaves the previous checkpoint whole."""
    if isinstance(state, (TrainState, SegTrainState, AEState)):
        payload = _state_payload(state)
    else:
        payload = {"format": "params", "params": _cpu(state)}
    path = checkpoint_file(ckpt_dir, name).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)
    return str(path)


def load(ckpt_path: str | Path) -> dict:
    """The dict a checkpoint file holds, its tensors on the CPU.
    ``ckpt_path`` names the file, with or without its ``.pt``."""
    path = Path(ckpt_path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?): the "
            "reader for those is still to come (ROADMAP §1: reading a JAX orbax "
            "directory); the port reads "
            f"its own <name>{SUFFIX} files")
    if not path.is_file() and path.suffix != SUFFIX:
        path = path.with_name(path.name + SUFFIX)
    if not path.is_file():
        raise FileNotFoundError(f"no checkpoint at {ckpt_path}")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") not in ("train_state", "seg_state", "ae_state", "params"):
        raise ValueError(f"{path} is not a checkpoint of this package")
    return payload


def restore(ckpt_dir: str | Path, state: TrainState | SegTrainState,
            name: str = "last") -> TrainState | SegTrainState:
    """Load a full-state checkpoint into ``state`` (built as the saved one
    was: same model, optimizer settings and ``logvar``), in place."""
    payload = load(checkpoint_file(ckpt_dir, name))
    want = "seg_state" if isinstance(state, SegTrainState) else "train_state"
    if payload["format"] == "params":
        raise ValueError(f"{ckpt_dir}/{name}: a params-only checkpoint has no train state")
    if payload["format"] != want:
        raise ValueError(f"{ckpt_dir}/{name}: a {payload['format']} checkpoint, not a {want}")
    if want == "seg_state":
        state.model.load_state_dict(payload["params"], strict=True)
        _restore_opt(state.opt_state, payload["opt"])
        state.step = payload["step"]
        return state
    if (payload["logvar"] is None) != (state.logvar is None):
        raise ValueError("the checkpoint and the state disagree on learn_logvar")
    state.model.load_state_dict(payload["params"], strict=True)
    with torch.no_grad():
        if state.logvar is not None:
            state.logvar.copy_(payload["logvar"])
        if payload["ema"].keys() != state.ema_params.keys():
            raise ValueError("the checkpoint's EMA shadow covers other parameters")
        for k, v in payload["ema"].items():
            state.ema_params[k].copy_(v)
    _restore_opt(state.opt_state, payload["opt"])
    state.ema_updates = payload["ema_updates"]
    state.step = payload["step"]
    return state


def partial_restore(params: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor], *,
                    ignore_keys: list[str] = (),
                    only_subtree: str | None = None) -> dict[str, torch.Tensor]:
    """Merge ``loaded`` (a possibly partial state_dict) into ``params``: a
    name takes the loaded tensor, cast to its dtype, when the shapes are
    equal, unless the name starts with an ``ignore_keys`` entry or holds it
    after a dot, or lies outside ``only_subtree`` (a name prefix, the
    reference's ``load_only_unet``). The JAX function's rule
    (checkpoints.py:43-66) on '/'-joined names; here the names are dotted."""
    out = {}
    for name, leaf in params.items():
        out[name] = leaf
        if only_subtree and not name.startswith(only_subtree):
            continue
        if any(name.startswith(ik) or f".{ik}" in name for ik in ignore_keys):
            continue
        got = loaded.get(name)
        if got is not None and tuple(got.shape) == tuple(leaf.shape):
            out[name] = got.to(leaf.dtype)
    return out
