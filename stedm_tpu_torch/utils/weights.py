"""Weight bridge: the JAX package's parameter tree -> this package's state_dict.

The JAX tree is nested mappings of arrays with the top-level groups ``unet``,
``first_stage``, ``cond_stage`` and ``agg`` (numpy arrays, or anything
``np.asarray`` takes). The port's key names are the reference torch layouts
that stedm_tpu/utils/torch_import.py reads, so this is the inverse of that
importer: HWIO conv kernels -> OIHW, Dense ``[in, out]`` -> Linear
``[out, in]``, the U-Net attention's Dense qkv/proj -> conv1d
``[out, in, 1]``, norm ``scale`` -> ``weight``. Codec fine-tuning's pieces
have their own: ``codec_state_dict`` (VQ or KL codec),
``discriminator_state_dict`` (params and batch statistics) and
``lpips_state_dict``. Nothing here imports the JAX package.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()):
    """(path, leaf) pairs; a GroupNorm wrapper ``X/norm/{scale,bias}``
    collapses to ``X/{scale,bias}`` (the port's GNSiLU owns its affine)."""
    for key, val in tree.items():
        if isinstance(val, Mapping):
            inner = val.get("norm") if set(val) == {"norm"} else None
            if isinstance(inner, Mapping) and set(inner) <= {"scale", "bias"}:
                for leaf, arr in inner.items():
                    yield prefix + (key, leaf), arr
            else:
                yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _leaf(parts: list[str], name: str, arr, conv1d: bool) -> tuple[list[str], np.ndarray]:
    a = np.asarray(arr, dtype=np.float32)
    if name == "kernel":
        if a.ndim == 4:
            return parts + ["weight"], a.transpose(3, 2, 0, 1)
        return parts + ["weight"], a.T[:, :, None] if conv1d else a.T
    if name == "scale":
        return parts + ["weight"], a
    if name == "embedding":
        return parts + ["embedding", "weight"], a
    return parts + [name], a


_RES = {"in_norm": "in_layers.0", "in_conv": "in_layers.2", "emb": "emb_layers.1",
        "out_norm": "out_layers.0", "out_conv": "out_layers.3", "skip": "skip_connection"}


def _unet_parts(parts: list[str], tree: Mapping) -> list[str]:
    head, rest = parts[0], parts[1:]
    if m := re.fullmatch(r"time_embed_(\d+)", head):
        return [f"time_embed.{m[1]}"]
    if head in ("out_norm", "out_conv"):
        return ["out.0" if head == "out_norm" else "out.2"]
    if m := re.fullmatch(r"middle_block_(\d)", head):
        base = "middle_block.1.block" if m[1] == "1" else f"middle_block.{m[1]}"
    elif m := re.fullmatch(r"(input|output)_blocks_(\d+)_(\d+|up)", head):
        kind, i, j = m.groups()
        if j == "up":   # after the block's attention, if it has one
            j = "2" if f"output_blocks_{i}_1" in tree else "1"
        base = f"{kind}_blocks.{i}.{j}"
    else:
        raise KeyError(f"unknown U-Net parameter group {head!r}")
    return [base] + [_RES.get(r, r) for r in rest]


def _vq_parts(parts: list[str], tree: Mapping) -> list[str]:
    out = []
    for p in parts:
        p = re.sub(r"^(down|up)_(\d+)_(block|attn)_(\d+)$", r"\1.\2.\3.\4", p)
        p = re.sub(r"^(down|up)_(\d+)_(downsample|upsample)$", r"\1.\2.\3", p)
        out.append(re.sub(r"^mid_(block_1|block_2|attn_1)$", r"mid.\1", p))
    return out


_SWIN = {"cpb_mlp_0": "cpb_mlp.0", "cpb_mlp_2": "cpb_mlp.2", "mlp_fc1": "mlp.0",
         "mlp_fc2": "mlp.3", "patch_embed": "features.0.0", "patch_norm": "features.0.2"}


def _swin_parts(parts: list[str], tree: Mapping) -> list[str]:
    out = []
    for p in parts:
        if m := re.fullmatch(r"stage(\d+)_block(\d+)", p):
            p = f"features.{2 * int(m[1]) + 1}.{m[2]}"
        elif m := re.fullmatch(r"merge(\d+)", p):
            p = f"features.{2 * int(m[1]) + 2}"
        out.append(_SWIN.get(p, p))
    return out


def _agg_parts(parts: list[str], tree: Mapping) -> list[str]:
    if parts[0] == "embedder":
        return ["embedder"] + _swin_parts(parts[1:], tree["embedder"])
    return parts


def _convert(tree: Mapping, key_fn, conv1d: bool = False) -> dict[str, torch.Tensor]:
    sd = {}
    for path, arr in _flatten(tree):
        parts = key_fn(list(path[:-1]), tree) if len(path) > 1 else []
        conv = conv1d and bool(parts) and parts[-1] in ("qkv", "proj_out")
        names, val = _leaf(parts, path[-1], arr, conv)
        sd[".".join(names)] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


def unet_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    return _convert(tree, _unet_parts, conv1d=True)


def vq_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    return _convert(tree, _vq_parts)


def swin_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    return _convert(tree, _swin_parts)


def agg_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    return _convert(tree, _agg_parts)


def cond_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    return _convert(tree, lambda parts, _: parts)


def codec_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    """A VQ or KL codec's state_dict from its JAX tree (a KL generator tree's
    ``lossvar`` group, the loss's output log-variance, is left out)."""
    return vq_state_dict({k: v for k, v in tree.items() if k != "lossvar"})


def discriminator_state_dict(params: Mapping, batch_stats: Mapping | None = None
                             ) -> dict[str, torch.Tensor]:
    """``NLayerDiscriminator``'s state_dict from the JAX ``params`` and
    ``batch_stats`` (the inverse of torch_import.py:map_discriminator):
    ``main_{i}`` -> ``main.{i}``; a BatchNorm's ``scale`` / ``mean`` / ``var``
    -> ``weight`` / ``running_mean`` / ``running_var`` (with a zero
    ``num_batches_tracked``), an ActNorm's ``loc`` / ``scale`` -> ``[1, C, 1,
    1]`` (with ``initialized`` set)."""
    sd = {}
    for name, leaves in params.items():
        base = name.replace("main_", "main.")
        actnorm = "loc" in leaves
        for leaf, arr in leaves.items():
            a = np.array(arr, dtype=np.float32)
            if leaf == "kernel":
                sd[f"{base}.weight"] = a.transpose(3, 2, 0, 1)
            elif actnorm:
                sd[f"{base}.{leaf}"] = a.reshape(1, -1, 1, 1)
            else:
                sd[f"{base}.{'weight' if leaf == 'scale' else leaf}"] = a
        if actnorm:
            sd[f"{base}.initialized"] = np.array(1, dtype=np.uint8)
    for name, leaves in (batch_stats or {}).items():
        base = name.replace("main_", "main.")
        sd[f"{base}.running_mean"] = np.array(leaves["mean"], dtype=np.float32)
        sd[f"{base}.running_var"] = np.array(leaves["var"], dtype=np.float32)
        sd[f"{base}.num_batches_tracked"] = np.array(0, dtype=np.int64)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


# taming ScalingLayer buffers, which the JAX LPIPS keeps as constants
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def lpips_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """``LPIPS``'s state_dict from the JAX LPIPS params (the inverse of
    torch_import.py:map_lpips): ``net/net_slice{s}_{i}`` -> ``net.slice{s}.{i}``,
    ``lin{k}_model_1`` -> ``lin{k}.model.1``, plus the scaling buffers."""
    sd = {"scaling_layer.shift": torch.tensor(_LPIPS_SHIFT).view(1, 3, 1, 1),
          "scaling_layer.scale": torch.tensor(_LPIPS_SCALE).view(1, 3, 1, 1)}
    for path, arr in _flatten(params):
        *parts, leaf = path
        if parts[0] == "net":
            m = re.fullmatch(r"net_slice(\d)_(\d+)", parts[1])
            key = f"net.slice{m[1]}.{m[2]}"
        else:
            key = re.sub(r"^lin(\d)_model_1$", r"lin\1.model.1", parts[0])
        names, val = _leaf([key], leaf, arr, conv1d=False)
        sd[".".join(names)] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


_GROUPS = {"unet": unet_state_dict, "first_stage": vq_state_dict,
           "cond_stage": cond_state_dict, "agg": agg_state_dict}


def state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The port STEDM's state_dict from a JAX STEDM parameter tree; groups
    the port does not hold (e.g. a trained ``logvar``) are left out."""
    sd = {}
    for group, fn in _GROUPS.items():
        if group in params:
            sd.update({f"{group}.{k}": v for k, v in fn(params[group]).items()})
    return sd
