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
``lpips_state_dict``; the segmentation net has ``seg_state_dict`` and the
MiT-B2 importer ``load_seg_encoder`` (torch_import.py:445, :655-671).

The CompVis readers (torch_import.py:101-442, :674-732) load a torch
checkpoint into the port's models with the JAX importer's rule: a tensor
that the importer maps (``map_unet``, ``map_vq``, ``map_full_ldm``) is
loaded where its name and shape match, everything else keeps its init. The
importer names what it maps by flax paths, and ``ignore_keys`` are matched
as substrings of those; so every port parameter carries its flax path
(``flax_paths``, the inverse of the name maps above) and the readers match
on it, skipping exactly what the JAX importer skips.
Nothing here imports the JAX package.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from pathlib import Path

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
    if head == "label_emb":
        return [head]
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


def _node(tree: Mapping, keys) -> Mapping:
    for key in keys:
        tree = tree[key]
    return tree


def _convert(tree: Mapping, key_fn, conv1d: bool = False) -> dict[str, torch.Tensor]:
    sd = {}
    for path, arr in _flatten(tree):
        parts = key_fn(list(path[:-1]), tree) if len(path) > 1 else []
        # the attention block's qkv / proj_out (not a spatial transformer's)
        conv = (conv1d and bool(parts) and parts[-1] in ("qkv", "proj_out")
                and "qkv" in _node(tree, path[:-2]))
        names, val = _leaf(parts, path[-1], arr, conv)
        sd[".".join(names)] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


def unet_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    """The U-Net's state_dict; the class embedding ``label_emb/embedding``
    becomes the reference's ``label_emb.weight``."""
    sd = _convert(tree, _unet_parts, conv1d=True)
    if "label_emb.embedding.weight" in sd:
        sd["label_emb.weight"] = sd.pop("label_emb.embedding.weight")
    return sd


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


def seg_state_dict(params: Mapping, batch_stats: Mapping | None = None
                   ) -> dict[str, torch.Tensor]:
    """``SegUNet``'s state_dict from the JAX ``params`` and ``batch_stats``:
    the port's module names are the JAX tree's, so only the layouts change
    (Dense ``[in, out]`` -> ``[out, in]``, HWIO -> OIHW, the depthwise
    ``(3, 3, 1, C)`` -> ``(C, 1, 3, 3)``, ``scale`` -> ``weight``) and a
    BatchNorm's ``mean`` / ``var`` become ``running_mean`` / ``running_var``."""
    sd = _convert(params, lambda parts, _: parts)
    for path, arr in _flatten(batch_stats or {}):
        *parts, leaf = path
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[".".join([*parts, name])] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return sd


def map_mit_b2(sd: Mapping[str, torch.Tensor], root: str = "") -> dict[str, torch.Tensor]:
    """A Mix-Transformer (SegFormer MiT) encoder state_dict in the published
    NVlabs layout (``patch_embed1.proj``, ``block1.0.attn.kv``, ``norm1``;
    what segmentation_models_pytorch wraps for ``encoder_weights="imagenet"``)
    -> ``MiTEncoder``'s state_dict (torch_import.py:445-492). ``root`` is
    the prefix to strip (``"_model.encoder."`` for a Lightning checkpoint,
    ``"encoder."`` for an smp.Unet state_dict). The fused ``attn.kv`` splits
    into ``attn.k`` and ``attn.v``; the classification ``head.*`` is left out."""
    if root:
        sd = {k[len(root):]: v for k, v in sd.items() if k.startswith(root)}
    out: dict[str, torch.Tensor] = {}

    def put(dst: str, src: str) -> None:
        out[f"{dst}.weight"], out[f"{dst}.bias"] = sd[f"{src}.weight"], sd[f"{src}.bias"]

    for s in range(4):
        t = s + 1
        if f"patch_embed{t}.proj.weight" not in sd:
            continue
        put(f"patch_embed_{s}", f"patch_embed{t}.proj")
        put(f"embed_norm_{s}", f"patch_embed{t}.norm")
        put(f"stage_norm_{s}", f"norm{t}")
        i = 0
        while f"block{t}.{i}.norm1.weight" in sd:
            bt, bj = f"block{t}.{i}.", f"stage{s}_block{i}."
            for name in ("norm1", "norm2", "attn.q", "attn.proj", "mlp.fc1", "mlp.fc2"):
                put(bj + name.replace("mlp.", "ffn."), bt + name)
            kv_w, kv_b = sd[f"{bt}attn.kv.weight"], sd[f"{bt}attn.kv.bias"]
            c = kv_w.shape[0] // 2
            out[f"{bj}attn.k.weight"], out[f"{bj}attn.k.bias"] = kv_w[:c], kv_b[:c]
            out[f"{bj}attn.v.weight"], out[f"{bj}attn.v.bias"] = kv_w[c:], kv_b[c:]
            if f"{bt}attn.sr.weight" in sd:  # sr_ratio > 1 stages only
                put(f"{bj}attn.sr", f"{bt}attn.sr")
                put(f"{bj}attn.sr_norm", f"{bt}attn.norm")
            put(f"{bj}ffn.dwconv", f"{bt}mlp.dwconv.dwconv")
            i += 1
    return out


def load_torch_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """The tensors of a torch checkpoint file (its ``state_dict`` entry when
    it has one), as torch_import.py:load_torch_state_dict reads them. The
    file comes from outside, so it is read with ``weights_only=True`` and
    never fully unpickled (the JAX importer falls back to that); a file
    holding other objects raises."""
    return _tensors(torch.load(path, map_location="cpu", weights_only=True))


def _tensors(payload: Mapping) -> dict[str, torch.Tensor]:
    if "state_dict" in payload:
        payload = payload["state_dict"]
    return {k: torch.as_tensor(v) for k, v in payload.items() if hasattr(v, "shape")}


def load_seg_encoder(model: torch.nn.Module, path: str | Path) -> tuple[int, int]:
    """Load pretrained MiT-B2 weights into a ``SegUNet``'s encoder
    (reference modules/segmentation.py:41 ``encoder_weights="imagenet"``),
    the key root detected as torch_import.py:655-671 does (a bare NVlabs
    file, an smp.Unet state_dict or a Lightning checkpoint). A parameter
    takes the file's tensor where the name and shape match and keeps its
    value otherwise; returns (loaded, left) counted over all the model's
    parameters, printed as the JAX importer prints them. A directory (an
    orbax checkpoint) is not read yet (ROADMAP §1: reading a JAX orbax
    directory) and raises."""
    p = Path(path)
    if p.is_dir():
        raise NotImplementedError(
            f"{p} is a directory (an orbax checkpoint of the JAX package?): the reader "
            "for those is still to come (ROADMAP §1: reading a JAX orbax directory)")
    sd = load_torch_state_dict(p)
    root = next((cand for cand in ("_model.encoder.", "model.encoder.", "encoder.")
                 if any(k.startswith(cand + "patch_embed1.") for k in sd)), "")
    loaded = {f"encoder.{k}": v for k, v in map_mit_b2(sd, root=root).items()}
    n_loaded = n_left = 0
    with torch.no_grad():
        for name, param in model.named_parameters():
            got = loaded.get(name)
            if got is not None and tuple(got.shape) == tuple(param.shape):
                param.copy_(got.to(param.dtype))
                n_loaded += 1
            else:
                n_left += 1
    print(f"[torch_import] merged {n_loaded} tensors ({n_left} left at init)")
    return n_loaded, n_left


# ---- the CompVis readers ---------------------------------------------------

_RES_FLAX = {v: k for k, v in _RES.items()}


def _unet_flax(path: str, model: torch.nn.Module) -> str:
    """A U-Net module path -> its flax path (the inverse of ``_unet_parts``)."""
    if m := re.fullmatch(r"time_embed\.(\d+)", path):
        return f"time_embed_{m[1]}"
    if path in ("out.0", "out.2"):
        return "out_norm" if path == "out.0" else "out_conv"
    if path == "label_emb":
        return "label_emb/embedding"
    if m := re.fullmatch(r"middle_block\.1\.block(\..+)?", path):
        head, rest = "middle_block_1", m[1] or ""
    elif m := re.fullmatch(r"middle_block\.(\d)(\..+)?", path):
        head, rest = f"middle_block_{m[1]}", m[2] or ""
    elif m := re.fullmatch(r"(input|output)_blocks\.(\d+)\.(\d+)(\..+)?", path):
        kind, i, j, rest = m[1], m[2], m[3], m[4] or ""
        block = model.get_submodule(f"{kind}_blocks.{i}.{j}")
        # a decoder level's last layer: an Upsample, or a ResBlock with up
        up = type(block).__name__ == "Upsample" or getattr(block, "up", False)
        head = f"{kind}_blocks_{i}_{'up' if up else j}"
    else:
        raise KeyError(f"unknown U-Net module {path!r}")
    parts = rest.lstrip(".").split(".") if rest else []
    for k in range(len(parts) - 1, -1, -1):     # two-part ResBlock names first
        pair = ".".join(parts[k:k + 2])
        if pair in _RES_FLAX:
            parts[k:k + 2] = [_RES_FLAX[pair]]
    return "/".join([head] + [_RES_FLAX.get(p, p) for p in parts])


def _vq_flax(path: str, model) -> str:
    path = re.sub(r"(down|up)\.(\d+)\.(block|attn)\.(\d+)", r"\1_\2_\3_\4", path)
    path = re.sub(r"(down|up)\.(\d+)\.(downsample|upsample)", r"\1_\2_\3", path)
    return re.sub(r"mid\.(block_1|block_2|attn_1)", r"mid_\1", path).replace(".", "/")


_SWIN_FLAX = {v: k for k, v in _SWIN.items()}


def _swin_flax(path: str) -> str:
    for port, flax in _SWIN_FLAX.items():
        if path == port or path.startswith(port + "."):
            return flax + path[len(port):].replace(".", "/")
    out, parts = [], path.split(".")
    while parts:
        if len(parts) >= 3 and parts[0] == "features" and int(parts[1]) % 2:
            out.append(f"stage{(int(parts[1]) - 1) // 2}_block{parts[2]}")
            parts = parts[3:]
        elif len(parts) >= 2 and parts[0] == "features":
            out.append(f"merge{int(parts[1]) // 2 - 1}")
            parts = parts[2:]
        elif ".".join(parts[:2]) in _SWIN_FLAX:
            out.append(_SWIN_FLAX[".".join(parts[:2])])
            parts = parts[2:]
        else:
            out.append(parts.pop(0))
    return "/".join(out)


def _agg_flax(path: str, model) -> str:
    if path == "embedder" or path.startswith("embedder."):
        rest = path[len("embedder."):]
        return "embedder" + ("/" + _swin_flax(rest) if rest else "")
    return path.replace(".", "/")


_FLAX_GROUPS = {"unet": _unet_flax, "first_stage": _vq_flax, "agg": _agg_flax,
                "cond_stage": lambda path, _: path.replace(".", "/")}


def _flax_leaf(module: torch.nn.Module, leaf: str) -> str:
    """A parameter's flax leaf name by the kind of its module."""
    kind = type(module).__name__
    if "GNSiLU" in kind or isinstance(module, torch.nn.GroupNorm):
        return {"weight": "norm/scale", "bias": "norm/bias"}[leaf]
    if isinstance(module, torch.nn.LayerNorm):
        return {"weight": "scale", "bias": "bias"}[leaf]
    if isinstance(module, (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d)):
        return {"weight": "kernel", "bias": "bias"}[leaf]
    return leaf


def flax_paths(module: torch.nn.Module, group: str | None = None) -> dict[str, str]:
    """Each parameter of ``module`` -> its path in the JAX tree ('/'-joined):
    of a whole STEDM when ``group`` is None, else of that group's module
    (``unet``, ``first_stage``, ``cond_stage``, ``agg``), relative to it."""
    if group is None:
        out = {}
        for name, child in module.named_children():
            out.update({f"{name}.{k}": f"{name}/{v}" for k, v in flax_paths(child, name).items()})
        return out
    out = {}
    for mod_path, mod in module.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            key = f"{mod_path}.{leaf}" if mod_path else leaf
            if isinstance(mod, torch.nn.Embedding):   # the codebook: X/embedding
                out[key] = _FLAX_GROUPS[group](mod_path, module)
            elif mod_path:
                out[key] = f"{_FLAX_GROUPS[group](mod_path, module)}/{_flax_leaf(mod, leaf)}"
            else:
                out[key] = leaf
    return out


def _resblock(prefix: str, flax: str, sd: Mapping, out: dict) -> None:
    for fname, tname in _RES.items():
        for leaf in ("weight", "bias"):
            if f"{prefix}{tname}.{leaf}" in sd:
                flax_leaf = ("norm/scale" if leaf == "weight" else "norm/bias") \
                    if "norm" in fname else ("kernel" if leaf == "weight" else "bias")
                out[f"{flax}/{fname}/{flax_leaf}"] = sd[f"{prefix}{tname}.{leaf}"]


def _conv(prefix: str, flax: str, sd: Mapping, out: dict) -> None:
    """A conv or dense: its weight and its bias, when the weight is there."""
    if f"{prefix}weight" in sd:
        out[f"{flax}/kernel"] = sd[f"{prefix}weight"]
        out[f"{flax}/bias"] = sd[f"{prefix}bias"]


def _norm(prefix: str, flax: str, sd: Mapping, out: dict) -> None:
    if f"{prefix}weight" in sd:
        out[f"{flax}/norm/scale"] = sd[f"{prefix}weight"]
        out[f"{flax}/norm/bias"] = sd[f"{prefix}bias"]


def map_unet(sd: Mapping[str, torch.Tensor], root: str = "model.diffusion_model."
             ) -> dict[str, torch.Tensor]:
    """The torch U-Net tensors that torch_import.py:map_unet maps, by flax
    path (relative to ``unet``), in torch layout: the port's own."""
    sd = {k[len(root):]: v for k, v in sd.items() if k.startswith(root)}
    out: dict = {}
    for i in (0, 2):
        if f"time_embed.{i}.weight" in sd:
            _conv(f"time_embed.{i}.", f"time_embed_{i}", sd, out)
    _conv("input_blocks.0.0.", "input_blocks_0_0", sd, out)
    idx = 1
    while any(k.startswith(f"input_blocks.{idx}.") for k in sd):
        if f"input_blocks.{idx}.0.op.weight" in sd:   # Downsample
            _conv(f"input_blocks.{idx}.0.op.", f"input_blocks_{idx}_0/op", sd, out)
        else:
            _resblock(f"input_blocks.{idx}.0.", f"input_blocks_{idx}_0", sd, out)
        idx += 1
    _resblock("middle_block.0.", "middle_block_0", sd, out)
    _resblock("middle_block.1.block.", "middle_block_1", sd, out)
    _norm("middle_block.2.norm.", "middle_block_2/norm", sd, out)
    for name in ("qkv", "proj_out"):
        _conv(f"middle_block.2.{name}.", f"middle_block_2/{name}", sd, out)
    _resblock("middle_block.3.", "middle_block_3", sd, out)
    idx = 0
    while any(k.startswith(f"output_blocks.{idx}.") for k in sd):
        _resblock(f"output_blocks.{idx}.0.", f"output_blocks_{idx}_0", sd, out)
        _conv(f"output_blocks.{idx}.1.conv.", f"output_blocks_{idx}_up/conv", sd, out)
        idx += 1
    if "out.0.weight" in sd:
        _norm("out.0.", "out_norm", sd, out)
        _conv("out.2.", "out_conv", sd, out)
    return out


def _vq_resnet(prefix: str, flax: str, sd: Mapping, out: dict) -> None:
    for name in ("norm1", "norm2"):
        for leaf, fl in (("weight", "scale"), ("bias", "bias")):
            if f"{prefix}{name}.{leaf}" in sd:
                out[f"{flax}/{name}/norm/{fl}"] = sd[f"{prefix}{name}.{leaf}"]
    for name in ("conv1", "conv2", "nin_shortcut"):
        for leaf, fl in (("weight", "kernel"), ("bias", "bias")):
            if f"{prefix}{name}.{leaf}" in sd:
                out[f"{flax}/{name}/{fl}"] = sd[f"{prefix}{name}.{leaf}"]


def map_vq(sd: Mapping[str, torch.Tensor], root: str = "") -> dict[str, torch.Tensor]:
    """The codec tensors that torch_import.py:map_vq maps (bare vq-f4.ckpt
    keys, or under ``root``), by flax path relative to the codec."""
    if root:
        sd = {k[len(root):]: v for k, v in sd.items() if k.startswith(root)}
    out: dict = {}
    for side in ("encoder", "decoder"):
        if f"{side}.conv_in.weight" in sd:
            _conv(f"{side}.conv_in.", f"{side}/conv_in", sd, out)
            _norm(f"{side}.norm_out.", f"{side}/norm_out", sd, out)
            _conv(f"{side}.conv_out.", f"{side}/conv_out", sd, out)
            for mid in ("block_1", "block_2"):
                _vq_resnet(f"{side}.mid.{mid}.", f"{side}/mid_{mid}", sd, out)
            for name in ("q", "k", "v", "proj_out"):
                _conv(f"{side}.mid.attn_1.{name}.", f"{side}/mid_attn_1/{name}", sd, out)
            _norm(f"{side}.mid.attn_1.norm.", f"{side}/mid_attn_1/norm", sd, out)
    for lvl in range(16):
        for blk in range(8):
            _vq_resnet(f"encoder.down.{lvl}.block.{blk}.", f"encoder/down_{lvl}_block_{blk}",
                       sd, out)
            _vq_resnet(f"decoder.up.{lvl}.block.{blk}.", f"decoder/up_{lvl}_block_{blk}",
                       sd, out)
        _conv(f"encoder.down.{lvl}.downsample.conv.", f"encoder/down_{lvl}_downsample/conv",
              sd, out)
        _conv(f"decoder.up.{lvl}.upsample.conv.", f"decoder/up_{lvl}_upsample/conv", sd, out)
    if "quantize.embedding.weight" in sd:
        out["quantize/embedding"] = sd["quantize.embedding.weight"]
    for qc in ("quant_conv", "post_quant_conv"):
        _conv(f"{qc}.", qc, sd, out)
    return out


def map_full_ldm(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A whole CompVis LDM (or an entry-point ``model.``-prefixed)
    checkpoint by flax path of the STEDM tree: ``unet``, ``first_stage``
    and ``cond_stage`` (torch_import.py:428-442); the style branch is not
    mapped."""
    if any(k.startswith("model.model.diffusion_model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    out = {f"unet/{k}": v for k, v in map_unet(sd).items()}
    out.update({f"first_stage/{k}": v
                for k, v in map_vq(sd, root="first_stage_model.").items()})
    if "cond_stage_model.channel_mapper.weight" in sd:
        out["cond_stage/channel_mapper/kernel"] = sd["cond_stage_model.channel_mapper.weight"]
    return out


@torch.no_grad()
def merge_loaded(model: torch.nn.Module, loaded: Mapping[str, torch.Tensor],
                 paths: Mapping[str, str], *, subtree: str | None = None,
                 ignore_keys=()) -> tuple[int, int]:
    """Copy ``loaded`` (flax path -> tensor) into ``model`` where path and
    shape match (torch_import.py:674-705): ``paths`` gives each parameter's
    flax path (``flax_paths``); with ``subtree`` only the parameters under
    it count and ``loaded`` is relative to it; a parameter whose path holds
    an ``ignore_keys`` entry is skipped and not counted. Returns and prints
    (loaded, left at init)."""
    n_loaded = n_left = 0
    for key, param in model.named_parameters():
        name = paths[key]
        if subtree is not None:
            if not name.startswith(subtree + "/"):
                continue
            name_in = name[len(subtree) + 1:]
        else:
            name_in = name
        if any(ik and ik in name for ik in ignore_keys):
            continue
        got = loaded.get(name_in)
        if got is not None and tuple(got.shape) == tuple(param.shape):
            param.copy_(got.to(param.dtype))
            n_loaded += 1
        else:
            n_left += 1
    print(f"[torch_import] merged {n_loaded} tensors ({n_left} left at init)")
    return n_loaded, n_left


def read_weight_file(path: str | Path) -> tuple[str, dict[str, torch.Tensor]]:
    """``("port", state_dict)`` for a ``params`` or ``ae_state`` checkpoint
    of this package (train/checkpoints.py; the ``.pt`` may be left off),
    else ``("torch", tensors)`` as ``load_torch_state_dict`` reads them. A
    full train state raises, as does a directory (an orbax checkpoint of the
    JAX package, not read yet: ROADMAP §1: reading a JAX orbax directory)."""
    p = Path(path)
    if p.is_dir():
        raise NotImplementedError(
            f"{p} is a directory (an orbax checkpoint of the JAX package?): the reader "
            "for those is still to come (ROADMAP §1: reading a JAX orbax directory)")
    if not p.is_file() and p.with_name(p.name + ".pt").is_file():
        p = p.with_name(p.name + ".pt")
    payload = torch.load(p, map_location="cpu", weights_only=True)
    if isinstance(payload, Mapping) and "format" in payload:
        if payload["format"] not in ("params", "ae_state"):
            raise ValueError(f"{p} holds a full train state, not bare params")
        return "port", dict(payload["params"])
    return "torch", _tensors(payload)


def load_first_stage(codec: torch.nn.Module, path: str | Path) -> tuple[int, int]:
    """A first-stage checkpoint into ``codec`` (a VQ or KL codec), in JAX's
    two forms (train_diff.py:98-103, train_ae.py:144-162): a torch state
    dict through ``map_vq`` (``first_stage_model.`` stripped when present),
    non-strict; or this package's own ``ae_state`` / ``params`` file (a
    train_ae output, or a STEDM's params whose ``first_stage.`` part is
    taken), loaded strictly. Returns and prints (loaded, left at init)."""
    kind, sd = read_weight_file(path)
    if kind == "port":
        if any(k.startswith("first_stage.") for k in sd):
            sd = {k[len("first_stage."):]: v for k, v in sd.items()
                  if k.startswith("first_stage.")}
        codec.load_state_dict(sd, strict=True)
        n = sum(1 for _ in codec.parameters())
        print(f"[torch_import] merged {n} tensors (0 left at init)")
        return n, 0
    root = "first_stage_model." if any(k.startswith("first_stage_model.") for k in sd) else ""
    return merge_loaded(codec, map_vq(sd, root=root), flax_paths(codec, "first_stage"))


def load_into_model(model: torch.nn.Module, path: str | Path, *, subtree: str | None = None,
                    ignore_keys=()) -> tuple[int, int]:
    """A torch checkpoint into a STEDM (torch_import.py:708-732): with
    ``subtree="unet"`` through ``map_unet`` (root ``model.diffusion_model.``
    or ``model.model.diffusion_model.``), else the whole model through
    ``map_full_ldm``; then ``merge_loaded`` with ``ignore_keys``. The first
    stage loads through ``load_first_stage``."""
    kind, sd = read_weight_file(path)
    if kind == "port":
        raise ValueError(f"{path} is a checkpoint of this package, not a torch state dict")
    if subtree == "unet":
        root = ("model.diffusion_model." if any(k.startswith("model.diffusion_model.")
                                                for k in sd)
                else "model.model.diffusion_model.")
        loaded = map_unet(sd, root=root)
    else:
        loaded = map_full_ldm(sd)
    return merge_loaded(model, loaded, flax_paths(model), subtree=subtree,
                        ignore_keys=ignore_keys)
