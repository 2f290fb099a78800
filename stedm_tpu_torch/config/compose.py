"""Hydra-style YAML config composition, dependency-free.

A copy of stedm_tpu/config/compose.py: the port imports nothing of the JAX
package. It reads the same ``configs/`` at the repository root.

The reference drives everything through Hydra 1.x (`@hydra.main(config_path="conf")`,
reference `train_diff.py:34`) with group defaults lists and CLI overrides like
`data/dataset=[her2_anno,her2_syn] data.ratios=[0.2,0.8] +ckpt_name=...`
(reference `README.md:37-51`). Hydra is not available in this environment, so this
module implements the subset of composition semantics that config surface needs:

* ``defaults`` lists with ``_self_`` ordering, group selections (``- data: flowers``),
  multi-selections (``- dataset: [flowers_anno]``) and package redirection
  (``- annotator@her2_anno.annotator: her2``),
* group option files placed at their group package (``conf/data/flowers.yaml`` lands
  at ``cfg.data``; ``conf/data/dataset/her2_anno.yaml`` merges into
  ``cfg.data.dataset``),
* CLI overrides: ``key=value`` / ``key.sub=value`` value overrides, ``group=option``
  and ``group/sub=[a,b]`` group re-selection, ``+key=value`` additions,
* ``hydra``-namespace entries are accepted and ignored.

Values are parsed as YAML, so ``data.ratios=[0.2,0.8]`` yields a real list.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Iterable

import yaml


class Config(dict):
    """A nested dict with attribute access (a stand-in for OmegaConf's DictConfig)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:  # pragma: no cover - trivial
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as exc:  # pragma: no cover - trivial
            raise AttributeError(name) from exc

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def copy(self) -> "Config":
        return Config.wrap(to_container(self))


def to_container(obj: Any) -> Any:
    """Recursively convert Config nodes back to plain dicts/lists."""
    if isinstance(obj, dict):
        return {k: to_container(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_container(v) for v in obj]
    return obj


class _Loader(yaml.SafeLoader):
    """SafeLoader with a YAML-1.2-style float resolver so ``1e-7`` parses as a float
    (YAML 1.1 requires ``1.0e-7``; Hydra/OmegaConf accept the short form)."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    __import__("re").compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
           |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
           |\.[0-9_]+(?:[eE][-+][0-9]+)?
           |[-+]?\.(?:inf|Inf|INF)
           |\.(?:nan|NaN|NAN))$""", __import__("re").X),
    list("-+0123456789."),
)


def load_yaml(path: Path) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        data = yaml.load(f, Loader=_Loader)
    return data or {}


def _deep_merge(base: dict, new: dict) -> dict:
    """Merge ``new`` into ``base`` (later wins), recursing into dicts."""
    for key, value in new.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, dict):
            _deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value)
    return base


def _set_path(root: dict, dotted: str, value: Any, *, merge: bool = False) -> None:
    parts = dotted.split(".") if dotted else []
    node = root
    for part in parts[:-1]:
        node = node.setdefault(part, {})
        if not isinstance(node, dict):
            raise ValueError(f"Cannot descend into non-dict config node at '{part}'")
    if not parts:
        if merge and isinstance(value, dict):
            _deep_merge(root, value)
        else:
            raise ValueError("Empty config path")
        return
    leaf = parts[-1]
    if merge and isinstance(node.get(leaf), dict) and isinstance(value, dict):
        _deep_merge(node[leaf], value)
    else:
        node[leaf] = copy.deepcopy(value)


def _parse_value(text: str) -> Any:
    try:
        return yaml.load(text, Loader=_Loader)
    except yaml.YAMLError:
        return text


class _Composer:
    def __init__(self, config_dir: Path):
        self.config_dir = Path(config_dir)

    def compose(self, config_name: str, overrides: Iterable[str] | None = None) -> Config:
        group_overrides: dict[str, Any] = {}
        value_overrides: list[tuple[str, Any, bool]] = []
        for ov in overrides or []:
            if "=" not in ov:
                raise ValueError(f"Malformed override (expected key=value): {ov!r}")
            key, _, raw = ov.partition("=")
            key = key.strip()
            additive = key.startswith("+")
            if additive:
                key = key[1:]
            value = _parse_value(raw)
            if not additive and self._is_group(key):
                group_overrides[key] = value
            else:
                value_overrides.append((key, value, additive))

        cfg: dict = {}
        consumed: set[str] = set()
        self._load_into(cfg, self.config_dir / f"{config_name}.yaml",
                        package="", group_path="", group_overrides=group_overrides,
                        consumed=consumed)
        # group overrides that never matched a defaults entry are applied directly
        for key, value in group_overrides.items():
            if key not in consumed:
                self._apply_group(cfg, key, value, package=None)

        for key, value, additive in value_overrides:
            _set_path(cfg, key, value)

        cfg.pop("hydra", None)
        return Config.wrap(cfg)

    # -- internals ---------------------------------------------------------

    def _is_group(self, key: str) -> bool:
        return "." not in key and (self.config_dir / key).is_dir()

    def _load_into(self, cfg: dict, path: Path, *, package: str, group_path: str,
                   group_overrides: dict[str, Any], consumed: set[str]) -> None:
        data = load_yaml(path)
        defaults = data.pop("defaults", None)
        data.pop("hydra", None)

        def merge_self() -> None:
            _set_path(cfg, package, data, merge=True) if package else _deep_merge(cfg, data)

        if defaults is None:
            merge_self()
            return

        self_seen = False
        for entry in defaults:
            if entry == "_self_":
                merge_self()
                self_seen = True
                continue
            if isinstance(entry, str):
                # plain sibling config: merge at this file's package
                sibling = path.parent / f"{entry}.yaml"
                self._load_into(cfg, sibling, package=package, group_path=group_path,
                                group_overrides=group_overrides, consumed=consumed)
                continue
            if not isinstance(entry, dict) or len(entry) != 1:
                raise ValueError(f"Unsupported defaults entry in {path}: {entry!r}")
            (key, option), = entry.items()
            if key.startswith("override "):
                key = key[len("override "):]
            if key.split("@")[0].split("/")[0] == "hydra":
                continue
            group, _, pkg_redirect = key.partition("@")
            full_group = f"{group_path}/{group}" if group_path else group
            if full_group in group_overrides and full_group not in consumed:
                option = group_overrides[full_group]
                consumed.add(full_group)
            if pkg_redirect:
                target_pkg = f"{package}.{pkg_redirect}" if package else pkg_redirect
            else:
                leaf = group.split("/")[-1]
                target_pkg = f"{package}.{leaf}" if package else leaf
            options = option if isinstance(option, list) else [option]
            for opt in options:
                if opt is None:
                    continue
                opt_path = path.parent / group / f"{opt}.yaml"
                if not opt_path.exists():
                    # group may be addressed from the config root (absolute group)
                    opt_path = self.config_dir / group / f"{opt}.yaml"
                self._load_into(cfg, opt_path, package=target_pkg,
                                group_path=full_group,
                                group_overrides=group_overrides, consumed=consumed)
        if not self_seen:
            merge_self()

    def _apply_group(self, cfg: dict, group: str, option: Any, package: str | None) -> None:
        """Apply a CLI group override that did not match any defaults entry."""
        options = option if isinstance(option, list) else [option]
        target_pkg = package if package is not None else group.replace("/", ".")
        # a fresh selection replaces whatever the defaults put there
        _set_path(cfg, target_pkg, {})
        for opt in options:
            opt_path = self.config_dir / group / f"{opt}.yaml"
            self._load_into(cfg, opt_path, package=target_pkg, group_path=group,
                            group_overrides={}, consumed=set())


def compose(config_name: str, overrides: Iterable[str] | None = None,
            config_dir: str | Path | None = None) -> Config:
    """Compose a config like ``hydra.main`` would (reference `train_diff.py:34`)."""
    if config_dir is None:
        config_dir = Path(__file__).resolve().parents[2] / "configs"
    return _Composer(Path(config_dir)).compose(config_name, overrides)
