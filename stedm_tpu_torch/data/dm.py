"""Root data module: per-dataset sub-modules, mixing ratios, predict pairing.

Equivalent of the reference's `DataModule` (reference `data/dm.py:10-87`): one
sub-datamodule per ``cfg.data.dataset`` entry with ratio > 0, instantiated by dotted
classpath (``ds_cfg.file``); train/val/test iterate the concatenation; predict zips
the first dataset's (layout, one-hot, seg) with the *second* dataset's style images —
this is how unseen styles pair with known layouts at generation time
(reference `data/ds.py:18-21`).

A copy of stedm_tpu/data/dm.py (the port imports nothing of the JAX package)
with one change: a shipped classpath ``stedm_tpu.data.<mod>.<Cls>`` resolves
to ``stedm_tpu_torch.data.<mod>.<Cls>``. The Flowers, HER2 and CATCH modules
are ported; ``location.loader: grain`` selects the worker-process loader
(data/worker_loader.py) where the JAX package selects grain.
"""

from __future__ import annotations

import importlib

from stedm_tpu_torch.data.loader import ConcatDataset, Loader
from stedm_tpu_torch.data.worker_loader import WorkerLoader

_JAX_DATA = "stedm_tpu.data."
_PORTED = ("flowers", "her2", "catch")


def get_obj_from_str(path: str):
    """Dotted-path import (reference ldm/util.py:85-93); the JAX package's
    data classpaths map onto this package's copies."""
    if path.startswith(_JAX_DATA):
        mod = path[len(_JAX_DATA):].partition(".")[0]
        if mod not in _PORTED:
            raise NotImplementedError(f"{path}: the {mod} data module is not ported "
                                      "(ROADMAP §1)")
        path = "stedm_tpu_torch.data." + path[len(_JAX_DATA):]
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)


class PredictDataset:
    """Element i = (img, one_hot, seg) from the annotated ds + style images from the
    unannotated ds + index (reference data/ds.py:7-21)."""

    def __init__(self, img_ds, style_ds):
        self._img_ds = img_ds
        self._style_ds = style_ds

    def __len__(self):
        return len(self._img_ds)

    def __getitem__(self, idx, rng=None):
        img_tup = _maybe_rng(self._img_ds, idx, rng)
        style_tup = _maybe_rng(self._style_ds, idx, rng)
        return img_tup[0], img_tup[1], img_tup[2], style_tup[3], img_tup[4]


def _maybe_rng(ds, idx, rng):
    try:
        return ds.__getitem__(idx, rng=rng)
    except TypeError:
        return ds[idx]


class DataModule:
    def __init__(self, cfg):
        self._cfg = cfg
        self._batch_size = cfg.data.batch_size
        self._n_workers = cfg.location.n_workers
        self._data_modules = {}
        for ds_name, ratio in zip(cfg.data.dataset, cfg.data.ratios):
            if ratio > 0.0:
                ds_cfg = cfg.data.dataset[ds_name]
                dm_class = get_obj_from_str(ds_cfg.file)
                self._data_modules[ds_name] = dm_class(cfg, ds_cfg, ratio)
        self._is_prepared = False

    @property
    def data_modules(self):
        return self._data_modules

    def prepare_data(self):
        """Rank-0-only staging (reference dm.py:36-41); callers gate on process 0."""
        if not self._is_prepared:
            for dm in self._data_modules.values():
                dm.prepare_data()
            self._is_prepared = True

    def setup(self, stage=None):
        for dm in self._data_modules.values():
            dm.setup(stage)

    def _concat(self, attr: str):
        return ConcatDataset([getattr(dm, attr)() for dm in self._data_modules.values()
                              if len(getattr(dm, attr)()) > 0])

    def _loader(self, dataset, *, shuffle: bool, seed: int = 0,
                drop_last: bool = True) -> Loader:
        # multiprocess option (the reference's torch DataLoader workers):
        # worker processes where the JAX package runs grain's (dm.py:80-92)
        cls = WorkerLoader if self._cfg.location.get("loader") == "grain" else Loader
        return cls(dataset, self._batch_size, shuffle=shuffle,
                   num_workers=self._n_workers,
                   prefetch=self._cfg.location.get("prefetch", 2), seed=seed,
                   drop_last=drop_last)

    def train_loader(self, seed: int = 0) -> Loader:
        return self._loader(self._concat("train_dataset"), shuffle=True, seed=seed)

    def val_loader(self) -> Loader:
        return self._loader(self._concat("val_dataset"), shuffle=False,
                            drop_last=False)

    def test_loader(self) -> Loader:
        return self._loader(self._concat("test_dataset"), shuffle=False,
                            drop_last=False)

    def predict_loader(self) -> Loader:
        names = list(self._cfg.data.dataset.keys())
        img_ds = self._data_modules[names[0]].predict_dataset()
        style_ds = self._data_modules[names[1]].predict_dataset()
        return self._loader(PredictDataset(img_ds, style_ds), shuffle=False,
                            drop_last=False)
