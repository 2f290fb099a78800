"""Oxford Flowers-102 data modules and datasets.

A copy of stedm_tpu/data/flowers.py (the port imports nothing of the JAX
package): JPEGs read with PIL, transformed with cv2, as there.

Rebuild of the reference's flowers pipeline (reference
`data/flowers/flowers_dm.py`, `flowers_ds.py`, `flowers/style_sampler.py`):

* `Flowers_DM_Anno`: reads ``imagelabels.mat``/``setid.mat`` splits; within each
  *annotated* train class the first ``class_train_samples`` images are annotated,
  the rest plus all held-out classes are style-only (flowers_dm.py:106-113),
* segmentations come from the blue-background heuristic on ``segmim_*.jpg``
  (flowers_ds.py:49),
* epochs are sampling budgets: ``len(dataset) == samples``, every item draws a
  random image (flowers_ds.py:30-43),
* style images are produced by a sampler (none / augmented) through the heavy
  affine augmentation, and are randomly dropped to the constant -2 (post range
  shift) with ``style_drop_rate`` (flowers_ds.py:62-66).

Arrays are channels-last numpy: img [P,P,3] in [-1,1], one_hot [P,P,C], seg [P,P]
int32, style [N,P,P,3].
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np
from PIL import Image

from stedm_tpu_torch.data import augment


def _one_hot(seg: np.ndarray, num_classes: int) -> np.ndarray:
    return np.eye(num_classes, dtype=np.float32)[seg]


def _load_flower_seg(path: str) -> np.ndarray:
    """Blue-screen heuristic: background is (R<=10, G<=10, B>=220)
    (reference flowers_ds.py:49)."""
    seg = np.array(Image.open(path))
    bg = (seg[:, :, 0] <= 10) & (seg[:, :, 1] <= 10) & (seg[:, :, 2] >= 220)
    return (1 - bg).astype(np.uint8)


# ---- style samplers (reference data/flowers/style_sampler.py) ----------------


class NoneSampler:
    def __init__(self, cfg, transforms):
        self._transforms = transforms

    def sample_imgs(self, rng, img):
        out = self._transforms(rng, np.zeros_like(img))["image"]
        return out[None]


class AugmentedSampler:
    """The same image re-augmented (scale/rotate/shear) as the style source."""

    def __init__(self, cfg, transforms):
        self._transforms = transforms

    def sample_imgs(self, rng, img):
        return self._transforms(rng, img)["image"][None]


# ---- datasets ----------------------------------------------------------------


class Flowers_DS:
    """Random-sampling training dataset (reference flowers_ds.py:9-66)."""

    def __init__(self, img_l, samples, num_classes, base_transforms, style_sampler,
                 style_drop_rate):
        self._img_l = img_l
        self._samples = samples
        self._num_classes = num_classes
        self._base_transforms = base_transforms
        self._style_sampler = style_sampler
        self._style_drop_rate = style_drop_rate

    def __len__(self):
        return self._samples if len(self._img_l) > 0 else 0

    def __getitem__(self, idx, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        img_tup = self._img_l[int(rng.integers(0, len(self._img_l)))]
        img_raw = np.array(Image.open(img_tup[0]).convert("RGB"))
        seg_raw = _load_flower_seg(img_tup[1])

        applied = self._base_transforms(rng, img_raw, seg_raw)
        img, seg = applied["image"], applied["mask"].astype(np.int32)
        one_hot = _one_hot(seg, self._num_classes)

        style = self._style_sampler.sample_imgs(rng, img_raw)
        if rng.uniform() < self._style_drop_rate:
            style = np.zeros_like(style) - 0.5

        return (img * 2 - 1).astype(np.float32), one_hot, seg, \
            (style * 2 - 1).astype(np.float32)


class Flowers_DS_Predict(Flowers_DS):
    def __getitem__(self, idx, rng=None):
        return (*super().__getitem__(idx, rng=rng), idx)


class Flowers_DS_Ordered:
    """Deterministic val/test dataset (reference flowers_ds.py:74-110)."""

    def __init__(self, img_l, num_classes, transforms):
        self._img_l = img_l
        self._num_classes = num_classes
        self._transforms = transforms
        unique = np.unique(np.array([t[-1] for t in img_l])) if img_l else []
        self.wsi_lookup = {wsi: i for i, wsi in enumerate(unique)}

    def __len__(self):
        return len(self._img_l)

    def __getitem__(self, idx, rng=None):
        rng = rng or np.random.default_rng(idx)
        img_tup = self._img_l[idx]
        img_raw = np.array(Image.open(img_tup[0]).convert("RGB"))
        seg_raw = _load_flower_seg(img_tup[1])
        applied = self._transforms(rng, img_raw, seg_raw)
        img, seg = applied["image"], applied["mask"].astype(np.int32)
        one_hot = _one_hot(seg, self._num_classes)
        return (img * 2 - 1).astype(np.float32), one_hot, seg, (0, 0), \
            self.wsi_lookup[img_tup[-1]]


class Flowers_DS_Syn:
    """Random-sampling dataset over generated img/seg PNG pairs
    (reference flowers_ds.py:113-141)."""

    def __init__(self, img_l, samples, num_classes, transforms):
        self._img_l = img_l
        self._samples = samples
        self._num_classes = num_classes
        self._transforms = transforms

    def __len__(self):
        return self._samples if len(self._img_l) > 0 else 0

    def __getitem__(self, idx, rng=None):
        rng = rng or np.random.default_rng()
        img_tup = self._img_l[int(rng.integers(0, len(self._img_l)))]
        img = np.array(Image.open(img_tup[0]).convert("RGB"))
        seg = np.array(Image.open(img_tup[1]).convert("L"))
        applied = self._transforms(rng, img, seg)
        img, seg = applied["image"], applied["mask"].astype(np.int32)
        one_hot = _one_hot(seg, self._num_classes)
        p = img.shape[0]
        style = np.zeros((1, p, p, 3), dtype=np.float32)
        return (img * 2 - 1).astype(np.float32), one_hot, seg, style


class Flowers_DS_Syn_Ordered:
    def __init__(self, img_l, num_classes, transforms):
        self._img_l = img_l
        self._num_classes = num_classes
        self._transforms = transforms

    def __len__(self):
        return len(self._img_l)

    def __getitem__(self, idx, rng=None):
        rng = rng or np.random.default_rng(idx)
        img_tup = self._img_l[idx]
        img = np.array(Image.open(img_tup[0]).convert("RGB"))
        seg = np.array(Image.open(img_tup[1]).convert("L"))
        applied = self._transforms(rng, img, seg)
        img, seg = applied["image"], applied["mask"].astype(np.int32)
        one_hot = _one_hot(seg, self._num_classes)
        return (img * 2 - 1).astype(np.float32), one_hot, seg, (0, 0), idx


# ---- data modules --------------------------------------------------------------

_SAMPLERS = {"NoneSampler": NoneSampler, "AugmentedSampler": AugmentedSampler}


def _stage_dir(data_dir: str, zip_name: str) -> str:
    """Zip staging (reference flowers_dm.py:43-68): scratch-local unpack when a
    STEDM_SCRATCH dir is set (the SLURM /scratch pattern), plain dir otherwise."""
    scratch = os.environ.get("STEDM_SCRATCH")
    base_dir = f"{data_dir}/{zip_name}"
    zip_file = f"{base_dir}.zip"
    if scratch:
        local = Path(scratch) / zip_name
        if not local.is_dir():
            local.parent.mkdir(parents=True, exist_ok=True)
            shutil.unpack_archive(zip_file, local)
        return str(local)
    if not os.path.isdir(base_dir) and os.path.isfile(zip_file):
        shutil.unpack_archive(zip_file, base_dir)
    return base_dir


class Flowers_DM_Anno:
    """(reference flowers_dm.py:21-163)"""

    ds_cls = Flowers_DS

    def __init__(self, cfg, ds_cfg, ratio, **kwargs):
        self._cfg = cfg
        self._ds_cfg = ds_cfg
        self._data_dir = cfg.location.data_dir
        self._patch_size = cfg.data.patch_size
        self._num_classes = cfg.data.num_classes
        self._samples = int(cfg.data.samples * ratio)
        self._zip_name = ds_cfg.zip_name

    def prepare_data(self):
        base_dir = f"{self._data_dir}/{self._zip_name}"
        zip_file = f"{base_dir}.zip"
        if self._cfg.data.reload_data or (not os.path.isfile(zip_file)
                                          and os.path.isdir(base_dir)):
            shutil.make_archive(zip_file[:-4], "zip", base_dir)

    def _load_splits(self, base_dir: str):
        import scipy.io

        labels = scipy.io.loadmat(base_dir + "/imagelabels.mat")["labels"][0]
        splits = scipy.io.loadmat(base_dir + "/setid.mat")
        train_idx = set(splits["trnid"][0].tolist())
        val_idx = set(splits["valid"][0].tolist())
        test_idx = set(splits["tstid"][0].tolist())

        list_val, list_test = [], []
        label_bins = [[] for _ in range(102)]
        for i, label in enumerate(labels):
            el = (f"{base_dir}/imgs/image_{str(i + 1).zfill(5)}.jpg",
                  f"{base_dir}/segs/segmim_{str(i + 1).zfill(5)}.jpg",
                  int(label) - 1, i + 1)
            if (i + 1) in train_idx:
                label_bins[int(label) - 1].append(el)
            elif (i + 1) in val_idx:
                list_val.append(el)
            elif (i + 1) in test_idx:
                list_test.append(el)
            else:
                raise RuntimeError("Element could not be assigned to train/val/test!")
        return label_bins, list_val, list_test

    def setup(self, stage=None):
        base_dir = _stage_dir(self._data_dir, self._zip_name)
        label_bins, self._list_val, self._list_test = self._load_splits(base_dir)

        n_anno = self._cfg.data.class_train_samples
        self._list_train, self._list_unanno = [], []
        for label, bin_list in enumerate(label_bins):
            if label in self._ds_cfg.train_classes:
                self._list_train.extend(bin_list[:n_anno])
                self._list_unanno.extend(bin_list[n_anno:])
            elif label in self._ds_cfg.unanno_classes:
                self._list_unanno.extend(bin_list)
            else:
                raise RuntimeError(f"Class {label} not assigned!")

        p = self._patch_size
        sampler_cls = _SAMPLERS[self._cfg.style_sampling.class_name]
        sampler = sampler_cls(self._cfg.style_sampling, augment.style_transforms(p))
        drop = self._cfg.get("style_drop_rate", 0.0)

        self._ds_train = Flowers_DS(self._list_train, self._samples,
                                    self._num_classes, augment.base_transforms(p),
                                    sampler, drop)
        self._ds_val = Flowers_DS_Ordered(self._list_val, self._num_classes,
                                          augment.eval_transforms(p))
        self._ds_test = Flowers_DS_Ordered(self._list_test, self._num_classes,
                                           augment.eval_transforms(p))
        self._ds_predict = Flowers_DS_Predict(self._list_train, self._samples,
                                              self._num_classes,
                                              augment.base_transforms(p), sampler, 0.0)

    def train_dataset(self):
        return self._ds_train

    def val_dataset(self):
        return self._ds_val

    def test_dataset(self):
        return self._ds_test

    def predict_dataset(self):
        return self._ds_predict


class Flowers_DM_UnAnno(Flowers_DM_Anno):
    """Style source for zero-shot transfer: only a predict dataset over the
    *unannotated* pool (reference flowers_dm.py:166-227)."""

    def setup(self, stage=None):
        base_dir = _stage_dir(self._data_dir, self._zip_name)
        label_bins, self._list_val, self._list_test = self._load_splits(base_dir)

        n_anno = self._cfg.data.class_train_samples
        self._list_train, self._list_unanno = [], []
        # reference quirk (flowers_dm.py:201-208): the unanno module bins by the
        # first-20/rest class split rather than the configured class lists
        for bin_list in label_bins[:20]:
            self._list_train.extend(bin_list[:n_anno])
            self._list_unanno.extend(bin_list[n_anno:])
        for bin_list in label_bins[20:]:
            self._list_unanno.extend(bin_list)

        p = self._patch_size
        sampler_cls = _SAMPLERS[self._cfg.style_sampling.class_name]
        sampler = sampler_cls(self._cfg.style_sampling, augment.style_transforms(p))
        self._ds_train = []
        self._ds_val = []
        self._ds_test = []
        self._ds_predict = Flowers_DS(self._list_train, self._samples,
                                      self._num_classes, augment.base_transforms(p),
                                      sampler, 0.0)

    def train_dataset(self):
        return self._ds_train

    def val_dataset(self):
        return self._ds_val

    def test_dataset(self):
        return self._ds_test

    def predict_dataset(self):
        return self._ds_predict


class Flowers_DM_Syn:
    """Generated img/seg pairs written by predict_diff
    (reference flowers_dm.py:230-328)."""

    def __init__(self, cfg, ds_cfg, ratio, **kwargs):
        self._cfg = cfg
        self._data_dir = cfg.location.data_dir
        self._patch_size = cfg.data.patch_size
        self._num_classes = cfg.data.num_classes
        self._samples = int(cfg.data.samples * ratio)
        self._folder_name = ds_cfg.folder_name

    def prepare_data(self):
        pass

    def setup(self, stage=None):
        scratch = os.environ.get("STEDM_SCRATCH")
        base_dir = (f"{scratch}/{self._folder_name}" if scratch
                    else f"{self._data_dir}/syn_data/{self._folder_name}")
        num = len(os.listdir(base_dir)) // 2
        self._list_train = [(f"{base_dir}/img_{str(i).zfill(5)}.png",
                             f"{base_dir}/seg_{str(i).zfill(5)}.png")
                            for i in range(num)]
        p = self._patch_size
        self._ds_train = Flowers_DS_Syn(self._list_train, self._samples,
                                        self._num_classes, augment.base_transforms(p))
        self._ds_ordered = Flowers_DS_Syn_Ordered(self._list_train, self._num_classes,
                                                  augment.eval_transforms(p))
        self._ds_val = []
        self._ds_test = []
        self._ds_predict = []

    def train_dataset(self):
        return self._ds_train

    def val_dataset(self):
        return self._ds_val

    def test_dataset(self):
        return self._ds_test

    def predict_dataset(self):
        return self._ds_predict
