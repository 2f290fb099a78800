"""HER2 whole-slide-image data modules and datasets.

Rebuild of the reference HER2 pipeline (reference `data/her2/her2_dm.py`,
`her2_ds.py`, `her2/style_sampler.py`):

* `HER2_DM_Anno.prepare_data` pulls WSIs + polygon annotations from an EXACT
  server, rasterizes ROI segmentations and low-res sampling maps, pickles and zips
  them (her2_dm.py:49-81); `setup` splits val by WSI-number folds and anno/unanno
  by HER2-score bins x12 ROIs (her2_dm.py:114-143),
* `HER2_DS_Anno` builds a **class-balanced spatial sampling index** (BG 0.5 /
  any-tumor 0.5) over the sampling maps, per-slide tissue masks for style
  sampling, and lazily opens one slide per file (her2_ds.py:40-161),
* `HER2_DS_Ordered` tiles ROIs deterministically via PatchHandlerMS and reports
  per-patch ROI border cut margins for metric masking (her2_ds.py:169-236),
* `HER2_DS_UnAnno` samples tissue-masked random patches from unannotated scoring
  slides with seg = -1 (her2_ds.py:239-337).

A copy of stedm_tpu/data/her2.py (the port imports nothing of the JAX package)
with these changes: slides are read through the port's host library
(data/wsi.py), one copy of a slide shared by the loader threads where the
JAX package opens one per thread; a tissue-mask coordinate scales to the
slide by the mask's own step (``wsi.tissue_mask_step``), not by
``kernel_size``, which lands 4x out on an ``ArraySlide`` (ROADMAP §3);
``HER2_DM_Anno.prepare_data`` keeps the staged-zip and staged-directory
branches and refuses the pull from an EXACT server (ROADMAP §1: the pull
from an EXACT server);
``HER2_DM_UnAnno.setup`` reads the scoring list with the ``csv`` module,
selecting the rows pandas' ``read_csv`` gives the JAX package
(``read_score_list``).

ROI tuple format (from `stedm_tpu/data/prep.py` / the reference pickles):
``(file_path, (y_off, x_off), seg_png, sampling_png, [strength_png,] wsi_num)``.
"""

from __future__ import annotations

import csv
import os
import pickle
import shutil
import threading

import numpy as np

from stedm_tpu_torch.data import augment
from stedm_tpu_torch.data.flowers import Flowers_DM_Syn, _one_hot, _stage_dir
from stedm_tpu_torch.data.wsi import (open_slide, sample, tissue_mask, tissue_mask_step,
                                      wsi_sample, wsi_sample_batch)
from stedm_tpu_torch.utils.patch_handler import PatchHandlerMS


# ---- style samplers (reference data/her2/style_sampler.py) --------------------


class NoneSampler:
    def __init__(self, cfg, transforms):
        self._transforms = transforms

    def sample_imgs(self, rng, slide_obj, pos, offset, p_size, b_scale,
                    sample_list, lookup_f):
        out = self._transforms(rng, np.zeros((p_size, p_size, 3), np.uint8))["image"]
        return out[None]


class NearbySampler:
    """Patch at the target position jittered by +-relative_dist * patch extent
    (reference style_sampler.py:16-32)."""

    def __init__(self, cfg, transforms):
        self._transforms = transforms
        self._relative_dist = cfg.relative_dist

    def sample_imgs(self, rng, slide_obj, pos, offset, p_size, b_scale,
                    sample_list, lookup_f):
        y_c = pos[0] + self._relative_dist * int(rng.integers(-p_size * b_scale,
                                                              p_size * b_scale))
        x_c = pos[1] + self._relative_dist * int(rng.integers(-p_size * b_scale,
                                                              p_size * b_scale))
        crop = wsi_sample(slide_obj, offset, p_size, b_scale, (y_c, x_c))
        return self._transforms(rng, crop)["image"][None]


class MultiPatchSampler:
    """num_patches random tissue-mask patches from the same slide
    (reference style_sampler.py:35-59)."""

    def __init__(self, cfg, transforms):
        self._transforms = transforms
        self._num_patches = cfg.num_patches

    def sample_imgs(self, rng, slide_obj, pos, offset, p_size, b_scale,
                    sample_list, lookup_f):
        positions = []
        for _ in range(self._num_patches):
            coords = sample_list[int(rng.integers(0, len(sample_list)))]
            positions.append((int(coords[0] * lookup_f + 0.5 * lookup_f),
                              int(coords[1] * lookup_f + 0.5 * lookup_f)))
        # one batched read: the whole set runs on the native async pool when
        # available (data/native_pipeline.py), else an equivalent python loop
        crops = wsi_sample_batch(slide_obj, (0, 0), p_size, b_scale, positions)
        return np.stack([self._transforms(rng, crop)["image"] for crop in crops],
                        axis=0)


_SAMPLERS = {"NoneSampler": NoneSampler, "NearbySampler": NearbySampler,
             "MultiPatchSampler": MultiPatchSampler}


class _SlideCache:
    """One lazily opened slide per key, shared by every loader thread. An
    ``ArraySlide`` is a read-only pyramid, so one copy serves all threads and
    its levels are registered once with the host library's pool, whose
    registrations live as long as the process. (The reference keeps one
    OpenSlide handle per worker, her2_ds.py:135-138, as those cannot be
    shared.)"""

    def __init__(self):
        self._slides: dict = {}
        self._mu = threading.Lock()

    # a worker process of the multiprocess loader (data/worker_loader.py)
    # gets an empty cache and opens its slides itself, lazily (her2.py:97-110)
    def __getstate__(self):
        return {}

    def __setstate__(self, state):
        self.__init__()

    def get(self, key, path):
        with self._mu:
            entry = self._slides.setdefault(key, [threading.Lock(), None])
        with entry[0]:      # one open per slide; other slides open meanwhile
            if entry[1] is None:
                entry[1] = open_slide(path)
        return entry[1]


# ---- datasets ------------------------------------------------------------------


class HER2_DS_Anno:
    """(reference her2_ds.py:21-161)"""

    def __init__(self, img_l, samples, patch_size, base_scale, overlap, lookup_f,
                 num_classes, style_sampler, style_drop_rate, transforms,
                 rois_per_slide: int = 12):
        self._img_l = img_l
        self._samples = samples
        self._patch_size = patch_size
        self._base_scale = base_scale
        self._lookup_f = lookup_f
        self._num_classes = num_classes
        self._style_sampler = style_sampler
        self._style_drop_rate = style_drop_rate
        self._transforms = transforms
        self._rois_per_slide = rois_per_slide
        self._slides = _SlideCache()
        self.kernel_size = (patch_size - 2 * overlap) * base_scale

        import cv2

        wsi_nums = np.unique(np.array([el[-1] for el in img_l])) if img_l else []
        wsi_idx = {num: i for i, num in enumerate(wsi_nums)}

        # class-balanced spatial sampling index over the sampling maps
        per_class = [[[] for _ in wsi_nums] for _ in range(num_classes)]
        p_h = int(((patch_size / 2) * base_scale) / lookup_f)
        for img_num, img_tup in enumerate(img_l):
            smap = cv2.imdecode(img_tup[3], cv2.IMREAD_ANYDEPTH)
            for cls in range(num_classes):
                mask = smap[p_h:-p_h, p_h:-p_h] == cls
                coords = np.argwhere(mask) + p_h
                coords = np.concatenate(
                    [coords, np.full((len(coords), 1), img_num, coords.dtype)], axis=1)
                per_class[cls][wsi_idx[img_tup[-1]]].append(coords)
        for cls in range(num_classes):
            for j in range(len(wsi_nums)):
                per_class[cls][j] = np.concatenate(per_class[cls][j], axis=0) \
                    if per_class[cls][j] else np.zeros((0, 3), np.int64)

        # merge all tumor classes; P = [0.5 BG, 0.5 tumor] (her2_ds.py:65-84)
        tumor = []
        for j in range(len(wsi_nums)):
            tumor.append(np.concatenate([per_class[c][j]
                                         for c in range(1, num_classes)], axis=0))
        bg = [c for c in per_class[0]]
        self._global_sample_list = [
            [c for c in bg if len(c)], [c for c in tumor if len(c)]]
        self._probs = np.array([0.5, 0.5])

        # tissue-mask style sampling coordinates per unique slide file
        self.style_samp_list, self.style_steps = [], []
        files = np.unique([el[0] for el in img_l])[::-1] if img_l else []
        for idx, file_name in enumerate(files):
            slide = open_slide(str(file_name))
            mask = tissue_mask(slide, self.kernel_size)
            coords = np.argwhere(mask)
            coords = np.concatenate(
                [coords, np.full((len(coords), 1), idx, coords.dtype)], axis=1)
            self.style_samp_list.append(coords)
            self.style_steps.append(tissue_mask_step(slide, self.kernel_size))
            slide.close()

    def __len__(self):
        return self._samples if len(self._img_l) > 0 else 0

    def __getitem__(self, idx, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        cls = int(rng.choice(len(self._probs), p=self._probs))
        class_list = self._global_sample_list[cls]
        instance_list = class_list[int(rng.integers(0, len(class_list)))]
        coords = instance_list[int(rng.integers(0, len(instance_list)))]

        img_num = int(coords[2])
        img_p = self._img_l[img_num]
        slide = self._slides.get(img_p[-1], img_p[0])

        y_c = int(coords[0] * self._lookup_f + 0.5 * self._lookup_f)
        x_c = int(coords[1] * self._lookup_f + 0.5 * self._lookup_f)

        img, seg = sample(slide, img_p[1], img_p[2], self._patch_size,
                          self._base_scale, (y_c, x_c), self._transforms, rng)
        seg = seg.astype(np.int32)

        style_img_num = min(int(img_num / self._rois_per_slide),
                            len(self.style_samp_list) - 1)
        style = self._style_sampler.sample_imgs(
            rng, slide, (y_c, x_c), img_p[1], self._patch_size, self._base_scale,
            self.style_samp_list[style_img_num], self.style_steps[style_img_num])

        one_hot = _one_hot(seg, self._num_classes)
        if rng.uniform() < self._style_drop_rate:
            style = np.zeros_like(style) - 0.5
        return (img * 2 - 1).astype(np.float32), one_hot, seg, \
            (style * 2 - 1).astype(np.float32)


class HER2_DS_Predict(HER2_DS_Anno):
    def __getitem__(self, idx, rng=None):
        return (*super().__getitem__(idx, rng=rng), idx)


class HER2_DS_Ordered:
    """Deterministic ROI tiling for val/test (reference her2_ds.py:169-236)."""

    def __init__(self, img_l, patch_size, base_scale, overlap, num_classes,
                 transforms):
        import cv2

        self._img_l = img_l
        self._patch_size = patch_size
        self._base_scale = base_scale
        self._overlap = overlap
        self._num_classes = num_classes
        self._transforms = transforms
        self._slides = _SlideCache()

        ref = cv2.imdecode(img_l[0][2], cv2.IMREAD_ANYDEPTH) if img_l \
            else np.zeros((0, 0))
        self._patcher = PatchHandlerMS(ref.shape, int(patch_size * base_scale),
                                       int(overlap * base_scale))
        self._img_p_num = self._patcher.num_segs()
        unique = np.unique(np.array([t[-1] for t in img_l])) if img_l else []
        self.wsi_lookup = {num: i for i, num in enumerate(unique)}

    def __len__(self):
        return self._img_p_num * len(self._img_l)

    def __getitem__(self, idx, rng: np.random.Generator | None = None):
        import cv2

        rng = rng or np.random.default_rng(idx)
        img_num = int(idx / self._img_p_num)
        p_num = idx % self._img_p_num
        img_p = self._img_l[img_num]
        slide = self._slides.get(img_p[-1], img_p[0])

        seg_full = cv2.imdecode(img_p[2], cv2.IMREAD_ANYDEPTH)
        seg_crop = self._patcher.get(seg_full, p_num, 1)

        kernel = (self._patch_size - 2 * self._overlap) * self._base_scale
        j = int(p_num / self._patcher._x_p)
        i = int(p_num % self._patcher._x_p)
        x_c = int(i * kernel + 0.5 * kernel)
        y_c = int(j * kernel + 0.5 * kernel)

        cut_x = cut_y = 0
        if (x_c + 0.5 * kernel) >= seg_full.shape[1]:
            cut_x = int(((x_c + 0.5 * kernel) - seg_full.shape[1]) / self._base_scale)
        if (y_c + 0.5 * kernel) >= seg_full.shape[0]:
            cut_y = int(((y_c + 0.5 * kernel) - seg_full.shape[0]) / self._base_scale)

        img_crop = wsi_sample(slide, img_p[1], self._patch_size, self._base_scale,
                              (y_c, x_c))
        applied = self._transforms(rng, img_crop, seg_crop)
        img, seg = applied["image"], applied["mask"].astype(np.int32)
        one_hot = _one_hot(seg, self._num_classes)
        return (img * 2 - 1).astype(np.float32), one_hot, seg, (cut_y, cut_x), \
            self.wsi_lookup[img_p[-1]]


class HER2_DS_UnAnno:
    """Tissue-masked random patches from unannotated scoring slides; seg = -1
    (reference her2_ds.py:239-337)."""

    def __init__(self, wsi_rows, samples, patch_size, base_scale, overlap,
                 num_classes, style_sampler, transforms):
        self._samples = samples
        self._patch_size = patch_size
        self._base_scale = base_scale
        self._num_classes = num_classes
        self._style_sampler = style_sampler
        self._transforms = transforms
        self.kernel_size = (patch_size - 2 * overlap) * base_scale
        self._slides = _SlideCache()

        self._sample_list = []
        self._mask_steps = []
        self._ds_list = []
        self.slide_info = []
        for idx, row in enumerate(wsi_rows):
            slide = open_slide(row["File Path"])
            mask = tissue_mask(slide, self.kernel_size)
            coords = np.argwhere(mask)
            coords = np.concatenate(
                [coords, np.full((len(coords), 1), idx, coords.dtype)], axis=1)
            self._sample_list.append(coords)
            self._mask_steps.append(tissue_mask_step(slide, self.kernel_size))
            dim = (int(slide.dimensions[1] / base_scale),
                   int(slide.dimensions[0] / base_scale))
            self._ds_list.append((row["File Path"], dim,
                                  (mask.shape[1], mask.shape[0]),
                                  row.get("HER2 Score"), row.get("Slide ID")))
            self.slide_info.append((str(row.get("Slide ID")), dim, mask.shape[1],
                                    mask.shape[0], row.get("HER2 Score")))
            slide.close()

    def __len__(self):
        return self._samples if len(self._sample_list) > 0 else 0

    def __getitem__(self, idx, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        inst = int(rng.integers(0, len(self._sample_list)))
        instance_list = self._sample_list[inst]
        coords = instance_list[int(rng.integers(0, len(instance_list)))]

        img_p = self._ds_list[int(coords[2])]
        slide = self._slides.get(img_p[4], img_p[0])

        step = self._mask_steps[int(coords[2])]
        y_c = (coords[0] + 0.5) * step
        x_c = (coords[1] + 0.5) * step
        crop = wsi_sample(slide, (0, 0), self._patch_size, self._base_scale,
                          (y_c, x_c))
        img = self._transforms(rng, crop)["image"]
        seg = np.full((self._patch_size, self._patch_size), -1, np.int32)
        style = self._style_sampler.sample_imgs(
            rng, slide, (y_c, x_c), (0, 0), self._patch_size, self._base_scale,
            instance_list, step)
        one_hot = np.zeros((self._patch_size, self._patch_size, self._num_classes),
                           np.float32)
        return (img * 2 - 1).astype(np.float32), one_hot, seg, \
            (style * 2 - 1).astype(np.float32), inst


# syn datasets share the flowers implementations (identical logic,
# reference her2_ds.py:340-393)
from stedm_tpu_torch.data.flowers import (  # noqa: E402
    Flowers_DS_Syn as HER2_DS_Syn,
    Flowers_DS_Syn_Ordered as HER2_DS_Syn_Ordered,
)


# ---- data modules ----------------------------------------------------------------


class HER2_DM_Anno:
    """(reference her2_dm.py:22-196)"""

    def __init__(self, cfg, ds_cfg, ratio, **kwargs):
        self._cfg = cfg
        self._ds_cfg = ds_cfg
        self._data_dir = cfg.location.data_dir
        self._base_scale = cfg.data.base_scale
        self._patch_size = cfg.data.patch_size
        self._overlap = cfg.data.overlap_val
        self._num_classes = cfg.data.num_classes
        self._samples = int(cfg.data.samples * ratio)
        self._lookup_f = cfg.data.lookup_f
        self._zip_name = (f"{ds_cfg.name}_{ds_cfg.annotator.name}"
                          if ds_cfg.get("annotator") else ds_cfg.name)

    def prepare_data(self):
        """Zip a staged tree (her2_dm.py:49-81). Pulling the slides and
        polygons from an EXACT server when neither the zip nor the tree is
        staged is not ported (ROADMAP §1: the pull from an EXACT server)."""
        base_dir = f"{self._data_dir}/{self._zip_name}"
        zip_file = f"{base_dir}.zip"
        if not self._cfg.data.reload_data and os.path.isfile(zip_file):
            return
        if os.path.isdir(base_dir) and os.path.isfile(f"{base_dir}/train_val.pkl"):
            shutil.make_archive(zip_file[:-4], "zip", base_dir)
            return
        raise NotImplementedError(
            f"{base_dir}: no staged tree or zip, and the pull from an EXACT server "
            "(utils/exact.py) is not ported (ROADMAP §1: the pull from an EXACT server)")

    def setup(self, stage=None):
        base_dir = _stage_dir(self._data_dir, self._zip_name)

        with open(f"{base_dir}/train_val.pkl", "rb") as f:
            list_train_val = pickle.load(f)
        self._list_train, self._list_val = [], []
        if self._ds_cfg.get("folds"):
            val_nums = set(self._ds_cfg.folds[0])
            for el in list_train_val:
                (self._list_val if el[-1] in val_nums else self._list_train).append(el)
        else:
            self._list_train = list_train_val
        fix = lambda lst: [(f"{base_dir}/wsi/{el[0]}", *el[1:]) for el in lst]
        self._list_train, self._list_val = fix(self._list_train), fix(self._list_val)
        with open(f"{base_dir}/test.pkl", "rb") as f:
            self._list_test = fix(pickle.load(f))

        # anno/unanno split by HER2-score class bins x rois-per-slide
        # (her2_dm.py:133-143)
        score_dict = {int(k): v for k, v in dict(self._ds_cfg.score_dict).items()} \
            if self._ds_cfg.get("score_dict") else {}
        n_bins = (max(score_dict.values()) + 1) if score_dict else 1
        class_lists = [[] for _ in range(n_bins)]
        for el in self._list_train:
            class_lists[score_dict.get(int(el[-1]), 0)].append(el)
        n = self._cfg.data.class_train_samples * 12
        self._list_train, self._list_unanno = [], []
        for class_list in class_lists:
            self._list_train.extend(class_list[:n])
            self._list_unanno.extend(class_list[n:])

        p = self._patch_size
        sampler_cls = _SAMPLERS[self._cfg.style_sampling.class_name]
        sampler = sampler_cls(self._cfg.style_sampling, augment.base_transforms(p))
        sampler_pred = sampler_cls(self._cfg.style_sampling,
                                   augment.style_transforms(p))
        drop = self._cfg.get("style_drop_rate", 0.0)

        args = (self._patch_size, self._base_scale, self._overlap, self._lookup_f,
                self._num_classes)
        self._ds_train = HER2_DS_Anno(self._list_train, self._samples, *args,
                                      sampler, drop, augment.base_transforms(p))
        self._ds_val = HER2_DS_Ordered(self._list_val, self._patch_size,
                                       self._base_scale, self._overlap,
                                       self._num_classes, augment.eval_transforms(p))
        self._ds_test = HER2_DS_Ordered(self._list_test, self._patch_size,
                                        self._base_scale, self._overlap,
                                        self._num_classes, augment.eval_transforms(p))
        self._ds_predict = HER2_DS_Predict(self._list_train, self._samples, *args,
                                           sampler_pred, 0.0,
                                           augment.style_transforms(p))

    def train_dataset(self):
        return self._ds_train

    def val_dataset(self):
        return self._ds_val

    def test_dataset(self):
        return self._ds_test

    def predict_dataset(self):
        return self._ds_predict


# the cells pandas' read_csv reads as NaN by default (its na_values)
_NA = frozenset(["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                 "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                 "nan", "null"])


def read_score_list(list_file: str, data_dir: str) -> list[dict]:
    """The scored slides of ``all_wsi_scores.csv`` (``;``-separated) that are
    not marked for exclusion and lie in ``data_dir`` (her2_dm.py:254-266): the
    rows the JAX package selects from pandas' frame, where a missing cell is
    NaN (``str(x) == "nan"``), a missing ``USE`` column excludes every row
    and a score such as ``2+`` reads as its first digit."""
    wsi_rows = []
    with open(list_file, newline="") as f:
        for row in csv.DictReader(f, delimiter=";"):
            use = row.get("USE")
            if row["HERIHCScore"] not in _NA and use is not None and use in _NA:
                file_path = f"{data_dir}/{row['Tumorblock_ID']}_HER2_IHC.svs"
                if os.path.isfile(file_path):
                    wsi_rows.append({"File Path": file_path,
                                     "HER2 Score": int(row["HERIHCScore"][0]),
                                     "Slide ID": row["Tumorblock_ID"]})
    return wsi_rows


class HER2_DM_UnAnno:
    """Scoring-slide style source (reference her2_dm.py:196-307)."""

    def __init__(self, cfg, ds_cfg, ratio, **kwargs):
        self._cfg = cfg
        self._ds_cfg = ds_cfg
        self._data_dir = cfg.location.data_dir
        self._base_scale = cfg.data.base_scale
        self._patch_size = cfg.data.patch_size
        self._overlap = cfg.data.overlap_val
        self._num_classes = cfg.data.num_classes
        self._samples = int(cfg.data.samples * ratio)
        self._zip_file_name = ds_cfg.zip_file_name
        self._list_file_name = ds_cfg.list_file_name

    def prepare_data(self):
        zip_file = f"{self._data_dir}/{self._zip_file_name}"
        target = f"{self._data_dir}/{self._zip_file_name[:-4]}"
        if not os.path.isdir(target) and os.path.isfile(zip_file):
            shutil.unpack_archive(zip_file, target)

    def setup(self, stage=None):
        data_dir = f"{self._data_dir}/{self._zip_file_name[:-4]}"
        wsi_rows = read_score_list(f"{self._data_dir}/{self._list_file_name}", data_dir)

        p = self._patch_size
        sampler_cls = _SAMPLERS[self._cfg.style_sampling.class_name]
        sampler = sampler_cls(self._cfg.style_sampling, augment.style_transforms(p))
        self._ds_train = []
        self._ds_val = []
        self._ds_test = []
        self._ds_predict = HER2_DS_UnAnno(wsi_rows, self._samples, self._patch_size,
                                          self._base_scale, self._overlap,
                                          self._num_classes, sampler,
                                          augment.style_transforms(p))

    def train_dataset(self):
        return self._ds_train

    def val_dataset(self):
        return self._ds_val

    def test_dataset(self):
        return self._ds_test

    def predict_dataset(self):
        return self._ds_predict


class HER2_DM_Syn:
    """Generated img/seg pairs (reference her2_dm.py:310-409) — shares the flowers
    syn module logic."""

    def __init__(self, cfg, ds_cfg, ratio, **kwargs):
        self._impl = Flowers_DM_Syn(cfg, ds_cfg, ratio, **kwargs)

    def prepare_data(self):
        self._impl.prepare_data()

    def setup(self, stage=None):
        self._impl.setup(stage)

    def train_dataset(self):
        return self._impl.train_dataset()

    def val_dataset(self):
        return self._impl.val_dataset()

    def test_dataset(self):
        return self._impl.test_dataset()

    def predict_dataset(self):
        return self._impl.predict_dataset()
