"""CATCH whole-slide-image data modules and datasets.

Rebuild of the reference CATCH pipeline (reference `data/catch/catch_dm.py`,
`catch_ds.py`, `catch_utils.py`, `catch/style_sampler.py`) — the HER2 pattern at
``base_scale 8`` / ``lookup_f 128`` with 8 classes, and WSI-sized segmentations too
large for PNG: they are rasterized chunk-wise (16384^2) into gzip'd HDF5 datasets
with 512^2 chunks (catch_utils.py:61-111) and read back as direct h5 crops
(catch_ds.py:135-146). Sampling draws BG / any-tumor / true-white-background with
probs (0.4, 0.5, 0.1) (catch_ds.py:73-83); the CATCH MultiPatch sampler adds
+-lookup_f coordinate jitter (catch/style_sampler.py:48-50).

A copy of stedm_tpu/data/catch.py (the port imports nothing of the JAX package)
with three changes: slides are read through the port's host library
(data/wsi.py), one copy shared by the loader threads; a tissue-mask
coordinate scales by the mask's own step, as in data/her2.py; and
``CATCH_DM_Anno.prepare_data`` keeps the staged-zip and
staged-directory branches and refuses the pull from an EXACT server (ROADMAP
§1: the pull from an EXACT server), the one place the JAX package reads the ``split_file`` (with
pandas).

WSI tuple format: ``(file_path, (min_y, min_x), sampling_png, wsi_num)``; the
segmentation lives in ``anno.hdf5[str(wsi_num)]``.
"""

from __future__ import annotations

import math
import os
import pickle
import shutil
import threading

import numpy as np

from stedm_tpu_torch.data import augment
from stedm_tpu_torch.data.flowers import Flowers_DM_Syn, _one_hot, _stage_dir
from stedm_tpu_torch.data.her2 import NearbySampler, NoneSampler, _SlideCache
from stedm_tpu_torch.data.wsi import (block_reduce_median, open_slide, tissue_mask,
                                      tissue_mask_step, wsi_sample, wsi_sample_batch)


class MultiPatchSampler:
    """Like HER2's but with +-lookup_f jitter (reference catch/style_sampler.py:35-59)."""

    def __init__(self, cfg, transforms):
        self._transforms = transforms
        self._num_patches = cfg.num_patches

    def sample_imgs(self, rng, slide_obj, pos, offset, p_size, b_scale,
                    sample_list, lookup_f):
        positions = []
        for _ in range(self._num_patches):
            coords = sample_list[int(rng.integers(0, len(sample_list)))]
            positions.append(
                (int(coords[0] * lookup_f + 0.5 * lookup_f)
                 + int(rng.integers(-lookup_f, lookup_f)),
                 int(coords[1] * lookup_f + 0.5 * lookup_f)
                 + int(rng.integers(-lookup_f, lookup_f))))
        # batched read on the native async pool when available
        crops = wsi_sample_batch(slide_obj, (0, 0), p_size, b_scale, positions)
        return np.stack([self._transforms(rng, crop)["image"] for crop in crops],
                        axis=0)


_SAMPLERS = {"NoneSampler": NoneSampler, "NearbySampler": NearbySampler,
             "MultiPatchSampler": MultiPatchSampler}


def h5_sample(slide_obj, anno_dset, offset, p_size, b_scale, pos, trans, rng):
    """Aligned (image, h5-seg) patch pair (reference catch_utils.py:123-134)."""
    p_h = int((p_size / 2) * b_scale)
    seg_crop = anno_dset[pos[0] - p_h:pos[0] + p_h, pos[1] - p_h:pos[1] + p_h]
    img_crop = wsi_sample(slide_obj, offset, p_size, b_scale, pos)
    applied = trans(rng, img_crop, np.asarray(seg_crop))
    return applied["image"], applied["mask"]


def rasterize_wsi_chunked(conts, anno_file, dset_name: str, look_f: int,
                          chunk_size: int = 16384) -> tuple:
    """Chunked rasterization of a full WSI's annotations into HDF5 + a low-res
    sampling map (reference catch_utils.py:45-115). ``conts``: list of
    (polygon Nx2, value) sorted large-first. Returns ((min_y, min_x), samp_png)."""
    import cv2

    mins = np.min([np.amin(c[0], axis=0) for c in conts], axis=0)
    maxs = np.max([np.amax(c[0], axis=0) for c in conts], axis=0)
    min_x, min_y = int(mins[0]), int(mins[1])
    chunks_x = int(math.ceil((maxs[0] - mins[0]) / chunk_size))
    chunks_y = int(math.ceil((maxs[1] - mins[1]) / chunk_size))

    dset = anno_file.create_dataset(
        dset_name, (chunks_y * chunk_size, chunks_x * chunk_size),
        chunks=(512, 512), compression="gzip", dtype="uint8")

    samp_chunk = (chunk_size // look_f, chunk_size // look_f)
    sampling_map = np.full((chunks_y * samp_chunk[0], chunks_x * samp_chunk[1]), 255,
                           dtype=np.uint8)
    for cy in range(chunks_y):
        for cx in range(chunks_x):
            x_rel, y_rel = cx * chunk_size, cy * chunk_size
            seg_chunk = np.full((chunk_size, chunk_size), 255, dtype=np.uint8)
            for poly, value in conts:
                p = np.copy(poly).reshape((-1, 1, 2)).astype(int)
                p[:, :, 0] -= x_rel + min_x
                p[:, :, 1] -= y_rel + min_y
                cv2.drawContours(seg_chunk, [p], -1, int(value), -1)
            samp = block_reduce_median(seg_chunk, look_f)
            sampling_map[cy * samp_chunk[0]:(cy + 1) * samp_chunk[0],
                         cx * samp_chunk[1]:(cx + 1) * samp_chunk[1]] = samp
            seg_chunk[seg_chunk == 255] = 0
            seg_chunk = cv2.morphologyEx(seg_chunk, cv2.MORPH_CLOSE,
                                         np.ones((7, 7), np.uint8))
            dset[y_rel:y_rel + chunk_size, x_rel:x_rel + chunk_size] = seg_chunk
    samp_png = cv2.imencode(".png", sampling_map)[1]
    return (min_y, min_x), samp_png


class _H5Cache:
    """Per-thread h5py file handles (h5 handles are not thread safe to share)."""

    def __init__(self, path):
        self._path = path
        self._local = threading.local()

    # picklable for multiprocess loaders (grain workers): handles re-open lazily
    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "_local"}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local = threading.local()

    def dataset(self, name: str):
        import h5py

        f = getattr(self._local, "file", None)
        if f is None:
            f = self._local.file = h5py.File(self._path, mode="r")
        return f[name]


class CATCH_DS_Anno:
    """(reference catch_ds.py:18-161)"""

    def __init__(self, img_l, anno_file_path, patch_size, base_scale, overlap,
                 samples, lookup_f, num_classes, style_sampler, style_drop_rate,
                 transforms):
        import cv2

        self._img_l = img_l
        self._samples = samples
        self._patch_size = patch_size
        self._base_scale = base_scale
        self._lookup_f = lookup_f
        self._num_classes = num_classes
        self._style_sampler = style_sampler
        self._style_drop_rate = style_drop_rate
        self._transforms = transforms
        self._slides = _SlideCache()
        self._h5 = _H5Cache(anno_file_path)
        self.kernel_size = (patch_size - 2 * overlap) * base_scale

        wsi_nums = np.unique(np.array([el[3] for el in img_l])) if img_l else []
        wsi_idx = {n: i for i, n in enumerate(wsi_nums)}
        per_class = [[[] for _ in wsi_nums] for _ in range(num_classes + 1)]
        p_h = int(((patch_size / 2) * base_scale) / lookup_f)
        for img_num, img_tup in enumerate(img_l):
            smap = cv2.imdecode(img_tup[2], cv2.IMREAD_ANYDEPTH)
            classes = list(range(num_classes)) + [255]
            for slot, cls in enumerate(classes):
                mask = smap[p_h:-p_h, p_h:-p_h] == cls
                coords = np.argwhere(mask) + p_h
                coords = np.concatenate(
                    [coords, np.full((len(coords), 1), img_num, coords.dtype)], axis=1)
                per_class[slot if cls != 255 else -1][wsi_idx[img_tup[3]]].append(coords)

        def flat(slots):
            arrs = [np.concatenate(per_class[s][j], axis=0)
                    for s in slots for j in range(len(wsi_nums))
                    if per_class[s][j]]
            return np.concatenate(arrs, axis=0) if arrs else np.zeros((0, 3), np.int64)

        # BG / any-tumor / white-background pools, P = (0.4, 0.5, 0.1)
        # (catch_ds.py:73-83)
        self._global_sample_list = [flat([0]), flat(range(1, num_classes)),
                                    flat([num_classes])]
        self._probs = np.array([0.4, 0.5, 0.1])
        self._probs /= self._probs.sum()

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
        while True:
            cls = int(rng.choice(len(self._probs), p=self._probs))
            pool = self._global_sample_list[cls]
            if len(pool):
                break
        coords = pool[int(rng.integers(0, len(pool)))]

        img_num = int(coords[2])
        img_p = self._img_l[img_num]
        slide = self._slides.get(img_p[-1], img_p[0])
        anno_dset = self._h5.dataset(str(img_p[-1]))

        y_c = int(coords[0] * self._lookup_f + 0.5 * self._lookup_f)
        x_c = int(coords[1] * self._lookup_f + 0.5 * self._lookup_f)
        img, seg = h5_sample(slide, anno_dset, img_p[1], self._patch_size,
                             self._base_scale, (y_c, x_c), self._transforms, rng)
        seg = seg.astype(np.int32)

        style_num = min(img_num, len(self.style_samp_list) - 1)
        style = self._style_sampler.sample_imgs(
            rng, slide, (y_c, x_c), img_p[1], self._patch_size, self._base_scale,
            self.style_samp_list[style_num], self.style_steps[style_num])

        one_hot = _one_hot(seg, self._num_classes)
        if rng.uniform() < self._style_drop_rate:
            style = np.zeros_like(style) - 0.5
        return (img * 2 - 1).astype(np.float32), one_hot, seg, \
            (style * 2 - 1).astype(np.float32)


class CATCH_DS_Predict(CATCH_DS_Anno):
    def __getitem__(self, idx, rng=None):
        return (*super().__getitem__(idx, rng=rng), idx)


class CATCH_DS_Ordered:
    """Deterministic grid over WSIs, optionally subsampled by wsi_red_factor
    (reference catch_ds.py:169-258)."""

    def __init__(self, img_l, anno_file_path, patch_size, base_scale, overlap,
                 lookup_f, wsi_red_factor, num_classes, transforms):
        import cv2

        self._img_l = img_l
        self._patch_size = patch_size
        self._base_scale = base_scale
        self._lookup_f = lookup_f
        self._num_classes = num_classes
        self._transforms = transforms
        self._slides = _SlideCache()
        self._h5 = _H5Cache(anno_file_path)
        self.kernel_size = (patch_size - 2 * overlap) * base_scale

        self._sample_list = np.zeros((0, 3), dtype=np.int64)
        patch_f = int(self.kernel_size / lookup_f)
        for img_num, img_tup in enumerate(img_l):
            smap = cv2.imdecode(img_tup[2], cv2.IMREAD_ANYDEPTH)
            border = int((overlap * base_scale) / lookup_f)
            mask = np.ones(smap.shape, np.uint8)[border:-border, border:-border]
            block_y = int(mask.shape[0] / patch_f)
            block_x = int(mask.shape[1] / patch_f)
            mask = mask[:block_y, :block_x][::wsi_red_factor, ::wsi_red_factor]
            coords = np.argwhere(mask) * wsi_red_factor * patch_f + border
            coords = np.concatenate(
                [coords, np.full((len(coords), 1), img_num, coords.dtype)], axis=1)
            self._sample_list = np.concatenate([self._sample_list, coords], axis=0)

        unique = np.unique(np.array([t[-1] for t in img_l])) if img_l else []
        self.wsi_lookup = {n: i for i, n in enumerate(unique)}

    def __len__(self):
        return len(self._sample_list) if len(self._img_l) > 0 else 0

    def __getitem__(self, idx, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng(idx)
        coords = self._sample_list[idx]
        img_p = self._img_l[int(coords[2])]
        slide = self._slides.get(img_p[0], img_p[0])
        anno_dset = self._h5.dataset(str(img_p[-1]))

        y_c = int(coords[0] * self._lookup_f + 0.5 * self.kernel_size)
        x_c = int(coords[1] * self._lookup_f + 0.5 * self.kernel_size)
        img, seg = h5_sample(slide, anno_dset, img_p[1], self._patch_size,
                             self._base_scale, (y_c, x_c), self._transforms, rng)
        seg = seg.astype(np.int32)
        one_hot = _one_hot(seg, self._num_classes)
        return (img * 2 - 1).astype(np.float32), one_hot, seg, (0, 0), \
            self.wsi_lookup[img_p[-1]]


class CATCH_DS_UnAnno:
    """(reference catch_ds.py:261-337)"""

    def __init__(self, img_l, patch_size, base_scale, overlap, samples, num_classes,
                 style_sampler, transforms):
        self._img_l = img_l
        self._samples = samples
        self._patch_size = patch_size
        self._base_scale = base_scale
        self._num_classes = num_classes
        self._style_sampler = style_sampler
        self._transforms = transforms
        self._slides = _SlideCache()
        self.kernel_size = (patch_size - 2 * overlap) * base_scale

        self._sample_list, self._mask_steps = [], []
        for idx, img_tup in enumerate(img_l):
            slide = open_slide(img_tup[0])
            mask = tissue_mask(slide, self.kernel_size)
            coords = np.argwhere(mask)
            coords = np.concatenate(
                [coords, np.full((len(coords), 1), idx, coords.dtype)], axis=1)
            self._sample_list.append(coords)
            self._mask_steps.append(tissue_mask_step(slide, self.kernel_size))
            slide.close()

    def __len__(self):
        return self._samples if len(self._sample_list) > 0 else 0

    def __getitem__(self, idx, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        inst = int(rng.integers(0, len(self._sample_list)))
        instance_list = self._sample_list[inst]
        coords = instance_list[int(rng.integers(0, len(instance_list)))]
        img_p = self._img_l[int(coords[2])]
        slide = self._slides.get(img_p[-1], img_p[0])

        step = self._mask_steps[int(coords[2])]
        y_c = (coords[0] + 0.5) * step
        x_c = (coords[1] + 0.5) * step
        crop = wsi_sample(slide, (0, 0), self._patch_size, self._base_scale,
                          (y_c, x_c))
        img = self._transforms(rng, crop)["image"]
        seg = np.full((self._patch_size, self._patch_size), -1, np.int32)
        style = self._style_sampler.sample_imgs(
            rng, slide, (y_c, x_c), img_p[1], self._patch_size, self._base_scale,
            instance_list, step)
        one_hot = np.zeros((self._patch_size, self._patch_size, self._num_classes),
                           np.float32)
        return (img * 2 - 1).astype(np.float32), one_hot, seg, \
            (style * 2 - 1).astype(np.float32)


from stedm_tpu_torch.data.flowers import (  # noqa: E402
    Flowers_DS_Syn as CATCH_DS_Syn,
    Flowers_DS_Syn_Ordered as CATCH_DS_Syn_Ordered,
)


class CATCH_DM_Anno:
    """(reference catch_dm.py:24-204)"""

    def __init__(self, cfg, ds_cfg, ratio, **kwargs):
        self._cfg = cfg
        self._ds_cfg = ds_cfg
        self._data_dir = cfg.location.data_dir
        self._base_scale = cfg.data.base_scale
        self._patch_size = cfg.data.patch_size
        self._overlap = cfg.data.overlap_val
        self._num_classes = cfg.data.num_classes
        self._classes = list(ds_cfg.get("classes", cfg.data.classes))
        self._samples = int(cfg.data.samples * ratio)
        self._lookup_f = cfg.data.lookup_f
        self._zip_name = (f"{ds_cfg.zip_name}_{ds_cfg.annotator.name}"
                          if ds_cfg.get("annotator") else ds_cfg.zip_name)

    def prepare_data(self):
        """Zip a staged tree (catch_dm.py:53-121). Pulling the slides and
        polygons from an EXACT server when neither the zip nor the tree is
        staged is not ported (ROADMAP §1: the pull from an EXACT server)."""
        base_dir = f"{self._data_dir}/{self._zip_name}"
        zip_file = f"{base_dir}.zip"
        if not self._cfg.data.reload_data and os.path.isfile(zip_file):
            return
        if os.path.isdir(base_dir) and os.path.isfile(f"{base_dir}/train.pkl"):
            shutil.make_archive(zip_file[:-4], "zip", base_dir)
            return
        raise NotImplementedError(
            f"{base_dir}: no staged tree or zip, and the pull from an EXACT server "
            "(utils/exact.py) is not ported (ROADMAP §1: the pull from an EXACT server)")

    def _load_lists(self, base_dir):
        out = []
        for split in ("train", "val", "test"):
            with open(f"{base_dir}/{split}.pkl", "rb") as f:
                lst = pickle.load(f)
            out.append([(f"{base_dir}/wsi/{el[0]}", *el[1:]) for el in lst])
        return out

    def _split_anno_unanno(self):
        class_lists = [[] for _ in range(self._num_classes - 1)]
        for el in self._list_train:
            for class_num, class_name in enumerate(self._classes[1:]):
                if class_name in el[0]:
                    class_lists[class_num].append(el)
        n = self._cfg.data.class_train_samples
        self._list_train, self._list_unanno = [], []
        for class_list in class_lists:
            self._list_train.extend(class_list[:n])
            self._list_unanno.extend(class_list[n:])

    def setup(self, stage=None):
        base_dir = _stage_dir(self._data_dir, self._zip_name)
        self._list_train, self._list_val, self._list_test = self._load_lists(base_dir)
        self._anno_path = f"{base_dir}/anno.hdf5"
        self._split_anno_unanno()

        p = self._patch_size
        sampler_cls = _SAMPLERS[self._cfg.style_sampling.class_name]
        sampler = sampler_cls(self._cfg.style_sampling, augment.base_transforms(p))
        sampler_pred = sampler_cls(self._cfg.style_sampling,
                                   augment.style_transforms(p))
        drop = self._cfg.get("style_drop_rate", 0.0)

        self._ds_train = CATCH_DS_Anno(
            self._list_train, self._anno_path, p, self._base_scale, self._overlap,
            self._samples, self._lookup_f, self._num_classes, sampler, drop,
            augment.base_transforms(p))
        self._ds_val = CATCH_DS_Ordered(
            self._list_val, self._anno_path, p, self._base_scale, self._overlap,
            self._lookup_f, 4, self._num_classes, augment.eval_transforms(p))
        self._ds_test = CATCH_DS_Ordered(
            self._list_test, self._anno_path, p, self._base_scale, self._overlap,
            self._lookup_f, 1, self._num_classes, augment.eval_transforms(p))
        self._ds_predict = CATCH_DS_Predict(
            self._list_train, self._anno_path, p, self._base_scale, self._overlap,
            self._samples, self._lookup_f, self._num_classes, sampler_pred, 0.0,
            augment.style_transforms(p))

    def train_dataset(self):
        return self._ds_train

    def val_dataset(self):
        return self._ds_val

    def test_dataset(self):
        return self._ds_test

    def predict_dataset(self):
        return self._ds_predict


class CATCH_DM_UnAnno(CATCH_DM_Anno):
    """Unannotated pool as predict-only style source (catch_dm.py:207-256)."""

    def setup(self, stage=None):
        base_dir = _stage_dir(self._data_dir, self._zip_name)
        self._list_train, self._list_val, self._list_test = self._load_lists(base_dir)
        self._anno_path = f"{base_dir}/anno.hdf5"
        self._split_anno_unanno()

        p = self._patch_size
        sampler_cls = _SAMPLERS[self._cfg.style_sampling.class_name]
        sampler_pred = sampler_cls(self._cfg.style_sampling,
                                   augment.style_transforms(p))
        self._ds_train = []
        self._ds_val = []
        self._ds_test = []
        self._ds_predict = CATCH_DS_UnAnno(
            self._list_unanno, p, self._base_scale, self._overlap, self._samples,
            self._num_classes, sampler_pred, augment.style_transforms(p))


class CATCH_DM_Syn:
    """(reference catch_dm.py:258-356) — shares the flowers syn module logic."""

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
