"""Miniature HER2 and CATCH trees for the tests that hold the port's WSI data
path and entry points against the JAX package.

HER2 (``her2_anno_her2_anno``): three annotated slides (white background
around a tissue block) with two square ROIs each, rasterised from polygons
of classes 1-5 with the JAX package's ``rasterize_rois``; slides 101 and 102
are train/val, 103 test. ``scoring_wsi/`` holds unannotated slides under
``<id>_HER2_IHC.svs`` names (PNG content) and ``all_wsi_scores.csv`` lists
them with an empty ``USE`` column, an excluded row, a ``2+`` score, a row
without a score and a row whose slide is missing.

CATCH (``catch_catch_anno``): slides named by subtype, their segmentations
in ``anno.hdf5`` (one dataset per slide number), train/val/test pickles.

``fix_jax_mask_step`` gives the JAX package's datasets the port's repair of
the tissue-mask scale, so that the two can be held equal item by item.
"""

import pickle
from pathlib import Path

import numpy as np
from PIL import Image

# small shapes: 32^2 patches at base scale 2, sampling maps at 1/8
HER2_OVERRIDES = [
    "data=her2", "data.patch_size=32", "data.samples=6", "data.batch_size=2",
    "data.base_scale=2", "data.lookup_f=8", "data.overlap_val=4", "data.overlap_train=4",
    "data.class_train_samples=1", "location=pc", "location.n_workers=2",
    "data.dataset.her2_anno.score_dict={101: 0, 102: 0, 103: 1}",
    "data.dataset.her2_anno.folds=[[102]]",
]
CATCH_OVERRIDES = [
    "data=catch", "data.patch_size=32", "data.samples=6", "data.batch_size=2",
    "data.base_scale=2", "data.lookup_f=8", "data.overlap_val=4", "data.overlap_train=4",
    "data.class_train_samples=1", "location=pc", "location.n_workers=2",
    "data.num_val_inst=4", "data.num_test_inst=4",
]
SLIDE_HW = (320, 384)
ROI = 128


def _slide(rng, hw=SLIDE_HW, block=(24, 24, 296, 360)) -> np.ndarray:
    img = np.full((*hw, 3), 255, np.uint8)
    y0, x0, y1, x1 = block
    img[y0:y1, x0:x1] = rng.integers(30, 220, (y1 - y0, x1 - x0, 3), dtype=np.uint8)
    return img


def _polygons(rng, bbox, n: int = 4):
    """``n`` quadrilaterals inside ``bbox`` with labels over classes 1-5."""
    labels = ["HER2 0", "HER2 1+", "HER2 2+", "HER2 3+", "DCIS"]
    out = []
    for i in range(n):
        cy = rng.integers(bbox["y1"] + 24, bbox["y2"] - 24)
        cx = rng.integers(bbox["x1"] + 24, bbox["x2"] - 24)
        r = rng.integers(12, 30, 4)
        poly = np.array([[cx - r[0], cy], [cx, cy - r[1]], [cx + r[2], cy], [cx, cy + r[3]]],
                        np.float64)
        out.append((poly, labels[i % len(labels)]))
    return out


def her2_rois(rng, name: str, label_dict) -> list[tuple]:
    from stedm_tpu.data.prep import rasterize_rois

    rois = [dict(x1=40, y1=40, x2=40 + ROI, y2=40 + ROI),
            dict(x1=200, y1=150, x2=200 + ROI, y2=150 + ROI)]
    conts = [c for bbox in rois for c in _polygons(rng, bbox)]
    return rasterize_rois(rois, conts, label_dict, 8, name)


def write_her2_tree(root: Path) -> Path:
    """The HER2 tree above under ``root``; returns ``root``."""
    from stedm_tpu.config import compose

    label_dict = dict(compose("config_diff", ["data=her2"]).data.dataset.her2_anno.label_dict)
    base = root / "her2_anno_her2_anno"
    (base / "wsi").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lists = {"train_val": [], "test": []}
    for num in (101, 102, 103):
        name = f"slide_{num}.png"
        Image.fromarray(_slide(rng)).save(base / "wsi" / name)
        lists["test" if num == 103 else "train_val"] += her2_rois(rng, name, label_dict)
    for split, lst in lists.items():
        with open(base / f"{split}.pkl", "wb") as f:
            pickle.dump(lst, f)
    scoring = root / "scoring_wsi"
    scoring.mkdir()
    for sid in ("5001", "5002", "5003", "5004"):
        Image.fromarray(_slide(rng)).save(scoring / f"{sid}_HER2_IHC.svs", format="PNG")
    (root / "all_wsi_scores.csv").write_text(
        "Tumorblock_ID;HERIHCScore;USE\n"
        "5001;2+;\n"       # kept, scored 2
        "5002;3;\n"        # kept
        "5003;1;no\n"      # marked for exclusion
        "5004;;\n"         # no score
        "5005;0;\n")       # its slide is missing
    return root


def write_syn_folder(root: Path, name: str, n: int = 6, size: int = 40) -> None:
    """``syn_data/<name>``: img/seg PNG pairs as predict_diff writes them."""
    folder = root / "syn_data" / name
    folder.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(n):
        img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        seg = np.zeros((size, size), np.uint8)
        y, x = rng.integers(4, size // 2, 2)
        seg[y:y + size // 3, x:x + size // 3] = 1
        Image.fromarray(img).save(folder / f"img_{i:05d}.png")
        Image.fromarray(seg).save(folder / f"seg_{i:05d}.png")


# (file name, slide number, split, tumour class) of the CATCH tree
CATCH_SLIDES = [("Melanoma_01.png", 0, "train", 3), ("Histiocytoma_02.png", 1, "train", 7),
                ("Melanoma_03.png", 2, "val", 3), ("SCC_04.png", 3, "val", 6),
                ("SCC_05.png", 4, "test", 6), ("Melanoma_06.png", 5, "train", 3)]


def write_catch_tree(root: Path) -> Path:
    """The CATCH tree above under ``root``; returns ``root``."""
    import cv2
    import h5py

    from stedm_tpu.data.wsi import block_reduce_median

    base = root / "catch_catch_anno"
    (base / "wsi").mkdir(parents=True)
    rng = np.random.default_rng(1)
    lists = {"train": [], "val": [], "test": []}
    with h5py.File(base / "anno.hdf5", "w") as f:
        for name, num, split, cls in CATCH_SLIDES:
            Image.fromarray(_slide(rng)).save(base / "wsi" / name)
            seg = np.zeros((256, 320), np.uint8)
            seg[40:200, 60:140] = cls
            seg[120:220, 180:300] = 1 + num % 2
            f.create_dataset(str(num), data=seg, chunks=(64, 64), compression="gzip")
            samp = block_reduce_median(np.where(seg == 0, 255, seg).astype(np.uint8), 8)
            samp[:2] = 0
            lists[split].append((name, (16, 24), cv2.imencode(".png", samp)[1], num))
    for split, lst in lists.items():
        with open(base / f"{split}.pkl", "wb") as fh:
            pickle.dump(lst, fh)
    return root


def equal_items(got, want) -> None:
    """Two dataset items (or lists of them) equal field by field: arrays by
    dtype, shape and every value."""
    assert type(got) is type(want) or isinstance(want, (int, np.integer))
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            equal_items(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def items(ds, idxs, seed: int) -> list:
    """``ds[i]`` for each ``i``, each drawn from its own explicit generator."""
    return [ds.__getitem__(i, rng=np.random.default_rng([seed, i])) for i in idxs]


def fix_jax_mask_step(mp) -> None:
    """Through ``mp`` (a ``pytest.MonkeyPatch``), give the JAX package's HER2
    and CATCH datasets that sample from tissue masks the port's scale of a
    mask coordinate: ``wsi.tissue_mask_step`` in place of ``kernel_size``,
    which lands 4x out on an ``ArraySlide`` (ROADMAP §3). After its
    ``__init__`` a dataset's ``kernel_size``, read from then on only to scale
    mask coordinates, becomes the step of its slides' masks (one step: every
    slide here has a level 2)."""
    import stedm_tpu.data.catch as jcatch
    import stedm_tpu.data.her2 as jher2
    from stedm_tpu_torch.data.wsi import tissue_mask_step

    for mod, names in ((jher2, ("HER2_DS_Anno", "HER2_DS_UnAnno")),
                       (jcatch, ("CATCH_DS_Anno", "CATCH_DS_UnAnno"))):
        steps: list = []

        def recording(slide, kernel_size, _tissue_mask=mod.tissue_mask, _steps=steps):
            _steps.append(tissue_mask_step(slide, kernel_size))
            return _tissue_mask(slide, kernel_size)

        mp.setattr(mod, "tissue_mask", recording)
        for name in names:
            cls = getattr(mod, name)

            def init(self, *args, _init=cls.__init__, _steps=steps, **kwargs):
                _steps.clear()
                _init(self, *args, **kwargs)
                if _steps:
                    assert len(set(_steps)) == 1, _steps
                    self.kernel_size = _steps[0]

            mp.setattr(cls, "__init__", init)
