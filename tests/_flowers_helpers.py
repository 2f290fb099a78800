"""A miniature Flowers-102 tree and the tiny entry-point overrides shared by
the tests that hold the port's data pipeline and entry points against the
JAX package (the tree and the overrides of tests/test_e2e_flowers.py)."""

from pathlib import Path

import numpy as np
from PIL import Image

from test_e2e_flowers import CLASS_OVERRIDES, TINY_OVERRIDES  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def write_flowers_tree(root: Path, n: int = 24, size: int = 40) -> Path:
    """imgs/, segs/ (blue background, a foreground square), imagelabels.mat
    and setid.mat under ``root/flowers``; labels cycle over classes 1..6,
    ids split train/val/test by index mod 3. Returns ``root``."""
    import scipy.io

    base = root / "flowers"
    (base / "imgs").mkdir(parents=True)
    (base / "segs").mkdir(parents=True)
    rng = np.random.default_rng(0)
    labels = np.array([(i % 6) + 1 for i in range(n)])
    ids = ([], [], [])
    lo, hi = size // 4, 3 * size // 4
    for i in range(n):
        img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        seg = np.zeros((size, size, 3), dtype=np.uint8)
        seg[:, :, 2] = 255
        seg[lo:hi, lo:hi] = [200, 200, 0]
        Image.fromarray(img).save(base / "imgs" / f"image_{str(i + 1).zfill(5)}.jpg")
        Image.fromarray(seg).save(base / "segs" / f"segmim_{str(i + 1).zfill(5)}.jpg")
        ids[i % 3].append(i + 1)
    scipy.io.savemat(base / "imagelabels.mat", {"labels": labels[None]})
    scipy.io.savemat(base / "setid.mat", {"trnid": np.array(ids[0])[None],
                                         "valid": np.array(ids[1])[None],
                                         "tstid": np.array(ids[2])[None]})
    return root


def write_preview_fixture(root: Path, patch: int = 32) -> None:
    """The epoch-end preview folder (test_img_diff/flowers): a layout and two
    augmented-sampling styles (tests/test_e2e_flowers.py:86-95)."""
    folder = root / "test_img_diff" / "flowers"
    (folder / "augmented").mkdir(parents=True, exist_ok=True)
    cond = np.zeros((patch, patch), np.uint8)
    cond[patch // 4:3 * patch // 4, patch // 4:3 * patch // 4] = 255
    Image.fromarray(cond).save(folder / "test_c.png")
    for i in range(2):
        style = np.random.default_rng(i).integers(0, 255, (patch, patch, 3), np.uint8)
        Image.fromarray(style).save(folder / "augmented" / f"{i}_img.png")


def run_overrides(data_dir: Path, result_dir: Path) -> list[str]:
    """The tiny model and data of tests/test_e2e_flowers.py on ``data_dir``."""
    return TINY_OVERRIDES + CLASS_OVERRIDES + [f"location.data_dir={data_dir}",
                                               f"location.result_dir={result_dir}"]


def jax_train_loader(jdm, seed: int):
    """What the JAX DataModule's train_loader yields once the per-item
    generator reaches the dataset: the JAX Loader over its only non-empty
    train dataset (its ConcatDataset of one dataset maps every index to
    itself). Its own train_loader draws unseeded (ROADMAP §3)."""
    from stedm_tpu.data.loader import Loader

    datasets = [m.train_dataset() for m in jdm.data_modules.values()
                if len(m.train_dataset()) > 0]
    assert len(datasets) == 1
    loader = jdm.train_loader(seed=seed)
    return Loader(datasets[0], loader.batch_size, shuffle=True,
                  num_workers=loader.num_workers, seed=seed, drop_last=True)
