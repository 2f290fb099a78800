"""Host-side image augmentations (albumentations replacement).

A copy of stedm_tpu/data/augment.py (the port imports nothing of the JAX
package).

The reference composes albumentations transforms (reference
`data/flowers/flowers_dm.py:116-123`): Resize, H/V flips, a heavy Affine
(scale 0.8-1.2, translate 10%, rotate +-360, shear +-20, reflect border) for style
augmentation, and ToFloat. Albumentations is not in this environment, so this module
implements the same ops on numpy/OpenCV with an explicit np.random.Generator —
no hidden global RNG, so worker pipelines stay reproducible.

All transforms take/return HWC uint8 (or float32) arrays; masks use nearest
interpolation. Images are converted to float32 in [0, 1] by ``to_float`` (the
[-1, 1] range shift happens in the dataset, reference flowers_ds.py:66).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import cv2
import numpy as np


@dataclasses.dataclass
class Resize:
    height: int
    width: int

    def __call__(self, rng, image, mask=None):
        image = cv2.resize(image, (self.width, self.height),
                           interpolation=cv2.INTER_LINEAR)
        if mask is not None:
            mask = cv2.resize(mask, (self.width, self.height),
                              interpolation=cv2.INTER_NEAREST)
        return image, mask


@dataclasses.dataclass
class HorizontalFlip:
    p: float = 0.5

    def __call__(self, rng, image, mask=None):
        if rng.uniform() < self.p:
            image = image[:, ::-1]
            if mask is not None:
                mask = mask[:, ::-1]
        return image, mask


@dataclasses.dataclass
class VerticalFlip:
    p: float = 0.5

    def __call__(self, rng, image, mask=None):
        if rng.uniform() < self.p:
            image = image[::-1]
            if mask is not None:
                mask = mask[::-1]
        return image, mask


@dataclasses.dataclass
class Affine:
    """Random scale/translate/rotate/shear with reflected borders
    (reference flowers_dm.py:122)."""

    scale: tuple[float, float] = (0.8, 1.2)
    translate_percent: float = 0.1
    rotate: tuple[float, float] = (-360, 360)
    shear: tuple[float, float] = (-20, 20)
    p: float = 1.0

    def __call__(self, rng, image, mask=None):
        if rng.uniform() >= self.p:
            return image, mask
        h, w = image.shape[:2]
        scale = rng.uniform(*self.scale)
        angle = rng.uniform(*self.rotate)
        shear = np.deg2rad(rng.uniform(*self.shear))
        tx = rng.uniform(-self.translate_percent, self.translate_percent) * w
        ty = rng.uniform(-self.translate_percent, self.translate_percent) * h

        center = np.array([w / 2, h / 2])
        rad = np.deg2rad(angle)
        rot = np.array([[np.cos(rad), -np.sin(rad)], [np.sin(rad), np.cos(rad)]])
        sh = np.array([[1.0, np.tan(shear)], [0.0, 1.0]])
        m2 = scale * rot @ sh
        offset = center - m2 @ center + np.array([tx, ty])
        m = np.concatenate([m2, offset[:, None]], axis=1).astype(np.float32)

        image = cv2.warpAffine(image, m, (w, h), flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_REFLECT)
        if mask is not None:
            mask = cv2.warpAffine(mask, m, (w, h), flags=cv2.INTER_NEAREST,
                                  borderMode=cv2.BORDER_REFLECT)
        return image, mask


@dataclasses.dataclass
class ToFloat:
    max_value: float = 255.0

    def __call__(self, rng, image, mask=None):
        return image.astype(np.float32) / self.max_value, mask


class Compose:
    """Apply transforms in order; call signature mirrors albumentations'
    ``transform(image=..., mask=...)`` but takes an explicit RNG."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, rng: np.random.Generator, image: np.ndarray,
                 mask: np.ndarray | None = None) -> dict:
        for t in self.transforms:
            image, mask = t(rng, image, mask)
        out = {"image": np.ascontiguousarray(image)}
        if mask is not None:
            out["mask"] = np.ascontiguousarray(mask)
        return out


def base_transforms(patch_size: int) -> Compose:
    """Train-time: resize + flips + to-float (reference flowers_dm.py:116-117)."""
    return Compose([Resize(patch_size, patch_size), HorizontalFlip(), VerticalFlip(),
                    ToFloat()])


def eval_transforms(patch_size: int) -> Compose:
    """Val/test: resize + to-float only (reference flowers_dm.py:119)."""
    return Compose([Resize(patch_size, patch_size), ToFloat()])


def style_transforms(patch_size: int) -> Compose:
    """Style-source: flips + heavy affine (reference flowers_dm.py:121-123)."""
    return Compose([Resize(patch_size, patch_size), HorizontalFlip(), VerticalFlip(),
                    Affine(), ToFloat()])
