"""Overlap-aware patch grid over a large image (reference
`utils/patch_handler_ms.py:7-78`, ``PatchHandlerMS``).

A copy of stedm_tpu/utils/patch_handler.py (the port imports nothing of the JAX
package).

``get`` extracts padded patches (white padding for imagery, zeros for masks) on a
stride of ``patch_size - 2*overlap``; ``take`` writes back only each patch's
non-overlap kernel region, reassembling a full-resolution output. ``get`` accepts a
``scale`` to read aligned crops from lower-resolution companions of the same image.
"""

from __future__ import annotations

import math

import numpy as np


class PatchHandlerMS:
    def __init__(self, img_shape: tuple, patch_size: int, overlap: int):
        self._img_shape = img_shape
        self._patch_size = patch_size
        self._overlap = overlap
        self._kernel_size = patch_size - 2 * overlap
        # note: the reference derives the x-count from shape[0] (patch_handler_ms.py:
        # 14-15), which only holds for its transposed ROI rasters; here x counts
        # columns (shape[1]) and y rows (shape[0]) for any (H, W[, C]) image
        self._x_p = math.ceil(img_shape[1] / self._kernel_size)
        self._y_p = math.ceil(img_shape[0] / self._kernel_size)
        self._img_p_num = int(self._x_p * self._y_p)
        self._out_image: np.ndarray | None = None

    def num_segs(self) -> int:
        return self._img_p_num

    def _grid_pos(self, idx: int) -> tuple[int, int]:
        return int(idx % self._x_p), int(idx // self._x_p)  # (i, j)

    def get(self, image: np.ndarray, idx: int, scale: float = 1.0) -> np.ndarray:
        i, j = self._grid_pos(idx)
        kernel = self._kernel_size / scale
        overlap = self._overlap / scale
        x_s = int(i * kernel - overlap)
        y_s = int(j * kernel - overlap)
        x_e, y_e = x_s + self._patch_size, y_s + self._patch_size

        x_lo = max(x_s, 0) - x_s
        y_lo = max(y_s, 0) - y_s
        x_hi = x_e - min(x_e, image.shape[1])
        y_hi = y_e - min(y_e, image.shape[0])

        # white padding for imagery (microscopy background), zeros for masks
        if image.ndim > 2:
            out = np.full((self._patch_size, self._patch_size, image.shape[2]), 255,
                          dtype=image.dtype)
        else:
            out = np.zeros((self._patch_size, self._patch_size), dtype=image.dtype)
        out[y_lo:self._patch_size - y_hi, x_lo:self._patch_size - x_hi] = \
            image[y_s + y_lo:y_e - y_hi, x_s + x_lo:x_e - x_hi]
        return out

    def take(self, patch: np.ndarray, idx: int) -> None:
        if self._out_image is None:
            shape = (self._img_shape[0], self._img_shape[1])
            if patch.ndim > 2:
                shape += (patch.shape[2],)
            self._out_image = np.zeros(shape, dtype=patch.dtype)

        i, j = self._grid_pos(idx)
        o = self._overlap
        x_s = i * self._kernel_size - o
        y_s = j * self._kernel_size - o
        x_e = x_s + self._patch_size
        y_e = y_s + self._patch_size
        x_hi = x_e - min(x_e, self._img_shape[1])
        y_hi = y_e - min(y_e, self._img_shape[0])

        self._out_image[y_s + o:min(self._img_shape[0], y_e - o),
                        x_s + o:min(self._img_shape[1], x_e - o)] = \
            patch[o:min(self._patch_size - o, self._patch_size - y_hi),
                  o:min(self._patch_size - o, self._patch_size - x_hi)]

    def get_out_image(self) -> np.ndarray | None:
        return self._out_image

    def clear(self) -> None:
        self._out_image = None
