"""Whole-slide-image access layer.

A copy of stedm_tpu/data/wsi.py (the port imports nothing of the JAX package)
with one backend: ``ArraySlide``, a pyramid over a plain image file (read by
PIL by its content, whatever its name) or a numpy array, exposing the
openslide subset the datasets use: ``read_region(location, level, size)``
(RGBA, location in level-0 coords), ``level_downsamples``,
``level_dimensions``, ``dimensions``, ``close()``. Reading ``.svs`` pyramids
through libopenslide is not ported (ROADMAP §1, not queued: OpenSlide); the
JAX package takes
that path only where openslide-python imports.

Every patch read runs in the port's host library (stedm_tpu_torch/native.py):
crop, white fill outside the slide and the residual block mean in one
GIL-releasing call, single reads on its async pool; so does a pyramid level
of even sides (the same bytes as numpy's float64 mean). The JAX package
falls back to numpy without its library; here ``wsi_sample_reference`` keeps
that numpy path as the plain version the tests hold the library against.
"""

from __future__ import annotations

import numpy as np

from stedm_tpu_torch.data.native_pipeline import global_pipeline
from stedm_tpu_torch.native import downscale_mean_native, wsi_patch_native


def downscale_local_mean(image: np.ndarray, factors: tuple, cval: float = 0.0) -> np.ndarray:
    """Block-mean downscaling with edge padding (skimage equivalent)."""
    factors = tuple(int(f) for f in factors)
    pads = []
    for dim, f in zip(image.shape, factors):
        rem = dim % f
        pads.append((0, (f - rem) % f))
    pads += [(0, 0)] * (image.ndim - len(factors))
    padded = np.pad(image, pads, mode="constant", constant_values=cval)
    shape = []
    for dim, f in zip(padded.shape, factors):
        shape += [dim // f, f]
    shape += list(padded.shape[len(factors):])
    reshaped = padded.reshape(shape)
    axes = tuple(2 * i + 1 for i in range(len(factors)))
    return reshaped.astype(np.float64).mean(axis=axes)


def block_reduce_median(image: np.ndarray, block: int) -> np.ndarray:
    """Median over non-overlapping blocks (skimage block_reduce(func=median))."""
    h, w = image.shape
    ph, pw = (block - h % block) % block, (block - w % block) % block
    padded = np.pad(image, ((0, ph), (0, pw)), mode="constant")
    bh, bw = padded.shape[0] // block, padded.shape[1] // block
    blocks = padded.reshape(bh, block, bw, block).transpose(0, 2, 1, 3)
    return np.median(blocks.reshape(bh, bw, -1), axis=-1).astype(image.dtype)


class ArraySlide:
    """Pyramid over an in-memory array / plain image file (openslide-compatible)."""

    def __init__(self, source, levels: int = 4):
        if isinstance(source, np.ndarray):
            base = source
        else:
            from PIL import Image

            Image.MAX_IMAGE_PIXELS = None
            base = np.array(Image.open(source).convert("RGB"))
        self._levels = [base]
        for _ in range(levels - 1):
            prev = self._levels[-1]
            if min(prev.shape[:2]) < 2:
                break
            if prev.shape[0] % 2 == 0 and prev.shape[1] % 2 == 0 and prev.dtype == np.uint8:
                # the truncated mean of four bytes is exact either way; the
                # host library's needs no float64 copy (1.6 GB at 8192^2)
                self._levels.append(downscale_mean_native(prev, 2))
            else:
                self._levels.append(
                    downscale_local_mean(prev, (2, 2), cval=255).astype(np.uint8))

    @property
    def dimensions(self) -> tuple[int, int]:
        h, w = self._levels[0].shape[:2]
        return (w, h)  # openslide is (width, height)

    @property
    def level_dimensions(self):
        return [(lvl.shape[1], lvl.shape[0]) for lvl in self._levels]

    @property
    def level_downsamples(self):
        return [2.0 ** i for i in range(len(self._levels))]

    def read_region(self, location, level, size) -> np.ndarray:
        """RGBA patch; ``location`` is (x, y) in level-0 coords, alpha=0 padding."""
        x0, y0 = int(location[0]), int(location[1])
        w, h = int(size[0]), int(size[1])
        ds = int(self.level_downsamples[level])
        lx, ly = x0 // ds, y0 // ds
        lvl = self._levels[level]
        out = np.zeros((h, w, 4), dtype=np.uint8)
        src_y0, src_x0 = max(ly, 0), max(lx, 0)
        src_y1 = min(ly + h, lvl.shape[0])
        src_x1 = min(lx + w, lvl.shape[1])
        if src_y1 > src_y0 and src_x1 > src_x0:
            dy, dx = src_y0 - ly, src_x0 - lx
            crop = lvl[src_y0:src_y1, src_x0:src_x1]
            out[dy:dy + crop.shape[0], dx:dx + crop.shape[1], :3] = crop
            out[dy:dy + crop.shape[0], dx:dx + crop.shape[1], 3] = 255
        return out

    def close(self) -> None:
        pass


def open_slide(path):
    """An ``ArraySlide`` over ``path`` (``.npy``: a saved array)."""
    path = str(path)
    if path.endswith(".npy"):
        return ArraySlide(np.load(path))
    return ArraySlide(path)


def _level_plan(slide_obj, p_size: int, b_scale: int):
    """Pick the pyramid level + residual block-mean factor for ``b_scale``
    (reference her2_utils.py:177-208 level-selection logic)."""
    levels = [int(round(lvl)) for lvl in slide_obj.level_downsamples]
    if b_scale in levels:
        return levels.index(b_scale), 1
    out_lvl_ds = next(lvl for lvl in reversed(levels) if lvl < b_scale)
    return levels.index(out_lvl_ds), int(b_scale / out_lvl_ds)


def _origin(pos, offset, p_size: int, b_scale: int) -> tuple[int, int]:
    """The crop's level-0 origin (y0, x0), truncated as the reference does."""
    return (int(pos[0] + offset[0] - (p_size / 2) * b_scale),
            int(pos[1] + offset[1] - (p_size / 2) * b_scale))


def wsi_sample(slide_obj: ArraySlide, offset, p_size: int, b_scale: int, pos) -> np.ndarray:
    """Read a (p_size, p_size) RGB patch centered at ``pos`` (y, x, level-0 coords,
    plus ``offset``) at pyramid scale ``b_scale`` (reference her2_utils.py:177-208):
    the matching level when present, else a finer one block-mean downscaled;
    white outside the slide. One call of the host library."""
    lvl, down = _level_plan(slide_obj, p_size, b_scale)
    ds = int(slide_obj.level_downsamples[lvl])
    y0, x0 = _origin(pos, offset, p_size, b_scale)
    return wsi_patch_native(slide_obj._levels[lvl], y0 // ds, x0 // ds, p_size, down)


def wsi_sample_reference(slide_obj, offset, p_size: int, b_scale: int, pos) -> np.ndarray:
    """The plain numpy version of :func:`wsi_sample` through ``read_region``
    (the JAX package's fallback path), for the tests."""
    levels = [int(round(lvl)) for lvl in slide_obj.level_downsamples]
    y0, x0 = _origin(pos, offset, p_size, b_scale)
    if b_scale in levels:
        lvl = levels.index(b_scale)
        crop = np.array(slide_obj.read_region(location=(x0, y0), level=lvl,
                                              size=(p_size, p_size)), copy=True)
        crop[:, :, :3][crop[:, :, 3] == 0] = 255
        return crop[:, :, :3]

    out_lvl_ds = next(lvl for lvl in reversed(levels) if lvl < b_scale)
    lvl = levels.index(out_lvl_ds)
    scale_diff = int(b_scale / out_lvl_ds)
    crop = np.array(slide_obj.read_region(
        location=(x0, y0), level=lvl,
        size=(p_size * scale_diff, p_size * scale_diff)), copy=True)
    crop[:, :, :3][crop[:, :, 3] == 0] = 255
    crop = crop[:, :, :3]
    return downscale_local_mean(crop, (scale_diff, scale_diff)).astype(np.uint8)


class _SingleTicket:
    """Unwraps the native pool's [1, p, p, C] batch to one [p, p, C] patch."""

    def __init__(self, ticket):
        self._t = ticket

    def get(self) -> np.ndarray:
        return self._t.get()[0]


def wsi_sample_async(slide_obj: ArraySlide, offset, p_size: int, b_scale: int, pos):
    """Submit ONE `wsi_sample` read to the C++ async pool; returns a ticket
    whose ``.get()`` yields the [p, p, 3] patch, so that `sample()` decodes
    the segmentation PNG while the pool crops and downscales."""
    lvl, down = _level_plan(slide_obj, p_size, b_scale)
    ds = int(slide_obj.level_downsamples[lvl])
    y0, x0 = _origin(pos, offset, p_size, b_scale)
    ticket = global_pipeline().submit(slide_obj._levels[lvl],
                                      np.array([[y0 // ds, x0 // ds]], np.int64),
                                      p_size, down)
    return _SingleTicket(ticket)


def wsi_sample_batch(slide_obj: ArraySlide, offset, p_size: int, b_scale: int,
                     positions) -> np.ndarray:
    """Batch `wsi_sample`: [N, p, p, 3] patches for N positions, the whole
    batch on the C++ async pool (one GIL release for N patches)."""
    positions = np.asarray(positions)
    lvl, down = _level_plan(slide_obj, p_size, b_scale)
    ds = int(slide_obj.level_downsamples[lvl])
    # mirror wsi_sample's int() truncation exactly, then floor-divide to
    # level coords like read_region does
    y0 = np.trunc(positions[:, 0] + offset[0] - (p_size / 2) * b_scale).astype(np.int64)
    x0 = np.trunc(positions[:, 1] + offset[1] - (p_size / 2) * b_scale).astype(np.int64)
    coords = np.stack([y0 // ds, x0 // ds], axis=1)
    return global_pipeline().submit(slide_obj._levels[lvl], coords, p_size, down).get()


def sample(slide_obj, offset, seg_comp: np.ndarray, p_size: int, b_scale: int, pos,
           trans, rng) -> tuple[np.ndarray, np.ndarray]:
    """Aligned (image, segmentation) patch pair (reference her2_utils.py:164-174).
    ``seg_comp`` is the PNG-encoded ROI segmentation at base scale.

    The image crop is submitted to the C++ async pool FIRST, so the PNG
    segmentation decode (cv2 releases the GIL) runs concurrently with the
    native crop/downscale."""
    import cv2

    ticket = wsi_sample_async(slide_obj, offset, p_size, b_scale, pos)
    p_h = int((p_size / 2) * b_scale)
    seg = cv2.imdecode(seg_comp, cv2.IMREAD_ANYDEPTH)
    seg_crop = seg[pos[0] - p_h:pos[0] + p_h, pos[1] - p_h:pos[1] + p_h]
    img_crop = ticket.get()
    applied = trans(rng, img_crop, seg_crop)
    return applied["image"], applied["mask"]


def _tissue_mask_plan(slide_obj, kernel_size: int) -> tuple[int, int]:
    """The pyramid level the tissue mask is read at, and its block-mean factor."""
    return min(2, len(slide_obj.level_downsamples) - 1), max(int(kernel_size / 16), 1)


def tissue_mask_step(slide_obj, kernel_size: int) -> int:
    """Level-0 pixels per pixel of ``tissue_mask(slide_obj, kernel_size)``:
    the scale that turns a mask coordinate into a slide position. The
    reference scales by ``kernel_size``, which holds only where level 2 is a
    16x downsample, as in an ``.svs``; an ``ArraySlide``'s level 2 is 4x, and
    there it lands 4x out, mostly off the slide (ROADMAP §3)."""
    lvl, f = _tissue_mask_plan(slide_obj, kernel_size)
    return int(slide_obj.level_downsamples[lvl]) * f


def tissue_mask(slide_obj, kernel_size: int) -> np.ndarray:
    """Low-res tissue mask for style sampling (reference her2_ds.py:96-110):
    level-2 min-channel < 253 after block-mean, then morphology x2. A
    coordinate scales to the slide by ``tissue_mask_step``."""
    from scipy.ndimage import binary_dilation, binary_erosion, binary_opening

    lvl, f = _tissue_mask_plan(slide_obj, kernel_size)
    ref = slide_obj.read_region(location=(0, 0), level=lvl,
                                size=slide_obj.level_dimensions[lvl])
    ref = np.min(np.array(ref)[:, :, :3], axis=2)
    mask = downscale_local_mean(ref, (f, f), cval=255) < 253
    mask = binary_dilation(mask, iterations=2)
    mask = binary_erosion(mask, iterations=2)
    return binary_opening(mask, iterations=2)
