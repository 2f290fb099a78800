"""WSI annotation preparation: ROI rasterization, sampling maps, consensus.

Host-side rebuild of the reference prep tools (reference `data/her2/her2_utils.py:
14-161`): pull annotations from an EXACT server, rasterize sorted polygon contours
into per-ROI segmentation masks, build low-res class sampling maps, and — for
multi-annotator test sets — compute a per-pixel consensus. The reference's numba
kernels (`her2_utils.py:87-130`) become vectorized numpy here; a C++ kernel for the
consensus lives in native/ for large slides.

A copy of stedm_tpu/data/prep.py (the port imports nothing of the JAX package)
whose consensus runs in the port's host library (stedm_tpu_torch/native.py)
and raises when it cannot be built; ``consensus_stack_numpy`` stays as the
plain version the tests hold it against. Pulling the annotations from an
EXACT server is not ported (ROADMAP §1: the pull from an EXACT server).

HER2 class code convention (configs/data/dataset/her2_anno.yaml label_dict):
0 BG, 1-4 HER2 grades, 5 DCIS/LCIS, 6 hard negative.
"""

from __future__ import annotations

import re

import numpy as np

from stedm_tpu_torch.data.wsi import block_reduce_median
from stedm_tpu_torch.native import consensus_stack_native


def rasterize_rois(img_annos_rois, tissue_conts, label_dict, look_f: int,
                   path_name: str) -> list[tuple]:
    """Rasterize one image's ROIs (reference her2_utils.py:30-74).

    ``tissue_conts``: iterable of (polygon Nx2 float array, label string);
    ``img_annos_rois``: iterable of bbox dicts with x1/y1/x2/y2.
    Returns reference-format tuples
    ``(file_name, (y1, x1), seg_png, sampling_png, wsi_num)``.
    """
    import cv2

    conts = []
    for poly, label in tissue_conts:
        poly = np.asarray(poly)
        if len(poly):
            conts.append((poly, cv2.contourArea(poly.astype(np.float32)),
                          label_dict[label]))
    conts.sort(key=lambda el: -el[1])  # draw large contours first

    out = []
    for bbox in img_annos_rois:
        # note: the reference allocates (x-extent, y-extent) — kept verbatim since
        # downstream offsets assume this orientation (her2_utils.py:55)
        img_seg = np.zeros((bbox["x2"] - bbox["x1"], bbox["y2"] - bbox["y1"]), np.uint8)
        for poly, _area, value in conts:
            p = np.copy(poly).reshape((-1, 1, 2)).astype(int)
            p[:, :, 0] -= bbox["x1"]
            p[:, :, 1] -= bbox["y1"]
            cv2.drawContours(img_seg, [p], -1, int(value), -1)

        sampling_map = block_reduce_median(img_seg, look_f)
        seg_png = cv2.imencode(".png", img_seg)[1]
        samp_png = cv2.imencode(".png", sampling_map)[1]
        num = int(re.findall(r"\d+", path_name)[0])
        out.append((path_name, (bbox["y1"], bbox["x1"]), seg_png, samp_png, num))
    return out


def consensus_stack(stack: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-pixel multi-annotator consensus (reference her2_utils.py:87-130).
    ``stack``: [K, H, W] uint8 annotations. Returns (value, strength).

    Runs the C++ kernel (csrc/host/consensus.cc) — WSI masks are hundreds of
    megapixels; :func:`consensus_stack_numpy` is its plain version."""
    return consensus_stack_native(np.asarray(stack))


def consensus_stack_numpy(stack: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized numpy consensus (see :func:`consensus_stack`).

    Stage 1 groups codes into {BG/HN, tumor grades, DCIS} and takes ceil(median);
    stage 2 resolves within the winning group.
    """
    stack = np.asarray(stack)
    k = stack.shape[0]
    is_grade = (stack >= 1) & (stack <= 4)
    mod = np.zeros_like(stack)
    mod[is_grade] = 1
    mod[stack == 5] = 2
    first = np.ceil(np.median(mod, axis=0)).astype(np.int64)

    value = np.zeros(stack.shape[1:], dtype=np.uint8)
    strength = np.zeros(stack.shape[1:], dtype=np.uint8)

    # group 0: background vs hard-negative majority
    bg_count = (stack == 0).sum(axis=0)
    hn_count = (stack == 6).sum(axis=0)
    m0 = first == 0
    value[m0 & (hn_count >= bg_count)] = 6
    strength[m0] = (bg_count + hn_count)[m0]

    # group 1: median over the grade votes only
    grades = np.where(is_grade, stack.astype(np.float64), np.nan)
    import warnings

    with np.errstate(all="ignore"), warnings.catch_warnings():
        # all-NaN columns (no grade votes) are a legal degenerate case -> value 0
        warnings.simplefilter("ignore", RuntimeWarning)
        grade_median = np.ceil(np.nanmedian(grades, axis=0))
    grade_median = np.nan_to_num(grade_median, nan=0.0).astype(np.uint8)
    m1 = first == 1
    value[m1] = grade_median[m1]
    grade_count = (stack == grade_median[None]).astype(np.int64)
    grade_count = (grade_count & is_grade).sum(axis=0)
    strength[m1] = grade_count[m1]

    # group 2: DCIS/LCIS
    m2 = first == 2
    value[m2] = 5
    strength[m2] = (stack == 5).sum(axis=0)[m2]
    return value, strength


def consensus_rois(lists_roi: list[list[tuple]], look_f: int) -> list[tuple]:
    """Merge per-annotator ROI lists into consensus ROIs
    (reference her2_utils.py:132-161). Output tuples carry an extra
    strength map: (file, offset, seg_png, sampling_png, strength_png, wsi_num)."""
    import cv2

    out = []
    for el in zip(*lists_roi):
        stack = np.stack([cv2.imdecode(t[2], cv2.IMREAD_ANYDEPTH) for t in el], axis=0)
        value, strength = consensus_stack(stack)
        s = value.shape
        new_shape = (int(s[0] / look_f), int(s[1] / look_f))
        sampling = cv2.resize(value, new_shape, interpolation=cv2.INTER_NEAREST)
        out.append((el[0][0], el[0][1],
                    cv2.imencode(".png", value)[1],
                    cv2.imencode(".png", sampling)[1],
                    cv2.imencode(".png", strength)[1],
                    el[0][4]))
    return out
