"""Segmentation losses and confusion-matrix metrics (stedm_tpu/utils/metrics.py).

The loss and the confusion matrices work on tensors (NHWC, as the JAX
package's); the functions that read a finished matrix (IoU, Dice, the
tumor-collapsed matrix, the subtype variance) are numpy copies of the JAX
package's.

A confusion matrix is ``[C, C]`` fp32, rows true and columns predicted,
summed by ``index_add_`` as JAX's scatter-add sums it (``bincount`` would
read its maximum back to the host, a sync every step): fp32 counts are
exact while a cell stays under 2^24 (one 512^2 batch of 2 is 524,288
pixels).

``confusion_matrix_png`` draws the normalised matrix with PIL: the JAX
package's ``plot_confusion_matrix`` uses matplotlib, which the H100 machine
lacks. The same cells, labels and title.
"""

from __future__ import annotations

import numpy as np
import torch


def dice_loss(probs: torch.Tensor, one_hot: torch.Tensor, eps: float = 0.01) -> torch.Tensor:
    """Soft Dice over (batch, H, W) per class, averaged over classes 1..C-1
    (reference modules/utils.py:8-18). Inputs are NHWC."""
    dims = (0, 1, 2)
    probs, one_hot = probs.float(), one_hot.float()
    intersection = (probs * one_hot).sum(dims)
    dice = (2 * intersection + eps) / (one_hot.sum(dims) + probs.sum(dims) + eps)
    return (1.0 - dice[1:]).mean()


def cross_entropy(logits: torch.Tensor, one_hot: torch.Tensor) -> torch.Tensor:
    """torch CrossEntropyLoss with probability targets: mean over pixels of
    -sum_c p_c log softmax_c (reference modules/segmentation.py:45-47)."""
    log_softmax = torch.log_softmax(logits.float(), dim=-1)
    return -(one_hot.float() * log_softmax).sum(-1).mean()


def seg_loss(logits: torch.Tensor, one_hot: torch.Tensor, *, ce_ratio: float = 0.1,
             dice_ratio: float = 0.9) -> torch.Tensor:
    """ce_ratio * CE + dice_ratio * Dice(softmax) (reference segmentation.py:44-47)."""
    probs = torch.softmax(logits.float(), dim=-1)
    return ce_ratio * cross_entropy(logits, one_hot) + dice_ratio * dice_loss(probs, one_hot)


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, num_classes: int,
                     mask: torch.Tensor | None = None, *, per_sample: bool = False
                     ) -> torch.Tensor:
    """``[C, C]`` confusion matrix (rows true, columns predicted), counting
    only the pixels where ``mask`` holds. ``per_sample=True`` gives one
    matrix for each sample of the leading axis, ``[B, C, C]`` (the JAX eval
    step's ``vmap``)."""
    c2 = num_classes * num_classes
    idx = label.long() * num_classes + pred.long()
    bins = c2
    if per_sample:
        b = idx.shape[0]
        idx = idx + c2 * torch.arange(b, device=idx.device).view(b, *[1] * (idx.dim() - 1))
        bins = b * c2
    weights = (torch.ones(idx.shape, dtype=torch.float32, device=idx.device) if mask is None
               else mask.to(torch.float32).expand(idx.shape))
    flat = torch.zeros(bins, dtype=torch.float32, device=idx.device).index_add_(
        0, idx.reshape(-1), weights.reshape(-1))
    return flat.view(-1, num_classes, num_classes) if per_sample \
        else flat.view(num_classes, num_classes)


def border_mask(shape: tuple[int, int], overlap: int, cut_y: torch.Tensor,
                cut_x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W]`` validity mask equal to the reference's crop
    ``[o:-(o+c_y), o:-(o+c_x)]`` (segmentation.py:108-114), per sample."""
    h, w = shape
    dev = cut_y.device
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    cy = cut_y.long()[:, None, None]
    cx = cut_x.long()[:, None, None]
    return ((rows >= overlap) & (rows < h - overlap - cy)
            & (cols >= overlap) & (cols < w - overlap - cx))


def calc_iou_scores(cm: np.ndarray) -> np.ndarray:
    """(reference modules/utils.py:33-40)"""
    tp = np.diag(cm)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    return tp / (tp + fp + fn + 1e-10)


def calc_dice_score(cm: np.ndarray) -> np.ndarray:
    """(reference modules/utils.py:21-30)"""
    dices = np.zeros((cm.shape[0],))
    tp = np.diagonal(cm)
    sum_pred = cm.sum(axis=0)
    sum_gt = cm.sum(axis=1)
    valid = sum_gt > 0
    dices[valid] = 2 * tp[valid] / (sum_gt[valid] + sum_pred[valid])
    return dices


def combined_tumor_cm(cm: np.ndarray) -> np.ndarray:
    """Collapse all tumor classes into one (reference segmentation.py:144-152):
    row 1 becomes the sum of rows 1.., then take the 2x2 corner."""
    comb = np.array(cm, copy=True)
    comb[1] = comb[1:].sum(axis=0)
    return comb[:2, :2]


def tumor_iou(cm: np.ndarray) -> float:
    return float(calc_iou_scores(combined_tumor_cm(cm))[1])


def subtype_variance(cm: np.ndarray) -> float:
    """Variance of the tumor-detection rate across subtype rows
    (reference segmentation.py:155-156)."""
    norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1e-10)
    return float(np.var(norm[1:-1, 1])) if cm.shape[0] > 2 else 0.0


def confusion_matrix_png(cm: np.ndarray, class_names_x, class_names_y, path,
                         title: str = "Confusion matrix") -> None:
    """The JAX package's ``plot_confusion_matrix`` figure drawn with PIL:
    white-to-blue cells of 72 pixels, each value rounded to 3 decimals
    (white text on the darker half), the class names on the axes, the title
    above; saved as PNG."""
    from PIL import Image, ImageDraw, ImageFont

    cell = 72
    font = ImageFont.load_default()
    rows, cols = cm.shape
    left, top = 12 + 7 * max(len(str(n)) for n in class_names_y) + 16, 40
    width, height = left + cols * cell + 20, top + rows * cell + 44
    img = Image.new("RGB", (width, height), "white")
    draw = ImageDraw.Draw(img)
    draw.text((left, 10), title, fill="black", font=font)
    vals = np.around(cm, decimals=3)
    vmax = float(vals.max()) if vals.size and vals.max() > 0 else 1.0
    threshold = vals.max() / 2.0 if vals.size else 0.5
    for i in range(rows):
        for j in range(cols):
            f = float(vals[i, j]) / vmax
            colour = tuple(int(round(255 + f * (c - 255))) for c in (8, 48, 107))
            x0, y0 = left + j * cell, top + i * cell
            draw.rectangle([x0, y0, x0 + cell - 1, y0 + cell - 1], fill=colour)
            text = f"{vals[i, j]:g}"
            draw.text((x0 + cell // 2 - 3 * len(text), y0 + cell // 2 - 5), text,
                      fill="white" if vals[i, j] > threshold else "black", font=font)
    for i, name in enumerate(class_names_y):
        draw.text((12, top + i * cell + cell // 2 - 5), str(name), fill="black", font=font)
    for j, name in enumerate(class_names_x):
        draw.text((left + j * cell + 4, top + rows * cell + 4), str(name), fill="black",
                  font=font)
    draw.text((left, height - 16), "Predicted label (rows: true label)", fill="black",
              font=font)
    img.save(path)
