"""The port's segmentation losses and confusion matrices
(stedm_tpu_torch/utils/metrics.py) against stedm_tpu/utils/metrics.py, function
by function, on the same numpy-seeded inputs. Losses within 1e-6 relative
(fp32 on both sides, sums in other orders); confusion matrices, masks and the
numpy functions equal exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_helpers  # noqa: F401  (caps torch threads)

from stedm_tpu.utils import metrics as J
from stedm_tpu_torch.utils import metrics as M

LOSS_RTOL = 1e-6


def _probs_and_targets(seed: int, classes: int, shape=(2, 9, 7)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (*shape, classes)).astype(np.float32)
    labels = rng.integers(0, classes, shape)
    one_hot = np.eye(classes, dtype=np.float32)[labels]
    return logits, one_hot, labels


@pytest.mark.parametrize("classes", [2, 3, 5])
def test_dice_loss(classes):
    logits, one_hot, _ = _probs_and_targets(classes, classes)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = float(J.dice_loss(jnp.asarray(probs), jnp.asarray(one_hot)))
    got = float(M.dice_loss(torch.from_numpy(probs), torch.from_numpy(one_hot)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("classes", [2, 4])
def test_cross_entropy(classes):
    logits, one_hot, _ = _probs_and_targets(10 + classes, classes)
    want = float(J.cross_entropy(jnp.asarray(logits), jnp.asarray(one_hot)))
    got = float(M.cross_entropy(torch.from_numpy(logits), torch.from_numpy(one_hot)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("ratios", [(0.1, 0.9), (1.0, 0.0), (0.5, 2.0)])
def test_seg_loss(ratios):
    logits, one_hot, _ = _probs_and_targets(20, 2)
    kw = dict(ce_ratio=ratios[0], dice_ratio=ratios[1])
    want = float(J.seg_loss(jnp.asarray(logits), jnp.asarray(one_hot), **kw))
    got = float(M.seg_loss(torch.from_numpy(logits), torch.from_numpy(one_hot), **kw))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_seg_loss_in_bf16_is_computed_in_fp32():
    """bf16 logits are upcast first, as the JAX loss upcasts them."""
    logits, one_hot, _ = _probs_and_targets(21, 2)
    lb = torch.from_numpy(logits).bfloat16()
    want = float(J.seg_loss(jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
                            jnp.asarray(one_hot)))
    got = M.seg_loss(lb, torch.from_numpy(one_hot))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("classes,masked", [(2, False), (2, True), (3, False), (3, True)])
def test_confusion_matrix(classes, masked):
    rng = np.random.default_rng(30 + classes)
    pred = rng.integers(0, 2, (3, 11, 13))
    label = rng.integers(0, classes, (3, 11, 13))
    mask = rng.uniform(size=(3, 11, 13)) > 0.3 if masked else None
    want = np.asarray(J.confusion_matrix(jnp.asarray(pred), jnp.asarray(label), classes,
                                         mask=None if mask is None else jnp.asarray(mask)))
    got = M.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), classes,
                             mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (classes, classes)
    np.testing.assert_array_equal(got.numpy(), want)


def test_confusion_matrix_per_sample_is_the_vmap_of_the_jax_function():
    rng = np.random.default_rng(40)
    pred = rng.integers(0, 2, (4, 8, 8))
    label = rng.integers(0, 3, (4, 8, 8))
    mask = rng.uniform(size=(4, 8, 8)) > 0.5
    got = M.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), 3,
                             mask=torch.from_numpy(mask), per_sample=True)
    want = np.stack([np.asarray(J.confusion_matrix(jnp.asarray(p), jnp.asarray(lbl), 3,
                                                   mask=jnp.asarray(m)))
                     for p, lbl, m in zip(pred, label, mask)])
    assert got.shape == (4, 3, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_confusion_matrix_counts_a_512_batch_of_2_exactly():
    """One 512^2 batch of 2 (524,288 pixels) in one fp32 cell: exact."""
    pred = torch.zeros(2, 512, 512, dtype=torch.long)
    cm = M.confusion_matrix(pred, pred, 2)
    assert cm[0, 0].item() == 2 * 512 * 512 and cm.sum().item() == 2 * 512 * 512


@pytest.mark.parametrize("overlap,cuts", [(0, ((0, 0), (0, 0))), (1, ((0, 2), (1, 0))),
                                          (3, ((4, 1), (0, 5)))])
def test_border_mask(overlap, cuts):
    cut_y, cut_x = np.array(cuts[0]), np.array(cuts[1])
    want = np.asarray(J.border_mask((16, 12), overlap, jnp.asarray(cut_y), jnp.asarray(cut_x)))
    got = M.border_mask((16, 12), overlap, torch.from_numpy(cut_y), torch.from_numpy(cut_x))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


_CMS = [np.array([[50, 5, 0], [4, 20, 1], [2, 3, 15]], dtype=float),
        np.array([[10, 2], [3, 7]], dtype=float),
        np.array([[0, 0, 0, 0], [1, 2, 0, 0], [0, 3, 4, 0], [5, 0, 0, 6]], dtype=float),
        np.zeros((3, 3))]


@pytest.mark.parametrize("cm", _CMS, ids=["3x3", "2x2", "4x4", "empty"])
@pytest.mark.parametrize("fn", ["calc_iou_scores", "calc_dice_score", "combined_tumor_cm",
                                "tumor_iou", "subtype_variance"])
def test_numpy_functions_are_copies(fn, cm):
    np.testing.assert_array_equal(getattr(M, fn)(cm), getattr(J, fn)(cm))


def test_confusion_matrix_png_draws_every_cell(tmp_path):
    """The PIL figure (the H100 machine has no matplotlib): one PNG, each
    cell's colour darker as its value grows, the largest the darkest."""
    from PIL import Image

    cm = np.array([[0.9, 0.1], [0.3, 0.7], [0.5, 0.5]])
    path = tmp_path / "val_cm_3.png"
    M.confusion_matrix_png(cm, ["BG", "Tumor"], ["BG", "A", "B"], path, title="Val Conf Matrix")
    img = np.asarray(Image.open(path).convert("RGB")).astype(int)
    left, top, cell = 12 + 7 * 2 + 16, 40, 72
    corner = lambda i, j: img[top + i * cell + 3, left + j * cell + 3]
    shade = {(i, j): corner(i, j).sum() for i in range(3) for j in range(2)}
    order = sorted(shade, key=shade.get)
    assert order[0] == (0, 0) and order[-1] == (0, 1)
    assert shade[(1, 1)] < shade[(2, 0)] < shade[(1, 0)]
