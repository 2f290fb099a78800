"""The port's WSI reader chain against the JAX package's, bit for bit: the
host library (stedm_tpu_torch/native.py, built with g++ from
csrc/host/*.cc) against ``stedm_tpu.native`` and against the numpy
versions; the async pool's order and ``wsi_sample_batch`` against single
reads; ``data/wsi.py`` (pyramids, ``wsi_sample`` at a level that exists and
at one that needs a block mean, white fill, ``tissue_mask``, ``sample``),
``utils/patch_handler.py`` and ``data/prep.py`` (``rasterize_rois``, the
consensus, ``consensus_rois``); and the build, which raises when g++
fails."""

import numpy as np
import pytest

import stedm_tpu.data.prep as jprep
import stedm_tpu.data.wsi as jwsi
from stedm_tpu import native as jnative
from stedm_tpu.utils.patch_handler import PatchHandlerMS as JPatchHandlerMS
from stedm_tpu_torch import native
from stedm_tpu_torch.data import augment, prep, wsi
from stedm_tpu_torch.data.native_pipeline import AsyncPatchPipeline
from stedm_tpu_torch.utils.patch_handler import PatchHandlerMS


@pytest.fixture(scope="module")
def level():
    return np.random.default_rng(0).integers(0, 256, (96, 112, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def slide_image():
    """A slide: white around a tissue block, odd sides (the pyramid pads)."""
    rng = np.random.default_rng(1)
    img = np.full((203, 257, 3), 255, np.uint8)
    img[30:170, 40:220] = rng.integers(20, 230, (140, 180, 3), dtype=np.uint8)
    return img


@pytest.mark.parametrize("k", [4, 5])
def test_consensus_native_equals_jax_and_numpy(k):
    stack = np.random.default_rng(k).integers(0, 7, (k, 40, 56)).astype(np.uint8)
    got = native.consensus_stack_native(stack)
    for want in (jnative.consensus_stack_native(stack), prep.consensus_stack_numpy(stack),
                 jprep.consensus_stack_numpy(stack)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(prep.consensus_stack(stack), got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("origin,fill", [((-5, 10), 255), ((30, -7), 0), ((-100, -100), 7),
                                         ((80, 100), 255)])
@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
def test_extract_patch_native_equals_jax(level, origin, fill, gray):
    img = level[..., 0] if gray else level
    got = native.extract_patch_native(img, *origin, 32, fill)
    np.testing.assert_array_equal(got, jnative.extract_patch_native(img, *origin, 32, fill))
    # the plain version: the crop of the image padded with the fill
    pad = [(200, 200), (200, 200)] + ([] if gray else [(0, 0)])
    big = np.pad(img, pad, constant_values=fill)
    y, x = origin[0] + 200, origin[1] + 200
    np.testing.assert_array_equal(got, big[y:y + 32, x:x + 32])


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_downscale_mean_native_equals_jax(level, factor):
    got = native.downscale_mean_native(level, factor)
    np.testing.assert_array_equal(got, jnative.downscale_mean_native(level, factor))
    h, w = level.shape[0] // factor * factor, level.shape[1] // factor * factor
    sums = level[:h, :w].astype(np.int64).reshape(h // factor, factor, w // factor, factor,
                                                  3).sum(axis=(1, 3))
    np.testing.assert_array_equal(got, sums // (factor * factor))


@pytest.mark.parametrize("y0,x0,down", [(10, 20, 1), (-9, 30, 2), (80, 100, 2), (-50, -60, 4),
                                        (7, 7, 3)])
def test_wsi_patch_native_equals_jax_and_numpy(level, y0, x0, down):
    got = native.wsi_patch_native(level, y0, x0, 16, down)
    np.testing.assert_array_equal(got, jnative.wsi_patch_native(level, y0, x0, 16, down))
    big = np.pad(level, [(300, 300), (300, 300), (0, 0)], constant_values=255)
    crop = big[y0 + 300:y0 + 300 + 16 * down, x0 + 300:x0 + 300 + 16 * down]
    want = wsi.downscale_local_mean(crop, (down, down)).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_async_pool_keeps_the_order_of_each_batch(level):
    rng = np.random.default_rng(2)
    pipe = AsyncPatchPipeline(n_workers=4)
    batches = [rng.integers(-10, 100, (24, 2)) for _ in range(6)]
    tickets = [pipe.submit(level, c, 16, 2) for c in batches]   # all in flight at once
    for coords, ticket in zip(batches, tickets):
        out = ticket.get()
        assert out.shape == (24, 16, 16, 3)
        for patch, (y0, x0) in zip(out, coords):
            np.testing.assert_array_equal(patch, native.wsi_patch_native(level, int(y0),
                                                                         int(x0), 16, 2))


@pytest.mark.parametrize("crop", [(203, 257), (200, 256)], ids=["odd", "even"])
def test_pyramid_equals_jax(slide_image, crop):
    """Odd sides are padded white (numpy); even ones take the host library."""
    image = np.ascontiguousarray(slide_image[:crop[0], :crop[1]])
    got, want = wsi.ArraySlide(image), jwsi.ArraySlide(image)
    assert got.level_downsamples == want.level_downsamples == [1.0, 2.0, 4.0, 8.0]
    assert got.level_dimensions == want.level_dimensions
    assert got.dimensions == want.dimensions == crop[::-1]
    for g, w in zip(got._levels, want._levels):
        np.testing.assert_array_equal(g, w)
    region = dict(location=(-20, 150), level=1, size=(70, 40))
    np.testing.assert_array_equal(got.read_region(**region), want.read_region(**region))


def test_open_slide_reads_by_content(slide_image, tmp_path):
    from PIL import Image

    Image.fromarray(slide_image).save(tmp_path / "77_HER2_IHC.svs", format="PNG")
    np.save(tmp_path / "s.npy", slide_image)
    for name in ("77_HER2_IHC.svs", "s.npy"):
        np.testing.assert_array_equal(wsi.open_slide(tmp_path / name)._levels[0], slide_image)
    # the JAX package reads the .png and .npy names the same way
    Image.fromarray(slide_image).save(tmp_path / "s.png")
    np.testing.assert_array_equal(wsi.open_slide(tmp_path / "s.png")._levels[2],
                                  jwsi.open_slide(str(tmp_path / "s.png"))._levels[2])


@pytest.mark.parametrize("b_scale", [1, 2, 4, 8, 16], ids=lambda b: f"scale{b}")
@pytest.mark.parametrize("pos", [(100, 128), (4, 4), (200, 250), (-30, 300)])
def test_wsi_sample_equals_jax_and_the_numpy_path(slide_image, b_scale, pos):
    """Scales 1-8 are pyramid levels; 16 needs a block mean of level 3.
    The corners reach past the slide (white fill)."""
    slide = wsi.ArraySlide(slide_image)
    got = wsi.wsi_sample(slide, (3, -5), 24, b_scale, pos)
    np.testing.assert_array_equal(got, jwsi.wsi_sample(jwsi.ArraySlide(slide_image), (3, -5),
                                                       24, b_scale, pos))
    np.testing.assert_array_equal(got, wsi.wsi_sample_reference(slide, (3, -5), 24, b_scale,
                                                                pos))
    assert wsi.wsi_sample_async(slide, (3, -5), 24, b_scale, pos).get().tobytes() == \
        got.tobytes()


def test_white_fill_outside_the_slide(slide_image):
    slide = wsi.ArraySlide(slide_image)
    np.testing.assert_array_equal(wsi.wsi_sample(slide, (0, 0), 16, 2, (-500, -500)), 255)
    half = wsi.wsi_sample(slide, (0, 0), 16, 1, (0, 0))      # origin at (-8, -8)
    np.testing.assert_array_equal(half[:8], 255)
    np.testing.assert_array_equal(half[8:, 8:], slide_image[:8, :8])


@pytest.mark.parametrize("b_scale", [2, 16])
def test_wsi_sample_batch_equals_single_reads_and_jax(slide_image, b_scale):
    rng = np.random.default_rng(3)
    positions = [(int(y), int(x)) for y, x in rng.integers(-30, 280, (12, 2))]
    slide = wsi.ArraySlide(slide_image)
    batch = wsi.wsi_sample_batch(slide, (2, 1), 20, b_scale, positions)
    assert batch.shape == (12, 20, 20, 3)
    np.testing.assert_array_equal(batch, jwsi.wsi_sample_batch(jwsi.ArraySlide(slide_image),
                                                               (2, 1), 20, b_scale, positions))
    for patch, pos in zip(batch, positions):
        np.testing.assert_array_equal(patch, wsi.wsi_sample(slide, (2, 1), 20, b_scale, pos))


@pytest.mark.parametrize("kernel", [16, 40, 48])
def test_tissue_mask_equals_jax(slide_image, kernel):
    got = wsi.tissue_mask(wsi.ArraySlide(slide_image), kernel)
    want = jwsi.tissue_mask(jwsi.ArraySlide(slide_image), kernel)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_sample_equals_jax(slide_image):
    import cv2

    seg = np.zeros((120, 120), np.uint8)
    seg[20:90, 30:100] = 3
    seg_png = cv2.imencode(".png", seg)[1]
    pair = {}
    for name, mod, aug in (("port", wsi, augment), ("jax", jwsi, None)):
        from stedm_tpu.data import augment as jaugment

        trans = (aug or jaugment).base_transforms(16)
        pair[name] = mod.sample(mod.ArraySlide(slide_image), (40, 50), seg_png, 16, 2, (60, 60),
                                trans, np.random.default_rng(5))
    for g, w in zip(pair["port"], pair["jax"]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(100, 130), (100, 130, 3), (64, 64)])
def test_patch_handler_round_trip_equals_jax(shape):
    img = np.random.default_rng(4).integers(0, 255, shape, dtype=np.uint8)
    got, want = PatchHandlerMS(shape, 32, 4), JPatchHandlerMS(shape, 32, 4)
    assert got.num_segs() == want.num_segs()
    for i in range(got.num_segs()):
        patch = got.get(img, i)
        np.testing.assert_array_equal(patch, want.get(img, i))
        np.testing.assert_array_equal(got.get(img, i, 2.0), want.get(img, i, 2.0))
        got.take(patch, i)
    np.testing.assert_array_equal(got.get_out_image(), img)


def _rois():
    rng = np.random.default_rng(6)
    label_dict = {"Background": 0, "HER2 1+": 2, "HER2 3+": 4, "DCIS": 5}
    rois = [dict(x1=10, y1=20, x2=90, y2=140), dict(x1=100, y1=0, x2=164, y2=64)]
    conts = []
    for i in range(6):
        c = rng.uniform(0, 160, 2)
        poly = c + rng.uniform(-30, 30, (5, 2))
        conts.append((poly, list(label_dict)[i % 4]))
    conts.append((np.zeros((0, 2)), "DCIS"))        # an empty polygon is skipped
    return rois, conts, label_dict


def _equal_tuples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def test_rasterize_rois_equals_jax():
    rois, conts, label_dict = _rois()
    got = prep.rasterize_rois(rois, conts, label_dict, 8, "slide_17.png")
    _equal_tuples(got, jprep.rasterize_rois(rois, conts, label_dict, 8, "slide_17.png"))
    assert got[0][4] == 17 and got[0][1] == (20, 10)


def test_consensus_rois_equals_jax():
    rois, conts, label_dict = _rois()
    rng = np.random.default_rng(7)
    lists = []
    for _ in range(3):      # three annotators' rasters of the same ROIs
        jittered = [(poly + rng.uniform(-6, 6, poly.shape), lbl) for poly, lbl in conts]
        lists.append(prep.rasterize_rois(rois, jittered, label_dict, 8, "slide_17.png"))
    _equal_tuples(prep.consensus_rois(lists, 8), jprep.consensus_rois(lists, 8))


def test_host_library_build_raises_when_gpp_fails(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libx.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build()
    assert not (tmp_path / "libx.so").exists()


def test_host_library_is_rebuilt_when_a_source_is_newer(tmp_path, monkeypatch):
    import os
    import shutil

    srcs = []
    for s in native.SOURCES:
        srcs.append(tmp_path / s.name)
        shutil.copy(s, srcs[-1])
    monkeypatch.setattr(native, "SOURCES", tuple(srcs))
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "lib" / "libstedm_host.so")
    assert native._stale()
    native.build()
    assert not native._stale()
    t = native.LIB_PATH.stat().st_mtime
    os.utime(srcs[1], (t + 10, t + 10))
    assert native._stale()
