"""The port's CATCH data (stedm_tpu_torch/data/catch.py) against the JAX
package's on the miniature tree of tests/_her2_helpers.py (segmentations in
an HDF5 store): ``setup``'s splits and the anno/unanno split by subtype,
every dataset's ``__getitem__`` bit for bit on every field from the same
explicit generator (each style sampler; the CATCH multi-patch sampler's
jitter), ``h5_sample``, ``rasterize_wsi_chunked``, the train loader against
the JAX Loader over the JAX dataset, and the refusal of the EXACT pull."""

import numpy as np
import pytest

import _port_helpers  # noqa: F401  (caps torch threads)
from _flowers_helpers import jax_train_loader
from _her2_helpers import CATCH_OVERRIDES, equal_items as _equal, items as _items
from _her2_helpers import fix_jax_mask_step, write_catch_tree

import stedm_tpu.data.catch as jcatch
from stedm_tpu.config import compose as jcompose
from stedm_tpu.data.dm import DataModule as JDataModule
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.data import catch
from stedm_tpu_torch.data.dm import DataModule

SEED = 5


@pytest.fixture(scope="module", autouse=True)
def jax_mask_step():
    """JAX's datasets given the port's scale of a tissue-mask coordinate
    (ROADMAP §3), so that items can be held equal."""
    with pytest.MonkeyPatch.context() as mp:
        fix_jax_mask_step(mp)
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_catch_tree(tmp_path_factory.mktemp("catch"))


def _modules(tree, sampling: str, extra=()):
    overrides = CATCH_OVERRIDES + [f"location.data_dir={tree}", f"style_sampling={sampling}",
                                   "data/dataset=[catch_anno,catch_unanno]",
                                   "data.ratios=[1.0,1.0]", *extra]
    if sampling == "mp":
        overrides.append("style_sampling.num_patches=2")
    jdm = JDataModule(jcompose("config_diff", overrides))
    pdm = DataModule(compose("config_diff", overrides))
    for dm in (jdm, pdm):
        dm.prepare_data()
        dm.setup()
    return jdm, pdm


@pytest.fixture(scope="module", params=["none", "nearby", "mp"])
def modules(tree, request):
    return _modules(tree, request.param)


def test_setup_splits_by_subtype_equal_jax(modules):
    jdm, pdm = modules
    for name in ("catch_anno", "catch_unanno"):
        j, p = jdm.data_modules[name], pdm.data_modules[name]
        for lst in ("_list_train", "_list_val", "_list_test", "_list_unanno"):
            _equal(tuple(getattr(p, lst)), tuple(getattr(j, lst)))
    p = pdm.data_modules["catch_anno"]
    # one slide of each subtype stays annotated (class_train_samples 1); the
    # second Melanoma slide goes to the unannotated pool
    assert [el[-1] for el in p._list_train] == [0, 1]
    assert [el[-1] for el in p._list_unanno] == [5]
    assert [el[-1] for el in p._list_val] == [2, 3] and [el[-1] for el in p._list_test] == [4]


@pytest.mark.parametrize("split", ["train_dataset", "predict_dataset"])
def test_anno_items_bit_for_bit(modules, split):
    jdm, pdm = modules
    jds = getattr(jdm.data_modules["catch_anno"], split)()
    pds = getattr(pdm.data_modules["catch_anno"], split)()
    assert type(pds).__name__ == type(jds).__name__ and len(pds) == len(jds) == 6
    for g, w in zip(pds._global_sample_list, jds._global_sample_list):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(_items(pds, range(6), SEED), _items(jds, range(6), SEED)):
        _equal(g, w)


@pytest.mark.parametrize("split,n", [("val_dataset", 8), ("test_dataset", 30)])
def test_ordered_items_bit_for_bit(modules, split, n):
    jdm, pdm = modules
    jds = getattr(jdm.data_modules["catch_anno"], split)()
    pds = getattr(pdm.data_modules["catch_anno"], split)()
    assert len(pds) == len(jds) == n
    for i in range(n):
        _equal(pds[i], jds[i])


def test_unanno_items_bit_for_bit(modules):
    jdm, pdm = modules
    jds = jdm.data_modules["catch_unanno"].predict_dataset()
    pds = pdm.data_modules["catch_unanno"].predict_dataset()
    assert len(pds) == len(jds) == 6
    for g, w in zip(_items(pds, range(4), SEED), _items(jds, range(4), SEED)):
        _equal(g, w)


def test_train_loader_two_epochs_bit_for_bit(tree):
    jdm, pdm = _modules(tree, "mp", ["data.ratios=[1.0,0.0]"])
    want_loader, got_loader = jax_train_loader(jdm, SEED), pdm.train_loader(seed=SEED)
    assert len(got_loader) == len(want_loader) == 3
    for _ in range(2):
        for g, w in zip(list(got_loader), list(want_loader)):
            _equal(g, w)


def test_h5_sample_equals_jax(tree):
    import h5py

    from stedm_tpu.data import augment as jaugment
    from stedm_tpu.data.wsi import ArraySlide as JArraySlide
    from stedm_tpu_torch.data import augment
    from stedm_tpu_torch.data.wsi import ArraySlide

    path = tree / "catch_catch_anno"
    with h5py.File(path / "anno.hdf5", "r") as f:
        args = ((16, 24), 32, 2, (100, 120))
        got = catch.h5_sample(ArraySlide(str(path / "wsi" / "SCC_04.png")), f["3"], *args,
                              augment.base_transforms(32), np.random.default_rng(1))
        want = jcatch.h5_sample(JArraySlide(str(path / "wsi" / "SCC_04.png")), f["3"], *args,
                                jaugment.base_transforms(32), np.random.default_rng(1))
    _equal(got, want)


def test_rasterize_wsi_chunked_equals_jax(tmp_path):
    import h5py

    rng = np.random.default_rng(2)
    conts = []
    for value in (0, 3, 5):
        c = rng.uniform(100, 500, 2)
        conts.append((c + rng.uniform(-90, 90, (6, 2)), value))
    out = {}
    for name, mod in (("port", catch), ("jax", jcatch)):
        with h5py.File(tmp_path / f"{name}.hdf5", "w") as f:
            offset, samp = mod.rasterize_wsi_chunked(conts, f, "7", 16, chunk_size=256)
            out[name] = (offset, samp, f["7"][()])
    _equal(out["port"], out["jax"])
    assert out["port"][2].shape[0] % 256 == 0 and set(np.unique(out["port"][2])) <= {0, 3, 5}


def test_a_tree_that_is_not_staged_refuses_the_exact_pull(tmp_path):
    dm = DataModule(compose("config_diff", ["data=catch", f"location.data_dir={tmp_path}"]))
    with pytest.raises(NotImplementedError, match="EXACT server.*ROADMAP §1: the pull from an EXACT server"):
        dm.prepare_data()
    assert not any(tmp_path.iterdir())
