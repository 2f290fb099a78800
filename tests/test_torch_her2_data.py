"""The port's HER2 data (stedm_tpu_torch/data/her2.py) against the JAX
package's on the miniature tree of tests/_her2_helpers.py: ``setup``'s
splits, folds and anno/unanno binning, the scoring list read with ``csv``
against pandas' rows, every dataset's ``__getitem__`` bit for bit on every
field from the same explicit generator (each style sampler), the train
loader against the JAX Loader over the JAX dataset, the ordered loaders,
the syn module, and the refusal of the EXACT pull."""

import numpy as np
import pytest

import _port_helpers  # noqa: F401  (caps torch threads)
from _flowers_helpers import jax_train_loader
from _her2_helpers import HER2_OVERRIDES, equal_items as _equal, items as _items
from _her2_helpers import fix_jax_mask_step, write_her2_tree, write_syn_folder

from stedm_tpu.config import compose as jcompose
from stedm_tpu.data.dm import DataModule as JDataModule
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.data import her2
from stedm_tpu_torch.data.dm import DataModule

SEED = 4
SAMPLERS = ["none", "nearby", "mp"]


@pytest.fixture(scope="module", autouse=True)
def jax_mask_step():
    """JAX's datasets given the port's scale of a tissue-mask coordinate
    (ROADMAP §3), so that items can be held equal."""
    with pytest.MonkeyPatch.context() as mp:
        fix_jax_mask_step(mp)
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = write_her2_tree(tmp_path_factory.mktemp("her2"))
    write_syn_folder(root, "her2")
    return root


def _overrides(tree, sampling: str, extra=()):
    out = HER2_OVERRIDES + [f"location.data_dir={tree}", f"style_sampling={sampling}",
                            "data/dataset=[her2_anno,her2_unanno]", "data.ratios=[1.0,1.0]",
                            *extra]
    if sampling == "mp":
        out.append("style_sampling.num_patches=3")
    return out


def _modules(tree, sampling: str, extra=()):
    overrides = _overrides(tree, sampling, extra)
    jdm = JDataModule(jcompose("config_diff", overrides))
    pdm = DataModule(compose("config_diff", overrides))
    for dm in (jdm, pdm):
        dm.prepare_data()
        dm.setup()
    return jdm, pdm


@pytest.fixture(scope="module", params=SAMPLERS)
def modules(tree, request):
    return _modules(tree, request.param)


def test_setup_splits_folds_and_bins_equal_jax(modules):
    jdm, pdm = modules
    j, p = jdm.data_modules["her2_anno"], pdm.data_modules["her2_anno"]
    for name in ("_list_train", "_list_val", "_list_test", "_list_unanno"):
        _equal(tuple(getattr(p, name)), tuple(getattr(j, name)))
    # fold 102 is val; 101 and 102 bin to score class 0 and the first ROI
    # list of 12 keeps both of 101's ROIs in train
    assert [el[-1] for el in p._list_val] == [102, 102]
    assert [el[-1] for el in p._list_train] == [101, 101]
    assert [el[-1] for el in p._list_test] == [103, 103]


@pytest.mark.parametrize("split", ["train_dataset", "predict_dataset"])
def test_anno_items_bit_for_bit(modules, split):
    jdm, pdm = modules
    jds = getattr(jdm.data_modules["her2_anno"], split)()
    pds = getattr(pdm.data_modules["her2_anno"], split)()
    assert type(pds).__name__ == type(jds).__name__ and len(pds) == len(jds) == 6
    for i in range(2):
        assert pds._global_sample_list[i].__len__() == jds._global_sample_list[i].__len__()
    for g, w in zip(pds.style_samp_list, jds.style_samp_list):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(_items(pds, range(6), SEED), _items(jds, range(6), SEED)):
        _equal(g, w)


@pytest.mark.parametrize("split", ["val_dataset", "test_dataset"])
def test_ordered_items_bit_for_bit_with_cut_margins(modules, split):
    jdm, pdm = modules
    jds = getattr(jdm.data_modules["her2_anno"], split)()
    pds = getattr(pdm.data_modules["her2_anno"], split)()
    assert len(pds) == len(jds) == 18       # 2 ROIs x 3 x 3 tiles
    got, want = [pds[i] for i in range(len(pds))], [jds[i] for i in range(len(jds))]
    for g, w in zip(got, want):
        _equal(g, w)
    cuts = {g[3] for g in got}
    assert (0, 0) in cuts and any(c[0] > 0 for c in cuts) and any(c[1] > 0 for c in cuts)


def test_unanno_items_bit_for_bit(modules):
    jdm, pdm = modules
    jds = jdm.data_modules["her2_unanno"].predict_dataset()
    pds = pdm.data_modules["her2_unanno"].predict_dataset()
    # the slide ID stays the text of its cell (pandas makes a numeric column
    # int); it is a cache key and a label, never part of an item
    assert [(*t[:4], str(t[4])) for t in jds._ds_list] == pds._ds_list
    assert [(str(t[0]), *t[1:]) for t in jds.slide_info] == pds.slide_info
    for g, w in zip(_items(pds, range(4), SEED), _items(jds, range(4), SEED)):
        _equal(g, w)


def test_unanno_centres_lie_on_the_tissue(tree):
    """The scoring slides' tissue-mask coordinates scaled by the mask's step
    fall on the tissue block of tests/_her2_helpers.py; scaled by
    ``kernel_size``, as the JAX package does, most fall off the slide, where
    a read is white fill (ROADMAP §3)."""
    from _her2_helpers import SLIDE_HW

    from stedm_tpu_torch.data.wsi import open_slide, wsi_sample

    _, pdm = _modules(tree, "nearby")
    ds = pdm.data_modules["her2_unanno"].predict_dataset()
    assert ds._mask_steps == [12, 12] and ds.kernel_size == 48   # level 2 is 4x: 4 * 48 // 16
    for coords, (path, *_) in zip(ds._sample_list, ds._ds_list):
        slide = open_slide(path)
        for scale, on_tissue in ((12, True), (ds.kernel_size, False)):
            centres = (coords[:, :2] + 0.5) * scale
            inside = ((centres < SLIDE_HW).all(1)).mean()
            white = np.mean([(wsi_sample(slide, (0, 0), 32, 2, c).min(-1) >= 253).mean()
                             for c in centres[::7]])
            if on_tissue:
                assert inside == 1.0 and white < 0.25, (inside, white)
            else:
                assert inside < 0.5 and white > 0.5, (inside, white)


def test_two_epochs_register_each_slide_once(tree):
    """The loader's threads share one copy of each slide: a second epoch, run
    on new threads, registers no pyramid level with the host library's pool
    (whose registrations live as long as the process)."""
    from stedm_tpu_torch.data.native_pipeline import global_pipeline

    _, pdm = _modules(tree, "nearby", ["data.ratios=[1.0,0.0]"])
    loader = pdm.train_loader(seed=SEED)
    assert loader.num_workers == 2
    sizes = []
    for _ in range(2):
        assert len(list(loader)) == 3
        sizes.append(len(global_pipeline()._images))
    assert sizes[0] == sizes[1]
    ds = pdm.data_modules["her2_anno"].train_dataset()
    assert len(ds._slides._slides) == 1      # slide 101 holds both train ROIs


def test_predict_pairs_layouts_with_unannotated_styles(modules):
    """The predict loader: annotated layouts with styles from the scoring
    slides, bit for bit (the Loader hands its generator to PredictDataset)."""
    jdm, pdm = modules
    want, got = list(jdm.predict_loader()), list(pdm.predict_loader())
    assert len(got) == len(want) == 3   # 6 pairs, batch 2
    for g, w in zip(got, want):
        assert len(g) == 5
        _equal(g, w)


def test_train_loader_two_epochs_bit_for_bit(tree):
    jdm, pdm = _modules(tree, "nearby", ["data.ratios=[1.0,0.0]"])
    want_loader, got_loader = jax_train_loader(jdm, SEED), pdm.train_loader(seed=SEED)
    assert len(got_loader) == len(want_loader) == 3
    for _ in range(2):
        for g, w in zip(list(got_loader), list(want_loader)):
            _equal(g, w)


@pytest.mark.parametrize("split", ["val_loader", "test_loader"])
def test_ordered_loaders_bit_for_bit(tree, split):
    jdm, pdm = _modules(tree, "nearby", ["data.ratios=[1.0,0.0]"])
    want, got = list(getattr(jdm, split)()), list(getattr(pdm, split)())
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        _equal(g, w)


def test_syn_module_bit_for_bit(tree):
    overrides = HER2_OVERRIDES + [f"location.data_dir={tree}", "style_sampling=none",
                                  "data/dataset=[her2_anno,her2_syn]", "data.ratios=[0.0,1.0]"]
    jdm = JDataModule(jcompose("config_seg", overrides))
    pdm = DataModule(compose("config_seg", overrides))
    for dm in (jdm, pdm):
        dm.setup()
    jds = jdm.data_modules["her2_syn"].train_dataset()
    pds = pdm.data_modules["her2_syn"].train_dataset()
    assert len(pds) == len(jds) > 0
    for g, w in zip(_items(pds, range(4), SEED), _items(jds, range(4), SEED)):
        _equal(g, w)


def _pandas_rows(list_file, data_dir):
    """The rows JAX's HER2_DM_UnAnno.setup selects (her2.py:515-528)."""
    import os

    import pandas as pd

    rows = []
    for _, row in pd.read_csv(list_file, sep=";").iterrows():
        if str(row["HERIHCScore"]) != "nan" and str(row.get("USE")) == "nan":
            path = f"{data_dir}/{row['Tumorblock_ID']}_HER2_IHC.svs"
            if os.path.isfile(path):
                rows.append((path, int(str(row["HERIHCScore"])[0]), str(row["Tumorblock_ID"])))
    return rows


@pytest.mark.parametrize("text", [
    None,   # the tree's list: empty USE cells, an excluded row, a 2+ score
    "Tumorblock_ID;HERIHCScore;USE\n5001;2;\n5002;NA;\n5004;3+;nan\n",
    "Tumorblock_ID;HERIHCScore;USE\n5001;1+;\n5002;2;N/A\n5003;3;1\n",
    "Tumorblock_ID;HERIHCScore\n5001;2\n5002;3\n",     # no USE column: none kept
], ids=["tree", "na_cells", "excluded", "no_use_column"])
def test_score_list_rows_equal_pandas(tree, tmp_path, text):
    list_file = tree / "all_wsi_scores.csv"
    if text is not None:
        list_file = tmp_path / "scores.csv"
        list_file.write_text(text)
    got = [(r["File Path"], r["HER2 Score"], r["Slide ID"])
           for r in her2.read_score_list(str(list_file), f"{tree}/scoring_wsi")]
    assert got == _pandas_rows(list_file, f"{tree}/scoring_wsi")
    if text is None:
        assert [r[1:] for r in got] == [(2, "5001"), (3, "5002")]


def test_a_tree_that_is_not_staged_refuses_the_exact_pull(tmp_path):
    dm = DataModule(compose("config_diff", ["data=her2", f"location.data_dir={tmp_path}"]))
    with pytest.raises(NotImplementedError, match="EXACT server.*ROADMAP §1: the pull from an EXACT server"):
        dm.prepare_data()
    assert not any(tmp_path.iterdir())


def test_a_staged_tree_is_zipped_once(tree, tmp_path):
    import shutil

    data = tmp_path / "data"
    shutil.copytree(tree / "her2_anno_her2_anno", data / "her2_anno_her2_anno")
    dm = DataModule(compose("config_diff", HER2_OVERRIDES + [f"location.data_dir={data}"]))
    dm.prepare_data()
    assert (data / "her2_anno_her2_anno.zip").is_file()
    shutil.rmtree(data / "her2_anno_her2_anno")
    dm = DataModule(compose("config_diff", HER2_OVERRIDES + [f"location.data_dir={data}"]))
    dm.prepare_data()
    dm.setup()      # unpacks the zip
    assert len(dm.data_modules["her2_anno"]._list_train) == 2


def test_jax_score_list_drops_every_slide_of_an_all_numeric_list(tree, tmp_path):
    """Found in the JAX package (ROADMAP §3): when every column of the list
    is numeric (scores without a ``+``, ``USE`` empty), pandas' ``iterrows``
    hands each row over as floats, the slide's file name becomes
    ``5001.0_HER2_IHC.svs`` and no slide is found. The port reads the cells
    as text and keeps them."""
    list_file = tmp_path / "scores.csv"
    list_file.write_text("Tumorblock_ID;HERIHCScore;USE\n5001;2;\n5002;3;\n5003;1;1\n")
    got = her2.read_score_list(str(list_file), f"{tree}/scoring_wsi")
    assert [(r["HER2 Score"], r["Slide ID"]) for r in got] == [(2, "5001"), (3, "5002")]
    assert _pandas_rows(list_file, f"{tree}/scoring_wsi") == []
