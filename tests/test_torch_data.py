"""The port's copy of the data pipeline (stedm_tpu_torch/data/) against the
JAX package's on a tiny generated Flowers tree: the batches of every loader,
bit for bit in every field, and batch_to_ldm; the repaired generator
hand-over of ConcatDataset; an unstaged HER2 or CATCH tree raises, and
``location.loader=grain`` builds the worker-process loader."""

import numpy as np
import pytest
import torch

import _port_helpers  # noqa: F401  (caps torch threads)
from _port_helpers import check_grain_loader
from _flowers_helpers import jax_train_loader, run_overrides, write_flowers_tree

from stedm_tpu.config import compose as jcompose
from stedm_tpu.data.dm import DataModule as JDataModule
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.data.dm import DataModule
from stedm_tpu_torch.data.prefetch import prefetch_to_device
from stedm_tpu_torch.train_diff import batch_to_ldm

SEED = 3


@pytest.fixture(scope="module")
def modules(tmp_path_factory):
    data = write_flowers_tree(tmp_path_factory.mktemp("data"))
    overrides = run_overrides(data, tmp_path_factory.mktemp("results")) + [
        "location.n_workers=2", "data.samples=6"]
    jdm = JDataModule(jcompose("config_predict", overrides))
    pdm = DataModule(compose("config_predict", overrides))
    for dm in (jdm, pdm):
        dm.prepare_data()
        dm.setup()
    return jdm, pdm


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _equal(g, w)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_train_loader_two_epochs_bit_for_bit(modules):
    jdm, pdm = modules
    want_loader, got_loader = jax_train_loader(jdm, SEED), pdm.train_loader(seed=SEED)
    assert len(got_loader) == len(want_loader) == 3
    for _ in range(2):
        want, got = list(want_loader), list(got_loader)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _equal(g, w)
    # and a second loader from the same seed replays them
    again = pdm.train_loader(seed=SEED)
    for g, w in zip(list(again), list(jax_train_loader(jdm, SEED))):
        _equal(g, w)


def test_jax_train_loader_ignores_its_seed(modules):
    """The fault the port's ConcatDataset repairs (ROADMAP §3): JAX's
    ConcatDataset takes no generator, so its train items come from unseeded
    draws and two loaders with one seed differ (over an epoch: the first
    batches alone, a few draws from a few images, can coincide)."""
    jdm, _ = modules
    a, b = list(jdm.train_loader(seed=SEED)), list(jdm.train_loader(seed=SEED))
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))


@pytest.mark.parametrize("split", ["predict_loader", "val_loader", "test_loader"])
def test_ordered_loaders_bit_for_bit(modules, split):
    jdm, pdm = modules
    want, got = list(getattr(jdm, split)()), list(getattr(pdm, split)())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _equal(g, w)


def test_batch_to_ldm_and_the_cpu_prefetch(modules):
    from train_diff import batch_to_ldm as jbatch_to_ldm

    jdm, pdm = modules
    batch = next(iter(pdm.predict_loader()))
    want = jbatch_to_ldm(next(iter(jdm.predict_loader())))
    got = batch_to_ldm(batch)
    assert got.keys() == want.keys()
    for k in want:
        _equal([got[k]], [want[k]])
    out = list(prefetch_to_device([batch, batch, batch], size=2, transform=batch_to_ldm,
                                  device="cpu"))
    assert len(out) == 3
    for b in out:
        for k in want:
            assert isinstance(b[k], torch.Tensor)
            np.testing.assert_array_equal(b[k].numpy(), want[k])


@pytest.mark.parametrize("overrides,match", [
    (["data=her2"], "EXACT server.*ROADMAP §1: the pull from an EXACT server"),
    (["data=catch"], "EXACT server.*ROADMAP §1: the pull from an EXACT server"),
    (["location.loader=grain"], None),
], ids=["her2", "catch", "grain"])
def test_unported_data_modules_raise(overrides, match, tmp_path, modules):
    """HER2 and CATCH, ported, refuse the pull from an EXACT server when no
    tree or zip is staged. The grain loader, once refused, is the
    worker-process loader (match None), on the Flowers tree."""
    if match is None:
        loc = modules[1]._cfg.location
        dm = DataModule(compose("config_diff", run_overrides(loc.data_dir, loc.result_dir)
                                + overrides + ["location.n_workers=2", "data.samples=6"]))
        dm.prepare_data()
        dm.setup()
        check_grain_loader(dm, SEED)
        return
    with pytest.raises(NotImplementedError, match=match):
        DataModule(compose("config_diff", overrides + [f"location.data_dir={tmp_path}"])
                   ).prepare_data()
