"""The multiprocess loader of ``location.loader: grain``
(stedm_tpu_torch/data/worker_loader.py) with 2 worker processes, on tiny
Flowers and HER2 trees:

* its batches equal the threaded ``Loader``'s bit for bit at the shards
  (0, 2) and (1, 2) and unsharded, epochs 0 and 1, ``drop_last`` on and off,
  all from one set of persistent workers (the epoch reaches them);
* each item equals the JAX package's ``grain_loader._Source(...)[idx]`` (a
  plain object: no grain process runs) over the JAX copy of the dataset;
  grain's own order, contiguous shards and its own permutation, is not
  reproduced (ROADMAP §3);
* a HER2 dataset pickles, and reads the same items in a worker as the
  threaded loader does in this process.
"""

import pickle

import numpy as np
import pytest

import _port_helpers  # noqa: F401  (caps torch threads)
from _flowers_helpers import run_overrides, write_flowers_tree
from _her2_helpers import HER2_OVERRIDES, equal_items, fix_jax_mask_step, write_her2_tree

from stedm_tpu.config import compose as jcompose
from stedm_tpu.data.dm import DataModule as JDataModule
from stedm_tpu.data.grain_loader import _Source
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.data.dm import DataModule
from stedm_tpu_torch.data.loader import Loader
from stedm_tpu_torch.data.worker_loader import WorkerLoader

SEED = 3
GRAIN = ["location.loader=grain", "location.n_workers=2", "data.samples=7"]


@pytest.fixture(scope="module")
def flowers(tmp_path_factory):
    data = write_flowers_tree(tmp_path_factory.mktemp("data"))
    overrides = run_overrides(data, tmp_path_factory.mktemp("results")) + GRAIN
    dms = JDataModule(jcompose("config_diff", overrides)), DataModule(compose("config_diff",
                                                                              overrides))
    for dm in dms:
        dm.prepare_data()
        dm.setup()
    return dms


@pytest.fixture(scope="module")
def loaders(flowers):
    """The port's grain train loader (2 worker processes, kept for the module)
    and a threaded one over the same dataset."""
    loader = flowers[1].train_loader(seed=SEED)
    assert isinstance(loader, WorkerLoader) and loader.num_workers == 2
    yield loader, Loader(loader.dataset, loader.batch_size, shuffle=True, seed=SEED)
    loader.close()


@pytest.mark.parametrize("shard", [(0, 2), (1, 2), None], ids=["rank0", "rank1", "one"])
@pytest.mark.parametrize("drop_last", [True, False], ids=["drop", "keep"])
def test_batches_equal_the_threaded_loaders(loaders, shard, drop_last):
    workers, threads = loaders
    for loader in (workers, threads):
        loader.process_shard, loader.drop_last, loader.epoch = shard, drop_last, 0
    assert len(workers) == len(threads)
    for epoch in range(2):
        got, want = list(workers), list(threads)
        assert len(got) == len(want) == len(threads) > 0
        assert workers.epoch == threads.epoch == epoch + 1
        for g, w in zip(got, want):
            equal_items(g, w)


def test_items_equal_jax_grain_source(flowers):
    """Every item of the train dataset, epochs 0 and 1, through the workers
    one item a batch against ``_Source.__getitem__`` (the JAX sub-dataset:
    JAX's ConcatDataset hands no generator on, ROADMAP §3)."""
    jdm, pdm = flowers
    (jds,) = [m.train_dataset() for m in jdm.data_modules.values() if len(m.train_dataset())]
    (pds,) = [m.train_dataset() for m in pdm.data_modules.values() if len(m.train_dataset())]
    loader = WorkerLoader(pds, 1, shuffle=False, num_workers=2, seed=SEED, drop_last=False)
    try:
        for epoch in range(2):
            source = _Source(jds, SEED, epoch, takes_rng=True)
            got = list(loader)
            assert len(got) == len(source) == 7
            for idx, batch in enumerate(got):
                equal_items(tuple(b[0] if isinstance(b, np.ndarray) else tuple(c[0] for c in b)
                                  for b in batch), source[idx])
    finally:
        loader.close()


def test_her2_dataset_pickles_and_reads_the_same_in_a_worker(tmp_path, monkeypatch):
    fix_jax_mask_step(monkeypatch)
    tree = write_her2_tree(tmp_path / "her2")
    cfg = compose("config_diff", HER2_OVERRIDES + GRAIN[:2] + [
        "style_sampling=nearby", f"location.data_dir={tree}",
        f"location.result_dir={tmp_path / 'results'}"])
    dm = DataModule(cfg)
    dm.prepare_data()
    dm.setup()
    loader = dm.train_loader(seed=SEED)
    assert isinstance(loader, WorkerLoader)
    ds = loader.dataset
    copy = pickle.loads(pickle.dumps(ds))
    equal_items(copy.__getitem__(1, rng=np.random.default_rng(5)),
                ds.__getitem__(1, rng=np.random.default_rng(5)))
    threads = Loader(ds, loader.batch_size, shuffle=True, seed=SEED)
    try:
        got, want = list(loader), list(threads)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            equal_items(g, w)
    finally:
        loader.close()
