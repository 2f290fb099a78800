"""The multiprocess loader of ``location.loader: grain``: the same datasets
in worker processes (the counterpart of stedm_tpu/data/grain_loader.py).

The threaded ``Loader`` shares one interpreter and its GIL between the
items it decodes; the reference's torch ``DataLoader`` gives every worker a
process (reference data/dm.py:49-87). The JAX package gets processes from
grain, which the port cannot use (``grain.python`` imports jax). Here a
``torch.utils.data.DataLoader`` runs the items in ``num_workers`` processes
over a batch sampler that yields exactly the threaded ``Loader``'s batches:
its permutation, its rank-interleaved wrap-padded shard and ``drop_last``
(``Loader._indices``). Each item is drawn with
``np.random.default_rng((seed, epoch, idx))`` (grain_loader.py:27-44), so
the batches equal the threaded loader's bit for bit. (Grain's own order,
contiguous shards and its own permutation, differs; ROADMAP §3.)

* Workers start from a ``forkserver``: the parent may hold a CUDA context and
  the host library's pool threads, which a fork of it would copy
  half-alive; the server is a fresh interpreter that imports torch and the
  data modules once (``PRELOAD``), and each worker forks from it. (Under
  ``spawn`` each worker imports torch before it can read its pickled
  dataset, and the parent starts them one after another: ~3 s a worker.)
  So the dataset pickles: a HER2 or CATCH slide cache arrives empty and each
  worker opens its slides lazily and builds its own host-library pool
  (``_init_worker``).
* The workers persist across epochs. The sampler runs in the parent and
  hands every index over with its epoch, so the epoch reaches them.
* A worker collates its batch and returns the numeric arrays as tensors,
  which travel through shared memory; the parent turns them back into numpy.
"""

from __future__ import annotations

import multiprocessing
from typing import Iterator

import numpy as np
import torch

from stedm_tpu_torch.data.loader import Loader, collate, takes_rng

# what the forkserver imports before it forks a worker
PRELOAD = ["stedm_tpu_torch.data.worker_loader", "stedm_tpu_torch.data.catch"]


class _Items(torch.utils.data.Dataset):
    """The dataset by ``(epoch, idx)``, with the threaded loader's per-item
    generator when the dataset takes one."""

    def __init__(self, dataset, seed: int):
        self.dataset = dataset
        self.seed = seed
        self.with_rng = takes_rng(dataset)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, key):
        epoch, idx = key
        if self.with_rng:
            rng = np.random.default_rng((self.seed, epoch, int(idx)))
            return self.dataset.__getitem__(int(idx), rng=rng)
        return self.dataset[int(idx)]


class _Batches(torch.utils.data.Sampler):
    """The current epoch's batches of ``(epoch, idx)`` keys; the loader sets
    them before each pass."""

    def __init__(self):
        self.batches: list[list[tuple[int, int]]] = []

    def __iter__(self):
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


def _shareable(x):
    if isinstance(x, np.ndarray) and x.dtype.kind in "biuf":
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, tuple):
        return tuple(_shareable(v) for v in x)
    return x


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, tuple):
        return tuple(_numpy(v) for v in x)
    return x


def _collate(items: list[tuple]) -> tuple:
    """The port's ``collate``, numeric arrays as tensors (shared memory)."""
    return _shareable(collate(items))


def _init_worker(worker_id: int) -> None:
    """One intra-op thread a worker; the host library's pool of this process
    when the library is built (else at first use, as in the parent)."""
    torch.set_num_threads(1)
    from stedm_tpu_torch import native

    if not native._stale():
        from stedm_tpu_torch.data.native_pipeline import global_pipeline

        global_pipeline()


class WorkerLoader(Loader):
    """``Loader``'s surface (``batch_size``, ``epoch``, ``process_shard``,
    ``len``, collated numpy batches) over worker processes.
    ``num_workers`` 0 loads in the calling process."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 num_workers: int = 4, prefetch: int = 2, seed: int = 0,
                 drop_last: bool = True):
        super().__init__(dataset, batch_size, shuffle=shuffle, num_workers=1,
                         prefetch=prefetch, seed=seed, drop_last=drop_last)
        self.num_workers = max(0, num_workers)
        self._sampler = _Batches()
        self._dl: torch.utils.data.DataLoader | None = None

    def _loader(self) -> torch.utils.data.DataLoader:
        if self._dl is None:
            multi = self.num_workers > 0
            ctx = None
            if multi:
                ctx = multiprocessing.get_context("forkserver")
                ctx.set_forkserver_preload(PRELOAD)
            self._dl = torch.utils.data.DataLoader(
                _Items(self.dataset, self.seed), batch_sampler=self._sampler,
                num_workers=self.num_workers, collate_fn=_collate,
                worker_init_fn=_init_worker if multi else None,
                multiprocessing_context=ctx,
                prefetch_factor=max(1, self.prefetch) if multi else None,
                persistent_workers=multi)
        return self._dl

    def __iter__(self) -> Iterator[tuple]:
        indices = self._indices()
        epoch = self.epoch
        self.epoch += 1
        batches = [[(epoch, int(i)) for i in indices[s:s + self.batch_size]]
                   for s in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        self._sampler.batches = batches
        for batch in self._loader():
            yield _numpy(batch)

    def close(self) -> None:
        """Stop the worker processes (they also stop with the loader)."""
        if self._dl is not None:
            it = self._dl._iterator
            if it is not None and hasattr(it, "_shutdown_workers"):
                it._shutdown_workers()
            self._dl = None
