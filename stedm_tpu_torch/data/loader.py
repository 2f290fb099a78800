"""Host-side batch loader feeding the device input stream.

A copy of stedm_tpu/data/loader.py (the port imports nothing of the JAX
package) with one repair: ``ConcatDataset`` hands the per-item generator on
to its datasets. The JAX package's takes none (loader.py:34-36), so the
Loader finds no ``rng`` parameter and every training item is drawn from an
unseeded generator: two JAX train loaders with the same seed differ. Here
the train batches depend on the seed alone, and equal, bit for bit, what
the JAX Loader yields over the same datasets handed the generator.

Replaces torch ``DataLoader``/``ConcatDataset`` (reference `data/dm.py:49-87`).
Datasets are plain python objects with ``__len__``/``__getitem__`` returning tuples
of numpy arrays. The loader samples indices, materializes items in a thread pool
(cv2/PIL/OpenSlide release the GIL), collates to stacked numpy batches, and keeps a
prefetch queue ahead of the consumer so host decode overlaps device compute.

Threads (not processes) are deliberate: the heavy lifting is C code, and expensive
per-slide handles can be cached per thread (the reference's lazy per-worker
OpenSlide handles, her2_ds.py:135-138, have the same motivation).
"""

from __future__ import annotations

import inspect
import queue
import threading
from typing import Iterator, Sequence

import numpy as np


class ConcatDataset:
    """Index-concatenation of datasets (torch ConcatDataset equivalent)."""

    def __init__(self, datasets: Sequence):
        self.datasets = [d for d in datasets if len(d) > 0]
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None):
        ds = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        local = idx - int(self._offsets[ds])
        if rng is not None and takes_rng(self.datasets[ds]):
            return self.datasets[ds].__getitem__(local, rng=rng)
        return self.datasets[ds][local]


def takes_rng(dataset) -> bool:
    """Whether ``dataset.__getitem__`` takes an ``rng`` keyword."""
    try:
        return "rng" in inspect.signature(type(dataset).__getitem__).parameters
    except (TypeError, ValueError):
        return False


def collate(items: list[tuple]) -> tuple:
    """Stack a list of equal-structure tuples into batched numpy arrays."""
    out = []
    for parts in zip(*items):
        first = parts[0]
        if isinstance(first, np.ndarray):
            out.append(np.stack(parts))
        elif isinstance(first, tuple):
            out.append(tuple(np.asarray(col) for col in zip(*parts)))
        else:
            out.append(np.asarray(parts))
    return tuple(out)


class Loader:
    """Iterable over collated batches with threaded prefetch.

    ``shuffle=True`` draws a fresh permutation per epoch from ``seed + epoch``;
    datasets whose ``__getitem__`` takes an optional ``rng`` kwarg get a
    per-(epoch, index) child generator — the splittable-PRNG answer to the
    reference's np.random-in-forked-workers pattern (SURVEY.md §7 hard part f).
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 num_workers: int = 4, prefetch: int = 2, seed: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        # multi-host: (process_index, process_count). Every process draws the SAME
        # permutation (seeded), pads it by wrapping to a multiple of process_count,
        # and takes the rank-interleaved slice — torch DistributedSampler semantics
        # (the reference relies on Lightning's DDP sampler injection), so all
        # processes run the same number of batches in lockstep.
        self.process_shard: tuple[int, int] | None = None

    def _shard(self) -> tuple[int, int]:
        return self.process_shard or (0, 1)

    def __len__(self) -> int:
        pi, pc = self._shard()
        n = -(-len(self.dataset) // pc)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(n)
        else:
            idx = np.arange(n)
        pi, pc = self._shard()
        if pc > 1:
            pad = (-n) % pc
            if pad:  # wrap like DistributedSampler so ranks stay in lockstep
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[pi::pc]
        return idx

    def __iter__(self) -> Iterator[tuple]:
        with_rng = takes_rng(self.dataset)
        indices = self._indices()
        epoch = self.epoch
        self.epoch += 1
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        def fetch_item(idx: int):
            if with_rng:
                rng = np.random.default_rng((self.seed, epoch, int(idx)))
                return self.dataset.__getitem__(int(idx), rng=rng)
            return self.dataset[int(idx)]

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(self.num_workers) as pool:
                for batch_idx in batches:
                    if stop.is_set():
                        break
                    items = list(pool.map(fetch_item, batch_idx))
                    out_q.put(collate(items))
            out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
