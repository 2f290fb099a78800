"""Host -> device prefetch: overlap the input pipeline with device compute
(the CUDA counterpart of stedm_tpu/data/prefetch.py).

Each host batch goes through ``transform`` (``batch_to_ldm``) into pinned
host memory and is copied to the card with ``non_blocking=True`` on a side
stream, ``size`` batches ahead of the consumer. An event recorded after the
copies is waited on by the consumer's stream before the batch is handed
over, and each tensor is marked as used on that stream, so the caching
allocator keeps its memory until the consumer's work on it is done. Pinning
that fails raises: there is no synchronous fallback. On a CPU device (the
tests) the batch is handed over as CPU tensors, without copies.

``laps``, a dict, gathers the host clock the consumer's thread spends on
batches: waiting for the host pipeline and transforming (``data``), pinning
and issuing the copies (``h2d``).
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from stedm_tpu_torch._device import resolve_device


def pinned(x) -> torch.Tensor:
    """``x`` (a numpy array) as a tensor in page-locked host memory."""
    return torch.from_numpy(np.ascontiguousarray(x)).pin_memory()


def prefetch_to_device(iterator: Iterable, *, size: int = 2,
                       transform: Callable | None = None,
                       device=None, laps: dict | None = None) -> Iterator[dict]:
    """Yield dicts of device tensors ``size`` batches ahead of consumption;
    runs on ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    queue: collections.deque = collections.deque()
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    laps = {} if laps is None else laps
    it = iter(iterator)

    def pull():
        t = time.perf_counter()
        batch = next(it, None)
        if batch is not None and transform is not None:
            batch = transform(batch)
        laps["data"] = laps.get("data", 0.0) + time.perf_counter() - t
        return batch

    def put(batch) -> None:
        t = time.perf_counter()
        if side is None:
            out, ready = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, None
        else:
            host = {k: pinned(v) for k, v in batch.items()}
            with torch.cuda.stream(side):
                out = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
                ready = torch.cuda.Event()
                ready.record(side)
        queue.append((out, ready))
        laps["h2d"] = laps.get("h2d", 0.0) + time.perf_counter() - t

    def take() -> dict:
        out, ready = queue.popleft()
        if ready is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            for t in out.values():
                t.record_stream(consumer)
        return out

    while len(queue) < size and (batch := pull()) is not None:
        put(batch)
    while queue:
        out = take()
        nxt = pull()
        if nxt is not None:
            put(nxt)
        yield out
