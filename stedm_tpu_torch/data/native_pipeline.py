"""Async native patch pipeline: batch WSI patch extraction off the GIL.

A copy of stedm_tpu/data/native_pipeline.py over the port's own host library
(stedm_tpu_torch/native.py, csrc/host/pipeline.cc). The C++ worker pool
performs the `wsi_sample` hot loop — crop from a pyramid level with white
fill + block-mean downscale — for whole position batches while Python
continues: threads in C++ instead of forked processes, zero pickling, shared
pyramid memory. Where the JAX package's pool is ``None`` without its library,
this one builds the library or raises.

    pipe = AsyncPatchPipeline(n_workers=8)
    ticket = pipe.submit(level_array, coords, p_size, down)   # returns at once
    patches = ticket.get()                                    # [N, p, p, C]
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from stedm_tpu_torch import native


class _Ticket:
    def __init__(self, pipe: "AsyncPatchPipeline", ticket: int, out: np.ndarray):
        self._pipe, self._ticket, self._out = pipe, ticket, out
        self._done = False

    def get(self) -> np.ndarray:
        if not self._done:
            self._pipe._lib.stedm_pipe_wait(self._pipe._handle, self._ticket)
            self._done = True
        return self._out


class AsyncPatchPipeline:
    """One C++ worker pool; registered pyramid levels are kept alive here."""

    def __init__(self, n_workers: int | None = None):
        self._lib = native.load()
        n = n_workers or max(2, (os.cpu_count() or 4) // 2)
        self._handle = ctypes.c_void_p(self._lib.stedm_pipe_create(n))
        self._images: dict[int, tuple[int, np.ndarray]] = {}
        self._mu = threading.Lock()

    def _img_id(self, arr: np.ndarray) -> int:
        key = id(arr)
        with self._mu:
            hit = self._images.get(key)
            if hit is not None:
                return hit[0]
            a = np.ascontiguousarray(arr, dtype=np.uint8)
            h, w = a.shape[:2]
            c = a.shape[2] if a.ndim == 3 else 1
            img_id = self._lib.stedm_pipe_register(self._handle, native.u8ptr(a), h, w, c)
            # strong ref: the C++ side holds a non-owning view
            self._images[key] = (img_id, a)
            return img_id

    def submit(self, level: np.ndarray, coords: np.ndarray, p_size: int,
               down: int) -> _Ticket:
        """``coords``: [N, 2] (y0, x0) level coordinates of the crop origin."""
        img_id = self._img_id(level)
        coords = np.asarray(coords, dtype=np.int64).reshape(-1, 2)
        n = coords.shape[0]
        c = level.shape[2] if level.ndim == 3 else 1
        jobs = np.empty((n, 5), np.int64)
        jobs[:, 0] = img_id
        jobs[:, 1:3] = coords
        jobs[:, 3] = p_size
        jobs[:, 4] = down
        out = np.empty((n, p_size, p_size, c), np.uint8)
        ticket = self._lib.stedm_pipe_submit(
            self._handle, jobs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            native.u8ptr(out))
        # the C++ side copies the job rows before submit returns
        return _Ticket(self, ticket, out)

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            if getattr(self, "_handle", None):
                self._lib.stedm_pipe_destroy(self._handle)
        except Exception:
            pass


_GLOBAL: AsyncPatchPipeline | None = None
_GLOBAL_MU = threading.Lock()


def global_pipeline() -> AsyncPatchPipeline:
    """The process-wide pool."""
    global _GLOBAL
    with _GLOBAL_MU:
        if _GLOBAL is None:
            _GLOBAL = AsyncPatchPipeline()
        return _GLOBAL
