"""ctypes bindings for the host-side C++ of the WSI data path
(``csrc/host/consensus.cc``, ``csrc/host/pipeline.cc``).

The counterpart of stedm_tpu/native.py. The sources are copies of
``native/*.cc``; they are compiled with ``g++`` (the flags of
native/Makefile) into ``build/host/libstedm_host.so`` at the repository root
(git-ignored) at first use, and rebuilt when a source is newer than the
library. A failed build raises: the JAX package's loader returns ``None``
and its callers fall back to numpy quietly; here the numpy versions
(``data/prep.py:consensus_stack_numpy``, ``data/wsi.py:wsi_sample_reference``)
are plain references for the tests only.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / "csrc" / "host" / name
                for name in ("consensus.cc", "pipeline.cc"))
LIB_PATH = Path(__file__).resolve().parents[1] / "build" / "host" / "libstedm_host.so"
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-std=c++17", "-shared")

_lib = None
_mu = threading.Lock()


def _stale() -> bool:
    return (not LIB_PATH.exists()
            or LIB_PATH.stat().st_mtime < max(s.stat().st_mtime for s in SOURCES))


def build() -> None:
    """Compile the host library with ``g++``; raises with the compiler's
    output when it fails."""
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.stem}.{os.getpid()}.tmp.so")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES),
           "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as err:
        raise RuntimeError(f"cannot run {cmd[0]} to build the host library: {err}") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for the host library:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)


def load() -> ctypes.CDLL:
    """The host library's ctypes handle, built first when missing or stale."""
    global _lib
    with _mu:
        if _lib is not None:
            return _lib
        if _stale():
            build()
        lib = ctypes.CDLL(str(LIB_PATH))
        u8p, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
        lib.stedm_consensus.argtypes = [u8p, i64, i64, u8p, u8p]
        lib.stedm_extract_patch.argtypes = [u8p, i64, i64, i64, i64, i64, i64,
                                            ctypes.c_uint8, u8p]
        lib.stedm_downscale_mean.argtypes = [u8p, i64, i64, i64, i64, u8p]
        lib.stedm_wsi_patch.argtypes = [u8p, i64, i64, i64, i64, i64, i64, i64, u8p]
        # the async patch pool (csrc/host/pipeline.cc)
        lib.stedm_pipe_create.argtypes = [i64]
        lib.stedm_pipe_create.restype = ctypes.c_void_p
        lib.stedm_pipe_register.argtypes = [ctypes.c_void_p, u8p, i64, i64, i64]
        lib.stedm_pipe_register.restype = i64
        lib.stedm_pipe_submit.argtypes = [ctypes.c_void_p, ctypes.POINTER(i64), i64, u8p]
        lib.stedm_pipe_submit.restype = i64
        lib.stedm_pipe_wait.argtypes = [ctypes.c_void_p, i64]
        lib.stedm_pipe_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def consensus_stack_native(stack: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """C++ consensus over a [K, H, W] uint8 stack: (value, strength)."""
    lib = load()
    stack = np.ascontiguousarray(stack, dtype=np.uint8)
    k, h, w = stack.shape
    value = np.empty((h, w), np.uint8)
    strength = np.empty((h, w), np.uint8)
    lib.stedm_consensus(u8ptr(stack), k, h * w, u8ptr(value), u8ptr(strength))
    return value, strength


def extract_patch_native(image: np.ndarray, y_s: int, x_s: int, patch: int,
                         fill: int) -> np.ndarray:
    """``patch``² crop at (y_s, x_s) of an [H, W(, C)] uint8 image, ``fill``
    outside it."""
    lib = load()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        h, w = image.shape
        c = 1
        out = np.empty((patch, patch), np.uint8)
    else:
        h, w, c = image.shape
        out = np.empty((patch, patch, c), np.uint8)
    lib.stedm_extract_patch(u8ptr(image), h, w, c, y_s, x_s, patch, fill, u8ptr(out))
    return out


def wsi_patch_native(level: np.ndarray, y0: int, x0: int, size: int,
                     down: int) -> np.ndarray:
    """Crop ``size*down`` at (y0, x0) in a [H, W, C] uint8 pyramid level with
    white (255) fill outside, block-mean by ``down`` -> [size, size, C]: the
    wsi_sample hot path in one GIL-releasing call."""
    lib = load()
    level = np.ascontiguousarray(level, dtype=np.uint8)
    h, w, c = level.shape
    out = np.empty((size, size, c), np.uint8)
    lib.stedm_wsi_patch(u8ptr(level), h, w, c, y0, x0, size, down, u8ptr(out))
    return out


def downscale_mean_native(image: np.ndarray, factor: int) -> np.ndarray:
    """Block mean by ``factor`` of an [H, W(, C)] uint8 image (the remainder
    rows and columns dropped, the mean truncated)."""
    lib = load()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = image.shape if image.ndim == 3 else (*image.shape, 1)
    out = np.empty((h // factor, w // factor, c), np.uint8)
    lib.stedm_downscale_mean(u8ptr(image.reshape(h, w, c)), h, w, c, factor, u8ptr(out))
    return out if image.ndim == 3 else out[..., 0]
