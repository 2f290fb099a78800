"""Device selection and the CUDA kernel build.

CUDA sources under ``stedm_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library each, with a plain C interface loaded
through ``ctypes``. The libraries go to ``build/kernels/`` at the repository
root (git-ignored) at first use; a library older than its source or than
any ``csrc/*.cuh`` header is rebuilt.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def resolve_device(device=None) -> torch.device:
    """``cuda`` when no device is given; raises if there is no card then.

    The CPU is used only when a caller asks for it explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "explicitly to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(stem: str) -> Path:
    return BUILD_DIR / f"lib{stem}.so"


def _stale(stem: str) -> bool:
    """Whether ``lib<stem>.so`` is missing or older than its source or than
    any header under ``csrc/`` (the sources include them)."""
    lib = _lib_path(stem)
    if not lib.exists():
        return True
    sources = [CSRC / f"{stem}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(src.stat().st_mtime for src in sources)


def _start_build(stem: str) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{stem}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish_build(stem: str, proc: subprocess.Popen, tmp: Path) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {stem}.cu:\n{out}")
    os.replace(tmp, _lib_path(stem))
    return out


def build_all(stems) -> dict[str, str]:
    """Compile the given sources in parallel (one nvcc each); returns each
    build's compiler output (register and shared-memory use)."""
    started = {s: _start_build(s) for s in stems if _stale(s)}
    return {s: _finish_build(s, *pt) for s, pt in started.items()}


# H100 shared memory: what a block may use, and the least a block of a
# cluster kernel asks for so that two never share an SM (an SM has 228 KB
# for its blocks): the cluster kernels' plans count on one block an SM
SMEM_LIMIT = 232448
ONE_PER_SM = 118784

_LIBS: dict[str, ctypes.CDLL] = {}


def load_library(stem: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<stem>.cu``, built first if needed."""
    if stem not in _LIBS:
        if _stale(stem):
            _finish_build(stem, *_start_build(stem))
        _LIBS[stem] = ctypes.CDLL(str(_lib_path(stem)))
    return _LIBS[stem]


@functools.lru_cache(maxsize=None)
def max_active_clusters(stem: str, sizes: tuple, smem: int, index: int) -> tuple:
    """Clusters of each of ``sizes`` blocks, ``smem`` bytes of dynamic shared
    memory each, that device ``index`` holds at once: the
    ``<stem>_max_active_clusters`` of ``csrc/<stem>.cu``
    (cudaOccupancyMaxActiveClusters on that library's kernel)."""
    fn = getattr(load_library(stem), f"{stem}_max_active_clusters")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    with torch.cuda.device(index):
        got = tuple(fn(k, smem) for k in sizes)
    if min(got) < 1:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters of {stem} failed: {got}")
    return got


def check_cuda_tensor(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
