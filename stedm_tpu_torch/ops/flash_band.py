"""The flash attention forward and backward above head dimension 1024: the band route.

Above the largest compiled instance of the flash kernels (Dh 1024, a cluster
of eight 128-column blocks) ``blocked_attention`` sends every call here, at
any width: the landscape U-Net at ``num_heads: 1`` with ``channel_mult: [1,
4, 16]`` (Dh 2048 at its bottleneck) and a codec with ``ddconfig.ch_mult:
[1, 2, 16]`` (a 2048-wide AttnBlockVQ), where the JAX package runs the stock
Pallas kernel (stedm_tpu/ops/blocked_attention.py:99, models/vq.py:89).

The kernels are in ``csrc/flash_band.cu``: one tiled product, C = A B^T over
128 x 128 tiles (``wgmma`` + TMA; fp32 as 3xTF32 on split halves) with a
fused epilogue (``EPI_*``), a row pass (the forward's softmax), copy passes
(bf16 transposes, fp32 TF32 splits) and a Di pass. A call runs them over
bands: ``band_plan`` takes as many heads and query (or key) rows at once as
a workspace budget holds (``BAND_BYTES`` for the S / P / dS of a band,
``COPY_BYTES`` for the copies of a group of heads), and

- forward: S = Q K^T (``EPI_S``) -> row pass (LSE, P normalised, in the
  operands' type) -> O = P V (``EPI_O``);
- backward: the Di pass, then a query sweep, P (``EPI_P_ROW``) -> dS
  (``EPI_DS_ROW``) -> dQ = dS K, and a key sweep, P^T (``EPI_P_COL``) ->
  dS^T and P^T in the operands' type (``EPI_DS_COL``) -> dV = P^T dO, dK =
  dS^T Q: two sweeps that recompute the scores instead of adding partial
  gradients across bands, so no atomics and the same bits every run.

Every kernel has its plain version here (``product_plain``: a product with
its epilogue; ``rows_plain``: the row pass), and the plain route
(``forward_plain``, ``backward_plain``), which the wrappers take for CPU
tensors, runs them over the same bands, so its numerics are the kernels'.
A CUDA tensor always takes the kernels. Launches count once a call under
``COUNTERS``.
"""

from __future__ import annotations

import ctypes
import itertools
import math
from typing import NamedTuple

import torch

EPI_S, EPI_O, EPI_P_ROW, EPI_P_COL, EPI_DS_ROW, EPI_DS_COL = range(6)
STEM = "flash_band"
# the LAUNCHES key of each (dtype, backward)
COUNTERS = {torch.bfloat16: ("flash_band", "flash_band_bwd"),
            torch.float32: ("flash_band_f32", "flash_band_bwd_f32")}
BM = 128                       # rows of a product's output tile
BAND_BYTES = 512 * 2 ** 20     # S / P / dS of the rows in flight
COPY_BYTES = 2 ** 30           # the copies of a group of heads
_LOG2E = 1.0 / math.log(2.0)
_LN2 = math.log(2.0)


def _score_bytes(f32: bool, backward: bool) -> int:
    """Workspace bytes a score of a band: S or P (fp32), then P (forward),
    or dS and P^T (backward), in the operands' type (fp32: TF32 hi and lo)."""
    return 4 + (2 if backward else 1) * (8 if f32 else 2)


class BandPlan(NamedTuple):
    """How a call runs: ``tp`` the pitch of a workspace row of scores (T
    rounded up to 8), ``group`` the heads whose copies are made at once,
    ``heads`` x ``rows`` a band, ``chunks`` the bands in order, each
    ``(c0, z, g, r0, m)``: heads c0 + z .. c0 + z + g - 1 of copy group c0,
    rows r0 .. r0 + m - 1; ``copy_bytes`` and ``band_bytes`` the two parts
    of the workspace, ``workspace`` its bytes (with the backward's Di pass)."""

    tp: int
    group: int
    heads: int
    rows: int
    chunks: tuple
    copy_bytes: int
    band_bytes: int
    workspace: int


def _align(n: int) -> int:
    return -(-n // 256) * 256


def _copy_bytes_a_head(t: int, tp: int, w: int, f32: bool, backward: bool) -> int:
    """bf16: V^T (forward), K^T, Q^T and dO^T (backward); fp32 the TF32
    halves of Q, K and V^T (forward), of Q, K, V, dO, K^T, Q^T and dO^T
    (backward)."""
    if not f32:
        return (6 if backward else 2) * w * tp
    return (32 if backward else 16) * t * w + (24 if backward else 8) * w * tp


def band_plan(bh: int, t: int, w: int, dtype, backward: bool) -> BandPlan:
    """The bands of a ``[B * H = bh, T, W]`` call: whole heads at once where a
    band of them fits ``BAND_BYTES``, else one head in bands of rows (a
    multiple of 128, evened out over the head); copy groups of as many
    heads as ``COPY_BYTES`` holds (at least one)."""
    f32 = dtype == torch.float32
    tp = -(-t // 8) * 8
    per_head = _copy_bytes_a_head(t, tp, w, f32, backward)
    group = max(1, min(bh, COPY_BYTES // per_head))
    cap = max(BM, BAND_BYTES // (_score_bytes(f32, backward) * tp) // BM * BM)
    if cap >= t:
        heads, rows = min(group, cap // t), t
    else:
        per_band = -(-t // -(-t // cap))         # rows evened out over the bands
        heads, rows = 1, -(-per_band // BM) * BM
    chunks = []
    for c0 in range(0, bh, group):
        gc = min(group, bh - c0)
        for z in range(0, gc, heads):
            chunks += [(c0, z, min(heads, gc - z), r0, min(rows, t - r0))
                       for r0 in range(0, t, rows)]
    n = heads * rows * tp
    band = _align(4 * n) + (2 if backward else 1) * _align((8 if f32 else 2) * n)
    copies = _align(per_head * group) + 7 * 256
    stats = 2 * _align(4 * bh * t) if backward else 0
    return BandPlan(tp, group, heads, rows, tuple(chunks), copies, band, stats + copies + band)


# ---- plain versions: the structure and arithmetic of the kernels ----

def product_plain(epi: int, a, b, dtype, scale: float = 1.0, vec=None, p=None):
    """band_gemm's plain version: acc = A B^T in fp32 over ``[G, M, K]`` and
    ``[G, N, K]``, then the epilogue ``epi``: ``EPI_S`` acc; ``EPI_O`` acc in
    ``dtype``; ``EPI_P_ROW`` / ``EPI_P_COL`` exp2(acc * scale - vec) with
    ``vec`` (LSE * log2(e)) by row / column; ``EPI_DS_ROW`` p * (acc - vec) *
    scale in ``dtype`` (``vec`` = Di by row); ``EPI_DS_COL`` that by column
    and ``p`` in ``dtype``."""
    acc = a.float() @ b.float().transpose(-1, -2)
    if epi == EPI_S:
        return acc
    if epi == EPI_O:
        return acc.to(dtype)
    col = vec[..., None, :] if epi in (EPI_P_COL, EPI_DS_COL) else vec[..., :, None]
    if epi in (EPI_P_ROW, EPI_P_COL):
        return torch.exp2(acc * scale - col)
    ds = (p * (acc - col) * scale).to(dtype)
    return ds if epi == EPI_DS_ROW else (ds, p.to(dtype))


def rows_plain(s, scale2: float, dtype):
    """band_rows' plain version: each row of S scaled by ``scale2`` (sm_scale
    * log2(e)), its LSE (natural log) and P = exp2(S scale2 - LSE log2(e)) in
    ``dtype``."""
    x = s * scale2
    mx = x.amax(-1, keepdim=True)
    lse2 = mx + torch.log2(torch.exp2(x - mx).sum(-1, keepdim=True))
    return torch.exp2(x - lse2).to(dtype), lse2[..., 0] * _LN2


def stats_plain(o, do, lse):
    """band_stats' plain version: LSE * log2(e) and Di = rowsum(dO o O), fp32."""
    return lse.float() * _LOG2E, (do.float() * o.float()).sum(-1)


def _heads(x):
    b, h, t, w = x.shape
    return x.reshape(b * h, t, w)


def forward_plain(q, k, v, sm_scale: float, return_lse: bool = False):
    """The band route's forward on the plain versions, band by band."""
    b, h, t, w = q.shape
    q3, k3, v3 = _heads(q), _heads(k), _heads(v)
    out = torch.empty_like(q3)
    lse = torch.empty(b * h, t, dtype=torch.float32, device=q.device)
    for c0, z, g, r0, m in band_plan(b * h, t, w, q.dtype, False).chunks:
        hs, rs = slice(c0 + z, c0 + z + g), slice(r0, r0 + m)
        s = product_plain(EPI_S, q3[hs, rs], k3[hs], q.dtype)
        p, lse[hs, rs] = rows_plain(s, sm_scale * _LOG2E, q.dtype)
        out[hs, rs] = product_plain(EPI_O, p, v3[hs].transpose(-1, -2), q.dtype)
    out = out.reshape(q.shape)
    return (out, lse.reshape(b, h, t)) if return_lse else out


def backward_plain(q, k, v, o, lse, do, sm_scale: float):
    """The band route's backward on the plain versions: the Di pass, then the
    query and key sweeps band by band. Returns ``(dq, dk, dv)``."""
    b, h, t, w = q.shape
    dtype = q.dtype
    q3, k3, v3, do3 = _heads(q), _heads(k), _heads(v), _heads(do)
    lse2, di = (x.reshape(b * h, t) for x in stats_plain(o, do, lse))
    dq, dk, dv = (torch.empty_like(q3) for _ in range(3))
    chunks = band_plan(b * h, t, w, dtype, True).chunks
    for _, bands in itertools.groupby(chunks, key=lambda c: c[0]):
        bands = list(bands)
        for c0, z, g, r0, m in bands:            # the query sweep
            hs, rs = slice(c0 + z, c0 + z + g), slice(r0, r0 + m)
            p = product_plain(EPI_P_ROW, q3[hs, rs], k3[hs], dtype, sm_scale * _LOG2E,
                              lse2[hs, rs])
            ds = product_plain(EPI_DS_ROW, do3[hs, rs], v3[hs], dtype, sm_scale, di[hs, rs], p)
            dq[hs, rs] = product_plain(EPI_O, ds, k3[hs].transpose(-1, -2), dtype)
        for c0, z, g, r0, m in bands:            # the key sweep
            hs, rs = slice(c0 + z, c0 + z + g), slice(r0, r0 + m)
            p = product_plain(EPI_P_COL, k3[hs, rs], q3[hs], dtype, sm_scale * _LOG2E, lse2[hs])
            ds, pt = product_plain(EPI_DS_COL, v3[hs, rs], do3[hs], dtype, sm_scale, di[hs], p)
            dv[hs, rs] = product_plain(EPI_O, pt, do3[hs].transpose(-1, -2), dtype)
            dk[hs, rs] = product_plain(EPI_O, ds, q3[hs].transpose(-1, -2), dtype)
    return tuple(x.reshape(q.shape) for x in (dq, dk, dv))


# ---- the kernels ----

_FNS: dict[str, object] = {}
_P, _I64 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "flash_band_gemm": [ctypes.c_int, ctypes.c_int, _P, _I64, _P, _I64, _I64, _P, _P, _P, _P, _P,
                        _I64, ctypes.c_float, _P],
    "flash_band_rows": [ctypes.c_int, _P, _P, _P, _I64, ctypes.c_float, _P],
    "flash_band_copy": [ctypes.c_int, _P, _I64, _P, _P, _P],
    "flash_band_stats": [ctypes.c_int, _P, _P, _I64, _P, _P, _P, _P],
}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        from stedm_tpu_torch._device import load_library

        fn = getattr(load_library(STEM), name)
        fn.argtypes, fn.restype = _SIGNATURES[name], ctypes.c_int
        _FNS[name] = fn
    return fn


def _call(name: str, *args) -> None:
    args = [(ctypes.c_int64 * len(a))(*a) if isinstance(a, tuple) else a for a in args]
    err = _fn(name)(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


class _Workspace:
    """Consecutive 256-byte-aligned views of one uint8 buffer."""

    def __init__(self, nbytes: int, device, workspace=None):
        if workspace is None:
            workspace = torch.empty(nbytes, device=device, dtype=torch.uint8)
        elif (workspace.device != torch.device(device) or workspace.dtype != torch.uint8
              or workspace.numel() < nbytes or workspace.data_ptr() % 256):
            raise ValueError(f"workspace must be {nbytes} bytes (uint8) on q's device, "
                             "256-byte aligned")
        self.buf, self.off = workspace, 0

    def take(self, n: int, dtype) -> torch.Tensor:
        nbytes = n * torch.empty((), dtype=dtype).element_size()
        view = self.buf[self.off:self.off + nbytes].view(dtype)
        self.off += _align(nbytes)
        return view


class _Op(NamedTuple):
    """An operand of band_gemm: a tensor, its view's geometry (cols, rows,
    n2, n3, s_row, s2, s3; elements) and the map coordinates of block z = 0
    (row0, z0)."""

    x: torch.Tensor
    geo: tuple
    row0: int = 0
    z0: int = 0

    def at(self, row0: int, z0: int) -> _Op:
        return self._replace(row0=row0, z0=z0)


def _user_op(x, strides) -> _Op:
    b, h, t, w = x.shape
    sb, sh, st = strides
    return _Op(x, (w, t, h, b, st, sh, sb))


def _ws_op(x, rows: int, cols: int, n2: int, split: bool) -> _Op:
    """A workspace array ``[n2, rows, cols]`` (``split``: ``[2, n2, rows, cols]``,
    the TF32 hi and lo halves)."""
    return _Op(x, (cols, rows, n2, 2 if split else 1, cols, rows * cols, n2 * rows * cols))


def _gemm(f32: bool, epi: int, a: _Op, b: _Op, m: int, n: int, k: int, z: int, c, *,
          ldc: int = 0, zs: int = 0, half: int = 0, o_strides=(0, 0, 0), h: int = 1,
          z0: int = 0, row0: int = 0, t: int = 0, c2=None, p_in=None, lse2=None, di=None,
          scale: float = 1.0) -> None:
    _call("flash_band_gemm", int(f32), epi, a.x.data_ptr(), a.geo, b.x.data_ptr(), b.geo,
          (m, n, k, z, a.row0, a.z0, b.row0, b.z0), c.data_ptr(), _ptr(c2), _ptr(p_in),
          _ptr(lse2), _ptr(di), (ldc, zs, half, *o_strides, h, z0, row0, t), float(scale),
          _stream(c))


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _copy(x, strides, h, z0, n, cap, t, w, tp, nat=None, tr=None) -> None:
    _call("flash_band_copy", int(x.dtype == torch.float32), x.data_ptr(),
          (*strides, h, z0, n, cap, t, w, tp), _ptr(nat), _ptr(tr), _stream(x))


class _Copies:
    """The copy passes of one group of heads: bf16 the transposed tensors,
    ``[cap, W, TP]``; fp32 the TF32 halves, natural ``[2, cap, T, W]`` and
    transposed ``[2, cap, W, TP]``; each an operand of band_gemm."""

    def __init__(self, ws: _Workspace, f32: bool, cap: int, t: int, w: int, tp: int,
                 natural: tuple, transposed: tuple):
        self.f32, self.cap, self.t, self.w, self.tp = f32, cap, t, w, tp
        dt, parts = (torch.float32, 2) if f32 else (torch.bfloat16, 1)
        self.nat = {n: ws.take(parts * cap * t * w, dt) for n in natural}
        self.tr = {n: ws.take(parts * cap * w * tp, dt) for n in transposed}

    def make(self, tensors: dict, strides: dict, h: int, c0: int, n: int) -> None:
        for name in set(self.nat) | set(self.tr):
            _copy(tensors[name], strides[name], h, c0, n, self.cap, self.t, self.w, self.tp,
                  self.nat.get(name), self.tr.get(name))

    def nat_op(self, name: str) -> _Op:
        return _ws_op(self.nat[name], self.t, self.w, self.cap, True)

    def tr_op(self, name: str) -> _Op:
        return _ws_op(self.tr[name], self.w, self.tp, self.cap, self.f32)


def forward_cuda(q, k, v, sm_scale: float, out, lse, strides: dict) -> None:
    """The band route's forward kernels on ``[B, H, T, W]`` CUDA tensors of
    one dtype (W rows 16 bytes apart; ``strides``: each of q, k, v, out's
    element strides, ``blocked_attention.check_strided``): O into ``out``,
    the LSE into ``lse`` (fp32 ``[B, H, T]``) unless it is None."""
    b, h, t, w = q.shape
    bh, f32 = b * h, q.dtype == torch.float32
    plan = band_plan(bh, t, w, q.dtype, False)
    tp, cap, rows, heads = plan.tp, plan.group, plan.rows, plan.heads
    ws = _Workspace(plan.workspace, q.device)
    copies = _Copies(ws, f32, cap, t, w, tp, ("q", "k") if f32 else (), ("v",))
    s = ws.take(heads * rows * tp, torch.float32)
    pw = ws.take((2 if f32 else 1) * heads * rows * tp, q.dtype)
    ops = {"q": _user_op(q, strides["q"]), "k": _user_op(k, strides["k"])}
    scale2 = sm_scale * _LOG2E
    for c0, z, g, r0, m in plan.chunks:
        if z == 0 and r0 == 0:
            copies.make({"q": q, "k": k, "v": v}, strides, h, c0, min(cap, bh - c0))
        if f32:
            a, bq = copies.nat_op("q").at(r0, z), copies.nat_op("k").at(0, z)
        else:
            a, bq = ops["q"].at(r0, c0 + z), ops["k"].at(0, c0 + z)
        _gemm(f32, EPI_S, a, bq, m, tp, w, g, s, ldc=tp, zs=rows * tp)
        _call("flash_band_rows", int(f32), s.data_ptr(), pw.data_ptr(), _ptr(lse),
              (m, g, tp, rows * tp, heads * rows * tp, t, tp, c0 + z, r0), float(scale2),
              _stream(q))
        _gemm(f32, EPI_O, _ws_op(pw, rows, tp, heads, f32), copies.tr_op("v").at(0, z), m, w,
              tp, g, out, o_strides=strides["out"], h=h, z0=c0 + z, row0=r0, t=t)


def backward_cuda(q, k, v, o, lse, do, sm_scale: float, strides: dict, workspace=None):
    """The band route's backward kernels: ``(dq, dk, dv)``, contiguous, from
    the forward's inputs, its output ``o`` and LSE and the output gradient
    ``do`` (``strides``: each one's element strides); ``workspace``, when
    given, a uint8 CUDA tensor of at least ``band_plan(...).workspace``
    bytes."""
    b, h, t, w = q.shape
    bh, f32, dtype = b * h, q.dtype == torch.float32, q.dtype
    plan = band_plan(bh, t, w, dtype, True)
    tp, cap, rows, heads = plan.tp, plan.group, plan.rows, plan.heads
    ws = _Workspace(plan.workspace, q.device, workspace)
    lse2, di = ws.take(bh * t, torch.float32), ws.take(bh * t, torch.float32)
    copies = _Copies(ws, f32, cap, t, w, tp, ("q", "k", "v", "do") if f32 else (),
                     ("k", "q", "do"))
    n = heads * rows * tp
    pws = ws.take(n, torch.float32)
    parts = 2 if f32 else 1
    dsw, ptw = ws.take(parts * n, dtype), ws.take(parts * n, dtype)
    dq, dk, dv = (torch.empty_like(q, memory_format=torch.contiguous_format) for _ in range(3))
    grads = tuple(x.stride()[:3] for x in (dq, dk, dv))
    _call("flash_band_stats", int(f32), o.data_ptr(), do.data_ptr(),
          (*strides["o"], *strides["do"], h, bh, t, w), lse.data_ptr(), lse2.data_ptr(),
          di.data_ptr(), _stream(q))
    tensors = {"q": q, "k": k, "v": v, "do": do}
    user = {name: _user_op(x, strides[name]) for name, x in tensors.items()}
    ws_op = lambda x: _ws_op(x, rows, tp, heads, f32)      # noqa: E731
    band = dict(ldc=tp, zs=rows * tp, half=n, h=h, t=t)
    p_scale = sm_scale * _LOG2E

    def op(name, row0, c0, z):
        return copies.nat_op(name).at(row0, z) if f32 else user[name].at(row0, c0 + z)

    for c0, bands in itertools.groupby(plan.chunks, key=lambda c: c[0]):
        bands = list(bands)
        copies.make(tensors, strides, h, c0, min(cap, bh - c0))
        for _, z, g, r0, m in bands:               # the query sweep
            at = dict(band, z0=c0 + z, row0=r0)
            _gemm(f32, EPI_P_ROW, op("q", r0, c0, z), op("k", 0, c0, z), m, tp, w, g, pws,
                  lse2=lse2, scale=p_scale, **at)
            _gemm(f32, EPI_DS_ROW, op("do", r0, c0, z), op("v", 0, c0, z), m, tp, w, g, dsw,
                  p_in=pws, di=di, scale=sm_scale, **at)
            _gemm(f32, EPI_O, ws_op(dsw), copies.tr_op("k").at(0, z), m, w, tp, g, dq,
                  o_strides=grads[0], h=h, z0=c0 + z, row0=r0, t=t)
        for _, z, g, r0, m in bands:               # the key sweep
            at = dict(band, z0=c0 + z, row0=r0)
            _gemm(f32, EPI_P_COL, op("k", r0, c0, z), op("q", 0, c0, z), m, tp, w, g, pws,
                  lse2=lse2, scale=p_scale, **at)
            _gemm(f32, EPI_DS_COL, op("v", r0, c0, z), op("do", 0, c0, z), m, tp, w, g, dsw,
                  c2=ptw, p_in=pws, di=di, scale=sm_scale, **at)
            _gemm(f32, EPI_O, ws_op(ptw), copies.tr_op("do").at(0, z), m, w, tp, g, dv,
                  o_strides=grads[2], h=h, z0=c0 + z, row0=r0, t=t)
            _gemm(f32, EPI_O, ws_op(dsw), copies.tr_op("q").at(0, z), m, w, tp, g, dk,
                  o_strides=grads[1], h=h, z0=c0 + z, row0=r0, t=t)
    return dq, dk, dv
