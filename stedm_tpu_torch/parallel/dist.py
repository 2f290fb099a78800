"""Several processes, one card each, over the ``data`` axis (the counterpart
of stedm_tpu/parallel/mesh.py).

The reference trains and predicts under Lightning DDP (reference
train_diff.py:72-76); the JAX package shards the batch over a mesh's
``data`` axis and lets XLA insert the gradient all-reduce. Here each process
holds one card and one rank of a ``torch.distributed`` process group, as
``torchrun --nproc_per_node=N`` starts them:

* ``maybe_initialize_distributed`` joins the group when torchrun's variables
  are set (NCCL on ``cuda``, gloo on the CPU) and gives the process its card,
  ``cuda:{LOCAL_RANK}``; without them nothing is initialised and every
  helper below is the identity of one process;
* every rank loads its rank-interleaved share of the global batch
  (``Loader.process_shard``, torch ``DistributedSampler`` order), so global
  row ``i * W + r`` of a batch is rank ``r``'s local row ``i``;
* ``rank_rows`` draws a random tensor for the whole global batch from the
  shared generator and keeps this rank's rows of it, so each item gets the
  draw it gets in a one-process run at the same global batch;
* ``all_reduce_mean_`` averages gradients through one flat buffer,
  ``all_reduce_sum`` and ``sum_across_ranks`` (with a gradient) sum metrics
  and batch statistics.

Only the ``data`` axis is ported: ``mesh_size`` refuses any other axis
(ROADMAP §1: the model axis of sharding_rules.py).
"""

from __future__ import annotations

import math
import os
from typing import Callable

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(dev: torch.device) -> torch.device:
    """Join the process group when torchrun's environment is present (all of
    ``TORCHRUN_ENV``) and none is initialised yet; returns this process's
    device, ``cuda:{LOCAL_RANK}`` when ``dev`` is a card and ``LOCAL_RANK``
    is set, else ``dev``. A caller that initialised the group itself (any
    backend) keeps it."""
    dev = torch.device(dev)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if dist.is_initialized() or not all(k in os.environ for k in TORCHRUN_ENV):
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]), **kwargs)
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def mesh_size(cfg, dev: torch.device) -> int:
    """The data-parallel size that ``location.mesh`` resolves to: ``data: -1``
    is every process, a number must equal the number of processes, since
    each process holds one device. Raises for another axis and for more
    than one device in a process."""
    mesh = dict(cfg.location.mesh)
    other = sorted(k for k in mesh if k != "data")
    if other:
        raise NotImplementedError(
            f"location.mesh {mesh}: only the data axis is ported; {other} is not "
            "(ROADMAP §1: the model axis of sharding_rules.py)")
    procs = world_size()
    launched = int(os.environ.get("WORLD_SIZE", procs))
    if launched != procs:
        raise NotImplementedError(
            f"WORLD_SIZE={launched}, but this process is a rank of {procs}: launch with "
            "torchrun, which sets RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT too "
            "(torch.distributed)")
    n = procs if int(mesh.get("data", -1)) == -1 else int(mesh["data"])
    if n != procs:
        raise NotImplementedError(
            f"location.mesh {mesh} resolves to {n} devices in {procs} process(es): the "
            f"port runs one device a process; launch {n} processes with torchrun "
            "(torch.distributed)")
    return n


def local_batch_size(global_batch: int) -> int:
    """This process's share of the global batch (mesh.py:83-90)."""
    pc = world_size()
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{pc} processes")
    return global_batch // pc


def process_shard() -> tuple[int, int]:
    """``(rank, world size)``, the loaders' ``process_shard``."""
    return rank(), world_size()


def rank_rows(sample: Callable[..., torch.Tensor], shape, **kwargs) -> torch.Tensor:
    """``sample(shape, **kwargs)`` (``torch.randn``, ``torch.rand``, ...)
    for this rank's rows of the global batch: the draw is made for
    ``world_size() * shape[0]`` rows and rows ``rank::world_size`` are kept,
    the rows of this rank's items under the rank-interleaved shard."""
    w = world_size()
    shape = tuple(shape)
    if w == 1:
        return sample(shape, **kwargs)
    return sample((shape[0] * w,) + shape[1:], **kwargs)[rank()::w]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over ranks, in place (no gradient)."""
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor]) -> None:
    """Average ``tensors`` over ranks in place through one flat buffer per
    dtype: one collective a dtype whatever the number of tensors."""
    w = world_size()
    if w == 1 or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(w)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def reduce_grads_(params: list[torch.nn.Parameter]) -> None:
    """Average the ``.grad`` of ``params`` over ranks. A tensor that has a
    gradient on some rank and none on another gets zeros there first (which
    ranks hold one is itself all-reduced), so every rank reduces the same
    list; a tensor with no gradient on any rank keeps none."""
    if world_size() == 1:
        return
    dev = params[0].device
    has = torch.tensor([p.grad is not None for p in params], dtype=torch.float32,
                       device=dev)
    all_reduce_sum(has)
    for p, h in zip(params, has.tolist()):
        if h and p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_mean_([p.grad for p in params if p.grad is not None])


class _SumAcrossRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward sums the incoming gradients too: the
    gradient of a rank's input collects every rank's use of the sum."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad


def sum_across_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over ranks, differentiable; ``t`` itself on one process.
    With each rank's loss built on such sums and the parameter gradients
    averaged over ranks, the update is the gradient of the mean of the
    ranks' losses, as one process computes it over the global batch."""
    if world_size() == 1:
        return t
    return _SumAcrossRanks.apply(t)


def batch_moments(x: torch.Tensor, dims: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 mean and biased variance of ``x`` over ``dims`` and over
    every rank's rows (flax's ``E[x^2] - E[x]^2``, clamped at 0), with
    gradients through both: a BatchNorm in train mode normalising over the
    global batch."""
    x = x.float()
    count = math.prod(x.shape[d] for d in dims) * world_size()
    sums = sum_across_ranks(torch.stack([x.sum(dims), x.square().sum(dims)]))
    mean = sums[0] / count
    var = torch.clamp(sums[1] / count - mean.square(), min=0.0)
    return mean, var


def broadcast_value(value: float, dev: torch.device) -> float:
    """Rank 0's ``value`` on every rank (a float64 broadcast)."""
    if world_size() == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    dist.broadcast(t, src=0)
    return float(t.item())


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def valid_rows(n_items: int, start: int, count: int) -> torch.Tensor:
    """Which of this rank's local rows ``start .. start + count - 1`` of an
    unshuffled, wrap-padded shard of ``n_items`` items are real items (bool
    ``[count]``): local row ``i`` is global position ``i * W + r``, and the
    positions from ``n_items`` on repeat the first items."""
    i = torch.arange(start, start + count)
    return i * world_size() + rank() < n_items
