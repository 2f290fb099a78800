"""STEDM in PyTorch for NVIDIA Hopper: the synthetic-pair sampler.

The JAX package ``stedm_tpu`` is the reference this package is held against;
nothing here imports it (or JAX). Public sampling functions take and return
NHWC tensors like the reference; modules work on NCHW-logical tensors in
``torch.channels_last`` memory format, which is NHWC in memory.

Entry points (``models.stedm.build_flagship``, ``train.steps.make_sample_fn``)
run on ``cuda`` unless the caller passes another device, and raise when no
card is present and none was given. The hand-written kernels live in
``csrc/`` (CUDA C++, one library a source, built with ``nvcc`` at first use);
each has a plain PyTorch version beside it, in ``ops/``, that runs on CPU
tensors.
"""

from stedm_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
