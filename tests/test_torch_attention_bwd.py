"""The port's flash-attention backward against the stock TPU kernels themselves.

``jax.vjp`` of ``stedm_tpu.ops.blocked_attention.flash_sdpa`` (block 128)
runs the stock Pallas backward kernels (``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``, which the port's ``csrc/flash_attention_bwd.cu``
replaces) in interpret mode on the CPU. The same numpy-seeded q, k, v and dO
go through the port's plain backward ``attention_backward_reference`` and
through ``FlashAttentionFunction`` on the CPU, fed strided views of one packed
``[B, T, H, 3, Dh]`` projection as the U-Net's AttentionBlock feeds it; Dh
512 at one head is the codec's AttnBlockVQ, whose gradient codec
fine-tuning takes; Dh 32 the AttentionBlock at ``num_head_channels: 32``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stedm_tpu.ops.blocked_attention import flash_sdpa
from stedm_tpu_torch.ops import blocked_attention as pattn

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _stock_grads(q, k, v, do, scale, jdt):
    """dq, dk, dv of the stock TPU kernels (interpret mode), as fp32 numpy."""
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: flash_sdpa(a, b, c, scale, block=128),
                         *(jnp.asarray(x, jdt) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do, jdt))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _close(got, want, dtype):
    got = got.float().numpy()
    if dtype == "float32":
        # the same sums in another order
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        # one bf16 ulp of P and dS on either side, and of the bf16 output
        assert np.all(np.abs(got - want) <= 2 ** -7 * (np.abs(want) + 1)), \
            float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,t,dh", [(1, 2, 256, 128), (2, 2, 128, 64), (1, 1, 256, 512),
                                      (2, 4, 128, 32)])
def test_backward_matches_stock_tpu_kernels(b, h, t, dh, dtype):
    jdt, tdt = DTYPES[dtype]
    r = np.random.default_rng(t + dh)
    proj = r.normal(size=(b, t, h, 3, dh)).astype(np.float32)
    do = r.normal(size=(b, h, t, dh)).astype(np.float32)
    scale = dh ** -0.25                      # per operand, as the AttentionBlock passes it
    sm_scale = float(scale) ** 2
    q, k, v = (np.ascontiguousarray(proj[:, :, :, i].transpose(0, 2, 1, 3)) for i in range(3))
    want = _stock_grads(q, k, v, do, scale, jdt)

    # the plain backward on the port's own forward output and LSE
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    tdo = torch.from_numpy(do).to(tdt)
    out, lse = pattn.attention_reference(tq, tk, tv, sm_scale, return_lse=True)
    plain = pattn.attention_backward_reference(tq, tk, tv, out, lse, tdo, sm_scale)
    for got, w in zip(plain, want):
        _close(got, w, dtype)

    # FlashAttentionFunction on strided views of the packed projection
    packed = torch.from_numpy(proj).to(tdt).requires_grad_()
    views = packed.permute(0, 2, 3, 1, 4).unbind(2)
    assert not views[0].is_contiguous()
    via = pattn.flash_attention(*views, sm_scale)
    via.backward(tdo)
    grads = packed.grad.permute(0, 2, 3, 1, 4).unbind(2)
    for got, w in zip(grads, want):
        _close(got, w, dtype)
