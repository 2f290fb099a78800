"""The port's kernel gradients on the CPU: the GroupNorm+SiLU Function's
backward against the JAX package's custom VJP (its Pallas forward run in
interpret mode) and against autograd, the attention gradients against
``jax.grad`` of the JAX package's plain SDPA paths, and the plain versions of
the flash-attention backward kernels against autograd. Inputs come from numpy
seeds; everything is fp32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_helpers import ATOL, RTOL

from stedm_tpu.ops import blocked_attention as jattn
from stedm_tpu.ops import gn_silu as jgn
from stedm_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_launch_counts
from stedm_tpu_torch.ops import blocked_attention as pattn
from stedm_tpu_torch.ops import gn_silu as pgn

B, H, W, C, G = 2, 4, 4, 128, 32
GN_MODES = [("plain", True), ("plain", False), ("add", True), ("add", False),
            ("film", True), ("film", False)]


def _gn_case(mode, seed):
    r = np.random.default_rng(seed)
    d = dict(x=r.normal(0.3, 1.5, (B, H, W, C)), gamma=r.normal(1, 0.1, C),
             beta=r.normal(0, 0.1, C), dy=r.normal(size=(B, H, W, C)))
    if mode == "add":
        d["add"] = r.normal(size=(B, C))
    if mode == "film":
        d["film_scale"], d["film_shift"] = r.normal(0, 0.2, (B, C)), r.normal(0, 0.2, (B, C))
    return {k: v.astype(np.float32) for k, v in d.items()}


def _torch_grads(fn, d, names, silu):
    leaves = {n: torch.from_numpy(d[n]).requires_grad_() for n in names}
    y = fn(leaves["x"], leaves["gamma"], leaves["beta"],
           **{n: leaves[n] for n in names[3:]}, apply_silu=silu)
    y.backward(torch.from_numpy(d["dy"]))
    return [leaves[n].grad.numpy() for n in names]


def _close_rel(got, want, rel, names):
    """max |got - want| <= rel * max |want|, per gradient."""
    for name, a, b in zip(names, got, want):
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("mode,silu", GN_MODES, ids=[f"{m}-{'silu' if s else 'nosilu'}"
                                                     for m, s in GN_MODES])
def test_gn_silu_function_backward_matches_jax_vjp_and_autograd(mode, silu):
    d = _gn_case(mode, seed=len(mode) + silu)
    extra = {"plain": [], "add": ["add"], "film": ["film_scale", "film_shift"]}[mode]
    names = ["x", "gamma", "beta"] + extra
    reset_launch_counts()
    got = _torch_grads(pgn.gn_silu, d, names, silu)       # GNSiLUFunction
    assert PLAIN_CALLS["gn_silu_bwd"] == 0, "a CPU backward is not a card call"
    ref = _torch_grads(pgn.gn_silu_reference, d, names, silu)

    orig = jgn._gn_silu_pallas
    jgn._gn_silu_pallas = functools.partial(orig, interpret=True)
    try:
        def f(*args):
            kw = dict(zip(names, args))
            return jgn._gn_silu(kw["x"], kw["gamma"], kw["beta"], kw.get("add"),
                                kw.get("film_scale"), kw.get("film_shift"), G, 1e-5, silu)

        y, vjp = jax.vjp(f, *[jnp.asarray(d[n]) for n in names])
        want = [np.asarray(g) for g in vjp(jnp.asarray(d["dy"]))]
    finally:
        jgn._gn_silu_pallas = orig
    # fp32 sums over 16 positions x 4 channels (statistics) and the batch
    # (gamma, beta) in other orders
    _close_rel(got, want, 1e-4, names)
    _close_rel(got, ref, 1e-4, names)


def test_gn_silu_module_gradient_through_channels_last():
    """GNSiLU permutes a channels_last tensor to NHWC and back; the gradient
    arriving at the Function is made contiguous NHWC before the backward."""
    from stedm_tpu_torch.models.layers import GNSiLU

    r = np.random.default_rng(3)
    x = torch.from_numpy(r.normal(size=(B, C, H, W)).astype(np.float32))
    add = torch.from_numpy(r.normal(size=(B, C)).astype(np.float32))
    mod = GNSiLU(C)
    xs = [x.clone().contiguous(memory_format=torch.channels_last).requires_grad_()
          for _ in range(2)]
    w = torch.from_numpy(r.normal(size=(B, C, H, W)).astype(np.float32))
    (mod(xs[0], add=add) * w).sum().backward()
    ref = pgn.gn_silu_reference(xs[1].permute(0, 2, 3, 1), mod.weight, mod.bias, add)
    (ref.permute(0, 3, 1, 2) * w).sum().backward()
    torch.testing.assert_close(xs[0].grad, xs[1].grad, rtol=1e-4, atol=1e-5)


def _qkv(shape, seed):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("impl", ["exact", "chunked", "flash"])
def test_sdpa_gradients_match_jax(impl):
    shape = (2, 4, 48, 32)
    q, k, v, w = _qkv(shape, seed=11)
    scale = float(shape[-1]) ** -0.25
    jref = {"exact": lambda a, b, c: jattn.sdpa(a, b, c, scale, impl="exact"),
            "chunked": lambda a, b, c: jattn.chunked_sdpa(a, b, c, scale, q_chunk=16),
            "flash": lambda a, b, c: jattn.sdpa(a, b, c, scale, impl="exact")}[impl]
    want = jax.grad(lambda *a: jnp.sum(jref(*a) * w), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = pattn.sdpa(*leaves, scale, impl=impl, q_chunk=16)
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t", [70, 5, 128])
def test_attention_backward_reference_matches_autograd(t):
    q, k, v, do = (torch.from_numpy(a) for a in _qkv((2, 3, t, 64), seed=t))
    s = 64 ** -0.5
    out, lse = pattn.attention_reference(q, k, v, s, return_lse=True)
    got = pattn.attention_backward_reference(q, k, v, out, lse, do, s)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    pattn.attention_reference(*leaves, s).backward(do)
    for name, g, leaf in zip("qkv", got, leaves):
        # fp32; the log2-domain rebuild of P against torch's softmax
        torch.testing.assert_close(g, leaf.grad, rtol=1e-4, atol=1e-5, msg=name)


def test_flash_function_on_cpu_takes_the_plain_versions():
    q, k, v, do = (torch.from_numpy(a) for a in _qkv((1, 2, 33, 64), seed=5))
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    reset_launch_counts()
    out = pattn.flash_attention(*leaves, 0.125)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("FlashAttention")
    out.backward(do)
    assert not any(LAUNCHES.values()), LAUNCHES
    ref = pattn.attention_backward_reference(q, k, v, out.detach(),
                                             pattn.attention_reference(q, k, v, 0.125, True)[1],
                                             do, 0.125)
    for g, leaf in zip(ref, leaves):
        torch.testing.assert_close(leaf.grad, g)


def test_return_lse_matches_logsumexp():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv((2, 2, 37, 64), seed=9))
    s = 0.3
    out, lse = pattn.attention_reference(q, k, v, s, return_lse=True)
    torch.testing.assert_close(lse, torch.logsumexp((q @ k.transpose(-1, -2)) * s, -1))
    torch.testing.assert_close(out, pattn.attention_reference(q, k, v, s))
