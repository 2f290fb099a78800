"""The port's hand-written kernels against their plain versions on the card.

These need a CUDA card, nvcc and triton; without a card they skip (the CPU
tests hold the plain versions against the JAX package). On a card machine:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref, rel, abs_):
    d = (got.float() - ref.float()).abs()
    assert bool((d <= rel * ref.float().abs() + abs_).all()), float(d.max())


@pytest.mark.parametrize("shape,mode", [((2, 8, 8, 128), "add"), ((2, 16, 16, 640), "plain"),
                                        ((3, 7, 5, 96), "film")])
def test_gn_silu_kernel(cuda, shape, mode):
    from stedm_tpu_torch.ops import gn_silu as g

    b, c = shape[0], shape[3]
    x = torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)
    gamma = torch.randn(c, generator=cuda, device="cuda")
    beta = torch.randn(c, generator=cuda, device="cuda")
    kw = {}
    if mode == "add":
        kw["add"] = torch.randn(b, c, generator=cuda, device="cuda")
    elif mode == "film":
        kw["film_scale"] = torch.randn(b, c, generator=cuda, device="cuda")
        kw["film_shift"] = torch.randn(b, c, generator=cuda, device="cuda")
    got = g.gn_silu(x, gamma, beta, **kw)
    # neighbouring bf16 values (2^-7 relative)
    _close(got, g.gn_silu_reference(x, gamma, beta, **kw), 2 ** -7, 2 ** -9)


@pytest.mark.parametrize("shape", [(2, 2, 256, 128), (1, 1, 200, 512), (1, 3, 70, 64),
                                   (2, 1, 130, 192), (1, 2, 65, 256)])
def test_flash_attention_kernel(cuda, shape):
    from stedm_tpu_torch.ops import blocked_attention as a

    q, k, v = (torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    s = shape[-1] ** -0.5
    got, ref = a.flash_attention(q, k, v, s), a.attention_reference(q, k, v, s)
    # both round P and the output to bf16: within 2^-8 (P |V| + |o|) of each other
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * s, dim=-1)
    scale = p @ v.float().abs() + ref.float().abs()
    assert bool(((got.float() - ref.float()).abs() <= 2 ** -7 * scale).all())


def test_flash_attention_gates_head_dim(cuda):
    from stedm_tpu_torch.ops import blocked_attention as a

    q = torch.zeros(1, 1, 64, 96, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        a.flash_attention(q, q, q, 0.1)


def test_nearest_code_kernel(cuda):
    from stedm_tpu_torch.ops import quantize as qz

    z = torch.randn(3000, 3, generator=cuda, device="cuda")
    cb = torch.randn(5000, 3, generator=cuda, device="cuda")
    got, ref = qz.nearest_code(z, cb), qz.nearest_code_reference(z, cb)
    diff = (got != ref).nonzero().flatten()
    d = lambda i: ((z[diff].double() - cb[i[diff].long()].double()) ** 2).sum(1)
    assert bool(((d(got) - d(ref)).abs() <= 1e-5 * (1 + (z[diff] ** 2).sum(1))).all())


def _abs_bound(*pairs):
    """sum of |a| @ |b| over the pairs: the magnitude a sum of products can
    lose to rounding and summation order."""
    return sum(a.float().abs() @ b.float().abs() for a, b in pairs)


@pytest.mark.parametrize("shape", [(2, 2, 256, 128), (1, 3, 70, 64), (1, 2, 130, 128),
                                   (2, 4, 4, 64)])
def test_flash_attention_backward_kernels(cuda, shape):
    from stedm_tpu_torch.ops import blocked_attention as a

    q, k, v, do = (torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    s = shape[-1] ** -0.5
    o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
    # the forward's LSE against torch.logsumexp of the same fp32 logits
    logits = (q.float() @ k.float().transpose(-1, -2)) * s
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=1e-5, atol=1e-5)
    got = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
    ref = a.attention_backward_reference(q, k, v, o, lse, do, s)
    # P and dS are rounded to bf16 on both sides (at most one ulp apart), the
    # sums run in other orders and the outputs round to bf16: within 2^-7 of
    # the sum of |terms| plus |ref|
    p = torch.softmax(logits, -1)
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - (do.float() * o.float()).sum(-1, keepdim=True)) * s
    bounds = (_abs_bound((ds, k)), _abs_bound((ds.transpose(-1, -2), q)),
              _abs_bound((p.transpose(-1, -2), do)))
    for name, g, r, bound in zip(("dq", "dk", "dv"), got, ref, bounds):
        d = (g.float() - r.float()).abs()
        assert bool((d <= 2 ** -7 * (bound + r.float().abs())).all()), (name, float(d.max()))


def test_flash_attention_function_launches_backward_kernels(cuda):
    from stedm_tpu_torch.ops import LAUNCHES, blocked_attention as a

    q, k, v = (torch.randn(1, 2, 96, 64, generator=cuda, device="cuda")
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.randn(1, 96, 2, 64, generator=cuda, device="cuda").to(torch.bfloat16)
    before = dict(LAUNCHES)
    out = a.flash_attention(q, k, v, 0.125)
    # the output gradient reaches the Function non-contiguous, as behind a reshape
    out.transpose(1, 2).backward(do)
    assert LAUNCHES["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 1
    assert LAUNCHES["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    # the kernels are deterministic: the Function's output and gradients equal
    # the direct launches on the same saved output and LSE bit for bit
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o, lse = a.flash_attention_cuda(qd, kd, vd, 0.125, return_lse=True)
    assert torch.equal(out.detach(), o)
    direct = a.flash_attention_bwd_cuda(qd, kd, vd, o, lse, do.transpose(1, 2).contiguous(),
                                        0.125)
    for name, t, d in zip(("dq", "dk", "dv"), (q, k, v), direct):
        assert torch.equal(t.grad, d), name


def test_flash_attention_backward_gates_head_dim(cuda):
    from stedm_tpu_torch.ops import blocked_attention as a

    q = torch.randn(1, 1, 64, 512, generator=cuda, device="cuda").to(torch.bfloat16)
    o, lse = a.flash_attention_cuda(q, q, q, 0.05, return_lse=True)
    with pytest.raises(ValueError, match="head dims"):
        a.flash_attention_bwd_cuda(q, q, q, o, lse, o, 0.05)


@pytest.mark.parametrize("shape,mode", [((2, 16, 16, 128), "add"), ((2, 8, 8, 640), "plain"),
                                        ((2, 8, 8, 256), "film")])
def test_gn_silu_function_backward(cuda, shape, mode):
    from stedm_tpu_torch.ops import gn_silu as g

    b, c = shape[0], shape[3]
    x = torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(c, generator=cuda, device="cuda")
    beta = 0.1 * torch.randn(c, generator=cuda, device="cuda")
    extra = {"add": ["add"], "film": ["film_scale", "film_shift"], "plain": []}[mode]
    kw = {n: 0.5 * torch.randn(b, c, generator=cuda, device="cuda") for n in extra}
    dy = torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta, *kw.values())]
        y = fn(leaves[0], leaves[1], leaves[2], **dict(zip(kw, leaves[3:])))
        y.backward(dy)
        return [t.grad.float() for t in leaves]

    got = grads(g.gn_silu)                      # GNSiLUFunction: Triton forward
    ref = grads(g.gn_silu_reference)            # autograd of the plain version
    for gg, rr in zip(got, ref):
        # dx rounds to bf16; the fp32 sums run in other orders
        torch.testing.assert_close(gg, rr, rtol=2 ** -7, atol=1e-3 * float(rr.abs().max()))
