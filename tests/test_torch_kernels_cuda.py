"""The port's hand-written kernels against their plain versions on the card.

These need a CUDA card and nvcc; without a card they skip (the CPU tests hold
the plain versions against the JAX package). On a card machine:

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


def _gn_case(gen, shape, mode, x_dtype, vec_dtype):
    b, c = shape[0], shape[3]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(x_dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
    names = {"plain": [], "add": ["add"], "film": ["film_scale", "film_shift"]}[mode]
    kw = {n: (0.5 * torch.randn(b, c, generator=gen, device="cuda")).to(vec_dtype)
          for n in names}
    return x, gamma, beta, kw


@pytest.mark.parametrize("shape,mode", [((2, 8, 8, 128), "add"), ((3, 7, 5, 96), "film"),
                                        ((2, 16, 16, 640), "plain"), ((1, 128, 128, 128), "add")])
def test_gn_silu_kernel_fp32(cuda, shape, mode):
    """fp32 x and vectors, at a resident and at a re-read shape."""
    from stedm_tpu_torch.ops import gn_silu as g

    x, gamma, beta, kw = _gn_case(cuda, shape, mode, torch.float32, torch.float32)
    got = g.gn_silu_cuda(x, gamma, beta, **kw)
    assert got.dtype == torch.float32
    # fp32 sums in another order; rsqrtf and __expf within a few ulps
    torch.testing.assert_close(got, g.gn_silu_reference(x, gamma, beta, **kw), rtol=1e-4,
                               atol=1e-4)


# a slab that stays resident and one whose CTAs read part of their tile
# again (64 boxes of rows a CTA, 13 slots), bf16 x with bf16 and fp32 vectors
@pytest.mark.parametrize("shape,mode,resident", [((2, 96, 96, 256), "add", True),
                                                 ((1, 256, 256, 64), "film", False),
                                                 ((2, 128, 128, 128), "plain", False)])
@pytest.mark.parametrize("vec_dtype", [torch.bfloat16, torch.float32])
def test_gn_silu_kernel_resident_and_reread(cuda, shape, mode, resident, vec_dtype):
    from stedm_tpu_torch.ops import gn_silu as g

    b, h, w, c = shape
    assert g._launch_plan(b, h * w, c, 32, 2, g._device_active(0))["resident"] == resident
    x, gamma, beta, kw = _gn_case(cuda, shape, mode, torch.bfloat16, vec_dtype)
    got = g.gn_silu_cuda(x, gamma, beta, eps=1e-6, **kw)
    _close(got, g.gn_silu_reference(x, gamma, beta, eps=1e-6, **kw), 2 ** -7, 2 ** -9)
    # the sums meet in a fixed order: a second launch gives the same bits
    assert torch.equal(got, g.gn_silu_cuda(x, gamma, beta, eps=1e-6, **kw))


def test_gn_silu_kernel_empty_last_cta(cuda):
    """9 rows (3 channels a group) over a cluster of 8 CTAs of 2 rows each:
    the last three CTAs have none and still meet the cluster's barriers."""
    from stedm_tpu_torch.ops import gn_silu as g

    shape = (3, 3, 3, 96)
    p = g._plan_for(3, 9, 96, 3, 2, 96, 8, g._device_active(0))
    assert p["cluster"] == 8 and p["rows_per_cta"] == 2
    for mode in ("plain", "add", "film"):
        x, gamma, beta, kw = _gn_case(cuda, shape, mode, torch.bfloat16, torch.bfloat16)
        vecs = [kw.get(k) for k in ("add", "film_scale", "film_shift")]
        got = g._launch(x, gamma, beta, *vecs, 1e-5, True, g._ints(p))
        _close(got, g.gn_silu_reference(x, gamma, beta, **kw), 2 ** -7, 2 ** -9)
        assert torch.equal(got, g._launch(x, gamma, beta, *vecs, 1e-5, True, g._ints(p)))
        # the plan the wrapper picks itself agrees too
        _close(g.gn_silu_cuda(x, gamma, beta, **kw), g.gn_silu_reference(x, gamma, beta, **kw),
               2 ** -7, 2 ** -9)


def test_gn_silu_kernel_launches_from_another_thread(cuda):
    """Autograd's worker thread (a checkpointed block's recomputed forward)
    launches the kernel as the first thread does."""
    import threading

    from stedm_tpu_torch.ops import gn_silu as g

    x, gamma, beta, kw = _gn_case(cuda, (2, 16, 16, 640), "add", torch.bfloat16, torch.float32)
    here = g.gn_silu_cuda(x, gamma, beta, **kw)
    there = []
    worker = threading.Thread(target=lambda: there.append(g.gn_silu_cuda(x, gamma, beta, **kw)))
    worker.start()
    worker.join()
    assert len(there) == 1 and torch.equal(here, there[0])


def test_gn_silu_kernel_refusals(cuda):
    from stedm_tpu_torch.ops import gn_silu as g

    x, gamma, beta, kw = _gn_case(cuda, (2, 8, 8, 128), "add", torch.bfloat16, torch.float32)
    with pytest.raises(ValueError):
        g.gn_silu_cuda(x.half(), gamma, beta)
    with pytest.raises(ValueError):
        g.gn_silu_cuda(x.permute(0, 2, 1, 3), gamma, beta)
    with pytest.raises(ValueError):
        g.gn_silu_cuda(x, gamma, beta.bfloat16())
    with pytest.raises(ValueError):
        g.gn_silu_cuda(x, gamma, beta, film_scale=kw["add"], film_shift=kw["add"].bfloat16())
    with pytest.raises(ValueError):
        g.gn_silu_cuda(x, gamma, beta, film_scale=kw["add"])
    with pytest.raises(ValueError):
        g.gn_silu_cuda(x, gamma, beta, add=kw["add"], film_scale=kw["add"], film_shift=kw["add"])


@pytest.mark.parametrize("shape", [(2, 2, 256, 128), (1, 1, 200, 512), (1, 3, 70, 64),
                                   (2, 1, 130, 192), (1, 2, 65, 256), (2, 32, 256, 32),
                                   (2, 1, 256, 1024), (1, 2, 100, 640)])
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
    """Every head dimension runs: above 1024 ``flash_attention`` and
    ``sdpa(impl='flash')`` launch the band forward (``flash_band``)."""
    from stedm_tpu_torch.ops import LAUNCHES, blocked_attention as a

    q = torch.randn(1, 1, 64, 1152, generator=cuda, device="cuda").to(torch.bfloat16)
    before = LAUNCHES["flash_band"]
    for out in (a.flash_attention(q, q, q, 0.1), a.sdpa(q, q, q, 0.1 ** 0.5, impl="flash")):
        ref = a.attention_reference(q, q, q, 0.1)
        assert bool(((out.float() - ref.float()).abs()
                     <= _attention_tolerance(q, q, q, 0.1, ref)).all())
    assert LAUNCHES["flash_band"] == before + 2


def _attention_tolerance(q, k, v, s, ref):
    """2^-7 (P |V| + |ref|): both sides round P and the output to bf16."""
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * s, dim=-1)
    return 2 ** -7 * (p @ v.float().abs() + ref.float().abs())


@pytest.mark.parametrize("shape", [(2, 3, 40, 64), (1, 2, 200, 64), (2, 2, 200, 128),
                                   (1, 2, 200, 256), (1, 1, 40, 512), (1, 1, 4096 + 8, 512),
                                   (1, 2, 333, 320), (1, 2, 333, 448), (2, 3, 40, 32),
                                   (1, 4, 1030, 32)])
def test_flash_attention_forward_ragged_and_lse(cuda, shape):
    """Every head-dimension class at ragged T (below a tile, between tiles,
    long): O against the plain version, the LSE against torch.logsumexp, and
    a second run equal to the first bit for bit."""
    from stedm_tpu_torch.ops import blocked_attention as a

    q, k, v = (torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    s = shape[-1] ** -0.5
    got, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
    ref = a.attention_reference(q, k, v, s)
    assert bool(torch.isfinite(got.float()).all())
    assert bool(((got.float() - ref.float()).abs() <= _attention_tolerance(q, k, v, s, ref)).all())
    lse_ref = torch.logsumexp((q.float() @ k.float().transpose(-1, -2)) * s, -1)
    # fp32 sums in another order
    assert bool(((lse - lse_ref).abs() <= 1e-5 * lse_ref.abs() + 1e-4).all())
    again, lse_again = a.flash_attention_cuda(q, k, v, s, return_lse=True)
    assert torch.equal(got, again) and torch.equal(lse, lse_again)
    assert torch.equal(got, a.flash_attention_cuda(q, k, v, s))   # without the LSE


@pytest.mark.parametrize("shape", [(4, 8, 1100, 64), (3, 16, 700, 128), (6, 30, 100, 192),
                                   (8, 32, 1024, 32),
                                   (8, 4, 1000, 256), (5, 40, 60, 128)])
def test_flash_attention_more_work_items_than_blocks(cuda, shape):
    """Up to Dh 256 the kernel is persistent: more (head, query tile) items
    than SMs, so a block walks over several, with one, two and many key tiles
    an item and with one and two Q buffers."""
    from stedm_tpu_torch.ops import blocked_attention as a

    q, k, v = (torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    s = shape[-1] ** -0.5
    got, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
    for i in range(shape[0]):   # a sample at a time keeps the fp32 logits small
        qi, ki, vi = q[i:i + 1], k[i:i + 1], v[i:i + 1]
        ref = a.attention_reference(qi, ki, vi, s)
        tol = _attention_tolerance(qi, ki, vi, s, ref)
        assert bool(((got[i:i + 1].float() - ref.float()).abs() <= tol).all()), i
        lse_ref = torch.logsumexp((qi.float() @ ki.float().transpose(-1, -2)) * s, -1)
        assert bool(((lse[i:i + 1] - lse_ref).abs() <= 1e-5 * lse_ref.abs() + 1e-4).all()), i
    again = a.flash_attention_cuda(q, k, v, s)
    assert torch.equal(got, again)


@pytest.mark.parametrize("b,t,h,dh", [(2, 256, 8, 128), (1, 200, 4, 64), (2, 70, 1, 512),
                                     (2, 256, 32, 32)])
def test_flash_attention_strided_equals_contiguous(cuda, b, t, h, dh):
    """q, k, v as views of a packed [B, T, H, 3, Dh] projection and a
    token-major output: bit for bit the contiguous launch."""
    from stedm_tpu_torch.ops import blocked_attention as a

    proj = torch.randn((b, t, h, 3, dh), generator=cuda, device="cuda").to(torch.bfloat16)
    q, k, v = proj.permute(0, 2, 3, 1, 4).unbind(2)
    assert not q.is_contiguous()
    s = dh ** -0.5
    out = torch.empty((b, t, h, dh), device="cuda", dtype=torch.bfloat16).permute(0, 2, 1, 3)
    got = a.flash_attention_cuda(q, k, v, s, out=out)
    assert got.data_ptr() == out.data_ptr()
    ref = a.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), s)
    assert torch.equal(got, ref)
    # the no-gradient entry point lays O out token-major, so the heads merge as a view
    via = a.flash_attention(q, k, v, s)
    assert torch.equal(via, ref)
    merged = via.transpose(1, 2).reshape(b, t, h * dh)
    assert merged.data_ptr() == via.data_ptr()


def test_flash_attention_cuda_refusals(cuda):
    from stedm_tpu_torch.ops import blocked_attention as a

    q = torch.zeros(1, 2, 64, 72, dtype=torch.bfloat16, device="cuda")
    ok = q[..., :64]
    a.flash_attention_cuda(ok, ok, ok, 0.1)                 # a row pitch of 144 bytes is fine
    with pytest.raises(ValueError):
        a.flash_attention_cuda(q[..., 4:68], ok, ok, 0.1)   # rows start 8 bytes off
    with pytest.raises(ValueError):
        a.flash_attention_cuda(ok, ok, ok.float(), 0.1)
    with pytest.raises(ValueError):
        a.flash_attention_cuda(ok, ok, ok, 0.1, out=torch.empty(1, 2, 64, 128, device="cuda",
                                                                 dtype=torch.bfloat16))


def test_nearest_code_kernel(cuda):
    from stedm_tpu_torch.ops import quantize as qz

    z = torch.randn(3000, 3, generator=cuda, device="cuda")
    cb = torch.randn(5000, 3, generator=cuda, device="cuda")
    got, ref = qz.nearest_code(z, cb), qz.nearest_code_reference(z, cb)
    diff = (got != ref).nonzero().flatten()
    d = lambda i: ((z[diff].double() - cb[i[diff].long()].double()) ** 2).sum(1)
    assert bool(((d(got) - d(ref)).abs() <= 1e-5 * (1 + (z[diff] ** 2).sum(1))).all())


# N not a multiple of the 512-token tile; codebooks split across 8, 8 and 1
# CTAs, slices of 1024, 132 and 8 codes (132: blocks of 64 codes with a
# partial last one), the last slice not a multiple of 4 codes (its tail
# loaded by threads)
@pytest.mark.parametrize("n,n_embed", [(3000, 8192), (2049, 1030), (70, 5)])
def test_nearest_code_kernel_duplicated_codes(cuda, n, n_embed):
    """A codebook whose second half repeats its first, each code also
    repeated within its slice, and tokens placed on codes: the lower index
    must win every tie, across the CTAs of a cluster and within one."""
    from stedm_tpu_torch.ops import quantize as qz

    half = (n_embed + 1) // 2
    base = torch.randn(half, 3, generator=cuda, device="cuda")
    cb = torch.cat([base, base])[:n_embed].contiguous()
    cb[1::7] = cb[0::7][:cb[1::7].shape[0]]         # neighbours within a slice too
    pick = torch.randint(0, n_embed, (n,), generator=cuda, device="cuda")
    z = cb[pick].clone()
    z[::3] += 0.01 * torch.randn(z[::3].shape, generator=cuda, device="cuda")
    got = qz.nearest_code_cuda(z, cb)
    ref = qz.nearest_code_reference(z, cb)
    # exact ties on the duplicates: the first index of equal rows wins
    rows = [tuple(r) for r in cb.tolist()]
    first = {}
    for i, row in enumerate(rows):
        first.setdefault(row, i)
    assert all(first[rows[i]] == i for i in got.tolist())
    diff = (got != ref).nonzero().flatten()
    d = lambda i: ((z[diff].double() - cb[i[diff].long()].double()) ** 2).sum(1)
    assert bool(((d(got) - d(ref)).abs() <= 1e-5 * (1 + (z[diff] ** 2).sum(1))).all())
    assert torch.equal(got, qz.nearest_code_cuda(z, cb))


# the flagship decode (split 2, 4096 codes a CTA), split 4, and splits of 8
# whose slices hold 128 and 20 codes (the last rank of the latter none)
@pytest.mark.parametrize("n,n_embed", [(32768, 8192), (8192, 8192), (1000, 1000), (513, 130)])
def test_nearest_code_kernel_is_the_argmin_in_its_own_order(cuda, n, n_embed):
    """On a coarse grid many distances tie exactly. The kernel's index is
    the first minimum of the distances formed in its own order of rounding
    (||c||^2 - 2 ((z0 c0 + z1 c1) + z2 c2), each product and sum rounded),
    which torch's elementwise fp32 ops reproduce, for every token."""
    from stedm_tpu_torch.ops import quantize as qz

    cb = (torch.randint(-6, 7, (n_embed, 3), generator=cuda, device="cuda") * 0.25).float()
    z = (torch.randint(-8, 9, (n, 3), generator=cuda, device="cuda") * 0.125).float()
    got = qz.nearest_code_cuda(z, cb)
    w = (cb[:, 0] * cb[:, 0] + cb[:, 1] * cb[:, 1]) + cb[:, 2] * cb[:, 2]
    want = []
    for zc in z.split(4096):
        dot = (zc[:, :1] * cb[:, 0] + zc[:, 1:2] * cb[:, 1]) + zc[:, 2:] * cb[:, 2]
        want.append(torch.argmin(w - 2 * dot, dim=1).to(torch.int32))   # the first minimum
    assert torch.equal(got, torch.cat(want))


def _rms_bound(*pairs):
    """sqrt(sum (a b)^2) over each product's terms: the scale of what
    rounding its terms independently moves the sum."""
    return sum(a.float().square() @ b.float().square() for a, b in pairs).sqrt()


def _backward_tolerance(q, k, v, o, do, s, ref):
    """2^-7 (sqrt(sum terms^2) + |ref|) for dq, dk, dv: P and dS are rounded
    to bf16 on both sides (at most one ulp apart), the sums run in other
    orders and the outputs round to bf16 (one ulp is at most 2^-7 |ref|)."""
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * s, -1)
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - (do.float() * o.float()).sum(-1, keepdim=True)) * s
    bounds = (_rms_bound((ds, k)), _rms_bound((ds.transpose(-1, -2), q)),
              _rms_bound((p.transpose(-1, -2), do)))
    return [2 ** -7 * (bd + r.float().abs()) for bd, r in zip(bounds, ref)]


# ragged T below one 128-key tile, between tiles and long; Dh 64 and 128; and
# more (head, key tile) blocks than SMs (3 * 48 heads of two key tiles); Dh
# 256 and 512 (clusters of two and four blocks), one key tile and ragged, and
# more clusters than the card holds at once (2 * 40 key tiles)
@pytest.mark.parametrize("shape", [(2, 2, 256, 128), (1, 3, 70, 64), (1, 2, 130, 128),
                                   (2, 4, 4, 64), (1, 2, 40, 128), (2, 2, 200, 64),
                                   (1, 2, 1100, 128), (3, 48, 130, 64), (2, 40, 256, 128),
                                   (1, 1, 256, 512), (1, 1, 100, 512), (2, 1, 1000, 512),
                                   (1, 2, 300, 256), (2, 1, 5120, 512), (1, 3, 70, 32),
                                   (1, 2, 130, 32), (2, 32, 1024, 32)])
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
    for name, g, r, tol in zip(("dq", "dk", "dv"), got, ref,
                               _backward_tolerance(q, k, v, o, do, s, ref)):
        d = (g.float() - r.float()).abs()
        assert bool((d <= tol).all()), (name, float(d.max()))
    # dQ's parts are added in a fixed order: a second launch gives the same bits
    again = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
    for name, g, g2 in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(g, g2), name


@pytest.mark.parametrize("b,t,h,dh", [(2, 256, 8, 128), (1, 200, 4, 64), (2, 1030, 2, 128),
                                      (2, 700, 1, 512), (2, 1030, 4, 32)])
def test_flash_attention_backward_strided_equals_contiguous(cuda, b, t, h, dh):
    """q, k, v as views of a packed [B, T, H, 3, Dh] projection and a
    token-major output gradient: bit for bit the launch on contiguous copies."""
    from stedm_tpu_torch.ops import blocked_attention as a

    proj = torch.randn((b, t, h, 3, dh), generator=cuda, device="cuda").to(torch.bfloat16)
    q, k, v = proj.permute(0, 2, 3, 1, 4).unbind(2)
    do = torch.randn((b, t, h, dh), generator=cuda, device="cuda").to(torch.bfloat16)
    do = do.permute(0, 2, 1, 3)
    # one head (AttnBlockVQ's): a token-major gradient is contiguous
    assert not q.is_contiguous() and (h == 1 or not do.is_contiguous())
    s = dh ** -0.5
    o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
    got = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
    ref = a.flash_attention_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                     o.contiguous(), lse, do.contiguous(), s)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.equal(g, r), name


@pytest.mark.parametrize("shape", [(2, 3, 70, 64), (1, 2, 300, 128), (1, 1, 200, 512),
                                   (2, 3, 70, 32)])
def test_flash_attention_backward_di_pass(cuda, shape):
    """The Di pass's output at the head of the workspace: LSE * log2(e) and
    Di = rowsum(dO o O) per 64-row query tile, +inf and 0 past T."""
    from stedm_tpu_torch.ops import blocked_attention as a

    b, h, t, dh = shape
    q, k, v, do = (torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o, lse = a.flash_attention_cuda(q, k, v, dh ** -0.5, return_lse=True)
    ws = torch.empty(a.bwd_workspace_bytes(b * h, t, dh), device="cuda", dtype=torch.uint8)
    a.flash_attention_bwd_cuda(q, k, v, o, lse, do, dh ** -0.5, workspace=ws)
    nq = (t + 63) // 64
    stats = ws[:b * h * nq * 2 * 64 * 4].view(torch.float32).view(b, h, nq, 2, 64)
    stats = stats.transpose(2, 3).reshape(b, h, 2, nq * 64)
    # fp32 sums of Dh products in another order
    torch.testing.assert_close(stats[:, :, 1, :t], a._row_dot(do, o), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stats[:, :, 0, :t], lse * 1.4426950408889634, rtol=1e-6,
                               atol=1e-6)
    assert bool((stats[:, :, 1, t:] == 0).all() and torch.isinf(stats[:, :, 0, t:]).all())


def test_flash_attention_function_launches_backward_kernels(cuda):
    from stedm_tpu_torch.ops import LAUNCHES, blocked_attention as a

    proj = torch.randn(1, 96, 2, 3, 64, generator=cuda, device="cuda").to(torch.bfloat16)
    proj.requires_grad_()
    q, k, v = proj.permute(0, 2, 3, 1, 4).unbind(2)
    do = torch.randn(1, 96, 2, 64, generator=cuda, device="cuda").to(torch.bfloat16)
    before = dict(LAUNCHES)
    out = a.flash_attention(q, k, v, 0.125)
    # O is laid out token-major, so the heads merge as a view; the output
    # gradient reaches the Function as a token-major view
    assert out.transpose(1, 2).is_contiguous()
    out.transpose(1, 2).backward(do)
    assert LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    # the Function's output and gradients equal the direct launches on the
    # same saved output and LSE bit for bit
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o, lse = a.flash_attention_cuda(qd, kd, vd, 0.125, return_lse=True)
    assert torch.equal(out.detach(), o)
    direct = a.flash_attention_bwd_cuda(qd, kd, vd, o, lse, do.transpose(1, 2), 0.125)
    grads = proj.grad.permute(0, 2, 3, 1, 4).unbind(2)
    for name, g, d in zip(("dq", "dk", "dv"), grads, direct):
        assert torch.equal(g, d), name


@pytest.mark.parametrize("shape", [(1, 2, 96, 64), (2, 2, 300, 128), (1, 1, 200, 512)])
def test_flash_attention_launches_from_another_thread(cuda, shape):
    """Autograd runs a backward (and a checkpointed block's recomputed
    forward) on its own host thread: the kernels launch there as they do
    on the thread that first launched them."""
    import threading

    from stedm_tpu_torch.ops import blocked_attention as a

    q, k, v, do = (torch.randn(shape, generator=cuda, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    s = shape[-1] ** -0.5
    bwd = shape[-1] in a.BWD_HEAD_DIMS

    def run():
        o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
        return (o, lse, *a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)) if bwd else (o, lse)

    here = run()
    there = []
    worker = threading.Thread(target=lambda: there.append(run()))
    worker.start()
    worker.join()
    assert len(there) == 1, "the launch on the other thread raised"
    for x, y in zip(here, there[0]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dh", [1152, 2048])
def test_flash_attention_backward_gates_head_dim(cuda, dh):
    """Above 1024 the backward runs the band route (counted as
    ``flash_band_bwd``) within phase 2b's tolerance."""
    from stedm_tpu_torch.ops import LAUNCHES, blocked_attention as a

    q, k, v, do = (torch.randn(1, 1, 64, dh, generator=cuda, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o, lse = a.flash_attention_cuda(q, k, v, 0.05, return_lse=True)
    before = LAUNCHES["flash_band_bwd"]
    got = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, 0.05)
    assert LAUNCHES["flash_band_bwd"] == before + 1
    ref = a.attention_backward_reference(q, k, v, o, lse, do, 0.05)
    for name, g, r, tol in zip(("dq", "dk", "dv"), got, ref,
                               _backward_tolerance(q, k, v, o, do, 0.05, ref)):
        assert bool(((g.float() - r.float()).abs() <= tol).all()), name


# every head dimension up to 1024 on the smallest instance at or above it:
# the bf16 backward's Dh-32 instance (256 keys a block: one key tile, two,
# ragged, many), Dh 16 on it, the copy route (Dh 20, 8 and 4: rows not 16
# bytes apart), the padded instances (the backward's 192-448 on its cluster
# instances, whose last ranks hold only zero columns), the cluster instances
# above 512 (520 on 640: rank 4 of 5 holds 8 real columns; 768 and 1024
# ragged), the band route above 1024 (1100: bf16 copies of width 1104;
# 2048 over two heads); bf16 and fp32
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(1, 2, 100, 32), (2, 3, 300, 32), (1, 2, 256, 32),
                                   (2, 8, 1100, 32), (2, 4, 300, 16), (1, 3, 200, 20),
                                   (1, 2, 70, 4), (2, 2, 130, 8), (1, 2, 300, 48),
                                   (1, 2, 300, 96), (1, 2, 300, 160), (1, 2, 300, 192),
                                   (1, 2, 300, 320), (1, 1, 300, 448), (1, 2, 300, 520),
                                   (1, 1, 200, 768), (2, 1, 140, 1024), (1, 2, 300, 1100),
                                   (1, 1, 130, 1152), (2, 1, 140, 2048)])
def test_flash_attention_every_head_dim(cuda, dtype, shape):
    from stedm_tpu_torch.ops import LAUNCHES, blocked_attention as a

    q, k, v, do = (torch.randn(shape, generator=cuda, device="cuda").to(dtype)
                   for _ in range(4))
    d = shape[-1]
    s = d ** -0.5
    before = dict(LAUNCHES)
    o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
    ref_o = a.attention_reference(q, k, v, s)
    rel = 2 ** -16 if dtype == torch.float32 else 2 ** -7
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * s, dim=-1)
    tol_o = rel * (p @ v.float().abs() + ref_o.float().abs())
    assert bool(((o.float() - ref_o.float()).abs() <= tol_o).all())
    got = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
    if dtype == torch.bfloat16:     # phase 2b's test
        ref = a.attention_backward_reference(q, k, v, o, lse, do, s)
        tols = _backward_tolerance(q, k, v, o, do, s, ref)
    else:                           # 10a's: the plain steps in float64
        ref, bounds = _f64_backward(q, k, v, o, lse, do, s)
        tols = [2 ** -16 * (bd + r.abs()) for bd, r in zip(bounds, ref)]
    for name, g, r, tol in zip(("dq", "dk", "dv"), got, ref, tols):
        err = (g.double() - r.double()).abs()
        assert bool((err <= tol).all()), (name, float(err.max()))
    again = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for launches, stem in zip((1, 2), a.KERNELS[dtype]):     # the forward once, the backward twice
        key = a.launch_counter(stem, d)
        assert LAUNCHES[key] - before.get(key, 0) == launches, key


def test_sdpa_runs_the_plain_attention_above_512(cuda):
    """Above 1024 (Dh 1152) every impl launches the band kernels (counted as
    ``flash_band`` and ``flash_band_bwd``) with their gradient, the output
    within phase 2's tolerance of the exact path. At Dh 1024 (the landscape
    bottleneck at num_heads 1) every impl launches the cluster kernels,
    counted as ``<kernel>_dh1024``."""
    from stedm_tpu_torch.ops import LAUNCHES, blocked_attention as a

    q, k, v = (torch.randn((2, 1, 256, 1152), generator=cuda, device="cuda")
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    for impl in ("exact", "chunked", "auto", "flash"):
        before = dict(LAUNCHES)
        out = a.sdpa(q, k, v, 1152 ** -0.25, impl=impl, q_chunk=64)
        ref = a.attention_reference(q, k, v, 1152 ** -0.5)
        p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * 1152 ** -0.5, -1)
        tol = 2 ** -7 * (p @ v.float().abs() + ref.float().abs())
        assert bool(((out.float() - ref.float()).abs() <= tol).all()), impl
        out.float().sum().backward()
        assert LAUNCHES["flash_band"] == before["flash_band"] + 1
        assert LAUNCHES["flash_band_bwd"] == before["flash_band_bwd"] + 1
    q, k, v = (x[..., :1024].detach().contiguous().requires_grad_() for x in (q, k, v))
    before = dict(LAUNCHES)
    for impl in ("exact", "chunked", "auto", "flash"):
        a.sdpa(q, k, v, 1024 ** -0.25, impl=impl).float().sum().backward()
    assert LAUNCHES["flash_attention_dh1024"] - before.get("flash_attention_dh1024", 0) == 4
    assert LAUNCHES["flash_attention_bwd_dh1024"] - before.get("flash_attention_bwd_dh1024", 0) == 4
    assert LAUNCHES["flash_band"] == before["flash_band"]


def test_codec_attention_above_1024_runs_the_plain_attention(cuda):
    """AttnBlockVQ above 1024 channels launches the band forward on the card
    (fp32 here, counted as ``flash_band_f32``) and matches its CPU copy (the
    band route's plain versions); at 1024 it launches the Dh-1024 forward."""
    from stedm_tpu_torch.models.vq import AttnBlockVQ
    from stedm_tpu_torch.ops import LAUNCHES

    for c, key in ((1152, "flash_band_f32"), (1024, "flash_attention_f32_dh1024")):
        torch.manual_seed(c)
        block = AttnBlockVQ(c).eval()
        x = torch.randn(1, c, 8, 8)
        with torch.no_grad():
            ref = block(x)
            before = LAUNCHES.get(key, 0)
            got = block.cuda()(x.cuda()).cpu()
        assert LAUNCHES[key] == before + 1
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


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

    got = grads(g.gn_silu)                      # GNSiLUFunction: CUDA forward
    ref = grads(g.gn_silu_reference)            # autograd of the plain version
    for gg, rr in zip(got, ref):
        # dx rounds to bf16; the fp32 sums run in other orders
        torch.testing.assert_close(gg, rr, rtol=2 ** -7, atol=1e-3 * float(rr.abs().max()))


def _tiny_serving(seed: int, p: int = 32):
    """A tiny bf16 STEDM on the card, a batch and the composed serving mode
    (refreshes (0, 3, 5) of 8 steps, window (0.25, 0.75), CFG 1.5)."""
    from stedm_tpu_torch.core.schedules import DiffusionSchedule
    from stedm_tpu_torch.models.stedm import STEDM
    from stedm_tpu_torch.train.steps import SamplerConfig

    torch.manual_seed(seed)
    model = STEDM(dtype=torch.bfloat16, unet_config=dict(
        in_channels=6, out_channels=3, model_channels=32, num_res_blocks=1,
        channel_mult=(1, 4, 8), num_heads=4, attention_resolutions=(32, 16, 8)),
        first_stage_config=dict(embed_dim=3, n_embed=256, ddconfig=dict(
            z_channels=3, resolution=p, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2, 2],
            num_res_blocks=1, attn_resolutions=[])),
        cond_stage_config=dict(n_stages=2, in_channels=2, out_channels=3),
        style_agg="mean", style_sampling="nearby", patch_size=p).eval()
    for layer in model.unet.zero_init_layers():
        layer.reset_parameters()
    model.cuda()
    cfg = SamplerConfig(ddim_steps=8, eta=0.0, cfg_scale=1.5, rescale_phi=0.7, downsample=4,
                        cache_schedule=(0, 3, 5), cfg_interval=(0.25, 0.75))
    return model, DiffusionSchedule.create("linear", 1000, 0.0015, 0.0205), cfg


def _tiny_batch(gen, p: int = 32):
    seg = torch.zeros(2, p, p, 2, device="cuda")
    seg[..., 0] = 1
    seg[:, 8:20, 4:28] = torch.tensor([0.0, 1.0], device="cuda")
    return {"segmentation": seg,
            "style_imgs": torch.rand(2, 1, p, p, 3, generator=gen, device="cuda") * 2 - 1}


def _with_latent(sampler, model, batch, x_T):
    """``sampler``'s images and the latent z_0 it handed the decoder."""
    seen, decode = [], model.decode_first_stage
    model.decode_first_stage = lambda z, *a: (seen.append(z.clone()), decode(z, *a))[1]
    try:
        img = sampler(model, batch, x_T=x_T)
    finally:
        del model.decode_first_stage
    return img, seen[0]


@pytest.mark.parametrize("carry", [False, True], ids=["blocks", "carry"])
def test_graph_replay_equals_eager_serving(cuda, carry):
    """The block sampler's CUDA graphs give the eager loop's bits, latent
    z_0 and images, on a tiny serving trajectory; a second call copies new
    inputs into the captured buffers and replays them, and gives the eager
    result on those."""
    from stedm_tpu_torch.ops import LAUNCHES
    from stedm_tpu_torch.train.host_sampler import make_host_sample_fn
    from stedm_tpu_torch.train.steps import make_sample_fn

    model, sched, cfg = _tiny_serving(21)
    eager = make_sample_fn(model, sched, cfg)
    graphs = make_host_sample_fn(model, sched, cfg, unroll=3, carry_cache=carry)
    runs = []
    for _ in range(2):
        batch = _tiny_batch(cuda)
        x_T = torch.randn(2, 8, 8, 3, generator=cuda, device="cuda")
        want, z_want = _with_latent(eager, model, batch, x_T)
        got, z_got = _with_latent(graphs, model, batch, x_T)
        assert torch.equal(z_got, z_want), float((z_got - z_want).abs().max())
        assert torch.equal(got, want), float((got.float() - want.float()).abs().max())
        assert (got.abs() < 1.0).float().mean() > 0.5   # the images are not saturated
        runs.append(z_got)
    assert not torch.equal(runs[0], runs[1])
    assert graphs.capture_launches["gn_silu"] > 0 and graphs.capture_launches[
        "flash_attention"] == 4                  # the bottleneck of the 4 full passes
    before = dict(LAUNCHES)
    graphs(model, _tiny_batch(cuda), x_T=torch.randn(2, 8, 8, 3, generator=cuda, device="cuda"))
    # a replay passes no wrapper: only the eager decode counts (its
    # mid-block attention and one nearest code)
    assert LAUNCHES["flash_attention"] - before["flash_attention"] == 1
    assert LAUNCHES["nearest_code"] - before["nearest_code"] == 1


# ---- the fp32 flash kernels and the streaming nearest code ----

def _f32_forward_tolerance(q, k, v, s, ref):
    """2^-16 (P |V| + |ref|): fp32 products and sums in other orders."""
    p = torch.softmax((q @ k.transpose(-1, -2)) * s, dim=-1)
    return 2 ** -16 * (p @ v.abs() + ref.abs())


# T not a multiple of the 64-row / 64-key tiles, Dh 512 below one tile, and
# every cluster size (Dh / 128, or Dh / 64 at 192, 320, 448); the Dh-32
# instance at Dh 4 .. 32, ragged over its 128-row work items, with more
# work items than SMs (its blocks walk several) and a single row
@pytest.mark.parametrize("shape", [(2, 3, 40, 64), (1, 2, 200, 128), (1, 1, 130, 192),
                                   (1, 2, 300, 256), (1, 1, 100, 320), (1, 1, 333, 448),
                                   (1, 1, 2500, 512), (3, 16, 300, 128), (2, 2, 97, 384),
                                   (1, 2, 40, 512), (2, 1, 1, 512), (1, 3, 129, 64),
                                   (2, 3, 40, 32), (2, 8, 1024, 32), (2, 3, 200, 4),
                                   (1, 2, 130, 8), (2, 2, 300, 16), (1, 3, 257, 20),
                                   (2, 1, 129, 28), (4, 40, 300, 32), (2, 2, 1, 32)])
def test_flash_attention_f32_forward(cuda, shape):
    """Every head-dimension class at ragged T: O within 2^-16 (P|V| + |ref|)
    of the plain version (TF32 off), the LSE against torch.logsumexp, two
    launches bit for bit."""
    from stedm_tpu_torch.ops import LAUNCHES, blocked_attention as a

    q, k, v = (torch.randn(shape, generator=cuda, device="cuda") for _ in range(3))
    s = shape[-1] ** -0.5
    counter = a.launch_counter("flash_attention_f32", shape[-1])
    before = LAUNCHES.get(counter, 0)
    got, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
    assert LAUNCHES[counter] == before + 1
    ref = a.attention_reference(q, k, v, s)
    assert bool(((got - ref).abs() <= _f32_forward_tolerance(q, k, v, s, ref)).all())
    lse_ref = torch.logsumexp((q @ k.transpose(-1, -2)) * s, -1)
    assert bool(((lse - lse_ref).abs() <= 1e-5 * lse_ref.abs() + 1e-5).all())
    assert torch.equal(got, a.flash_attention_cuda(q, k, v, s))


@pytest.mark.parametrize("b,t,h,dh", [(2, 256, 8, 128), (1, 200, 4, 64), (2, 70, 1, 512),
                                     (2, 256, 8, 32), (1, 200, 4, 16), (2, 70, 3, 20)])
def test_flash_attention_f32_strided_equals_contiguous(cuda, b, t, h, dh):
    from stedm_tpu_torch.ops import blocked_attention as a

    proj = torch.randn((b, t, h, 3, dh), generator=cuda, device="cuda")
    q, k, v = proj.permute(0, 2, 3, 1, 4).unbind(2)
    s = dh ** -0.5
    out = torch.empty((b, t, h, dh), device="cuda").permute(0, 2, 1, 3)
    got = a.flash_attention_cuda(q, k, v, s, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, a.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                                   v.contiguous(), s))


def _f64_backward(q, k, v, o, lse, do, s):
    """attention_backward_reference's steps in float64 and each gradient's
    sqrt(sum terms^2): the fp32 plain version sums 16k keys in one cuBLAS
    sequence, whose own error reaches the fp32 tolerance there."""
    Q, K, V, O, DO = (x.double() for x in (q, k, v, o, do))
    log2e = 1.4426950408889634
    P = torch.exp2((Q @ K.transpose(-1, -2)) * (s * log2e) - lse.double()[..., None] * log2e)
    dS = P * (DO @ V.transpose(-1, -2) - (DO * O).sum(-1, keepdim=True)) * s
    ref = (dS @ K, dS.transpose(-1, -2) @ Q, P.transpose(-1, -2) @ DO)
    bounds = ((dS.square() @ K.square()).sqrt(),
              (dS.transpose(-1, -2).square() @ Q.square()).sqrt(),
              (P.transpose(-1, -2).square() @ DO.square()).sqrt())
    return ref, bounds


# T not a multiple of the 32-query / 64-key tiles, Dh 512 below one tile;
# the Dh-32 instance (128 keys a block) at Dh 4 .. 32, a block's second
# 64 keys partly or wholly past T
@pytest.mark.parametrize("shape", [(2, 3, 40, 64), (1, 2, 200, 128), (1, 1, 130, 192),
                                   (1, 2, 300, 256), (1, 1, 100, 320), (1, 1, 257, 512),
                                   (3, 8, 130, 64), (2, 1, 1000, 512), (2, 2, 97, 384),
                                   (1, 2, 20, 512), (1, 1, 333, 448), (2, 1, 33, 128),
                                   (2, 3, 40, 32), (2, 4, 1030, 32), (2, 3, 130, 4),
                                   (1, 2, 200, 8), (2, 2, 333, 16), (1, 3, 97, 20),
                                   (2, 1, 257, 28), (1, 2, 65, 32)])
def test_flash_attention_f32_backward(cuda, shape):
    """dq, dk, dv within 2^-16 (sqrt(sum terms^2) + |ref|) of the plain
    version's steps in float64; two launches give the same bits."""
    from stedm_tpu_torch.ops import LAUNCHES, blocked_attention as a

    q, k, v, do = (torch.randn(shape, generator=cuda, device="cuda") for _ in range(4))
    s = shape[-1] ** -0.5
    o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
    counter = a.launch_counter("flash_attention_bwd_f32", shape[-1])
    before = LAUNCHES.get(counter, 0)
    got = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
    assert LAUNCHES[counter] == before + 1
    ref, bounds = _f64_backward(q, k, v, o, lse, do, s)
    for name, g, r, bd in zip(("dq", "dk", "dv"), got, ref, bounds):
        d = (g.double() - r).abs()
        assert bool((d <= 2 ** -16 * (bd + r.abs())).all()), (name, float(d.max()))
    again = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
    for name, g, g2 in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(g, g2), name


# every cluster instance above 512 (clusters of 5 to 8 blocks of 128
# columns), T ragged over several 64-key and 32-query tiles
@pytest.mark.parametrize("shape", [(1, 1, 700, 640), (1, 1, 130, 768), (2, 1, 333, 896),
                                   (1, 2, 257, 1024)])
def test_flash_attention_f32_cluster_instances(cuda, shape):
    """The forward's O within 2^-16 (P|V| + |ref|) and each gradient within
    2^-16 (sqrt(sum terms^2) + |ref|) of the plain version's steps in
    float64 (the S and dP partials summed across the cluster by a
    reduce-scatter and a gather), each launch counted under its instance."""
    from stedm_tpu_torch.ops import LAUNCHES, blocked_attention as a

    q, k, v, do = (torch.randn(shape, generator=cuda, device="cuda") for _ in range(4))
    s = shape[-1] ** -0.5
    fwd, bwd = (a.launch_counter(stem, shape[-1])
                for stem in ("flash_attention_f32", "flash_attention_bwd_f32"))
    before = dict(LAUNCHES)
    o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
    got = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
    assert LAUNCHES[fwd] == before.get(fwd, 0) + 1
    assert LAUNCHES[bwd] == before.get(bwd, 0) + 1
    Q, K, V = (x.double() for x in (q, k, v))
    p = torch.softmax((Q @ K.transpose(-1, -2)) * s, -1)
    ref = p @ V
    assert bool(((o.double() - ref).abs() <= 2 ** -16 * (p @ V.abs() + ref.abs())).all())
    ref, bounds = _f64_backward(q, k, v, o, lse, do, s)
    for name, g, r, bd in zip(("dq", "dk", "dv"), got, ref, bounds):
        d = (g.double() - r).abs()
        assert bool((d <= 2 ** -16 * (bd + r.abs())).all()), (name, float(d.max()))


@pytest.mark.parametrize("shape", [(2, 2, 700, 512), (2, 4, 333, 128), (1, 2, 650, 192),
                                   (1, 1, 700, 1024), (2, 3, 700, 32), (1, 4, 333, 16)])
def test_flash_attention_f32_backward_is_deterministic(cuda, shape):
    """Many 64-key blocks add their parts of dQ into the sums in key-block
    order behind turn counters (one per head, query tile and cluster rank):
    two launches give the same bits, with a fresh workspace each time and
    with one reused."""
    from stedm_tpu_torch.ops import blocked_attention as a

    b, h, t, d = shape
    q, k, v, do = (torch.randn(shape, generator=cuda, device="cuda") for _ in range(4))
    s = d ** -0.5
    o, lse = a.flash_attention_cuda(q, k, v, s, return_lse=True)
    first = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s)
    ws = torch.empty(a.fp32_plan(b, h, t, d)["bwd_workspace"], device="cuda", dtype=torch.uint8)
    for _ in range(2):
        again = a.flash_attention_bwd_cuda(q, k, v, o, lse, do, s, workspace=ws)
        for name, g, g2 in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(g, g2), name


@pytest.mark.parametrize("d", [32, 64, 192, 256, 512])
def test_flash_attention_f32_refuses_another_cluster(cuda, d):
    """The C side takes only the wrapper's plan: Dh / 128 blocks a cluster,
    or Dh / 64 when Dh is not a multiple of 128, and 1 at Dh 32."""
    import ctypes

    from stedm_tpu_torch.ops import blocked_attention as a

    q = torch.randn((1, 1, 64, d), generator=cuda, device="cuda")
    plan = a.fp32_plan(1, 1, 64, d)
    ws = torch.empty(plan["fwd_workspace"], device="cuda", dtype=torch.uint8)
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*([64 * d, 64 * d, d] * 4))
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), None, ws.data_ptr(),
            1, 1, 64, d)
    assert plan["fwd"](*args, plan["cluster"], strides, 0.1, stream) == 0
    assert plan["fwd"](*args, plan["cluster"] + 1, strides, 0.1, stream) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("dh", [64, 32, 16])
def test_flash_attention_function_f32_launches_fp32_kernels(cuda, dh):
    """The U-Net's AttentionBlock at fp32: FlashAttentionFunction on strided
    views runs the fp32 forward and backward and equals the direct launches."""
    from stedm_tpu_torch.ops import LAUNCHES, blocked_attention as a

    proj = torch.randn(1, 96, 2, 3, dh, generator=cuda, device="cuda").requires_grad_()
    q, k, v = proj.permute(0, 2, 3, 1, 4).unbind(2)
    do = torch.randn(1, 96, 2, dh, generator=cuda, device="cuda")
    fwd, bwd = (a.launch_counter(stem, dh) for stem in ("flash_attention_f32",
                                                         "flash_attention_bwd_f32"))
    before = dict(LAUNCHES)
    out = a.flash_attention(q, k, v, 0.125)
    out.transpose(1, 2).backward(do)
    assert LAUNCHES[fwd] == before[fwd] + 1
    assert LAUNCHES[bwd] == before[bwd] + 1
    assert LAUNCHES["flash_attention"] == before["flash_attention"]
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o, lse = a.flash_attention_cuda(qd, kd, vd, 0.125, return_lse=True)
    assert torch.equal(out.detach(), o)
    direct = a.flash_attention_bwd_cuda(qd, kd, vd, o, lse, do.transpose(1, 2), 0.125)
    grads = proj.grad.permute(0, 2, 3, 1, 4).unbind(2)
    for name, g, d in zip(("dq", "dk", "dv"), grads, direct):
        assert torch.equal(g, d), name


# widths 1-16 (registers) and 20 (read from the L1); codebooks beyond a
# CTA's shared memory at width 3; splits of 8, 2 and 1; a last chunk partly
# padding
@pytest.mark.parametrize("n,width,n_embed", [(3000, 4, 16384), (2049, 8, 1030), (70, 1, 5),
                                             (5000, 16, 4096), (700, 20, 300), (3000, 3, 200000),
                                             (40000, 3, 16384), (1000, 7, 2049)])
def test_nearest_code_stream_kernel(cuda, n, width, n_embed):
    """The streaming kernel against the plain version: equal indices but at
    fp32 near-ties; duplicated codes keep the lowest index; two launches
    equal."""
    from stedm_tpu_torch.ops import LAUNCHES, quantize as qz

    assert qz._launch_plan(n, n_embed, width)["kernel"] == "stream"
    half = (n_embed + 1) // 2
    base = torch.randn(half, width, generator=cuda, device="cuda")
    cb = torch.cat([base, base])[:n_embed].contiguous()
    z = cb[torch.randint(0, n_embed, (n,), generator=cuda, device="cuda")].clone()
    z[::3] += 0.01 * torch.randn(z[::3].shape, generator=cuda, device="cuda")
    before = LAUNCHES["nearest_code_stream"]
    got = qz.nearest_code_cuda(z, cb)
    assert LAUNCHES["nearest_code_stream"] == before + 1
    ref = qz.nearest_code_reference(z, cb)
    rows = [tuple(r) for r in cb.tolist()]
    first = {}
    for i, row in enumerate(rows):
        first.setdefault(row, i)
    assert all(first[rows[i]] == i for i in got.tolist())
    diff = (got != ref).nonzero().flatten()
    d = lambda i: ((z[diff].double() - cb[i[diff].long()].double()) ** 2).sum(1)
    assert bool(((d(got) - d(ref)).abs() <= 1e-5 * (1 + (z[diff] ** 2).sum(1))).all())
    assert torch.equal(got, qz.nearest_code_cuda(z, cb))


@pytest.mark.parametrize("n,n_embed", [(40000, 16384), (3000, 5000)])
def test_nearest_code_stream_is_the_argmin_in_its_own_order(cuda, n, n_embed):
    """Widths 3 (at 16384 codes and 40000 tokens through the streaming
    kernel, the slice too large for the resident one) and 4 (padded to 8):
    on a coarse grid many distances tie exactly; the index is the first minimum of the distances
    formed in the kernel's order (||c||^2 - 2 (((z0 c0 + z1 c1) + z2 c2) +
    ...), each product and sum rounded)."""
    from stedm_tpu_torch.ops import quantize as qz

    for width in (3, 4):
        cb = (torch.randint(-6, 7, (n_embed, width), generator=cuda, device="cuda") * 0.25).float()
        z = (torch.randint(-8, 9, (n, width), generator=cuda, device="cuda") * 0.125).float()
        if width == 4:
            assert qz._launch_plan(n, n_embed, width)["kernel"] == "stream"
        got = qz.nearest_code_cuda(z, cb)
        w = cb[:, 0] * cb[:, 0]
        for i in range(1, width):
            w = w + cb[:, i] * cb[:, i]
        want = []
        for zc in z.split(4096):
            dot = zc[:, :1] * cb[:, 0]
            for i in range(1, width):
                dot = dot + zc[:, i:i + 1] * cb[:, i]
            want.append(torch.argmin(w - 2 * dot, dim=1).to(torch.int32))
        assert torch.equal(got, torch.cat(want)), width
