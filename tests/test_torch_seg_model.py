"""The port's MiT-B2 U-Net (stedm_tpu_torch/models/segformer.py), its weight
bridge (``seg_state_dict``) and its MiT-B2 importer (``load_seg_encoder``)
against stedm_tpu/models/segformer.py and stedm_tpu/utils/torch_import.py,
module by module, in train and eval mode, in fp32 and bf16, with the same
weights and numpy-seeded inputs.

Tolerances: fp32 within ``_port_helpers.RTOL`` / ``ATOL`` (1e-3, 2e-4). In
bf16 both sides round at other places, so the port's distance to JAX's bf16
output must stay within twice JAX's own bf16-vs-fp32 distance on the same
input (max and mean), the control this test computes. The running
statistics after a train-mode call within 1e-6 in fp32; in bf16 within 2e-3
(a decoder block) and 5e-3 (the whole net), where the batch statistics
come from bf16 activations rounded at other places."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_helpers import ATOL, RTOL, random_params

from stedm_tpu.models import segformer as J
from stedm_tpu.utils.torch_import import load_seg_encoder as jload_seg_encoder
from stedm_tpu_torch.models import segformer as P
from stedm_tpu_torch.utils.weights import load_seg_encoder, seg_state_dict

ENC = dict(embed_dims=(16, 32, 40, 64), depths=(1, 2, 1, 1), num_heads=(1, 2, 5, 8),
           sr_ratios=(8, 4, 2, 1))
DEC = (32, 24, 16, 8, 8)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
STATS_ATOL = 1e-6


class _Bound:
    """A flax module whose static call arguments (h, w, train) are fixed, so
    that ``random_params`` can trace its init."""

    def __init__(self, module, **static):
        self.module, self.static = module, static

    def init(self, key, *args):
        return self.module.init(key, *args, **self.static)


def _batch_stats(module, seed: int, *args, **static):
    shapes = jax.eval_shape(lambda k, *a: module.init(k, *a, **static),
                            jax.random.PRNGKey(0), *args)["batch_stats"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.normal(0, 0.1, s.shape) if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, s.shape)).astype(np.float32), shapes)


def _apply(module, variables, *args, train=None, **static):
    kw = dict(static) if train is None else dict(static, train=train)
    if train:
        out, mut = module.apply(variables, *args, mutable=["batch_stats"], **kw)
        return out, mut["batch_stats"]
    return module.apply(variables, *args, **kw), None


def _jax_f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_bf16_close(got: np.ndarray, want: np.ndarray, want32: np.ndarray) -> None:
    err, ctrl = np.abs(got - want), np.abs(want - want32)
    assert err.max() <= 2 * ctrl.max(), (err.max(), ctrl.max())
    assert err.mean() <= 2 * ctrl.mean(), (err.mean(), ctrl.mean())


def _torch_in(x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(x).to(dtype)


def _token_case(name):
    """(JAX module factory, port module factory, input shape, h, w)."""
    dim, heads = 40, 5
    if name == "attn_sr1":
        return (lambda dt: J.EfficientAttention(dim, heads, 1, dtype=dt),
                lambda: P.EfficientAttention(dim, heads, 1), 8, 6)
    if name == "attn_sr2":
        return (lambda dt: J.EfficientAttention(dim, heads, 2, dtype=dt),
                lambda: P.EfficientAttention(dim, heads, 2), 8, 6)
    if name == "mixffn":
        return lambda dt: J.MixFFN(4 * dim, dtype=dt), lambda: P.MixFFN(dim, 4 * dim), 8, 6
    return (lambda dt: J.MiTBlock(dim, heads, 2, dtype=dt),
            lambda: P.MiTBlock(dim, heads, 2), 8, 6)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", ["attn_sr1", "attn_sr2", "mixffn", "block"])
def test_token_modules(name, dt):
    jmake, pmake, h, w = _token_case(name)
    jdt, tdt = DTYPES[dt]
    x = np.random.default_rng(1).normal(size=(2, h * w, 40)).astype(np.float32)
    params = random_params(_Bound(jmake(jnp.float32), h=h, w=w), 3, jnp.zeros((1, h * w, 40)))
    port = pmake()
    port.load_state_dict(seg_state_dict(params), strict=True)
    got = port(_torch_in(x, tdt), h, w)
    assert got.dtype == tdt
    got = got.detach().float().numpy()
    want = _jax_f32(jmake(jdt).apply({"params": params}, jnp.asarray(x, jdt), h, w))
    if dt == "fp32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        want32 = _jax_f32(jmake(jnp.float32).apply({"params": params}, jnp.asarray(x), h, w))
        _assert_bf16_close(got, want, want32)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_mit_encoder(dt):
    jdt, tdt = DTYPES[dt]
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    params = random_params(J.MiTEncoder(**ENC), 4, jnp.zeros((1, 64, 64, 3)))
    port = P.MiTEncoder(**ENC)
    port.load_state_dict(seg_state_dict(params), strict=True)
    feats = port(_torch_in(x, tdt).permute(0, 3, 1, 2))
    want = jax.jit(J.MiTEncoder(dtype=jdt, **ENC).apply)({"params": params},
                                                        jnp.asarray(x, jdt))
    want32 = jax.jit(J.MiTEncoder(**ENC).apply)({"params": params}, jnp.asarray(x))
    assert len(feats) == 4
    for f, wnt, w32 in zip(feats, want, want32):
        assert f.dtype == tdt and f.is_contiguous(memory_format=torch.channels_last)
        got = f.detach().permute(0, 2, 3, 1).float().numpy()
        if dt == "fp32":
            np.testing.assert_allclose(got, _jax_f32(wnt), rtol=RTOL, atol=ATOL)
        else:
            _assert_bf16_close(got, _jax_f32(wnt), _jax_f32(w32))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("with_skip", [True, False], ids=["skip", "noskip"])
def test_decoder_block(with_skip, train, dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(5)
    x = rng.normal(1.0, 2.0, size=(3, 4, 5, 12)).astype(np.float32)
    skip = rng.normal(size=(3, 8, 10, 6)).astype(np.float32) if with_skip else None
    jskip = None if skip is None else jnp.asarray(skip)
    jblock = J.DecoderBlock(10)
    params = random_params(_Bound(jblock, train=False), 6, jnp.asarray(x), jskip)
    stats = _batch_stats(jblock, 7, jnp.asarray(x), jskip, train=False)
    port = P.DecoderBlock(12 + (6 if with_skip else 0), 10).train(train)
    port.load_state_dict(seg_state_dict(params, stats), strict=True)
    nchw = lambda a: None if a is None else _torch_in(a, tdt).permute(0, 3, 1, 2)
    got = port(nchw(x), nchw(skip)).detach().permute(0, 2, 3, 1).float().numpy()
    variables = {"params": params, "batch_stats": stats}
    jin = lambda a, d: None if a is None else jnp.asarray(a, d)
    want, new_stats = _apply(J.DecoderBlock(10, dtype=jdt), variables, jin(x, jdt),
                             jin(skip, jdt), train=train)
    if dt == "fp32":
        np.testing.assert_allclose(got, _jax_f32(want), rtol=RTOL, atol=ATOL)
    else:
        want32, _ = _apply(jblock, variables, jnp.asarray(x), jskip, train=train)
        _assert_bf16_close(got, _jax_f32(want), _jax_f32(want32))
    sd = port.state_dict()
    expect = seg_state_dict(params, new_stats if train else stats)
    for k in ("bn1.running_mean", "bn1.running_var", "bn2.running_mean", "bn2.running_var"):
        atol = STATS_ATOL if dt == "fp32" else 2e-3
        np.testing.assert_allclose(sd[k].numpy(), expect[k].numpy(), rtol=0, atol=atol)
        if train:   # the statistics moved, by flax's momentum
            assert not torch.equal(sd[k], seg_state_dict(params, stats)[k])


def _seg_models(seed: int, patch: int = 64):
    jmodel = J.SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC)
    x0 = jnp.zeros((1, patch, patch, 3))
    params = random_params(jmodel, seed, x0)
    stats = _batch_stats(jmodel, seed + 1, x0)
    return jmodel, params, stats


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_seg_unet(train, dt):
    jdt, tdt = DTYPES[dt]
    _, params, stats = _seg_models(8)
    x = np.random.default_rng(9).normal(size=(2, 64, 64, 3)).astype(np.float32)
    port = P.SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC, dtype=tdt)
    port.load_state_dict(seg_state_dict(params, stats), strict=True)
    got = port(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 64, 2)
    assert port.training == train
    variables = {"params": params, "batch_stats": stats}
    jmodel = J.SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC, dtype=jdt)
    fn = jax.jit(lambda v, a: _apply(jmodel, v, a, train=train))
    want, new_stats = fn(variables, jnp.asarray(x))
    got = got.detach().numpy()
    if dt == "fp32":
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    else:
        j32 = J.SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC)
        want32, _ = jax.jit(lambda v, a: _apply(j32, v, a, train=train))(variables,
                                                                          jnp.asarray(x))
        _assert_bf16_close(got, np.asarray(want), np.asarray(want32))
    if train:
        sd, expect = port.state_dict(), seg_state_dict(params, new_stats)
        keys = [k for k in expect if "running" in k]
        assert len(keys) == 20
        atol = STATS_ATOL if dt == "fp32" else 5e-3
        for k in keys:
            np.testing.assert_allclose(sd[k].numpy(), expect[k].numpy(), rtol=0, atol=atol)


def test_seg_unet_returns_its_inputs_dtype():
    port = P.SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC,
                     dtype=torch.bfloat16).eval()
    x = torch.randn(1, 32, 32, 3)
    assert port(x).dtype == torch.float32
    assert port(x.bfloat16()).dtype == torch.bfloat16


def test_bridge_key_set_and_shapes_at_the_shipped_widths():
    """``seg_state_dict`` of the shipped SegUNet's tree (by eval_shape at
    512^2) gives exactly the meta-device port model's keys and shapes: 396
    parameters and 20 BatchNorm running-stat buffers (1,984 values)."""
    shapes = jax.eval_shape(J.SegUNet(classes=2).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 512, 512, 3)))
    zeros = lambda tree: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree)
    sd = seg_state_dict(zeros(shapes["params"]), zeros(shapes["batch_stats"]))
    with torch.device("meta"):
        port = P.SegUNet(classes=2)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    params = dict(port.named_parameters())
    assert len(params) == 396
    assert sum(p.numel() for p in params.values()) == 27_477_154
    assert sum(p.numel() for p in port.encoder.parameters()) == 24_196_288
    buffers = dict(port.named_buffers())
    assert len(buffers) == 20 and sum(b.numel() for b in buffers.values()) == 1984
    n_jax = sum(np.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_jax == 27_477_154


def _nvlabs_state_dict(seed: int, enc: dict) -> dict:
    """A synthetic MiT state_dict in the published NVlabs layout
    (tests/test_seg.py:122-160 at ``enc``'s widths), with a classification head."""
    rng = np.random.default_rng(seed)
    dims, depths, srs = enc["embed_dims"], enc["depths"], enc["sr_ratios"]
    sd = {}
    n = lambda *shape: rng.normal(0, 0.2, shape)
    for s, (d, depth, sr) in enumerate(zip(dims, depths, srs)):
        t = s + 1
        in_ch, k = (3, 7) if s == 0 else (dims[s - 1], 3)
        sd[f"patch_embed{t}.proj.weight"] = n(d, in_ch, k, k)
        sd[f"patch_embed{t}.proj.bias"] = n(d)
        for nm in (f"patch_embed{t}.norm", f"norm{t}"):
            sd[f"{nm}.weight"], sd[f"{nm}.bias"] = 1 + n(d), n(d)
        for i in range(depth):
            b = f"block{t}.{i}."
            for nm in ("norm1", "norm2"):
                sd[b + nm + ".weight"], sd[b + nm + ".bias"] = 1 + n(d), n(d)
            sd[b + "attn.q.weight"], sd[b + "attn.q.bias"] = n(d, d), n(d)
            sd[b + "attn.kv.weight"], sd[b + "attn.kv.bias"] = n(2 * d, d), n(2 * d)
            sd[b + "attn.proj.weight"], sd[b + "attn.proj.bias"] = n(d, d), n(d)
            if sr > 1:
                sd[b + "attn.sr.weight"], sd[b + "attn.sr.bias"] = n(d, d, sr, sr) / sr, n(d)
                sd[b + "attn.norm.weight"], sd[b + "attn.norm.bias"] = 1 + n(d), n(d)
            sd[b + "mlp.fc1.weight"], sd[b + "mlp.fc1.bias"] = n(4 * d, d), n(4 * d)
            sd[b + "mlp.dwconv.dwconv.weight"] = n(4 * d, 1, 3, 3)
            sd[b + "mlp.dwconv.dwconv.bias"] = n(4 * d)
            sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"] = n(d, 4 * d) / 2, n(d)
    sd["head.weight"], sd["head.bias"] = n(1000, dims[-1]), n(1000)
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("root", ["", "encoder.", "_model.encoder."],
                         ids=["nvlabs", "smp", "lightning"])
def test_mit_importer_gives_the_jax_importers_forward(root, tmp_path, capsys):
    """The same synthetic checkpoint through JAX's ``load_seg_encoder`` and
    the port's: equal load counts and the same forward (fp32, eval); the
    decoder keeps its weights and ``head.*`` is left out."""
    path = tmp_path / "mit.pth"
    torch.save({root + k: v for k, v in _nvlabs_state_dict(11, ENC).items()}, path)
    jmodel, params, stats = _seg_models(12)
    jparams = jload_seg_encoder(params, str(path))
    jcounts = capsys.readouterr().out
    port = P.SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC)
    port.load_state_dict(seg_state_dict(params, stats), strict=True)
    loaded, left = load_seg_encoder(port, path)
    assert capsys.readouterr().out == jcounts
    assert loaded == sum(1 for _ in port.encoder.parameters())
    assert left == sum(1 for n, _ in port.named_parameters() if not n.startswith("encoder."))
    x = np.random.default_rng(13).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = jmodel.apply({"params": jparams, "batch_stats": stats}, jnp.asarray(x))
    got = port.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    sd = port.state_dict()
    for k, v in seg_state_dict(params, stats).items():
        if not k.startswith("encoder."):
            assert torch.equal(sd[k], v), k


def test_mit_importer_refuses_a_directory(tmp_path):
    port = P.SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC)
    with pytest.raises(NotImplementedError, match="item 10"):
        load_seg_encoder(port, tmp_path)
