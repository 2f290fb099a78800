"""Tiled canvases, the port against the JAX package: ``tiled_apply`` on the
cases of tests/test_tiled.py (port against JAX and against the expected
values), the canvas sampler (``make_sample_fn`` and the block sampler,
CFG on and off) on a tiny STEDM, the canvas refusals, and
``predict_diff.main +canvas_size`` against JAX's ``predict_diff.main``.

Tolerances: ``tiled_apply`` fp32 rtol = atol = 1e-6 against JAX (the tiles
add in JAX's order, row-major) and 1e-5 against the expected values, as
tests/test_tiled.py; the sampler rtol = atol = 1e-3, as
tests/test_torch_sample.py; predict: seg PNGs equal, images within 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_serving import BASE, B, P, _schedules, models  # noqa: F401

import _port_helpers  # noqa: F401  (caps torch threads)
from _flowers_helpers import run_overrides, write_flowers_tree
from _port_helpers import jax_init, random_params

import stedm_tpu.train.host_sampler as jhost
from stedm_tpu.config import compose as jcompose
from stedm_tpu.models.stedm import build_stedm as jbuild_stedm
from stedm_tpu.ops.tiled import tiled_apply as jtiled_apply
from stedm_tpu.train import checkpoints as jcheckpoints
from stedm_tpu.train.steps import SamplerConfig as JSamplerConfig
from stedm_tpu.train.steps import make_sample_fn as jmake_sample_fn
from stedm_tpu_torch import predict_diff
from stedm_tpu_torch.ops.tiled import tiled_apply
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.train.host_sampler import make_host_sample_fn
from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn
from stedm_tpu_torch.utils.weights import state_dict_from_jax

RTOL = ATOL = 1e-3
CANVAS = 2 * P

TILE_CASES = {   # tests/test_tiled.py: (shape, fn, kwargs, expected)
    "identity": ((2, 40, 56, 3), "identity", dict(patch=16, stride=8), "x"),
    "pointwise": ((1, 32, 32, 2), "tanh", dict(patch=16, stride=12), "fn"),
    "upscaling": ((1, 16, 16, 3), "repeat", dict(patch=8, stride=4, out_channels=1, scale=2),
                  3.0),
    "ragged_edges": ((1, 30, 22, 3), "double", dict(patch=16, stride=10), 2.0),
}


def _fn(name, xp):
    if name == "identity":
        return lambda t: t
    if name == "tanh":
        return lambda t: xp.tanh(t) * 2.0 + 1.0
    if name == "double":
        return lambda t: t * 2.0
    if xp is jnp:
        return lambda t: jnp.repeat(jnp.repeat(t, 2, 1), 2, 2)[..., :1] * 3.0
    return lambda t: t.repeat_interleave(2, 1).repeat_interleave(2, 2)[..., :1] * 3.0


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tiled_apply_matches_jax(case):
    shape, name, kw, expected = TILE_CASES[case]
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    if case in ("upscaling", "ragged_edges"):
        x = np.ones(shape, np.float32)
    want = np.asarray(jtiled_apply(_fn(name, jnp), jnp.asarray(x), **kw))
    got = tiled_apply(_fn(name, torch), torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref = x if expected == "x" else np.tanh(x) * 2 + 1 if expected == "fn" else expected
    np.testing.assert_allclose(got, np.broadcast_to(ref, got.shape), rtol=1e-5, atol=1e-5)


def _canvas_batch(models):  # noqa: F811
    r = np.random.default_rng(5)
    seg = np.zeros((B, CANVAS, CANVAS, 2), np.float32)
    seg[..., 0] = 1.0
    seg[:, 8:44, 20:60] = [0.0, 1.0]
    return {"segmentation": seg, "style_imgs": models[3]["style_imgs"]}, r


CANVAS_CASES = {"cfg": dict(), "no_cfg": dict(cfg_scale=1.0, use_cfg=False)}


@pytest.mark.parametrize("host", [False, True], ids=["make_sample_fn", "host_blocks"])
@pytest.mark.parametrize("case", list(CANVAS_CASES))
def test_canvas_sampler_matches_jax(models, case, host):  # noqa: F811
    jm, params, pm, _ = models
    batch, _ = _canvas_batch(models)
    jsched, sched = _schedules()
    kw = {**BASE, "ddim_steps": 4, **CANVAS_CASES[case]}
    rng = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if host:
        want = np.asarray(jhost.make_host_sample_fn(jm, jsched, JSamplerConfig(**kw),
                                                    unroll=2)(params, jbatch, rng))
    else:
        # optimised: at 64^2 a QUICK_COMPILE reference's run outlasts the compile it saves
        want = np.asarray(jax.jit(jmake_sample_fn(jm, jsched, JSamplerConfig(**kw)))(
            params, jbatch, rng))
    x_T = torch.from_numpy(np.array(jax.random.normal(
        rng, (B, CANVAS // 4, CANVAS // 4, 3), jnp.float32)))
    fn = (make_host_sample_fn(pm, sched, SamplerConfig(**kw), unroll=2, device="cpu") if host
          else make_sample_fn(pm, sched, SamplerConfig(**kw), device="cpu"))
    got = fn(pm, batch, x_T=x_T).numpy()
    assert got.shape == (B, CANVAS, CANVAS, 3) and np.isfinite(got).all()
    assert (np.abs(got) < 1.0).mean() > 0.5, "a clipped-flat canvas would compare nothing"
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("eta", [0.0, 0.3])
def test_canvas_block_sampler_equals_make_sample_fn(models, eta):  # noqa: F811
    pm = models[2]
    batch, r = _canvas_batch(models)
    sched = _schedules()[1]
    cfg = SamplerConfig(**{**BASE, "ddim_steps": 4, "eta": eta})
    x_T = torch.from_numpy(r.normal(size=(B, CANVAS // 4, CANVAS // 4, 3)).astype(np.float32))
    run = lambda fn: fn(pm, batch, x_T=x_T, generator=torch.Generator().manual_seed(3))  # noqa
    assert torch.equal(run(make_host_sample_fn(pm, sched, cfg, unroll=3, device="cpu")),
                       run(make_sample_fn(pm, sched, cfg, device="cpu")))


REFUSALS = {
    "plms": (dict(method="plms"), NotImplementedError, "DDIM only"),
    "dpm": (dict(method="dpm"), NotImplementedError, "DDIM only"),
    "caching": (dict(cache_interval=2), ValueError, "caching is not supported"),
    "two_call_cfg": (dict(batched_cfg=False), ValueError, "require batched_cfg"),
    "cfg_interval": (dict(cfg_interval=(0.25, 0.75)), ValueError, "cfg_interval is not"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_canvas_refusals_match_jax(models, case):  # noqa: F811
    jm, params, pm, _ = models
    batch, _ = _canvas_batch(models)
    jsched, sched = _schedules()
    kw, exc, match = REFUSALS[case]
    kw = {**BASE, "ddim_steps": 4, **kw}
    with pytest.raises(exc, match=match):   # at build or trace time
        jax.jit(jmake_sample_fn(jm, jsched, JSamplerConfig(**kw))).lower(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    for make in (make_sample_fn, make_host_sample_fn):
        with pytest.raises(exc, match=match):
            make(pm, sched, SamplerConfig(**kw), device="cpu")(pm, batch)


PREDICT = ["data.samples=2", "data.batch_size=4", "ddim_steps=4", "cfg_scale=1.5",
           "diffusion.compute_dtype=float32", f"+canvas_size={CANVAS}"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_flowers_tree(tmp_path_factory.mktemp("data")), tmp_path_factory.mktemp("res")


def _pairs(folder):
    imgs, segs = sorted(folder.glob("img_*.png")), sorted(folder.glob("seg_*.png"))
    assert [p.name[4:] for p in imgs] == [p.name[4:] for p in segs]
    return [np.array(Image.open(p)) for p in imgs], [np.array(Image.open(p)) for p in segs]


def test_predict_canvas_matches_jax(tree):
    """Four layouts mosaicked into one canvas with the first one's style,
    through both predict_diff.main on the same weights and x_T."""
    import predict_diff as jpredict_diff

    data, results = tree
    overrides = run_overrides(data, results) + PREDICT
    jcfg = jcompose("config_predict", overrides)
    jm = jbuild_stedm(jcfg)
    params = random_params(jm, 5, jnp.zeros((1, P, P, 3)), jnp.zeros((1, P, P, 2)),
                           jnp.zeros((1, 1, P, P, 3)), jnp.zeros((1,), jnp.int32))
    jpath = results / "jax_ckpt"
    jcheckpoints.save(jpath, params, name="params")
    ppath = checkpoints.save(results / "port_ckpt", state_dict_from_jax(params), name="params")
    with jax_init("shapes"):   # every parameter is restored from jpath
        jpredict_diff.main(overrides + [f"+ckpt_path={jpath}", "+predict_name=jax"])

    def jax_x_T(batch_idx, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(0), batch_idx)
        return torch.from_numpy(np.asarray(jax.random.normal(key, shape, jnp.float32)))

    out = predict_diff.main(overrides + [f"+ckpt_path={ppath}", "+predict_name=port"],
                            device="cpu", x_T_fn=jax_x_T)
    want_img, want_seg = _pairs(data / "syn_data" / "jax")
    got_img, got_seg = _pairs(data / "syn_data" / "port")
    assert out["pairs"] == len(got_img) == len(want_img) == 1
    for g, w in zip(got_seg, want_seg):
        assert g.shape == (CANVAS, CANVAS)
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_img, want_img):
        assert g.shape == (CANVAS, CANVAS, 3) and g.std() > 0
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1

    with pytest.raises(SystemExit, match="multiple of the training patch"):
        predict_diff.main(run_overrides(data, results) + [
            f"+ckpt_path={ppath}", f"+canvas_size={P + P // 2}"], device="cpu")
