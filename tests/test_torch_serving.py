"""The serving mode on a tiny STEDM, the port against the JAX package: the
U-Net's deep-feature cache out and in, ``make_sample_fn`` with trunk caching
(``cache_interval``, ``cache_schedule``, ``cache_levels``), the guidance
window (``cfg_interval``) and both composed, ``measure_cache_drift``, the
refusals, and the port's own identities (every step refreshed or guided is
the exact trajectory, at eta 0 and eta > 0).

Same weights (the JAX tree through ``state_dict_from_jax``), same inputs
(numpy from a seed; x_T drawn with jax.random as the JAX sampler draws it).
Tolerance: rtol = atol = 1e-3, as tests/test_torch_sample.py (fp32
summation-order differences carried through the trajectory and the
decoder)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_helpers import load, quick_jit, random_params

from stedm_tpu.core.schedules import DiffusionSchedule as JSchedule
from stedm_tpu.models.stedm import STEDM as JSTEDM
from stedm_tpu.train.calibrate import measure_cache_drift as jmeasure_cache_drift
from stedm_tpu.train.steps import SamplerConfig as JSamplerConfig
from stedm_tpu.train.steps import make_sample_fn as jmake_sample_fn
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.models.stedm import STEDM
from stedm_tpu_torch.train.calibrate import measure_cache_drift
from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn
from stedm_tpu_torch.utils.weights import state_dict_from_jax

RTOL = ATOL = 1e-3
P, B = 32, 2
CONFIGS = dict(
    unet_config=dict(in_channels=6, out_channels=3, model_channels=32, num_res_blocks=1,
                     channel_mult=(1, 4, 8), num_heads=8, attention_resolutions=(32, 16, 8)),
    first_stage_config=dict(embed_dim=3, n_embed=256, ddconfig=dict(
        double_z=False, z_channels=3, resolution=P, in_channels=3, out_ch=3, ch=32,
        ch_mult=[1, 2, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0)),
    cond_stage_config=dict(n_stages=2, in_channels=2, out_channels=3),
    style_agg="mean", style_sampling="nearby", patch_size=P)
BASE = dict(ddim_steps=8, eta=0.0, cfg_scale=1.5, rescale_phi=0.7, downsample=4)


def _schedules():
    return (JSchedule.create("linear", 1000, 0.0015, 0.0205),
            DiffusionSchedule.create("linear", 1000, 0.0015, 0.0205))


@pytest.fixture(scope="module")
def models():
    r = np.random.default_rng(0)
    seg = np.zeros((B, P, P, 2), np.float32)
    seg[..., 0] = 1.0
    seg[:, 8:20, 4:28] = [0.0, 1.0]
    batch = {"segmentation": seg,
             "style_imgs": r.uniform(-1, 1, (B, 1, P, P, 3)).astype(np.float32)}
    jm = JSTEDM(**CONFIGS)
    params = random_params(jm, 1, jnp.zeros((B, P, P, 3)), jnp.asarray(seg),
                           jnp.asarray(batch["style_imgs"]), jnp.zeros((B,), jnp.int32))
    pm = load(STEDM(**CONFIGS), state_dict_from_jax(params))
    return jm, params, pm, batch


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("levels", [1, 2])
def test_unet_cache_out_and_in_match_jax(models, levels):
    """eps and the cache of a full pass, then a cached pass on that cache,
    with the CFG fan-out (a [2B] style context) carried by the cache."""
    jm, params, pm, _ = models
    r = np.random.default_rng(3)
    z = r.normal(size=(B, P // 4, P // 4, 3)).astype(np.float32)
    z2 = r.normal(size=(B, P // 4, P // 4, 3)).astype(np.float32)
    seg_cond = r.normal(size=(B, P // 4, P // 4, 3)).astype(np.float32)
    style = r.normal(size=(2 * B, 512)).astype(np.float32)
    t, t2 = np.array([900, 650], np.int32), np.array([610, 400], np.int32)

    full = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, levels, method=jm.eps_full))
    cached = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, levels, method=jm.eps_cached))
    j_out, j_cache = full(params, z, t, seg_cond, style)
    j_cached = np.asarray(cached(params, z2, t2, seg_cond, j_cache))

    tt = torch.from_numpy
    with torch.no_grad():
        out, cache = pm.eps_full(tt(z), tt(t).long(), tt(seg_cond), tt(style), levels)
        got_cached = pm.eps_cached(tt(z2), tt(t2).long(), tt(seg_cond), cache, levels)
    n_levels = len(CONFIGS["unet_config"]["channel_mult"])
    assert cache.shape[0] == 2 * B and cache.is_contiguous(memory_format=torch.channels_last)
    assert cache.shape[2] == P // 4 // 2 ** (levels - 1) and levels < n_levels
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_nhwc(cache), np.asarray(j_cache), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_cached.numpy(), j_cached, rtol=RTOL, atol=ATOL)
    # a cached pass is not the full pass: the deep trunk is stale
    with torch.no_grad():
        fresh = pm.eps(tt(z2), tt(t2).long(), tt(seg_cond), tt(style))
    assert float((fresh - got_cached).abs().max()) > 1e-3


def test_unet_cache_arguments_are_checked(models):
    pm = models[2]
    x, t = torch.zeros(1, 6, 8, 8), torch.zeros(1, dtype=torch.long)
    with torch.no_grad():
        _, cache = pm.unet(x, t, return_cache=True)
        with pytest.raises(AssertionError):
            pm.unet(x, t, cache=cache, return_cache=True)
        for levels in (0, 3):
            with pytest.raises(AssertionError):
                pm.unet(x, t, return_cache=True, cache_levels=levels)


SERVING = {
    "interval_2": dict(cache_interval=2),
    "interval_3_ragged": dict(ddim_steps=7, cache_interval=3),   # 8 DDIM steps
    "interval_2_levels_2": dict(cache_interval=2, cache_levels=2),
    "schedule": dict(cache_schedule=(0, 3, 5)),
    "cfg_interval": dict(cfg_interval=(0.25, 0.75)),
    "composed": dict(cache_schedule=(0, 5), cfg_interval=(0.25, 0.75)),
    "cached_no_cfg": dict(cache_interval=2, cfg_scale=1.0, use_cfg=False),
}


def _sample_both(models, kw):
    jm, params, pm, batch = models
    jsched, sched = _schedules()
    kw = {**BASE, **kw}
    rng = jax.random.PRNGKey(7)
    jsample = quick_jit(jmake_sample_fn(jm, jsched, JSamplerConfig(**kw)))
    want = np.asarray(jsample(params, {k: jnp.asarray(v) for k, v in batch.items()}, rng))
    x_T = torch.from_numpy(np.array(jax.random.normal(rng, (B, P // 4, P // 4, 3),
                                                      jnp.float32)))
    got = make_sample_fn(pm, sched, SamplerConfig(**kw), device="cpu")(pm, batch, x_T=x_T)
    return got.numpy(), want, x_T


@pytest.mark.parametrize("mode", list(SERVING), ids=list(SERVING))
def test_serving_sampler_matches_jax(models, mode):
    got, want, _ = _sample_both(models, SERVING[mode])
    assert got.shape == (B, P, P, 3) and np.isfinite(got).all()
    assert 0.05 < np.abs(got).mean() and (np.abs(got) < 1.0).mean() > 0.5, \
        "the image must not be clipped flat for the comparison to mean anything"
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cache_drift_matches_jax(models):
    jm, params, pm, batch = models
    jsched, sched = _schedules()
    rng = jax.random.PRNGKey(5)
    want = jmeasure_cache_drift(jm, jsched, JSamplerConfig(**BASE), params,
                                {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    x_T = torch.from_numpy(np.array(jax.random.normal(rng, (B, P // 4, P // 4, 3),
                                                      jnp.float32)))
    got = measure_cache_drift(pm, sched, SamplerConfig(**BASE), batch, x_T=x_T, device="cpu")
    assert got.shape == (BASE["ddim_steps"] - 1,) and got.dtype == np.float64
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


IDENTITIES = {
    "interval_1": dict(cache_interval=1, cache_levels=2),
    "refresh_every_step": dict(cache_schedule=tuple(range(BASE["ddim_steps"]))),
    "window_every_step": dict(cfg_interval=(0.0, 1.0)),
    "composed_every_step": dict(cache_schedule=tuple(range(BASE["ddim_steps"])),
                                cfg_interval=(0.0, 1.0)),
}


@pytest.mark.parametrize("eta", [0.0, 0.3])
@pytest.mark.parametrize("mode", list(IDENTITIES), ids=list(IDENTITIES))
def test_port_serving_degenerates_to_exact(models, mode, eta):
    """Every step refreshed and guided is the exact trajectory, bit for bit,
    with the eta > 0 noise drawn in the same order."""
    pm, batch = models[2], models[3]
    sched = _schedules()[1]
    x_T = torch.from_numpy(np.random.default_rng(4).normal(
        size=(B, P // 4, P // 4, 3)).astype(np.float32))

    def run(**kw):
        fn = make_sample_fn(pm, sched, SamplerConfig(**{**BASE, "eta": eta, **kw}),
                            device="cpu")
        return fn(pm, batch, x_T=x_T, generator=torch.Generator().manual_seed(11))

    exact = run()
    assert torch.equal(run(**IDENTITIES[mode]), exact)
    if eta > 0:
        assert not torch.equal(exact, run(eta=0.0)), "the noise must be in play"


def test_serving_mode_moves_the_output(models):
    """The shipped knobs change the trajectory (and so the tests above
    compare something): caching and the window each move the image."""
    pm, batch = models[2], models[3]
    sched = _schedules()[1]
    x_T = torch.from_numpy(np.random.default_rng(4).normal(
        size=(B, P // 4, P // 4, 3)).astype(np.float32))
    run = lambda **kw: make_sample_fn(pm, sched, SamplerConfig(**{**BASE, **kw}),
                                      device="cpu")(pm, batch, x_T=x_T)
    exact = run()
    for kw in (dict(cache_interval=2), dict(cfg_interval=(0.25, 0.75))):
        assert float((run(**kw) - exact).abs().max()) > 1e-2, kw


REFUSED = {
    "interval_and_schedule": dict(cache_interval=2, cache_schedule=(0, 3)),
    "caching_two_call_cfg": dict(cache_interval=2, batched_cfg=False),
    "caching_plms": dict(cache_interval=2, method="plms"),
    "cfg_interval_plms": dict(cfg_interval=(0.2, 0.8), method="plms"),
    "eta_plms": dict(eta=0.3, method="plms"),
    "bad_window": dict(cfg_interval=(0.7, 0.2)),
}


@pytest.mark.parametrize("mode", list(REFUSED), ids=list(REFUSED))
def test_refusals_match_jax(models, mode):
    """The combinations the JAX sampler refuses with ValueError, refused alike
    (the JAX side at build or trace time, the port when it is built)."""
    jm, params, pm, batch = models
    jsched, sched = _schedules()
    kw = {**BASE, **REFUSED[mode]}
    with pytest.raises(ValueError) as jerr:
        jax.jit(jmake_sample_fn(jm, jsched, JSamplerConfig(**kw))).lower(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as err:
        make_sample_fn(pm, sched, SamplerConfig(**kw), device="cpu")
    assert str(err.value).split(" (")[0] == str(jerr.value).split(" (")[0]


def test_sampler_config_fields_match_jax():
    """The port's SamplerConfig carries the JAX one's fields and defaults,
    the tiled canvases' stride included."""
    port = {f.name: f.default for f in dataclasses.fields(SamplerConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JSamplerConfig)}
    assert port == ref


def _toy_eps(xp, cat, b):
    """Synthetic model evaluations in framework ``xp``: the cache depends on
    x and t, and the cached passes read it row by row, so a stale cache or
    one cut at the wrong step moves the result (or breaks its shape)."""
    def pair(x, t):
        e = 0.1 * x + 1e-5 * t[:, None, None, None]
        return e, 0.9 * e

    def cond(x, t):
        return pair(x, t)[0]

    def trunk(x, t):
        return xp.tanh(x) * (1.0 + 1e-4 * t[:, None, None, None])

    def full(x, t):
        c = trunk(x, t)
        return pair(x, t), cat([c, 0.5 * c])

    def cached(x, t, cache):
        return 0.1 * x + 0.05 * cache[:b], 0.09 * x + 0.05 * cache[b:]

    def full_cond(x, t):
        return cond(x, t), trunk(x, t)

    def cached_cond(x, t, cache):
        assert cache.shape[0] == b
        return 0.1 * x + 0.05 * cache

    return pair, cond, full, cached, full_cond, cached_cond


RAW = {   # the sampler's name: its arguments beyond the eps functions
    "ddim_sample_cached": dict(cache_interval=3),
    "ddim_sample_scheduled": dict(refresh_positions=(0, 3, 5)),
    "ddim_sample_guided": dict(guided_lo=2, guided_hi=6),
    "ddim_sample_scheduled_guided": dict(refresh_positions=(0, 5), guided_lo=2, guided_hi=6),
}


@pytest.mark.parametrize("name", list(RAW), ids=list(RAW))
def test_raw_serving_samplers_match_jax(name):
    """core/ddim.py's serving samplers against stedm_tpu's on synthetic eps
    functions (8 steps, CFG 1.5): the refresh schedule, the forced refresh at
    the window's entry and the cache cut back to B rows at its end."""
    import stedm_tpu.core.ddim as jddim
    import stedm_tpu_torch.core.ddim as pddim

    jsched, sched = _schedules()
    x_T = np.random.default_rng(7).standard_normal((B, 8, 8, 3)).astype(np.float32)
    jfns = _toy_eps(jnp, jnp.concatenate, B)
    pfns = _toy_eps(torch, torch.cat, B)
    pick = {"ddim_sample_cached": (2, 3), "ddim_sample_scheduled": (2, 3),
            "ddim_sample_guided": (0, 1),
            "ddim_sample_scheduled_guided": (2, 3, 4, 5)}[name]
    kw = dict(RAW[name], cfg_scale=1.5, rescale_phi=0.7)
    want = getattr(jddim, name)(*(jfns[i] for i in pick), jnp.asarray(x_T),
                                jddim.DDIMParams.create(jsched, 8), **kw)
    got = getattr(pddim, name)(*(pfns[i] for i in pick), torch.from_numpy(x_T),
                               pddim.DDIMParams.create(sched, 8), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    exact = pddim.ddim_sample(pfns[0], torch.from_numpy(x_T), pddim.DDIMParams.create(sched, 8),
                              cfg_scale=1.5, rescale_phi=0.7)
    assert not torch.equal(got, exact)
