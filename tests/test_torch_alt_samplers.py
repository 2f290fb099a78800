"""PLMS and DPM-Solver++(2M), the port against the JAX package: the
samplers on an eps function defined the same way on both sides, through a
tiny STEDM (``make_sample_fn``, CFG on and off), the block sampler against
JAX's ``make_host_sample_fn`` (trajectory and partition), the block
sampler against the port's own ``make_sample_fn`` bit for bit, and the
same ValueErrors.

Tolerances: on the eps function, fp32 rtol = atol = 1e-5 (the latent reaches
|x| ~ 26 there); through the
tiny STEDM rtol = atol = 1e-3, as tests/test_torch_sample.py (fp32
summation-order differences carried through the trajectory and the
decoder)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_helpers import quick_jit
from test_torch_serving import BASE, B, P, _schedules, models  # noqa: F401

import stedm_tpu.train.host_sampler as jhost
from stedm_tpu.core.ddim import DDIMParams as JDDIMParams
from stedm_tpu.core.dpm_solver import dpm_solver_pp_sample as jdpm
from stedm_tpu.core.plms import plms_sample as jplms
from stedm_tpu.train.steps import SamplerConfig as JSamplerConfig
from stedm_tpu.train.steps import make_sample_fn as jmake_sample_fn
from stedm_tpu_torch.core.ddim import DDIMParams
from stedm_tpu_torch.core.dpm_solver import dpm_solver_pp_sample
from stedm_tpu_torch.core.plms import plms_sample
from stedm_tpu_torch.train.host_sampler import make_host_sample_fn
from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn

RTOL = ATOL = 1e-3
SHAPE = (2, 6, 5, 3)


def _eps_pair(xp, x, t):
    """A smooth eps (cond, uncond) of the latent and the timestep, written
    with ``xp`` = jnp or torch."""
    s = t.reshape(-1, 1, 1, 1).astype(xp.float32) if xp is jnp else \
        t.reshape(-1, 1, 1, 1).float()
    e_c = 0.3 * x + 0.2 * xp.sin(s / 97.0 + x)
    e_u = 0.25 * x - 0.1 * xp.cos(s / 53.0 - 2.0 * x)
    return e_c, e_u


@pytest.mark.parametrize("method", ["plms", "dpm"])
@pytest.mark.parametrize("cfg_scale", [1.0, 1.5], ids=["no_cfg", "cfg"])
def test_samplers_on_an_eps_function(method, cfg_scale):
    jsched, sched = _schedules()
    x_T = np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
    steps = 10
    if cfg_scale == 1.0:
        jfn = lambda x, t: _eps_pair(jnp, x, t)[0]   # noqa: E731
        fn = lambda x, t: _eps_pair(torch, x, t)[0]  # noqa: E731
    else:
        jfn = lambda x, t: _eps_pair(jnp, x, t)      # noqa: E731
        fn = lambda x, t: _eps_pair(torch, x, t)     # noqa: E731
    kw = dict(cfg_scale=cfg_scale, rescale_phi=0.7)
    if method == "plms":
        want = jax.jit(lambda x: jplms(jfn, x, JDDIMParams.create(jsched, steps), **kw))(x_T)
        got = plms_sample(fn, torch.from_numpy(x_T), DDIMParams.create(sched, steps), **kw)
    else:
        want = jax.jit(lambda x: jdpm(jfn, x, jsched, steps, **kw))(x_T)
        got = dpm_solver_pp_sample(fn, torch.from_numpy(x_T), sched, steps, **kw)
    assert np.isfinite(got.numpy()).all() and np.abs(got.numpy() - x_T).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plms_makes_one_more_evaluation_than_steps():
    """The trapezoid bootstrap evaluates twice at the first step: S + 1."""
    sched = _schedules()[1]
    calls = []

    def fn(x, t):
        calls.append(int(t[0]))
        return _eps_pair(torch, x, t)[0]

    params = DDIMParams.create(sched, 10)
    plms_sample(fn, torch.zeros(SHAPE), params)
    order = params.timesteps[::-1]
    assert len(calls) == params.num_steps + 1
    assert calls[:3] == [order[0], order[1], order[1]]   # x, then x_prev0 at t_next


def _jax_images(models, kw):  # noqa: F811
    jm, params, pm, batch = models
    jsched = _schedules()[0]
    rng = jax.random.PRNGKey(7)
    jsample = quick_jit(jmake_sample_fn(jm, jsched, JSamplerConfig(**kw)))
    want = np.asarray(jsample(params, {k: jnp.asarray(v) for k, v in batch.items()}, rng))
    x_T = np.array(jax.random.normal(rng, (B, P // 4, P // 4, 3), jnp.float32))
    return want, torch.from_numpy(x_T)


SAMPLER_CASES = {
    "plms_cfg": dict(method="plms", ddim_steps=6),
    "plms_no_cfg": dict(method="plms", ddim_steps=6, cfg_scale=1.0, use_cfg=False),
    "plms_two_call": dict(method="plms", ddim_steps=6, batched_cfg=False),
    "dpm_cfg": dict(method="dpm", ddim_steps=5),
    "dpm_no_cfg": dict(method="dpm", ddim_steps=5, cfg_scale=1.0, use_cfg=False),
}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_make_sample_fn_matches_jax(models, case):  # noqa: F811
    kw = {**BASE, **SAMPLER_CASES[case]}
    want, x_T = _jax_images(models, kw)
    pm, batch = models[2], models[3]
    got = make_sample_fn(pm, _schedules()[1], SamplerConfig(**kw), device="cpu")(
        pm, batch, x_T=x_T).numpy()
    assert got.shape == (B, P, P, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method,steps,unroll", [("plms", 7, None), ("plms", 6, 4),
                                                 ("dpm", 7, None), ("dpm", 6, 4)])
def test_block_sampler_matches_jax(models, monkeypatch, method, steps, unroll):  # noqa: F811
    """The port's blocks against JAX's host blocks; JAX's partition is read
    where its block builder computes it."""
    jm, params, pm, batch = models
    jsched, sched = _schedules()
    kw = {**BASE, "method": method, "ddim_steps": steps}
    seen = {}
    builder = {"plms": "_plms_blocks", "dpm": "_dpm_blocks"}[method]
    orig = getattr(jhost, builder)

    def spy(*args):
        partition, default_unroll = args[-2:]
        n = args[2].num_steps if method == "plms" else args[1].ddim_steps
        seen["sizes"] = partition(n, default_unroll(n))
        return orig(*args)

    monkeypatch.setattr(jhost, builder, spy)
    rng = jax.random.PRNGKey(7)
    jfn = jhost.make_host_sample_fn(jm, jsched, JSamplerConfig(**kw), unroll=unroll)
    want = np.asarray(jfn(params, {k: jnp.asarray(v) for k, v in batch.items()}, rng))
    x_T = torch.from_numpy(np.array(jax.random.normal(rng, (B, P // 4, P // 4, 3),
                                                      jnp.float32)))
    fn = make_host_sample_fn(pm, sched, SamplerConfig(**kw), unroll=unroll, device="cpu")
    got = fn(pm, batch, x_T=x_T).numpy()
    assert fn.block_sizes == seen["sizes"] and len(fn.block_sizes) > 1
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["plms", "dpm"])
def test_block_sampler_equals_make_sample_fn(models, method):  # noqa: F811
    """The blocks run the eager sampler's steps: the same bits."""
    pm, batch = models[2], models[3]
    sched = _schedules()[1]
    cfg = SamplerConfig(**{**BASE, "method": method, "ddim_steps": 7})
    x_T = torch.from_numpy(np.random.default_rng(4).normal(
        size=(B, P // 4, P // 4, 3)).astype(np.float32))
    fn = make_host_sample_fn(pm, sched, cfg, unroll=3, device="cpu")
    # ddim_steps 7 is 8 uniform DDIM steps (stride 142); DPM's grid takes 7
    assert fn.block_sizes == {"plms": [3, 3, 2], "dpm": [3, 3, 1]}[method]
    assert torch.equal(fn(pm, batch, x_T=x_T),
                       make_sample_fn(pm, sched, cfg, device="cpu")(pm, batch, x_T=x_T))


REFUSALS = {
    "plms_eta": (dict(method="plms", eta=0.3), "requires method='ddim'"),
    "dpm_eta": (dict(method="dpm", eta=0.3), "requires method='ddim'"),
    "plms_cfg_interval": (dict(method="plms", cfg_interval=(0.25, 0.75)),
                          "cfg_interval is only supported"),
    "dpm_cfg_interval": (dict(method="dpm", cfg_interval=(0.25, 0.75)),
                         "cfg_interval is only supported"),
    "plms_cache": (dict(method="plms", cache_interval=2), "only supported for DDIM"),
    "dpm_schedule": (dict(method="dpm", cache_schedule=(0, 3)), "only supported for DDIM"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_same_value_errors(models, case):  # noqa: F811
    jm, params, pm, batch = models
    jsched, sched = _schedules()
    kw, match = REFUSALS[case]
    kw = {**BASE, **kw}
    with pytest.raises(ValueError, match=match):   # some raise only when traced
        jax.jit(jmake_sample_fn(jm, jsched, JSamplerConfig(**kw))).lower(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=match):
        jhost.make_host_sample_fn(jm, jsched, JSamplerConfig(**kw))
    with pytest.raises(ValueError, match=match):
        make_sample_fn(pm, sched, SamplerConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match=match):
        make_host_sample_fn(pm, sched, SamplerConfig(**kw), device="cpu")
