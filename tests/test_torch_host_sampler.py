"""The port's block sampler (``make_host_sample_fn``, eager blocks on the
CPU) against stedm_tpu's host-driven block sampler: the same trajectory and
the same partition into blocks, with and without the cache carried between
blocks, in exact DDIM and in the serving mode; and against the port's own
``make_sample_fn``, bit for bit at eta 0 and eta > 0.

Tolerance: rtol = atol = 1e-3, as tests/test_torch_sample.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import BASE, B, P, _schedules, models  # noqa: F401

from stedm_tpu.train.host_sampler import make_host_sample_fn as jmake_host_sample_fn
from stedm_tpu.train.steps import SamplerConfig as JSamplerConfig
from stedm_tpu_torch.train.host_sampler import make_host_sample_fn
from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn

RTOL = ATOL = 1e-3

CASES = {
    "exact_cfg": (dict(), None, False),
    "composed": (dict(cache_schedule=(0, 5), cfg_interval=(0.25, 0.75)), 3, False),
    "composed_carry": (dict(cache_schedule=(0, 5), cfg_interval=(0.25, 0.75)), 3, True),
    "interval_3_ragged_carry": (dict(ddim_steps=7, cache_interval=3), 2, True),
    "schedule_no_cfg_carry": (dict(cache_schedule=(0, 5), cfg_scale=1.0, use_cfg=False),
                              3, True),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_block_sampler_matches_jax(models, case, monkeypatch, capsys):  # noqa: F811
    jm, params, pm, batch = models
    jsched, sched = _schedules()
    kw, unroll, carry = CASES[case]
    kw = {**BASE, **kw}
    rng = jax.random.PRNGKey(7)
    monkeypatch.setenv("STEDM_HOST_BLOCK_TIMING", "1")   # JAX prints its partition
    jfn = jmake_host_sample_fn(jm, jsched, JSamplerConfig(**kw), unroll=unroll,
                               carry_cache=carry)
    want = np.asarray(jfn(params, {k: jnp.asarray(v) for k, v in batch.items()}, rng))
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("block times")][0]
    jsizes = [int(tok.split(":")[0]) for tok in line.split()[3:]]

    x_T = torch.from_numpy(np.array(jax.random.normal(rng, (B, P // 4, P // 4, 3),
                                                      jnp.float32)))
    fn = make_host_sample_fn(pm, sched, SamplerConfig(**kw), unroll=unroll,
                             carry_cache=carry, device="cpu")
    got = fn(pm, batch, x_T=x_T).numpy()
    assert fn.block_sizes == jsizes
    assert got.shape == (B, P, P, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("eta", [0.0, 0.3])
@pytest.mark.parametrize("carry", [False, True], ids=["blocks", "carry"])
def test_block_sampler_equals_make_sample_fn(models, carry, eta):  # noqa: F811
    """The blocks run the same steps as the Python loop: the same bits, the
    eta > 0 noise drawn in the same order."""
    pm, batch = models[2], models[3]
    sched = _schedules()[1]
    cfg = SamplerConfig(**{**BASE, "eta": eta, "cache_schedule": (0, 3, 5),
                           "cfg_interval": (0.25, 0.75)})
    x_T = torch.from_numpy(np.random.default_rng(4).normal(
        size=(B, P // 4, P // 4, 3)).astype(np.float32))
    run = lambda fn: fn(pm, batch, x_T=x_T, generator=torch.Generator().manual_seed(11))
    fn = make_host_sample_fn(pm, sched, cfg, unroll=3, carry_cache=carry, device="cpu")
    assert fn.block_sizes == ([3, 3, 2] if carry else [3, 2, 3])
    assert torch.equal(run(fn), run(make_sample_fn(pm, sched, cfg, device="cpu")))


def test_block_sampler_refusals(models):  # noqa: F811
    pm = models[2]
    sched = _schedules()[1]
    # PLMS and DPM-Solver have blocks of their own now
    # (tests/test_torch_alt_samplers.py): they build; an unknown method raises
    for kw in (dict(method="plms"), dict(method="dpm")):
        assert make_host_sample_fn(pm, sched, SamplerConfig(**{**BASE, **kw}),
                                   device="cpu").block_sizes
    with pytest.raises(NotImplementedError):
        make_host_sample_fn(pm, sched, SamplerConfig(method="bogus"), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_host_sample_fn(pm, sched, SamplerConfig(cache_interval=2, cache_schedule=(0, 3)),
                            device="cpu")
    with pytest.raises(ValueError, match="runs the model it was built for"):
        fn = make_host_sample_fn(pm, sched, SamplerConfig(**BASE), device="cpu")
        fn(torch.nn.Linear(1, 1), models[3])
