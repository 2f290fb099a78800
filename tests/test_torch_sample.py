"""The whole slice on a tiny STEDM: layout and style encoding, a 4-step DDIM
trajectory with rescaled CFG (scale 1.5, phi 0.7), VQ decode and clip,
through the JAX sampler and the port with the same weights and the same
x_T (drawn with jax.random as make_sample_fn draws it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_helpers import load, random_params

from stedm_tpu.core.schedules import DiffusionSchedule as JSchedule
from stedm_tpu.models.stedm import STEDM as JSTEDM
from stedm_tpu.train.steps import SamplerConfig as JSamplerConfig
from stedm_tpu.train.steps import make_sample_fn as jmake_sample_fn
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.models.stedm import STEDM
from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn
from stedm_tpu_torch.utils.weights import state_dict_from_jax

P, B = 32, 2
CONFIGS = dict(
    unet_config=dict(in_channels=6, out_channels=3, model_channels=32, num_res_blocks=1,
                     channel_mult=(1, 4, 8), num_heads=8, attention_resolutions=(32, 16, 8)),
    first_stage_config=dict(embed_dim=3, n_embed=256, ddconfig=dict(
        double_z=False, z_channels=3, resolution=P, in_channels=3, out_ch=3, ch=32,
        ch_mult=[1, 2, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0)),
    cond_stage_config=dict(n_stages=2, in_channels=2, out_channels=3),
    style_agg="mean", style_sampling="nearby", patch_size=P)
SAMPLER = dict(ddim_steps=4, eta=0.0, cfg_scale=1.5, rescale_phi=0.7, downsample=4)


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


@pytest.mark.parametrize("batched_cfg", [True, False], ids=["shared_encoder", "two_call"])
def test_sampled_images_match_jax(models, batched_cfg):
    jm, params, pm, batch = models
    rng = jax.random.PRNGKey(7)
    jsample = jax.jit(jmake_sample_fn(
        jm, JSchedule.create("linear", 1000, 0.0015, 0.0205),
        JSamplerConfig(batched_cfg=batched_cfg, **SAMPLER)))
    want = np.asarray(jsample(params, {k: jnp.asarray(v) for k, v in batch.items()}, rng))
    x_T = np.array(jax.random.normal(rng, (B, P // 4, P // 4, 3), jnp.float32))

    sample = make_sample_fn(pm, DiffusionSchedule.create("linear", 1000, 0.0015, 0.0205),
                            SamplerConfig(batched_cfg=batched_cfg, **SAMPLER),
                            device="cpu")
    got = sample(pm, batch, x_T=torch.from_numpy(x_T)).numpy()
    assert got.shape == (B, P, P, 3) and np.isfinite(got).all()
    assert 0.05 < np.abs(got).mean() and (np.abs(got) < 1.0).mean() > 0.5, \
        "the image must not be clipped flat for the comparison to mean anything"
    # fp32 summation-order differences, carried through four U-Net passes, the
    # CFG rescale and the decoder
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_sampler_refuses_later_slices(models):
    """PLMS, DPM-Solver and tiled canvases, which later slices of the port
    brought (tests/test_torch_alt_samplers.py, tests/test_torch_tiled.py),
    now sample; an unknown method and PLMS on a canvas still raise."""
    pm, batch = models[2], models[3]
    sched = DiffusionSchedule.create("linear", 1000, 0.0015, 0.0205)
    x_T = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, P // 4, P // 4, 3)).astype(np.float32))
    for kw in (dict(method="plms"), dict(method="dpm")):
        got = make_sample_fn(pm, sched, SamplerConfig(**{**SAMPLER, **kw}), device="cpu")(
            pm, batch, x_T=x_T)
        assert got.shape == (B, P, P, 3) and torch.isfinite(got).all()
    with pytest.raises(NotImplementedError):
        make_sample_fn(pm, sched, SamplerConfig(method="bogus"), device="cpu")
    seg = np.zeros((1, 2 * P, 2 * P, 2), np.float32)
    seg[..., 0] = 1.0
    canvas = {"segmentation": seg, "style_imgs": np.zeros((1, 1, P, P, 3), np.float32)}
    got = make_sample_fn(pm, sched, SamplerConfig(**SAMPLER), device="cpu")(pm, canvas)
    assert got.shape == (1, 2 * P, 2 * P, 3) and torch.isfinite(got).all()
    with pytest.raises(NotImplementedError, match="DDIM only"):
        make_sample_fn(pm, sched, SamplerConfig(**{**SAMPLER, "method": "plms"}),
                       device="cpu")(pm, canvas)
