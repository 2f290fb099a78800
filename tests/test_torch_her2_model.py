"""The layout mapper's width (ROADMAP §3, PR 10): flax's ``SpatialRescaler``
takes its 1x1 mapper's width from the one-hot it is initialised on and never
reads the config's ``in_channels``. The port's ``SpatialRescaler`` and
``STEDM`` conditioning against JAX's on a 6-class (HER2) and an 8-class
(CATCH) one-hot with the weights bridged, and ``build_stedm`` against JAX's
``build_stedm`` + the entry points' init when the config's ``in_channels``
says something else. fp32 on the CPU; outputs within 1e-5 absolute (a 1x1
convolution of 2x2 means: the sums differ only in order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_helpers  # noqa: F401  (caps torch threads)
from _flowers_helpers import TINY_OVERRIDES
from _port_helpers import jax_apply, random_params

from stedm_tpu.config import compose as jcompose
from stedm_tpu.models.cond import SpatialRescaler as JSpatialRescaler
from stedm_tpu.models.stedm import build_stedm as jbuild_stedm
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.models.cond import SpatialRescaler
from stedm_tpu_torch.models.stedm import STEDM, build_stedm
from stedm_tpu_torch.utils.weights import cond_state_dict, state_dict_from_jax

ATOL = 1e-5
CLASSES = {"her2": 6, "catch": 8}


def _one_hot(n: int, c: int, hw: int = 32, seed: int = 0) -> np.ndarray:
    idx = np.random.default_rng(seed).integers(0, c, (n, hw, hw))
    return np.eye(c, dtype=np.float32)[idx]


@pytest.mark.parametrize("data", list(CLASSES))
def test_spatial_rescaler_on_a_histopathology_one_hot(data):
    c = CLASSES[data]
    x = _one_hot(2, c)
    jmod = JSpatialRescaler()          # in_channels stays 2: flax never reads it
    params = random_params(jmod, 1, jnp.asarray(x))
    assert params["channel_mapper"]["kernel"].shape == (1, 1, c, 3)
    want = jax_apply(jmod, params, jnp.asarray(x))
    mod = SpatialRescaler(in_channels=c)
    mod.load_state_dict(cond_state_dict(params), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _stedm_init_args(p: int, c: int):
    return (jnp.zeros((1, p, p, 3)), jnp.zeros((1, p, p, c)), jnp.zeros((1, 1, p, p, 3)),
            jnp.zeros((1,), jnp.int32))


@pytest.mark.parametrize("data", list(CLASSES))
def test_stedm_conditioning_on_a_histopathology_one_hot(data):
    """JAX's STEDM initialised on the C-class one-hot, its whole tree bridged
    into the port's ``STEDM`` built with the layout C channels wide."""
    c = CLASSES[data]
    overrides = TINY_OVERRIDES + [f"data={data}", "data.patch_size=32",
                                  "diffusion.compute_dtype=float32"]
    jmodel = jbuild_stedm(jcompose("config_diff", overrides))
    params = random_params(jmodel, 2, *_stedm_init_args(32, c))
    assert params["cond_stage"]["channel_mapper"]["kernel"].shape == (1, 1, c, 3)
    x = _one_hot(2, c, seed=3)
    want = jax_apply(jmodel, params, jnp.asarray(x), method=jmodel.cond_encode)
    cfg = compose("config_diff", overrides)
    diff = cfg.diffusion
    model = STEDM(unet_config=dict(diff.unet_config.params),
                  first_stage_config=dict(diff.first_stage_config.params),
                  cond_stage_config={**diff.cond_stage_config.params, "in_channels": c},
                  style_agg=cfg.style_agg.name, style_sampling=cfg.style_sampling.name,
                  patch_size=cfg.data.patch_size)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = model.cond_encode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("data", list(CLASSES))
def test_build_stedm_takes_the_width_of_the_entry_points_layout(data):
    """A config whose ``in_channels`` names the data's classes: JAX's entry
    points still initialise on the two-channel layout they feed
    (train_diff.py:87-91), so the mapper is [2 -> 3] on both sides."""
    overrides = TINY_OVERRIDES + [f"data={data}", "data.patch_size=32",
                                  "diffusion.compute_dtype=float32",
                                  f"diffusion.cond_stage_config.params.in_channels={CLASSES[data]}"]
    jmodel = jbuild_stedm(jcompose("config_diff", overrides))
    params = random_params(jmodel, 4, *_stedm_init_args(32, 2))
    model = build_stedm(compose("config_diff", overrides), "cpu")
    assert tuple(model.cond_stage.channel_mapper.weight.shape) == (3, 2, 1, 1)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    x = _one_hot(2, 2, seed=5)
    want = jax_apply(jmodel, params, jnp.asarray(x), method=jmodel.cond_encode)
    with torch.no_grad():
        got = model.cond_encode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
