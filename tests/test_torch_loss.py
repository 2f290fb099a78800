"""The port's training loss and schedule weights against the JAX package:
both parameterizations, the simple-loss weight and the ELBO weights, fp32 on
the CPU from numpy inputs made with a seed (relative tolerance 1e-5: the two
frameworks sum the per-sample means in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_helpers import RTOL  # noqa: F401  (also caps torch threads)

from stedm_tpu.core import diffusion as jdiff
from stedm_tpu.core import schedules as jsched
from stedm_tpu_torch.core import diffusion as pdiff
from stedm_tpu_torch.core import schedules as psched

SCHEDULE = dict(beta_schedule="linear", timesteps=1000, linear_start=0.0015, linear_end=0.0205)
TOL = 1e-5


def _inputs(seed=0, b=4):
    r = np.random.default_rng(seed)
    x0 = r.normal(size=(b, 8, 8, 3)).astype(np.float32)
    noise = r.normal(size=(b, 8, 8, 3)).astype(np.float32)
    t = r.integers(0, 1000, size=(b,)).astype(np.int32)
    w = r.normal(size=(3, 3)).astype(np.float32)   # a stand-in model: x_noisy @ w, scaled by t
    logvar = r.normal(0, 0.3, size=(1000,)).astype(np.float32)
    return x0, noise, t, w, logvar


@pytest.mark.parametrize("parameterization", ["eps", "x0"])
def test_lvlb_weights_match_jax(parameterization):
    js = jsched.DiffusionSchedule.create(parameterization=parameterization, **SCHEDULE)
    ps = psched.DiffusionSchedule.create(parameterization=parameterization, **SCHEDULE)
    np.testing.assert_allclose(ps.lvlb_weights, np.asarray(js.lvlb_weights), rtol=TOL, atol=0)
    assert ps.lvlb_weights[0] == ps.lvlb_weights[1]


def test_unknown_parameterization_raises_on_both_sides():
    with pytest.raises(NotImplementedError):
        jsched.DiffusionSchedule.create(parameterization="v", **SCHEDULE)
    with pytest.raises(NotImplementedError):
        psched.DiffusionSchedule.create(parameterization="v", **SCHEDULE)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(parameterization="x0"),
    dict(l_simple_weight=0.5),
    dict(parameterization="x0", l_simple_weight=0.5, original_elbo_weight=0.25, loss_type="l2"),
    dict(l_simple_weight=0.5, original_elbo_weight=0.1, use_logvar=True),
], ids=["eps", "x0", "l_simple_half", "x0_l2_elbo", "eps_logvar_elbo"])
def test_p_losses_match_jax(kwargs):
    kwargs = dict(kwargs)
    use_logvar = kwargs.pop("use_logvar", False)
    param = kwargs.get("parameterization", "eps")
    x0, noise, t, w, logvar = _inputs()
    js = jsched.DiffusionSchedule.create(parameterization=param, **SCHEDULE)
    ps = psched.DiffusionSchedule.create(parameterization=param, **SCHEDULE)

    def j_eps(x, tt):
        return (x @ jnp.asarray(w)) * (1 + tt.reshape(-1, 1, 1, 1) / 1000.0)

    def p_eps(x, tt):
        return (x @ torch.from_numpy(w)) * (1 + tt.reshape(-1, 1, 1, 1) / 1000.0)

    j_loss, j_parts = jdiff.p_losses(
        j_eps, js, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise),
        logvar=jnp.asarray(logvar) if use_logvar else None, **kwargs)
    p_loss, p_parts = pdiff.p_losses(
        p_eps, ps, torch.from_numpy(x0), torch.from_numpy(t).long(), torch.from_numpy(noise),
        logvar=torch.from_numpy(logvar) if use_logvar else None, **kwargs)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=TOL)
    assert set(p_parts) == set(j_parts)
    for name in j_parts:
        np.testing.assert_allclose(float(p_parts[name]), float(j_parts[name]), rtol=TOL)


def test_x0_target_differs_from_eps_target():
    """The two parameterizations are not the same loss on the same inputs."""
    x0, noise, t, w, _ = _inputs(seed=1)
    ps = psched.DiffusionSchedule.create(**SCHEDULE)
    fn = lambda x, tt: x @ torch.from_numpy(w)  # noqa: E731
    args = (fn, ps, torch.from_numpy(x0), torch.from_numpy(t).long(), torch.from_numpy(noise))
    eps, _ = pdiff.p_losses(*args)
    x0_loss, _ = pdiff.p_losses(*args, parameterization="x0")
    half, _ = pdiff.p_losses(*args, l_simple_weight=0.5)
    assert abs(float(eps) - float(x0_loss)) > 1e-3
    np.testing.assert_allclose(float(half), 0.5 * float(eps), rtol=1e-6)
