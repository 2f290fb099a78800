"""The set-ViT style encoder (``style_agg: svit``), the port against the JAX
package: ``SViT`` in eval mode with and without the time token, the STEDM
``svit`` branch (style vector and eps), one train micro-step at dropout 0
(loss and gradients), and the JAX fault the port repairs: JAX's train step
cannot draw the shipped dropout (``InvalidRngError``), while the port's
draws it from the step's generator.

Same weights (the JAX tree through ``state_dict_from_jax``), same inputs
(numpy from a seed). Tolerances: the module in fp32 at rtol 1e-5, atol
1e-5; through the whole STEDM rtol = atol = 1e-4 (fp32 sums in other
orders through the Swin-free model); the train step as tests/test_torch_train.py."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_helpers import load, random_params

from stedm_tpu.core.schedules import DiffusionSchedule as JSchedule
from stedm_tpu.models.stedm import STEDM as JSTEDM
from stedm_tpu.models.svit import SViT as JSViT
from stedm_tpu.train import optim as joptim
from stedm_tpu.train import steps as jsteps
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.models.stedm import STEDM
from stedm_tpu_torch.models.svit import SViT, dropout
from stedm_tpu_torch.train import optim as poptim
from stedm_tpu_torch.train import steps as psteps
from stedm_tpu_torch.utils.weights import agg_state_dict, state_dict_from_jax

P, B, N_T = 32, 2, 1000
SVIT = dict(patch_size=8, dim=32, depth=2, heads=2, mlp_dim=48, dim_head=16, t_dim=24,
            dropout=0.0, emb_dropout=0.0)
CONFIGS = dict(
    unet_config=dict(in_channels=6, out_channels=3, model_channels=32, num_res_blocks=1,
                     channel_mult=(1, 4, 8), num_heads=8, attention_resolutions=(32, 16, 8)),
    first_stage_config=dict(embed_dim=3, n_embed=256, ddconfig=dict(
        double_z=False, z_channels=3, resolution=P, in_channels=3, out_ch=3, ch=32,
        ch_mult=[1, 2, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0)),
    cond_stage_config=dict(n_stages=2, in_channels=2, out_channels=3),
    style_agg="svit", style_sampling="nearby", patch_size=P)
SCHED = ("linear", N_T, 0.0015, 0.0205)


def _set(n=2, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (B, n, P, P, 3)).astype(np.float32)


@pytest.mark.parametrize("time_token", [False, True], ids=["zeros_time_token", "time_token"])
def test_svit_eval_forward_matches_jax(time_token):
    imgs = _set()
    args = dict(image_size=P, num_classes=40, ns=2, **SVIT)
    jm = JSViT(**args)
    t_emb = np.random.default_rng(1).normal(size=(B * 2, SVIT["t_dim"])).astype(np.float32)
    extra = (jnp.asarray(t_emb),) if time_token else ()
    params = random_params(jm, 2, jnp.asarray(imgs), *extra)
    want = np.asarray(jax.jit(lambda p, x, *e: jm.apply({"params": p}, x, *e))(
        params, imgs, *extra))
    pm = load(SViT(time_embedding=time_token, **args), agg_state_dict(params))
    with torch.no_grad():
        got = pm(torch.from_numpy(imgs),
                 torch.from_numpy(t_emb) if time_token else None).numpy()
    assert got.shape == (B, 40)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _batch():
    r = np.random.default_rng(0)
    seg = np.zeros((B, P, P, 2), np.float32)
    seg[..., 0] = 1.0
    seg[:, 8:20, 4:28] = [0.0, 1.0]
    return {"image": r.uniform(-1, 1, (B, P, P, 3)).astype(np.float32),
            "segmentation": seg, "style_imgs": _set(1)}


def _models(svit=SVIT):
    batch = _batch()
    jm = JSTEDM(svit_config=svit, **CONFIGS)
    params = random_params(jm, 1, *(jnp.asarray(batch[k]) for k in
                                    ("image", "segmentation", "style_imgs")),
                           jnp.zeros((B,), jnp.int32))
    pm = load(STEDM(svit_config=svit, **CONFIGS), state_dict_from_jax(params))
    return jm, params, pm, batch


def test_stedm_svit_branch_matches_jax():
    jm, params, pm, batch = _models()
    assert isinstance(pm.agg, SViT) and pm.agg.to_time_embedding is None
    style = np.asarray(jm.apply({"params": params}, batch["style_imgs"],
                                method=jm.style_encode))
    t = np.array([10, 700])
    z = np.random.default_rng(2).normal(size=(B, P // 4, P // 4, 3)).astype(np.float32)
    seg_cond = jm.apply({"params": params}, batch["segmentation"], method=jm.cond_encode)
    eps = np.asarray(jm.apply({"params": params}, z, t, seg_cond, style, method=jm.eps))
    with torch.no_grad():
        pstyle = pm.style_encode(torch.from_numpy(batch["style_imgs"]))
        peps = pm.eps(torch.from_numpy(z), torch.from_numpy(t),
                      pm.cond_encode(torch.from_numpy(batch["segmentation"])), pstyle)
    np.testing.assert_allclose(pstyle.numpy(), style, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(peps.numpy(), eps, rtol=1e-4, atol=1e-4)


def test_train_micro_step_at_dropout_0_matches_jax():
    """One micro-step at accumulation 2: JAX's MultiSteps accumulator then
    holds the step's gradients."""
    jm, params, pm, batch = _models()
    jtx = joptim.make_optimizer(1e-3, accumulate_grad_batches=2)
    jstate = jsteps.create_train_state(params, jtx)
    rng = jax.random.PRNGKey(3)
    jstep = jax.jit(jsteps.make_train_step(jm, JSchedule.create(*SCHED), jtx))
    jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    r_t, r_n = jax.random.split(jax.random.fold_in(rng, 0))
    t = torch.from_numpy(np.array(jax.random.randint(r_t, (B,), 0, N_T)))
    noise = torch.from_numpy(np.array(jax.random.normal(r_n, (B, P // 4, P // 4, 3))))

    ptx = poptim.make_optimizer(1e-3, accumulate_grad_batches=2)
    pstate = psteps.create_train_state(pm, ptx)
    pstep = psteps.make_train_step(pm, DiffusionSchedule.create(*SCHED), ptx, device="cpu")
    pstate, pmetrics = pstep(pstate, batch, t=t, noise=noise)
    np.testing.assert_allclose(float(pmetrics["loss"]), float(m["loss"]), rtol=1e-4)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.opt_state.acc_grads))
    grads = {n: p.grad for n, p in pm.named_parameters() if p.grad is not None}
    agg = [k for k in want if k.startswith("agg.")]
    assert agg and all(k in grads for k in agg)
    floor = 1e-4 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name in agg + [k for k in want if k.startswith("unet.")]:
        w = want[name].numpy()
        assert np.abs(grads[name].numpy() - w).max() <= 1e-3 * max(np.abs(w).max(), floor), name


def test_jax_step_cannot_draw_the_shipped_dropout_and_the_port_does():
    """configs/style_agg/svit.yaml's dropout 0.1: JAX's step calls
    style_encode with train=True and no 'dropout' rng, which flax refuses
    (ROADMAP §3). The port draws the dropout from the step's generator."""
    shipped = {**SVIT, "dropout": 0.1, "emb_dropout": 0.1}
    jm, params, pm, batch = _models(shipped)
    jtx = joptim.make_optimizer(1e-3, accumulate_grad_batches=2)
    jstep = jsteps.make_train_step(jm, JSchedule.create(*SCHED), jtx)
    with pytest.raises(flax.errors.InvalidRngError, match="dropout"):
        jax.eval_shape(jstep, jsteps.create_train_state(params, jtx),
                       {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    pstep = psteps.make_train_step(pm, DiffusionSchedule.create(*SCHED),
                                   poptim.make_optimizer(0.0), device="cpu")
    # t and the noise fixed, so that only the dropout masks follow the seed
    r = np.random.default_rng(4)
    t = torch.from_numpy(r.integers(0, N_T, (B,)))
    noise = torch.from_numpy(r.normal(size=(B, P // 4, P // 4, 3)).astype(np.float32))
    losses = []
    for seed in (0, 0, 1):
        state = psteps.create_train_state(pm, poptim.make_optimizer(0.0))
        _, m = pstep(state, batch, torch.Generator().manual_seed(seed), t=t, noise=noise)
        losses.append(float(m["loss"]))
        pm.zero_grad(set_to_none=True)
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1] != losses[2]    # the draws follow the generator
    with torch.no_grad():   # eval mode draws nothing
        a = pm.style_encode(torch.from_numpy(batch["style_imgs"]))
        b = pm.style_encode(torch.from_numpy(batch["style_imgs"]))
    assert torch.equal(a, b)


def test_dropout_keeps_one_minus_the_rate_and_scales_what_it_keeps():
    """models/svit.py:dropout is flax's rule: each element kept with
    probability 1 - rate and divided by 1 - rate; the identity in eval mode
    and at rate 0; a train-mode draw needs the step's generator."""
    x = torch.rand(1000, 1000, generator=torch.Generator().manual_seed(0)) + 0.5   # no zeros
    rate = 0.1
    y = dropout(x, rate, True, torch.Generator().manual_seed(1))
    kept = y != 0
    # 1e6 Bernoulli(0.9) draws: the kept share has a standard deviation of 3e-4
    assert abs(float(kept.float().mean()) - (1 - rate)) < 2e-3
    assert torch.equal(y[kept], (x / (1 - rate))[kept])
    assert torch.equal(y, dropout(x, rate, True, torch.Generator().manual_seed(1)))
    assert not torch.equal(y, dropout(x, rate, True, torch.Generator().manual_seed(2)))
    assert dropout(x, rate, False, None) is x
    assert dropout(x, 0.0, True, torch.Generator().manual_seed(1)) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, rate, True, None)
