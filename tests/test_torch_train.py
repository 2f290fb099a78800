"""Diffusion training on a tiny STEDM, the port against the JAX package.

One module-scoped run: the same weights (random, every zero-init layer
non-zero), the same batch (one real and one constant style set, so the
style stop-gradient is covered) and the same t and noise (drawn with
jax.random as the JAX step draws them) go through three micro-steps of the
jitted JAX ``make_train_step`` and of the port's, at accumulation 2 with a
learned logvar. The JAX step's MultiSteps accumulator after the first
micro-step holds that step's gradients, so one JAX compile serves both the
gradient and the update comparisons. Smaller pieces (schedule, loss, EMA,
optimizer, scale-by-std) are compared on their own. Everything is fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _port_helpers import load, random_params

from stedm_tpu.core import diffusion as jdiff
from stedm_tpu.core.schedules import DiffusionSchedule as JSchedule
from stedm_tpu.models.stedm import STEDM as JSTEDM
from stedm_tpu.train import ema as jema
from stedm_tpu.train import optim as joptim
from stedm_tpu.train import steps as jsteps
from stedm_tpu_torch.core import diffusion as pdiff
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.models.stedm import STEDM, build_flagship
from stedm_tpu_torch.models.unet import UNet
from stedm_tpu_torch.train import ema as pema
from stedm_tpu_torch.train import optim as poptim
from stedm_tpu_torch.train import steps as psteps
from stedm_tpu_torch.utils.weights import state_dict_from_jax, unet_state_dict

P, B, N_T, LR = 32, 2, 1000, 1e-3
CONFIGS = dict(
    unet_config=dict(in_channels=6, out_channels=3, model_channels=32, num_res_blocks=1,
                     channel_mult=(1, 4, 8), num_heads=8, attention_resolutions=(32, 16, 8)),
    first_stage_config=dict(embed_dim=3, n_embed=256, ddconfig=dict(
        double_z=False, z_channels=3, resolution=P, in_channels=3, out_ch=3, ch=32,
        ch_mult=[1, 2, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0)),
    cond_stage_config=dict(n_stages=2, in_channels=2, out_channels=3),
    style_agg="mean", style_sampling="nearby", patch_size=P)
SCHED = ("linear", N_T, 0.0015, 0.0205)
GROUPS = ("unet", "cond_stage", "agg")
# the tiny step runs in about a second either way; XLA's backend optimisation
# would add 8 s to its compile
_QUICK_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _batch():
    r = np.random.default_rng(0)
    seg = np.zeros((B, P, P, 2), np.float32)
    seg[..., 0] = 1.0
    seg[:, 8:20, 4:28] = [0.0, 1.0]
    style = r.uniform(-1, 1, (B, 1, P, P, 3)).astype(np.float32)
    style[1] = -2.0                       # the style-drop fill: a constant set
    return {"image": r.uniform(-1, 1, (B, P, P, 3)).astype(np.float32),
            "segmentation": seg, "style_imgs": style}


def _jax_draws(rng, step):
    """t and noise as jax make_train_step draws them (steps.py:95-96, :114-115)."""
    r_t, r_n = jax.random.split(jax.random.fold_in(rng, step))
    t = jax.random.randint(r_t, (B,), 0, N_T)
    noise = jax.random.normal(r_n, (B, P // 4, P // 4, 3), dtype=jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))


@pytest.fixture(scope="module")
def run():
    batch = _batch()
    jm = JSTEDM(**CONFIGS)
    params = random_params(jm, 1, *(jnp.asarray(batch[k]) for k in
                                    ("image", "segmentation", "style_imgs")),
                           jnp.zeros((B,), jnp.int32))
    jtx = joptim.make_optimizer(LR, accumulate_grad_batches=2)
    jstate = jax.jit(lambda p: jsteps.create_train_state(jsteps.init_logvar(p, N_T), jtx))(
        params)   # one small compile beats optax's init op by op
    rng = jax.random.PRNGKey(3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax.jit(jsteps.make_train_step(jm, JSchedule.create(*SCHED), jtx,
                                           learn_logvar=True)).lower(
        jstate, jbatch, rng).compile(compiler_options=_QUICK_COMPILE)
    jlosses, jgrads = [], None
    for i in range(3):
        jstate, m = jstep(jstate, jbatch, rng)
        jlosses.append(float(m["loss"]))
        if i == 0:
            jgrads = jax.tree_util.tree_map(np.asarray, jstate.opt_state.acc_grads)

    pm = load(STEDM(**CONFIGS), state_dict_from_jax(params))
    p0 = {k: v.clone() for k, v in pm.state_dict().items()}
    logvar = psteps.init_logvar(N_T, device="cpu")
    ptx = poptim.make_optimizer(LR, accumulate_grad_batches=2)
    pstate = psteps.create_train_state(pm, ptx, logvar)
    pstep = psteps.make_train_step(pm, DiffusionSchedule.create(*SCHED), ptx,
                                   learn_logvar=True, device="cpu")
    plosses, pgrads = [], None
    for i in range(3):
        t, noise = _jax_draws(rng, i)
        pstate, m = pstep(pstate, batch, t=t, noise=noise)
        plosses.append(float(m["loss"]))
        if i == 0:
            pgrads = {n: p.grad.clone() for n, p in pm.named_parameters() if p.grad is not None}
            pgrads["logvar"] = logvar.grad.clone()
    return dict(params=params, jstate=jstate, jlosses=jlosses, jgrads=jgrads, pm=pm, p0=p0,
                pstate=pstate, plosses=plosses, pgrads=pgrads)


def test_micro_step_loss_and_grads_match_jax(run):
    # fp32 sums in other orders through the codec, the Swin and the U-Net
    np.testing.assert_allclose(run["plosses"][0], run["jlosses"][0], rtol=1e-4)
    want = state_dict_from_jax(run["jgrads"])
    got = run["pgrads"]
    assert set(got) == {k for k in want if not k.startswith("first_stage.")} | {"logvar"}
    # leaves whose gradient is zero analytically (an embedding added ahead of
    # a one-channel GroupNorm group is normalised away) hold only rounding
    # noise (4e-8 of the largest gradient here): their scale is floored at
    # 1e-4 of the largest gradient
    floor = 1e-4 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, w in want.items():
        w = w.numpy()
        if name.startswith("first_stage."):
            assert not np.any(w), f"{name}: the frozen codec got a gradient"
            continue
        g = got[name].numpy()
        assert np.abs(g - w).max() <= 1e-3 * max(np.abs(w).max(), floor), name
    lv_want = np.asarray(run["jgrads"]["logvar"])
    assert np.abs(got["logvar"].numpy() - lv_want).max() <= 1e-3 * np.abs(lv_want).max()
    # the style encoder saw the real set's gradient and only that one
    assert any(np.abs(got[k].numpy()).max() > 0 for k in got if k.startswith("agg."))


def test_three_micro_steps_match_jax(run):
    jstate, pstate, pm, p0 = run["jstate"], run["pstate"], run["pm"], run["p0"]
    # micro-steps 1 and 2 run the same weights; 3 runs them after one update
    np.testing.assert_allclose(run["plosses"], run["jlosses"], rtol=1e-4)
    assert pstate.step == 3 and pstate.opt_state.gradient_step == 1
    assert int(jstate.opt_state.gradient_step) == 1

    jnew = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    jold = state_dict_from_jax(run["params"])
    pnew = pm.state_dict()
    for group in GROUPS:
        keys = [k for k in jnew if k.startswith(group + ".")]
        dj = torch.cat([(jnew[k] - jold[k]).flatten() for k in keys])
        dp = torch.cat([(pnew[k] - p0[k]).flatten() for k in keys])
        assert float(dj.norm()) > 0, group
        # Adam's first step is about lr * sign(g): a relative error of the
        # whole update, not elementwise
        assert float((dp - dj).norm() / dj.norm()) <= 1e-2, group
    for k in (k for k in p0 if k.startswith("first_stage.")):
        assert torch.equal(pnew[k], p0[k]), k
    dlv_j = np.asarray(jstate.params["logvar"])
    dlv_p = pstate.logvar.detach().numpy()
    assert np.linalg.norm(dlv_p - dlv_j) <= 1e-2 * np.linalg.norm(dlv_j)

    # the EMA shadow after three updates (decays 0.1, 2/11, 3/12), measured
    # against where it started
    assert pstate.ema_updates == 3 == int(jstate.ema_updates)
    jema_sd = unet_state_dict(jax.tree_util.tree_map(np.asarray, jstate.ema_params))
    de_j = torch.cat([(jema_sd[k] - p0["unet." + k]).flatten() for k in pstate.ema_params])
    de_p = torch.cat([(v - p0["unet." + k]).flatten() for k, v in pstate.ema_params.items()])
    assert float(de_j.norm()) > 0
    assert float((de_p - de_j).norm() / de_j.norm()) <= 1e-2


def test_schedule_q_sample_and_lvlb_weights_match_jax():
    js, ps = JSchedule.create(*SCHED), DiffusionSchedule.create(*SCHED)
    for name in ("alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "lvlb_weights"):
        np.testing.assert_array_equal(getattr(ps, name), np.asarray(getattr(js, name)), name)
    r = np.random.default_rng(1)
    x, noise = (r.normal(size=(3, 4, 4, 3)).astype(np.float32) for _ in range(2))
    t = np.array([0, 517, 999])
    want = np.asarray(js.q_sample(jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise)))
    got = ps.q_sample(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("loss_type,learned,elbo", [
    ("l1", False, 0.0), ("l2", True, 0.3), ("l1", True, 1.0)])
def test_simple_loss_and_p_losses_match_jax(loss_type, learned, elbo):
    js, ps = JSchedule.create(*SCHED), DiffusionSchedule.create(*SCHED)
    r = np.random.default_rng(2)
    x, noise = (r.normal(size=(3, 4, 4, 3)).astype(np.float32) for _ in range(2))
    t = np.array([1, 400, 998])
    logvar = r.normal(0, 0.3, N_T).astype(np.float32) if learned else None
    w = np.float32(0.7)

    def run_(lib, sched, conv):
        return lib.p_losses(lambda xn, tt: w * xn + 0.1, sched, conv(x), conv(t), conv(noise),
                            loss_type=loss_type, logvar=None if logvar is None else conv(logvar),
                            original_elbo_weight=elbo)

    jl, jaux = run_(jdiff, js, jnp.asarray)
    pl, paux = run_(pdiff, ps, torch.from_numpy)
    for a, b in ((pl, jl), (paux["loss_simple"], jaux["loss_simple"]),
                 (paux["loss_vlb"], jaux["loss_vlb"])):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    np.testing.assert_allclose(
        pdiff.simple_loss(torch.from_numpy(x), torch.from_numpy(noise), loss_type).numpy(),
        np.asarray(jdiff.simple_loss(jnp.asarray(x), jnp.asarray(noise), loss_type)),
        rtol=1e-6)


def test_ema_update_matches_jax():
    r = np.random.default_rng(4)
    shadow = {"a": r.normal(size=(5, 3)), "b": r.normal(size=7)}
    shadow = {k: v.astype(np.float32) for k, v in shadow.items()}
    jshadow, n = dict(shadow), jnp.zeros((), jnp.int32)
    pshadow = {k: torch.from_numpy(v.copy()) for k, v in shadow.items()}
    pn = 0
    for _ in range(4):
        params = {k: r.normal(size=v.shape).astype(np.float32) for k, v in shadow.items()}
        jshadow, n = jema.ema_update(jshadow, {k: jnp.asarray(v) for k, v in params.items()}, n)
        pn = pema.ema_update(pshadow, {k: torch.from_numpy(v) for k, v in params.items()}, pn)
    assert pn == int(n) == 4
    assert pema.ema_decay(20_000) == float(jema.ema_decay(jnp.asarray(20_000)))
    for k in shadow:
        np.testing.assert_allclose(pshadow[k].numpy(), np.asarray(jshadow[k]), rtol=1e-6,
                                   atol=1e-7)


def _toy_tree(r):
    return {"unet": {"w": r.normal(size=(4, 3)), "b": r.normal(size=3)},
            "first_stage": {"w": r.normal(size=(2, 2))},
            "cond_stage": {"w": r.normal(size=(3, 3))},
            "agg": {"w": r.normal(size=(2, 5))}}


@pytest.mark.parametrize("style_trainable,clip", [(True, None), (False, None), (True, 0.5)])
def test_make_optimizer_matches_optax(style_trainable, clip):
    r = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), _toy_tree(r))
    kw = dict(style_encoder_trainable=style_trainable, accumulate_grad_batches=2,
              clip_grad_norm=clip)
    jtx = joptim.make_optimizer(0.05, **kw)
    jparams, jopt = tree, jtx.init(tree)
    jupdate = jax.jit(jtx.update)
    groups = {g: [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in sub.values()]
              for g, sub in tree.items()}
    ptx = poptim.make_optimizer(0.05, **kw)
    popt = ptx.init(groups)
    assert not any(p.requires_grad for p in groups["first_stage"])
    assert all(p.requires_grad == style_trainable for p in groups["agg"])
    for i in range(5):
        grads = jax.tree_util.tree_map(lambda a: r.normal(size=a.shape).astype(np.float32), tree)
        upd, jopt = jupdate(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for g, ps in groups.items():
            for p, gr in zip(ps, grads[g].values()):
                if p.requires_grad:
                    p.grad = torch.from_numpy(gr) if p.grad is None else p.grad + torch.from_numpy(gr)
        assert ptx.update(popt) == (i % 2 == 1)
        for g, ps in groups.items():
            for p, want in zip(ps, jparams[g].values()):
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-5,
                                           atol=1e-6, err_msg=f"{g} after micro-step {i}")


def test_make_optimizer_refuses_m_dtype():
    with pytest.raises(NotImplementedError):
        poptim.make_optimizer(1e-4, m_dtype=torch.bfloat16)
    assert poptim.scaled_lr(1e-6, 4, 2, 8) == joptim.scaled_lr(1e-6, 4, 2, 8)


def test_compute_scale_by_std_and_init_logvar_match_jax(run):
    batch = _batch()
    want = jsteps.compute_scale_by_std(JSTEDM(**CONFIGS), run["params"],
                                       jnp.asarray(batch["image"]))
    got = psteps.compute_scale_by_std(run["pm"], torch.from_numpy(batch["image"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    lv = psteps.init_logvar(N_T, 0.5, device="cpu")
    np.testing.assert_array_equal(lv.detach().numpy(),
                                  np.asarray(jsteps.init_logvar({}, N_T, 0.5)["logvar"]))


def test_unet_checkpointing_keeps_the_gradients():
    torch.manual_seed(0)
    unet = UNet(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, num_heads=4,
                attention_resolutions=(2,))
    for layer in unet.zero_init_layers():
        layer.reset_parameters()
    x, t, ctx = torch.randn(2, 6, 8, 8), torch.tensor([3, 700]), torch.randn(2, 512)

    def grads(use_checkpoint):
        unet.use_checkpoint = use_checkpoint
        unet.zero_grad()
        unet(x, t, ctx).square().sum().backward()
        return {n: p.grad.clone() for n, p in unet.named_parameters()}

    plain, ckpt = grads(False), grads(True)
    assert all(float(g.abs().max()) > 0 for n, g in plain.items() if "proj_out" in n)
    for n in plain:
        torch.testing.assert_close(ckpt[n], plain[n], msg=n)


def test_flagship_training_build():
    model, batch, _ = build_flagship(batch=2, device="meta", patch=512, nonzero_init=True)
    assert model.first_stage.encoder.down[0].block[0].conv1.weight.device.type == "meta"
    assert batch["image"].shape == (2, 512, 512, 3)
    assert batch["style_imgs"].shape == (2, 1, 512, 512, 3)
    assert model.patch_size == 512
    small = UNet(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, num_heads=4)
    layers = small.zero_init_layers()
    # 2 input + 3 middle + 4 output ResBlocks, the middle attention, the out conv
    assert len(layers) == 9 + 1 + 1
    assert all(not layer.weight.any() for layer in layers)
