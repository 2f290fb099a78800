"""The diffusion model's options against the JAX package, on tiny models.

Every option of the JAX U-Net (scale-shift norm, up/down ResBlocks, no
resampling convs, heads of ``num_head_channels``, the spatial transformer,
class labels, dropout), the conditioning keys of STEDM, the beta schedules,
the bf16 first moment of AdamW and the plain attention at Dh 32. Weights are
seeded random values in the JAX tree carried across by the port's weight
bridge and loaded strictly; inputs are numpy arrays from a seed; fp32 on the
CPU. ``model_channels`` 32, ``channel_mult`` (1, 2), one ResBlock a level.
The last tests pin what the JAX package does with these options and the
port mirrors (ROADMAP §3)."""

from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _port_helpers import load, nhwc_to_nchw, quick_jit, random_params, to_numpy_nhwc
from jax.experimental.pallas import tpu as pltpu

from stedm_tpu.core import ddim as jddim
from stedm_tpu.core import schedules as jsched
from stedm_tpu.models import unet as junet
from stedm_tpu.models import vq as jvq
from stedm_tpu.models.stedm import STEDM as JSTEDM
from stedm_tpu.ops.blocked_attention import flash_sdpa
from stedm_tpu.train import optim as joptim
from stedm_tpu.train import steps as jsteps
from stedm_tpu.train.fused_adamw import fused_adamw
from stedm_tpu_torch.core import ddim as pddim
from stedm_tpu_torch.core import schedules as psched
from stedm_tpu_torch.models import unet as punet
from stedm_tpu_torch.models import vq as pvq
from stedm_tpu_torch.models.stedm import STEDM
from stedm_tpu_torch.ops import blocked_attention as pattn
from stedm_tpu_torch.train import optim as poptim
from stedm_tpu_torch.train import steps as psteps
from stedm_tpu_torch.utils import weights

BASE = dict(in_channels=6, out_channels=3, model_channels=32, num_res_blocks=1,
            channel_mult=(1, 2), num_heads=2, attention_resolutions=(2,))
OPTION_SETS = {
    "scale_shift_updown": dict(use_scale_shift_norm=True, resblock_updown=True),
    "no_resample_conv_classes_dropout": dict(conv_resample=False, num_classes=5, dropout=0.1),
    "head_channels": dict(num_head_channels=16),
    "spatial_transformer": dict(use_spatial_transformer=True, transformer_depth=2,
                                num_head_channels=16),
    "all": dict(use_scale_shift_norm=True, resblock_updown=True, conv_resample=False,
                num_head_channels=16, use_spatial_transformer=True, transformer_depth=2,
                num_classes=5, dropout=0.1),
}
# fp32 on both sides: the same sums in other orders
REL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(seed: int = 0, b: int = 2, cin: int = 6):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, 16, 16, cin)).astype(np.float32),
            np.array([3, 977, 500, 20][:b], dtype=np.int32),
            r.normal(size=(b, 512)).astype(np.float32),
            np.array([1, 4, 0, 2][:b], dtype=np.int32))


def _unet_pair(options: dict, seed: int = 1):
    x, t, ctx, y = _inputs()
    jm = junet.UNet(**BASE, **options)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    if "num_classes" in options:
        args += (jnp.asarray(y),)
    params = random_params(jm, seed, *args)
    pm = load(punet.UNet(**BASE, **options), weights.unet_state_dict(params))
    return jm, params, pm, args


def _port_args(args):
    x, t, ctx = (torch.from_numpy(np.asarray(a)) for a in args[:3])
    y = torch.from_numpy(np.asarray(args[3])).long() if len(args) > 3 else None
    return (x.permute(0, 3, 1, 2), t, ctx), y


@pytest.mark.parametrize("name", list(OPTION_SETS))
def test_unet_options_match_jax(name):
    """The U-Net with each option set (dropout at eval: flax's
    deterministic), and the bridge's names and shapes for its parameters:
    the FiLM ``emb`` of width 2 out, the up/down ResBlocks, the spatial
    transformers, ``label_emb``."""
    options = OPTION_SETS[name]
    jm, params, pm, args = _unet_pair(options)
    want = np.asarray(quick_jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *args))
    pargs, y = _port_args(args)
    with torch.no_grad():
        got = to_numpy_nhwc(pm(*pargs, y=y))
    assert got.shape == want.shape == (2, 16, 16, 3)
    assert _rel(got, want) <= REL, _rel(got, want)
    # every port parameter has its flax path, at the JAX parameter's shape
    flat = {"/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    for key, path in weights.flax_paths(pm, "unet").items():
        want_shape = flat[path]
        got_shape = tuple(pm.get_parameter(key).shape)
        assert int(np.prod(got_shape)) == int(np.prod(want_shape)), (key, path)
    if options.get("use_scale_shift_norm"):
        assert pm.input_blocks[1][0].emb_layers["1"].out_features == 2 * 32


def test_unet_gradients_match_jax_grad():
    """Scale-shift norm, the spatial transformer and 16-wide heads: the
    gradient of sum(out * w) with respect to every parameter, ``jax.grad``
    against autograd, each tensor within 1e-4 relative (L2) plus 1e-4: the
    biases of the convs ahead of a GroupNorm of one channel a group get a
    zero gradient up to rounding (~1e-6 on each side)."""
    options = dict(use_scale_shift_norm=True, use_spatial_transformer=True,
                   num_head_channels=16)
    jm, params, pm, args = _unet_pair(options, seed=3)
    w = np.random.default_rng(9).normal(size=(2, 16, 16, 3)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, *args) * w)

    jgrads = weights.unet_state_dict(quick_jit(jax.grad(loss))(params))
    pargs, _ = _port_args(args)
    out = pm(*pargs).permute(0, 2, 3, 1)
    (out * torch.from_numpy(w)).sum().backward()
    for name, prm in pm.named_parameters():
        want, got = jgrads[name].numpy(), prm.grad.numpy()
        err = float(np.linalg.norm(got - want))
        assert err <= 1e-4 * np.linalg.norm(want) + 1e-4, (name, err, np.linalg.norm(want))


CODEC = dict(embed_dim=3, n_embed=64, ddconfig=dict(
    double_z=False, z_channels=3, resolution=32, in_channels=3, out_ch=3, ch=32,
    ch_mult=[1, 2, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0))
COND = dict(n_stages=2, in_channels=2, out_channels=3)


def _stedm_pair(key: str, options: dict | None = None, seed: int = 5, labels: bool = False):
    """A JAX and a port STEDM with ``conditioning_key`` and the U-Net's
    params only (eps touches nothing else): in_channels 6 for the layouts
    concatenated to the latent, else the latent's 3, as flax infers it;
    ``labels``: the tree made with integer labels (``label_emb``)."""
    unet = {**BASE, **(options or {})}
    cin = 6 if key in ("hybrid", "concat") else 3
    x, t, ctx, y = _inputs(cin=cin)
    params = random_params(junet.UNet(**{**unet, "in_channels": cin}), seed, jnp.asarray(x),
                           jnp.asarray(t), jnp.asarray(ctx), *([jnp.asarray(y)] if labels else []))
    kw = dict(unet_config=unet, first_stage_config=CODEC, cond_stage_config=COND,
              style_sampling="none", patch_size=64, conditioning_key=key)
    pm = STEDM(**kw).eval()
    pm.unet.load_state_dict(weights.unet_state_dict(params), strict=True)
    return JSTEDM(**kw), {"unet": params}, pm


@pytest.mark.parametrize("key", ["concat", "crossattn", "none"])
def test_stedm_eps_conditioning_keys(key):
    """concat: the layout concatenated, no style; crossattn: the style as
    the U-Net's context, no layout; none: neither (stedm_tpu
    stedm.py:120-135). The port's U-Net takes 3 input channels where the
    layout is not concatenated."""
    jm, params, pm = _stedm_pair(key)
    r = np.random.default_rng(6)
    z = r.normal(size=(2, 16, 16, 3)).astype(np.float32)
    seg = r.normal(size=(2, 16, 16, 3)).astype(np.float32)
    style = r.normal(size=(2, 512)).astype(np.float32)
    t = np.array([10, 600], np.int32)
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, (z, t, seg, style)),
                               method=jm.eps))
    with torch.no_grad():
        got = pm.eps(*map(torch.from_numpy, (z, t, seg, style))).numpy()
    assert pm.unet.input_blocks[0][0].in_channels == (6 if key == "concat" else 3)
    assert _rel(got, want) <= REL
    if key == "crossattn":   # the style reaches the output
        with torch.no_grad():
            other = pm.eps(*map(torch.from_numpy, (z, t, seg, style + 1))).numpy()
        assert not np.allclose(other, got)


def test_adm_refused_with_class_labels_and_ignored_without():
    """conditioning_key adm passes the float style vector as the U-Net's
    ``y`` (stedm_tpu stedm.py:132): with ``num_classes`` flax's nn.Embed
    raises ValueError and so does the port; without, ``y`` is ignored on
    both sides, so adm gives none's eps."""
    r = np.random.default_rng(7)
    z = r.normal(size=(2, 16, 16, 3)).astype(np.float32)
    style = r.normal(size=(2, 512)).astype(np.float32)
    t = np.array([10, 600], np.int32)
    jm, _, pm = _stedm_pair("adm", {"num_classes": 5}, labels=True)
    with pytest.raises(ValueError, match="integer"):
        jm.apply({"params": _}, *map(jnp.asarray, (z, t, z, style)), method=jm.eps)
    with pytest.raises(ValueError, match="integer"), torch.no_grad():
        pm.eps(*map(torch.from_numpy, (z, t, z, style)))
    jm, params, pm = _stedm_pair("adm")
    jm_none, _, pm_none = _stedm_pair("none")
    pm_none.load_state_dict(pm.state_dict())
    args = (z, t, z, style)
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args), method=jm.eps))
    want_none = np.asarray(jm_none.apply({"params": params}, *map(jnp.asarray, args),
                                         method=jm_none.eps))
    np.testing.assert_array_equal(want, want_none)
    with torch.no_grad():
        got = pm.eps(*map(torch.from_numpy, args)).numpy()
        assert np.array_equal(got, pm_none.eps(*map(torch.from_numpy, args)).numpy())
    assert _rel(got, want) <= REL


def test_ddim_step_with_the_spatial_transformer_through_batched_cfg():
    """With the spatial transformer the style no longer enters only at the
    bottleneck, so batched CFG runs both branches whole (stedm_tpu
    steps.py:318-338): one DDIM step with rescaled CFG (1.5, phi 0.7)
    against JAX's ``ddim_sample`` on JAX's batched pair. The shared-encoder
    fan-out is refused by both U-Nets, and caching with CFG by the port's
    sampler plan, as by JAX's (steps.py:359-362)."""
    opts = dict(use_spatial_transformer=True, num_head_channels=16)
    jm, params, pm = _stedm_pair("hybrid", opts, seed=8)
    r = np.random.default_rng(8)
    b = 2
    x_T = r.normal(size=(b, 16, 16, 3)).astype(np.float32)
    seg = r.normal(size=(b, 16, 16, 3)).astype(np.float32)
    ctx2 = r.normal(size=(2 * b, 512)).astype(np.float32)
    jsch = jsched.DiffusionSchedule.create("linear", 1000, 0.0015, 0.0205)
    sch = psched.DiffusionSchedule.create("linear", 1000, 0.0015, 0.0205)
    seg2 = jnp.concatenate([jnp.asarray(seg)] * 2)

    def jpair(x, t):
        e = jm.apply({"params": params}, jnp.concatenate([x, x]), jnp.concatenate([t, t]),
                     seg2, jnp.asarray(ctx2), method=jm.eps)
        return e[:b], e[b:]

    want = np.asarray(quick_jit(lambda x: jddim.ddim_sample(
        jpair, x, jddim.DDIMParams.create(jsch, 1, 0.0), cfg_scale=1.5,
        rescale_phi=0.7))(jnp.asarray(x_T)))
    cfg = psteps.SamplerConfig(ddim_steps=1, cfg_scale=1.5, rescale_phi=0.7, batched_cfg=True)
    plan = psteps.plan_sampler(pm, sch, cfg)
    assert plan.use_cfg and not plan.shared_enc and not pm.bottleneck_only
    f = psteps.eps_functions(pm, plan, torch.from_numpy(seg), torch.from_numpy(ctx2))
    with torch.no_grad():
        got = pddim.ddim_sample(f.pair, torch.from_numpy(x_T), plan.ddim, cfg_scale=1.5,
                                rescale_phi=0.7).numpy()
    assert _rel(got, want) <= REL
    # the shared-encoder fan-out (a context of 2B on a batch of B)
    x6 = jnp.concatenate([jnp.asarray(x_T), jnp.asarray(seg)], -1)
    t = jnp.array([5, 9], jnp.int32)
    with pytest.raises(AssertionError, match="bottleneck-only"):
        jm.apply({"params": params}, jnp.asarray(x_T), t, jnp.asarray(seg), jnp.asarray(ctx2),
                 method=jm.eps)
    with pytest.raises(AssertionError, match="bottleneck-only"), torch.no_grad():
        pm.unet(nhwc_to_nchw(np.asarray(x6)), torch.tensor([5, 9]), torch.from_numpy(ctx2))
    with pytest.raises(ValueError, match="bottleneck-only conditioning"):
        psteps.plan_sampler(pm, sch, psteps.SamplerConfig(ddim_steps=4, cache_interval=2))


@pytest.mark.parametrize("schedule", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedules_bit_equal(schedule):
    """The float64 betas and the float32 buffers of every schedule, bit for
    bit; an unknown name raises on both sides."""
    args = (schedule, 1000, 0.0015, 0.0205)
    np.testing.assert_array_equal(psched.make_beta_schedule(*args),
                                  jsched.make_beta_schedule(*args))
    js, ps = jsched.DiffusionSchedule.create(*args), psched.DiffusionSchedule.create(*args)
    for name in ("alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "lvlb_weights"):
        np.testing.assert_array_equal(getattr(ps, name), np.asarray(getattr(js, name)), name)
    with pytest.raises(ValueError, match="unknown"):
        psched.make_beta_schedule("quadratic", 10)
    with pytest.raises(ValueError, match="unknown"):
        jsched.make_beta_schedule("quadratic", 10)


@pytest.mark.parametrize("fused", [False, True], ids=["optax_mu_dtype", "fused_adamw"])
def test_adamw_bf16_first_moment_matches_jax(fused):
    """``m_dtype=bfloat16`` over 3 updates against ``optax.adamw(mu_dtype=
    bfloat16)`` and the JAX package's ``fused_adamw(m_dtype=bfloat16)``
    (``+fused_adamw``): the stored first moment is bf16 and within one bf16
    ulp of JAX's, the second fp32, and the parameters within 1e-6 relative.
    The two JAX forms differ (optax rounds b1 m to bf16, b1 included), and
    each port form matches its own."""
    r = np.random.default_rng(11)
    shapes = [(8, 4), (4,), (3, 3, 2)]
    p0 = [r.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[r.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]
    lr, wd = 1e-2, 0.01
    tx = (fused_adamw(lr, weight_decay=wd, m_dtype=jnp.bfloat16) if fused
          else optax.adamw(lr, weight_decay=wd, mu_dtype=jnp.bfloat16))
    jp = [jnp.asarray(a) for a in p0]
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
    jm = st.m if fused else st[0].mu
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = poptim.make_optimizer(lr, weight_decay=wd, fused=fused, m_dtype=torch.bfloat16)
    state = opt.init({"unet": ps})
    assert isinstance(state.adamw, poptim.AdamWLowFirstMoment)
    for g in grads:
        for p, a in zip(ps, g):
            p.grad = torch.from_numpy(a.copy())
        assert opt.update(state)
    for p, want in zip(ps, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    m = [state.adamw.state[p]["exp_avg"] for p in ps]
    assert all(x.dtype == torch.bfloat16 for x in m)
    assert all(state.adamw.state[p]["exp_avg_sq"].dtype == torch.float32 for p in ps)
    got_m = np.concatenate([x.float().numpy().ravel() for x in m])
    want_m = np.asarray(jm.astype(jnp.float32)).ravel() if fused else np.concatenate(
        [np.asarray(x.astype(jnp.float32)).ravel() for x in jm])
    assert np.all(np.abs(got_m - want_m) <= 2 ** -8 * np.abs(want_m)), \
        float(np.abs(got_m - want_m).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_at_dh32_matches_the_stock_kernel(dtype):
    """The U-Net's AttentionBlock at num_head_channels 32: the plain
    forward (and ``FlashAttentionFunction``'s on the CPU) against the stock
    Pallas TPU flash kernel in interpret mode, which takes Dh 32 (its gate
    checks T only, stedm_tpu/ops/blocked_attention.py:94-96)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    r = np.random.default_rng(12)
    q, k, v = (r.normal(size=(2, 4, 128, 32)).astype(np.float32) for _ in range(3))
    scale = 32 ** -0.25
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(flash_sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)), scale,
                                     block=128).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = pattn.attention_reference(tq, tk, tv, scale ** 2).float().numpy()
    tq.requires_grad_(True)
    fn = pattn.flash_attention(tq, tk, tv, scale ** 2).float().detach().numpy()
    np.testing.assert_array_equal(fn, got)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:   # one bf16 ulp of P and of the output on either side
        assert np.all(np.abs(got - want) <= 2 ** -7 * (np.abs(want) + 1))
    assert 32 in pattn.HEAD_DIMS and 32 in pattn.BWD_HEAD_DIMS
    assert pattn.launch_counter("flash_attention", 32) == "flash_attention_dh32"


# ---- what the JAX package does with these options, mirrored (ROADMAP §3) ----

def test_spatial_transformer_attends_over_its_own_tokens():
    """stedm_tpu unet.py:217, 253, 275 call the spatial transformer without
    the context: attn2's keys and values come from the tokens (inner x
    inner kernels, not 512 x inner), so the style reaches the U-Net only
    through ResBlockStyle. The port builds and calls it the same way."""
    jm, params, pm, args = _unet_pair(OPTION_SETS["spatial_transformer"])
    inner = 2 * 16
    assert params["middle_block_2"]["block_0"]["attn2"]["to_k"]["kernel"].shape == (64, 64)
    assert params["input_blocks_3_1"]["block_0"]["attn2"]["to_v"]["kernel"].shape == \
        (inner * 2, inner * 2)
    assert pm.middle_block[2].block_0.attn2.to_k.in_features == 64


def _dropout_step_models():
    unet = {**BASE, "dropout": 0.1}
    kw = dict(unet_config=unet, first_stage_config=CODEC, cond_stage_config=COND,
              style_sampling="none", patch_size=32)
    jm = JSTEDM(**kw)
    b = 2
    r = np.random.default_rng(13)
    seg = np.zeros((b, 32, 32, 2), np.float32)
    seg[..., 0] = 1.0
    batch = {"image": r.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
             "segmentation": seg,
             "style_imgs": r.uniform(-1, 1, (b, 1, 32, 32, 3)).astype(np.float32)}
    params = random_params(jm, 14, jnp.zeros((b, 32, 32, 3)), jnp.asarray(seg),
                           jnp.asarray(batch["style_imgs"]), jnp.zeros((b,), jnp.int32))
    pm = load(STEDM(**kw), weights.state_dict_from_jax(params))
    return jm, params, pm, batch


def test_jax_step_cannot_draw_unet_dropout_and_the_port_does():
    """A U-Net dropout above 0: JAX's train step applies ``model.eps(...,
    train=True)`` without a 'dropout' rng (stedm_tpu/train/steps.py:117-119),
    which flax refuses. The port draws the ResBlocks' masks from the step's
    generator; at fixed t and noise the loss follows the seed, and an eval
    forward draws nothing."""
    jm, params, pm, batch = _dropout_step_models()
    sched = ("linear", 1000, 0.0015, 0.0205)
    jtx = joptim.make_optimizer(1e-3)
    jstep = jsteps.make_train_step(jm, jsched.DiffusionSchedule.create(*sched), jtx)
    with pytest.raises(flax.errors.InvalidRngError, match="dropout"):
        jax.eval_shape(jstep, jsteps.create_train_state(params, jtx),
                       {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    pstep = psteps.make_train_step(pm, psched.DiffusionSchedule.create(*sched),
                                   poptim.make_optimizer(0.0), device="cpu")
    r = np.random.default_rng(15)
    t = torch.from_numpy(r.integers(0, 1000, (2,)))
    noise = torch.from_numpy(r.normal(size=(2, 8, 8, 3)).astype(np.float32))
    losses = []
    for seed in (0, 0, 1):
        state = psteps.create_train_state(pm, poptim.make_optimizer(0.0))
        _, m = pstep(state, batch, torch.Generator().manual_seed(seed), t=t, noise=noise)
        losses.append(float(m["loss"]))
        pm.zero_grad(set_to_none=True)
    assert np.isfinite(losses).all() and losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="generator"):
        pstep(psteps.create_train_state(pm, poptim.make_optimizer(0.0)), batch, None, t=t,
              noise=noise)
    z, seg, style = torch.zeros(2, 8, 8, 3), torch.zeros(2, 8, 8, 3), torch.zeros(2, 512)
    with torch.no_grad():
        assert torch.equal(pm.eps(z, t, seg, style), pm.eps(z, t, seg, style))


def test_codec_dropout_is_never_drawn():
    """The codec's ResnetBlocks apply dropout only in train mode, which no
    caller of the JAX codec passes (stedm_tpu vq.py:288, ``training_recon``
    -> ``encode``): at dropout 0.1 JAX's training forward equals its
    forward at 0, and the port's (which takes the key and draws nothing)
    equals both."""
    x = np.random.default_rng(16).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    dd = CODEC["ddconfig"]
    jm0 = jvq.VQModelInterface(embed_dim=3, n_embed=64, ddconfig=dd)
    jm1 = jvq.VQModelInterface(embed_dim=3, n_embed=64, ddconfig={**dd, "dropout": 0.1})
    params = random_params(jm0, 17, jnp.asarray(x))
    run = lambda m: quick_jit(lambda p, a: m.apply({"params": p}, a,
                                                   method=m.training_recon)[0])(params, x)
    want = np.asarray(run(jm1))
    np.testing.assert_array_equal(want, np.asarray(run(jm0)))
    pm = load(pvq.VQModelInterface(embed_dim=3, n_embed=64, ddconfig={**dd, "dropout": 0.1}),
              weights.vq_state_dict(params))
    with torch.no_grad():
        got = pm.training_recon(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_entry_points_take_the_options(tmp_path):
    """train_diff.main (2 micro-steps) and predict_diff.main on a tiny
    Flowers tree with the spatial transformer (32-wide heads), U-Net
    dropout 0.1, crossattn, the cosine schedule and ``+adamw_m_bf16``, then
    train_ae.main with codec dropout 0.1: finite losses, a bf16 first moment
    in the checkpoint, every pair written (chip_smoke.py phase 12d at the
    shipped widths)."""
    from _flowers_helpers import run_overrides, write_flowers_tree, write_preview_fixture

    from stedm_tpu_torch import predict_diff, train_ae, train_diff
    from stedm_tpu_torch.train import checkpoints

    data = write_flowers_tree(tmp_path / "data")
    write_preview_fixture(data)
    unet = "diffusion.unet_config.params."
    options = [unet + "use_spatial_transformer=true", "+" + unet + "num_head_channels=32",
               unet + "dropout=0.1", "diffusion.conditioning_key=crossattn",
               "diffusion.beta_schedule=cosine", "+adamw_m_bf16=true"]
    args = run_overrides(data, tmp_path / "results") + options
    out = train_diff.main(args + ["+preview_ddim_steps=4", "accumulate_grad_batches=1"],
                          device="cpu")
    assert out["step"] == 2 and np.isfinite(out["epochs"][0]["loss"])
    saved = checkpoints.load(checkpoints.checkpoint_file(
        f"{out['run_dir']}/ckpt", f"{Path(out['run_dir']).name}_last"))
    assert {v["exp_avg"].dtype for v in saved["opt"]["adamw"]["state"].values()} == \
        {torch.bfloat16}
    pred = predict_diff.main(args + ["data.samples=1", "ddim_steps=4", "cfg_scale=1.5",
                                     "+predict_name=options"], device="cpu")
    assert len(list(Path(pred["predict_dir"]).rglob("*.png"))) > 0
    ae = train_ae.main(run_overrides(data, tmp_path / "ae") + [
        "diffusion.first_stage_config.params.ddconfig.dropout=0.1", "loss.disc_start=0"],
        device="cpu")
    assert all(np.isfinite(v) for v in ae["epochs"][0]["train"].values())
