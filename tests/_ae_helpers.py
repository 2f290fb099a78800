"""Two codec fine-tuning steps through the JAX package and through the
port, on the same weights (carried by the port's weight bridge), images
and, for the KL codec, posterior noise; shared by the step tests."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _port_helpers import random_params

from stedm_tpu.models import autoencoder_kl as jkl
from stedm_tpu.models import vq as jvq
from stedm_tpu.models.lpips import LPIPS as JLPIPS
from stedm_tpu.train import ae_steps as jae
from stedm_tpu.train import vae_losses as JL
from stedm_tpu_torch.models import autoencoder_kl as pkl
from stedm_tpu_torch.models import vq as pvq
from stedm_tpu_torch.models.lpips import LPIPS
from stedm_tpu_torch.train import ae_steps as pae
from stedm_tpu_torch.train import vae_losses as PL
from stedm_tpu_torch.utils import weights

P, B, LR, SEED, STEPS = 32, 2, 1e-3, 0, 2
DD = dict(z_channels=3, resolution=P, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
          num_res_blocks=1, attn_resolutions=[], dropout=0.0)
# the tiny codec's GAN: disc_start 1, so step 0 runs without the GAN terms
# and step 1 with them
LOSS = dict(disc_start=1, disc_weight=0.5, disc_ndf=16, disc_num_layers=2, kl_weight=1e-4)
# a small step: XLA's backend optimisation would add more compile time than
# it saves
_QUICK_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


def run_steps(variant: str, perceptual_weight: float, ddconfig: dict | None = None,
              steps: int = STEPS, patch: int = P) -> dict:
    """``steps`` steps of both packages' codec fine-tuning on the tiny codec
    (``ddconfig``, default ``DD``) at ``patch``, from the same weights
    (``gen0``: the JAX tree)."""
    dd = DD if ddconfig is None else ddconfig
    img = np.random.default_rng(11).uniform(-1, 1, (B, patch, patch, 3)).astype(np.float32)
    jcfg = JL.VAELossConfig(perceptual_weight=perceptual_weight, **LOSS)
    pcfg = PL.VAELossConfig(perceptual_weight=perceptual_weight, **LOSS)
    if variant == "vq":
        jm = jvq.VQModelInterface(embed_dim=3, n_embed=64, ddconfig=dict(dd, double_z=False))
        pm = pvq.VQModelInterface(embed_dim=3, n_embed=64, ddconfig=dict(dd, double_z=False))
    else:
        jm = jkl.AutoencoderKL(embed_dim=3, ddconfig=dict(dd, double_z=True))
        pm = pkl.AutoencoderKL(embed_dim=3, ddconfig=dict(dd, double_z=True))
    gen = dict(random_params(jm, 1, jnp.asarray(img)))
    if variant == "kl":
        gen["lossvar"] = {"logvar": jnp.zeros((), jnp.float32)}
    jd = JL.build_discriminator(jcfg)
    dvars = jax.jit(jd.init)(jax.random.PRNGKey(2), jnp.asarray(img))
    jlp, lparams = None, {}
    pl = None
    if perceptual_weight:
        jlp = JLPIPS()
        lparams = random_params(jlp, 3, jnp.asarray(img), jnp.asarray(img))
        pl = LPIPS()
        pl.load_state_dict(weights.lpips_state_dict(lparams), strict=True)

    gen_tx, disc_tx = jae.ae_optimizers(LR)
    jstate = jax.jit(lambda g, d: jae.create_ae_state(g, d, gen_tx, disc_tx))(gen, dvars)
    jstep = jax.jit(jae.make_ae_train_step(jm, jcfg, gen_tx, disc_tx, lpips=jlp, variant=variant,
                                           seed=SEED)).lower(
        jstate, jnp.asarray(img), lparams).compile(compiler_options=_QUICK_COMPILE)
    jlogs, jrecs = [], []
    for _ in range(steps):
        jstate, log, rec = jstep(jstate, jnp.asarray(img), lparams)
        jlogs.append({k: float(v) for k, v in log.items()})
        jrecs.append(np.asarray(rec))

    pm.load_state_dict(weights.codec_state_dict(gen), strict=True)
    pd = PL.build_discriminator(pcfg)
    pd.load_state_dict(weights.discriminator_state_dict(dvars["params"], dvars["batch_stats"]),
                       strict=True)
    logvar = pae.init_lossvar(0.0, device="cpu") if variant == "kl" else None
    p_before = {k: v.clone() for k, v in pm.state_dict().items()}
    with torch.no_grad():     # the reconstruction before any update
        rec0 = pm.training_recon(torch.from_numpy(img), *(
            [torch.zeros(pm.latent_shape(img.shape))] if variant == "kl" else []))[0].numpy()
    d_before = {k: v.clone() for k, v in pd.state_dict().items()}
    ptx, pdtx = pae.ae_optimizers(LR)
    pstate = pae.create_ae_state(pm, pd, ptx, pdtx, logvar=logvar)
    pstep = pae.make_ae_train_step(pm, pcfg, lpips=pl, variant=variant, seed=SEED, device="cpu")
    plogs, precs = [], []
    for i in range(steps):
        noise = None
        if variant == "kl":   # as the JAX step draws it (ae_steps.py:112)
            key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
            noise = torch.from_numpy(np.array(jax.random.normal(key, pm.latent_shape(img.shape))))
        pstate, log, rec = pstep(pstate, torch.from_numpy(img), noise=noise)
        plogs.append({k: float(v) for k, v in log.items()})
        precs.append(rec.numpy())
    return dict(
        jlogs=jlogs, plogs=plogs, jrecs=jrecs, precs=precs, rec0=rec0,
        j_gen=weights.codec_state_dict(_np_tree(jstate.gen_params)),
        j_disc=weights.discriminator_state_dict(_np_tree(jstate.disc_params),
                                                _np_tree(jstate.disc_stats)),
        j_logvar=(float(jstate.gen_params["lossvar"]["logvar"]) if variant == "kl" else None),
        p_gen=pm.state_dict(), p_disc=pd.state_dict(), p_logvar=logvar, p_before=p_before,
        d_before=d_before, pstate=pstate, pm=pm, pd=pd, img=img, jstate=jstate,
        jm=jm, jcfg=jcfg, pcfg=pcfg, jlp=jlp, lparams=lparams, pl=pl, gen0=gen)


def check_logs(run):
    """Every log value of both steps: fp32 sums in other orders through the
    codec, LPIPS and the discriminator (relative differences of 1e-5 were
    seen), within 1e-4."""
    for jlog, plog in zip(run["jlogs"], run["plogs"]):
        assert set(jlog) == set(plog)
        for k in jlog:
            np.testing.assert_allclose(plog[k], jlog[k], rtol=1e-4, atol=1e-6, err_msg=k)


def check_updates(run, discriminator: bool = True):
    """The generator's and the discriminator's updates over both steps.
    Adam's first steps are about lr * sign(g), so an element whose gradient
    is within rounding of zero (the key bias of the attention, which the
    softmax ignores, and convolution biases that a GroupNorm of one channel
    a group removes) steps either way on either side: the updates agree as
    a whole to 10 % in norm (each flipped element costs twice its step, so
    that is at most a quarter of a percent of them flipped), every element
    within two steps; the running statistics agree to fp32 rounding.
    ``discriminator`` False: the generator's only (a run that stops before
    the discriminator first moves)."""
    pairs = [(run["j_gen"], run["p_gen"], run["p_before"])]
    if discriminator:
        pairs.append((run["j_disc"], run["p_disc"], run["d_before"]))
    for want, got, before in pairs:
        keys = [k for k in got if "running" not in k
                and not k.endswith(("num_batches_tracked", "initialized"))]
        dj = torch.cat([(want[k].float() - before[k].float()).flatten() for k in keys])
        dp = torch.cat([(got[k].float() - before[k].float()).flatten() for k in keys])
        assert float(dj.norm()) > 0
        assert float((dp - dj).norm() / dj.norm()) <= 0.1
        assert float((dp - dj).abs().max()) <= 2 * LR * 2
        for k in got:
            if "running" in k:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6)


def check_reconstruction(got, want, rec0):
    """A reconstruction by updated parameters: its change from the first
    reconstruction agrees to 10 % in norm, as the updates do
    (``check_updates``), and every element to 1e-3 (a flipped step of lr
    moves an output by about that much)."""
    assert got.shape == want.shape
    dw, dg = want - rec0, got - rec0
    assert np.linalg.norm(dw) > 0
    assert np.linalg.norm(dg - dw) / np.linalg.norm(dw) <= 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
