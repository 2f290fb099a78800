"""Codec fine-tuning's loss pieces, the port against the JAX package: the
PatchGAN discriminator (train mode: logits and the running statistics as
flax updates them), LPIPS with seeded random weights, the GAN and
reconstruction losses, the adaptive weight, perplexity and the KL
posterior. Weights travel through the port's weight bridge; inputs are
numpy arrays from a seed; fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_helpers import ATOL, RTOL, random_params

from stedm_tpu.models import autoencoder_kl as jkl
from stedm_tpu.models.discriminator import NLayerDiscriminator as JDisc
from stedm_tpu.models.lpips import LPIPS as JLPIPS
from stedm_tpu.train import vae_losses as JL
from stedm_tpu_torch.models import autoencoder_kl as pkl
from stedm_tpu_torch.models.discriminator import NLayerDiscriminator
from stedm_tpu_torch.models.lpips import LPIPS
from stedm_tpu_torch.train import vae_losses as PL
from stedm_tpu_torch.utils import weights


def _images(seed, n=2, p=32):
    return np.random.default_rng(seed).uniform(-1, 1, (n, p, p, 3)).astype(np.float32)


@pytest.mark.parametrize("use_actnorm", [False, True], ids=["batchnorm", "actnorm"])
def test_discriminator_train_mode_matches_flax(use_actnorm):
    """Logits with batch statistics, and the running statistics threaded
    through a real and a fake call as flax's BatchNorm(momentum=0.9) updates
    them (biased batch variance); the module's buffers stay as they were."""
    real, fake = _images(0), _images(1)
    jd = JDisc(ndf=16, n_layers=2, use_actnorm=use_actnorm)
    variables = jd.init(jax.random.PRNGKey(0), jnp.asarray(real))
    params = random_params(jd, 2, jnp.asarray(real))
    r = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(
        lambda a: r.uniform(0.5, 1.5, a.shape).astype(np.float32),
        dict(variables.get("batch_stats", {})))

    def jrun(p, st):
        lr, mut = jd.apply({"params": p, "batch_stats": st}, jnp.asarray(real), train=True,
                           mutable=["batch_stats"])
        lf, mut = jd.apply({"params": p, "batch_stats": mut["batch_stats"]}, jnp.asarray(fake),
                           train=True, mutable=["batch_stats"])
        return lr, lf, mut["batch_stats"]

    lr, lf, new = jax.jit(jrun)(params, stats)
    pd = NLayerDiscriminator(ndf=16, n_layers=2, use_actnorm=use_actnorm)
    pd.load_state_dict(weights.discriminator_state_dict(params, stats), strict=True)
    before = {k: v.clone() for k, v in pd.state_dict().items()}
    got_r, st = pd(torch.from_numpy(real))
    got_f, st = pd(torch.from_numpy(fake), st)
    assert got_r.shape == (2, 6, 6, 1)
    np.testing.assert_allclose(got_r.detach().numpy(), np.asarray(lr), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_f.detach().numpy(), np.asarray(lf), rtol=RTOL, atol=ATOL)
    assert all(torch.equal(v, pd.state_dict()[k]) for k, v in before.items())
    pd.set_running_stats(st)
    want = weights.discriminator_state_dict(params, jax.tree_util.tree_map(np.asarray, new))
    for k, v in pd.state_dict().items():
        if "running" in k:
            # the batch moments in another order (E[x^2] - E[x]^2 on both sides)
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6)
    assert len(st) == (0 if use_actnorm else 2)


@pytest.fixture(scope="module")
def lpips_pair():
    x, y = _images(4), _images(5)
    jm = JLPIPS()
    params = random_params(jm, 6, jnp.asarray(x), jnp.asarray(y))
    pm = LPIPS()
    pm.load_state_dict(weights.lpips_state_dict(params), strict=True)
    return jm, params, pm, x, y


def test_lpips_matches_jax(lpips_pair):
    """The distance and its gradient with respect to the second image (the
    reconstruction's path in the generator loss); the trunk is frozen."""
    jm, params, pm, x, y = lpips_pair
    val, grad = jax.jit(jax.value_and_grad(
        lambda b: jnp.sum(jm.apply({"params": params}, jnp.asarray(x), b))))(jnp.asarray(y))
    want = jax.jit(lambda a, b: jm.apply({"params": params}, a, b))(jnp.asarray(x), jnp.asarray(y))
    ty = torch.from_numpy(y).requires_grad_()
    got = pm(torch.from_numpy(x), ty)
    assert got.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    got.sum().backward()
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(grad), rtol=RTOL, atol=1e-5)
    assert all(p.grad is None and not p.requires_grad for p in pm.parameters())


def test_lpips_state_dict_has_taming_names(lpips_pair):
    # taming's LPIPS: the scaling layer's buffers, torchvision's VGG16
    # ``features`` indices under five slices, and the five 1x1 heads
    pm = lpips_pair[2]
    convs = {1: (0, 2), 2: (5, 7), 3: (10, 12, 14), 4: (17, 19, 21), 5: (24, 26, 28)}
    want = {"scaling_layer.shift", "scaling_layer.scale"}
    want |= {f"net.slice{n}.{i}.{w}" for n, idx in convs.items() for i in idx
             for w in ("weight", "bias")}
    want |= {f"lin{k}.model.1.weight" for k in range(5)}
    assert set(pm.state_dict()) == want
    pm.load_state_dict({k: v.clone() for k, v in pm.state_dict().items()}, strict=True)


@pytest.mark.parametrize("kind", ["hinge", "vanilla"])
def test_gan_losses_match_jax(kind):
    r = np.random.default_rng(7)
    real, fake = (r.normal(size=(2, 6, 6, 1)).astype(np.float32) for _ in range(2))
    jfn = JL.VAELossConfig(disc_loss=kind).d_loss()
    pfn = PL.VAELossConfig(disc_loss=kind).d_loss()
    np.testing.assert_allclose(float(pfn(torch.from_numpy(real), torch.from_numpy(fake))),
                               float(jfn(jnp.asarray(real), jnp.asarray(fake))), rtol=1e-6)


def test_adopt_weight_and_perplexity_match_jax():
    for step in (0, 4, 5, 9):
        assert np.float32(PL.adopt_weight(0.7, step, threshold=5)) == JL.adopt_weight(0.7, step, 5)
    idx = np.random.default_rng(8).integers(0, 40, (2, 8, 8)).astype(np.int32)
    jp, ju = JL.measure_perplexity(jnp.asarray(idx), 64)
    pp, pu = PL.measure_perplexity(torch.from_numpy(idx).long(), 64)
    np.testing.assert_allclose(float(pp), float(jp), rtol=1e-6)
    assert int(pu) == int(ju)


@pytest.mark.parametrize("pixel_loss,perceptual", [("l1", 0.0), ("l2", 0.0), ("l1", 0.8)])
def test_nll_terms_match_jax(lpips_pair, pixel_loss, perceptual):
    jm, params, pm, x, y = lpips_pair
    jcfg = JL.VAELossConfig(pixel_loss=pixel_loss, perceptual_weight=perceptual,
                            pixelloss_weight=1.3)
    pcfg = PL.VAELossConfig(pixel_loss=pixel_loss, perceptual_weight=perceptual,
                            pixelloss_weight=1.3)
    japply = lambda a, b: jm.apply({"params": params}, a, b)   # noqa: E731
    rec, p = JL.nll_terms(jcfg, japply, jnp.asarray(x), jnp.asarray(y))
    got_rec, got_p = PL.nll_terms(pcfg, pm, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got_rec.detach().numpy(), np.asarray(rec), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(p), rtol=RTOL, atol=ATOL)


def test_adaptive_weight_matches_jax():
    r = np.random.default_rng(9)
    a, b = r.normal(size=(3, 3, 8, 3)).astype(np.float32), r.normal(size=(3, 3, 8, 3)) * 1e-3
    jcfg, pcfg = JL.VAELossConfig(disc_weight=0.75), PL.VAELossConfig(disc_weight=0.75)
    want = JL.adaptive_weight(jcfg, jnp.asarray(a), jnp.asarray(b, jnp.float32))
    # the norm does not depend on the layout: HWIO against OIHW
    got = PL.adaptive_weight(pcfg, torch.from_numpy(a).permute(3, 2, 0, 1),
                             torch.from_numpy(b.astype(np.float32)).permute(3, 2, 0, 1))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(PL.adaptive_weight(pcfg, torch.ones(4) * 1e9, torch.zeros(4))) == 1e4 * 0.75


def test_diagonal_gaussian_matches_jax():
    r = np.random.default_rng(10)
    moments = r.normal(size=(2, 4, 4, 6)).astype(np.float32) * 3   # some log-variances clipped
    other = r.normal(size=(2, 4, 4, 6)).astype(np.float32)
    sample = r.normal(size=(2, 4, 4, 3)).astype(np.float32)
    jd, jo = jkl.DiagonalGaussian(jnp.asarray(moments)), jkl.DiagonalGaussian(jnp.asarray(other))
    pd, po = (pkl.DiagonalGaussian(torch.from_numpy(m)) for m in (moments, other))
    for got, want in ((pd.kl(), jd.kl()), (pd.kl(po), jd.kl(jo)),
                      (pd.nll(torch.from_numpy(sample)), jd.nll(jnp.asarray(sample)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(pd.sample(torch.from_numpy(sample)).numpy(),
                               np.asarray(jd.mean + jd.std * sample), rtol=1e-6, atol=1e-6)
