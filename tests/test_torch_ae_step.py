"""Codec fine-tuning on a tiny VQ codec, the port against the JAX package.

Two steps of ``make_ae_train_step`` (generator, then discriminator, on the
same batch) through the jitted JAX step and through the port's, on the same
codec, discriminator and LPIPS weights (seeded random, carried by the
port's weight bridge) and the same images: patch 32, ch 32, an 8x8 codebook
of 64 codes, ``disc_ndf`` 16, ``disc_num_layers`` 2, ``disc_start`` 1 (step
0 without the GAN terms, step 1 with them), LPIPS at weight 0.7, Adam lr
1e-3. fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _ae_helpers import LR, check_logs, check_reconstruction, check_updates, run_steps

from stedm_tpu.train import ae_steps as jae
from stedm_tpu_torch.train import ae_steps as pae


@pytest.fixture(scope="module")
def run():
    return run_steps("vq", perceptual_weight=0.7)


def test_step_logs_match_jax(run):
    check_logs(run)
    assert [log["train/disc_factor"] for log in run["plogs"]] == [0.0, 1.0]


def test_step_reconstructions_match_jax(run):
    """The discriminator step's reconstruction, by the updated generator."""
    for jrec, prec in zip(run["jrecs"], run["precs"]):
        assert prec.shape == (2, 32, 32, 3)
        check_reconstruction(prec, jrec, run["rec0"])


def test_step_updates_match_jax(run):
    check_updates(run)


def test_discriminator_still_before_disc_start():
    """At step 0 (before ``disc_start``) the discriminator's loss is zero and
    Adam leaves its parameters exactly where they were; the generator step
    leaves no gradient on the discriminator or on LPIPS."""
    from stedm_tpu_torch.models.vq import VQModelInterface
    from stedm_tpu_torch.train.vae_losses import VAELossConfig, build_discriminator
    from _ae_helpers import DD, LOSS

    torch.manual_seed(0)
    cfg = VAELossConfig(perceptual_weight=0.0, **LOSS)
    model = VQModelInterface(embed_dim=3, n_embed=64, ddconfig=dict(DD, double_z=False))
    disc = build_discriminator(cfg)
    state = pae.create_ae_state(model, disc, *pae.ae_optimizers(LR))
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    gen_before = [p.detach().clone() for p in model.parameters()]
    step = pae.make_ae_train_step(model, cfg, device="cpu")
    state, log, _ = step(state, torch.rand(2, 32, 32, 3) * 2 - 1)
    assert float(log["train/disc_loss"]) == 0.0 and state.step == 1
    for k, v in disc.state_dict().items():
        if "running" not in k:
            assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in disc.parameters())
    assert any(not torch.equal(a, p) for a, p in zip(gen_before, model.parameters()))


def test_eval_step_matches_jax(run):
    jfn = jax.jit(jae.make_ae_eval_step(run["jm"], run["jcfg"], lpips=run["jlp"]))
    want, jrec = jfn(run["jstate"].gen_params, jnp.asarray(run["img"]), run["lparams"])
    got, prec = pae.make_ae_eval_step(run["pm"], run["pcfg"], lpips=run["pl"], device="cpu")(
        torch.from_numpy(run["img"]))
    assert set(got) == set(want)
    # evaluated on parameters whose updates differ as test_step_updates_match_jax allows
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, err_msg=k)
    check_reconstruction(prec.numpy(), np.asarray(jrec), run["rec0"])
