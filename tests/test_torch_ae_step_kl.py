"""Codec fine-tuning on a tiny KL codec, the port against the JAX package:
two steps of ``make_ae_train_step`` with ``variant="kl"`` on the same
weights and images as tests/test_torch_ae_step.py (no LPIPS here), the
trainable output log-variance, and the posterior noise that the JAX step
draws from ``fold_in(PRNGKey(seed), step)`` drawn the same way here and
handed to the port's step. fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _ae_helpers import check_logs, check_reconstruction, check_updates, run_steps

from stedm_tpu.train import ae_steps as jae
from stedm_tpu_torch.train import ae_steps as pae


@pytest.fixture(scope="module")
def run():
    return run_steps("kl", perceptual_weight=0.0)


def test_kl_step_logs_match_jax(run):
    check_logs(run)
    assert [log["train/logvar"] for log in run["plogs"]][0] == 0.0


def test_kl_step_reconstructions_and_logvar_match_jax(run):
    for jrec, prec in zip(run["jrecs"], run["precs"]):
        check_reconstruction(prec, jrec, run["rec0"])
    np.testing.assert_allclose(float(run["p_logvar"].detach()), run["j_logvar"], rtol=1e-5)


def test_kl_step_updates_match_jax(run):
    check_updates(run)


def test_kl_eval_step_matches_jax(run):
    """The eval step's fixed posterior draw: the JAX step's PRNGKey(0),
    handed over as ``noise``."""
    jfn = jax.jit(jae.make_ae_eval_step(run["jm"], run["jcfg"], variant="kl"))
    want, jrec = jfn(run["jstate"].gen_params, jnp.asarray(run["img"]), {})
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), run["pm"].latent_shape((2, 32, 32, 3))))
    got, prec = pae.make_ae_eval_step(run["pm"], run["pcfg"], variant="kl", device="cpu")(
        torch.from_numpy(run["img"]), noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, err_msg=k)
    check_reconstruction(prec.numpy(), np.asarray(jrec), run["rec0"])
