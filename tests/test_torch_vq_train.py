"""The codec's training side, the port against the JAX package: the vector
quantizer's straight-through gradient and taming codebook loss, the VQ and
KL codecs' training forwards, and the ``ddconfig`` keys they take.

Weights are seeded random values in the JAX trees carried by the port's
weight bridge; inputs are numpy arrays from a seed. fp32 on the CPU,
tolerance rtol 1e-3 / atol 2e-4 (tests/_port_helpers.py) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_helpers import ATOL, RTOL, random_params

from stedm_tpu.models import autoencoder_kl as jkl
from stedm_tpu.models import vq as jvq
from stedm_tpu_torch.models import autoencoder_kl as pkl
from stedm_tpu_torch.models import vq as pvq
from stedm_tpu_torch.utils import weights

DD = dict(double_z=False, z_channels=3, resolution=32, in_channels=3, out_ch=3, ch=32,
          ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0)


def _quantizer(seed=0, n_embed=16, dim=4):
    r = np.random.default_rng(seed)
    z = r.normal(size=(2, 4, 4, dim)).astype(np.float32)
    cb = r.normal(size=(n_embed, dim)).astype(np.float32)
    pq = pvq.VectorQuantizer(n_embed, dim)
    pq.embedding.weight.data = torch.from_numpy(cb.copy())
    return jvq.VectorQuantizer(n_embed=n_embed, embed_dim=dim), pq, z, cb


def test_quantizer_with_loss_matches_jax():
    jq, pq, z, cb = _quantizer()
    z_st, emb, idx = jq.apply({"params": {"embedding": jnp.asarray(cb)}}, jnp.asarray(z),
                              with_loss=True)
    got_st, got_emb, got_idx = pq(torch.from_numpy(z), with_loss=True)
    assert np.array_equal(got_idx.numpy(), np.asarray(idx)) and got_idx.shape == (2, 4, 4)
    # z + (z_q - z) in fp32 on both sides: the same operations
    np.testing.assert_allclose(got_st.detach().numpy(), np.asarray(z_st), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got_emb.detach()), float(emb), rtol=1e-6)
    assert torch.equal(pq(torch.from_numpy(z)), got_st)


def test_quantizer_gradients_match_jax_grad():
    """The straight-through estimator: d(out.sum())/dz is all ones and the
    codebook gets no gradient from it (the repaired stop-gradient); the
    codebook loss's gradients reach both z and the codebook."""
    jq, pq, z, cb = _quantizer(1)
    w = np.random.default_rng(2).normal(size=z.shape).astype(np.float32)

    def jloss(zz, c, which):
        out, emb, _ = jq.apply({"params": {"embedding": c}}, zz, with_loss=True)
        return out.sum() if which == "sum" else jnp.sum(out * w) + 3.0 * emb

    for which in ("sum", "weighted"):
        dz, dcb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(cb), which)
        tz = torch.from_numpy(z).requires_grad_()
        pq.embedding.weight.grad = None
        out, emb, _ = pq(tz, with_loss=True)
        (out.sum() if which == "sum" else (out * torch.from_numpy(w)).sum() + 3.0 * emb).backward()
        got_cb = pq.embedding.weight.grad
        got_cb = torch.zeros_like(pq.embedding.weight) if got_cb is None else got_cb
        if which == "sum":
            assert torch.equal(tz.grad, torch.ones_like(tz))
            assert not got_cb.any()
        np.testing.assert_allclose(tz.grad.numpy(), np.asarray(dz), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_cb.numpy(), np.asarray(dcb), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def vq_codec():
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jm = jvq.VQModelInterface(embed_dim=3, n_embed=64, ddconfig=DD)
    params = random_params(jm, 4, jnp.asarray(x))
    pm = pvq.VQModelInterface(embed_dim=3, n_embed=64, ddconfig=DD)
    pm.load_state_dict(weights.codec_state_dict(params), strict=True)
    return jm, params, pm, x


def test_vq_training_recon_matches_jax(vq_codec):
    jm, params, pm, x = vq_codec
    rec, emb, idx = jax.jit(lambda p, a: jm.apply({"params": p}, a, method=jm.training_recon))(
        params, jnp.asarray(x))
    got_rec, got_emb, got_idx = pm.training_recon(torch.from_numpy(x))
    assert np.array_equal(got_idx.numpy(), np.asarray(idx)) and got_idx.shape == (2, 16, 16)
    np.testing.assert_allclose(got_rec.detach().numpy(), np.asarray(rec), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got_emb.detach()), float(emb), rtol=RTOL)


def test_kl_training_recon_matches_jax():
    x = np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    dd = dict(DD, double_z=True)
    jm = jkl.AutoencoderKL(embed_dim=3, ddconfig=dd)
    params = random_params(jm, 6, jnp.asarray(x))
    pm = pkl.AutoencoderKL(embed_dim=3, ddconfig=dd)
    pm.load_state_dict(weights.codec_state_dict(params), strict=True)
    key = jax.random.PRNGKey(7)
    # the posterior noise as the JAX module draws it from its key
    noise = np.array(jax.random.normal(key, (2, 16, 16, 3)))
    assert pm.latent_shape(x.shape) == noise.shape

    def jfwd(p, a):
        rec, post = jm.apply({"params": p}, a, key, method=jm.training_recon)
        return rec, post.kl(), post.mean

    rec, kl, mean = jax.jit(jfwd)(params, jnp.asarray(x))
    got_rec, post = pm.training_recon(torch.from_numpy(x), torch.from_numpy(noise))
    np.testing.assert_allclose(post.mean.detach().numpy(), np.asarray(mean), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(post.kl().detach().numpy(), np.asarray(kl), rtol=RTOL)
    np.testing.assert_allclose(got_rec.detach().numpy(), np.asarray(rec), rtol=RTOL, atol=ATOL)


# err None: once refused, now built (a dropout the JAX codec never draws,
# tests/test_torch_model_options.py::test_codec_dropout_is_never_drawn)
@pytest.mark.parametrize("cls,dd,err", [
    (pvq.VQModelInterface, dict(DD, dropout=0.1), None),
    (pkl.AutoencoderKL, dict(DD, double_z=True, dropout=0.5), None),
    (pvq.VQModelInterface, dict(DD, double_z=True), ValueError),
    (pkl.AutoencoderKL, dict(DD), ValueError),
    (pvq.VQModelInterface, dict(DD, give_pre_end=True), ValueError),
])
def test_codecs_refuse_what_they_do_not_take(cls, dd, err):
    if err is None:
        assert cls(embed_dim=3, ddconfig=dd).encoder is not None
        return
    with pytest.raises(err):
        cls(embed_dim=3, ddconfig=dd)


def test_codecs_take_the_shipped_ddconfig_values():
    assert pvq.VQModelInterface(embed_dim=3, n_embed=8, ddconfig=DD).encoder.conv_out.out_channels == 3
    kl = pkl.AutoencoderKL(embed_dim=3, ddconfig=dict(DD, double_z=True))
    assert kl.encoder.conv_out.out_channels == 6 and kl.quant_conv.out_channels == 6
