"""The codec fine-tuning step (stedm_tpu/train/ae_steps.py): a generator
update, then a discriminator update on the same batch.

``make_ae_train_step`` returns ``train_step(state, img, *, noise=None) ->
(state, log, rec)``:

* generator: the codec's training forward (VQ: encode, quantize with the
  codebook loss, decode; KL: encode, sample the posterior, decode), the
  reconstruction, perceptual and GAN terms (the discriminator in train mode,
  batch statistics, its running-statistics update discarded), the adaptive
  GAN weight, and Adam on the codec (and, for KL, the output log-variance).
  The gradient is taken with respect to the generator's tensors only, so
  nothing lands on the discriminator;
* discriminator: the codec's training forward again with the updated
  parameters, without gradient (as ae_steps.py:148 runs it: the
  reconstruction is not the generator step's), the hinge / vanilla loss on
  real then fake (the running statistics threaded through both calls, as
  flax does) and Adam on the discriminator.

The state lives in the modules and in ``AEState``, updated in place. Both
optimizers are Adam(lr, 0.5, 0.9), eps 1e-8, as ``optax.adam``. The KL step
takes its posterior noise as ``noise=`` (standard normal, the latent's
shape), reused by the discriminator's re-run; without it a generator seeded
from ``seed`` and the step counter draws it (other bits than the JAX
package's ``fold_in(PRNGKey(seed), step)``).

Across ranks (parallel/dist.py) each rank takes its rows of the global
batch's posterior noise, the gradients of both updates and those that set
the adaptive GAN weight are averaged over ranks, and the PatchGAN's
BatchNorm normalises over the global batch, so the step is the one-process
step on the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from stedm_tpu_torch._device import resolve_device
from stedm_tpu_torch.parallel import dist
from stedm_tpu_torch.train.vae_losses import (
    VAELossConfig,
    discriminator_loss,
    kl_generator_loss,
    measure_perplexity,
    nll_terms,
    vq_generator_loss,
)


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr, b1, b2)`` as a ``torch.optim.Adam`` factory."""

    lr: float
    b1: float = 0.5
    b2: float = 0.9
    eps: float = 1e-8

    def init(self, params: list[torch.nn.Parameter]) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps)


def ae_optimizers(lr: float) -> tuple[Adam, Adam]:
    """Adam betas (0.5, 0.9) for the generator and the discriminator."""
    return Adam(lr), Adam(lr)


def init_lossvar(logvar_init: float = 0.0, device=None) -> torch.nn.Parameter:
    """The KL variant's trainable output log-variance (0-dim); the JAX
    package carries it as ``gen_params['lossvar']['logvar']``."""
    return torch.nn.Parameter(torch.full((), float(logvar_init), dtype=torch.float32,
                                         device=resolve_device(device)))


@dataclasses.dataclass
class AEState:
    """Both adversaries (their parameters and the discriminator's running
    statistics live in the modules), their optimizers and the step counter."""

    model: torch.nn.Module
    disc: torch.nn.Module
    gen_params: list[torch.nn.Parameter]
    gen_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam
    logvar: torch.nn.Parameter | None = None
    step: int = 0


def create_ae_state(model, disc, gen_tx: Adam, disc_tx: Adam,
                    logvar: torch.nn.Parameter | None = None) -> AEState:
    """Adam over the codec (plus ``logvar`` for KL) and over the
    discriminator; every one of their tensors is made trainable."""
    gen_params = list(model.parameters()) + ([logvar] if logvar is not None else [])
    disc_params = list(disc.parameters())
    for p in gen_params + disc_params:
        p.requires_grad_(True)
    return AEState(model=model, disc=disc, gen_params=gen_params,
                   gen_opt=gen_tx.init(gen_params), disc_opt=disc_tx.init(disc_params),
                   logvar=logvar)


def _apply(opt: torch.optim.Optimizer, params, loss) -> None:
    """One optimizer step on ``d loss / d params`` (a tensor the loss does not
    reach gets a zero gradient, as in optax, so Adam still decays its
    moments)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    dist.all_reduce_mean_([p.grad for p in params])   # across ranks: the global mean
    opt.step()
    opt.zero_grad(set_to_none=True)


def _check(cfg: VAELossConfig, variant: str) -> None:
    if cfg.disc_conditional:
        raise NotImplementedError("disc_conditional is not supported")
    if variant not in ("vq", "kl"):
        raise ValueError(f"Unknown codec variant {variant!r}")


def make_ae_train_step(model, cfg: VAELossConfig, lpips=None, variant: str = "vq",
                       seed: int = 0, device=None) -> Callable:
    """The combined generator + discriminator step over NHWC images in
    [-1, 1]; ``lpips`` is the LPIPS module or None (perceptual term off)."""
    _check(cfg, variant)
    dev = resolve_device(device)

    def train_step(state: AEState, img: torch.Tensor, *, noise: torch.Tensor | None = None):
        img = torch.as_tensor(img).to(dev, torch.float32)
        step, disc = state.step, state.disc
        stats = disc.running_stats()
        last = state.model.decoder.conv_out.weight

        def disc_in_gen_step(rec):          # batch statistics; their update is discarded
            return disc(rec, stats)[0]

        if variant == "vq":
            def forward():
                return state.model.training_recon(img)

            loss_fn = vq_generator_loss(cfg, forward=forward, disc_apply=disc_in_gen_step,
                                        lpips=lpips, last_layer=last)
        else:
            if noise is None:
                gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + step)
                noise = dist.rank_rows(torch.randn, state.model.latent_shape(img.shape),
                                       generator=gen, device=dev)
            noise = noise.to(dev, torch.float32)

            def forward():
                return state.model.training_recon(img, noise)

            loss_fn = kl_generator_loss(cfg, forward=forward, disc_apply=disc_in_gen_step,
                                        lpips=lpips, last_layer=last, logvar=state.logvar)
        g_total, g_log, idx, _ = loss_fn(img, step)
        _apply(state.gen_opt, state.gen_params, g_total)

        with torch.no_grad():
            rec = forward()[0]              # the updated generator's reconstruction
        d_loss_fn = discriminator_loss(cfg, disc_apply=lambda x, st: disc(x, st))
        d_total, d_log, stats = d_loss_fn(stats, img, rec, step)
        _apply(state.disc_opt, list(disc.parameters()), d_total)
        disc.set_running_stats(stats)

        log = {f"train/{k}": v.detach() for k, v in {**g_log, **d_log}.items()}
        if idx is not None:
            perplexity, cluster_use = measure_perplexity(idx, state.model.n_embed)
            log["train/perplexity"] = perplexity
            log["train/cluster_usage"] = cluster_use
        state.step += 1
        return state, log, rec

    return train_step


def make_ae_eval_step(model, cfg: VAELossConfig, lpips=None, variant: str = "vq",
                      device=None) -> Callable:
    """Validation metrics ``eval_step(img, *, noise=None) -> (metrics, rec)``
    without gradient or update. The KL posterior is sampled with a fixed
    draw (``noise``, else a generator seeded 0), so every epoch compares
    like with like."""
    _check(cfg, variant)
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(img: torch.Tensor, *, noise: torch.Tensor | None = None):
        img = torch.as_tensor(img).to(dev, torch.float32)
        if variant == "vq":
            rec, emb_loss, idx = model.training_recon(img)
            rec_loss, p_loss = nll_terms(cfg, lpips, img, rec)
            perplexity, cluster_use = measure_perplexity(idx, model.n_embed)
            return {"val/rec_loss": torch.mean(rec_loss), "val/quant_loss": torch.mean(emb_loss),
                    "val/p_loss": torch.mean(p_loss), "val/perplexity": perplexity,
                    "val/cluster_usage": cluster_use}, rec
        if noise is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            noise = torch.randn(model.latent_shape(img.shape), generator=gen, device=dev)
        rec, posterior = model.training_recon(img, noise.to(dev, torch.float32))
        rec_loss, p_loss = nll_terms(cfg, lpips, img, rec)
        kl = posterior.kl()
        return {"val/rec_loss": torch.mean(rec_loss), "val/kl_loss": torch.sum(kl) / kl.shape[0],
                "val/p_loss": torch.mean(p_loss)}, rec

    return eval_step
