"""Perceptual and adversarial losses of codec fine-tuning
(stedm_tpu/train/vae_losses.py): taming's ``VQLPIPSWithDiscriminator`` and
``LPIPSWithDiscriminator`` as functions of explicit modules and tensors.

Images are NHWC. ``adopt_weight`` is a plain Python choice on the step
counter (PyTorch runs eagerly: nothing recompiles at ``disc_start``). The
generator losses take the adaptive discriminator weight from the gradients
of the reconstruction term and of the GAN term with respect to the
decoder's last kernel only: one forward and two short ``autograd.grad``
pulls that keep the graph for the full backward of the total.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from stedm_tpu_torch.parallel import dist


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """``value`` before ``threshold`` steps, ``weight`` from then on."""
    return value if global_step < threshold else weight


def measure_perplexity(idx: torch.Tensor, n_embed: int):
    """Codebook perplexity and the number of codes used."""
    counts = torch.bincount(idx.reshape(-1), minlength=n_embed)
    avg_probs = counts.float() / idx.numel()
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
    return perplexity, torch.sum(avg_probs > 0)


@dataclasses.dataclass(frozen=True)
class VAELossConfig:
    """The union of the two loss constructors; ``kl_weight`` and
    ``logvar_init`` drive only the KL variant, ``codebook_weight`` only VQ."""

    disc_start: int = 0
    codebook_weight: float = 1.0
    pixelloss_weight: float = 1.0
    disc_num_layers: int = 3
    disc_in_channels: int = 3
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    perceptual_weight: float = 1.0
    use_actnorm: bool = False
    disc_conditional: bool = False
    disc_ndf: int = 64
    disc_loss: str = "hinge"
    pixel_loss: str = "l1"
    kl_weight: float = 1.0
    logvar_init: float = 0.0

    def d_loss(self):
        if self.disc_loss == "hinge":
            return hinge_d_loss
        if self.disc_loss == "vanilla":
            return vanilla_d_loss
        raise ValueError(f"Unknown GAN loss {self.disc_loss!r}")

    def px_loss(self):
        if self.pixel_loss == "l1":
            return lambda x, y: torch.abs(x - y)
        if self.pixel_loss == "l2":
            return lambda x, y: torch.square(x - y)
        raise ValueError(f"Unknown pixel loss {self.pixel_loss!r}")


def build_discriminator(cfg: VAELossConfig):
    from stedm_tpu_torch.models.discriminator import NLayerDiscriminator

    return NLayerDiscriminator(input_nc=cfg.disc_in_channels, ndf=cfg.disc_ndf,
                               n_layers=cfg.disc_num_layers, use_actnorm=cfg.use_actnorm)


def nll_terms(cfg: VAELossConfig, lpips, inputs: torch.Tensor, rec: torch.Tensor):
    """The pixel (+ perceptual) reconstruction loss map ``[B, H, W, C]`` and
    the perceptual distance ``[B, 1, 1, 1]`` (zeros without ``lpips``)."""
    rec_loss = cfg.px_loss()(inputs.float(), rec.float()) * cfg.pixelloss_weight
    p_loss = torch.zeros((inputs.shape[0], 1, 1, 1), device=inputs.device)
    if cfg.perceptual_weight > 0 and lpips is not None:
        p_loss = lpips(inputs, rec)
        rec_loss = rec_loss + cfg.perceptual_weight * p_loss
    return rec_loss, p_loss


def adaptive_weight(cfg: VAELossConfig, nll_grad: torch.Tensor, g_grad: torch.Tensor):
    """``|grad nll| / (|grad g| + 1e-4)``, clipped to [0, 1e4], times
    ``disc_weight``; no gradient."""
    d_weight = torch.linalg.vector_norm(nll_grad) / (torch.linalg.vector_norm(g_grad) + 1e-4)
    return torch.clamp(d_weight, 0.0, 1e4).detach() * cfg.disc_weight


def _d_weight(cfg, nll, g, last_layer):
    nll_grad, = torch.autograd.grad(nll, last_layer, retain_graph=True)
    g_grad, = torch.autograd.grad(g, last_layer, retain_graph=True)
    dist.all_reduce_mean_([nll_grad, g_grad])   # across ranks: the global batch's
    return adaptive_weight(cfg, nll_grad, g_grad)


def vq_generator_loss(cfg: VAELossConfig, *, forward, disc_apply, lpips, last_layer):
    """The generator side of the VQ pairing: ``loss_fn(inputs, global_step)
    -> (loss, log, idx, rec)`` with ``forward() -> (rec, emb_loss, idx)`` (the
    codec's training forward), ``disc_apply(rec) -> logits`` and
    ``last_layer``, the decoder's last kernel."""

    def loss_fn(inputs, global_step: int):
        rec, emb_loss, idx = forward()
        rec_loss, p_loss = nll_terms(cfg, lpips, inputs, rec)
        nll = torch.mean(rec_loss)
        g = -torch.mean(disc_apply(rec))
        d_weight = _d_weight(cfg, nll, g, last_layer)
        disc_factor = adopt_weight(cfg.disc_factor, global_step, threshold=cfg.disc_start)
        loss = nll + d_weight * disc_factor * g + cfg.codebook_weight * torch.mean(emb_loss)
        log = {"total_loss": loss, "quant_loss": torch.mean(emb_loss), "nll_loss": nll,
               "p_loss": torch.mean(p_loss), "d_weight": d_weight,
               "disc_factor": torch.tensor(disc_factor), "g_loss": g}
        return loss, log, idx, rec

    return loss_fn


def kl_generator_loss(cfg: VAELossConfig, *, forward, disc_apply, lpips, last_layer, logvar):
    """The generator side of the KL pairing: ``forward() -> (rec,
    posterior)``; ``logvar`` is the trainable output log-variance (a 0-dim
    parameter)."""

    def loss_fn(inputs, global_step: int):
        rec, posterior = forward()
        rec_loss, p_loss = nll_terms(cfg, lpips, inputs, rec)
        nll_map = rec_loss / torch.exp(logvar) + logvar
        nll = torch.sum(nll_map) / nll_map.shape[0]
        g = -torch.mean(disc_apply(rec))
        d_weight = _d_weight(cfg, nll, g, last_layer)
        kl = posterior.kl()
        kl_loss = torch.sum(kl) / kl.shape[0]
        disc_factor = adopt_weight(cfg.disc_factor, global_step, threshold=cfg.disc_start)
        loss = nll + cfg.kl_weight * kl_loss + d_weight * disc_factor * g
        log = {"total_loss": loss, "logvar": logvar.detach().clone(), "kl_loss": kl_loss,
               "nll_loss": nll,
               "p_loss": torch.mean(p_loss), "d_weight": d_weight,
               "disc_factor": torch.tensor(disc_factor), "g_loss": g}
        return loss, log, None, rec

    return loss_fn


def discriminator_loss(cfg: VAELossConfig, *, disc_apply):
    """The discriminator side: ``loss_fn(stats, inputs, rec, global_step) ->
    (loss, log, stats)`` with ``disc_apply(x, stats) -> (logits, stats)``;
    the running statistics go through the real, then the fake call."""
    d_loss_fn = cfg.d_loss()

    def loss_fn(stats, inputs, rec, global_step: int):
        logits_real, stats = disc_apply(inputs, stats)
        logits_fake, stats = disc_apply(rec, stats)
        disc_factor = adopt_weight(cfg.disc_factor, global_step, threshold=cfg.disc_start)
        d_loss = disc_factor * d_loss_fn(logits_real, logits_fake)
        log = {"disc_loss": d_loss, "logits_real": torch.mean(logits_real),
               "logits_fake": torch.mean(logits_fake)}
        return d_loss, log, stats

    return loss_fn
