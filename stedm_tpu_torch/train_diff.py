"""Train the style- and layout-conditioned latent diffusion model on one card
or, under torchrun, on one card a process (the counterpart of
train_diff.py:56-303).

* per-device batch = batch_base * batch_mul; lr = base_lr * batch * n_devices
  (reference train_diff.py:36-39), n_devices the processes that
  ``location.mesh``'s ``data`` axis resolves to (``-1``: all of them),
* gradient accumulation (``accumulate_grad_batches``, default 4) inside the
  optimizer,
* a full-state checkpoint every epoch (``<result_dir>/<run>/ckpt/<run>_last.pt``,
  train/checkpoints.py), ``+resume=true`` continues from it,
* epoch-end preview sampling from the fixed test folder when present.

The layout is the data's one-hot collapsed to background vs any foreground
(``batch_to_ldm``), so the model's layout mapper is two channels wide on
every dataset: Flowers, HER2 (6 classes) and CATCH (8).

Usage, from the repository root, on a machine with one CUDA card::

    python -m stedm_tpu_torch.train_diff data=flowers style_sampling=augmented \\
        style_agg=mean location.data_dir=/data location.result_dir=/results
    python -m stedm_tpu_torch.train_diff data=her2 style_sampling=nearby \\
        location.data_dir=/data location.result_dir=/results

and on N cards, one process each (parallel/dist.py; NCCL)::

    torchrun --nproc_per_node=N -m stedm_tpu_torch.train_diff data=flowers ...

Every rank loads its rank-interleaved share of the global batch, takes its
rows of the global batch's draws of t and noise, and the optimizer averages
the gradients over ranks once an update, so N ranks train as one process
does on the global batch. Rank 0 stages the data while the others wait
(train_diff.py:80), and alone logs, writes checkpoints and previews
(:142, :211); every rank resumes from the same file. ``scale_by_std`` takes
the std of the whole first global batch and every rank uses rank 0's value
(JAX's processes each use their own rows' factor; ROADMAP §3).

Warm starts (train_diff.py:97-111), both paths under ``location.result_dir``:
``diffusion.first_stage_config.params.ckpt_path`` loads the codec, from a
``train_ae`` output (``<run>/ckpt/<run>_best.pt``, the documented hand-off)
or a torch state dict through ``map_vq``; ``diffusion.ckpt_path`` loads a
CompVis ``.ckpt`` into the U-Net (``load_only_unet``, default true) or the
whole model, with ``ignore_keys`` (utils/weights.py).

``main(argv, device=None)`` runs on ``cuda``; tests pass ``device="cpu"``.
Not ported, and refused: a mesh axis other than ``data`` or more than one
device in a process (parallel/dist.py:mesh_size), a HER2 or CATCH tree
that is not staged (ROADMAP §1: the pull from an EXACT server), a JAX
orbax directory as a warm start
(ROADMAP §1: reading a JAX orbax directory). ``+adamw_m_bf16`` stores
AdamW's first moment in bf16 (train/optim.py), ``+fused_adamw`` or not.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from stedm_tpu_torch._device import resolve_device
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.data.dm import DataModule
from stedm_tpu_torch.data.prefetch import prefetch_to_device
from stedm_tpu_torch.models.stedm import build_stedm
from stedm_tpu_torch.parallel import dist
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.train.optim import make_optimizer, scaled_lr
from stedm_tpu_torch.train.steps import (
    SamplerConfig,
    compute_scale_by_std,
    create_train_state,
    init_logvar,
    make_sample_fn,
    make_train_step,
)
from stedm_tpu_torch.utils.logging import EventLogger, NullLogger
from stedm_tpu_torch.utils.weights import load_first_stage, load_into_model


def batch_to_ldm(np_batch: tuple) -> dict:
    """Collapse the C-class one-hot to 2 channels (BG vs any-FG) and build the LDM
    batch dict (reference modules/ldm_diffusion.py:51-60)."""
    img, one_hot, _seg, style = np_batch[:4]
    fg = one_hot[..., 1:].sum(axis=-1, keepdims=True)
    seg2 = np.concatenate([one_hot[..., :1], fg], axis=-1)
    return {"image": img, "segmentation": seg2.astype(np.float32),
            "style_imgs": style}


def warm_start(cfg, model) -> dict:
    """The two optional loads of train_diff.py:97-111, paths under
    ``location.result_dir``: the first stage into the codec
    (``load_first_stage``), then ``diffusion.ckpt_path`` into the U-Net or,
    with ``load_only_unet: false``, the whole model, skipping
    ``ignore_keys``. Returns the (loaded, left at init) counts by key."""
    counts = {}
    fs_ckpt = cfg.diffusion.first_stage_config.params.get("ckpt_path")
    if fs_ckpt:
        counts["first_stage"] = load_first_stage(
            model.first_stage, f"{cfg.location.result_dir}/{fs_ckpt}")
    unet_ckpt = cfg.diffusion.get("ckpt_path")
    if unet_ckpt:
        counts["diffusion"] = load_into_model(
            model, f"{cfg.location.result_dir}/{unet_ckpt}",
            subtree="unet" if cfg.diffusion.get("load_only_unet", True) else None,
            ignore_keys=list(cfg.diffusion.get("ignore_keys", None) or []))
    return counts


def count_params(model: torch.nn.Module, name: str = "model") -> int:
    """Parameter counts by top-level group, printed as the JAX package's
    utils/report.py:count_params prints them."""
    groups = [(g, sum(p.numel() for p in m.parameters())) for g, m in model.named_children()]
    total = sum(n for _, n in groups)
    print(f"{name}: {total / 1e6:.2f}M params")
    for g, n in groups:
        print(f"  {g}: {n / 1e6:.2f}M")
    return total


def step_seed(seed: int, step: int) -> int:
    """The seed of a micro-step's draws of t and noise: a function of the
    step, so a resumed run draws what an uninterrupted one would (the JAX
    step folds the step into its key)."""
    return ((int(seed) + 1) << 32) + int(step)


def main(argv: list[str], device=None) -> dict:
    """Train as configured; returns the run's numbers: per epoch the mean
    loss, seconds, micro-steps and samples, and the host clock the loop
    spent getting batches (``data_s``) and issuing their copies (``h2d_s``);
    the step it started from (the restored one on a resume) and the last;
    the scale factor; the warm starts' (loaded, left at init) counts."""
    cfg = compose("config_diff", argv)
    dev = dist.maybe_initialize_distributed(resolve_device(device))

    if cfg.data.batch_size is None:
        cfg.data.batch_size = cfg.data.batch_base * cfg.location.batch_mul
    n_devices = dist.mesh_size(cfg, dev)
    lr = scaled_lr(cfg.base_lr, cfg.data.batch_base, cfg.location.batch_mul,
                   n_devices, cfg.lr)
    global_batch = cfg.data.batch_size * n_devices
    seed = cfg.get("seed", 0)
    main_rank = dist.is_main()

    run_name = f"{cfg.name}_{cfg.data.name}_{cfg.style_sampling.name}_{cfg.style_agg.name}"
    result_dir = f"{cfg.location.result_dir}/{run_name}"
    logger = (EventLogger if main_rank else NullLogger)(
        result_dir, run_name, use_wandb=cfg.location.get("wandb", False), config=dict(cfg))
    print(f"devices={n_devices} global_batch={global_batch} lr={lr:.3e}")

    dm = DataModule(cfg)
    if main_rank:
        dm.prepare_data()
    dist.barrier()
    dm.setup()

    model = build_stedm(cfg, dev, seed=seed)
    count_params(model, name="STEDM")  # reference prints this at init (ddpm.py:90)
    loaded = warm_start(cfg, model)

    schedule = DiffusionSchedule.create(
        cfg.diffusion.beta_schedule, cfg.diffusion.timesteps,
        cfg.diffusion.linear_start, cfg.diffusion.linear_end)

    # each rank loads its rank-interleaved share of the global batch
    # (train_diff.py:120-124)
    loader = dm.train_loader(seed=seed)
    loader.batch_size = dist.local_batch_size(global_batch)
    loader.process_shard = dist.process_shard()

    # first-batch latent std rescale (reference ddpm.py:480-494); the factor is
    # persisted so resumes reproduce restarted_from_ckpt semantics (set once, kept)
    if cfg.diffusion.get("scale_by_std", False):
        sf_file = f"{result_dir}/scale_factor.json"
        # rank 0's view decides, before it writes the file
        if dist.broadcast_value(float(os.path.isfile(sf_file)), dev):
            with open(sf_file) as f:
                sf = json.load(f)["scale_factor"]
        else:
            first = batch_to_ldm(next(iter(loader)))
            loader.epoch = 0  # the peek must not consume an epoch's permutation
            with torch.no_grad():
                sf = compute_scale_by_std(model, torch.as_tensor(first["image"], device=dev))
            sf = dist.broadcast_value(sf, dev)
            if main_rank:
                with open(sf_file, "w") as f:
                    json.dump({"scale_factor": sf}, f)
        print(f"### USING STD-RESCALING ### scale_factor={sf:.6f}")
        model.scale_factor = sf

    learn_logvar = cfg.diffusion.get("learn_logvar", False)
    logvar_init = cfg.diffusion.get("logvar_init", 0.0)
    logvar = init_logvar(cfg.diffusion.timesteps, logvar_init, device=dev) \
        if learn_logvar else None

    tx = make_optimizer(
        lr, style_encoder_trainable=cfg.diffusion.get("style_encoder_trainable", True),
        accumulate_grad_batches=cfg.get("accumulate_grad_batches", 4),
        clip_grad_norm=cfg.get("clip_grad_norm"),
        fused=bool(cfg.get("fused_adamw", False)),
        m_dtype=torch.bfloat16 if cfg.get("adamw_m_bf16") else None)
    state = create_train_state(model, tx, logvar)

    # preemption-safe resume: resume=true reloads the last epoch's checkpoint
    ckpt_dir, ckpt_name = result_dir + "/ckpt", f"{run_name}_last"
    start_epoch = 0
    if cfg.get("resume"):
        if checkpoints.checkpoint_file(ckpt_dir, ckpt_name).is_file():
            state = checkpoints.restore(ckpt_dir, state, name=ckpt_name)
            start_epoch = state.step // max(len(loader), 1)
            print(f"resumed from step {state.step} (epoch ~{start_epoch})")
        else:
            print(f"resume requested but no checkpoint at "
                  f"{checkpoints.checkpoint_file(ckpt_dir, ckpt_name)}; fresh start")

    train_step = make_train_step(model, schedule, tx,
                                 loss_type=cfg.diffusion.get("loss_type", "l1"),
                                 learn_logvar=learn_logvar, logvar_init=logvar_init,
                                 device=dev)
    gen = torch.Generator(device=dev)

    start_step, epochs = state.step, []
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        losses, laps = [], {}
        batches = prefetch_to_device(loader, size=cfg.location.get("prefetch", 2),
                                     transform=batch_to_ldm, device=dev, laps=laps)
        for batch in batches:
            gen.manual_seed(step_seed(seed, state.step))
            state, metrics = train_step(state, batch, gen)
            losses.append(metrics["loss"])
        train_loss = float("nan")
        if losses:
            rank_losses = torch.stack(losses)
            dist.all_reduce_mean_([rank_losses])    # each rank's rows: the global mean
            train_loss = float(rank_losses.mean())
        seconds = time.time() - t0
        logger.log({"Train Loss": train_loss, "epoch": epoch, "epoch_time_s": seconds},
                   step=state.step)
        if main_rank:
            checkpoints.save(ckpt_dir, state, name=ckpt_name)
        epochs.append({"epoch": epoch, "loss": train_loss, "seconds": seconds,
                       "micro_steps": len(losses), "samples": len(losses) * global_batch,
                       "data_s": laps.get("data", 0.0), "h2d_s": laps.get("h2d", 0.0)})
        if main_rank:
            preview_previews(cfg, model, schedule, state, logger, epoch, dev)

    dist.barrier()   # rank 0's checkpoint is on disk when any rank returns
    logger.close()
    return {"epochs": epochs, "start_step": start_step, "step": state.step,
            "scale_factor": float(model.scale_factor), "run_dir": result_dir,
            "warm_start": loaded}


def _load_preview_styles(cfg, folder: str) -> list[np.ndarray]:
    """The reference's 4 fixed test styles (ldm_diffusion.py:145-172): 'nearby'
    loads {i}_img.png, 'mp' concatenates {i}_img_{j}.png over the set axis,
    'dummy' uses a constant -1 set."""
    from PIL import Image

    load = lambda f: (np.array(Image.open(f))[:, :, :3].astype(np.float32)
                      / 127.5 - 1)
    style_dir = f"{folder}/{cfg.style_sampling.name}"
    styles = []
    if cfg.style_sampling.name == "dummy":
        p = cfg.data.patch_size
        return [np.full((1, 1, p, p, 3), -1.0, np.float32)] * 4
    for i in range(4):
        if cfg.style_sampling.name == "mp":
            parts = []
            for j in range(cfg.style_sampling.get("num_patches", 1)):
                f = f"{style_dir}/{i}_img_{j}.png"
                if os.path.isfile(f):
                    parts.append(load(f)[None, None])
            if parts:
                styles.append(np.concatenate(parts, axis=1))
        else:
            f = f"{style_dir}/{i}_img.png"
            if os.path.isfile(f):
                styles.append(load(f)[None, None])
    return styles


def preview_previews(cfg, model, schedule, state, logger, epoch, dev) -> None:
    """Epoch-end fixed-style previews (reference ldm_diffusion.py:128-221), gated on
    the test folder existing on disk: 4 unguided samples at 128 DDIM steps
    (``+preview_ddim_steps``), plus, when style drop is active, CFG variants at
    guidance scales 3 and 5 on the first two styles (ldm_diffusion.py:195-221).
    Sampled eagerly with the trained weights, noise from ``epoch``."""
    test_folder = cfg.data.get("test_folder")
    if not test_folder:
        return
    folder = f"{cfg.location.data_dir}/{test_folder}"
    cond_path = f"{folder}/test_c.png"
    if not os.path.isfile(cond_path):
        return
    from PIL import Image

    test_img = np.array(Image.open(cond_path).convert("L"))
    test_img = (test_img > 0).astype(np.int64)
    one_hot = np.eye(2, dtype=np.float32)[test_img][None]

    styles = _load_preview_styles(cfg, folder)
    if not styles:
        return

    steps = cfg.get("preview_ddim_steps", 128)  # reference uses 128 (ldm_diffusion.py:185)
    gen = torch.Generator(device=dev)
    sample = make_sample_fn(model, schedule, SamplerConfig(
        ddim_steps=steps, eta=0.0, cfg_scale=1.0, use_cfg=False, downsample=4), device=dev)
    imgs = []
    for style in styles:
        batch = {"segmentation": one_hot, "style_imgs": style}
        imgs.append(sample(model, batch, generator=gen.manual_seed(epoch))[0].float().cpu())
    logger.log_images("Sample Images", imgs, step=epoch)

    # CFG previews (ldm_diffusion.py:195-221): styles 0/1 at guidance 3 and 5,
    # uncond = dropped (constant -2) style
    if cfg.get("style_drop_rate", 0.0) > 0.0 and cfg.style_sampling.name != "dummy":
        cfg_imgs = []
        for style in styles[:2]:
            batch = {"segmentation": one_hot, "style_imgs": style}
            for scale in (3.0, 5.0):
                cfg_sample = make_sample_fn(model, schedule, SamplerConfig(
                    ddim_steps=steps, eta=0.0, cfg_scale=scale, rescale_phi=0.7,
                    batched_cfg=True, downsample=4), device=dev)
                img = cfg_sample(model, batch, generator=gen.manual_seed(epoch))
                cfg_imgs.append(img[0].float().cpu())
        logger.log_images("Sample Images CFG", cfg_imgs, step=epoch)


if __name__ == "__main__":
    main(sys.argv[1:])
