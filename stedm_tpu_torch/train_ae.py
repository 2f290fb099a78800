"""Codec fine-tuning on one card, or under torchrun on one card a process
(the counterpart of train_ae.py): ``main``
composes ``config_ae``, reads the data module's images and runs the
combined generator + discriminator step (``train/ae_steps.py``) with the
taming lr rule, validating every epoch and writing ``<run>_last`` and, on a
new lowest ``val/rec_loss``, ``<run>_best`` (``<result_dir>/<run>/ckpt/``).
``build_codec`` instantiates the codec named by a ``first_stage_config``.

Usage, from the repository root, on a machine with one CUDA card::

    python -m stedm_tpu_torch.train_ae data=her2 location.data_dir=/data \\
        location.result_dir=/results +lpips_ckpt=/weights/vgg.pth,/weights/vgg16.pth
    torchrun --nproc_per_node=N -m stedm_tpu_torch.train_ae data=her2 ...

Across N ranks (parallel/dist.py) every rank trains on its rank-interleaved
share of the global batch and the step averages the gradients
(train/ae_steps.py), so the ranks train as one process on the global batch.
JAX's ``train_ae.py:186`` gives every process the whole global batch and no
``process_shard``; the port shards as ``train_diff`` does (ROADMAP §3).
Validation runs on rank 0 alone, over the whole val split at the global
batch, so its metrics and the choice of ``_best`` are the one-process run's;
rank 0 alone logs (its train log covers its own rows) and writes
checkpoints.

``main(argv, device=None)`` runs on ``cuda``; tests pass ``device="cpu"``.
Without ``lpips_ckpt`` the perceptual term is off, as in the JAX entry
point (random VGG features are no perceptual metric); with it, a
comma-separated list of torch state_dict files (taming's ``vgg.pth`` heads,
a torchvision VGG16, a full taming LPIPS) is loaded. A warm start
(``diffusion.first_stage_config.params.ckpt_path``, under ``result_dir``)
reads a torch state dict through ``map_vq`` (a CompVis ``vq-f4.ckpt``,
bare or under ``first_stage_model.``), or the port's own checkpoint file: a
``_best`` or ``_last`` of this entry point or a params file. Refused: a JAX
orbax directory (ROADMAP §1: reading a JAX orbax directory), a mesh axis
other than ``data`` or more than one device in a process
(parallel/dist.py:mesh_size) and a HER2 or CATCH tree that is not staged
(ROADMAP §1: the pull from an EXACT server).

The repository's configs are yaml; this package keeps Python copies of the
pieces its tests and chip_smoke.py build codecs from (``AE_LOSS``:
config_ae.yaml's ``loss`` block and its ``base_lr``; ``VQ_F4`` and
``KL_F4``: the first-stage configs), which a test holds equal to the files.

Typical use of the pieces, on the card::

    model, variant = build_codec(VQ_F4, dtype=torch.bfloat16)
    cfg = VAELossConfig(**AE_LOSS)
    disc = build_discriminator(cfg).cuda()
    gen_tx, disc_tx = ae_optimizers(scaled_lr(BASE_LR, 1, batch))
    state = create_ae_state(model.cuda(), disc, gen_tx, disc_tx)
    step = make_ae_train_step(model, cfg, lpips=None, variant=variant)
    for img in batches:                 # NHWC images in [-1, 1] on the card
        state, log, rec = step(state, img)
"""

from __future__ import annotations

import sys
import time

import torch

from stedm_tpu_torch._device import resolve_device
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.data.dm import DataModule
from stedm_tpu_torch.data.prefetch import prefetch_to_device
from stedm_tpu_torch.models.autoencoder_kl import AutoencoderKL
from stedm_tpu_torch.models.lpips import LPIPS
from stedm_tpu_torch.models.vq import VQModelInterface
from stedm_tpu_torch.parallel import dist
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.train.ae_steps import (
    ae_optimizers,
    create_ae_state,
    init_lossvar,
    make_ae_eval_step,
    make_ae_train_step,
)
from stedm_tpu_torch.train.vae_losses import VAELossConfig, build_discriminator
from stedm_tpu_torch.utils.logging import EventLogger, NullLogger
from stedm_tpu_torch.utils.weights import load_first_stage, load_torch_state_dict

# configs/config_ae.yaml
BASE_LR = 4.5e-6
AE_LOSS = dict(disc_start=1000, codebook_weight=1.0, pixelloss_weight=1.0, disc_num_layers=3,
               disc_in_channels=3, disc_factor=1.0, disc_weight=0.75, perceptual_weight=1.0,
               use_actnorm=False, disc_ndf=64, disc_loss="hinge", pixel_loss="l1",
               kl_weight=1.0e-6, logvar_init=0.0)

_DDCONFIG = dict(z_channels=3, resolution=512, in_channels=3, out_ch=3, ch=128,
                 ch_mult=[1, 2, 4], num_res_blocks=2, attn_resolutions=[], dropout=0.0)
# configs/diffusion/first_stage_config/vq-f4.yaml and kl-f4.yaml
VQ_F4 = dict(target="stedm_tpu.models.vq.VQModelInterface",
             params=dict(embed_dim=3, n_embed=8192, ckpt_path=None,
                         ddconfig=dict(double_z=False, **_DDCONFIG)))
KL_F4 = dict(target="stedm_tpu.models.autoencoder_kl.AutoencoderKL",
             params=dict(embed_dim=3, ckpt_path=None, ddconfig=dict(double_z=True, **_DDCONFIG)))


def scaled_lr(base_lr: float, accumulate: int, global_batch: int,
              lr: float | None = None) -> float:
    """The taming lr rule of train_ae.py: ``base_lr * accumulate * global
    batch``, unless ``lr`` is set."""
    return float(lr) if lr else float(base_lr) * accumulate * global_batch


def build_codec(first_stage_config: dict, dtype: torch.dtype = torch.float32):
    """``(model, variant)`` for a first-stage config (``target`` and
    ``params``): ``AutoencoderKL`` -> ``"kl"``, anything else the VQ codec ->
    ``"vq"``. A ``ckpt_path`` is loaded into it as given
    (``utils.weights.load_first_stage``)."""
    params = dict(first_stage_config["params"])
    ckpt_path = params.pop("ckpt_path", None)
    params.pop("monitor", None)
    params.pop("lossconfig", None)
    params["ddconfig"] = dict(params["ddconfig"])
    if str(first_stage_config["target"]).rsplit(".", 1)[-1] == "AutoencoderKL":
        params.pop("n_embed", None)
        model, variant = AutoencoderKL(dtype=dtype, **params), "kl"
    else:
        model, variant = VQModelInterface(dtype=dtype, **params), "vq"
    if ckpt_path:
        load_first_stage(model, ckpt_path)
    return model, variant


# torchvision VGG16 ``features`` indices where each LPIPS slice ends
# (torch_import.py:_VGG_SLICE_BOUNDS)
_VGG_SLICE_BOUNDS = (4, 9, 16, 23, 30)


def lpips_keys(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A torch LPIPS source under the port's ``LPIPS`` names, as
    torch_import.py:map_lpips reads it: taming's ``vgg.pth`` heads
    (``lin{k}.model.1.weight``), a taming ``LPIPS`` state_dict
    (``net.slice{s}.{i}.*``) or a torchvision VGG16 (``features.{i}.*``,
    sliced at the max-pools), under any of the roots ``""``,
    ``perceptual_loss.``, ``loss.perceptual_loss.``."""
    out = {}
    for key, v in sd.items():
        k = key
        for root in ("loss.perceptual_loss.", "perceptual_loss."):
            if k.startswith(root):
                k = k[len(root):]
        parts = k.split(".")
        if parts[0].startswith("lin") and parts[1:] == ["model", "1", "weight"]:
            out[k] = v
        elif parts[0] == "net" and parts[-1] in ("weight", "bias"):
            out[k] = v
        elif parts[0] == "features" and parts[-1] in ("weight", "bias"):
            idx = int(parts[1])
            s = next(i for i, end in enumerate(_VGG_SLICE_BOUNDS) if idx < end) + 1
            out[f"net.slice{s}.{idx}.{parts[-1]}"] = v
    return out


def maybe_load_lpips(cfg, device) -> LPIPS | None:
    """The LPIPS module for the perceptual term, or None when no
    ``lpips_ckpt`` is staged (the term is then off: random VGG features are
    no perceptual metric), as train_ae.py:71-96. ``lpips_ckpt`` is a
    comma-separated list of torch state_dict files, merged in order."""
    path = cfg.get("lpips_ckpt")
    if not path or float(cfg.loss.perceptual_weight) <= 0:
        if float(cfg.loss.perceptual_weight) > 0:
            print("lpips_ckpt not set: disabling the perceptual term "
                  "(stage taming vgg_lpips weights to enable)")
        return None
    lpips = LPIPS()
    sd = lpips.state_dict()
    for part in str(path).split(","):
        for k, v in lpips_keys(load_torch_state_dict(part)).items():
            if k not in sd or tuple(sd[k].shape) != tuple(v.shape):
                raise ValueError(f"{part}: {k} {tuple(v.shape)} does not fit LPIPS")
            sd[k] = v.float()
    lpips.load_state_dict(sd, strict=True)
    return lpips.to(device).eval()


def warm_start(model, cfg, fs_ckpt: str) -> tuple[int, int]:
    """Load the codec's weights from ``<result_dir>/<fs_ckpt>``
    (train_ae.py:144-162): a torch state dict through ``map_vq``, or this
    package's own checkpoint file. A JAX orbax directory raises (ROADMAP
    §1: reading a JAX orbax directory)."""
    return load_first_stage(model, f"{cfg.location.result_dir}/{fs_ckpt}")


def _mean(logs: list[dict]) -> dict[str, float]:
    return {k: float(torch.stack([torch.as_tensor(log[k]).double().cpu() for log in logs]
                                 ).mean()) for k in logs[0]}


def main(argv: list[str], device=None) -> dict:
    """Fine-tune the codec as configured (train_ae.py:99-233); returns the
    run's numbers: per epoch the mean train log, the mean val metrics, the
    seconds, the steps and the host clock spent getting batches (``data_s``)
    and issuing their copies (``h2d_s``); the last step and the run
    directory."""
    cfg = compose("config_ae", argv)
    dev = dist.maybe_initialize_distributed(resolve_device(device))
    if cfg.data.batch_size is None:
        cfg.data.batch_size = cfg.data.batch_base * cfg.location.batch_mul
    n_devices = dist.mesh_size(cfg, dev)
    global_batch = cfg.data.batch_size * n_devices
    accum = int(cfg.get("accumulate_grad_batches", 1))
    lr = scaled_lr(cfg.base_lr, accum, global_batch, cfg.get("lr"))
    seed = cfg.get("seed", 0)

    main_rank = dist.is_main()
    run_name = cfg.get("run_name") or f"ae_{cfg.data.name}"
    dm = DataModule(cfg)
    if main_rank:
        dm.prepare_data()  # before anything is written: an unstaged tree refuses
    dist.barrier()
    result_dir = f"{cfg.location.result_dir}/{run_name}"
    logger = (EventLogger if main_rank else NullLogger)(
        result_dir, run_name, use_wandb=cfg.location.get("wandb", False), config=dict(cfg))
    print(f"devices={n_devices} global_batch={global_batch} lr={lr:.3e}")
    dm.setup()

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg.diffusion.get("compute_dtype", "float32")]
    fs = dict(cfg.diffusion.first_stage_config)
    fs_ckpt = fs["params"].get("ckpt_path")
    fs["params"] = {k: v for k, v in dict(fs["params"]).items() if k != "ckpt_path"}
    loss_cfg = VAELossConfig(**dict(cfg.loss))
    lpips = maybe_load_lpips(cfg, dev)
    if lpips is None:
        loss_cfg = VAELossConfig(**{**dict(cfg.loss), "perceptual_weight": 0.0})
    cuda_devs = [dev.index or 0] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda_devs), torch.device(dev):
        torch.manual_seed(seed)
        model, variant = build_codec(fs, dtype=dtype)
        disc = build_discriminator(loss_cfg)
    if fs_ckpt:
        warm_start(model, cfg, fs_ckpt)
    logvar = init_lossvar(loss_cfg.logvar_init, device=dev) if variant == "kl" else None
    gen_tx, disc_tx = ae_optimizers(lr)
    state = create_ae_state(model, disc, gen_tx, disc_tx, logvar)
    train_step = make_ae_train_step(model, loss_cfg, lpips=lpips, variant=variant,
                                    seed=seed, device=dev)
    eval_step = make_ae_eval_step(model, loss_cfg, lpips=lpips, variant=variant,
                                  device=dev)

    loader = dm.train_loader(seed=seed)
    loader.batch_size = dist.local_batch_size(global_batch)
    loader.process_shard = dist.process_shard()
    val_loader = dm.val_loader()
    val_loader.batch_size = global_batch
    prefetch = cfg.location.get("prefetch", 2)
    images = lambda b: {"img": b[0]}  # noqa: E731
    ckpt_dir = result_dir + "/ckpt"

    best_val, epochs = float("inf"), []
    for epoch in range(cfg.num_epochs):
        t0 = time.time()
        logs, laps = [], {}
        for batch in prefetch_to_device(loader, size=prefetch, transform=images, device=dev,
                                        laps=laps):
            state, log, _rec = train_step(state, batch["img"])
            logs.append(log)
        train = _mean(logs) if logs else {}     # read back: the card is done
        record = {"epoch": epoch, "steps": len(logs), "seconds": time.time() - t0,
                  "data_s": laps.get("data", 0.0), "h2d_s": laps.get("h2d", 0.0),
                  "train": train, "val": {}}
        if logs:
            logger.log({**train, "epoch": epoch, "epoch_time_s": record["seconds"]},
                       step=state.step)
        vals = [eval_step(batch["img"])[0] for batch in
                prefetch_to_device(val_loader, size=prefetch, transform=images, device=dev)
                ] if main_rank else []
        if vals:
            record["val"] = _mean(vals)
            logger.log(record["val"], step=state.step)
            checkpoints.save(ckpt_dir, state, name=f"{run_name}_last")
            if record["val"]["val/rec_loss"] < best_val:
                best_val = record["val"]["val/rec_loss"]
                checkpoints.save(ckpt_dir, state, name=f"{run_name}_best")
        epochs.append(record)

    dist.barrier()   # rank 0's checkpoints are on disk when any rank returns
    logger.close()
    return {"epochs": epochs, "step": state.step, "run_dir": result_dir, "lr": lr,
            "variant": variant}


if __name__ == "__main__":
    main(sys.argv[1:])
