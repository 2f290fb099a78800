"""Generate synthetic (image, segmentation) pairs with DDIM, PLMS or
DPM-Solver++(2M) and rescaled CFG on one card, or under torchrun on one
card a process (the counterpart of predict_diff.py:50-325).

* loads a trained checkpoint (train/checkpoints.py: a full train state, from
  which ``+use_ema=true`` samples with the EMA shadow of the U-Net, or bare
  params); the default is the training run's ``ckpt/<run>_last.pt``,
* writes ``img_NNNNN.png`` / ``seg_NNNNN.png`` pairs under
  ``data_dir/syn_data/<predict_name>`` (reference predict_diff.py:51-57),
* doubles ``cfg.data.samples`` (reference :62),
* ``sampler: ddim | plms | dpm``,
* the serving mode's knobs: ``+cache_interval``, ``+cache_levels``,
  ``+cache_schedule`` (``auto:R`` calibrates on the first batch),
  ``+cfg_interval=[lo,hi]``,
* ``+canvas_size=<k * patch>``: k x k layouts of a batch are mosaicked into
  one canvas with the first one's style, and sampled through tiled eps and
  decode (exact DDIM; predict_diff.py:172-200, :301),
* on the card, the block sampler replayed as CUDA graphs
  (train/host_sampler.py) serves by default; ``+host_loop=false`` gives the
  eager sampler, ``+block_carry`` and ``+unroll`` shape the blocks.

As JAX's predict, it reads neither ``diffusion.ckpt_path`` nor the first
stage's ``ckpt_path``: the run's checkpoint holds the codec.

The loop is pipelined one batch deep: batch k+1's upload (pinned host memory,
``non_blocking``) and sampler launches are issued before batch k's images are
read back (quantised to uint8 on the card, copied into pinned memory with
``non_blocking``) and written as PNGs. ``+compact_transfer=true`` uploads the
conditioning as uint8 layout indices + float16 style images.

Predict pairs the first dataset's layouts with the second's styles
(``data/dm.py:PredictDataset``): on HER2, ``her2_anno`` layouts with style
patches from the unannotated scoring slides of ``her2_unanno``, the paper's
zero-shot style transfer.

Usage, from the repository root, on a machine with one CUDA card::

    python -m stedm_tpu_torch.predict_diff data/dataset=[flowers_anno,flowers_unanno] \\
        data.ratios=[1.0,1.0] style_sampling=augmented style_agg=mean cfg_scale=1.5
    python -m stedm_tpu_torch.predict_diff data=her2 \\
        data/dataset=[her2_anno,her2_unanno] data.ratios=[1.0,1.0]
    torchrun --nproc_per_node=N -m stedm_tpu_torch.predict_diff ...

Across N ranks (parallel/dist.py) the predict grid is sharded rank by rank
(predict_diff.py:160-168): every rank loads its rank-interleaved share of
each global batch, takes its rows of the global batch's x_T (drawn from the
batch's seed for ``N * local rows``, :320) and writes only its own pairs
(:268-276). Each process holds one card, so a local batch needs no padding
(:305-310); the rows that wrap-pad the last shard repeat an item, are
sampled and are not written. A pair thus equals the one-process run's
when the number of layouts divides by N (a padded global batch draws more
rows). Each rank picks its sampler as one card does (the graphed blocks on
the card, ``+host_loop=false`` the eager loop), since it holds a whole
card; an explicit ``+host_loop=true`` with several ranks is refused as JAX
refuses it (:222-230). The ``auto:`` drift calibration runs on rank 0's
first batch and every rank uses its positions (JAX calibrates on each
process's own batch; ROADMAP §3). Sampling noise at ``eta > 0`` is each
rank's own draw.

``main(argv, device=None, x_T_fn=None)`` runs on ``cuda``; tests pass
``device="cpu"``. ``x_T_fn(batch_idx, shape)`` draws a global batch's x_T.
Refused: a mesh axis other than ``data`` or more than one device in a
process (parallel/dist.py:mesh_size) and a HER2 or CATCH tree that is not
staged (ROADMAP §1: the pull from an EXACT server).
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from PIL import Image

from stedm_tpu_torch._device import resolve_device
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.core.cache_schedule import positions_from_spec
from stedm_tpu_torch.core.ddim import DDIMParams
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.data.dm import DataModule
from stedm_tpu_torch.data.prefetch import pinned
from stedm_tpu_torch.models.stedm import build_stedm
from stedm_tpu_torch.parallel import dist
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.train.calibrate import measure_cache_drift
from stedm_tpu_torch.train.host_sampler import make_host_sample_fn
from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn
from stedm_tpu_torch.train_diff import batch_to_ldm


def load_sampling_weights(model, ckpt_path: str, use_ema: bool) -> str:
    """Load a full-state or a params-only checkpoint into ``model``; with
    ``use_ema`` the U-Net takes the EMA shadow of a full state. Returns the
    checkpoint's format."""
    payload = checkpoints.load(ckpt_path)
    model.load_state_dict(payload["params"], strict=True)
    if use_ema:
        if payload["format"] != "train_state":
            raise ValueError(f"+use_ema=true needs a full-state checkpoint; {ckpt_path} "
                             "holds bare params")
        model.unet.load_state_dict(payload["ema"], strict=True)
    return payload["format"]


def parse_cfg_interval(ci) -> tuple[float, float] | None:
    """``+cfg_interval=[lo,hi]`` (or the string ``lo:hi``) as a float pair.
    A bare ``lo:hi`` on the command line is YAML sexagesimal and parses as
    one number, which is refused (predict_diff.py:144-147)."""
    if ci is None:
        return None
    if isinstance(ci, str):
        lo_s, _, hi_s = ci.partition(":")
        return float(lo_s), float(hi_s)
    if isinstance(ci, (int, float)):
        raise SystemExit(
            f"+cfg_interval={ci!r}: pass the interval as a [lo,hi] list "
            "(a bare lo:hi parses as one YAML sexagesimal number)")
    return tuple(float(v) for v in ci)


def default_x_T(seed: int, dev: torch.device) -> Callable:
    """``x_T_fn(batch_idx, shape)``: a standard normal draw from a generator
    seeded from ``seed`` and the batch index."""
    gen = torch.Generator(device=dev)

    def x_T_fn(batch_idx: int, shape: tuple) -> torch.Tensor:
        gen.manual_seed((int(seed) << 32) + int(batch_idx))
        return torch.randn(shape, generator=gen, device=dev)

    return x_T_fn


def mosaic(ldm_batch: dict, indices: np.ndarray, grid: int) -> tuple[dict, np.ndarray]:
    """``grid`` x ``grid`` consecutive layouts of the batch as one canvas,
    row-major, with the style and index of the first (predict_diff.py:
    283-301); a remainder of fewer than ``grid**2`` layouts is dropped."""
    g = grid * grid
    n = ldm_batch["segmentation"].shape[0] // g

    def tile(x):   # [n*g, p, p, C] -> [n, grid*p, grid*p, C]
        p, c = x.shape[1], x.shape[-1]
        x = x[:n * g].reshape(n, grid, grid, p, p, c)
        return x.transpose(0, 1, 3, 2, 4, 5).reshape(n, grid * p, grid * p, c)

    return ({"image": ldm_batch["image"][:n * g:g],
             "segmentation": tile(ldm_batch["segmentation"]),
             "style_imgs": ldm_batch["style_imgs"][:n * g:g]}, indices[:n * g:g])


class _Laps:
    """Host-clock laps of the generation loop: (phase, seconds, end time)."""

    def __init__(self):
        self.laps: list[tuple[str, float, float]] = []
        self.start = self._t = time.perf_counter()

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        self.laps.append((phase, now - self._t, now))
        self._t = now

    def summary(self, first_pairs: int) -> dict:
        """Seconds to the first batch's PNGs, then the rest of the loop as a
        whole and by phase."""
        t_first = next(end for phase, _, end in self.laps if phase == "png")
        rest = [(phase, dt) for phase, dt, end in self.laps if end > t_first]
        phases = {ph: sum(dt for p, dt in rest if p == ph)
                  for ph in ("data", "h2d", "sample", "wait", "png")}
        return {"first_batch_pairs": first_pairs, "first_batch_s": t_first - self.start,
                "steady_s": self._t - t_first, "steady_phase_s": phases}


def main(argv: list[str], device=None, x_T_fn: Callable | None = None) -> dict:
    """Write the pairs; returns the run's numbers on the host clock: the
    pairs written, the set-up seconds, the seconds to the first batch's PNGs
    and the rest of the loop, in all and by phase: loading batches
    (``data``), uploading them (``h2d``), issuing the sampler and the uint8
    quantisation (``sample``), waiting for the card (``wait``) and writing
    PNGs (``png``)."""
    t_start = time.perf_counter()
    cfg = compose("config_predict", argv)
    dev = dist.maybe_initialize_distributed(resolve_device(device))

    if cfg.data.batch_size is None:
        cfg.data.batch_size = cfg.data.batch_base * cfg.location.batch_mul
    n_devices = dist.mesh_size(cfg, dev)
    world, rank = dist.world_size(), dist.rank()
    global_batch = cfg.data.batch_size * n_devices
    p = cfg.data.patch_size
    canvas = int(cfg.get("canvas_size", 0) or 0)
    grid = 1
    if canvas > p:
        if canvas % p:
            raise SystemExit(f"canvas_size {canvas} must be a multiple of the "
                             f"training patch {p}")
        grid = canvas // p
    method = cfg.get("sampler", "ddim")

    # double the sample budget (reference predict_diff.py:62)
    cfg.data.samples = cfg.data.samples * 2

    ckpt_name = cfg.get("ckpt_name")
    run_name = ckpt_name or \
        f"diff_{cfg.data.name}_{cfg.style_sampling.name}_{cfg.style_agg.name}"
    predict_dir = Path(cfg.location.data_dir) / "syn_data" / cfg.get(
        "predict_name", cfg.data.name)
    predict_dir.mkdir(parents=True, exist_ok=True)

    dm = DataModule(cfg)
    if dist.is_main():
        dm.prepare_data()
    dist.barrier()
    dm.setup()

    model = build_stedm(cfg, dev)
    ckpt_path = cfg.get("ckpt_path") or \
        f"{cfg.location.result_dir}/{run_name}/ckpt/{run_name}_last"
    fmt = load_sampling_weights(model, ckpt_path, bool(cfg.get("use_ema")))
    print(f"loaded {fmt} checkpoint {ckpt_path}{' (EMA U-Net)' if cfg.get('use_ema') else ''}")

    schedule = DiffusionSchedule.create(
        cfg.diffusion.beta_schedule, cfg.diffusion.timesteps,
        cfg.diffusion.linear_start, cfg.diffusion.linear_end)
    use_cfg = (cfg.cfg_scale != 1) and (cfg.style_sampling.name != "none")
    sampler_cfg = SamplerConfig(
        ddim_steps=cfg.ddim_steps, eta=cfg.eta, cfg_scale=cfg.cfg_scale,
        rescale_phi=cfg.get("rescale_phi", 0.7),
        batched_cfg=cfg.get("batched_cfg", True), use_cfg=use_cfg, downsample=4,
        method=method, cache_interval=int(cfg.get("cache_interval", 1)),
        cache_levels=int(cfg.get("cache_levels", 1)),
        cfg_interval=parse_cfg_interval(cfg.get("cfg_interval", None)))

    # multi-rank: the rank-interleaved predict grid (predict_diff.py:160-168)
    loader = dm.predict_loader()
    loader.batch_size = dist.local_batch_size(global_batch)
    loader.process_shard = dist.process_shard()
    loader.drop_last = False
    seed = cfg.get("seed", 0)
    if x_T_fn is None:
        x_T_fn = default_x_T(seed, dev)
    eta_gen = torch.Generator(device=dev)

    loader_stream = iter(loader)
    spec = cfg.get("cache_schedule", None)
    if spec is not None:
        if grid > 1:
            raise SystemExit("deep-feature caching (+cache_schedule=) is not "
                             "supported on tiled canvases (+canvas_size=)")
        n_steps = DDIMParams.create(schedule, cfg.ddim_steps, cfg.eta).num_steps
        spec = str(spec) if isinstance(spec, str) else list(spec)
        drift = None
        if isinstance(spec, str) and spec.startswith("auto"):
            first = next(loader_stream)
            loader_stream = itertools.chain([first], loader_stream)
            calib_cfg = dataclasses.replace(sampler_cfg, cache_interval=1,
                                            cache_schedule=None)
            if dist.is_main():   # rank 0's batch calibrates every rank
                drift = measure_cache_drift(model, schedule, calib_cfg, batch_to_ldm(first),
                                            generator=eta_gen.manual_seed(seed), device=dev)
            drift = dist.broadcast_object(drift)
        positions = positions_from_spec(spec, n_steps, drift)
        print(f"cache_schedule: refreshing the deep trunk at positions "
              f"{list(positions)} of {n_steps} steps")
        sampler_cfg = dataclasses.replace(sampler_cfg, cache_schedule=tuple(positions))

    use_host = cfg.get("host_loop", None)
    if use_host and world > 1:
        raise SystemExit(
            "+host_loop=true requires a single device and a single process "
            f"(got devices={n_devices}, processes={world}); drop host_loop: each "
            "rank then picks its sampler as one card does")
    if use_host is None:
        use_host = dev.type == "cuda"
    if use_host:
        sample = make_host_sample_fn(model, schedule, sampler_cfg,
                                     unroll=cfg.get("unroll", None),
                                     carry_cache=bool(cfg.get("block_carry", False)),
                                     device=dev)
    else:
        sample = make_sample_fn(model, schedule, sampler_cfg, device=dev)
    compact = bool(cfg.get("compact_transfer", False))
    on_card = dev.type == "cuda"

    def upload(ldm_batch: dict) -> dict:
        """The conditioning on the device; through pinned memory on the card."""
        if compact:
            host = {"seg": np.argmax(ldm_batch["segmentation"], -1).astype(np.uint8),
                    "style": np.asarray(ldm_batch["style_imgs"], np.float16)}
        else:
            host = {k: ldm_batch[k] for k in ("segmentation", "style_imgs")}
        put = {k: (pinned(v) if on_card else torch.from_numpy(np.ascontiguousarray(v)))
               .to(dev, non_blocking=True) for k, v in host.items()}
        if compact:
            return {"segmentation": torch.nn.functional.one_hot(put["seg"].long(), 2).float(),
                    "style_imgs": put["style"].float()}
        return put

    def flush(prev) -> None:
        """Wait for a generated batch's readback and write its pairs."""
        host_u8, ready, segs, idxs, keep, bi = prev
        if ready is not None:
            ready.synchronize()
        laps.lap("wait")
        imgs = host_u8.numpy()
        n_rows = int(keep.sum())
        for img_u8, seg, num in zip(imgs[keep], segs[keep], idxs[keep]):
            num_str = str(int(num)).zfill(5)
            Image.fromarray(img_u8).save(predict_dir / f"img_{num_str}.png")
            Image.fromarray(seg).save(predict_dir / f"seg_{num_str}.png")
        laps.lap("png")
        print(f"batch {bi}: wrote {n_rows} pairs to {predict_dir}", flush=True)

    # one-batch pipeline: issue batch k+1 (upload + sampler launches) BEFORE
    # reading back batch k, so that the readback and the PNG encoding of k
    # overlap the card computing k+1
    pending, n_pairs, first_pairs, seen = None, 0, 0, 0
    setup_s = time.perf_counter() - t_start
    laps = _Laps()
    for batch_idx, np_batch in enumerate(loader_stream):
        laps.lap("data")
        ldm_batch = batch_to_ldm(np_batch)
        indices = np.asarray(np_batch[4])
        # this rank's items; the rows that wrap-pad the last shard are not written
        valid = dist.valid_rows(len(loader.dataset), seen, len(indices)).numpy()
        seen += len(indices)
        if grid > 1:
            g = grid * grid
            valid = valid[:len(valid) // g * g:g]
            ldm_batch, indices = mosaic(ldm_batch, indices, grid)
            if indices.size == 0:
                print(f"batch {batch_idx}: fewer than {grid * grid} layouts, skipping")
                continue
        b, side = ldm_batch["segmentation"].shape[:2]
        batch = upload(ldm_batch)
        laps.lap("h2d")
        # the global batch's draw, and this rank's rows of it
        x_T = x_T_fn(batch_idx, (b * world, side // 4, side // 4, 3))[rank::world]
        imgs = sample(model, batch, x_T=x_T,
                      generator=eta_gen.manual_seed((int(seed) << 32) + batch_idx))
        # the PNG quantisation ((x+1)*127.5, truncated) on the device
        imgs_u8 = ((imgs + 1.0) * 127.5).to(torch.uint8)
        if on_card:
            host_u8 = torch.empty(imgs_u8.shape, dtype=torch.uint8, pin_memory=True)
            host_u8.copy_(imgs_u8, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host_u8, ready = imgs_u8, None
        segs = np.argmax(ldm_batch["segmentation"], axis=-1).astype(np.uint8)
        laps.lap("sample")
        if pending is not None:
            flush(pending)
        pending = (host_u8, ready, segs, indices, valid, batch_idx)
        first_pairs = first_pairs or int(valid.sum())
        n_pairs += int(valid.sum())
    if pending is not None:
        flush(pending)
    dist.barrier()   # every rank's pairs are on disk when any rank returns
    return {"pairs": n_pairs, "setup_s": setup_s, **laps.summary(first_pairs),
            "predict_dir": str(predict_dir)}


if __name__ == "__main__":
    main(sys.argv[1:])
