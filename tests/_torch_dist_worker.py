"""Subprocess worker for tests/test_torch_distributed.py.

Runs the port's four entry points at tiny widths on the CPU as ONE process:
a rank of a gloo group when torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) are set, else a plain
one-process run. The local batch is the global batch over the world size,
so both kinds of run see the same global batches:

* ``train_diff``: 4 micro-steps at accumulation 2 (2 updates: after the
  first, the zero-initialised output layers pass gradients on), ``scale_by_std`` on;
* ``train_ae``: a tiny VQ codec, 2 steps with the GAN live from step 0;
* ``train_seg``: a tiny SegUNet, 1 epoch (train, val, test);
* ``predict_diff``: 4 pairs at a global batch of 6 (a ragged last batch),
  written under ``syn_data/<result_dir's name>``.

Invoked as ``python _torch_dist_worker.py <data_dir> <result_dir> <out.json>``;
writes the entry points' returned numbers to ``out.json``, with the message
of ``predict_diff``'s ``+host_loop=true`` refusal on a rank (None on one
process, where it is not tried). No JAX here.
"""

import json
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from stedm_tpu_torch import predict_diff, train_ae, train_diff, train_seg  # noqa: E402
from stedm_tpu_torch.models.segformer import SegUNet  # noqa: E402
from stedm_tpu_torch.parallel import dist  # noqa: E402

_UNANNO = str(list(range(3, 102))).replace(" ", "")
GLOBAL_BATCH, PREDICT_BATCH = 4, 6
CLASSES = ["data.dataset.flowers_anno.train_classes=[0,1,2]",
           f"data.dataset.flowers_anno.unanno_classes={_UNANNO}"]
DIFF = [
    "data.patch_size=32", "data.samples=4", "data.class_train_samples=2",
    "num_epochs=1", "lr=1e-4", "location=pc", "style_sampling=augmented", "style_agg=mean",
    "diffusion.compute_dtype=float32", "diffusion.unet_config.params.model_channels=32",
    "diffusion.unet_config.params.num_res_blocks=1",
    "diffusion.unet_config.params.channel_mult=[1,2]",
    "diffusion.unet_config.params.num_heads=4",
    "diffusion.first_stage_config.params.ddconfig.ch=32",
    "diffusion.first_stage_config.params.ddconfig.num_res_blocks=1",
    "diffusion.first_stage_config.params.n_embed=64",
    "data/dataset=[flowers_anno,flowers_unanno]", "data.ratios=[1.0,1.0]",
    "data.dataset.flowers_unanno.train_classes=[0,1,2]",
    f"data.dataset.flowers_unanno.unanno_classes={_UNANNO}", *CLASSES]
TRAIN_DIFF = DIFF + ["data.samples=16", "accumulate_grad_batches=2",
                     "+diffusion.scale_by_std=true"]
PREDICT = DIFF + ["data.samples=2", "ddim_steps=4", "+host_loop=false"]
AE = [
    "data=flowers", "data.patch_size=32", "data.samples=8", "data.class_train_samples=2",
    "num_epochs=1", "lr=1e-4", "location=pc", "diffusion.compute_dtype=float32",
    "style_sampling=augmented",
    "data/dataset=[flowers_anno,flowers_unanno]", "data.ratios=[1.0,1.0]",
    "data.dataset.flowers_unanno.train_classes=[0,1,2]",
    f"data.dataset.flowers_unanno.unanno_classes={_UNANNO}",
    "diffusion.first_stage_config.params.ddconfig.ch=32",
    "diffusion.first_stage_config.params.ddconfig.ch_mult=[1,2]",
    "diffusion.first_stage_config.params.ddconfig.num_res_blocks=1",
    "diffusion.first_stage_config.params.n_embed=64", "loss.disc_ndf=8",
    "loss.disc_num_layers=1", "loss.disc_start=0", *CLASSES]
SEG = [
    "data.patch_size=32", "data.samples=10", "data.class_train_samples=2", "num_epochs=1",
    "lr=1e-4", "location=pc", "accumulate_grad_batches=2", "compute_dtype=float32",
    "data/dataset=[flowers_anno,flowers_syn]", "data.ratios=[0.2,0.8]",
    "data.overlap_train=2", "data.overlap_val=2", *CLASSES]


def tiny_seg(cfg, device=None, seed: int = 0) -> SegUNet:
    """A narrow SegUNet (tests/test_torch_isolation.py's widths), fp32."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return SegUNet(classes=2, dtype=torch.float32, decoder_channels=(16, 8, 8, 8, 8),
                       encoder_config=dict(embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
                                           num_heads=(1, 2, 3, 4))).to(device)


def main(data: str, results: str, out: str) -> None:
    dev = dist.maybe_initialize_distributed(torch.device("cpu"))
    world = dist.world_size()
    where = [f"location.data_dir={data}", f"location.result_dir={results}",
             f"location.mesh.data={world if world > 1 else 1}"]

    def local(n):
        return f"data.batch_size={n // world}"

    train_seg.build_seg_model = tiny_seg
    got = {"world": world, "rank": dist.rank(), "host_loop_refusal": None}
    got["diff"] = train_diff.main(TRAIN_DIFF + where + [local(GLOBAL_BATCH)], device=dev)
    got["ae"] = train_ae.main(AE + where + [local(GLOBAL_BATCH)], device=dev)
    got["seg"] = train_seg.main(SEG + where + [local(GLOBAL_BATCH)], device=dev)
    got["predict"] = predict_diff.main(
        PREDICT + where + [local(PREDICT_BATCH), f"+predict_name={Path(results).name}"],
        device=dev)
    if world > 1:
        try:
            predict_diff.main(PREDICT + where + [local(PREDICT_BATCH), "+host_loop=true",
                                                 "+predict_name=refused"], device=dev)
        except SystemExit as exc:
            got["host_loop_refusal"] = str(exc)
    Path(out).write_text(json.dumps(got, default=lambda x: x.tolist() if hasattr(x, "tolist")
                                    else str(x)))


if __name__ == "__main__":
    main(*sys.argv[1:4])
