"""The port stands alone: it imports neither JAX/Flax nor the JAX package,
for sampling (the serving mode too), for diffusion training, for codec
fine-tuning, through the train and predict entry points (PLMS, DPM-Solver,
a tiled canvas, the set-ViT and a warm start included), for downstream
segmentation, and on the histopathology data path (the host library, the
WSI reader chain, the HER2 data module) and ``train_ae.main``, and as a
rank of a gloo group (``parallel/``) with the worker-process loader
(``data/worker_loader.py``), whose worker process reports its own modules
(with every import of JAX blocked in the parent)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "stedm_tpu_torch"
FORBIDDEN = ("jax", "flax", "stedm_tpu")

_PROBE = """
import sys, torch
torch.set_num_threads(2)


class _Blocked:
    \"\"\"Refuse every import of JAX, Flax or the JAX package.\"\"\"

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "stedm_tpu"):
            raise ImportError(f"blocked: {name}")


sys.meta_path.insert(0, _Blocked())
from stedm_tpu_torch.models.vq import VQModelInterface
from stedm_tpu_torch.models.unet import UNet
from stedm_tpu_torch.train import steps
vq = VQModelInterface(n_embed=16, ddconfig=dict(ch=32, ch_mult=[1, 2], num_res_blocks=1,
                                                resolution=16, z_channels=3)).eval()
unet = UNet(model_channels=32, channel_mult=(1, 2), num_res_blocks=1).eval()
with torch.no_grad():
    img = vq.decode(torch.randn(1, 8, 8, 3))
    eps = unet(torch.randn(1, 6, 8, 8), torch.tensor([10]), torch.randn(1, 512))
assert img.shape == (1, 16, 16, 3) and eps.shape == (1, 3, 8, 8)
# the serving mode: the U-Net's cache out and in, and its sampler modules
from stedm_tpu_torch.core import cache_schedule
from stedm_tpu_torch.train import calibrate, host_sampler
with torch.no_grad():
    _, cache = unet(torch.randn(1, 6, 8, 8), torch.tensor([10]), torch.randn(2, 512),
                    return_cache=True)
    eps = unet(torch.randn(1, 6, 8, 8), torch.tensor([10]), cache=cache)
assert cache.shape == (2, 64, 8, 8) and eps.shape == (2, 3, 8, 8)
# the training slice: its modules import, and a backward runs through the
# GroupNorm and flash-attention Functions (their plain versions on the CPU)
from stedm_tpu_torch.core import diffusion
from stedm_tpu_torch.train import ema, optim
net = UNet(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, attn_impl="flash",
           use_checkpoint=True)
for layer in net.zero_init_layers():
    layer.reset_parameters()
net(torch.randn(1, 6, 8, 8), torch.tensor([10]), torch.randn(1, 512)).square().mean().backward()
assert all(float(p.grad.abs().max()) > 0 for n, p in net.named_parameters() if "qkv" in n)
# codec fine-tuning: one generator + discriminator step of a tiny VQ codec
# with LPIPS, through the entry module
from stedm_tpu_torch import train_ae
from stedm_tpu_torch.models.lpips import LPIPS
from stedm_tpu_torch.train import ae_steps, vae_losses
codec, variant = train_ae.build_codec({"target": "VQModelInterface", "params": dict(
    embed_dim=3, n_embed=16, ddconfig=dict(ch=32, ch_mult=[1, 2], num_res_blocks=1,
                                           resolution=16, z_channels=3))})
cfg = vae_losses.VAELossConfig(disc_ndf=8, disc_num_layers=1)
state = ae_steps.create_ae_state(codec, vae_losses.build_discriminator(cfg),
                                 *ae_steps.ae_optimizers(1e-4))
step = ae_steps.make_ae_train_step(codec, cfg, lpips=LPIPS(), variant=variant, device="cpu")
state, log, rec = step(state, torch.rand(1, 16, 16, 3) * 2 - 1)
assert rec.shape == (1, 16, 16, 3) and bool(torch.isfinite(log["train/total_loss"]))
# the entry points: config composition, the Flowers data pipeline, the
# train loop with its checkpoint and event log, predict writing PNG pairs
from stedm_tpu_torch import predict_diff, train_diff
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.data import dm, flowers, prefetch
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.utils import logging
run = train_diff.main(OVERRIDES, device="cpu")
assert run["step"] == 2 and checkpoints.load(run["run_dir"] + "/ckpt/" + RUN + "_last")
out = predict_diff.main(OVERRIDES + ["data.samples=1", "ddim_steps=2"], device="cpu")
assert out["pairs"] == 2
# the rest of the generation workflow: PLMS, DPM-Solver, a tiled canvas,
# the set-ViT style encoder and a first-stage warm start
from stedm_tpu_torch.core import dpm_solver, plms
from stedm_tpu_torch.models import svit
from stedm_tpu_torch.ops import tiled
for extra in (["sampler=plms"], ["sampler=dpm"],
              ["+canvas_size=64", "data.samples=2", "data.batch_size=4"]):
    out = predict_diff.main(OVERRIDES + ["data.samples=1", "ddim_steps=4"] + extra,
                            device="cpu")
    assert out["pairs"] >= 1
results = run["run_dir"].rsplit("/", 1)[0]
checkpoints.save(results + "/fs", checkpoints.load(run["run_dir"] + "/ckpt/" + RUN + "_last")[
    "params"], name="params")
run = train_diff.main(OVERRIDES + ["style_agg=svit",
                                   "diffusion.first_stage_config.params.ckpt_path=fs/params.pt"],
                      device="cpu")
assert run["step"] == 2 and run["warm_start"]["first_stage"][1] == 0
# downstream segmentation: the MiT-B2 U-Net, its bridge and importer, the
# losses and confusion matrices, the steps and the entry point
from stedm_tpu_torch import train_seg
from stedm_tpu_torch.models.segformer import SegUNet
from stedm_tpu_torch.train import seg_steps
from stedm_tpu_torch.utils import metrics, weights
seg = SegUNet(decoder_channels=(16, 8, 8, 8, 8), encoder_config=dict(
    embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4)))
seg_state = seg_steps.create_seg_state(seg, seg_steps.make_seg_optimizer(1e-4))
seg_state, seg_out = seg_steps.make_seg_train_step(seg, num_classes=2, overlap=1,
                                                   device="cpu")(
    seg_state, torch.randn(2, 32, 32, 3), torch.randint(0, 2, (2, 32, 32)))
seg_eval = seg_steps.make_seg_eval_step(seg, num_classes=2, num_inst=3, overlap=1,
                                        device="cpu")(
    torch.randn(2, 32, 32, 3), torch.randint(0, 2, (2, 32, 32)), torch.zeros(2),
    torch.zeros(2), torch.tensor([0, 2]))
assert float(seg_out["cm"].sum()) == 2 * 30 * 30 and float(seg_eval["inst_cm"].sum()) == 1800
run = train_seg.main(SEG_OVERRIDES, device="cpu")
assert run["step"] == 2 and set(run["tests"]) == {"last", "best"}
# histopathology: the host library (built with g++), the WSI reader chain,
# the HER2 data module with its batches, and codec fine-tuning's entry point
import numpy as np
from stedm_tpu_torch import native
from stedm_tpu_torch.data import catch, her2, native_pipeline, prep, wsi
from stedm_tpu_torch.utils import patch_handler
value, strength = prep.consensus_stack(np.zeros((3, 8, 8), np.uint8))
assert value.shape == strength.shape == (8, 8)
her2_dm = dm.DataModule(compose("config_diff", HER2_OVERRIDES))
her2_dm.prepare_data()
her2_dm.setup()
img, one_hot, seg, style = next(iter(her2_dm.train_loader()))[:4]
assert img.shape == (2, 32, 32, 3) and one_hot.shape == (2, 32, 32, 6)
run = train_ae.main(AE_OVERRIDES, device="cpu")
assert run["step"] == 2 and run["epochs"][0]["val"]
# several processes: a rank of a gloo group (torchrun's variables) and the
# worker-process loader; a worker process reads a HER2 item and lists the
# modules it holds
import os
from stedm_tpu_torch import parallel
from stedm_tpu_torch.data import worker_loader
os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                  MASTER_PORT=PORT)
assert parallel.maybe_initialize_distributed("cpu") == torch.device("cpu")
assert torch.distributed.get_backend() == "gloo" and parallel.world_size() == 1
run = train_diff.main(OVERRIDES + ["location.loader=grain", "location.n_workers=1",
                                   "num_epochs=2", "+resume=true"], device="cpu")
assert run["step"] == 4
sys.path.insert(0, PROBE_DIR)
from probe_ds import Modules
loader = worker_loader.WorkerLoader(Modules(her2_dm.train_loader().dataset), 1, num_workers=1)
(worker_bad,), item = next(iter(loader))[-1], next(iter(loader))[:-1]
assert worker_bad == "" and item[0].shape == (1, 32, 32, 3), worker_bad
loader.close()
torch.distributed.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "stedm_tpu"))
print("LOADED", bad)
"""


_PROBE_DS = """
import sys
import numpy as np


class Modules:
    \"\"\"A dataset's items and, last, the JAX modules of the process that
    reads them (empty: none).\"\"\"

    def __init__(self, inner):
        self.inner = inner

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, idx, rng=None):
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "stedm_tpu"))
        item = self.inner.__getitem__(idx, rng=rng or np.random.default_rng(0))
        return (*item, ",".join(bad))
"""


def _free_port() -> str:
    import socket

    try:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return str(s.getsockname()[1])
    except OSError:
        pytest.skip("cannot bind a localhost port in this sandbox")


def test_import_and_forward_load_no_jax(tmp_path):
    from _flowers_helpers import run_overrides, write_flowers_tree
    from _her2_helpers import HER2_OVERRIDES, write_her2_tree

    overrides = run_overrides(write_flowers_tree(tmp_path / "data"), tmp_path / "results")
    unanno = str(list(range(3, 102))).replace(" ", "")
    seg_overrides = overrides[-2:] + [
        "data.patch_size=32", "data.samples=4", "data.batch_size=2",
        "data.class_train_samples=2", "num_epochs=1", "location=pc",
        "compute_dtype=float32", "data.dataset.flowers_anno.train_classes=[0,1,2]",
        f"data.dataset.flowers_anno.unanno_classes={unanno}"]
    her2_tree = write_her2_tree(tmp_path / "her2")
    her2_overrides = HER2_OVERRIDES + ["style_sampling=nearby", f"location.data_dir={her2_tree}",
                                       f"location.result_dir={tmp_path / 'results'}"]
    ae_overrides = her2_overrides + [
        "data.samples=4", "num_epochs=1", "diffusion.compute_dtype=float32",
        "diffusion.first_stage_config.params.ddconfig.ch=32",
        "diffusion.first_stage_config.params.ddconfig.ch_mult=[1,2]",
        "diffusion.first_stage_config.params.ddconfig.num_res_blocks=1",
        "diffusion.first_stage_config.params.n_embed=64", "loss.disc_ndf=8",
        "loss.disc_num_layers=1"]
    (tmp_path / "probe_ds.py").write_text(_PROBE_DS)
    head = (f"OVERRIDES = {overrides!r}\nRUN = 'diff_flowers_augmented_mean'\n"
            f"PORT = '{_free_port()}'\nPROBE_DIR = {str(tmp_path)!r}\n"
            f"SEG_OVERRIDES = {seg_overrides!r}\nHER2_OVERRIDES = {her2_overrides!r}\n"
            f"AE_OVERRIDES = {ae_overrides!r}\n")
    out = subprocess.run([sys.executable, "-c", head + _PROBE], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"
