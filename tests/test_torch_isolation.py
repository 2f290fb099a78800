"""The port stands alone: it imports neither JAX/Flax nor the JAX package,
for sampling (the serving mode too), for diffusion training, for codec
fine-tuning, through the train and predict entry points and for downstream
segmentation (with every import of JAX blocked)."""

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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "stedm_tpu"))
print("LOADED", bad)
"""


def test_import_and_forward_load_no_jax(tmp_path):
    from _flowers_helpers import run_overrides, write_flowers_tree

    overrides = run_overrides(write_flowers_tree(tmp_path / "data"), tmp_path / "results")
    unanno = str(list(range(3, 102))).replace(" ", "")
    seg_overrides = overrides[-2:] + [
        "data.patch_size=32", "data.samples=4", "data.batch_size=2",
        "data.class_train_samples=2", "num_epochs=1", "location=pc",
        "compute_dtype=float32", "data.dataset.flowers_anno.train_classes=[0,1,2]",
        f"data.dataset.flowers_anno.unanno_classes={unanno}"]
    head = (f"OVERRIDES = {overrides!r}\nRUN = 'diff_flowers_augmented_mean'\n"
            f"SEG_OVERRIDES = {seg_overrides!r}\n")
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
