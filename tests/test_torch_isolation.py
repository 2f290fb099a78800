"""The port stands alone: it imports neither JAX/Flax nor the JAX package,
for sampling and for training."""

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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "stedm_tpu"))
print("LOADED", bad)
"""


def test_import_and_forward_load_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=PKG.parent,
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
