"""The flagship's structure (built on the meta device, no memory) and the
entry points' device rule: cuda unless the caller asks for another device."""

import pytest
import torch
import _port_helpers  # noqa: F401  (caps torch threads)

from stedm_tpu_torch import predict_diff, resolve_device, train_ae, train_diff
from stedm_tpu_torch.core.ddim import DDIMParams
from stedm_tpu_torch.models.stedm import build_flagship
from stedm_tpu_torch.train.steps import SamplerConfig, make_sample_fn


def _count(module):
    return sum(p.numel() for p in module.parameters())


def test_flagship_parameter_counts():
    model, batch, schedule = build_flagship(device="meta")
    # README.md:67: the reference's U-Net and VQ-f4 codec
    assert _count(model.unet) == 234_635_139
    assert _count(model.first_stage) == 55_322_782
    assert _count(model.cond_stage) == 6
    assert batch["segmentation"].shape == (8, 256, 256, 2)
    assert batch["style_imgs"].shape == (8, 1, 256, 256, 3)
    assert DDIMParams.create(schedule, 50).num_steps == 50


def test_flagship_bumps_every_4d_parameter():
    """The +0.005 bump of bench.py:223-225 reaches the zero-init output convs."""
    model, _, _ = build_flagship(batch=1, device="meta")
    four_d = [n for n, p in model.named_parameters() if p.dim() == 4]
    assert "unet.out.2.weight" in four_d
    assert "unet.output_blocks.0.0.out_layers.3.weight" in four_d


def test_ragged_ddim_stride_is_kept():
    _, _, schedule = build_flagship(batch=1, device="meta")
    assert DDIMParams.create(schedule, 128).num_steps == 143


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_flagship()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    model, _, schedule = build_flagship(batch=1, device="meta")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sample_fn(model, schedule, SamplerConfig(ddim_steps=50))
    # the train, predict and codec fine-tuning entry points: no CPU path
    # unless asked for
    for main in (train_diff.main, predict_diff.main, train_ae.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


def test_explicit_device_is_honoured():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("meta")).type == "meta"
