"""The port's segmentation entry point over the histopathology data, on the
CPU, against the JAX package's train_seg.main on the miniature trees of
tests/_her2_helpers.py, tiny SegUNets by monkeypatch, fp32, 64^2 patches at
base scale 1:

* ``train_seg.main data=her2`` (her2_anno 0.2 + her2_syn 0.8): every logged
  number, the patient IoU over val patches with non-zero cut margins
  included, within the tolerances of tests/test_torch_seg_entry.py;
* ``train_seg.main data=catch``: the subtype IoU of ``eval_subtypes``,
  which the JAX entry point never computes (ROADMAP §3), against JAX's run
  given the same repair (its ``_epoch_metrics`` handed the subtype names and
  the patients of its own data module).

JAX's ConcatDataset is given the port's generator hand-over (ROADMAP §3),
as in test_torch_seg_entry.py; the JAX package's files stay as they are."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _port_helpers  # noqa: F401  (caps torch threads)
from _port_helpers import jax_init, quick_compile
from _her2_helpers import CATCH_OVERRIDES, HER2_OVERRIDES, write_catch_tree, write_her2_tree
from _her2_helpers import write_syn_folder
from test_torch_seg_entry import LOSS_RTOL, METRIC_ATOL
from test_torch_seg_model import DEC, ENC

import stedm_tpu.data.loader as jloader
from stedm_tpu.data.dm import DataModule as JDataModule
from stedm_tpu.models.segformer import SegUNet as JSegUNet
from stedm_tpu_torch import train_seg
from stedm_tpu_torch.data.loader import ConcatDataset
from stedm_tpu_torch.models.segformer import SegUNet
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.utils.weights import seg_state_dict


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = write_her2_tree(tmp_path_factory.mktemp("her2"))
    write_syn_folder(root, "her2", size=72)
    return root


def _where(data, results):
    return [f"location.data_dir={data}", f"location.result_dir={results}"]


def _events(run_dir):
    return [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]


SEG_BASE = ["data.patch_size=64", "data.base_scale=1", "data.samples=8", "num_epochs=2",
            "lr=1e-4", "accumulate_grad_batches=2", "compute_dtype=float32"]


def _tiny_seg(monkeypatch, jtrain_seg):
    tiny = functools.partial(JSegUNet, decoder_channels=DEC, encoder_config=ENC)
    # JAX's main makes this init again (one quick jit: _port_helpers)
    with quick_compile(), jax_init("jit-memo"):
        init = tiny(classes=2).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), False)
    sd = seg_state_dict(jax.tree_util.tree_map(np.asarray, init["params"]),
                        jax.tree_util.tree_map(np.asarray, init["batch_stats"]))

    def build_tiny(cfg, device=None, seed=0):
        model = SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC).to(device)
        model.load_state_dict(sd, strict=True)
        return model

    monkeypatch.setattr(jtrain_seg, "SegUNet", tiny)
    monkeypatch.setattr(jloader.ConcatDataset, "__getitem__", ConcatDataset.__getitem__)
    monkeypatch.setattr(train_seg, "build_seg_model", build_tiny)


def _same_events(jev, pev):
    assert [sorted(e) for e in pev] == [sorted(e) for e in jev]
    assert [e["step"] for e in pev] == [e["step"] for e in jev]
    for je, pe in zip(jev, pev):
        for key, want in je.items():
            if key in ("ts", "epoch_time_s", "step", "epoch"):
                continue
            tol = dict(rtol=LOSS_RTOL) if "Loss" in key else dict(rtol=0, atol=METRIC_ATOL)
            np.testing.assert_allclose(pe[key], want, err_msg=key, **tol)


def test_train_seg_her2_matches_jax(tree, tmp_path, monkeypatch):
    import train_seg as jtrain_seg

    _tiny_seg(monkeypatch, jtrain_seg)
    args = HER2_OVERRIDES + SEG_BASE + ["data/dataset=[her2_anno,her2_syn]",
                                        "data.ratios=[0.2,0.8]", "style_sampling=none"]
    with quick_compile(), jax_init("jit-memo"):
        jtrain_seg.main(args + _where(tree, tmp_path / "jax"))
    out = train_seg.main(args + _where(tree, tmp_path / "port"), device="cpu")
    run = "seg_her2_syn"
    jev, pev = _events(tmp_path / "jax" / run), _events(tmp_path / "port" / run)
    _same_events(jev, pev)
    logged = {k for e in pev for k in e}
    for key in ("Val Patient IoU Score", "Val Patient IoU Var", "Test (last) IoU Score",
                "Test (best) Patient IoU Score"):
        assert key in logged, key
    assert set(out["tests"]) == {"last", "best"}
    for tag in ("last", "best"):
        assert checkpoints.load(tmp_path / "port" / run / "ckpt" / f"{run}_{tag}")["format"] \
            == "seg_state"


def test_train_seg_catch_logs_the_subtype_iou(tmp_path_factory, tmp_path, monkeypatch):
    import train_seg as jtrain_seg

    data = write_catch_tree(tmp_path_factory.mktemp("catch"))
    _tiny_seg(monkeypatch, jtrain_seg)
    # the port's repair handed to JAX's entry point: its _epoch_metrics gets
    # the subtype names and the patients' image list of its own data module
    dms = []

    class RecordedDataModule(JDataModule):
        def __init__(self, cfg):
            super().__init__(cfg)
            dms.append((cfg, self))

    epoch_metrics = jtrain_seg._epoch_metrics

    def with_subtypes(prefix, cm, inst_cms, logger, step, **kw):
        if inst_cms is not None:
            kw.update(train_seg.subtype_args(*dms[-1])["val" if prefix == "Val" else "test"])
        return epoch_metrics(prefix, cm, inst_cms, logger, step, **kw)

    monkeypatch.setattr(jtrain_seg, "DataModule", RecordedDataModule)
    monkeypatch.setattr(jtrain_seg, "_epoch_metrics", with_subtypes)
    args = CATCH_OVERRIDES + SEG_BASE + ["data.overlap_val=8", "style_sampling=none",
                                         "num_epochs=1"]
    with quick_compile(), jax_init("jit-memo"):
        jtrain_seg.main(args + _where(data, tmp_path / "jax"))
    out = train_seg.main(args + _where(data, tmp_path / "port"), device="cpu")
    jev, pev = _events(tmp_path / "jax" / "seg_catch"), _events(tmp_path / "port" / "seg_catch")
    _same_events(jev, pev)
    for key in ("Val Subtype IoU Score", "Val Subtype IoU Var", "Test (last) Subtype IoU Score"):
        assert any(key in e for e in pev), key
    val = out["epochs"][0]["val"]
    assert 0.0 <= val["Val Subtype IoU Score"] <= 1.0
    # the val patients, Melanoma_03 and SCC_04, each their own subtype
    assert [t[-1] for t in train_seg.subtype_args(*dms[-1])["val"]["image_list"]] == [2, 3]


