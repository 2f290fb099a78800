"""The port's segmentation entry point (stedm_tpu_torch/train_seg.py) against the
JAX package's train_seg.main on a tiny Flowers tree (tests/_flowers_helpers.py)
plus a synthetic ``flowers_syn`` folder, README's mix (flowers_anno 0.2,
flowers_syn 0.8), two epochs at accumulation 2, fp32 on the CPU.

Both runs get the same weights: JAX's main initialises a tiny SegUNet from its
seed, and the port's builds the same net and loads that init through
``seg_state_dict``. Both get the same batches: JAX's ConcatDataset hands no
generator on to its datasets (ROADMAP §3), so for this test it is given the
port's repair, which the JAX Loader then uses; the JAX package's files stay as
they are.

Tolerances: the logged losses within 1e-4 relative (4e-5 measured); every
IoU and variance within 1e-3 absolute: after Adam's first updates a
parameter whose gradient is near zero differs by up to 2 lr, and a pixel
whose two logits nearly tie flips its argmax (7e-5 measured, about one pixel
of a split); the same keys logged at the same steps; both checkpoints
written. ``_epoch_metrics`` on the same matrices gives JAX's numbers exactly,
its subtype branch included. Then every refusal."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import _port_helpers  # noqa: F401  (caps torch threads)
from _port_helpers import check_grain_loader, jax_init, quick_compile
from _flowers_helpers import write_flowers_tree
from test_torch_seg_model import DEC, ENC

import stedm_tpu.data.loader as jloader
from stedm_tpu.models.segformer import SegUNet as JSegUNet
from stedm_tpu_torch import train_seg
from stedm_tpu_torch.data.loader import ConcatDataset
from stedm_tpu_torch.models.segformer import SegUNet
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.utils.weights import seg_state_dict

PATCH, RUN = 64, "seg_flowers_syn"
_UNANNO = str(list(range(3, 102))).replace(" ", "")
OVERRIDES = [
    f"data.patch_size={PATCH}", "data.samples=10", "data.batch_size=2",
    "data.class_train_samples=2", "num_epochs=2", "lr=1e-4", "location=pc",
    "accumulate_grad_batches=2", "compute_dtype=float32",
    "data/dataset=[flowers_anno,flowers_syn]", "data.ratios=[0.2,0.8]",
    "data.dataset.flowers_anno.train_classes=[0,1,2]",
    f"data.dataset.flowers_anno.unanno_classes={_UNANNO}",
]
LOSS_RTOL, METRIC_ATOL = 1e-4, 1e-3


def write_syn_folder(data, n: int = 6, size: int = 72) -> None:
    """``syn_data/flowers``: img/seg PNG pairs as predict_diff writes them."""
    folder = data / "syn_data" / "flowers"
    folder.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(n):
        img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        seg = np.zeros((size, size), np.uint8)
        y, x = rng.integers(8, size // 2, 2)
        seg[y:y + size // 3, x:x + size // 3] = 1
        Image.fromarray(img).save(folder / f"img_{i:05d}.png")
        Image.fromarray(seg).save(folder / f"seg_{i:05d}.png")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = write_flowers_tree(tmp_path_factory.mktemp("data"), n=24, size=72)
    write_syn_folder(root)
    return root


def _where(data, results):
    return [f"location.data_dir={data}", f"location.result_dir={results}"]


def _events(run_dir):
    return [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]


def test_train_seg_main_matches_jax(data, tmp_path, monkeypatch):
    import train_seg as jtrain_seg

    tiny = functools.partial(JSegUNet, decoder_channels=DEC, encoder_config=ENC)
    # JAX's main makes this init again (one quick jit: _port_helpers)
    with quick_compile(), jax_init("jit-memo"):
        init = tiny(classes=2).init(jax.random.PRNGKey(0), jnp.zeros((1, PATCH, PATCH, 3)),
                                    False)
    sd = seg_state_dict(jax.tree_util.tree_map(np.asarray, init["params"]),
                        jax.tree_util.tree_map(np.asarray, init["batch_stats"]))

    def build_tiny(cfg, device=None, seed=0):
        model = SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC).to(device)
        model.load_state_dict(sd, strict=True)
        return model

    monkeypatch.setattr(jtrain_seg, "SegUNet", tiny)
    monkeypatch.setattr(jloader.ConcatDataset, "__getitem__", ConcatDataset.__getitem__)
    monkeypatch.setattr(train_seg, "build_seg_model", build_tiny)
    with quick_compile(), jax_init("jit-memo"):
        jtrain_seg.main(OVERRIDES + _where(data, tmp_path / "jax"))
    out = train_seg.main(OVERRIDES + _where(data, tmp_path / "port"), device="cpu")

    assert [e["micro_steps"] for e in out["epochs"]] == [5, 5] and out["step"] == 10
    jev, pev = _events(tmp_path / "jax" / RUN), _events(tmp_path / "port" / RUN)
    assert [sorted(e) for e in pev] == [sorted(e) for e in jev]
    assert [e["step"] for e in pev] == [e["step"] for e in jev]
    for je, pe in zip(jev, pev):
        for key, want in je.items():
            if key in ("ts", "epoch_time_s", "step", "epoch"):
                continue
            tol = dict(rtol=LOSS_RTOL) if "Loss" in key else dict(rtol=0, atol=METRIC_ATOL)
            np.testing.assert_allclose(pe[key], want, err_msg=key, **tol)
    logged = {k for e in pev for k in e}
    for key in ("Train Loss", "Train IoU Score", "Val Loss", "Val IoU Score",
                "Val Patient IoU Score", "Test (last) IoU Score", "Test (best) IoU Score"):
        assert key in logged, key
    for e in pev:
        for key, v in e.items():
            if "IoU Score" in key:
                assert 0.0 <= v <= 1.0, (key, v)
    ckpt = tmp_path / "port" / RUN / "ckpt"
    for tag in ("last", "best"):
        assert (tmp_path / "jax" / RUN / "ckpt" / f"{RUN}_{tag}").is_dir()
        assert checkpoints.load(ckpt / f"{RUN}_{tag}")["format"] == "seg_state"
    assert checkpoints.load(ckpt / f"{RUN}_last")["step"] == 10
    assert set(out["tests"]) == {"last", "best"}
    assert sorted(p.name for p in (tmp_path / "port" / RUN).glob("*_cm_*.png")) == \
        sorted(p.name for p in (tmp_path / "jax" / RUN).glob("*_cm_*.png"))


class _Logger:
    def __init__(self, run_dir):
        self.run_dir, self.records = run_dir, []

    def log(self, metrics, step=None):
        self.records.append((step, dict(metrics)))


@pytest.mark.parametrize("with_inst", [False, True], ids=["train", "eval"])
def test_epoch_metrics_equal_jax(with_inst, tmp_path):
    """The same confusion matrices through both ``_epoch_metrics``: equal
    numbers, the subtype IoU grouped by ``name_idx`` included, and the same
    figure files."""
    import train_seg as jtrain_seg

    rng = np.random.default_rng(2)
    cm = rng.integers(0, 500, (4, 4)).astype(float)
    inst = rng.integers(0, 50, (5, 4, 4)).astype(float) if with_inst else None
    if with_inst:
        inst[3] = 0.0       # an instance without pixels is left out
    kw = dict(subtype_names=["BG", "A", "B", "C"],
              image_list=[("x_A_1",), ("x_B_2",), ("x_A_3",), ("x_C_4",), ("x_B_5",)],
              name_idx=0, class_names=["BG", "A", "B", "C"])
    out = {}
    for name, fn in (("jax", jtrain_seg._epoch_metrics), ("port", train_seg._epoch_metrics)):
        (tmp_path / name).mkdir()
        logger = _Logger(tmp_path / name)
        out[name] = fn("Val", cm, inst, logger, 7, **kw)
        assert logger.records == [(7, out[name])]
    assert out["port"] == out["jax"]
    assert ("Val Subtype IoU Score" in out["port"]) == with_inst
    assert [p.name for p in (tmp_path / "port").iterdir()] == ["val_cm_7.png"]
    assert [p.name for p in (tmp_path / "jax").iterdir()] == ["val_cm_7.png"]


def test_train_seg_main_loads_a_mit_encoder(data, tmp_path, monkeypatch, capsys):
    """``+encoder_ckpt=``: a synthetic NVlabs-layout file loads into the
    encoder of the built net (the importer itself: test_torch_seg_model.py)."""
    from test_torch_seg_model import _nvlabs_state_dict

    path = tmp_path / "mit.pth"
    torch.save({"_model.encoder." + k: v for k, v in _nvlabs_state_dict(1, ENC).items()}, path)
    built = {}

    def build_tiny(cfg, device=None, seed=0):
        built["model"] = SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC)
        return built["model"]

    monkeypatch.setattr(train_seg, "build_seg_model", build_tiny)
    args = OVERRIDES + _where(data, tmp_path) + ["num_epochs=1", f"+encoder_ckpt={path}",
                                                 "run_name=mit"]
    out = train_seg.main(args, device="cpu")
    n_enc = sum(1 for _ in built["model"].encoder.parameters())
    assert f"merged {n_enc} tensors" in capsys.readouterr().out
    assert np.isfinite(out["epochs"][0]["loss"]) and out["run_dir"].endswith("/mit")


@pytest.mark.parametrize("args,error,match", [
    ([], RuntimeError, "no CUDA device"),
    # HER2 and CATCH are ported; a tree that is not staged refuses the EXACT pull
    (["data=her2"], NotImplementedError, "EXACT server.*ROADMAP §1: the pull from an EXACT server"),
    (["data=catch"], NotImplementedError, "EXACT server.*ROADMAP §1: the pull from an EXACT server"),
    # once refused: the worker-process loader (error None)
    (["+location.loader=grain", "location.n_workers=2"], None, None),
    (["location.mesh.data=2"], NotImplementedError, "torch.distributed"),
], ids=["no_card", "her2", "catch", "grain", "mesh"])
def test_refusals(args, error, match, tmp_path, data):
    if error is None:
        from stedm_tpu_torch.config import compose
        from stedm_tpu_torch.data.dm import DataModule

        dm = DataModule(compose("config_seg", OVERRIDES + _where(data, tmp_path) + args))
        dm.prepare_data()
        dm.setup()
        check_grain_loader(dm)
        return
    device = None if error is RuntimeError else "cpu"
    if torch.cuda.is_available() and device is None:
        pytest.skip("a card is present")
    with pytest.raises(error, match=match):
        train_seg.main([f"location.result_dir={tmp_path}",
                        f"location.data_dir={tmp_path / 'data'}"] + args, device=device)
    assert not any(tmp_path.iterdir())


def test_refuses_several_processes(tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        train_seg.main([f"location.result_dir={tmp_path}"], device="cpu")
