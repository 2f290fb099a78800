"""Two gloo ranks of the port's entry points against one process at the same
global batch (stedm_tpu_torch/parallel/dist.py), on the CPU.

One module-scoped fixture launches ``tests/_torch_dist_worker.py`` three
times at once: as the two ranks of a torchrun-style group (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and as a
plain process. Each runs ``train_diff`` (4 micro-steps, accumulation 2,
``scale_by_std``), ``train_ae`` (2 steps, the GAN live), ``train_seg`` (1
epoch) and ``predict_diff`` (4 pairs, a ragged last batch) at tiny widths on
``tests/_flowers_helpers.py``'s tree. Each comparison below is a case over
those results.

Tolerances. A run draws, reduces and updates in another order on two ranks
than on one, so fp32 sums differ in their last bits, and Adam turns a
gradient that is rounding noise (a conv bias in front of a GroupNorm, whose
exact gradient is near zero) into a full-size step of either sign. So every
parameter is held within ``2 lr`` per Adam update and the mean over all of
them within ``1e-3 lr``: a rank that trained on its own rows, or on its own
draws, moves most of them by a sizeable fraction of ``lr`` (the
``scale_by_std`` factor within 1e-6 relative, the logged losses within
1e-6). Running statistics (BatchNorm) are held within 1e-6. Confusion
matrices and seg PNGs are equal; images within 1, as
``test_torch_entry.py`` holds the port's predict to JAX's.

The one-process runs are held to JAX by ``test_torch_entry.py`` and
``test_torch_seg_entry.py``, and JAX's two-process runs to its one-process
runs by ``tests/test_distributed.py``. Skipped (not failed) only when a
localhost port cannot be bound."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from _flowers_helpers import write_flowers_tree
from test_torch_seg_entry import write_syn_folder

from stedm_tpu_torch import train_diff
from stedm_tpu_torch.parallel import dist
from stedm_tpu_torch.train import checkpoints

WORKER = Path(__file__).with_name("_torch_dist_worker.py")
LR = 1e-4
RUNS = {"diff": "diff_flowers_augmented_mean", "ae": "ae_flowers", "seg": "seg_flowers_syn"}
UPDATES = {"diff": 2, "ae": 2, "seg": 1}


def _free_port() -> int:
    try:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]
    except OSError:
        pytest.skip("cannot bind a localhost port in this sandbox")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one process, rank 0, rank 1): each one's returned numbers, its result
    directory and the data tree."""
    root = tmp_path_factory.mktemp("dist")
    data = write_flowers_tree(root / "data", n=24, size=40)
    write_syn_folder(data, n=6, size=40)
    port = _free_port()
    procs = []
    for tag, env in (("one", {}),
                     *((f"rank{r}", {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
                                     "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
                       for r in range(2))):
        results = root / ("one" if tag == "one" else "two")
        env = {**{k: v for k, v in os.environ.items() if k not in dist.TORCHRUN_ENV}, **env}
        procs.append((tag, results, subprocess.Popen(
            [sys.executable, str(WORKER), str(data), str(results), str(root / f"{tag}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = {}
    for tag, results, proc in procs:
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        out[tag] = (json.loads((root / f"{tag}.json").read_text()), results)
    return out, data


def _ckpt(results: Path, kind: str) -> dict:
    run = RUNS[kind]
    return checkpoints.load(results / run / "ckpt" / f"{run}_last")


def _close(a: dict, b: dict, updates: int) -> None:
    diffs = {k: (a[k].double() - b[k].double()).abs() for k in a if a[k].is_floating_point()}
    worst = max(diffs, key=lambda k: float(diffs[k].max()))
    assert float(diffs[worst].max()) <= 2 * LR * updates, worst
    n = sum(d.numel() for d in diffs.values())
    assert float(sum(d.sum() for d in diffs.values())) / n <= 1e-3 * LR


@pytest.mark.parametrize("kind", ["diff", "ae", "seg"])
def test_two_ranks_train_the_parameters_of_one(runs, kind):
    """The parameters after training; for train_diff also the EMA shadow,
    for train_ae also the discriminator (its running statistics included)."""
    (one, r1), (two, r2) = runs[0]["one"], runs[0]["rank0"]
    a, b = _ckpt(r1, kind), _ckpt(r2, kind)
    assert a["step"] == b["step"] > 0
    params = {k: v for k, v in a["params"].items() if "running" not in k}
    _close(params, {k: b["params"][k] for k in params}, UPDATES[kind])
    extra = {"diff": "ema", "ae": "disc"}.get(kind)
    if extra:
        _close(a[extra], b[extra], UPDATES[kind])


def test_seg_batchnorm_running_statistics(runs):
    (_, r1), (_, r2) = runs[0]["one"], runs[0]["rank0"]
    a, b = _ckpt(r1, "seg")["params"], _ckpt(r2, "seg")["params"]
    keys = [k for k in a if "running" in k]
    assert keys
    for k in keys:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=1e-6)


def test_ae_discriminator_running_statistics(runs):
    (_, r1), (_, r2) = runs[0]["one"], runs[0]["rank0"]
    a, b = _ckpt(r1, "ae")["disc"], _ckpt(r2, "ae")["disc"]
    keys = [k for k in a if "running" in k]
    assert keys
    for k in keys:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_seg_confusion_matrices_are_equal(runs, split):
    """Summed over ranks, with the wrap-padded rows of val and test left out;
    the IoUs computed from them are equal too."""
    one, two = runs[0]["one"][0]["seg"], runs[0]["rank0"][0]["seg"]
    a, b = one["matrices"][split], two["matrices"][split]
    if split == "test":
        assert set(a) == set(b) == {"last", "best"}
        a, b = list(a.values()), list(b.values())
        assert two["tests"] == one["tests"]
    else:
        assert len(a) == len(b) == 1
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert np.asarray(a).sum() > 0


def test_logged_numbers_agree(runs):
    """The train loss of train_diff and train_seg (averaged over ranks), the
    val loss and metrics of train_seg and train_ae (rank 0 validates alone
    in train_ae), and the scale factor."""
    one, two, other = (runs[0][t][0] for t in ("one", "rank0", "rank1"))
    assert two["diff"]["scale_factor"] == pytest.approx(one["diff"]["scale_factor"], rel=1e-6)
    assert other["diff"]["scale_factor"] == two["diff"]["scale_factor"]
    for kind in ("diff", "seg"):
        assert two[kind]["epochs"][0]["loss"] == pytest.approx(
            one[kind]["epochs"][0]["loss"], rel=1e-6)
    assert two["seg"]["epochs"][0]["val"] == pytest.approx(one["seg"]["epochs"][0]["val"],
                                                           rel=1e-6)
    assert two["ae"]["epochs"][0]["val"] == pytest.approx(one["ae"]["epochs"][0]["val"],
                                                          rel=1e-6)
    assert other["ae"]["epochs"][0]["val"] == {}


def test_predict_pairs_equal_one_process(runs):
    """4 layouts at a global batch of 6: one ragged batch; each rank writes
    its own 2 pairs, and together they are the one process's 4."""
    (one, _), (two, _), (other, _) = (runs[0][t] for t in ("one", "rank0", "rank1"))
    data = runs[1]
    assert one["predict"]["pairs"] == 4 and two["predict"]["pairs"] == other["predict"]["pairs"] == 2
    want, got = data / "syn_data" / "one", data / "syn_data" / "two"
    names = sorted(p.name for p in want.glob("*.png"))
    assert len(names) == 8 and names == sorted(p.name for p in got.glob("*.png"))
    for name in names:
        a, b = np.array(Image.open(want / name)), np.array(Image.open(got / name))
        if name.startswith("seg"):
            np.testing.assert_array_equal(b, a)
        else:
            assert a.std() > 0 and np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_host_loop_true_is_refused_across_ranks(runs):
    for tag in ("rank0", "rank1"):
        assert "+host_loop=true requires a single device and a single process" in \
            runs[0][tag][0]["host_loop_refusal"]
    assert runs[0]["one"][0]["host_loop_refusal"] is None


def test_a_model_axis_is_refused(tmp_path):
    from _flowers_helpers import run_overrides

    with pytest.raises(NotImplementedError, match="model axis of sharding_rules.py"):
        train_diff.main(run_overrides(tmp_path, tmp_path) + ["+location.mesh.model=2"],
                        device="cpu")


def test_local_batch_size_refuses_an_uneven_split(monkeypatch):
    assert dist.local_batch_size(6) == 6
    monkeypatch.setattr(dist, "world_size", lambda: 4)
    assert dist.local_batch_size(8) == 2
    with pytest.raises(ValueError, match="global batch 6 not divisible by 4 processes"):
        dist.local_batch_size(6)
