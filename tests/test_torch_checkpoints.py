"""The port's checkpoints (stedm_tpu_torch/train/checkpoints.py): a full
train state round trip, exact, and ``partial_restore`` against the JAX
package's on the same trees, compared through the weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_helpers  # noqa: F401  (caps torch threads)
from _flowers_helpers import CLASS_OVERRIDES, TINY_OVERRIDES
from _port_helpers import random_params

from stedm_tpu.config import compose as jcompose
from stedm_tpu.models.stedm import build_stedm as jbuild_stedm
from stedm_tpu.train.checkpoints import partial_restore as jpartial_restore
from stedm_tpu_torch.config import compose
from stedm_tpu_torch.core.schedules import DiffusionSchedule
from stedm_tpu_torch.models.stedm import build_stedm
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.train.optim import make_optimizer
from stedm_tpu_torch.train.steps import create_train_state, init_logvar, make_train_step
from stedm_tpu_torch.utils import weights

OVERRIDES = TINY_OVERRIDES + CLASS_OVERRIDES + ["diffusion.compute_dtype=float32"]
P = 32


def _state(seed: int):
    model = build_stedm(compose("config_diff", OVERRIDES), device="cpu", seed=seed)
    tx = make_optimizer(1e-3, accumulate_grad_batches=2)
    return create_train_state(model, tx, init_logvar(1000, 0.0, device="cpu")), tx


def _batch(seed: int):
    r = np.random.default_rng(seed)
    seg = np.zeros((2, P, P, 2), np.float32)
    seg[..., 0] = 1.0
    return {"image": r.uniform(-1, 1, (2, P, P, 3)).astype(np.float32), "segmentation": seg,
            "style_imgs": r.uniform(-1, 1, (2, 1, P, P, 3)).astype(np.float32)}


def _assert_same_state(a, b):
    for (na, ta), (nb, tb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert na == nb and torch.equal(ta, tb), na
    assert torch.equal(a.logvar, b.logvar)
    assert a.ema_params.keys() == b.ema_params.keys()
    assert all(torch.equal(a.ema_params[k], b.ema_params[k]) for k in a.ema_params)
    assert (a.step, a.ema_updates) == (b.step, b.ema_updates)
    oa, ob = a.opt_state, b.opt_state
    assert (oa.mini_step, oa.gradient_step) == (ob.mini_step, ob.gradient_step)
    for pa, pb in zip(oa.params, ob.params):
        assert (pa.grad is None) == (pb.grad is None)
        assert pa.grad is None or torch.equal(pa.grad, pb.grad)
        sa, sb = oa.adamw.state[pa], ob.adamw.state[pb]
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_train_state_round_trip_is_exact(tmp_path):
    """Three micro-steps at accumulation 2 (one update applied, one micro-
    batch's gradients pending), saved and restored into a state built from
    other weights: everything equal, and the next step equal too."""
    state, tx = _state(0)
    step = make_train_step(state.model, DiffusionSchedule.create("linear", 1000, 0.0015, 0.0205),
                           tx, learn_logvar=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        state, _ = step(state, _batch(i), gen)
    assert state.opt_state.gradient_step == 1 and state.opt_state.mini_step == 1
    path = checkpoints.save(tmp_path / "ckpt", state, name="run_last")
    assert path.endswith("ckpt/run_last.pt")

    other, other_tx = _state(1)
    restored = checkpoints.restore(tmp_path / "ckpt", other, name="run_last")
    _assert_same_state(state, restored)
    step2 = make_train_step(other.model, DiffusionSchedule.create("linear", 1000, 0.0015, 0.0205),
                            other_tx, learn_logvar=True, device="cpu")
    state, _ = step(state, _batch(3), torch.Generator().manual_seed(9))
    restored, _ = step2(restored, _batch(3), torch.Generator().manual_seed(9))
    _assert_same_state(state, restored)


def test_params_only_files_and_refusals(tmp_path):
    state, _ = _state(0)
    sd = state.model.state_dict()
    path = checkpoints.save(tmp_path, sd, name="params")
    kind, back = weights.read_weight_file(tmp_path / "params")
    assert kind == "port" and back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert checkpoints.load(path)["format"] == "params"
    with pytest.raises(ValueError, match="params-only"):
        checkpoints.restore(tmp_path, state, name="params")
    checkpoints.save(tmp_path, state, name="full")
    with pytest.raises(ValueError, match="full train state"):
        weights.read_weight_file(tmp_path / "full.pt")
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(NotImplementedError, match="reading a JAX orbax directory"):
        checkpoints.load(tmp_path / "orbax_dir")
    with pytest.raises(FileNotFoundError):
        checkpoints.load(tmp_path / "missing")


@pytest.fixture(scope="module")
def trees():
    """Two random JAX parameter trees of the tiny STEDM; the loaded one
    lacks the ``agg`` group and has a cond-stage kernel of another shape."""
    jmodel = jbuild_stedm(jcompose("config_diff", OVERRIDES))
    args = (jnp.zeros((1, P, P, 3)), jnp.zeros((1, P, P, 2)), jnp.zeros((1, 1, P, P, 3)),
            jnp.zeros((1,), jnp.int32))
    params, loaded = (random_params(jmodel, s, *args) for s in (0, 1))
    loaded = {k: v for k, v in loaded.items() if k != "agg"}
    loaded["cond_stage"] = jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape[:-1] + (x.shape[-1] + 1,), np.float32), loaded["cond_stage"])
    return params, loaded


@pytest.mark.parametrize("jax_ignore,port_ignore,only", [
    ([], [], None),
    (["first_stage"], ["first_stage"], None),
    (["time_embed_0", "middle_block_2"], ["time_embed.0", "middle_block.2"], None),
    (["input_blocks_1_0"], ["input_blocks.1.0"], "unet"),
    ([], [], "first_stage"),
], ids=["all", "prefix", "infix", "infix_in_unet", "only_first_stage"])
def test_partial_restore_matches_jax(trees, jax_ignore, port_ignore, only):
    from stedm_tpu_torch.utils.weights import state_dict_from_jax

    params, loaded = trees
    want = state_dict_from_jax(jpartial_restore(params, loaded, ignore_keys=jax_ignore,
                                                only_subtree=only))
    base = state_dict_from_jax(params)
    got = checkpoints.partial_restore(base, state_dict_from_jax(loaded),
                                      ignore_keys=port_ignore, only_subtree=only)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    replaced = sum(not torch.equal(got[k], base[k]) for k in base)
    assert 0 < replaced < len(base)
