"""The port's segmentation train and eval steps (stedm_tpu_torch/train/seg_steps.py)
against stedm_tpu/train/seg_steps.py with ``optax.MultiSteps(optax.adamw)``,
the optimizer of the JAX entry point (train_seg.py:135-136): two micro-steps
at accumulation 1 and 2 from the same weights and batches, then the eval step
with per-sample cuts and instance ids; the seg state's checkpoint round trip.

Tolerances (fp32 on both sides): each step's loss within 1e-5 relative;
confusion matrices equal exactly; the running statistics within 1e-6; the
gradients summed over a micro-step (JAX's MultiSteps accumulator) within
1e-4 in relative L2 norm (4.5e-5 measured per tensor). Adam's first update
is about lr * sign(g), so a gradient near zero flips its element's update:
each parameter within 2 lr per applied update of JAX's, and the first
update within 1e-2 of JAX's in relative L2 norm (2.5e-3 and 9e-4 measured
at accumulation 1 and 2). The optimizer alone, on given gradients, within
1e-6 of optax's (a decay of 0.01 in place of optax's 1e-4 is 100 times
that)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _port_helpers  # noqa: F401  (caps torch threads)
from _port_helpers import random_params
from test_torch_seg_model import DEC, ENC, _batch_stats

from stedm_tpu.models.segformer import SegUNet as JSegUNet
from stedm_tpu.train import seg_steps as J
from stedm_tpu_torch.models.segformer import BatchNorm, SegUNet
from stedm_tpu_torch.train import checkpoints
from stedm_tpu_torch.train import seg_steps as P
from stedm_tpu_torch.utils.weights import seg_state_dict

# at 64^2 every stage attends over four or more keys (at 32^2 over one, and q
# and k get no gradient)
LR, CLASSES, OVERLAP, PATCH = 1e-4, 3, 2, 64
LOSS_RTOL, STATS_ATOL, GRAD_REL, UPDATE_REL = 1e-5, 1e-6, 1e-4, 1e-2


def _variables(seed: int = 0):
    jmodel = JSegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC)
    x0 = jnp.zeros((1, PATCH, PATCH, 3))
    return jmodel, random_params(jmodel, seed, x0), _batch_stats(jmodel, seed + 1, x0)


def _batches(seed: int, n: int = 2, b: int = 2):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, PATCH, PATCH, 3)).astype(np.float32),
             rng.integers(0, CLASSES, (b, PATCH, PATCH)).astype(np.int32)) for _ in range(n)]


def _port_model(params, stats):
    model = SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC)
    model.load_state_dict(seg_state_dict(params, stats), strict=True)
    return model


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(sd: dict, names, base: dict | None = None) -> np.ndarray:
    return np.concatenate([(sd[n] - (0 if base is None else base[n])).numpy().ravel()
                           for n in names])


def _run_both(k: int, bn_momentum: float | None = None):
    """Two micro-steps of both; per step the JAX and port outputs, their
    state_dicts, and the gradients accumulated so far (JAX's MultiSteps
    ``acc_grads``, a mean, and the port's ``.grad``, a sum)."""
    jmodel, params, stats = _variables()
    tx = optax.MultiSteps(optax.adamw(LR), every_k_schedule=k)
    jstate = J.create_seg_state({"params": params, "batch_stats": stats}, tx)
    jstep = jax.jit(J.make_seg_train_step(jmodel, tx, num_classes=CLASSES, overlap=OVERLAP))
    model = _port_model(params, stats)
    if bn_momentum is not None:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.momentum = bn_momentum
    state = P.create_seg_state(model, P.make_seg_optimizer(LR, k))
    step = P.make_seg_train_step(model, num_classes=CLASSES, overlap=OVERLAP, device="cpu")
    logs = []
    for i, (img, seg) in enumerate(_batches(1)):
        jstate, jout = jstep(jstate, jnp.asarray(img), jnp.asarray(seg))
        state, out = step(state, torch.from_numpy(img), torch.from_numpy(seg))
        grads = None
        if (i + 1) % k:
            grads = (seg_state_dict(jstate.opt_state.acc_grads),
                     {n: p.grad.clone() / (i + 1) for n, p in model.named_parameters()})
        logs.append((jout, out, seg_state_dict(jstate.params, jstate.batch_stats),
                     {k_: v.clone() for k_, v in model.state_dict().items()}, grads))
    return params, stats, state, jstate, logs


@pytest.mark.parametrize("k", [1, 2])
def test_two_train_steps_match_jax(k):
    params, stats, state, jstate, logs = _run_both(k)
    init = seg_state_dict(params, stats)
    names = [n for n in init if "running" not in n]
    updates = 0
    for i, (jout, out, want, got, grads) in enumerate(logs):
        np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_array_equal(out["cm"].numpy(), np.asarray(jout["cm"]))
        assert out["cm"].shape == (CLASSES, CLASSES)
        applied = (i + 1) % k == 0
        updates += applied
        for name, v in want.items():
            if "running" in name:       # the running statistics move every micro-step
                np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=0,
                                           atol=STATS_ATOL, err_msg=f"step {i}: {name}")
                assert not torch.equal(got[name], init[name]), name
            else:
                np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=0,
                                           atol=2 * LR * updates, err_msg=f"step {i}: {name}")
        moved = [n for n in names if not torch.equal(got[n], init[n])]
        # the parameters move on every k-th micro-step only, all of them
        assert len(moved) == (len(names) if applied else 0), (i, len(moved))
        if grads is not None:
            assert _rel(_flat(grads[1], names), _flat(grads[0], names)) <= GRAD_REL
        if applied and updates == 1:
            assert _rel(_flat(got, names, init), _flat(want, names, init)) <= UPDATE_REL
    assert state.step == 2 and int(jstate.step) == 2
    assert state.opt_state.gradient_step == 2 // k


def test_torch_batchnorm_momentum_fails_the_comparison():
    """The check can fail: torch's BatchNorm momentum (0.1 on the batch, where
    flax puts 0.01) moves the running statistics past the tolerance."""
    *_, logs = _run_both(1, bn_momentum=0.9)
    want, got = logs[0][2], logs[0][3]
    worst = max(float((got[n] - want[n]).abs().max()) for n in want if "running" in n)
    assert worst > 100 * STATS_ATOL, worst


@pytest.mark.parametrize("k", [1, 2])
def test_optimizer_matches_optax_multisteps_adamw_on_given_gradients(k):
    """Four micro-batches of given gradients: the parameters after each
    equal optax.MultiSteps(optax.adamw(lr), k)'s within 1e-6."""
    rng = np.random.default_rng(k)
    shapes = {"w": (5, 7), "b": (7,), "scale": (3,)}
    init = {n: rng.normal(0, 1, s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.normal(0, 1, s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(4)]
    tx = optax.MultiSteps(optax.adamw(1e-2), every_k_schedule=k)
    jparams, jopt = init, tx.init(init)
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in init.items()}
    opt = P.make_seg_optimizer(1e-2, k)
    opt_state = opt.init({"seg": list(params.values())})
    for g in grads:
        updates, jopt = tx.update(g, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n].copy()) if p.grad is None \
                else p.grad + torch.from_numpy(g[n])
        opt.update(opt_state)
        for n, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]), rtol=0,
                                       atol=1e-6, err_msg=n)


def test_optimizer_is_optax_adamw_with_its_default_decay_on_every_parameter():
    model = SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC)
    tx = P.make_seg_optimizer(1e-3, 4)
    state = P.create_seg_state(model, tx)
    import inspect

    assert tx.weight_decay == inspect.signature(optax.adamw).parameters["weight_decay"].default
    assert tx.accumulate_grad_batches == 4
    group = state.opt_state.adamw.param_groups[0]
    assert group["weight_decay"] == 1e-4 and len(group["params"]) == len(list(model.parameters()))
    assert all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("overlap", [1, 3])
def test_eval_step_matches_jax_with_cuts_and_instances(overlap):
    jmodel, params, stats = _variables(4)
    rng = np.random.default_rng(5)
    img = rng.normal(size=(3, PATCH, PATCH, 3)).astype(np.float32)
    seg = rng.integers(0, CLASSES, (3, PATCH, PATCH)).astype(np.int32)
    cut_y, cut_x = np.array([0, 2, 5]), np.array([1, 0, 3])
    wsi_nr = np.array([4, 1, 4])
    jeval = jax.jit(J.make_seg_eval_step(jmodel, num_classes=CLASSES, num_inst=6,
                                         overlap=overlap))
    want = jeval({"params": params, "batch_stats": stats}, jnp.asarray(img), jnp.asarray(seg),
                 jnp.asarray(cut_y), jnp.asarray(cut_x), jnp.asarray(wsi_nr))
    model = _port_model(params, stats).train()
    step = P.make_seg_eval_step(model, num_classes=CLASSES, num_inst=6, overlap=overlap,
                                device="cpu")
    got = step(*(torch.from_numpy(a) for a in (img, seg, cut_y, cut_x, wsi_nr)))
    assert not model.training
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))
    np.testing.assert_array_equal(got["inst_cm"].numpy(), np.asarray(want["inst_cm"]))
    assert got["inst_cm"].shape == (6, CLASSES, CLASSES)
    assert float(got["inst_cm"][[0, 2, 3, 5]].abs().sum()) == 0.0
    # the running statistics did not move
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in seg_state_dict(params, stats).items())


def test_seg_state_checkpoint_round_trip_mid_accumulation(tmp_path):
    """Saved after one micro-step of two (accumulated gradients pending),
    restored into a fresh state: the next step gives the same bits as an
    uninterrupted run."""
    _, params, stats = _variables(6)
    (img0, seg0), (img1, seg1) = _batches(7)

    def fresh():
        model = _port_model(params, stats)
        return P.create_seg_state(model, P.make_seg_optimizer(LR, 2)), model

    a, model_a = fresh()
    step_a = P.make_seg_train_step(model_a, num_classes=CLASSES, overlap=OVERLAP, device="cpu")
    a, _ = step_a(a, torch.from_numpy(img0), torch.from_numpy(seg0))
    path = checkpoints.save(tmp_path, a, name="seg_run_last")
    assert checkpoints.load(path)["format"] == "seg_state"
    b, model_b = fresh()
    b = checkpoints.restore(tmp_path, b, name="seg_run_last")
    assert b.step == 1 and b.opt_state.mini_step == 1
    step_b = P.make_seg_train_step(model_b, num_classes=CLASSES, overlap=OVERLAP, device="cpu")
    a, out_a = step_a(a, torch.from_numpy(img1), torch.from_numpy(seg1))
    b, out_b = step_b(b, torch.from_numpy(img1), torch.from_numpy(seg1))
    assert torch.equal(out_a["loss"], out_b["loss"]) and b.opt_state.gradient_step == 1
    sa, sb = model_a.state_dict(), model_b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    from stedm_tpu_torch.train.steps import TrainState

    with pytest.raises(ValueError, match="seg_state checkpoint, not a train_state"):
        checkpoints.restore(tmp_path, TrainState(model_a, None, None, {}), name="seg_run_last")


def test_steps_refuse_a_model_on_another_device():
    model = SegUNet(classes=2, decoder_channels=DEC, encoder_config=ENC).to("meta")
    step = P.make_seg_train_step(model, num_classes=2, overlap=1, device="cpu")
    with pytest.raises(ValueError, match="model lives on meta"):
        step(None, torch.zeros(1, PATCH, PATCH, 3), torch.zeros(1, PATCH, PATCH))
