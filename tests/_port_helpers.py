"""Shared pieces of the tests that hold stedm_tpu_torch against stedm_tpu.

Both sides get the same weights (the JAX tree, through the port's weight
bridge) and the same inputs, made with numpy from a seed; they exchange
numpy arrays. Comparisons are fp32 on the CPU.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

# tier-1 runs six pytest workers on eight cores
torch.set_num_threads(2)

# the precedent of tests/test_torch_parity.py:75 for fp32 module parity
RTOL, ATOL = 1e-3, 2e-4


def _leaf(rng, path, shape):
    name = str(getattr(path[-1], "key", path[-1]))
    if name == "scale":                      # norm affine around 1
        return 1.0 + rng.normal(0, 0.05, shape)
    if name == "logit_scale":                # swin log temperature
        return np.log(10.0) + rng.normal(0, 0.05, shape)
    if name == "kernel":                     # fan-in scaled, none left at zero
        return rng.normal(0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
    if name == "embedding":                  # codebook spread like the latents
        return rng.normal(0, 1.0, shape)
    return rng.normal(0, 0.05, shape)


# a PRNG whose draw is one primitive (threefry traces dozens a draw, ~60 % of
# tracing a tiny STEDM's init); the shapes and dtypes of an init's variables
# do not depend on its draws
SHAPE_PRNG = "unsafe_rbg"


def init_shapes(init, *args, **kwargs):
    """``jax.eval_shape`` of a flax ``init`` (``module.init`` or a function
    of the key first), its key drawn from ``SHAPE_PRNG``: the variables'
    shapes and dtypes, as the default PRNG gives them."""
    with jax.default_prng_impl(SHAPE_PRNG):
        return jax.eval_shape(init, jax.random.PRNGKey(0), *args, **kwargs)


def random_params(module, seed: int, *args, **kwargs):
    """A JAX module's parameter tree with seeded random values, shaped by
    ``eval_shape`` of its init (``init_shapes``: no init compile);
    zero-initialised layers (output convs, attention proj_out) get non-zero
    weights too."""
    shapes = init_shapes(module.init, *args, **kwargs)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _leaf(rng, p, s.shape).astype(np.float32), shapes["params"])


_INIT_MEMO: dict = {}


@contextlib.contextmanager
def jax_init(mode: str):
    """Within the block, flax's ``Module.init`` (which a JAX entry point
    calls op by op, one compile a primitive) is cheaper: ``"jit"`` gives the
    same values through one ``jax.jit``; ``"memo"`` computes them as flax
    does, once for each module, key and input shapes in this process (a
    test's own init and its JAX entry point's); ``"jit-memo"`` is ``"memo"``
    with each init computed through one ``quick_jit`` (op by op, flax
    compiles each primitive at full optimisation: ~35 s of a seg net's
    entry-point test); ``"shapes"`` gives zeros of
    the shapes ``eval_shape`` traces, for a JAX entry point whose parameters
    are all restored or whose init values no check reads. The JAX package
    itself is unchanged."""
    import flax.linen as nn

    orig = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        dyn = [i for i, a in enumerate(args) if isinstance(a, (jax.Array, np.ndarray))]

        def call(r, *arrays):
            full = list(args)
            for i, a in zip(dyn, arrays):
                full[i] = a
            return orig(self, r, *full, **kwargs)

        arrays = [args[i] for i in dyn]
        if mode in ("memo", "jit-memo"):
            key = (mode, repr(self), np.asarray(jax.random.key_data(rngs) if jnp.issubdtype(
                rngs.dtype, jax.dtypes.prng_key) else rngs).tobytes(),
                tuple((np.shape(a), str(np.asarray(a).dtype)) if i in dyn else repr(a)
                      for i, a in enumerate(args)), repr(sorted(kwargs.items())))
            if key not in _INIT_MEMO:   # host copies: a caller may donate its arrays
                _INIT_MEMO[key] = jax.tree_util.tree_map(
                    np.array, quick_jit(call)(rngs, *arrays) if mode == "jit-memo"
                    else orig(self, rngs, *args, **kwargs))
            return jax.tree_util.tree_map(jnp.array, _INIT_MEMO[key])
        if mode == "shapes":
            # host zeros: jnp.zeros compiles a broadcast for every leaf's shape
            return jax.tree_util.tree_map(lambda s: jnp.asarray(np.zeros(s.shape, s.dtype)),
                                          init_shapes(lambda r, *a: call(
                                              jax.tree_util.tree_map(lambda _: r, rngs), *a),
                                              *arrays))
        return jax.jit(call)(rngs, *arrays)

    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = orig


# XLA's backend optimisation off: a JAX reference compiles in a fraction of
# the time and moves by ~1e-6 (tests/test_torch_train.py, tests/_ae_helpers.py)
QUICK_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _in_port_test() -> bool:
    """Whether the running test (pytest's ``PYTEST_CURRENT_TEST``) is one of
    the port's, ``tests/test_torch_*.py``."""
    return "test_torch_" in os.environ.get("PYTEST_CURRENT_TEST", "").split("::")[0]


def _trust_held_params() -> None:
    """Within the port's tests, flax's ``Scope.param`` hands back a
    parameter that the tree already holds without its shape check, a
    ``jax.eval_shape`` of the parameter's initializer (~40 % of tracing a
    tiny STEDM's sampler, paid on every trace: a compile found in JAX's
    persistent cache is still traced first). The tests' trees are shaped by
    that same init (``random_params``, the weight bridge), and a tree of the
    wrong shape still fails in the ops that read it. Every other test (the
    JAX package's own) keeps the check; the JAX package is unchanged."""
    from flax.core import meta, scope

    orig = scope.Scope.param
    if getattr(orig, "_port_trusting", False):
        return

    def param(self, name, init_fn, *init_args, unbox=True, **init_kwargs):
        if not (_in_port_test() and self.has_variable("params", name)):
            return orig(self, name, init_fn, *init_args, unbox=unbox, **init_kwargs)
        self.reserve(name, "params")
        value = self.get_variable("params", name)
        return meta.unbox(value) if unbox else value

    param._port_trusting = True
    scope.Scope.param = param


_trust_held_params()


def quick_jit(fn, **kwargs):
    """``jax.jit(fn)`` compiled with ``QUICK_COMPILE``."""
    return jax.jit(fn, compiler_options=QUICK_COMPILE, **kwargs)


@contextlib.contextmanager
def quick_compile():
    """Within the block, every ``jax.jit`` made (a JAX entry point's train
    and eval steps) compiles with ``QUICK_COMPILE`` unless it names its own
    options. The JAX package itself is unchanged."""
    orig = jax.jit

    def jit(fun=None, **kwargs):
        kwargs.setdefault("compiler_options", QUICK_COMPILE)
        if fun is None:
            return functools.partial(jit, **kwargs)
        return orig(fun, **kwargs)

    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = orig


def jax_apply(module, params, *args, method=None):
    """A jitted apply (one compile beats op-by-op dispatch on the CPU)."""
    fn = jax.jit(lambda p, *a: module.apply({"params": p}, *a, method=method))
    return np.asarray(fn(params, *args))


def nhwc_to_nchw(a: np.ndarray) -> torch.Tensor:
    """An NHWC numpy array as an NCHW-logical channels_last tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def to_numpy_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def load(module: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """Strict load: every port key must come from the bridge and back."""
    module.load_state_dict(state_dict, strict=True)
    return module.eval()


def check_grain_loader(dm, seed: int = 0) -> None:
    """``location.loader=grain``: the data module's train loader is the
    worker-process loader, and its first batch equals, bit for bit, the
    threaded loader's over the same dataset."""
    from stedm_tpu_torch.data.loader import Loader
    from stedm_tpu_torch.data.worker_loader import WorkerLoader

    loader = dm.train_loader(seed=seed)
    assert isinstance(loader, WorkerLoader)
    threads = Loader(loader.dataset, loader.batch_size, shuffle=True, seed=seed)
    try:
        got = next(iter(loader))
    finally:
        loader.close()
    want = next(iter(threads))

    def equal(g, w):
        if isinstance(w, tuple):
            assert isinstance(g, tuple) and len(g) == len(w)
            for a, b in zip(g, w):
                equal(a, b)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)

    equal(got, want)
