"""Shared helpers of the PyTorch-port tests (``tests/test_torch_*.py``).

The port is held against the JAX package on the same numpy inputs: the
tests make their inputs with ``np.random.default_rng(seed)``, hand them to
both sides with the dtype pinned on each (conftest turns on jax x64, so an
f64 numpy array stays f64 in JAX), and compare numpy results.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# six xdist workers share eight cores: keep torch's intra-op pool small
torch.set_num_threads(2)


def to_torch(x, dtype) -> torch.Tensor:
    """numpy -> CPU tensor of the numpy ``dtype`` (np.float32/np.float64)."""
    return torch.as_tensor(np.asarray(x, dtype=dtype))


def to_jax(x, dtype):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(x, dtype=dtype))


def np_of(x) -> np.ndarray:
    """numpy view of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def align_signs(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Flip each column of ``got`` to the sign of ``want``'s (eigenvector
    signs are arbitrary, ops/pod.py)."""
    s = np.sign(np.einsum("ij,ij->j", got, want))
    s[s == 0] = 1.0
    return got * s[None, :]


def uniform_noise(rng, shape, dtype) -> np.ndarray:
    """Uniform(-sqrt3, sqrt3) noise in ``dtype`` — the raw field both sides
    filter when their own streams cannot match."""
    a = np.sqrt(3.0)
    return rng.uniform(-a, a, size=shape).astype(dtype)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXP_OPTIONS = ("jax_compilation_cache_dir",
                "jax_persistent_cache_min_compile_time_secs")


def load_experiment(name: str):
    """``benchmarks/<name>.py`` as a module.  The experiment files are not
    a package and set jax's compilation-cache options when imported
    (``exp_two_kernel_pipeline.py:43-44``); both options are restored here,
    so that no test worker keeps them."""
    import importlib.util

    import jax

    saved = {k: getattr(jax.config, k) for k in _EXP_OPTIONS}
    try:
        spec = importlib.util.spec_from_file_location(
            f"_exp_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def pallas_interpret(body, grid, in_specs, out_spec, out_shape, out_dtype,
                     *args):
    """``pl.pallas_call(body, ...)`` in interpret mode on the CPU, as the JAX
    package's own tests run its kernels.  Specs are ``(block_shape,
    index_map)`` pairs, or ``"smem"`` for a (1, n) scalar-memory input."""
    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def spec(s, arg):
        if s == "smem":
            return pl.BlockSpec(arg.shape, lambda *i: (0, 0),
                                memory_space=pltpu.SMEM)
        return pl.BlockSpec(*s)

    return np.asarray(pl.pallas_call(
        body, grid=grid,
        in_specs=[spec(s, a) for s, a in zip(in_specs, args)],
        out_specs=pl.BlockSpec(*out_spec),
        out_shape=jax.ShapeDtypeStruct(out_shape, out_dtype),
        interpret=pltpu.InterpretParams(),
    )(*args))
