"""Shared helpers of the PyTorch-port tests (``tests/test_torch_*.py``).

The port is held against the JAX package on the same numpy inputs: the
tests make their inputs with ``np.random.default_rng(seed)``, hand them to
both sides with the dtype pinned on each (conftest turns on jax x64, so an
f64 numpy array stays f64 in JAX), and compare numpy results.
"""

from __future__ import annotations

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
