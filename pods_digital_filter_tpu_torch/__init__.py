"""pods_digital_filter_tpu_torch — the PyTorch + CUDA port of
:mod:`pods_digital_filter_tpu` for one NVIDIA H100.

The JAX package stays the reference; this package runs its single-device,
in-memory main path (profile -> noise -> separable spatial filter ->
temporal FIR -> Lund colouring -> pack -> rotate -> POD -> Fourier
compression -> PODFS export) with PyTorch tensors.  The fused noise +
spatial-filter step, a Pallas kernel in the JAX package
(``pods_digital_filter_tpu/ops/pallas_filter.py``), is a CUDA C++ kernel
written for Hopper (``csrc/fused_filter.cu``).

The configuration dataclasses are the JAX package's own (that module
imports no jax).  Nothing in this package imports jax.
"""

__version__ = "0.1.0"

PROG = "pods-digital-filter-tpu-torch"

from pods_digital_filter_tpu.config import (  # noqa: F401,E402
    FilterConfig,
    PlaneConfig,
    PODFSConfig,
    PipelineConfig,
)
