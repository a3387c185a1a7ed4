"""Device selection for the port: what ``--platform`` is to the JAX CLI.

``resolve_device`` is the one place a device name becomes a
``torch.device``.  It never falls back: asking for ``"cuda"`` on a host
without a usable card raises.
"""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` (or a ``torch.device``) ->
    ``torch.device``.

    Also pins float32 products to full float32 on the card: cuBLAS and
    cuDNN may otherwise run them in TF32, which keeps about three decimal
    digits and would make the port's f32 results depend on the library's
    choice of kernel."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False (no usable CUDA card on this host)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: cuda or cpu")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for queued work on ``dev`` (no-op on the CPU) — stage timers
    read the host clock, and CUDA calls return before the card is done."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
