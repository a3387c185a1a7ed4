"""The two filter products on given noise — port of ``_kernel_gemms``
(``benchmarks/exp_two_kernel_pipeline.py:59-63``), the Pallas body that the
experiment's ``split_pipeline``, ``gemm_only`` and ``xla_rng_pipeline`` run.

K2 (``csrc/toeplitz_gemm.cu``; its source note says what bounds it) takes
the matrices as general dense matrices: ``out[i] = ByM @ (noise[i] @ BzT)``
with the noise cast to the tap dtype and the intermediate cast to ByM's
dtype, both products summed in float32.  The wrapper takes the plain
version only for CPU tensors; for CUDA tensors it launches K2 or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

#: K2 launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)


def _check(noise, BzT, ByM):
    if noise.dim() != 3 or BzT.dim() != 2 or ByM.dim() != 2:
        raise ValueError("toeplitz gemm: noise (total, jn, kn), BzT (kn, kma) "
                         "and ByM (jma, jn) expected")
    total, jn, kn = noise.shape
    if BzT.shape[0] != kn or ByM.shape[1] != jn:
        raise ValueError(f"toeplitz gemm: shapes noise {tuple(noise.shape)}, "
                         f"BzT {tuple(BzT.shape)}, ByM {tuple(ByM.shape)} "
                         "do not chain")
    if noise.dtype not in _DTYPES or BzT.dtype not in _DTYPES:
        raise ValueError("toeplitz gemm: float32 or bfloat16 tensors expected")
    if BzT.dtype != ByM.dtype:
        raise ValueError(f"toeplitz gemm: BzT ({BzT.dtype}) and ByM "
                         f"({ByM.dtype}) must share a dtype")
    devs = {noise.device, BzT.device, ByM.device}
    if len(devs) != 1:
        raise ValueError(f"toeplitz gemm: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"toeplitz gemm: unsupported device {dev}")
    return dev


def toeplitz_gemm(noise: torch.Tensor, BzT: torch.Tensor,
                  ByM: torch.Tensor) -> torch.Tensor:
    """``(total, jma, kma)`` float32: ``ByM @ (noise[i] @ BzT)`` for each
    slab ``i`` of ``noise`` ``(total, jn, kn)`` (float32 or bfloat16);
    ``BzT`` ``(kn, kma)`` and ``ByM`` ``(jma, jn)`` share a dtype, float32
    or bfloat16."""
    global LAUNCHES
    dev = _check(noise, BzT, ByM)
    if dev.type == "cpu":
        return toeplitz_gemm_plain(noise, BzT, ByM)
    if not noise.is_contiguous():
        raise ValueError("toeplitz gemm: noise must be contiguous")
    from pods_digital_filter_tpu_torch.ops import _build

    lib, _ = _build.load()
    total, jn, kn = noise.shape
    jma, kma = ByM.shape[0], BzT.shape[1]
    bf16 = BzT.dtype == torch.bfloat16
    need = lib.toeplitz_gemm_smem_bytes(jn, int(bf16))
    limit = lib.fused_filter_smem_limit(dev.index)
    if need > limit:
        raise ValueError(f"toeplitz gemm: jn={jn} needs {need} bytes of "
                         f"shared memory; the card allows {limit} per block")
    BzT, ByM = BzT.contiguous(), ByM.contiguous()
    out = torch.empty((total, jma, kma), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.toeplitz_gemm_launch(
            int(bf16), int(noise.dtype == torch.bfloat16), noise.data_ptr(),
            BzT.data_ptr(), ByM.data_ptr(), out.data_ptr(), jn, kn, jma, kma,
            total, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "toeplitz gemm kernel")
    LAUNCHES += 1
    return out


def toeplitz_gemm_plain(noise, BzT, ByM) -> torch.Tensor:
    """Plain version: float32 ``torch.matmul`` on operands promoted from
    their dtype, with the same casts between (``.to(bfloat16)`` rounds to
    nearest even, as the kernel and ``astype`` do)."""
    f32 = torch.float32
    t = torch.matmul(noise.to(BzT.dtype).to(f32), BzT.to(f32))
    return torch.matmul(ByM.to(f32), t.to(ByM.dtype).to(f32))
