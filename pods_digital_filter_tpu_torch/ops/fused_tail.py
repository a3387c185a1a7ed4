"""The generation tail after K1: temporal FIR -> Lund -> pack -> rotate ->
centre, from K1's filtered slabs to the finished packed block.

K5 (``csrc/fused_tail.cu``; its source note says what bounds it) does the
tail in one pass: it reads the slabs ``z (3, T + 2nfx, jma, kma)`` once and
writes ``A (3*jma*kma, T)``, row ``c*Np + j*kma + k``, once, with the banded
FIR as one fmaf chain in ascending tap order and Lund from the six factors
of :func:`lund.lund_cholesky`.  It writes float32, or bfloat16 rounded
wherever the plain bf16 chain rounds.  It replaces no TPU kernel (the JAX
package leaves the tail to XLA).  Its plain version is the chain the
generator ran before, unchanged: :func:`filters.filter_temporal` (the
dense Toeplitz product, in float32, then rounded to the block's type),
:func:`lund.apply_lund_stacked`, :func:`pack_snapshots`,
:func:`rotation.apply_rotation_packed` and the centre's subtraction; K5
equals it up to the summation order of the FIR and of the rotation (in
bf16, up to the neighbouring bf16 value where that order moves a rounding).

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches K5 or raises.  ``LAUNCHES`` counts kernel launches, and each
launch adds 1 to the counter ``fused_tail.launches``, each bfloat16 launch
1 to ``fused_tail.bf16_launches`` too (:func:`..utils.timing.count`, while
a profiler records).
"""

from __future__ import annotations

import torch

from pods_digital_filter_tpu_torch.ops import filters, fused_temporal, lund
from pods_digital_filter_tpu_torch.ops import rotation as rot_ops
from pods_digital_filter_tpu_torch.utils import timing

#: K5 launches since import (or since a caller reset it to 0)
LAUNCHES = 0

#: the block types K5 writes, each with the Lund fields, rotation and centre
#: of that type (K1's slabs and the taps are float32 in both)
DTYPES = (torch.float32, torch.bfloat16)

#: output steps of a K5 tile (csrc/fused_tail.cu): a block's chunk of steps
#: is a multiple of it
TILE_STEPS = 32


def pack_snapshots(colored: torch.Tensor) -> torch.Tensor:
    """(3, Ns, jma, kma) -> (3*jma*kma, Ns) with the reference's row layout
    ``row = comp*Np + j*kma + k`` (digitalfilters.py:1471-1473)."""
    c, ns, jma, kma = colored.shape
    return colored.permute(0, 2, 3, 1).reshape(c * jma * kma, ns)


def colour_pack(y: torch.Tensor, stresses, means, rotation=None,
                center=None) -> torch.Tensor:
    """The chain after the FIR: Lund-colour the filtered noise ``y (3, T,
    jma, kma)``, pack it, rotate it by ``rotation`` (3, 3) and subtract
    ``center`` (3*Np,), each where given."""
    A = pack_snapshots(lund.apply_lund_stacked(y, stresses, means))
    if rotation is not None:
        A = rot_ops.apply_rotation_packed(A, rotation)
    if center is not None:
        A = A - center[:, None]
    return A


def fused_tail_plain(z, bx, stresses, means, rotation=None,
                     center=None) -> torch.Tensor:
    """Plain version: :func:`filters.filter_temporal` along the slab axis in
    float32, rounded to the type of ``stresses``, then :func:`colour_pack`
    in that type."""
    y = filters.filter_temporal(z, bx, axis=-3).to(stresses.dtype)
    return colour_pack(y, stresses, means, rotation, center)


def _check(z, bx, stresses, means, rotation, center) -> int:
    """Raise ``ValueError`` unless the arguments are what K5 takes: ``z``
    and ``bx`` float32, the Lund fields, rotation and centre all of one type
    of :data:`DTYPES`; returns ``nfx``."""
    if z.dim() != 4 or z.shape[0] != 3:
        raise ValueError(f"fused tail: z must be (3, slabs, jma, kma), not "
                         f"{tuple(z.shape)}")
    _, num_slabs, jma, kma = z.shape
    if bx.dim() != 1 or bx.shape[0] % 2 == 0 or bx.shape[0] > num_slabs:
        raise ValueError(f"fused tail: bx must be 2nfx+1 <= {num_slabs} "
                         f"taps, not {tuple(bx.shape)}")
    want = {"stresses": (stresses, (6, jma, kma)),
            "means": (means, (3, jma, kma)),
            "rotation": (rotation, (3, 3)),
            "center": (center, (3 * jma * kma,))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"fused tail: {name} must be {shape}, not "
                             f"{tuple(t.shape)}")
    if stresses.dtype not in DTYPES:
        raise ValueError(f"fused tail: stresses must be float32 or bfloat16, "
                         f"not {stresses.dtype}")
    tensors = {"z": z, "bx": bx, **{k: v[0] for k, v in want.items()}}
    for name, t in tensors.items():
        if t is None:
            continue
        dtype = torch.float32 if name in ("z", "bx") else stresses.dtype
        if t.dtype != dtype:
            raise ValueError(f"fused tail: {name} must be "
                             f"{str(dtype).removeprefix('torch.')}, not "
                             f"{t.dtype}")
        if t.device != z.device:
            raise ValueError(f"fused tail: {name} is on {t.device}, z on "
                             f"{z.device}")
    if not z.is_contiguous():
        raise ValueError("fused tail: z must be contiguous")
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused tail: unsupported device {z.device}")
    return (bx.shape[0] - 1) // 2


def fused_tail(z: torch.Tensor, bx: torch.Tensor, stresses: torch.Tensor,
               means: torch.Tensor, rotation: torch.Tensor | None = None,
               center: torch.Tensor | None = None) -> torch.Tensor:
    """The packed block ``(3*jma*kma, T)`` of K1's slabs ``z (3, T + 2nfx,
    jma, kma)`` (float32, contiguous): the FIR of the ``2nfx+1`` float32 taps
    ``bx``, Lund with ``stresses`` (uu, vv, ww, uv, uw, vw) and ``means`` (U,
    V, W), each ``(jma, kma)`` planes, then the optional rotation and
    centring; the Lund fields, rotation and centre share one type of
    :data:`DTYPES`, which the block takes; every tensor on ``z``'s
    device."""
    global LAUNCHES
    nfx = _check(z, bx, stresses, means, rotation, center)
    if z.device.type == "cpu":
        return fused_tail_plain(z, bx, stresses, means, rotation, center)
    from pods_digital_filter_tpu_torch.ops import _build

    _, num_slabs, jma, kma = z.shape
    nsteps, npts = num_slabs - 2 * nfx, jma * kma
    dtype = stresses.dtype
    bf16 = dtype == torch.bfloat16
    lib, _ = _build.load()
    dev = z.device
    with torch.cuda.device(dev):
        slots = lib.fused_tail_slots(nfx, int(bf16), dev.index)
    _build.check_launch(max(0, -slots), "fused tail kernel (occupancy)")
    tiles = -(-npts // 128)
    chunk = fused_temporal._chunk(nsteps, nfx, tiles, slots, 65535,
                                  unit=TILE_STEPS)
    # in bf16 the factors are the plain chain's, computed in bf16; every
    # field reaches the kernel as float32 holding its values exactly
    as_f32 = lambda t: None if t is None else \
        t.to(torch.float32).contiguous()
    factors = as_f32(torch.stack(lund.lund_cholesky(*stresses)))
    means = as_f32(means)
    bx = bx.contiguous()
    extra = [as_f32(t) for t in (center, rotation)]
    out = torch.empty((3 * npts, nsteps), dtype=dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = lib.fused_tail_launch(
            int(bf16), z.data_ptr(), out.data_ptr(), factors.data_ptr(),
            means.data_ptr(), ptr(extra[0]), bx.data_ptr(), ptr(extra[1]),
            nfx, npts, nsteps, chunk,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "fused tail kernel")
    LAUNCHES += 1
    timing.count("fused_tail.launches", 1)
    if bf16:
        timing.count("fused_tail.bf16_launches", 1)
    return out
