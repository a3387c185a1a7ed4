"""The yardstick's arithmetic: published peaks of one H100 and the work
(bytes and FLOPs) of the kernels that the per-layer metrics hold against
them.

``bound``, ``filter_work`` and ``generations`` are frozen copies of
``chip_smoke.py``'s (``bound`` :488-496, ``filter_work`` :498-505,
``gemm_work`` :545-551, ``generations`` :1054-1062), kept here so that a
later change to the program or to its smoke script cannot move the
yardstick.  Everything is computed from shapes; nothing here touches a
device.
"""

from __future__ import annotations

#: NVIDIA's H100 SXM data sheet at 700 W: device memory bytes/s and dense
#: FLOP/s (f32 without tensor cores; bf16 and f64 on them)
PEAK = {"bytes": 3.35e12, "f32": 67e12, "bf16": 989e12, "f64": 67e12}


def bound(nbytes, flops=0.0, kind="f32"):
    """The least time the card could take for the work, in ms: the bytes
    that must move (each input read once, each output written once) over
    the memory rate, or the FLOPs over the peak of their type, whichever is
    larger; with which of the two sets it."""
    by_bytes = nbytes / PEAK["bytes"] * 1e3
    by_ops = flops / PEAK[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def filter_work(slabs, jma, kma, nf, steps=0):
    """FLOPs of the separable spatial filter (z then y pass, 2nf+1 taps) over
    ``slabs`` slabs, plus the temporal FIR over ``steps`` output steps, for
    3 components."""
    jn, taps = jma + 2 * nf, 2 * nf + 1
    return 3 * 2 * taps * ((jn * kma + jma * kma) * slabs + jma * kma * steps)


def gemm_work(total, jn, kn, jma, kma, noise_bytes, bf16_taps):
    """K2's work: its bytes (noise in, the taps, f32 out) and FLOPs."""
    tap_bytes = (kn * kma + jma * jn) * (2 if bf16_taps else 4)
    nbytes = total * (jn * kn * noise_bytes + jma * kma * 4) + tap_bytes
    flops = 2 * total * (jn * kn * kma + jma * jn * kma)
    return nbytes, flops, "bf16" if bf16_taps else "f32"


def generations(ns, block, group):
    """K1 launches of one streaming run with no stored rows: the mean pass
    (B blocks), the Gram pass (each panel's blocks, then the column blocks
    after it) and the projection (B blocks), B = ceil(ns / block)."""
    nb = -(-ns // block)
    gram = sum(min(group, nb - g0) + nb - min(g0 + group, nb)
               for g0 in range(0, nb, group))
    return 2 * nb + gram


# ---------------------------------------------------------------------------
# The benchmark's own counts (not in chip_smoke.py)
# ---------------------------------------------------------------------------

def k1_bytes(slabs, jma, kma, itemsize=4):
    """What one K1 launch must move: it draws its noise on the chip, so only
    the filtered ``(3, slabs, jma, kma)`` output is written (the taps are a
    few hundred bytes)."""
    return 3 * slabs * jma * kma * itemsize


def k1_bound_ms(slabs, jma, kma, nf):
    """K1's bound for one launch over ``slabs`` slabs: its output bytes or
    its filter FLOPs, whichever is larger (bytes, at these shapes)."""
    return bound(k1_bytes(slabs, jma, kma), filter_work(slabs, jma, kma, nf))


def gram_flops(np3, ns, block):
    """f32 FLOPs of the streaming Gram that the algorithm needs: the tiles
    on and below the diagonal, ``2 * np3 * b_i * b_j`` each (tiles that a
    panel computes above the diagonal and throws away are not counted)."""
    nb = -(-ns // block)
    widths = [min(block, ns - i * block) for i in range(nb)]
    return sum(2.0 * np3 * widths[i] * widths[j]
               for i in range(nb) for j in range(i + 1))


def projection_flops(np3, ns, modes):
    """The projection of every snapshot onto the kept modes."""
    return 2.0 * np3 * ns * modes


def fir_flops(np3, steps, nf):
    """The temporal FIR's useful FLOPs: ``2nf + 1`` taps per output value."""
    return 2.0 * (2 * nf + 1) * np3 * steps


def replay_bytes(points, slots, modes, kmax, steps, itemsize=8):
    """What one replay call must move, each once: the modes and the mean
    read, the ``(steps, slots * points)`` output written, and the Fourier
    tables (k, Re, Im) read."""
    n = slots * points
    return itemsize * (modes * n + n + steps * n + 3 * modes * kmax)
