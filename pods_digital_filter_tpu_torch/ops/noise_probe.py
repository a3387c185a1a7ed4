"""Noise-draw probes — port of the probe bodies of
``benchmarks/exp_two_kernel_pipeline.py`` (``_NOISE_BODIES`` at :341-347,
``_noise_body_batched`` at :350, ``_store2d_body`` at :314).

Each TPU body asks where a noise kernel's time goes: the generator, the
unpack of 16-bit halves, the seeding, the cast or the store.  K3
(``csrc/noise_probe.cu``; its source note gives each mode's exact stream)
asks the same of the port's Philox4x32-10.  The body ``noise32`` (one
32-bit word per value) is K1's raw mode, :func:`fused_filter.raw_noise`,
and has no mode here.

Every probe has a plain PyTorch version on :mod:`.philox`'s int64
arithmetic, equal to the kernel bit for bit.  The wrapper takes the plain
version only for a CPU ``device``; for a CUDA one it launches K3 or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from pods_digital_filter_tpu_torch.ops import philox

#: K3 launches since import (or since a caller reset it to 0)
LAUNCHES = 0

#: probe bodies with a K3 mode, by the experiment's variant names
BODIES = ("noise", "noise16b", "noise1seed", "noprng", "noisemin",
          "storeonly", "batched")
_MODES = {name: i for i, name in enumerate(BODIES)}
_STORE2D = 7

#: float32(2*sqrt(3)/65536): one 16-bit half -> uniform(-sqrt3, sqrt3)
SCALE16 = float(np.float32(2.0 * np.sqrt(3.0) / 65536.0))
_KNUTH = 0x9E3779B9            # int32(-1640531527), the original's stream hash


def _check(body, jn, kn, num_components, num_slabs, dtype, group):
    if body not in _MODES:
        raise ValueError(f"noise probe: unknown body {body!r}; one of {BODIES}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"noise probe: dtype must be float32 or bfloat16, "
                         f"not {dtype}")
    if body in ("noise", "noise1seed", "batched") and kn % 2:
        raise ValueError(f"noise probe {body!r}: kn={kn} must be even (two "
                         "16-bit halves per word; the 32-bit draw is K1's "
                         "raw mode)")
    if body in ("noise16b", "noisemin") and jn % 2:
        raise ValueError(f"noise probe {body!r}: jn={jn} must be even")
    total = num_components * num_slabs
    if body == "batched" and (total % group or (total // group) % num_components):
        raise ValueError(f"noise probe 'batched': {total} slabs do not split "
                         f"into groups of {group} per component")
    _check_size(total * jn * kn)


def _check_size(n):
    if n >= 2 ** 32:
        raise ValueError(f"noise probe: a launch writes at most 2^32 - 1 "
                         f"values (32-bit indices), not {n}")


def probe(body: str, seed: int, t0: int, num_slabs: int, jn: int, kn: int,
          num_components: int = 3, dtype=torch.bfloat16, device="cpu",
          group: int = 4) -> torch.Tensor:
    """Probe ``body``'s noise field ``(num_components * num_slabs, jn, kn)``
    in ``dtype``; ``group`` is the batched body's slabs per group."""
    global LAUNCHES
    _check(body, jn, kn, num_components, num_slabs, dtype, group)
    dev = torch.device(device)
    if dev.type == "cpu":
        return probe_plain(body, seed, t0, num_slabs, jn, kn, num_components,
                           dtype, dev, group)
    if dev.type != "cuda":
        raise ValueError(f"noise probe: unsupported device {dev}")
    out = torch.empty((num_components * num_slabs, jn, kn), dtype=dtype,
                      device=dev)
    _launch(_MODES[body], out, jn, kn, num_components, num_slabs, group, seed,
            t0)
    return out


def store2d(num_slabs: int, jma: int, kma: int, num_components: int = 3,
            device="cpu") -> torch.Tensor:
    """The constant 0.5 stored as ``(jma, num_components*num_slabs*kma)``
    float32 (the original's ``_store2d_body`` output layout)."""
    _check_size(num_components * num_slabs * jma * kma)
    dev = torch.device(device)
    if dev.type == "cpu":
        return store2d_plain(num_slabs, jma, kma, num_components, dev)
    if dev.type != "cuda":
        raise ValueError(f"noise probe: unsupported device {dev}")
    out = torch.empty((jma, num_components * num_slabs * kma),
                      dtype=torch.float32, device=dev)
    _launch(_STORE2D, out, jma, kma, num_components, num_slabs, 1, 0, 0)
    return out


def store2d_plain(num_slabs, jma, kma, num_components=3, device="cpu"):
    return torch.full((jma, num_components * num_slabs * kma), 0.5,
                      dtype=torch.float32, device=device)


def _launch(mode, out, jn, kn, num_components, num_slabs, group, seed, t0):
    global LAUNCHES
    from pods_digital_filter_tpu_torch.ops import _build

    lib, _ = _build.load()
    with torch.cuda.device(out.device):
        err = lib.noise_probe_launch(
            mode, int(out.dtype == torch.bfloat16), out.data_ptr(), jn, kn,
            num_components, num_slabs, group, t0 & philox.MASK32,
            seed & philox.MASK32, (seed >> 32) & philox.MASK32, SCALE16,
            philox.SCALE, torch.cuda.current_stream(out.device).cuda_stream)
    _build.check_launch(err, f"noise probe kernel (mode {mode})")
    LAUNCHES += 1


# --- plain versions -----------------------------------------------------------

def _words(shape, c0, c1, c2, c3, k0, k1) -> torch.Tensor:
    """Philox words of the counters broadcast to ``shape`` (the last axis
    indexes groups of four words), as ``(..., 4 * groups)`` int64."""
    c = [torch.as_tensor(x).expand(shape) if torch.is_tensor(x) else x
         for x in (c0, c1, c2, c3)]
    w = torch.stack(philox.philox4x32(*c, k0, k1), dim=-1)
    return w.reshape(*shape[:-1], 4 * shape[-1])


def _signed16(h: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of int64 ``h`` as a signed int16 value."""
    return ((h & 0xFFFF) ^ 0x8000) - 0x8000


def _halves(w: torch.Tensor) -> torch.Tensor:
    """The production unpack (``pallas_filter.py:180-183``): words ``(..., m)``
    -> ``(..., 2m)`` values ``[(w & 0xFFFF) - 32768 | int32(w) >> 16]``."""
    lo = (w & 0xFFFF) - 32768
    hi = _signed16(w >> 16)        # the arithmetic shift of the int32 word
    return torch.cat([lo, hi], dim=-1)


def probe_plain(body, seed, t0, num_slabs, jn, kn, num_components=3,
                dtype=torch.bfloat16, device="cpu", group=4) -> torch.Tensor:
    """Plain version of :func:`probe`, bit for bit."""
    _check(body, jn, kn, num_components, num_slabs, dtype, group)
    dev = torch.device(device)
    total = num_components * num_slabs
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    k0, k1 = seed & philox.MASK32, (seed >> 32) & philox.MASK32
    cs = ar(total)
    comp = (cs // num_slabs).view(-1, 1, 1)
    slab = ((t0 + cs % num_slabs) & philox.MASK32).view(-1, 1, 1)
    half = kn // 2
    if body == "storeonly":
        return torch.full((total, jn, kn), 0.5, dtype=dtype, device=dev)
    if body == "noprng":
        v = ar(kn)[None, :] * (cs + 1)[:, None]
        v = ((v + 2 ** 31) & philox.MASK32) - 2 ** 31          # int32 wrap
        x = (v.to(torch.float32) * philox.SCALE).to(dtype)
        return x[:, None, :].expand(total, jn, kn).contiguous()
    if body == "noise":
        groups = -(-half // 4)
        w = _words((total, jn, groups), ar(groups).view(1, 1, -1),
                   ar(jn).view(1, -1, 1), slab, comp, k0, k1)[..., :half]
        v = _halves(w)
    elif body in ("noise16b", "noisemin"):
        groups = -(-kn // 4)
        w = _words((total, jn // 2, groups), ar(groups).view(1, 1, -1),
                   ar(jn // 2).view(1, -1, 1), slab, comp, k0, k1)[..., :kn]
        v = torch.stack([_signed16(w), _signed16(w >> 16)], dim=2)
        v = v.reshape(total, jn, kn)       # rows 2r, 2r+1 from word row r
        if body == "noisemin":
            return v.to(torch.float32).to(dtype)
    elif body == "noise1seed":
        words = total * jn * half
        f = ar(-(-words // 4))
        w = _words((f.shape[0], 1), f.view(-1, 1), 0, 0, 0, k0,
                   k1).reshape(-1)[:words]
        v = _halves(w.view(total, jn, half))
    else:  # batched
        groups = -(-half // 4)
        ng = total // group
        per_comp = ng // num_components
        gi = ar(ng)
        stream = ((gi // per_comp) * (1 << 22) + t0 + gi % per_comp) \
            & philox.MASK32
        key0 = ((k0 + stream * _KNUTH) & philox.MASK32).view(-1, 1, 1, 1)
        w = _words((ng, group, jn, groups), ar(groups).view(1, 1, 1, -1),
                   ar(jn).view(1, 1, -1, 1), ar(group).view(1, -1, 1, 1), 0,
                   key0, k1)[..., :half]
        v = _halves(w).reshape(total, jn, kn)
    return (v.to(torch.float32) * SCALE16).to(dtype)
