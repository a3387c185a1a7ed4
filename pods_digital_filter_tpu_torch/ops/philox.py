"""Philox4x32-10 (Salmon et al., SC'11) in torch integer ops — the plain
version of the fused kernel's noise generator (``csrc/fused_filter.cu``
computes the same bits on the card).

Every noise element has its own counter, so the stream depends on neither
the kernel's tile shape nor the time window asked for:

    element (comp, slab, j, k) of the padded noise field (jn, kn)
        counter = (k >> 2, j, slab, comp),  key = (seed mod 2^32, seed >> 32)
        value   = word[k & 3] of Philox4x32-10(counter, key)

and the word becomes a float as in the JAX kernel's odd-``kn`` branch
(``pods_digital_filter_tpu/ops/pallas_filter.py:83``): bitcast to int32,
convert to float32, times ``float32(2*sqrt(3)*2^-32)`` — uniform on
[-sqrt(3), sqrt(3)), unit variance.

torch has no unsigned 32-bit shifts on every device, so words are held in
int64 in [0, 2^32): the int64 product of two such words wraps modulo 2^64,
and ``>> 32`` / ``& 0xFFFFFFFF`` then give the exact high and low 32-bit
halves of the 32x32 -> 64 product.
"""

from __future__ import annotations

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments
MASK32 = 0xFFFFFFFF
ROUNDS = 10

#: float32(2*sqrt(3)*2^-32): int32 word -> uniform(-sqrt3, sqrt3)
SCALE = float(np.float32(2.0 * np.sqrt(3.0) * 2.0 ** -32))


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = ROUNDS):
    """Philox4x32-``rounds`` on int64 tensors (or ints) holding 32-bit words;
    returns the four output words, int64 in [0, 2^32)."""
    k0 &= MASK32
    k1 &= MASK32
    for _ in range(rounds):
        p0 = c0 * M0
        p1 = c2 * M1
        hi0, lo0 = (p0 >> 32) & MASK32, p0 & MASK32
        hi1, lo1 = (p1 >> 32) & MASK32, p1 & MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + W0) & MASK32
        k1 = (k1 + W1) & MASK32
    return c0, c1, c2, c3


def words_to_uniform(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> float32 uniform on [-sqrt3, sqrt3):
    the int32 bitcast, an exact float conversion, one f32 multiply."""
    signed = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return signed.to(torch.float32) * SCALE


def raw_noise(seed: int, t0: int, num_slabs: int, jn: int, kn: int,
              num_components: int = 1, device="cpu",
              comp0: int = 0) -> torch.Tensor:
    """The element-keyed stream of slabs ``t0 .. t0+num_slabs-1`` as a float32
    ``(num_components, num_slabs, jn, kn)`` tensor on ``device``; components
    are ``comp0 .. comp0+num_components-1``."""
    device = torch.device(device)
    groups = -(-kn // 4)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    comp = (comp0 + ar(num_components)).view(-1, 1, 1, 1)
    slab = ((t0 + ar(num_slabs)) & MASK32).view(1, -1, 1, 1)
    j = ar(jn).view(1, 1, -1, 1)
    g = ar(groups).view(1, 1, 1, -1)
    shape = (num_components, num_slabs, jn, groups)
    c0, c1, c2, c3 = (x.expand(shape) for x in (g, j, slab, comp))
    words = philox4x32(c0, c1, c2, c3, seed & MASK32, (seed >> 32) & MASK32)
    # word q of group g is element k = 4g + q
    w = torch.stack(words, dim=-1).reshape(num_components, num_slabs, jn,
                                           4 * groups)
    return words_to_uniform(w[..., :kn]).contiguous()
