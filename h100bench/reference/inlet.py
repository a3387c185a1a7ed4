"""Plain reference of the inlet generator, in float64 after the noise draw.

It works out again everything the program's set-up derives: the profile,
the time step, the filter taps, the Lund factors, the rotation and the
Philox noise stream.  Frozen copies, each naming what it copies, hold the
semantics that cannot be derived otherwise:

* the Philox4x32-10 stream, its counters and its float conversion:
  ``pods_digital_filter_tpu_torch/ops/philox.py:24-79`` (K1's, where the
  configuration turns ``pallas`` on);
* the torch-ops generator's stream, one ``torch.Generator`` a slab seeded
  by a splitmix64 mix of ``(seed, slab)``, and its float conversion:
  ``pods_digital_filter_tpu_torch/ops/filters.py:53-88`` (where ``pallas``
  is off or absent, as on every sharded path; it depends on the device
  type, so the reference draws it on the program's);
* the Gaussian taps: ``pods_digital_filter_tpu_torch/ops/filters.py:31-40``;
* the tanh / top-hat profile, its clamp and the 1-D plane layout:
  ``pods_digital_filter_tpu_torch/models/profiles.py:39-77, 112-125``;
* the time step: ``pods_digital_filter_tpu_torch/config.py:227-242``;
* the Lund factors: ``pods_digital_filter_tpu_torch/ops/lund.py:18-38``;
* the rotation onto the plane normal:
  ``pods_digital_filter_tpu_torch/ops/rotation.py:17-47``.

Snapshot ``s`` of the window reads noise slabs ``s .. s + 2 nfx``, the
same in either stream, and however a mesh splits the window; the
packed row of component ``c`` at plane point ``(j, k)`` is
``c * jma * kma + j * kma + k``.  Imports torch and numpy only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
SCALE = float(np.float32(2.0 * np.sqrt(3.0) * 2.0 ** -32))
_GROUPS_PER_CHUNK = 1 << 25


def _philox(c0, c1, c2, c3, k0, k1):
    k0 &= MASK32
    k1 &= MASK32
    for _ in range(10):
        p0 = c0 * M0
        p1 = c2 * M1
        hi0, lo0 = (p0 >> 32) & MASK32, p0 & MASK32
        hi1, lo1 = (p1 >> 32) & MASK32, p1 & MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + W0) & MASK32
        k1 = (k1 + W1) & MASK32
    return c0, c1, c2, c3


def noise(seed, comp, t0, num_slabs, jn, kn, device):
    """float32 noise ``(num_slabs, jn, kn)`` of component ``comp``, slabs
    ``t0 ..``: element (comp, slab, j, k) is word ``k & 3`` of Philox at
    counter ``(k >> 2, j, slab, comp)``, key ``(seed mod 2^32, seed >> 32)``,
    as an int32 times ``SCALE``."""
    groups = -(-kn // 4)
    out = torch.empty((num_slabs, jn, kn), dtype=torch.float32, device=device)
    step = max(1, _GROUPS_PER_CHUNK // (jn * groups))
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    for s0 in range(0, num_slabs, step):
        n = min(step, num_slabs - s0)
        shape = (n, jn, groups)
        slab = ((t0 + s0 + ar(n)) & MASK32).view(-1, 1, 1).expand(shape)
        j = ar(jn).view(1, -1, 1).expand(shape)
        g = ar(groups).view(1, 1, -1).expand(shape)
        c = torch.full(shape, comp, dtype=torch.int64, device=device)
        w = torch.stack(_philox(g, j, slab, c, seed & MASK32,
                                (seed >> 32) & MASK32), dim=-1)
        w = w.reshape(n, jn, 4 * groups)[..., :kn]
        w = torch.where(w >= 2 ** 31, w - 2 ** 32, w)
        out[s0:s0 + n] = w.to(torch.float32) * SCALE
    return out


def slab_seed(seed, slab):
    """The seed of the generator that draws slab ``slab``."""
    mask = (1 << 64) - 1
    z = ((seed & mask) * 0x9E3779B97F4A7C15 + (slab & mask)) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def torch_noise(seed, comp, t0, num_slabs, jn, kn, device):
    """float32 noise ``(num_slabs, jn, kn)`` of component ``comp`` in the
    torch-ops stream: slab ``t0 + s`` is component ``comp`` of
    ``torch.rand((3, jn, kn))`` from a generator on ``device`` seeded with
    ``slab_seed(seed, t0 + s)``, times ``2 sqrt 3``, less ``sqrt 3``, in
    float32."""
    pdfr = float(np.sqrt(3.0))
    out = torch.empty((num_slabs, jn, kn), dtype=torch.float32,
                      device=device)
    g = torch.Generator(device=device)
    for s in range(num_slabs):
        g.manual_seed(slab_seed(seed, t0 + s))
        u = torch.rand((3, jn, kn), generator=g, dtype=torch.float32,
                       device=device)
        out[s] = u[comp].mul_(2.0 * pdfr).sub_(pdfr)
    return out


def taps(n, ln):
    k = np.arange(2 * n + 1, dtype=np.float64) - n
    a = np.exp(-np.pi * k * k / (2.0 * ln * ln))
    return a / np.sqrt(np.sum(a * a))


def band(coeffs, out_len, device):
    """``B`` with ``B[j, j + d] = coeffs[d]``: ``B @ x`` is the valid
    correlation of ``x`` with ``coeffs``."""
    width = len(coeffs)
    B = torch.zeros((out_len, out_len + width - 1), dtype=torch.float64,
                    device=device)
    c = torch.as_tensor(coeffs, dtype=torch.float64, device=device)
    idx = torch.arange(out_len, device=device)
    for d in range(width):
        B[idx, idx + d] = c[d]
    return B


def rotation_matrix(nx, ny, nz):
    n = np.sqrt(nx ** 2 + ny ** 2 + nz ** 2)
    n_proj = np.sqrt(nx ** 2 + ny ** 2)
    if ny > 0:
        azimuth = np.arccos(nx / n_proj)
    elif ny < 0:
        azimuth = -np.arccos(nx / n_proj)
    elif nx >= 0:
        azimuth = 0.0
    else:
        azimuth = np.pi
    c, s = np.cos(azimuth), np.sin(azimuth)
    Ra = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    if nz > 0:
        polar = np.arccos(n_proj / n)
    elif nz < 0:
        polar = -np.arccos(n_proj / n)
    else:
        polar = 0.0
    c, s = np.cos(polar), np.sin(polar)
    Rp = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
    return Ra.dot(Rp)


class Inlet:
    """The configuration's generator in float64: ``block(seed, t0, n)`` is
    snapshots ``t0 .. t0+n-1``, packed ``(3 * jma * kma, n)``.

    ``conf`` holds the configuration file's ``sizes``: ``jma``, ``kma``,
    ``nsteps``, ``res``, ``lengthscale``, ``fwidth``, ``U0``, ``u_dash``,
    ``normal``, ``mean_profile``, ``turb_profile``, and ``pallas``, which
    picks the noise stream; the rest (the mesh, the streaming block) do not
    change the snapshots."""

    def __init__(self, conf, device):
        if (conf["mean_profile"], conf["turb_profile"]) != (
                "hyperbolic-tangent", "top-hat"):
            raise ValueError("the reference holds the tanh / top-hat "
                             "profile only")
        self.device = torch.device(device)
        self.noise = noise if conf.get("pallas", False) else torch_noise
        self.jma, self.kma = int(conf["jma"]), int(conf["kma"])
        ln, fw = float(conf["lengthscale"]), float(conf["fwidth"])
        self.nf = int(math.ceil(fw * ln))
        y = np.linspace(-0.5, 0.5, self.kma)
        U = conf["U0"] / 2 * (1.0 + np.tanh(10.0 * (-np.abs(y) + 0.5)))
        uu = np.maximum((conf["u_dash"] * U) ** 2, 0.0)
        self.dt = conf["res"] / float(np.mean(U[U ** 2 != 0]))
        # Lund factors for uu = vv = ww, uv = uw = vw = 0
        eps = 1e-20
        a00 = np.sqrt(uu)
        a10 = np.where(a00 > 0, 0.0 / (a00 + eps), 0.0)
        a11 = np.sqrt(np.maximum(uu - a10 * a10, 0.0))
        a20 = np.where(a00 > 0, 0.0 / (a00 + eps), 0.0)
        a21 = np.where(a11 > 0, (0.0 - a10 * a20) / (a11 + eps), 0.0)
        a22 = np.sqrt(np.maximum(uu - a20 * a20 - a21 * a21, 0.0))
        row = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                        device=self.device)[None, None, :]
        self.lund = [row(a) for a in (a00, a10, a11, a20, a21, a22)]
        self.U = row(U)
        self.t = taps(self.nf, ln)
        self.By = band(self.t, self.jma, self.device)
        self.Bz = band(self.t, self.kma, self.device)
        self.R = rotation_matrix(*conf["normal"])

    @property
    def rows(self):
        return 3 * self.jma * self.kma

    def mean_guess(self):
        """The target mean, packed: a shift that keeps sums of the
        snapshots free of cancellation."""
        npt = self.jma * self.kma
        m = torch.zeros(self.rows, dtype=torch.float64, device=self.device)
        m[:npt] = self.U.expand(1, self.jma, self.kma).reshape(-1)
        return self._rotate(m[:, None])[:, 0]

    def _component(self, seed, comp, t0, n):
        nf, dev = self.nf, self.device
        x = self.noise(seed, comp, t0, n + 2 * nf, self.jma + 2 * nf,
                       self.kma + 2 * nf, dev).to(torch.float64)
        x = torch.matmul(x, self.Bz.T)
        x = torch.matmul(self.By, x)                 # (n + 2nf, jma, kma)
        Bt = band(self.t, n, dev)                    # (n, n + 2nf)
        y = torch.matmul(Bt, x.reshape(n + 2 * nf, -1))
        return y.reshape(n, self.jma, self.kma)

    def _rotate(self, A):
        if np.allclose(self.R, np.eye(3), rtol=0, atol=0):
            return A
        npt = self.jma * self.kma
        R = torch.as_tensor(self.R, dtype=A.dtype, device=A.device)
        V = A.reshape(3, npt, -1)
        return torch.tensordot(R, V, dims=([1], [0])).reshape(A.shape)

    def block(self, seed, t0, n):
        npt = self.jma * self.kma
        out = torch.empty((3 * npt, n), dtype=torch.float64,
                          device=self.device)
        a00, a10, a11, a20, a21, a22 = self.lund
        pack = lambda c, v: out[c * npt:(c + 1) * npt].copy_(
            v.reshape(n, npt).T)
        xu = self._component(seed, 0, t0, n)
        pack(0, a00 * xu + self.U)
        xv = self._component(seed, 1, t0, n)
        pack(1, a10 * xu + a11 * xv)
        xw = self._component(seed, 2, t0, n)
        pack(2, a20 * xu + a21 * xv + a22 * xw)
        del xu, xv, xw
        return self._rotate(out)
