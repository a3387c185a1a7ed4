"""A copy of ``pods_digital_filter_tpu/models/prf_reader.py``, the port's own
(the contour plots of ``make_plots`` are skipped, with a printed line, on a
host without matplotlib; any other plotting error is raised).

2-D ``.prf`` profile reader.

Reference: ``read_prf`` (digitalfilters.py:524-1035).  Reads a PRECISE-style
profile file (header lines, then a ``data,<cols>`` role line, then rows),
reconstructs the plane geometry from the point cloud, regrids onto a uniform
(y, z) lattice, rescales to a target mass flow / bulk velocity, and
synthesizes Reynolds stresses from k and epsilon/SDR with a Boussinesq
eddy-viscosity model.

Faithfully replicated quirks (each marked in-line):

* the in-plane basis vectors come from points (0 -> 1) and (0 -> last)
  (digitalfilters.py:595-610) — not robust to arbitrary point orderings, as
  the reference itself notes;
* the two de-rotation matrices use the *unnormalized* axis components in the
  Rodrigues formula (digitalfilters.py:648-674) — exact for unit normals;
* gradient smoothing averages a 2x2 (not 3x3) box: ``mean(a[i-1:i+1, j-1:j+1])``
  (digitalfilters.py:831-845);
* the length scale is ``0.07 * hydraulic diameter`` in grid units
  (digitalfilters.py:893-900);
* any ``uu/vv/ww`` columns are read but then *overwritten* by the
  eddy-viscosity model (digitalfilters.py:1000-1009) — reference behavior;
* returned fields are ``flip(axis=0).T`` of the (kma, jma) grids
  (digitalfilters.py:1024-1035).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
from scipy.interpolate import griddata


@dataclass
class PrfProfile:
    U: np.ndarray      # (jma, kma)
    V: np.ndarray
    W: np.ndarray
    uu: np.ndarray
    vv: np.ndarray
    ww: np.ndarray
    uv: np.ndarray
    uw: np.ndarray
    vw: np.ndarray
    length_scale: float    # lnx in grid spacings
    kma: int
    jma: int
    normal: tuple
    center: tuple
    # regridded intermediate fields, useful for diagnostics
    k: np.ndarray | None = None
    eps: np.ndarray | None = None
    y_grid: np.ndarray | None = None
    z_grid: np.ndarray | None = None


def _parse_header(path: str):
    """Scan to the ``data,...`` line; return (column-role map, rows to skip)."""
    roles = {}
    with open(path) as f:
        count = 0
        for line in f:
            count += 1
            if line.startswith("data"):
                cols = [c.strip() for c in line.strip().split(",")]
                for i, name in enumerate(cols[1:]):
                    roles[name] = i
                return roles, count
    raise ValueError(f"{path}: no 'data,...' column line found")


def _raw_rotation(nx, ny, nz, C, S):
    """The reference's literal Rodrigues-form matrix with possibly
    unnormalized axis components (digitalfilters.py:648-655, 668-674)."""
    t = 1.0 - C
    return np.array([
        [t * nx * nx + C,      t * nx * ny - S * nz, t * nx * nz + S * ny],
        [t * nx * ny + S * nz, t * ny * ny + C,      t * ny * nz - S * nx],
        [t * nx * nz - S * ny, t * ny * nz + S * nx, t * nz * nz + C],
    ])


def _smooth_2x2(a: np.ndarray) -> np.ndarray:
    """Interior smoothing with the reference's 2x2 mean box."""
    out = a.copy()
    src = a.copy()
    out[1:-1, 1:-1] = 0.25 * (src[:-2, :-2] + src[:-2, 1:-1]
                              + src[1:-1, :-2] + src[1:-1, 1:-1])
    return out


def read_prf(
    profile_file: str,
    res: float,
    mdot: float = 0.0,
    den: float = 0.0,
    bulk_velocity: float = 1.0,
    non_dim: bool = False,
    test_gradients: bool = False,
    outdir: str | None = None,
    make_plots: bool = False,
) -> PrfProfile:
    roles, skip = _parse_header(profile_file)
    from pods_digital_filter_tpu_torch import native

    data = native.parse_table(profile_file)
    if data is None or data.shape[1] <= max(roles.values()):
        try:
            data = np.loadtxt(profile_file, skiprows=skip)
        except Exception:
            data = np.loadtxt(profile_file, skiprows=skip, delimiter=",")

    def col(name):
        return data[:, roles[name]] if name in roles else None

    xA, yA, zA = col("x"), col("y"), col("z")
    UA, VA, WA = col("u"), col("v"), col("w")
    kA, epsA, sdrA = col("k"), col("e"), col("sdr")

    # --- plane basis from the point cloud (digitalfilters.py:595-618) ---
    x2, y2, z2 = xA[1] - xA[0], yA[1] - yA[0], zA[1] - zA[0]
    x1, y1, z1 = xA[-1] - xA[0], yA[-1] - yA[0], zA[-1] - zA[0]
    xn = y1 * z2 - z1 * y2
    yn = z1 * x2 - x1 * z2
    zn = x1 * y2 - y1 * x2
    nn = math.sqrt(xn * xn + yn * yn + zn * zn)
    xn, yn, zn = xn / nn, yn / nn, zn / nn

    xc = (xA.max() + xA.min()) / 2
    yc = (yA.max() + yA.min()) / 2
    zc = (zA.max() + zA.min()) / 2

    # --- de-rotate the plane into the y-z axes (digitalfilters.py:636-674) ---
    theta = -math.acos(max(-1.0, min(1.0, xn)))
    beta = -math.atan2(zn, yn)
    pts = np.stack([xA - xc, yA - yc, zA - zc], axis=0)
    T1 = _raw_rotation(0.0, -zn, yn, math.cos(theta), math.sin(theta))
    pts = T1 @ pts
    T2 = _raw_rotation(xn, yn, zn, math.cos(beta), math.sin(beta))
    pts = T2 @ pts

    yspan = pts[1].max() - pts[1].min()
    zspan = pts[2].max() - pts[2].min()
    kma = int(math.ceil(zspan / res))
    jma = int(math.ceil(yspan / res))

    yi = np.linspace(pts[1].min(), pts[1].min() + res * jma, jma)
    zi = np.linspace(pts[2].min(), pts[2].min() + res * kma, kma)
    y, z = np.meshgrid(yi, zi)   # (kma, jma)

    pyz = pts[1:, :].T

    def regrid(vals, clamp=False):
        if vals is None:
            return None
        out = griddata(pyz, vals, (y, z), fill_value=0.0, method="linear")
        if clamp:
            out[out < 0] = 0
        return out

    U = regrid(UA)
    V = regrid(VA)
    W = regrid(WA)
    k = regrid(kA, clamp=True)
    eps = regrid(epsA, clamp=True)
    sdr = regrid(sdrA, clamp=True)
    if sdr is not None:
        if k is None:
            raise ValueError(f"{profile_file}: 'sdr' column requires 'k'")
        eps = 0.09 * k * sdr   # digitalfilters.py:748-750
        eps[eps > 1.0e8] = 0
    if k is None or eps is None:
        raise ValueError(
            f"{profile_file}: .prf input needs 'k' and 'e' (or 'sdr') columns "
            "to synthesize Reynolds stresses (reference read_prf requirement)")

    # --- mass-flow / bulk-velocity rescale (digitalfilters.py:754-800) ---
    if mdot != 0.0:
        if den == 0.0:
            raise ValueError("--massflow requires --density")
        c_area = res ** 2
        area = c_area * (kma - 1) * (jma - 1)
        udotn = U.mean() * xn + V.mean() * yn + W.mean() * zn
        mdot_old = udotn * area * den
        flag = eps > 0
        TI = np.sqrt(2.0 / 3.0 * k[flag]) / np.sqrt(
            U[flag] ** 2 + V[flag] ** 2 + W[flag] ** 2)
        L = k[flag] ** 1.5 / eps[flag]
        scale = mdot / mdot_old
        U, V, W = U * scale, V * scale, W * scale
        k[flag] = TI ** 2 * (U[flag] ** 2 + W[flag] ** 2 + V[flag] ** 2)
        eps[flag] = k[flag] ** 1.5 / L
    elif bulk_velocity != 1.0:
        udotn = U.mean() * xn + V.mean() * yn + W.mean() * zn
        flag = eps > 0
        TI = np.sqrt(2.0 / 3.0 * k[flag]) / np.sqrt(
            U[flag] ** 2 + V[flag] ** 2 + W[flag] ** 2)
        L = k[flag] ** 1.5 / eps[flag]
        scale = bulk_velocity / udotn
        U, V, W = U * scale, V * scale, W * scale
        k[flag] = TI ** 2 * (U[flag] ** 2 + W[flag] ** 2 + V[flag] ** 2)
        eps[flag] = k[flag] ** 1.5 / L

    # --- test-gradient override + zero masking (digitalfilters.py:793-811) ---
    if test_gradients:
        eps = np.ones_like(U)
        k = np.ones_like(U)
        k[0] = eps[0] = 0.0
    flag = eps == 0.0
    flag1 = U == 0.0
    U[flag] = 0
    V[flag] = 0
    W[flag] = 0
    k[flag] = 0
    eps[flag1] = 0

    if test_gradients:
        U = 1 * y + 2 * z
        V = 3 * y + 4 * z
        W = 5 * y + 6 * z

    # --- gradients + 2x2 smoothing (digitalfilters.py:812-845) ---
    dU = np.gradient(U, res)
    dV = np.gradient(V, res)
    dW = np.gradient(W, res)
    dUdy, dUdz = dU[1], dU[0]
    dVdy, dVdz = dV[1], dV[0]
    dWdy, dWdz = dW[1], dW[0]
    for g in (dUdy, dUdz, dVdy, dVdz, dWdy, dWdz):
        g[flag] = 0
    if not test_gradients:
        dUdy = _smooth_2x2(dUdy)
        dUdz = _smooth_2x2(dUdz)
        dVdy = _smooth_2x2(dVdy)
        dVdz = _smooth_2x2(dVdz)
        dWdy = _smooth_2x2(dWdy)
        dWdz = _smooth_2x2(dWdz)

    dplots = None
    if make_plots and outdir is not None:
        from pods_digital_filter_tpu_torch.diagnostics import load_plots

        dplots = load_plots("the .prf contour plots")
    if dplots is not None:
        yp, zp = (y / z.max(), z / z.max()) if non_dim else (y, z)
        figsize = (8, 8 * kma / jma)
        for name, fld in [("dudy", dUdy), ("dudz", dUdz), ("dvdy", dVdy),
                          ("dvdz", dVdz), ("dwdy", dWdy), ("dwdz", dWdz),
                          ("U", U), ("V", V), ("W", W), ("eps", eps), ("k", k)]:
            dplots.contourf(yp, zp, fld, name, f"{outdir}/{name}",
                            figsize=figsize)

    # incompressibility approximation (digitalfilters.py:876-884)
    dUdx = -dVdy - dWdz
    dVdx = np.zeros((kma, jma))
    dWdx = np.zeros((kma, jma))

    # length scale = 0.07 * hydraulic diameter, in grid units
    B = 2 * pts[1].max()
    Cd = 2 * pts[2].max()
    L = 0.07 * 2 * B * Cd / (B + Cd)
    lnx = math.ceil(L / res)

    # --- Boussinesq eddy-viscosity stresses (digitalfilters.py:995-1013) ---
    nu_t = np.zeros((kma, jma))
    pos = eps > 0
    nu_t[pos] = 0.09 * k[pos] ** 2 / eps[pos]
    uu = -2.0 * nu_t * dUdx + 2.0 / 3.0 * k
    vv = -2.0 * nu_t * dVdy + 2.0 / 3.0 * k
    ww = -2.0 * nu_t * dWdz + 2.0 / 3.0 * k
    uv = -nu_t * (dUdy + dVdx)
    uw = -nu_t * (dUdz + dWdx)
    vw = -nu_t * (dVdz + dWdy)
    uu[uu < 0.0] = 0.0
    vv[vv < 0.0] = 0.0
    ww[ww < 0.0] = 0.0

    if dplots is not None:
        for name, fld in [("uu", uu), ("vv", vv), ("ww", ww),
                          ("uv", uv), ("uw", uw), ("vw", vw)]:
            dplots.contourf(yp, zp, fld, name, f"{outdir}/{name}",
                            figsize=figsize)

    def orient(a):
        return np.flip(a, 0).T   # (kma, jma) -> (jma, kma)

    return PrfProfile(
        U=orient(U), V=orient(V), W=orient(W),
        uu=orient(uu), vv=orient(vv), ww=orient(ww),
        uv=orient(uv), uw=orient(uw), vw=orient(vw),
        length_scale=float(lnx), kma=kma, jma=jma,
        normal=(xn, yn, zn), center=(xc, yc, zc),
        k=k, eps=eps, y_grid=y, z_grid=z,
    )
