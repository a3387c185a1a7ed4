"""A numpy copy of ``pods_digital_filter_tpu/io/prf.py`` (importing the
original loads jax through its package ``__init__``); the files it writes
are byte-identical to the original's (tests/test_torch_isolation.py).
``read_field_prf`` is a copy of the reader in ``pods_digital_filter_tpu/replay.py``.

ASCII writers: snapshot ``.prf`` files, ``PODFS_mean.prf`` /
``PODFS_mode_%04i.prf``, ``PODFS.dat``, ``POD.eigenvalues.dat``,
``POD.temporal_mode_%04d.dat``, ``POD.initial_conditions.dat``.

Formats are structure-identical to the reference writers:

* ``save_plane`` (PODFS.py:854-887) — per-snapshot profile;
* ``pod2prf`` (PODFS.py:1662-1800) — mean + mode profiles;
* ``fourier_coefficients`` tail (PODFS.py:1644-1659) — the PODFS.dat control
  file: num_modes, period, per-mode "<i+1>\\t<count>" lines, then
  "<k>\\t<Re>\\t<Im>" coefficient lines;
* ``write_eigenvalues`` (PODFS.py:1409-1427), ``write_temporal_modes``
  (PODFS.py:1468-1487), ``write_initial_conditions`` (PODFS.py:1396-1406).

Float cells in ``.prf`` files use the reference's fixed ``%0.12f`` formatter
(``nsigproclib_no_mpi.str``, lines 880-882).  ``PODFS.dat`` floats use
Python's shortest-repr ``str(float)`` — same as the reference modulo the
Python-2/3 float-repr difference (documented deviation; all consumers parse,
not byte-compare, these values).
"""

from __future__ import annotations

import os

import numpy as np

from pods_digital_filter_tpu_torch.io.plane import PlaneGeometry
from pods_digital_filter_tpu_torch.ops.fourier import FourierResult
from pods_digital_filter_tpu.variables import VariableSet


def fstr(val: float) -> str:
    """Fixed-width float formatter (reference sp.str, nsigproclib:880-882)."""
    return "%0.12f" % val


def _prf_header(name: str, normal, plane_rhs: float,
                turbulence_model: str = "none",
                columns=("u", "v", "w")) -> str:
    n1, n2, n3 = normal
    ncols = 3 + len(columns)
    lines = [
        f"# {name} # name of the profile",
        f"# turbulence model, {turbulence_model}",
        "# plane normal and translation " + str(n1) + "\t" + str(n2) + "\t" + str(n3) + "\t" + str(plane_rhs),
        "type, xyz # type of profile (rad or xyz)",
        "localcs,origin,0,0,0 # origin of local coordinate system",
        "localcs,xaxis,1,0,0 # x axis direction of local coordinate system",
        "localcs,yaxis,0,1,0 # y axis direction of local coordinate system",
        "localcs,zaxis,0,0,1 # z axis direction of local coordinate system",
        "tolerance, 1.00E-08 # tolerance",
        "scale," + ",".join(["1"] * ncols) + " # scaling factors",
        "data,x,y,z," + ",".join(columns),
    ]
    return "\n".join(lines) + "\n"


def _write_points_uvw(f, points: np.ndarray, u: np.ndarray):
    """Rows ``x,y,z,<columns>`` — u is (Np, ncols).

    Uses the native fixed-12 formatter (native/fastio.c) when available:
    same bytes as the Python path, ~40x faster at production plane sizes.
    """
    rows = np.concatenate([points, u], axis=1)
    from pods_digital_filter_tpu import native

    f.flush()
    if native.write_rows_fixed12(f.name, "a", rows):
        f.seek(0, os.SEEK_END)
        return
    f.writelines(
        ",".join(fstr(v) for v in row) + "\n" for row in rows
    )


def write_field_prf(path: str, name: str, points: np.ndarray, u: np.ndarray,
                    normal=(1.0, 0.0, 0.0), plane_rhs: float = 0.0,
                    columns=("u", "v", "w")) -> str:
    """Public general-purpose ``.prf`` writer: header + ``x,y,z,<columns>``
    rows for an arbitrary point cloud and (Np, ncols) field — the building
    block behind the snapshot/mean/mode writers, exposed for external tools
    (e.g. the replay CLI's ``--format prf`` output)."""
    with open(path, "w") as f:
        f.write(_prf_header(name, normal, plane_rhs, columns=columns))
        _write_points_uvw(f, np.asarray(points), np.asarray(u))
    return path


def write_snapshot_prf(outdir: str, time: float, packed_u: np.ndarray, geom: PlaneGeometry,
                       normal, origin) -> str:
    """Per-step snapshot profile (reference ``save_plane``): file name is the
    time formatted ``%.5E``; plane_rhs is ``origin . normal``."""
    npt = geom.num_cells
    u = np.stack([packed_u[:npt], packed_u[npt:2 * npt], packed_u[2 * npt:3 * npt]], axis=1)
    plane_rhs = origin[0] * normal[0] + origin[1] * normal[1] + origin[2] * normal[2]
    path = os.path.join(outdir, ("%.5E" % time) + ".prf")
    with open(path, "w") as f:
        f.write(_prf_header("Generated using the digital filter method", normal, plane_rhs))
        _write_points_uvw(f, geom.cell_centers, u)
    return path


def write_mean_prf(outdir: str, mean_field: np.ndarray, geom: PlaneGeometry,
                   normal, varset: VariableSet | None = None) -> str:
    """``PODFS_mean.prf`` (reference pod2prf; note it zeroes the translation
    so plane_rhs is always 0, PODFS.py:1671-1712).  ``varset`` selects the
    variable layout (default: 3-component velocity)."""
    varset = varset or VariableSet.velocity()
    npts = geom.num_cells
    u = varset.table(mean_field, npts)
    path = os.path.join(outdir, "PODFS_mean.prf")
    with open(path, "w") as f:
        f.write(_prf_header("PODFS_mean", normal, plane_rhs=0.0,
                            columns=varset.column_names))
        _write_points_uvw(f, geom.cell_centers, u)
    return path


def write_mode_prf(outdir: str, mode_index: int, spatial_mode: np.ndarray,
                   geom: PlaneGeometry, normal,
                   varset: VariableSet | None = None) -> str:
    """``PODFS_mode_%04i.prf`` for 1-based ``mode_index``."""
    varset = varset or VariableSet.velocity()
    npts = geom.num_cells
    u = varset.table(spatial_mode, npts)
    counter = "%4.4i" % mode_index
    path = os.path.join(outdir, f"PODFS_mode_{counter}.prf")
    with open(path, "w") as f:
        f.write(_prf_header(f"PODFS_mode_{counter}", normal, plane_rhs=0.0,
                            columns=varset.column_names))
        _write_points_uvw(f, geom.cell_centers, u)
    return path


def write_podfs_dat(outdir: str, fr: FourierResult) -> str:
    """The PODFS control file (docs/usage/CFDCodeIntegration.rst:26-37)."""
    path = os.path.join(outdir, "PODFS.dat")
    ns = fr.coeffs.shape[0]
    with open(path, "w") as f:
        f.write(str(fr.num_modes))
        f.write("\n" + str(fr.period))
        for i in range(fr.num_modes):
            f.write("\n" + str(i + 1) + "\t" + str(int(fr.counts[i])))
        for i in range(fr.num_modes):
            sel = fr.order[i, : fr.counts[i]]
            for n in sel:
                c = fr.coeffs[n, i]
                f.write("\n" + str(int(n - ns // 2)) + "\t" + str(float(c.real)) + "\t" + str(float(c.imag)))
    return path


def read_podfs_dat(path: str):
    """Parse a PODFS.dat control file back into (period, per-mode list of
    (k, Re, Im) arrays) — used by tests and the replay evaluator."""
    with open(path) as f:
        tokens = f.read().split("\n")
    num_modes = int(tokens[0])
    period = float(tokens[1])
    counts = []
    for i in range(num_modes):
        idx, cnt = tokens[2 + i].split("\t")
        assert int(idx) == i + 1
        counts.append(int(cnt))
    modes = []
    pos = 2 + num_modes
    for i in range(num_modes):
        rows = np.array(
            [[float(v) for v in tokens[pos + j].split("\t")] for j in range(counts[i])]
        ) if counts[i] else np.zeros((0, 3))
        pos += counts[i]
        modes.append(rows)
    return period, modes


def read_field_prf(path: str):
    """A copy of ``pods_digital_filter_tpu/replay.py`` ``read_field_prf``
    (that module belongs to the JAX package): read a ``PODFS_mean.prf`` /
    ``PODFS_mode_%04i.prf`` field profile.

    Returns ``(points (Np,3), u (Np, S))`` where ``S`` is the number of data
    columns after x,y,z — 3 for velocity models, 3 + number of scalars for
    multi-variable models.  The format (header lines through
    ``data,x,y,z,...``, then comma-separated fixed-width rows) is defined by
    the reference's ``pod2prf`` writer (PODFS.py:1711-1745).
    """
    from pods_digital_filter_tpu import native

    tab = native.parse_table(path)
    if tab is not None and tab.shape[1] >= 4:
        return tab[:, 0:3].copy(), tab[:, 3:].copy()

    points = []
    u = []
    in_data = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if not in_data:
                if line.startswith("data,"):
                    in_data = True
                continue
            vals = [float(v) for v in line.split(",")]
            points.append(vals[0:3])
            u.append(vals[3:])
    return np.asarray(points, dtype=np.float64), np.asarray(u, dtype=np.float64)


def write_eigenvalues(outdir: str, num_valid: int, energy: np.ndarray,
                      filename: str = "POD.eigenvalues.dat") -> str:
    """Energy accounting file (reference ``write_eigenvalues``,
    PODFS.py:1409-1427), including its header text and the zeroed cumulative
    columns beyond the valid modes."""
    import math as _math
    ns = energy.shape[0]
    cumulative = np.zeros(max(num_valid, 1))
    if num_valid > 0:
        cumulative[0] = energy[0].real
        for i in range(1, num_valid):
            cumulative[i] = cumulative[i - 1] + energy[i].real
        total = cumulative[num_valid - 1]
    else:
        total = 1.0
    path = os.path.join(outdir, filename)
    with open(path, "w") as f:
        f.write("#\n")
        f.write("# mode, energy, cumulative, percenterage energy, percentage cumulative, condition number (absolute value if negative)\n")
        f.write("#		Note: cummulative energies are set to zero after first negative energy")
        f.write("#\n")
        for i in range(num_valid):
            f.write("%4.1d %18.10e %18.10e %18.10e %18.10e %18.10e\n" % (
                i + 1, energy[i].real, cumulative[i],
                energy[i].real / total * 100.0, cumulative[i] / total * 100.0,
                _math.sqrt(energy[i].real / energy[0].real)))
        for i in range(num_valid, ns):
            f.write("%4.1d %18.10e %18.10e %18.10e %18.10e %18.10e\n" % (
                i + 1, energy[i].real, 0.0,
                energy[i].real / total * 100.0, 0.0,
                _math.sqrt(abs(energy[i].real / energy[0].real))))
    return path


def write_temporal_modes(outdir: str, num_valid: int, dt: float,
                         temporal_modes: np.ndarray) -> list:
    """Per-mode ``POD.temporal_mode_%04d.dat`` (PODFS.py:1468-1487)."""
    paths = []
    ns = temporal_modes.shape[0]
    for j in range(num_valid):
        path = os.path.join(outdir, "POD.temporal_mode_" + "%04d" % (j + 1) + ".dat")
        with open(path, "w") as f:
            f.write("#\n")
            f.write("# time, amplitude\n")
            f.write("#\n")
            for i in range(ns):
                f.write("%18.10e %18.10e\n" % (i * dt, temporal_modes[i, j].real))
        paths.append(path)
    return paths


def read_temporal_modes(paths) -> np.ndarray:
    cols = []
    for p in paths:
        data = np.loadtxt(p)
        cols.append(data[:, 1])
    return np.stack(cols, axis=1)


def write_initial_conditions(outdir: str, num_valid: int, initial: np.ndarray) -> str:
    path = os.path.join(outdir, "POD.initial_conditions.dat")
    with open(path, "w") as f:
        f.write("#\n")
        f.write("# mode, amplitude\n")
        f.write("#\n")
        for i in range(num_valid):
            f.write("%4.1d %18.10e\n" % (i + 1, initial[i]))
    return path
