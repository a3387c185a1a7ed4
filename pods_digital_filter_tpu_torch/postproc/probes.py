"""A copy of ``pods_digital_filter_tpu/postproc/probes.py`` (numpy only;
``read_inflow_data`` parses through the port's own native table parser).

Probe time-series export + legacy inflow-snapshot input.

Reference: ``write_vi_dat`` (PODFS.py:584-621) — Tecplot-style point-probe
writer; ``read_inflow_data`` (PODFS.py:1230-1240) — assembles the POD input
matrix from ``inflow.%06i`` text snapshots.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def write_vi_dat(
    filename: str,
    time_vec: np.ndarray,
    pprobe: np.ndarray,
    T_amb: float = 293.16,
    p_amb: float = 101325.0,
    fs: float = 0.0,
    fmax: Optional[Sequence[float]] = None,
) -> str:
    """Tecplot-style probe file (reference PODFS.py:584-621).  ``pprobe`` is
    (num_probes, num_snapshots)."""
    pprobe = np.asarray(pprobe, dtype=np.float64)
    num_probes, num_snapshots = pprobe.shape
    fmax = np.zeros(num_probes) if fmax is None else np.asarray(fmax)
    path = filename if filename.endswith(".dat") else filename + ".dat"
    with open(path, "w") as f:
        f.write(f"Point Probes - {os.path.splitext(os.path.basename(path))[0]}\n\n")
        f.write(f"# Ambient Pressure (Pa) = {p_amb}\n")
        f.write(f"# Ambient Temperature (C) = {T_amb - 273.16} \n")
        f.write("# Rig Mass Flow (kg/s) =  0.0000 \n")
        f.write("# Mach number = 0.0000 \n")
        f.write("# Primary Pressure Drop =    0.00 \n")
        f.write(f"# No. of Sensors = {num_probes}\n")
        f.write(f"# Sampling Frequency (kHz) = {fs}\n")
        f.write(f"# No. of Samples = {num_snapshots}\n")
        f.write("# No. of Time Histories =  1 \n\n")
        f.write("Variables = t")
        for i in range(num_probes):
            f.write(f",K{i + 1}")
        f.write("\n\n")
        for i in range(num_probes):
            f.write(f"# Peak Frequency {i + 1} (Hz) = {fmax[i]}\n")
        f.write("\n")
        f.write(f'ZONE T="probes", i={num_snapshots}, j=1, F=POINT \n\n')
        for i in range(num_snapshots):
            f.write("%9.9f\t" % time_vec[i])
            f.write("\t".join(str(v) for v in pprobe[:, i]) + "\n")
    return path


def read_vi_dat(path: str):
    """Read back a :func:`write_vi_dat` file -> (time_vec, pprobe)."""
    rows = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith(("#", "Point", "Variables", "ZONE")):
                continue
            rows.append([float(v) for v in s.split()])
    arr = np.asarray(rows, dtype=np.float64)
    return arr[:, 0], arr[:, 1:].T


def read_inflow_data(
    num_snapshots: int,
    num_cells: int,
    num_components: int = 3,
    directory: str = ".",
    prefix: str = "inflow.",
) -> np.ndarray:
    """Assemble the POD snapshot matrix A (num_cells*num_components,
    num_snapshots) from ``inflow.%06i`` text files — reference
    ``read_inflow_data`` (PODFS.py:1230-1240), including its
    ``order='F'`` flattening of each (num_cells, num_components) table."""
    from pods_digital_filter_tpu_torch import native

    paths = [os.path.join(directory, f"{prefix}{i:06d}")
             for i in range(num_snapshots)]
    A = np.zeros((num_cells * num_components, num_snapshots), dtype=np.float64)
    # native GIL-free parser fanned over a thread pool; per-file fallback
    tables = native.parse_tables(paths) or [None] * num_snapshots
    for i, (path, M) in enumerate(zip(paths, tables)):
        if M is None:
            M = np.loadtxt(path)
        A[:, i] = M.reshape(num_cells * num_components, order="F")
    return A


def write_inflow_data(
    A: np.ndarray,
    num_cells: int,
    num_components: int = 3,
    directory: str = ".",
    prefix: str = "inflow.",
) -> list:
    """Inverse of :func:`read_inflow_data` (testing + interop)."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(A.shape[1]):
        M = A[:, i].reshape(num_cells, num_components, order="F")
        path = os.path.join(directory, f"{prefix}{i:06d}")
        np.savetxt(path, M)
        paths.append(path)
    return paths
