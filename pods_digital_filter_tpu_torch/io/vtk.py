"""Legacy-VTK file writers — no VTK library dependency.  A numpy copy of
``pods_digital_filter_tpu/io/vtk.py`` (importing the original loads jax
through its package ``__init__``); byte-identical output
(tests/test_torch_isolation.py).

The reference writes binary legacy ``.vtk`` unstructured-grid files for the
POD mean field and spatial modes through the VTK Python bindings
(``write_mean_field2`` PODFS.py:438-498, ``write_spatial_POD_modes(_i_d)``
PODFS.py:202-435, ``write_field``/``write_stats`` PODFS.py:129-199).  Here
the same files are produced by emitting the legacy VTK byte format directly
(header + big-endian binary sections), which keeps the export path free of
the VTK runtime.

File/array naming parity:

* ``POD.spatial_mean_field_<var>.vtk`` — cell-data: per-component scalars
  ``<var>_k_POD`` (k = 1..C) plus vector ``<var>_POD`` (reference writes the
  vector array only, under the name ``<var>_POD``; we add the component
  scalars for symmetry with the mode files).
* ``POD.spatial_mode_<var>_%04d.vtk`` — point-data (the reference converts
  cell→point with ``vtkCellDataToPointData``): ``<var>_1_POD`` ..
  ``<var>_C_POD``, ``<var>_magnitude_POD``, and the vector ``<var>_POD``.

Deviation (documented): the reference's branch ``var_name == 'velcity' or
'U'`` (PODFS.py:251) is always true — a Python truthiness bug — so the
velocity layout is used for every single-var name; we implement that layout
directly for any single var name.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np

from pods_digital_filter_tpu_torch.io.plane import PlaneGeometry

_VTK_QUAD = 9


def _vtk_bytes_be(arr: np.ndarray, dtype: str) -> bytes:
    return np.ascontiguousarray(arr).astype(">" + dtype).tobytes()


def write_unstructured_grid(
    path: str,
    points: np.ndarray,
    connectivity: np.ndarray,
    cell_type: int = _VTK_QUAD,
    cell_data: Mapping[str, np.ndarray] | None = None,
    point_data: Mapping[str, np.ndarray] | None = None,
    title: str = "pods_digital_filter_tpu output",
) -> str:
    """Write a binary legacy-VTK UNSTRUCTURED_GRID file.

    ``points``: (Np, 3) float; ``connectivity``: (Nc, nodes_per_cell) int;
    data arrays are (N,) scalars or (N, 3) vectors keyed by array name.
    """
    points = np.asarray(points, dtype=np.float64)
    connectivity = np.asarray(connectivity, dtype=np.int64)
    n_pts = points.shape[0]
    n_cells, npc = connectivity.shape

    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\n")
        f.write(title.encode() + b"\n")
        f.write(b"BINARY\n")
        f.write(b"DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {n_pts} double\n".encode())
        f.write(_vtk_bytes_be(points, "f8"))
        f.write(f"\nCELLS {n_cells} {n_cells * (npc + 1)}\n".encode())
        cells = np.concatenate(
            [np.full((n_cells, 1), npc, dtype=np.int64), connectivity], axis=1)
        f.write(_vtk_bytes_be(cells, "i4"))
        f.write(f"\nCELL_TYPES {n_cells}\n".encode())
        f.write(_vtk_bytes_be(np.full(n_cells, cell_type, dtype=np.int64), "i4"))

        for section, data, count in (
            ("CELL_DATA", cell_data, n_cells),
            ("POINT_DATA", point_data, n_pts),
        ):
            if not data:
                continue
            f.write(f"\n{section} {count}\n".encode())
            for name, arr in data.items():
                arr = np.asarray(arr, dtype=np.float64)
                if arr.ndim == 1:
                    f.write(f"SCALARS {name} double 1\n".encode())
                    f.write(b"LOOKUP_TABLE default\n")
                elif arr.ndim == 2 and arr.shape[1] == 3:
                    f.write(f"VECTORS {name} double\n".encode())
                else:
                    raise ValueError(
                        f"array {name!r} must be (N,) or (N, 3); got {arr.shape}")
                if arr.shape[0] != count:
                    raise ValueError(
                        f"array {name!r} has {arr.shape[0]} tuples, "
                        f"expected {count} for {section}")
                f.write(_vtk_bytes_be(arr, "f8"))
                f.write(b"\n")
    return path


def quad_connectivity(jma: int, kma: int) -> np.ndarray:
    """Quad connectivity for the (jma+1)x(kma+1) node lattice of
    :class:`PlaneGeometry`; cell ordering p = j*kma + i matches the
    snapshot packing (digitalfilters.py:1471-1473)."""
    j, i = np.meshgrid(np.arange(jma), np.arange(kma), indexing="ij")
    n00 = j * (kma + 1) + i
    n01 = n00 + 1
    n11 = n01 + (kma + 1)
    n10 = n00 + (kma + 1)
    return np.stack([n00, n01, n11, n10], axis=-1).reshape(-1, 4)


def _cell_to_point(values: np.ndarray, jma: int, kma: int) -> np.ndarray:
    """Average cell values onto the node lattice (the reference's
    ``vtkCellDataToPointData``, PODFS.py:279-281): each node receives the
    mean of its adjacent cells."""
    v = values.reshape(jma, kma, -1)
    acc = np.zeros((jma + 1, kma + 1, v.shape[-1]))
    cnt = np.zeros((jma + 1, kma + 1, 1))
    for dj in (0, 1):
        for di in (0, 1):
            acc[dj:jma + dj, di:kma + di] += v
            cnt[dj:jma + dj, di:kma + di] += 1.0
    out = acc / cnt
    return out.reshape((jma + 1) * (kma + 1), -1).squeeze(-1) if values.ndim == 1 \
        else out.reshape((jma + 1) * (kma + 1), -1)


def _velocity_arrays(packed: np.ndarray, num_cells: int, num_components: int,
                     var_name: str) -> dict:
    """Split the packed [u;v;w] vector into the reference's array set:
    component scalars, magnitude, and the vector array (PODFS.py:252-270)."""
    comps = [packed[k * num_cells:(k + 1) * num_cells]
             for k in range(num_components)]
    out = {}
    for k, c in enumerate(comps):
        out[f"{var_name}_{k + 1}_POD"] = c
    mag = np.sqrt(np.sum([c * c for c in comps], axis=0))
    out[f"{var_name}_magnitude_POD"] = mag
    vec = np.stack(comps + [np.zeros(num_cells)] * (3 - num_components), axis=1)
    out[f"{var_name}_POD"] = vec
    return out


def _varset_arrays(packed: np.ndarray, num_cells: int, varset) -> dict:
    """Multi-variable array set (reference multi-var mode writer,
    PODFS.py:213-247/299-345): each vector variable contributes per-component
    scalars ``<var>_<k>_POD``, a magnitude ``<var>_magnitude_POD`` and the
    vector ``<var>_POD``; each scalar variable contributes one
    ``<var>_POD`` array.  Slot layout per variables.VariableSet."""
    out = {}
    for v, cc in varset.slot_ranges():
        block = packed[cc * num_cells:(cc + v.ncomp) * num_cells]
        if v.is_vector:
            out.update(_velocity_arrays(block, num_cells, 3, v.name))
        else:
            out[f"{v.name}_POD"] = block
    return out


def write_mean_field_vtk(
    outdir: str,
    mean_field: np.ndarray,
    geom: PlaneGeometry,
    var_name: str = "velocity",
    num_components: int = 3,
    varset=None,
) -> str:
    """``POD.spatial_mean_field_<var>.vtk`` (reference ``write_mean_field2``,
    PODFS.py:438-498) — cell-data on the inflow-plane quads.  Pass a
    :class:`variables.VariableSet` for multi-variable / scalar layouts."""
    cfg = geom.config
    conn = quad_connectivity(cfg.jma, cfg.kma)
    n_cells = cfg.jma * cfg.kma
    packed = np.asarray(mean_field, dtype=np.float64)
    if varset is not None:
        data = _varset_arrays(packed, n_cells, varset)
        var_name = varset.var_name
    else:
        data = _velocity_arrays(packed, n_cells, num_components, var_name)
    path = os.path.join(outdir, f"POD.spatial_mean_field_{var_name}.vtk")
    return write_unstructured_grid(
        path, geom.node_points, conn, cell_data=data,
        title=f"POD mean field ({var_name})")


def write_spatial_modes_vtk(
    outdir: str,
    spatial_modes: np.ndarray,
    geom: PlaneGeometry,
    num_modes_to_write: int | None = None,
    var_name: str = "velocity",
    num_components: int = 3,
    varset=None,
) -> list:
    """``POD.spatial_mode_<var>_%04d.vtk`` per mode (reference
    ``write_spatial_POD_modes_i_d``, PODFS.py:293-435) — point-data after
    cell→point averaging, matching the reference's vtkCellDataToPointData.

    With a :class:`variables.VariableSet` the multi-variable layout is used
    (per-var arrays; the file name carries the comma-joined var_name exactly
    like the reference, PODFS.py:298)."""
    cfg = geom.config
    jma, kma = cfg.jma, cfg.kma
    conn = quad_connectivity(jma, kma)
    n_cells = jma * kma
    modes = np.asarray(spatial_modes, dtype=np.float64)
    nm = modes.shape[1] if num_modes_to_write is None else num_modes_to_write
    if varset is not None:
        var_name = varset.var_name
    paths = []
    for j in range(nm):
        if varset is not None:
            cell_arrays = _varset_arrays(modes[:, j], n_cells, varset)
        else:
            cell_arrays = _velocity_arrays(modes[:, j], n_cells,
                                           num_components, var_name)
        point_arrays = {
            name: _cell_to_point(arr, jma, kma)
            for name, arr in cell_arrays.items()
        }
        path = os.path.join(
            outdir, f"POD.spatial_mode_{var_name}_{j + 1:04d}.vtk")
        write_unstructured_grid(
            path, geom.node_points, conn, point_data=point_arrays,
            title=f"POD spatial mode {j + 1} ({var_name})")
        paths.append(path)
    return paths


def write_field_vtk(
    outdir: str,
    name: str,
    packed_u: np.ndarray,
    geom: PlaneGeometry,
    var_name: str = "velocity",
    num_components: int = 3,
) -> str:
    """One snapshot / arbitrary packed field as cell-data
    (reference ``write_field``, PODFS.py:129-199)."""
    cfg = geom.config
    conn = quad_connectivity(cfg.jma, cfg.kma)
    n_cells = cfg.jma * cfg.kma
    data = _velocity_arrays(np.asarray(packed_u, dtype=np.float64),
                            n_cells, num_components, var_name)
    path = os.path.join(outdir, name if name.endswith(".vtk") else name + ".vtk")
    return write_unstructured_grid(
        path, geom.node_points, conn, cell_data=data,
        title=f"field ({var_name})")


def read_unstructured_grid(path: str) -> dict:
    """Minimal reader for files produced by :func:`write_unstructured_grid`
    (round-trip testing and downstream tooling)."""
    with open(path, "rb") as f:
        blob = f.read()

    def find_line(start, prefix):
        idx = blob.index(prefix, start)
        end = blob.index(b"\n", idx)
        return idx, end, blob[idx:end].decode()

    out = {"cell_data": {}, "point_data": {}}
    _, end, line = find_line(0, b"POINTS")
    n_pts = int(line.split()[1])
    pts_start = end + 1
    pts_bytes = n_pts * 3 * 8
    out["points"] = np.frombuffer(
        blob[pts_start:pts_start + pts_bytes], dtype=">f8").reshape(n_pts, 3)

    _, end, line = find_line(pts_start + pts_bytes, b"CELLS")
    n_cells, total = int(line.split()[1]), int(line.split()[2])
    c_start = end + 1
    cells = np.frombuffer(blob[c_start:c_start + total * 4], dtype=">i4")
    npc = cells[0]
    out["connectivity"] = cells.reshape(n_cells, npc + 1)[:, 1:].astype(np.int64)

    for section, key, count in ((b"CELL_DATA", "cell_data", n_cells),
                                (b"POINT_DATA", "point_data", n_pts)):
        try:
            sec_idx, sec_end, _ = find_line(0, section)
        except ValueError:
            continue
        pos = sec_end + 1
        while pos < len(blob):
            nl = blob.find(b"\n", pos)
            if nl < 0:
                break
            line = blob[pos:nl].decode(errors="replace").strip()
            if line.startswith("SCALARS"):
                name = line.split()[1]
                pos = blob.index(b"\n", blob.index(b"LOOKUP_TABLE", nl)) + 1
                nbytes = count * 8
                out[key][name] = np.frombuffer(
                    blob[pos:pos + nbytes], dtype=">f8").copy()
                pos += nbytes
            elif line.startswith("VECTORS"):
                name = line.split()[1]
                pos = nl + 1
                nbytes = count * 3 * 8
                out[key][name] = np.frombuffer(
                    blob[pos:pos + nbytes], dtype=">f8").reshape(count, 3).copy()
                pos += nbytes
            elif line.startswith(("CELL_DATA", "POINT_DATA")) and pos > sec_idx:
                break
            else:
                pos = nl + 1
    return out
