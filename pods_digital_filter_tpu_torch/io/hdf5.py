"""A copy of ``pods_digital_filter_tpu/io/hdf5.py`` (importing the original
loads jax through its package ``__init__``); h5py is imported lazily.

PODFS HDF5 export — format-identical to the reference writer
(``HDF5.py:11-64``; spec in docs/usage/CFDCodeIntegration.rst:56-74).

Layout:

* group ``main`` with attrs ``N_POD`` (int), ``period`` (float);
* dataset ``main/N_FC``: int count of Fourier coefficients per mode;
* dataset ``main/FC``: the (sum(N_FC), 3) [k, Re, Im] table flattened
  column-major (order='F'), i.e. all k's, then all Re's, then all Im's;
* dataset ``main/mean``: the (Np, Nvar) [x,y,z,<vars>] table flattened
  column-major, with attrs ``Np``, ``Nvar`` (3 + number of variable slots;
  6 for velocity), ``Vars`` (``'x,y,z,u,v,w,dummy'`` for velocity — the
  trailing ``dummy`` is reference-format, HDF5.py:37), ``SF=[1.]*Nvar``;
* group ``main/modes`` with one ``mode_%04i`` dataset per POD mode, same
  layout/attrs as ``mean``.

Multi-variable / scalar models (the reference's ``num_vars`` POD path,
PODFS.py:1294 + save_Planes packing, PODFS.py:706-734) pass a
:class:`variables.VariableSet`; the variable slots become the data columns
after x,y,z and ``Vars`` carries their names.
"""

from __future__ import annotations

import os

import numpy as np

from pods_digital_filter_tpu.variables import VariableSet


def _point_table(points: np.ndarray, u: np.ndarray) -> np.ndarray:
    ns = u.shape[1]
    tab = np.zeros((points.shape[0], 3 + ns), dtype=np.float64)
    tab[:, 0:3] = points
    tab[:, 3:] = u
    return tab


def _add_field_attrs(ds, num_points: int, varset: VariableSet):
    nvar = 3 + varset.num_slots
    ds.attrs["Np"] = num_points
    ds.attrs["Nvar"] = nvar
    ds.attrs["Vars"] = np.bytes_(
        "x,y,z," + ",".join(varset.column_names) + ",dummy")
    ds.attrs["SF"] = [1.0] * nvar


def write_hdf5(
    outdir: str,
    num_modes: int,
    period: float,
    n_fc: np.ndarray,          # (num_modes,) int
    fc: np.ndarray,            # (sum(n_fc), 3) [k, Re, Im]
    points: np.ndarray,        # (Np, 3) cell centres
    mean_field: np.ndarray,    # (S*Np,) packed mean
    spatial_modes: np.ndarray, # (S*Np, num_modes)
    filename: str = "PODFS.hdf5",
    varset: VariableSet | None = None,
) -> str:
    import h5py

    varset = varset or VariableSet.velocity()
    num_points = points.shape[0]
    nvar = 3 + varset.num_slots
    path = os.path.join(outdir, filename)
    with h5py.File(path, "w") as f:
        main = f.create_group("main")
        main.attrs["N_POD"] = num_modes
        main.attrs["period"] = period

        ds = main.create_dataset("N_FC", (num_modes,), dtype="i")
        ds[:] = np.asarray(n_fc, dtype=np.int64)

        total = int(np.sum(n_fc))
        ds = main.create_dataset("FC", (total * 3,), dtype=np.float64)
        ds[:] = np.asarray(fc, dtype=np.float64).reshape(total * 3, order="F")

        mean_tab = _point_table(points, varset.table(mean_field, num_points))
        ds = main.create_dataset("mean", (num_points * nvar,), dtype=np.float64)
        ds[:] = mean_tab.reshape(num_points * nvar, order="F")
        _add_field_attrs(ds, num_points, varset)

        modes = main.create_group("modes")
        for i in range(num_modes):
            counter = "%4.4i" % (i + 1)
            tab = _point_table(
                points, varset.table(spatial_modes[:, i], num_points))
            ds = modes.create_dataset("mode_" + counter,
                                      (num_points * nvar,), dtype=np.float64)
            ds[:] = tab.reshape(num_points * nvar, order="F")
            _add_field_attrs(ds, num_points, varset)
    return path


def read_hdf5(path: str) -> dict:
    """Load a PODFS.hdf5 back into arrays (tests / replay).  ``mean`` and
    ``modes`` tables are (Np, Nvar); ``vars`` carries the column names."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        main = f["main"]
        out["N_POD"] = int(main.attrs["N_POD"])
        out["period"] = float(main.attrs["period"])
        out["N_FC"] = np.asarray(main["N_FC"])
        total = int(out["N_FC"].sum())
        out["FC"] = np.asarray(main["FC"]).reshape((total, 3), order="F")
        mean = main["mean"]
        npts = int(mean.attrs["Np"])
        nvar = int(mean.attrs.get("Nvar", 6))
        out["Np"] = npts
        out["Nvar"] = nvar
        out["vars"] = (mean.attrs["Vars"].decode()
                       if isinstance(mean.attrs.get("Vars"), bytes)
                       else str(mean.attrs.get("Vars", "")))
        out["mean"] = np.asarray(mean).reshape((npts, nvar), order="F")
        out["modes"] = []
        for i in range(out["N_POD"]):
            ds = f["main/modes/mode_" + "%4.4i" % (i + 1)]
            out["modes"].append(np.asarray(ds).reshape((npts, nvar), order="F"))
    return out
