"""PODFS compression of existing snapshot data (no generation) — port of
``pods_digital_filter_tpu/compress.py``.

The reference's secondary input path: assemble the POD input matrix from
``inflow.%06i`` text snapshots (``read_inflow_data``, PODFS.py:1230-1240) or
from LES plane extraction (``save_Planes``, PODFS.py:623-852), then run the
same POD + Fourier compression + export stack, the POD's products on
``device`` (default the card).  CLI:

    python -m pods_digital_filter_tpu_torch.compress --num-snapshots 100 \\
        --num-cells 4096 --dt 1e-3 [-m 20] [-e 0.9] [--points points.txt] [-5]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pods_digital_filter_tpu_torch.device import resolve_device

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def compress_snapshot_matrix(
    A,
    points: np.ndarray,
    dt: float,
    num_modes: int,
    energy_target: float,
    outdir: str,
    tol_cn: float = 1.0e-15,
    cell_weights=None,
    write_hdf5: bool = False,
    verbose: bool = False,
    varset=None,
    dtype=None,
    device="cuda",
):
    """POD + Fourier compression + export for an arbitrary snapshot matrix
    ``A`` (S*Np, Ns) — numpy, or a tensor — with cell coordinates
    ``points`` (Np, 3).

    ``varset`` (a :class:`variables.VariableSet`) declares the variable
    slots ``S`` — the reference's multi-variable POD (``num_vars`` at
    PODFS.py:1294, packing PODFS.py:706-734).  Default: 3-component
    velocity.  ``dtype`` (float32 by default, or float64; a name or a torch
    dtype) is the POD's on ``device``.  Returns ``(PODResult,
    FourierResult, files)``.
    """
    from pods_digital_filter_tpu_torch.io import hdf5 as hdf5_io
    from pods_digital_filter_tpu_torch.io import prf as prf_io
    from pods_digital_filter_tpu_torch.ops import fourier, pod
    from pods_digital_filter_tpu_torch.variables import VariableSet

    dev = resolve_device(device)
    dtype = _DTYPES.get(dtype, dtype) or torch.float32
    varset = varset or VariableSet.velocity()
    npts = points.shape[0]
    if A.shape[0] != varset.num_slots * npts:
        raise ValueError(
            f"A has {A.shape[0]} rows; varset '{varset.var_name}' with "
            f"{npts} points needs {varset.num_slots * npts}")
    os.makedirs(outdir, exist_ok=True)
    files = []

    At = torch.as_tensor(A if isinstance(A, torch.Tensor) else np.asarray(A),
                         dtype=dtype, device=dev)
    mean_field, Ac, C = pod.center_and_gram(At)
    del At
    if cell_weights is not None:
        C = pod.gram_matrix(Ac, cell_weights)
    pr = pod.snapshot_pod(Ac, num_modes, tol_cn, gram=C)
    del Ac, C
    fr = fourier.fourier_compress(pr.temporal_modes, pr.num_trunc, dt,
                                  energy_target)
    mean_host = pod.to_numpy(mean_field).astype(np.float64)

    files.append(prf_io.write_eigenvalues(outdir, pr.num_valid, pr.energy))
    files.append(prf_io.write_podfs_dat(outdir, fr))
    files.append(_write_prf_points(
        os.path.join(outdir, "PODFS_mean.prf"), points, mean_host, npts,
        varset))
    for i in range(pr.num_trunc):
        files.append(_write_prf_points(
            os.path.join(outdir, f"PODFS_mode_{i + 1:04d}.prf"),
            points, pr.spatial_modes[:, i], npts, varset))
    if verbose:
        files.extend(prf_io.write_temporal_modes(
            outdir, pr.num_valid, dt, pr.temporal_modes))
    if write_hdf5:
        files.append(hdf5_io.write_hdf5(
            outdir, pr.num_trunc, fr.period, fr.counts, fr.packed_fc(),
            points, mean_host, pr.spatial_modes, varset=varset))
    return pr, fr, files


def _write_prf_points(path: str, points: np.ndarray, packed: np.ndarray,
                      npts: int, varset) -> str:
    from pods_digital_filter_tpu_torch.io.prf import _prf_header, _write_points_uvw

    u = varset.table(packed, npts)
    with open(path, "w") as f:
        f.write(_prf_header("PODFS compressed snapshot data",
                            (1.0, 0.0, 0.0), 0.0,
                            columns=varset.column_names))
        _write_points_uvw(f, points, u)
    return path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pods_digital_filter_tpu_torch.compress",
        description="PODFS-compress existing snapshot data "
                    "(inflow.%06i files) into a PODFS model")
    p.add_argument("--input-dir", default=".",
                   help="directory holding the snapshot files")
    p.add_argument("--prefix", default="inflow.",
                   help="snapshot file prefix (files <prefix>%%06d)")
    p.add_argument("--num-snapshots", type=int, required=True)
    p.add_argument("--num-cells", type=int, required=True)
    p.add_argument("--num-components", type=int, default=None,
                   help="total variable slots per point (default: from "
                        "--vars)")
    p.add_argument("--vars", default="velocity:3", metavar="SPEC",
                   help="variable layout: comma-separated names, each "
                        "optionally name:ncomp (1=scalar, 3=vector), e.g. "
                        "'velocity:3,k,epsilon' — the multi-variable POD "
                        "of the reference (PODFS.py:1294, 706-734)")
    p.add_argument("--dt", type=float, required=True,
                   help="snapshot time spacing (s)")
    p.add_argument("--points", default=None,
                   help="optional (Np, 3) whitespace table of cell "
                        "coordinates; zeros if absent")
    p.add_argument("-m", "--nm", type=int, default=20)
    p.add_argument("-e", "--et", type=float, default=0.9)
    p.add_argument("-5", "--hdf5", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--outdir", default="PODFS")
    p.add_argument("--device", default="cuda",
                   help="torch device of the POD: cuda (default; raises "
                        "without a card) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from pods_digital_filter_tpu_torch.postproc.probes import read_inflow_data
    from pods_digital_filter_tpu_torch.variables import VariableSet

    resolve_device(args.device)          # refuse a missing card before reading
    varset = VariableSet.parse(args.vars)
    num_slots = args.num_components or varset.num_slots
    if num_slots != varset.num_slots:
        raise ValueError(
            f"--num-components {num_slots} != {varset.num_slots} slots of "
            f"--vars '{args.vars}'")
    A = read_inflow_data(args.num_snapshots, args.num_cells,
                         num_slots, args.input_dir, args.prefix)
    if args.points:
        points = np.loadtxt(args.points)
        if points.shape != (args.num_cells, 3):
            raise ValueError(
                f"points table must be ({args.num_cells}, 3); "
                f"got {points.shape}")
    else:
        points = np.zeros((args.num_cells, 3))

    pr, fr, files = compress_snapshot_matrix(
        A, points, args.dt, args.nm, args.et, args.outdir,
        write_hdf5=args.hdf5, verbose=args.verbose, varset=varset,
        device=args.device)
    print(f"PODFS model written to {args.outdir}/ "
          f"({pr.num_trunc} modes, period {fr.period:.6g} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
