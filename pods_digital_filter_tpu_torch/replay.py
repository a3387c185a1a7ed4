"""PODFS replay — the CFD-solver side of the PODFS model; port of
``pods_digital_filter_tpu/replay.py``.

The reference defines the replay equation a downstream solver evaluates at
its inlet every timestep (docs/usage/CFDCodeIntegration.rst:85-91):

    U(x,t) = alpha * U_mean(x)
             + sum_i phi_i(x) * Re[ sum_j b_{i,j} * exp(2*pi*1j*k_{i,j}*t/T) ]

Load a saved model from either on-disk format (``PODFS.dat`` +
``PODFS_mean.prf``/``PODFS_mode_%04i.prf``, or ``PODFS.hdf5``) and evaluate
it at many times on the device:

* the temporal factors ``b_i(t)`` for a batch of times are a dense
  ``cos``/``sin`` contraction over the zero-padded per-mode coefficient
  table (padding coefficients are exactly zero, so no masking is needed),
  in real arithmetic as in the original;
* the spatial superposition is one ``(Nt, nm) @ (nm, S*Np)`` ``torch.matmul``
  (the original leaves it to XLA, outside any Pallas kernel).

The model is held in float64 by default (the original's dtype under
``jax_enable_x64``, how its tests run) and ``theta = 2*pi*k*t/T`` is formed
in the chosen dtype; ``dtype=torch.float32`` is the option.

Loaders read through the port's own ``io/prf.py`` and ``io/hdf5.py``.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass

import numpy as np
import torch

from pods_digital_filter_tpu_torch.device import resolve_device
from pods_digital_filter_tpu_torch.io.prf import read_field_prf

_DTYPES = {None: torch.float64, "float64": torch.float64,
           "float32": torch.float32}


# --------------------------------------------------------------------------
# Model container + loaders
# --------------------------------------------------------------------------

@dataclass
class PODFSModel:
    """A loaded PODFS model, padded to rectangular numpy arrays.

    ``k/c_re/c_im`` are (nm, kmax) with zero-padded coefficients — a zero
    coefficient contributes nothing, so the ragged per-mode counts need no
    mask on the compute path.
    """
    points: np.ndarray        # (Np, 3) plane cell centres
    mean: np.ndarray          # (S*Np,) packed mean field (slot blocks)
    modes: np.ndarray         # (nm, S*Np) packed spatial modes
    period: float
    k: np.ndarray             # (nm, kmax) integer wavenumbers (float array)
    c_re: np.ndarray          # (nm, kmax)
    c_im: np.ndarray          # (nm, kmax)
    counts: np.ndarray        # (nm,) original per-mode coefficient counts

    @property
    def num_modes(self) -> int:
        return self.modes.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    #: data column names after x,y,z (from the .prf ``data,`` header or the
    #: HDF5 ``Vars`` attr); ``("u","v","w")`` for velocity models
    columns: tuple = ("u", "v", "w")

    @property
    def num_slots(self) -> int:
        """Variable slots per point: 3 for velocity models, 3 + number of
        scalars for multi-variable models (variables.VariableSet layout)."""
        return self.mean.shape[0] // self.points.shape[0]

    @classmethod
    def from_arrays(cls, points, mean, modes, period, fc_per_mode,
                    columns=("u", "v", "w")) -> "PODFSModel":
        """A model from plain numpy arrays — ``mean`` packed (S*Np,),
        ``modes`` (nm, S*Np), ``fc_per_mode`` the ragged list of (count_i,
        3) [k, Re, Im] tables — padded by :func:`_pad_fc` as the loaders
        pad."""
        k, c_re, c_im, counts = _pad_fc(fc_per_mode)
        return cls(points=np.asarray(points, dtype=np.float64),
                   mean=np.asarray(mean, dtype=np.float64),
                   modes=np.asarray(modes, dtype=np.float64),
                   period=float(period), k=k, c_re=c_re, c_im=c_im,
                   counts=counts, columns=tuple(columns))


def _pad_fc(fc_per_mode):
    """Ragged list of (count_i, 3) [k, Re, Im] tables -> padded arrays."""
    nm = len(fc_per_mode)
    kmax = max((t.shape[0] for t in fc_per_mode), default=0) or 1
    k = np.zeros((nm, kmax))
    c_re = np.zeros((nm, kmax))
    c_im = np.zeros((nm, kmax))
    counts = np.zeros(nm, dtype=np.int64)
    for i, tab in enumerate(fc_per_mode):
        n = tab.shape[0]
        counts[i] = n
        if n:
            k[i, :n] = tab[:, 0]
            c_re[i, :n] = tab[:, 1]
            c_im[i, :n] = tab[:, 2]
    return k, c_re, c_im, counts


def _pack(u: np.ndarray) -> np.ndarray:
    """(Np, S) table -> packed (S*Np,) slot-block vector, the
    snapshot-matrix layout (digitalfilters.py:1471-1473)."""
    return u.reshape(-1, order="F")


def read_prf_columns(path: str) -> tuple:
    """Data column names (after x,y,z) from a ``.prf`` ``data,`` header."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("data,"):
                cols = [c.strip() for c in line.split(",")[1:]]
                return tuple(cols[3:]) if len(cols) > 3 else ("u", "v", "w")
    return ("u", "v", "w")


def load_prf(model_dir: str) -> PODFSModel:
    """Load the ``.prf`` flavor: ``PODFS.dat`` + ``PODFS_mean.prf`` +
    ``PODFS_mode_%04i.prf`` from ``model_dir``."""
    from pods_digital_filter_tpu_torch.io.prf import read_podfs_dat

    period, fc_per_mode = read_podfs_dat(os.path.join(model_dir, "PODFS.dat"))
    mean_path = os.path.join(model_dir, "PODFS_mean.prf")
    points, mean_u = read_field_prf(mean_path)
    columns = read_prf_columns(mean_path)

    mode_paths = sorted(
        p for p in os.listdir(model_dir)
        if re.fullmatch(r"PODFS_mode_\d{4}\.prf", p)
    )
    nm = len(fc_per_mode)
    if len(mode_paths) < nm:
        raise FileNotFoundError(
            f"PODFS.dat declares {nm} modes but {model_dir} holds only "
            f"{len(mode_paths)} PODFS_mode_*.prf files")
    modes = np.stack(
        [_pack(read_field_prf(os.path.join(model_dir, p))[1]) for p in mode_paths[:nm]]
    )
    k, c_re, c_im, counts = _pad_fc(fc_per_mode)
    return PODFSModel(points=points, mean=_pack(mean_u), modes=modes,
                      period=period, k=k, c_re=c_re, c_im=c_im, counts=counts,
                      columns=columns)


def load_hdf5(path: str) -> PODFSModel:
    """Load the HDF5 flavor (format spec: CFDCodeIntegration.rst:56-74)."""
    from pods_digital_filter_tpu_torch.io.hdf5 import read_hdf5

    d = read_hdf5(path)
    fc_per_mode = []
    pos = 0
    for n in d["N_FC"]:
        fc_per_mode.append(d["FC"][pos:pos + int(n)])
        pos += int(n)
    points = d["mean"][:, 0:3]
    nslots = d["mean"].shape[1] - 3
    mean = _pack(d["mean"][:, 3:])
    modes = np.stack([_pack(m[:, 3:]) for m in d["modes"]]) if d["modes"] \
        else np.zeros((0, points.shape[0] * nslots))
    k, c_re, c_im, counts = _pad_fc(fc_per_mode)
    # Vars attr is 'x,y,z,<cols>,dummy' (reference HDF5.py:37)
    vars_attr = [c for c in d.get("vars", "").split(",") if c]
    columns = tuple(vars_attr[3:3 + nslots]) if len(vars_attr) >= 3 + nslots \
        else ("u", "v", "w")
    return PODFSModel(points=points, mean=mean, modes=modes,
                      period=d["period"], k=k, c_re=c_re, c_im=c_im,
                      counts=counts, columns=columns)


def load_model(path: str) -> PODFSModel:
    """Dispatch on path: a directory -> .prf flavor, a file -> HDF5."""
    if os.path.isdir(path):
        return load_prf(path)
    return load_hdf5(path)


# --------------------------------------------------------------------------
# Evaluation on the device
# --------------------------------------------------------------------------

def _eval(ts, k, c_re, c_im, modes, mean, period, alpha):
    # theta[t, i, j] = 2*pi * k[i,j] * ts[t] / T
    theta = (2.0 * math.pi / period) * ts[:, None, None] * k[None, :, :]
    # b[t, i] = Re( sum_j c * exp(1j*theta) )  — zero-padded coeffs drop out
    b = torch.sum(c_re[None] * torch.cos(theta) - c_im[None] * torch.sin(theta),
                  dim=-1)
    # (Nt, nm) @ (nm, S*Np) — one product for the whole batch of timesteps
    fields = b @ modes
    return alpha * mean[None, :] + fields


class Replayer:
    """PODFS inlet evaluator on ``device`` (default the card).

    >>> rp = Replayer(load_model("PODFS"))
    >>> u = rp(0.0124)            # (Np, 3) velocity at one time
    >>> U = rp.batch(times)       # (Nt, Np, 3) for a whole run, one GEMM

    ``dtype``: float64 (``None``, the default) or float32.  ``alpha`` is the
    mean-field scaling factor of the replay equation
    (CFDCodeIntegration.rst:87-91).
    """

    def __init__(self, model: PODFSModel, dtype=None, device="cuda"):
        dtype = _DTYPES.get(dtype, dtype)
        if dtype not in (torch.float64, torch.float32):
            raise ValueError(f"replay dtype must be float64 or float32; got {dtype}")
        self.device = resolve_device(device)
        self.model = model
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                         device=self.device)
        self._k = as_t(model.k)
        self._c_re = as_t(model.c_re)
        self._c_im = as_t(model.c_im)
        self._modes = as_t(model.modes)
        self._mean = as_t(model.mean)
        self._period = float(model.period)
        self._dtype = dtype

    def batch_device(self, ts, alpha: float = 1.0) -> torch.Tensor:
        """Evaluate at a batch of times -> packed device tensor (Nt, S*Np).

        Stays on the device (no host copy): each packed row is the
        snapshot-matrix layout [u-block; v-block; w-block; scalars].
        ``ts`` may already be a tensor on the device, as the original takes
        a device array; host times are uploaded with a blocking copy, which
        waits for the device's queued work."""
        ts = torch.atleast_1d(torch.as_tensor(ts, dtype=self._dtype,
                                              device=self.device))
        return _eval(ts, self._k, self._c_re, self._c_im, self._modes,
                     self._mean, self._period, alpha)

    def batch(self, ts, alpha: float = 1.0) -> np.ndarray:
        """Evaluate at a batch of times -> (Nt, Np, S) on the host (S =
        variable slots; 3 for velocity models)."""
        out = self.batch_device(ts, alpha=alpha).cpu().numpy()
        npts = self.model.num_points
        ns = self.model.num_slots
        # each packed row is slot blocks -> (Np, S)
        return out.reshape(out.shape[0], ns, npts).transpose(0, 2, 1)

    def __call__(self, t: float, alpha: float = 1.0) -> np.ndarray:
        """Evaluate at one time -> (Np, S)."""
        return self.batch([t], alpha=alpha)[0]


# --------------------------------------------------------------------------
# CLI: replay a saved model back into snapshot files
# --------------------------------------------------------------------------

def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m pods_digital_filter_tpu_torch.replay",
        description="Replay a PODFS model (the CFD-solver-side evaluation, "
                    "CFDCodeIntegration.rst:85-91) at a series of times")
    p.add_argument("model", help="PODFS model: a directory with PODFS.dat + "
                                 ".prf files, or a PODFS.hdf5 file")
    p.add_argument("-n", "--nsteps", type=int, default=None,
                   help="number of equispaced times over one period "
                        "(default: inferred from -t if given, else 16)")
    p.add_argument("-t", "--dt", type=float, default=None,
                   help="time spacing (default: period / nsteps)")
    p.add_argument("--t0", type=float, default=0.0, help="start time")
    p.add_argument("--alpha", type=float, default=1.0,
                   help="mean-field scaling factor of the replay equation")
    p.add_argument("--outdir", default="PODFS_replay")
    p.add_argument("--format", choices=("prf", "npy"), default="prf",
                   help="output: per-time .prf profiles, or one "
                        "fields.npy (Nt, Np, 3) + times.npy")
    p.add_argument("--device", default="cuda",
                   help="torch device of the evaluation: cuda (default; "
                        "raises without a card) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    model = load_model(args.model)
    rp = Replayer(model, device=args.device)

    nsteps = args.nsteps or 16
    dt = args.dt if args.dt is not None else model.period / nsteps
    ts = args.t0 + dt * np.arange(nsteps)
    fields = rp.batch(ts, alpha=args.alpha)

    os.makedirs(args.outdir, exist_ok=True)
    if args.format == "npy":
        np.save(os.path.join(args.outdir, "fields.npy"), fields)
        np.save(os.path.join(args.outdir, "times.npy"), ts)
    else:
        from pods_digital_filter_tpu_torch.io.prf import write_field_prf

        for i, t in enumerate(ts):
            write_field_prf(
                os.path.join(args.outdir, ("%.5E" % float(t)) + ".prf"),
                "Replayed from PODFS model", model.points, fields[i],
                columns=model.columns)
    print(f"replayed {nsteps} timesteps (dt={dt:.6g} s, period="
          f"{model.period:.6g} s, {model.num_modes} modes, "
          f"{model.num_points} points) -> {args.outdir}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
