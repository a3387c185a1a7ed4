"""Judge a PODFS model on disk against the plain reference of its snapshots.

The reference computes, in float64 from the snapshot columns that a
``columns(t0, n)`` source hands it (the reference generator, or the same
matrix the program was given), in one blocked sweep:

* the column mean;
* the centred Gram ``G = Ac^T Ac`` and its eigenvalues (``eigvalsh``);
* ``Q = Ac^T Phi`` and ``S = Ac Ac^T Phi`` for the program's spatial modes
  ``Phi``, read from its files.

From these it judges what the program wrote, independently of the
eigenvectors' signs and of near-equal eigenvalues:

* ``mean_err``: the written mean against the reference's, over the largest
  root mean square of a raw element over time;
* ``energy_err``: the written eigenvalues of the kept modes against the
  reference's, over the largest;
* ``mode_resid``: ``|Ac Ac^T phi / Ns - lambda phi|`` of each written mode
  and its written eigenvalue, over the largest eigenvalue: zero for an exact
  eigenpair;
* ``fourier_err``: each written Fourier coefficient against the DFT of the
  reference's coefficient series ``Q`` of that mode, at the wavenumbers
  written, over the mode's largest reference coefficient; a wrong period
  counts as its relative error;
* ``fourier_coverage_err``: how far the written terms of a mode fall short
  of the energy target the configuration states, ``et - sum|c_r[written]| /
  sum|c_r|`` over the reference's DFT of the mode, the worst mode, 0 where
  every mode reaches it: too few terms, or a lower target, read here;
* ``modes_missing``: how many kept modes the files lack against the
  reference's truncation (an exact count);
* ``files_missing``: how many of the files the program writes for a model
  are absent or empty (an exact count); where any is, nothing else is read.

Also read, and printed, but not compared: ``fourier_count_err``, the most
by which a mode's written term count differs from the count the reference's
own magnitudes give for the same target.

Nothing here imports the program; the files are parsed here.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch


# ---------------------------------------------------------------------------
# The program's files
# ---------------------------------------------------------------------------

def read_prf(path):
    """``(Np, S)`` data columns after ``x,y,z`` of a ``.prf`` field file."""
    with open(path, "rb") as f:
        raw = f.read()
    at = raw.index(b"\ndata,")
    head_end = raw.index(b"\n", at + 1)
    ncols = raw[at + 1:head_end].count(b",")
    vals = np.fromstring(raw[head_end + 1:].replace(b"\n", b",").decode(),
                         dtype=np.float64, sep=",")
    return vals.reshape(-1, ncols)[:, 3:]


def read_podfs_dat(path):
    """``(period, [(k, c) per mode])`` of a ``PODFS.dat`` control file."""
    with open(path) as f:
        lines = f.read().split("\n")
    nm = int(lines[0])
    period = float(lines[1])
    counts = [int(lines[2 + i].split("\t")[1]) for i in range(nm)]
    pos, modes = 2 + nm, []
    for n in counts:
        tab = np.array([[float(v) for v in lines[pos + r].split("\t")]
                        for r in range(n)]).reshape(n, 3)
        modes.append((tab[:, 0].astype(np.int64), tab[:, 1] + 1j * tab[:, 2]))
        pos += n
    return period, modes


def read_eigenvalues(path):
    vals = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and not line.startswith("#") and not parts[0].startswith("#"):
                vals.append(float(parts[1]))
    return np.array(vals)


#: the files every model holds; ``PODFS_mode_%04d.prf`` for each mode that
#: ``PODFS.dat`` lists is counted by ``modes_missing``
MODEL_FILES = ("PODFS.dat", "PODFS_mean.prf", "POD.eigenvalues.dat")


def missing_files(model_dir, patterns=()):
    """The names of ``MODEL_FILES`` and the ``patterns`` (a name, or one
    ``*`` for any part of it) that match no non-empty file in
    ``model_dir``."""
    names = os.listdir(model_dir) if os.path.isdir(model_dir) else []
    out = []
    for pat in MODEL_FILES + tuple(patterns):
        head, _, tail = pat.partition("*")
        found = [n for n in names if n == pat or "*" in pat and len(n) >= len(
            head) + len(tail) and n.startswith(head) and n.endswith(tail)]
        if not any(os.path.getsize(os.path.join(model_dir, n)) > 0
                   for n in found):
            out.append(pat)
    return out


def read_model(model_dir):
    period, fc = read_podfs_dat(os.path.join(model_dir, "PODFS.dat"))
    pack = lambda tab: tab.reshape(-1, order="F")
    mean = pack(read_prf(os.path.join(model_dir, "PODFS_mean.prf")))
    modes = [pack(read_prf(os.path.join(model_dir, "PODFS_mode_%04d.prf"
                                        % (i + 1))))
             for i in range(len(fc))
             if os.path.isfile(os.path.join(model_dir, "PODFS_mode_%04d.prf"
                                            % (i + 1)))]
    energy = read_eigenvalues(os.path.join(model_dir, "POD.eigenvalues.dat"))
    return dict(period=period, fourier=fc, mean=mean,
                modes=np.stack(modes, axis=1) if modes else None,
                energy=energy)


# ---------------------------------------------------------------------------
# The reference sweep
# ---------------------------------------------------------------------------

def sweep(columns, rows, ns, block, phi, device, shift=None):
    """One blocked sweep over the snapshot columns in float64.

    ``columns(t0, n)`` returns ``(rows, n)`` float64 on ``device``; ``phi``
    is ``(rows, m)``.  Blocks are held as many at a time as the device's
    free memory allows (all of them on the CPU) to form every Gram tile; each block
    is generated once as a member of its group plus once per later group.
    ``shift`` (a ``(rows,)`` guess of the mean, default the first block's)
    keeps the sums free of cancellation.  Returns ``(mean, G, Q, S,
    scale)``: centred, on ``device``, and the largest root mean square of a
    raw element."""
    dev = torch.device(device)
    nb = -(-ns // block)
    width = lambda i: min(block, ns - i * block)
    group = nb
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        per = rows * block * 8
        # room for a block in generation (about three block sizes) and
        # the sweep's own block beside the held ones
        group = max(1, min(nb, int((free - 4 * per - 2 ** 31) // per)))
    phi = torch.as_tensor(phi, dtype=torch.float64, device=dev)
    G = torch.zeros((ns, ns), dtype=torch.float64, device=dev)
    Q = torch.zeros((ns, phi.shape[1]), dtype=torch.float64, device=dev)
    S = torch.zeros_like(phi)
    colsum = torch.zeros(rows, dtype=torch.float64, device=dev)
    sq = torch.zeros(rows, dtype=torch.float64, device=dev)
    c0 = None if shift is None else torch.as_tensor(
        shift, dtype=torch.float64, device=dev)

    def get(i):
        nonlocal c0
        A = columns(i * block, width(i))
        if c0 is None:
            c0 = A.mean(dim=1)
        return A.sub_(c0[:, None])

    for g0 in range(0, nb, group):
        g1 = min(g0 + group, nb)
        held = []
        for i in range(g0, g1):
            A = get(i)
            sl = slice(i * block, i * block + width(i))
            colsum += A.sum(dim=1)
            sq += A.square().sum(dim=1)
            Q[sl] = A.T @ phi
            S += A @ Q[sl]
            for j, B in zip(range(g0, i), held):
                G[sl, j * block:j * block + width(j)] = A.T @ B
            G[sl, sl] = A.T @ A
            held.append(A)
        for i in range(g1, nb):
            A = get(i)
            sl = slice(i * block, i * block + width(i))
            for j, B in zip(range(g0, g1), held):
                G[sl, j * block:j * block + width(j)] = A.T @ B
            del A
        del held
    G = torch.tril(G) + torch.tril(G, -1).T
    mu = colsum / ns
    p = G.sum(dim=1) / ns
    G = G - p[:, None] - p[None, :] + G.sum() / ns ** 2
    muphi = mu @ phi
    Q = Q - muphi[None, :]
    S = S - ns * mu[:, None] * muphi[None, :]
    # the largest root mean square over time of a raw element: the scale
    # of the field that the mean is judged against
    scale = torch.sqrt((sq + 2 * c0 * colsum) / ns + c0 ** 2).max()
    return c0 + mu, G, Q, S, float(scale)


def count_valid(energy, tol_cn=1.0e-15):
    """The reference's valid-mode count (PODFS.py:1312-1318)."""
    ns, tol2, nv = energy.shape[0], tol_cn ** 2, 0
    while (energy[nv] / energy[0] > tol2) and nv < ns - 2 and energy[nv] > 0:
        nv += 1
        if energy[nv] / energy[0] > tol2 and energy[nv] > 0:
            nv += 1
    return nv


def select_count(mag, energy_target):
    """The fewest terms, largest magnitudes first, whose magnitudes sum to
    ``energy_target`` of the total (at least one): the selection rule of
    the PODFS method (Fourier terms of a mode ranked by magnitude)."""
    csum = np.cumsum(np.sort(mag)[::-1])
    if not csum[-1] > 0:
        return 0
    return min(int(np.searchsorted(csum, energy_target * csum[-1],
                                   side="left")) + 1, mag.shape[0])


def judge(model_dir, columns, rows, ns, dt, num_modes, energy_target, block,
          device, shift=None, files=()):
    """The compared numbers of one written model (see the module's doc);
    ``files`` are glob patterns of further files the program writes."""
    lost = missing_files(model_dir, files)
    if lost:
        return {"files_missing": float(len(lost))}, {"missing files": lost}
    m = read_model(model_dir)
    lam_p = m["energy"]
    phi = m["modes"]
    if phi is None:
        phi = np.zeros((rows, 1))
    mean, G, Q, S, scale = sweep(columns, rows, ns, block, phi, device, shift)
    lam_r = torch.linalg.eigvalsh(G / ns).flip(0).cpu().numpy()
    nv = count_valid(lam_r)
    trunc = nv if num_modes < 0 or num_modes > nv else num_modes
    kept = 0 if m["modes"] is None else phi.shape[1]
    out = {"files_missing": 0.0, "modes_missing": float(abs(trunc - kept))}
    k = min(trunc, kept, lam_p.shape[0])
    lam0 = float(lam_r[0])
    mean_r = mean.cpu().numpy()
    out["mean_err"] = float(np.max(np.abs(m["mean"] - mean_r))) / scale
    out["energy_err"] = float(np.max(np.abs(lam_p[:k] - lam_r[:k]))) / lam0
    phi_t = torch.as_tensor(phi[:, :k], dtype=torch.float64, device=S.device)
    lam_t = torch.as_tensor(lam_p[:k], dtype=torch.float64, device=S.device)
    R = S[:, :k] / ns - phi_t * lam_t[None, :]
    out["mode_resid"] = float(torch.linalg.vector_norm(R, dim=0).max()) / lam0
    q = Q[:, :k].cpu().numpy()
    c_r = np.fft.fftshift(np.fft.fft(q, axis=0), axes=0) / ns
    worst = abs(m["period"] - ns * dt) / (ns * dt)
    short, counts = 0.0, []
    for j in range(k):
        ks, c_p = m["fourier"][j]
        if ks.size and (ks.min() < -(ns // 2) or ks.max() >= ns - ns // 2):
            worst = short = math.inf
            continue
        ref = c_r[ks + ns // 2, j]
        mag = np.abs(c_r[:, j])
        worst = max(worst, float(np.max(np.abs(c_p - ref), initial=0.0)
                                 / np.max(mag)))
        # a wavenumber written twice covers its magnitude once
        covered = mag[np.unique(ks) + ns // 2].sum() / mag.sum()
        short = max(short, energy_target - float(covered))
        counts.append(ks.size - select_count(mag, energy_target))
    out["fourier_err"] = worst
    out["fourier_coverage_err"] = short
    out["fourier_count_err"] = float(max(map(abs, counts), default=0))
    info = {"eigenvalue_0": lam0, "kept_modes": kept,
            "reference_valid": nv, "period": m["period"],
            "fourier_counts": [len(f[0]) for f in m["fourier"]],
            "fourier_count_diff": counts}
    return out, info
