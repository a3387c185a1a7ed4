"""A copy of ``pods_digital_filter_tpu/diagnostics/plots.py``: the
matplotlib diagnostics, off the hot path (numpy in, PNG out); only
:func:`pod_diagnostics` computes, through the port's
:func:`~pods_digital_filter_tpu_torch.ops.signal.welch_psd` on ``device``.
Import it through :func:`pods_digital_filter_tpu_torch.diagnostics.load_plots`,
which reports a host without matplotlib.

Off-hot-path matplotlib diagnostics — the framework's replacement for
the reference's ``nplotlib.py`` wrapper layer.

Main-path functions (``contourf``, ``timeseries``, ``PSD``, ``eigs``;
nplotlib.py:84, 140, 393, 465) plus the general-purpose helpers the
reference exposes for post-processing scripts (``bar`` 46, ``plot`` 163,
``scatter`` 185, ``logscatter`` 314, ``hist`` 291, ``semilogx`` 382,
``PSD3`` 454, ``convergence`` 476, ``contourfquiver`` 105,
``contourfcontour`` 120, ``scatter_3d`` 491) and a matplotlib
``tricontourf`` equivalent of the offscreen-VTK field renderers
(``vtkcontourf``/``vtkcontourfgrid``, nplotlib.py:531/758) that works on
the framework's VTK-free plane geometry.  Agg backend, PNG output."""

from __future__ import annotations

import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def contourf(y, z, field, title: str, path: str, levels: int = 100, figsize=None):
    fig, ax = plt.subplots(figsize=figsize)
    cs = ax.contourf(y, z, field, levels, cmap="jet")
    fig.colorbar(cs, ax=ax)
    ax.set_xlabel("y")
    ax.set_ylabel("z")
    ax.set_title(title)
    ax.set_aspect("equal")
    fig.savefig(path + ".png", dpi=200, bbox_inches="tight")
    plt.close(fig)
    return path + ".png"


def timeseries(t, y, path: str, label: str = ""):
    fig, ax = plt.subplots()
    ax.plot(t, y)
    ax.set_xlabel("time")
    ax.set_ylabel(label)
    fig.savefig(path + ".png", dpi=200, bbox_inches="tight")
    plt.close(fig)
    return path + ".png"


def psd(freqs, Sxx, path: str, label: str = "Power"):
    fig, ax = plt.subplots()
    ax.loglog(np.asarray(freqs)[freqs > 0], np.asarray(Sxx)[freqs > 0])
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel(label)
    fig.savefig(path + ".png", dpi=200, bbox_inches="tight")
    plt.close(fig)
    return path + ".png"


def eigen_spectrum(energy, path: str):
    fig, ax = plt.subplots()
    e = np.asarray(energy)
    ax.semilogy(np.arange(1, len(e) + 1), np.maximum(e, 1e-300), "o-")
    ax.set_xlabel("mode")
    ax.set_ylabel(r"$\lambda$")
    fig.savefig(path + ".png", dpi=200, bbox_inches="tight")
    plt.close(fig)
    return path + ".png"


def wns(k, E, path: str, label: str = "E(k)"):
    """Wavenumber spectrum with the Kolmogorov -5/3 slope overlay
    (reference ``WNS``, nplotlib.py:415-441)."""
    k = np.asarray(k)
    E = np.asarray(E)
    sel = k > 0
    fig, ax = plt.subplots()
    ax.loglog(k[sel], E[sel], label=label)
    if sel.any() and E[sel].max() > 0:
        k0 = k[sel][max(1, sel.sum() // 8)]
        E0 = np.interp(k0, k[sel], E[sel])
        kk = k[sel]
        ax.loglog(kk, E0 * (kk / k0) ** (-5.0 / 3.0), "k--",
                  label=r"$k^{-5/3}$")
    ax.set_xlabel("wavenumber k")
    ax.set_ylabel(label)
    ax.legend()
    fig.savefig(path + ".png", dpi=200, bbox_inches="tight")
    plt.close(fig)
    return path + ".png"


def _save(fig, path: str) -> str:
    fig.savefig(path + ".png", dpi=200, bbox_inches="tight")
    plt.close(fig)
    return path + ".png"


def arrow_field(y, t, dx, dy, path: str, xlabel: str = "", ylabel: str = ""):
    """Per-point arrows (nplotlib.arrow, 250-260): one arrow from (t_i, y_i)
    along (dy_i, dx_i), equal aspect."""
    fig, ax = plt.subplots(figsize=(5, 5))
    for ti, yi, dxi, dyi in zip(t, y, dx, dy):
        ax.arrow(ti, yi, dyi, dxi, length_includes_head=True,
                 head_width=0.001, head_length=0.001, width=0.0001,
                 fc="k", ec="k")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_aspect("equal")
    return _save(fig, path)


def arc_arrow(y, t, dx, dy, path: str, xlabel: str = "", ylabel: str = ""):
    """Arcs about the origin with arrowheads (nplotlib.arcarrow, 262-288):
    per point, an elliptical arc from angle atan2(y, dx) to atan2(y+dx,
    t+dy) plus a tangential head arrow."""
    from matplotlib.patches import Arc

    fig, ax = plt.subplots(figsize=(5, 5))
    for ti, yi, dxi, dyi in zip(t, y, dx, dy):
        t2 = ti + dyi
        x2 = yi + dxi
        ax.add_patch(Arc((0, 0), 2 * ti, 2 * x2,
                         theta1=np.arctan2(yi, dxi) * 180.0 / np.pi,
                         theta2=np.arctan2(x2, t2) * 180.0 / np.pi,
                         edgecolor="k"))
        ax.arrow(t2 + 0.001, x2, -0.0001 * x2, 0.0001 * t2,
                 length_includes_head=False, head_width=0.001,
                 head_length=0.001, width=0.0001, fc="k", ec="k")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return _save(fig, path)


def plot_with_point(x, y, px, py, path: str, xlabel: str = "",
                    ylabel: str = ""):
    """Line plot with scatter-marked points (nplotlib.plotwithpoint, 369)."""
    fig, ax = plt.subplots()
    ax.scatter(px, py)
    ax.plot(x, y)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return _save(fig, path)


def plot(x, y, path: str, xlabel: str = "", ylabel: str = "", title: str = ""):
    """General x-y line plot (nplotlib.plot, 163)."""
    fig, ax = plt.subplots()
    ax.plot(x, y)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    return _save(fig, path)


def bar(heights, path: str, labels=None, ylabel: str = ""):
    """Bar chart (nplotlib.bar/sbar, 46/59)."""
    fig, ax = plt.subplots()
    x = np.arange(len(heights))
    ax.bar(x, heights)
    if labels is not None:
        ax.set_xticks(x, labels)
    ax.set_ylabel(ylabel)
    return _save(fig, path)


def hist(values, path: str, bins: int = 50, xlabel: str = ""):
    """Histogram (nplotlib.hist, 291)."""
    fig, ax = plt.subplots()
    ax.hist(np.asarray(values).ravel(), bins=bins)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("count")
    return _save(fig, path)


def scatter(x, y, path: str, xlabel: str = "", ylabel: str = "",
            equal_aspect: bool = False, loglog: bool = False):
    """Scatter plot (nplotlib.scatter/scatter2/scattereq/logscatter,
    185/202/220/314)."""
    fig, ax = plt.subplots()
    ax.scatter(x, y, s=6)
    if loglog:
        ax.set_xscale("log")
        ax.set_yscale("log")
    if equal_aspect:
        ax.set_aspect("equal")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return _save(fig, path)


def semilogx(x, y, path: str, xlabel: str = "", ylabel: str = ""):
    """Log-x line plot (nplotlib.semilogx, 382)."""
    fig, ax = plt.subplots()
    ax.semilogx(x, y)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return _save(fig, path)


def psd3(freqs, spectra, path: str, labels=None):
    """Overlay of several PSDs on one log-log axis (nplotlib.PSD3, 454)."""
    freqs = np.asarray(freqs)
    sel = freqs > 0
    fig, ax = plt.subplots()
    for i, Sxx in enumerate(spectra):
        lbl = labels[i] if labels else f"signal {i}"
        ax.loglog(freqs[sel], np.asarray(Sxx)[sel], label=lbl)
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel("PSD")
    ax.legend()
    return _save(fig, path)


def convergence(values, path: str, ylabel: str = "residual"):
    """Iteration-convergence semilogy plot (nplotlib.convergence, 476)."""
    v = np.maximum(np.abs(np.asarray(values, dtype=np.float64)), 1e-300)
    fig, ax = plt.subplots()
    ax.semilogy(np.arange(1, len(v) + 1), v, "o-")
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel)
    return _save(fig, path)


def contourf_quiver(y, z, field, vy, vz, path: str, title: str = "",
                    levels: int = 100, stride: int = 2):
    """Filled contours + in-plane velocity arrows (nplotlib.contourfquiver,
    105)."""
    fig, ax = plt.subplots()
    cs = ax.contourf(y, z, field, levels, cmap="jet")
    fig.colorbar(cs, ax=ax)
    ax.quiver(np.asarray(y)[::stride, ::stride], np.asarray(z)[::stride, ::stride],
              np.asarray(vy)[::stride, ::stride], np.asarray(vz)[::stride, ::stride])
    ax.set_aspect("equal")
    ax.set_title(title)
    return _save(fig, path)


def contourf_contour(y, z, field, overlay, path: str, title: str = "",
                     levels: int = 100, overlay_levels: int = 10):
    """Filled contours with line-contour overlay (nplotlib.contourfcontour,
    120)."""
    fig, ax = plt.subplots()
    cs = ax.contourf(y, z, field, levels, cmap="jet")
    fig.colorbar(cs, ax=ax)
    ax.contour(y, z, overlay, overlay_levels, colors="k", linewidths=0.5)
    ax.set_aspect("equal")
    ax.set_title(title)
    return _save(fig, path)


def scatter_3d(x, y, z, path: str, c=None):
    """3-D point cloud (nplotlib.scatter_3d, 491)."""
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.scatter(x, y, z, c=c, s=4)
    return _save(fig, path)


def render_field(points, values, path: str, title: str = "",
                 component: int | None = None, levels: int = 100):
    """Render a field on an arbitrary plane point cloud — the matplotlib
    equivalent of the reference's offscreen-VTK contour renderers
    (``vtkcontourf``/``vtkcontourf_obj``/``vtkcontourfgrid``,
    nplotlib.py:531-845), using the two dominant in-plane coordinates and
    ``tricontourf`` so no structured grid or VTK library is needed.

    ``values`` is (Np,) scalar, (Np, 3) vector (renders magnitude unless
    ``component`` picks one), or packed (3*Np,).
    """
    points = np.asarray(points)
    values = np.asarray(values)
    npts = points.shape[0]
    if values.ndim == 1 and values.size == 3 * npts:
        values = values.reshape(npts, 3, order="F")
    if values.ndim == 2:
        values = values[:, component] if component is not None \
            else np.linalg.norm(values, axis=1)

    # project onto the two largest-extent coordinate axes
    spans = points.max(axis=0) - points.min(axis=0)
    a, b = np.argsort(spans)[-2:]
    fig, ax = plt.subplots()
    cs = ax.tricontourf(points[:, a], points[:, b], values, levels, cmap="jet")
    fig.colorbar(cs, ax=ax)
    ax.set_xlabel("xyz"[a])
    ax.set_ylabel("xyz"[b])
    ax.set_aspect("equal")
    ax.set_title(title)
    return _save(fig, path)


def pod_diagnostics(outdir: str, pod_result, fourier_result, dt: float,
                    device="cuda"):
    """Verbose-mode diagnostic bundle: per-mode PSDs (reference
    PODFS.py:1366-1386, computed on ``device``) and temporal-mode
    reconstruction overlays (``POD_tmode_recon<i>.png``,
    PODFS.py:1614-1623)."""
    from pods_digital_filter_tpu_torch.ops.pod import to_numpy
    from pods_digital_filter_tpu_torch.ops.signal import welch_psd

    ns = pod_result.temporal_modes.shape[0]
    t = np.arange(ns) * dt
    paths = []
    paths.append(eigen_spectrum(pod_result.energy[: pod_result.num_valid],
                                os.path.join(outdir, "POD_mode_energies")))
    for j in range(pod_result.num_trunc):
        y = pod_result.temporal_modes[:, j].real
        fs, Sxx, _ = welch_psd(y, 1.0 / dt, ns, iwindow=1, device=device)
        paths.append(psd(np.asarray(fs), to_numpy(Sxx),
                         os.path.join(outdir, f"POD_PSD_mode_{j}")))
        # reconstruction overlay
        fig, ax = plt.subplots()
        ax.plot(t, y, label="original")
        ax.plot(t, fourier_result.reconstruction[:, j], "--", label="fourier")
        ax.legend()
        fig.savefig(os.path.join(outdir, f"POD_tmode_recon{j}.png"),
                    dpi=200, bbox_inches="tight")
        plt.close(fig)
    return paths
