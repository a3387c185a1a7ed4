"""The port's diagnostics (pods_digital_filter_tpu_torch/diagnostics/): every
plot helper writes a decodable PNG, the ``-v`` paths draw their plots, and
only a missing matplotlib skips them (with a printed line) — any other
plotting error fails the run, where the JAX package prints and goes on.

Mirrors tests/test_diagnostics.py (2).
"""

import os
import sys

import numpy as np
import pytest

import torch_parity  # noqa: F401  (pins torch's thread count)

from pods_digital_filter_tpu_torch.diagnostics import load_plots, plots


def _png_ok(path):
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_all_plot_helpers_write_png(tmp_path, rng):
    t = np.linspace(0, 1, 64)
    y = np.sin(2 * np.pi * 5 * t)
    Y, Z = np.meshgrid(np.linspace(0, 1, 12), np.linspace(0, 1, 13))
    F = np.sin(2 * np.pi * Y) * np.cos(2 * np.pi * Z)
    freqs = np.linspace(0, 32, 33)
    S = 1.0 / (1.0 + freqs**2)

    out = str(tmp_path)
    _png_ok(plots.contourf(Y, Z, F, "f", f"{out}/contourf"))
    _png_ok(plots.timeseries(t, y, f"{out}/ts"))
    _png_ok(plots.psd(freqs, S, f"{out}/psd"))
    _png_ok(plots.eigen_spectrum(np.exp(-np.arange(10.0)), f"{out}/eigs"))
    _png_ok(plots.wns(freqs, S, f"{out}/wns"))
    _png_ok(plots.plot(t, y, f"{out}/plot"))
    _png_ok(plots.bar([1.0, 2.0, 3.0], f"{out}/bar", labels=["a", "b", "c"]))
    _png_ok(plots.hist(rng.standard_normal(500), f"{out}/hist"))
    _png_ok(plots.scatter(t, y, f"{out}/scatter", equal_aspect=True))
    _png_ok(plots.scatter(1 + np.abs(y), 1 + t, f"{out}/logscatter", loglog=True))
    _png_ok(plots.semilogx(1 + freqs, S, f"{out}/semilogx"))
    _png_ok(plots.psd3(freqs, [S, S * 2], f"{out}/psd3", labels=["u", "v"]))
    _png_ok(plots.convergence(np.exp(-np.arange(20.0)), f"{out}/conv"))
    _png_ok(plots.contourf_quiver(Y, Z, F, F, -F, f"{out}/cq"))
    _png_ok(plots.contourf_contour(Y, Z, F, F, f"{out}/cc"))
    _png_ok(plots.scatter_3d(t, y, t * y, f"{out}/s3d", c=y))
    d = 0.01 * rng.standard_normal((2, t.shape[0]))
    _png_ok(plots.arrow_field(y, t, d[0], d[1], f"{out}/arrow"))
    _png_ok(plots.arc_arrow(np.abs(y) + 0.1, 1 + t, d[0], d[1], f"{out}/arc"))
    _png_ok(plots.plot_with_point(t, y, t[::5], y[::5], f"{out}/pwp"))


def test_render_field_variants(tmp_path, rng):
    from pods_digital_filter_tpu_torch.config import PlaneConfig
    from pods_digital_filter_tpu_torch.io.plane import make_inflow_plane

    geom = make_inflow_plane(PlaneConfig(jma=8, kma=9, res=0.1))
    pts = geom.cell_centers
    npts = pts.shape[0]
    out = str(tmp_path)
    _png_ok(plots.render_field(pts, rng.standard_normal(npts), f"{out}/sc"))
    _png_ok(plots.render_field(pts, rng.standard_normal((npts, 3)), f"{out}/vec"))
    _png_ok(plots.render_field(pts, rng.standard_normal(3 * npts),
                               f"{out}/packed", component=0))


def test_plots_module_is_a_copy():
    """Every helper of the original is in the port's copy."""
    from pods_digital_filter_tpu.diagnostics import plots as jplots

    names = {n for n in dir(jplots) if callable(getattr(jplots, n))
             and not n.startswith("__") and getattr(
                 getattr(jplots, n), "__module__", "") == jplots.__name__}
    assert names and all(callable(getattr(plots, n, None)) for n in names)


def test_verbose_cli_writes_the_pod_plots(tmp_path, capsys):
    """``-v`` draws the POD plots (spectra through the port's welch_psd on
    the run's device)."""
    from pods_digital_filter_tpu_torch import cli

    out = tmp_path / "PODFS"
    assert cli.main(["-n", "8", "-m", "2", "-j", "6", "-k", "7", "-v",
                     "--device", "cpu", "--outdir", str(out)]) == 0
    assert "diagnostics skipped" not in capsys.readouterr().out
    for name in ("POD_mode_energies.png", "POD_PSD_mode_0.png",
                 "POD_PSD_mode_1.png", "POD_tmode_recon0.png",
                 "POD_tmode_recon1.png"):
        _png_ok(os.path.join(out, name))


def test_prf_reader_draws_the_contour_plots(tmp_path):
    """``read_prf(make_plots=True)`` draws the original's 17 contour plots
    and returns the profile it returns without them."""
    from test_profiles import _write_prf

    from pods_digital_filter_tpu_torch.models.prf_reader import read_prf

    path = str(tmp_path / "inlet.prf")
    _write_prf(path)
    out = tmp_path / "plots"
    out.mkdir()
    r = read_prf(path, res=0.1, outdir=str(out), make_plots=True)
    for name in ("dudy", "dudz", "dvdy", "dvdz", "dwdy", "dwdz", "U", "V",
                 "W", "eps", "k", "uu", "vv", "ww", "uv", "uw", "vw"):
        _png_ok(os.path.join(out, name + ".png"))
    r0 = read_prf(path, res=0.1)
    for name in ("U", "uu", "uv", "k", "eps"):
        np.testing.assert_array_equal(getattr(r, name), getattr(r0, name))


def test_missing_matplotlib_skips_with_a_line(monkeypatch, capsys):
    """Without matplotlib, load_plots prints the skip and returns None."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules,
                        "pods_digital_filter_tpu_torch.diagnostics.plots")
    import pods_digital_filter_tpu_torch.diagnostics as diag

    monkeypatch.delattr(diag, "plots")
    assert load_plots("the POD plots") is None
    assert "matplotlib is not installed, so the POD plots were not drawn" \
        in capsys.readouterr().out


def test_other_errors_fail_the_run(monkeypatch, tmp_path):
    """A plotting error other than a missing matplotlib is raised (the JAX
    package would print it and go on)."""
    from pods_digital_filter_tpu_torch import cli

    def broken(*a, **k):
        raise RuntimeError("a broken plot")

    monkeypatch.setattr(plots, "pod_diagnostics", broken)
    with pytest.raises(RuntimeError, match="a broken plot"):
        cli.main(["-n", "6", "-m", "2", "-j", "5", "-k", "6", "-v",
                  "--device", "cpu", "--outdir", str(tmp_path / "PODFS")])
