"""Diagnostics of the port: the matplotlib plots of :mod:`.plots`, a copy of
``pods_digital_filter_tpu/diagnostics/``.

The JAX package wraps its plots in ``except Exception`` and prints what
went wrong.  The port lets every plotting error fail the run, and only a
host without matplotlib skips the plots, saying so: :func:`load_plots`.
Every other module of the port imports without matplotlib.
"""

from __future__ import annotations


def load_plots(what: str):
    """The :mod:`.plots` module, or ``None`` (with a printed line naming
    ``what`` was skipped) when matplotlib is not installed.  Any other
    import error is raised."""
    try:
        from pods_digital_filter_tpu_torch.diagnostics import plots
    except ImportError as e:
        if (e.name or "").split(".")[0] != "matplotlib":
            raise
        print(f"diagnostics skipped: matplotlib is not installed, so {what} "
              "were not drawn")
        return None
    return plots
