"""``model_s``: the window's host seconds over the whole models completed in
it, each from its configuration or snapshots to every model file on disk.

Read wherever the cell's entry declares its units whole models
(``UNITS = "models"``), whatever the entry is named."""

from h100bench.harness import entry_module


def read(run):
    if getattr(entry_module(run.cell.entry), "UNITS", None) != "models" \
            or not run.units:
        return None
    return run.elapsed / len(run.units)
