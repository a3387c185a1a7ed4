"""``model_s``: the window's host seconds over the whole models completed in
it, each from its configuration or snapshots to every model file on disk."""


def read(run):
    if run.cell.entry not in ("pipeline", "compress") or not run.units:
        return None
    return run.elapsed / len(run.units)
