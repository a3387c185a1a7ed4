"""Shared by the readers of the program's stage timer (``StageTimer``):
the mean over the window's models of the named stages' seconds."""


def mean_stage(run, *names):
    units = [u for u in run.units if isinstance(u, dict) and "times" in u]
    if not units or not any(n in units[0]["times"] for n in names):
        return None
    return sum(sum(u["times"].get(n, 0.0) for n in names)
               for u in units) / len(units)
