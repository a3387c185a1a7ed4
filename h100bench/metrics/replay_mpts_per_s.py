"""``replay_mpts_per_s``: inlet points x time steps evaluated in the window,
over its host seconds, in millions."""


def read(run):
    if run.cell.entry != "replay" or not run.units:
        return None
    per_call = run.info["points x steps per call"]
    return len(run.units) * per_call / run.elapsed / 1e6
