"""``unstaged_s.inmem``: per model, the host seconds around
``run_pipeline`` less the sum of its stage timer, mean over the window's
in-memory models: the host glue between stages (the pageable copy of
``PipelineResult.A``, ``pod.resolve_spatial``)."""


def read(run):
    units = [u for u in run.units if isinstance(u, dict) and "times" in u
             and "streaming_pod" not in u["times"]]
    if not units:
        return None
    return sum(u["wall"] - sum(u["times"].values()) for u in units) / len(units)
