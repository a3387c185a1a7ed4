"""``setup_s``: host seconds from the start of the process to the start of
the window (imports, the card's context, builds, inputs, warm-up)."""


def read(run):
    return run.setup_s
