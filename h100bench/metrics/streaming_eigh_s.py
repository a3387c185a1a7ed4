"""``streaming_eigh_s``: the streaming eigen half per model, the program's
``streaming_eigh_vectors`` plus ``streaming_eigh_spectrum`` stages (the
deferred Lanczos join), mean over the window's models."""

import os

from h100bench.harness import load_module

_stages = load_module(os.path.join(os.path.dirname(__file__), "_stages.py"))


def read(run):
    return _stages.mean_stage(run, "streaming_eigh_vectors",
                              "streaming_eigh_spectrum")
