"""``gram_s.sharded4``: per model, rank 0's host seconds in the program's
``pod.gram`` span (the sharded Gram: the t-tiles exchanged chunk by chunk,
the strip's products, its sum over the plane tiles and gather over time;
ends in a device synchronize while traced), mean over the window's
models."""

import os

from h100bench.harness import load_module

_counts = load_module(os.path.join(os.path.dirname(__file__), "_counts.py"))


def read(run):
    return _counts.per_model(run, "pod.gram_s")
