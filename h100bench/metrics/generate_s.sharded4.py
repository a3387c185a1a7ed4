"""``generate_s.sharded4``: per model, rank 0's host seconds in the
program's ``sharded.generate`` spans (one a window of the tile's chunked
generation: noise, filters, Lund, rotation, the copy into the tile; each
ends in a device synchronize while traced), mean over the window's
models."""

import os

from h100bench.harness import load_module

_counts = load_module(os.path.join(os.path.dirname(__file__), "_counts.py"))


def read(run):
    return _counts.per_model(run, "sharded.generate_s")
