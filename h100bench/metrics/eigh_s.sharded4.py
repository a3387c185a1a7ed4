"""``eigh_s.sharded4``: per model, rank 0's host seconds in the program's
``pod.eigh`` span (its f64 eigen solve of the Gram on its card, the
counts, truncation and scaling, and the broadcast of the spectrum and the
kept temporal modes), mean over the window's models."""

import os

from h100bench.harness import load_module

_counts = load_module(os.path.join(os.path.dirname(__file__), "_counts.py"))


def read(run):
    return _counts.per_model(run, "pod.eigh_s")
