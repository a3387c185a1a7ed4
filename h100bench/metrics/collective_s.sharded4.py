"""``collective_s.sharded4``: per model, rank 0's host seconds in the
program's collective spans (``mesh.all_reduce``, ``mesh.all_gather``,
``mesh.exchange_t``, ``mesh.shift_s``, ``mesh.broadcast``), each ending in
a device synchronize while traced, mean over the window's models."""

import os

from h100bench.harness import load_module

_mesh = load_module(os.path.join(os.path.dirname(__file__), "_mesh.py"))


def read(run):
    return _mesh.seconds_per_model(run)
