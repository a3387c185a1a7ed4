"""``collective_gbps.sharded4``: rank 0's collective bytes (the bytes of
each collective's result on the rank) over the seconds of its collective
spans, in GB/s (1e9 bytes): a rate, not a share of a link's peak."""

import os

from h100bench.harness import load_module

_mesh = load_module(os.path.join(os.path.dirname(__file__), "_mesh.py"))


def read(run):
    return _mesh.gbps(run)
