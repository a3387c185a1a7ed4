"""Shared by the readers of the program's collective spans
(``pods_digital_filter_tpu_torch/parallel/mesh.py``): a span ``mesh.<x>``
counts its calls under its name, its host seconds under ``name + "_s"`` and
the bytes of its result on the rank under ``name + "_bytes"``; while a
profiler records, each ends in a device synchronize, so its seconds are the
transfer's.  The names are listed, not matched: the calls of
``mesh.shift_s`` end in ``_s`` themselves.  In a job the counters are rank
0's."""

import os

from h100bench.harness import load_module

_counts = load_module(os.path.join(os.path.dirname(__file__), "_counts.py"))

#: every collective span of the program's mesh
SPANS = ("mesh.all_reduce", "mesh.all_gather", "mesh.exchange_t",
         "mesh.exchange_s", "mesh.shift_s", "mesh.broadcast")


def seconds_per_model(run):
    """The collectives' seconds over the window's models, or None."""
    return _counts.per_model(run, *(n + "_s" for n in SPANS))


def gbps(run):
    """The collectives' bytes over their seconds, in GB/s, or None."""
    return _counts.ratio(tuple(n + "_bytes" for n in SPANS),
                         tuple(n + "_s" for n in SPANS), 1e-9)
