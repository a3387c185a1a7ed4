"""``model_s.window``: the window's seconds over its whole models, in the
main-size cells, as a per-layer metric.

The quantity of ``model_s``, read by its reader.  Its runs in these cells
spread by more than any bound the benchmark may set (a third of the
median from run to run; PERF.md), because the export's host threads and
the pageable copies share the card's host; so it is read in traced runs,
beside the breakdown, and holds no bound."""

import os

from h100bench.harness import load_module

_reader = load_module(os.path.join(os.path.dirname(__file__),
                                   "model_s.py"))


def read(run):
    return _reader.read(run)
