"""``model_s.stream``: the window's seconds over its whole models, in the
flagship's streaming cell.

The quantity of ``model_s``, read by its reader, under a name of its own
because the flagship's model times spread far less from run to run
than the main-size cells' (PERF.md) and are held to a bound of their own."""

import os

from h100bench.harness import load_module

_reader = load_module(os.path.join(os.path.dirname(__file__),
                                   "model_s.py"))


def read(run):
    return _reader.read(run)
