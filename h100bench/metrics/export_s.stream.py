"""``export_s.stream``: the program's ``export`` stage, seconds per model, in
the flagship's streaming cell.

The quantity of ``export_s``, read by its reader, under a name of its own
because it moves ``model_s.stream``, the flagship's model time, which
has a bound of its own."""

import os

from h100bench.harness import load_module

_reader = load_module(os.path.join(os.path.dirname(__file__),
                                   "export_s.py"))


def read(run):
    return _reader.read(run)
