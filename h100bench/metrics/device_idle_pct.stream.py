"""``device_idle_pct.stream``: the share of the traced window in which no
device operation ran, in the flagship's streaming cell.

The quantity of ``device_idle_pct.model``, read by its reader, under a
name of its own because it moves ``model_s.stream``, the flagship's model
time, which has a bound of its own."""

import os

from h100bench.harness import load_module

_reader = load_module(os.path.join(os.path.dirname(__file__),
                                   "device_idle_pct.model.py"))


def read(run):
    return _reader.read(run)
