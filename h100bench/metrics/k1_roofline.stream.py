"""``k1_roofline.stream``: K1's bound over its traced time per launch, in %, in
the flagship's streaming cell.

The quantity of ``k1_roofline``, read by its reader, under a name of its own
because it moves ``model_s.stream``, the flagship's model time, which
has a bound of its own."""

import os

from h100bench.harness import load_module

_reader = load_module(os.path.join(os.path.dirname(__file__),
                                   "k1_roofline.py"))


def read(run):
    return _reader.read(run)
