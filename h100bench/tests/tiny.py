"""A cell of ``BENCHMARK.json`` cut to a size the CPU holds in a second,
with the whole harness behind it: set-up, window, release, check, report."""

import copy
import io
import json
import os
import tempfile
import time
from contextlib import redirect_stderr, redirect_stdout

from h100bench import harness

SIZES = dict(jma=24, kma=20, nsteps=96, lengthscale=2.0, num_modes=6)
STREAMING = dict(streaming_block=32, gram_group=2)


def tiny_cell(name, bench=None):
    """``name``'s cell, its configuration cut to a 24 x 20 plane, 96
    snapshots, 6 modes (streaming blocks of 32, two held)."""
    cell = harness.find_cell(name, bench)
    cfg = copy.deepcopy(cell.config)
    cfg["sizes"].update(SIZES)
    if "streaming_block" in cfg["sizes"]:
        cfg["sizes"].update(STREAMING)
        cell.extra = dict(cell.extra,
                          reference_block=STREAMING["streaming_block"])
    if "fourier_counts" in cfg.get("assumed", {}):
        cfg["assumed"]["fourier_counts"] = [3, 5, 1, 7, 2, 9]
    cell.config = cfg
    return cell


def run_tiny(cell, seed=2 ** 40 + 17, seconds=0.3, trace=False, outdir=None):
    """The harness on the CPU: ``(result line as a dict, stderr text)``."""
    tmp = outdir or tempfile.mkdtemp()
    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                          device="cpu", outdir=tmp)
    run, numbers = harness.measure(ctx, time.perf_counter())
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.report(run, numbers, cell, int(trace), "cpu")
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()
