"""The benchmark's general loop: find a cell's files by name, set up, warm,
measure one window, judge what the window produced, print the result.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its files are
found by name, so that a later change adds files and never edits one:

* ``configs/<config>.json``: the deployment (sizes, program flags, source);
* ``traffic/<traffic>.json``: the mix, with the entry kind that drives it;
* ``cells/<cell>.json``: the limit of each number that decides ``correct``;
* ``entries/<kind>.py``: ``setup``, ``window``, ``release`` and ``check``;
* ``metrics/<metric>.py``: ``read(run)`` for each metric, None where it
  finds nothing to read.

A configuration's ``sizes`` may state a mesh (``shard_time``,
``shard_space``); its product is the ``chips`` of every cell that runs the
configuration.  A cell on one card runs in this process alone.  A cell on
N cards is a job of N processes, one a card (``job.py``): this process is
rank 0, every rank runs the entry's ``setup``, ``window`` and ``release``,
and rank 0 alone runs ``check`` and prints the result.  Of such a run,
``setup_s`` waits for the slowest rank's set-up, the memory peaks are the
fullest card's, ``device.busy_s`` is the mean over the ranks, and the
per-layer metrics read rank 0's trace, spans and counters.

The program is ``pods_digital_filter_tpu_torch``; nothing here or in a file
that is found here imports JAX or the JAX package.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: modules whose presence after the window refuses the run
FORBIDDEN = ("jax", "jaxlib", "flax", "pods_digital_filter_tpu")
GIB = 2 ** 30


class Refused(RuntimeError):
    """A run that must print no result (no card, a forbidden import)."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """A module from a file found by name (names may hold dots)."""
    name = "h100bench._found." + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with the files found for it."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    extra: dict = field(default_factory=dict)

    @property
    def entry(self):
        return self.traffic["entry"]


def mesh_size(sizes):
    """The cards a configuration's mesh takes: ``shard_time *
    shard_space``, each 1 where absent."""
    return int(sizes.get("shard_time", 1)) * int(sizes.get("shard_space", 1))


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name, bench=None, root=ROOT):
    """The cell ``name`` of ``BENCHMARK.json`` and its files."""
    bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = os.path.join(root, "h100bench")
    extra = load_json(os.path.join(here, "cells", name + ".json"))
    config = load_json(os.path.join(root, conf["file"]))
    if mesh_size(config.get("sizes", {})) != int(w["chips"]):
        raise ValueError(
            f"workload {name!r} asks for {w['chips']} card(s); the mesh of "
            f"configuration {w['config']!r} takes "
            f"{mesh_size(config.get('sizes', {}))}")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=config,
        traffic=load_json(os.path.join(here, "traffic",
                                       w["traffic"] + ".json")),
        limits=extra["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        extra=extra)


def entry_module(kind):
    return load_module(os.path.join(HERE, "entries", kind + ".py"))


def metric_reader(name):
    return load_module(os.path.join(HERE, "metrics", name + ".py"))


def splitmix(x):
    """A 63-bit mix of ``x``: the seeds of a run's models and samples."""
    z = (x * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) & (2 ** 63 - 1)


@dataclass
class Context:
    """What an entry is given: the cell, the seed, the device, a directory
    for its outputs, the run's length and whether it is traced."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    outdir: str
    disk_cap: int = 3 * GIB
    job: object = None        # a cell over several cards: this rank's Job

    def decide(self, value):
        """Rank 0's ``value`` on every rank (``value`` on one card): where
        the window ends, so that every rank runs the same units."""
        return value if self.job is None else self.job.decide(value)


@dataclass
class Run:
    """What a window produced, for the metric readers and the check."""
    cell: Cell
    elapsed: float = 0.0
    units: list = field(default_factory=list)   # one dict per model / call
    setup_s: float = 0.0
    window_peak: int = 0
    run_peak: int = 0
    ended_by: str = ""
    bytes_written: int = 0
    trace: object = None
    info: dict = field(default_factory=dict)


def dir_bytes(path):
    total = 0
    for base, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(base, f))
    return total


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_device(chips):
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False: this benchmark "
                      "measures the program on an NVIDIA card")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} card(s); "
                      f"torch.cuda.device_count() is "
                      f"{torch.cuda.device_count()}")


def device_info(device, run):
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": run.cell.chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.cell.chips, "memory_peak_bytes": int(run.run_peak)}


def measure(ctx, t_start):
    """Set up, warm and run one window of the cell; judge it.  Returns
    ``(run, numbers)``; ``numbers`` maps each compared name to its value.

    In a job (``ctx.job``) every rank comes here: set-up ends at a barrier,
    each rank's peaks and busy time are gathered into rank 0's ``run``
    (``merge``), the job is closed once the program's state is released,
    and only rank 0 runs the check (the others return no numbers)."""
    import torch

    from h100bench import trace as tracing

    job = ctx.job
    entry = entry_module(ctx.cell.entry)
    state = entry.setup(ctx)
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    if job is not None:
        job.barrier()
    run = Run(cell=ctx.cell)
    run.setup_s = time.perf_counter() - t_start
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    prof = tracing.start(ctx.device) if ctx.trace else None
    entry.window(state, ctx, run)
    if prof is not None:
        run.trace = tracing.stop(prof, ctx.device)
    if cuda:
        torch.cuda.synchronize()
        run.window_peak = torch.cuda.max_memory_allocated()
        run.run_peak = max(setup_peak, run.window_peak)
    if job is not None:
        where = f"cuda:{torch.cuda.current_device()}" if cuda else ctx.device
        mine = dict(rank=job.rank, device=where, window_peak=run.window_peak,
                    run_peak=run.run_peak,
                    busy_s=None if run.trace is None else run.trace.busy_s)
        merge(run, job.gather(mine))
    entry.release(state)
    if cuda:
        torch.cuda.empty_cache()
    if job is not None:
        job.close()
        if job.rank:
            return run, {}
    numbers = entry.check(state, ctx, run)
    return run, numbers


def merge(run, ranks):
    """Rank 0's ``run`` takes the fullest card's peaks and the mean of the
    ranks' busy seconds; ``ranks`` holds one dict a rank, in rank order."""
    run.window_peak = max(r["window_peak"] for r in ranks)
    run.run_peak = max(r["run_peak"] for r in ranks)
    busy = [r["busy_s"] for r in ranks]
    if run.trace is not None and None not in busy:
        run.trace.busy_s = sum(busy) / len(busy)
    run.info["ranks"] = [
        f"{r['rank']}: {r['device']}, window peak {r['window_peak']} B, run "
        f"peak {r['run_peak']} B" + ("" if r["busy_s"] is None else
                                     f", busy {r['busy_s']} s")
        for r in ranks]


def read_metrics(run, metrics):
    out = {}
    for m in metrics:
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(numbers, limits):
    """``(correct, compared)``: each compared number beside its limit; a
    number that is missing, not finite or over its limit fails."""
    correct, compared = True, {}
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        ok = math.isfinite(value) and value <= limit
        correct = correct and ok
        # JSON has no NaN or infinity: a number that is not finite is null
        compared[name] = {"value": value if math.isfinite(value) else None,
                          "limit": limit}
    return correct, compared


def main(argv=None, t_start=None):
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json "
                                            "once on the card")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank > 0 of a job, started by rank 0 (job.py)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--job", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.job is not None:
        return rank_main(args, t_start)
    cell = find_cell(args.workload)
    try:
        check_device(cell.chips)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    return run_cell(cell, args, "cuda", t_start)


def _argv(args):
    """The flags of a run, for the other ranks of its job."""
    return ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", repr(args.seconds), "--trace", str(args.trace)]


def run_cell(cell, args, device, t_start):
    """Run the cell once on ``device`` and print its result: in this
    process on one card, or as rank 0 of a job of ``cell.chips`` ranks
    that run this checkout's ``run.py``."""
    tmp = tempfile.mkdtemp(prefix="h100bench-")
    job = None
    try:
        if cell.chips > 1:
            from h100bench.job import Job

            job = Job.start(ROOT, _argv(args), cell.chips, device,
                            args.seconds, cleanup=[tmp])
        ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=device, outdir=tmp,
                      job=job)
        run, numbers = measure(ctx, t_start)
        found = forbidden_modules()
        if found:
            print(f"refused: the process loaded {found}", file=sys.stderr)
            return 3
        return report(run, numbers, cell, args.trace, ctx.device)
    except BaseException:
        if job is not None and not job.closed:
            traceback.print_exc()
            job.fail("rank 0 raised")
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rank_main(args, t_start):
    """A rank > 0 of a job: the same cell, seed, seconds and trace flag as
    rank 0, on the device rank 0 names; its output goes to its log."""
    from h100bench.job import Job

    tmp = tempfile.mkdtemp(prefix="h100bench-")
    try:
        job = Job.join(args.rank, args.job)
        ctx = Context(cell=find_cell(args.workload), seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device=job.device, outdir=tmp, job=job)
        measure(ctx, t_start)
    except BaseException:
        # exit at once: a process group whose peers are gone can hold the
        # interpreter's exit for the collective timeout
        traceback.print_exc()
        shutil.rmtree(tmp, ignore_errors=True)
        sys.stderr.flush()
        os._exit(1)
    shutil.rmtree(tmp, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"refused: rank {args.rank} loaded {found}", file=sys.stderr)
        return 3
    return 0


def report(run, numbers, cell, trace, device):
    correct, compared = verdict(numbers, cell.limits)
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    dev = device_info(device, run)
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    print(f"setup_s: {run.setup_s}", file=sys.stderr)
    for key, val in run.info.items():
        print(f"{key}: {val}", file=sys.stderr)
    print(f"window ended by {run.ended_by}: {len(run.units)} units in "
          f"{run.elapsed:.3f} s; {run.bytes_written} bytes written",
          file=sys.stderr)
    for name, value in numbers.items():
        if name not in compared:
            print(f"read, not compared: {name} {value!r}", file=sys.stderr)
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line = {"correct": bool(correct), "attempted": len(run.units),
            "failed": 0 if correct else 1, "metrics": metrics,
            "device": dev}
    if trace and run.trace is not None:
        line["breakdown"] = run.trace.breakdown
    line["compared"] = compared
    print(json.dumps(line))
    return 0
