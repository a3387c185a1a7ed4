"""A cell over several cards, run on the CPU: ranks of a gloo job started by
the harness's own launcher (``harness.run_cell``, what ``main`` calls once
it has found the cards), at the 24 x 20 plane of ``tiny.py``.

Each job runs in a process of its own (rank 0) with a deadline, in a copy
of the checkout to which the cell is added by new files and entries alone;
the copy's ``run.py`` starts the other ranks.  Rank 0 is started with the
program on ``PYTHONPATH``; no process of a job may outlive it."""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

from h100bench import harness
from h100bench.tests.tiny import SIZES, STREAMING, tiny_cell

ROOT = harness.ROOT
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
SEED = 2 ** 40 + 17
#: every job here ends within this many seconds, or the test fails
LIMIT = 240

RANK0 = """
import sys, time, types
t0 = time.perf_counter()
root, name, seed, seconds, trace, timeout = sys.argv[1:7]
sys.path.insert(0, root)
from pods_digital_filter_tpu_torch.parallel import mesh
mesh.TIMEOUT_S = float(timeout)
from h100bench import harness
args = types.SimpleNamespace(workload=name, seed=int(seed),
                             seconds=float(seconds), trace=int(trace))
raise SystemExit(harness.run_cell(harness.find_cell(name), args, "cpu", t0))
"""


def checkout(tmp_path):
    """A copy of the benchmark's files, and their bytes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "h100bench"), root / "h100bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    files = {p: p.read_bytes() for p in (root / "h100bench").rglob("*")
             if p.is_file()}
    return root, files


def add_cell(root, bench, name, chips, mesh=None, entry="pipeline",
             streaming=False):
    """A cell of a tiny main-size configuration (the flagship's, out of
    core, with ``streaming``), on the torch-ops generator, ``mesh`` in its
    ``sizes``, added by new files and entries alone."""
    twin = "flagship.stream" if streaming else "main512.inmem"
    base = harness.find_cell(twin, BENCH).config
    conf = dict(base, name="tiny_" + name.replace(".", "_"))
    conf["sizes"] = dict(base["sizes"], **SIZES, pallas=False, **(mesh or {}))
    cell = harness.load_json(os.path.join(ROOT, "h100bench", "cells",
                                          twin + ".json"))
    if streaming:
        conf["sizes"].update(STREAMING)
        cell["reference_block"] = STREAMING["streaming_block"]
    path = f"h100bench/configs/{conf['name']}.json"
    (root / path).write_text(json.dumps(conf))
    bench["configs"].append({"name": conf["name"], "source": "tiny",
                             "file": path, "reduced": [], "why": "tiny"})
    traffic = "models" if entry == "pipeline" else "models_" + entry
    if entry != "pipeline":
        (root / f"h100bench/traffic/{traffic}.json").write_text(json.dumps(
            {"entry": entry, "why": "throwaway"}))
    bench["workloads"].append({"name": name, "config": conf["name"],
                               "traffic": traffic, "chips": chips,
                               "why": "throwaway"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if twin in m.get("workloads", []):
            m["workloads"].append(name)
    (root / f"h100bench/cells/{name}.json").write_text(json.dumps(cell))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def planted(root, fault):
    """An entry ``faulty``: the pipeline entry with ``fault`` run at the
    start of every rank's set-up (``rank`` and ``time`` in scope)."""
    (root / "h100bench/entries/faulty.py").write_text(
        "import os, time\n"
        "from h100bench.harness import load_module\n"
        "_p = load_module(os.path.join(os.path.dirname(__file__), "
        "'pipeline.py'))\n"
        "UNITS, window, release, check = _p.UNITS, _p.window, _p.release, "
        "_p.check\n"
        "def setup(ctx):\n"
        "    rank = ctx.job.rank\n"
        f"    {fault}\n"
        "    return _p.setup(ctx)\n")


def job(root, name, seconds=0.01, trace=0, timeout=300):
    """Rank 0 of ``name`` in a process of its own; ``(rc, stdout, stderr,
    seconds)``."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-c", RANK0, str(root), name,
                        str(SEED), str(seconds), str(trace), str(timeout)],
                       capture_output=True, text=True, env=env, cwd=root,
                       timeout=LIMIT)
    return p.returncode, p.stdout, p.stderr, time.monotonic() - t0


def processes_of(root):
    """Pids of the processes whose command line names ``root``."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except OSError:
            continue
        if str(root) in cmd:
            found.append(int(pid))
    return found


def result(stdout):
    lines = stdout.strip().splitlines()
    return json.loads(lines[-1]) if lines else None


def has_result(stdout):
    lines = stdout.strip().splitlines()
    return bool(lines) and lines[-1].startswith('{"correct"')


@pytest.mark.parametrize("streaming,mesh", [
    (False, {"shard_space": 2}), (True, {"shard_time": 2})],
    ids=["inmem_1x2", "stream_2x1"])
def test_two_rank_cell_added_by_files_alone(tmp_path, streaming, mesh):
    """Two ranks over a mesh stated in the configuration, from files alone:
    one result line, correct, with the end-to-end model time where the twin
    cell reports one (the flagship's; the main-size cells read it per layer,
    ``test_traced_two_rank_cell``); its judged numbers are a one-rank run's
    of the same seed to float32 rounding."""
    root, before = checkout(tmp_path)
    bench = json.loads(json.dumps(BENCH))
    add_cell(root, bench, "tiny.sharded2", 2, mesh, streaming=streaming)
    add_cell(root, bench, "tiny.serial", 1, streaming=streaming)
    assert {p: p.read_bytes() for p in before} == before

    rc, out, err, _ = job(root, "tiny.sharded2")
    assert rc == 0, err[-3000:]
    line = result(out)
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] == 1
    assert "setup_s" in line["metrics"]
    assert ("model_s.stream" in line["metrics"]) == streaming
    assert line["device"]["count"] == 2
    shape = "{shard_time}x{shard_space}".format(
        **dict(dict(shard_time=1, shard_space=1), **mesh))
    assert f"mesh: {shape}, backend gloo" in err
    assert "ranks: ['0: cpu" in err and "'1: cpu" in err
    assert processes_of(root) == []

    rc, out, err1, _ = job(root, "tiny.serial")
    assert rc == 0, err1[-3000:]
    serial = result(out)
    assert serial["correct"] is True and "mesh:" not in err1
    for k, c in line["compared"].items():
        # both are float32 rounding against the f64 reference
        assert abs(c["value"] - serial["compared"][k]["value"]) <= 2 ** -21, k


def test_traced_two_rank_cell(tmp_path):
    """``--trace 1`` over two ranks: the per-layer metrics (the model time
    among them) and the breakdown are rank 0's; ``busy_s`` is the ranks'
    mean."""
    root, _ = checkout(tmp_path)
    add_cell(root, json.loads(json.dumps(BENCH)), "tiny.sharded2", 2,
             {"shard_space": 2})
    rc, out, err, _ = job(root, "tiny.sharded2", seconds=0.3, trace=1)
    assert rc == 0, err[-3000:]
    line = result(out)
    assert line["correct"] is True and line["device"]["window_s"] > 0
    assert "pod_s" in line["metrics"] and line["breakdown"]["idle_gaps"]
    assert line["metrics"]["model_s.window"]["value"] > 0
    ranks = [s for s in err.splitlines() if s.startswith("ranks: ")]
    busy = [float(b.split(" s")[0]) for b in ranks[0].split("busy ")[1:]]
    assert len(busy) == 2       # no device events on the CPU: both 0
    assert line["device"]["busy_s"] == pytest.approx(sum(busy) / 2)


@pytest.mark.parametrize("fault,timeout", [
    ("if rank == 1: raise RuntimeError('planted in rank 1')", 300),
    ("if rank == 0: raise RuntimeError('planted in rank 0')", 300),
    ("if rank == 1: time.sleep(3600)", 20)],
    ids=["rank1_raises", "rank0_raises", "rank1_hangs"])
def test_a_failing_rank_ends_the_job(tmp_path, fault, timeout):
    """A rank that raises ends the job at once (rank 0 too, while rank 1
    waits in a collective); one that hangs, at the deadline (``--seconds``
    plus the collective timeout, cut to 20 s here): non-zero, no result
    line, no process of the job left."""
    root, _ = checkout(tmp_path)
    add_cell(root, json.loads(json.dumps(BENCH)), "tiny.faulty", 2,
             {"shard_space": 2}, entry="faulty")
    planted(root, fault)
    rc, out, err, took = job(root, "tiny.faulty", timeout=timeout)
    assert rc != 0 and not has_result(out)
    assert "refused: job of 2 ranks ended" in err or "Error" in err, err
    if "raise" in fault:
        assert "planted in rank" in err
    assert took < (60 if "raise" in fault else timeout + 60)
    assert processes_of(root) == []


def test_ranks_end_with_rank0(tmp_path):
    """Rank 0 killed while rank 1 waits for it: rank 1 ends itself."""
    root, _ = checkout(tmp_path)
    add_cell(root, json.loads(json.dumps(BENCH)), "tiny.faulty", 2,
             {"shard_space": 2}, entry="faulty")
    planted(root, "if rank == 0: time.sleep(3600)")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    p = subprocess.Popen([sys.executable, "-c", RANK0, str(root),
                          "tiny.faulty", str(SEED), "0.01", "0", "300"],
                         stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL, env=env, cwd=root)
    try:
        end = time.monotonic() + LIMIT
        while len(processes_of(root)) < 2:      # rank 0 and rank 1
            assert p.poll() is None and time.monotonic() < end
            time.sleep(0.2)
        time.sleep(5)                            # rank 1 joins the job
        assert len(processes_of(root)) == 2
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)
    end = time.monotonic() + 30
    while processes_of(root) and time.monotonic() < end:
        time.sleep(0.2)
    assert processes_of(root) == []


def test_one_card_spawns_nothing(monkeypatch, capsys):
    """On one card the run is this process alone: no job started or
    joined, no process group made."""
    import types

    import torch.distributed as dist

    from h100bench import job as jobs

    def refuse(*a, **k):
        raise AssertionError("a one-card run made a job")

    monkeypatch.setattr(jobs.Job, "start", refuse)
    monkeypatch.setattr(jobs.Job, "join", refuse)
    args = types.SimpleNamespace(workload="main512.inmem", seed=SEED,
                                 seconds=0.01, trace=0)
    rc = harness.run_cell(tiny_cell("main512.inmem"), args, "cpu",
                          time.perf_counter())
    out = capsys.readouterr().out
    assert rc == 0 and result(out)["correct"] is True
    assert result(out)["device"]["count"] == 1
    assert not dist.is_initialized()


def test_peak_is_the_fullest_rank():
    """``merge`` on a fake two-rank run: the peaks are the fullest card's,
    ``peak_mem_gib`` reads them, busy seconds are the ranks' mean."""
    from h100bench.trace import Trace

    run = harness.Run(cell=tiny_cell("main512.inmem"), window_peak=3 << 30,
                      run_peak=4 << 30)
    run.trace = Trace(window_s=2.0, busy_s=1.0, kernels={})
    harness.merge(run, [
        dict(rank=0, device="cuda:0", window_peak=3 << 30, run_peak=4 << 30,
             busy_s=1.0),
        dict(rank=1, device="cuda:1", window_peak=5 << 30, run_peak=5 << 30,
             busy_s=1.5)])
    assert (run.window_peak, run.run_peak) == (5 << 30, 5 << 30)
    assert harness.metric_reader("peak_mem_gib").read(run) == 5.0
    assert run.trace.busy_s == 1.25
    assert len(run.info["ranks"]) == 2
