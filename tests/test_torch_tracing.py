"""The port's trace module (pods_digital_filter_tpu_torch/utils/timing.py)
and the spans and counters the program records with it, on the CPU at tiny
sizes: nothing is opened or counted without a profiler; under one, every
span appears as ``stage:<name>`` among the profiler's events and the
counters hold the steps, calls and bytes the run implies."""

import json
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parity  # noqa: F401  (pins torch's thread count)

from pods_digital_filter_tpu_torch import cli, compress, native, pipeline, replay
from pods_digital_filter_tpu_torch import config as tconfig
from pods_digital_filter_tpu_torch.utils import timing

NS = 24          # snapshots of the tiny runs
BLOCK = 8        # the streaming run's block
NPTS = 30        # points of the tiny compression


def _cfg(outdir, **kw):
    return tconfig.PipelineConfig(
        plane=tconfig.PlaneConfig(jma=6, kma=5, res=0.1),
        filt=tconfig.FilterConfig(length_scale_x=2.0, length_scale_y=2.0,
                                  length_scale_z=2.0, fwidth=2.0),
        podfs=tconfig.PODFSConfig(num_modes=4, energy_target=0.9),
        nsteps=NS, outdir=str(outdir), dtype="float32", **kw)


def _snapshots():
    rng = np.random.RandomState(3)
    t = np.arange(NS)
    return (1.0 + np.outer(rng.randn(3 * NPTS), np.cos(2 * np.pi * 2 * t / NS))
            + 0.1 * rng.randn(3 * NPTS, NS)).astype(np.float32)


def _points():
    return np.random.RandomState(4).rand(NPTS, 3)


def _inmem(tmp_path):
    def run():
        res = pipeline.run_pipeline(_cfg(tmp_path / "inmem"), device="cpu")
        return dict(result=res, files=res.files)
    return run


def _stream(tmp_path):
    def run():
        res = pipeline.run_pipeline(
            _cfg(tmp_path / "stream", streaming_block=BLOCK,
                 eig_mode="topk"), device="cpu")
        return dict(result=res, files=res.files)
    return run


def _compress(tmp_path):
    A = _snapshots()

    def run():
        _, _, files = compress.compress_snapshot_matrix(
            A, _points(), 0.01, 4, 0.9, str(tmp_path / "compress"),
            device="cpu")
        return dict(A=A, files=files)
    return run


def _replay(tmp_path, calls=3):
    d = str(tmp_path / "model")
    compress.compress_snapshot_matrix(_snapshots(), _points(), 0.01, 4, 0.9,
                                      d, device="cpu")
    rp = replay.Replayer(replay.load_prf(d), device="cpu")

    def run():
        for c in range(calls):
            rp.batch_device(0.01 * np.arange(c * 4, c * 4 + 4))
        return dict(calls=calls)
    return run


#: each run's set-up, which returns the run itself
RUNS = {"inmem": _inmem, "stream": _stream, "compress": _compress,
        "replay": _replay}

#: the spans of each run below its stages, as the profiler names them
SPANS = {
    "inmem": {"pipeline.resolve_spatial", "pipeline.result_to_host",
              "io.prf.write", "io.vtk.write"},
    "stream": {"streaming.generate", "lanczos.scan", "lanczos.tridiagonal",
               "io.prf.write", "io.vtk.write"},
    "compress": {"compress.upload", "compress.pod", "compress.fourier",
                 "compress.export", "io.prf.write"},
    "replay": {"replay.batch_device", "replay.upload_times"},
}


def _profiled(name, tmp_path):
    """Run ``name`` under a CPU profiler (its set-up outside it):
    ``(its output, event names, counts)``."""
    run = RUNS[name](tmp_path)
    timing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return out, names, timing.counts()


def _file_bytes(files):
    return sum(os.path.getsize(f) for f in files)


@pytest.mark.parametrize("name", list(RUNS))
def test_no_profiler_opens_and_counts_nothing(name, tmp_path, monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def spy(span_name, *args, **kw):
        opened.append(span_name)
        return real(span_name, *args, **kw)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    run = RUNS[name](tmp_path)
    timing.reset_counts()
    run()
    assert opened == []
    assert timing.counts() == {}


@pytest.mark.parametrize("name", list(RUNS))
def test_spans_appear_in_the_profile(name, tmp_path):
    out, names, counts = _profiled(name, tmp_path)
    want = {timing.PREFIX + s for s in SPANS[name]}
    assert want <= names, sorted(want - names)
    if "result" in out:
        # every stage of the program's own timer, with no patch of it
        stages = {timing.PREFIX + s for s in out["result"].timer.times}
        assert stages and stages <= names, sorted(stages - names)
        for s, sec in out["result"].timer.times.items():
            assert counts[s] >= 1 and 0 <= counts[s + "_s"] <= sec + 1e-3


@pytest.mark.parametrize("name", list(RUNS))
def test_counts_of_a_run(name, tmp_path):
    out, _, c = _profiled(name, tmp_path)
    if name == "inmem":
        assert c["pipeline.result_to_host"] == 1
        assert c["pipeline.result_to_host_bytes"] == out["result"].A.nbytes
    if name == "stream":
        route = out["result"].eig_route
        assert route["vectors"].startswith("Lanczos top-k")
        assert route["spectrum"].startswith("Lanczos m = n")
        # the top-k Krylov size min(max(4k + 32, 512), NS) is NS here, and
        # the deferred full spectrum takes NS steps in its worker thread
        assert c["lanczos.steps"] == NS + NS
        assert c["lanczos.scan"] == 2 and c["lanczos.tridiagonal"] == 2
        assert c["streaming.generate"] >= 3 * (NS // BLOCK)
    if name == "compress":
        assert c["compress.upload_bytes"] == out["A"].nbytes
        for s in ("upload", "pod", "fourier", "export"):
            assert c["compress." + s] == 1
    if name == "replay":
        assert c["replay.batch_device"] == out["calls"]
        assert c["replay.upload_times"] == out["calls"]
        assert c["replay.batch_device_s"] >= c["replay.upload_times_s"]
    if "files" in out:
        # each model file once, at its size on disk
        files = out["files"]
        assert c["io.prf.write"] + c.get("io.vtk.write", 0) == len(files)
        assert c["io.prf.write_bytes"] + c.get("io.vtk.write_bytes", 0) \
            == _file_bytes(files)
        # every .prf table is small here: one formatting thread each
        assert c["io.prf.write_threads"] == sum(f.endswith(".prf")
                                                for f in files)


@pytest.mark.parametrize("rows", [2, 50000])
def test_writer_threads_counter(rows, tmp_path):
    """A large table adds its formatting threads, more than one where the
    host has 3 or more processors; a small table adds exactly 1."""
    if rows > 2 and len(os.sched_getaffinity(0)) < 3:
        pytest.skip("fewer than 3 processors: every table takes one thread")
    table = np.random.default_rng(5).standard_normal((rows, 6))
    timing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        assert native.write_rows_fixed12(str(tmp_path / "t.prf"), "w", table)
    n = timing.counts()["io.prf.write_threads"]
    assert n == 1 if rows == 2 else n > 1


def _worker_counts():
    """Counts and a span made on a worker thread are kept."""
    def work():
        timing.count("worker.items", 3)
        with timing.span("worker.span", 7):
            pass

    with ThreadPoolExecutor(1) as pool:
        pool.submit(work).result(timeout=30)
    c = timing.counts()
    assert c["worker.items"] == 3
    assert c["worker.span"] == 1 and c["worker.span_bytes"] == 7


def _stress_counts():
    """More threads than cores add to one counter under a short switch
    interval: no update is lost."""
    threads, each = 2 * len(os.sched_getaffinity(0)) + 4, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                timing.count("stress.items", 1)
                with timing.span("stress.span", 2):
                    pass
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    c = timing.counts()
    assert c["stress.items"] == threads * each
    assert c["stress.span"] == threads * each
    assert c["stress.span_bytes"] == 2 * threads * each


def _nested_counts():
    """Nested spans count on their own; ``reset_counts`` clears."""
    with timing.span("outer", 10):
        with timing.span("outer.inner"):
            timing.count("outer.items", 4)
    c = timing.counts()
    assert c["outer"] == 1 and c["outer.inner"] == 1
    assert c["outer_bytes"] == 10 and "outer.inner_bytes" not in c
    assert c["outer_s"] >= c["outer.inner_s"] >= 0
    assert c["outer.items"] == 4
    timing.reset_counts()
    assert timing.counts() == {}


@pytest.mark.parametrize("check", [_worker_counts, _stress_counts,
                                   _nested_counts],
                         ids=["worker", "stress", "nested"])
def test_counters_while_recording(check):
    timing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        check()
    assert not torch.autograd.profiler._is_profiler_enabled
    timing.count("after.items", 1)
    assert "after.items" not in timing.counts()


@pytest.mark.parametrize("profiled", [False, True])
def test_cli_timings_print_counts_with_a_profile(profiled, tmp_path, capsys):
    timing.reset_counts()
    argv = ["-n", str(NS), "-j", "6", "-k", "5", "-m", "4", "--device", "cpu",
            "--streaming_block", str(BLOCK), "--eig_mode", "topk",
            "--outdir", str(tmp_path / "m"), "--timings"]
    if profiled:
        argv += ["--profile_dir", str(tmp_path / "trace")]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "streaming_gram" in out
    assert ("lanczos.steps" in out) == profiled
    if not profiled:
        return
    assert f"lanczos.steps{' ' * 27} {2 * NS}" in out
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    scans = {e.get("tid") for e in events
             if e.get("name") == timing.PREFIX + "lanczos.scan"}
    # every thread is recorded where torch can: the spectrum's worker too
    assert len(scans) == (2 if cli._all_threads() is not None else 1)
