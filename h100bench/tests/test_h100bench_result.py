"""The result's last line, as the harness prints it after a run (on the
CPU, at a tiny size, the card's look skipped)."""

import math
import shutil

import pytest

from h100bench import harness
from h100bench.tests.tiny import run_tiny, tiny_cell

CELLS = ["flagship.stream", "main512.inmem", "flagship.replay",
         "main512.compress"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_last_line(name, trace):
    cell = tiny_cell(name)
    line, err = run_tiny(cell, trace=trace)
    assert list(line)[-1] == "compared"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["compared"]) == set(cell.limits)
    for c in line["compared"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]
    wanted = cell.per_layer if trace else cell.end_to_end
    for name_, m in line["metrics"].items():
        assert name_ in {x["name"] for x in wanted}
        assert m["unit"] == {x["name"]: x["unit"] for x in wanted}[name_]
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        # the window's span is read from the trace (a CPU event here)
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert "setup_s" in line["metrics"]
    # the numbers compared are the last lines of standard error
    tail = err.strip().splitlines()[-len(cell.limits):]
    assert all(t.startswith("compared ") for t in tail)


def test_disk_cap_ends_the_window():
    cell = tiny_cell("main512.inmem")
    import tempfile
    tmp = tempfile.mkdtemp()
    ctx = harness.Context(cell=cell, seed=5, seconds=60.0, trace=False,
                          device="cpu", outdir=tmp, disk_cap=1_200_000)
    import time
    run, _ = harness.measure(ctx, time.perf_counter())
    assert run.ended_by == "disk cap"
    assert run.bytes_written <= ctx.disk_cap
    assert len(run.units) >= 1


def test_verdict_fails_missing_and_nonfinite():
    ok, compared = harness.verdict({"a": 1e-9, "b": float("nan")},
                                   {"a": 1e-6, "b": 1.0, "c": 1.0})
    assert not ok and set(compared) == {"a", "b", "c"}
    assert compared["b"]["value"] is None and compared["c"]["value"] is None
    assert harness.verdict({"a": 1e-9}, {"a": 1e-6})[0]


def test_kernel_seconds_within_stages():
    """A kernel counts for a stage only where it runs inside one of the
    stage's spans: the Lanczos products between the passes do not."""
    from h100bench.trace import Trace

    ms = 1_000_000
    tr = Trace(window_s=1.0, busy_s=0.5, kernels={
        "gemm_a": [3e-3, 3], "gemmSN_NN_kernel": [2e-3, 2]},
        events=[(1 * ms, 2 * ms, "gemm_a"), (3 * ms, 4 * ms, "gemm_a"),
                (5 * ms, 6 * ms, "gemmSN_NN_kernel"),
                (6 * ms, 7 * ms, "gemmSN_NN_kernel"),
                (8 * ms, 9 * ms, "gemm_a")],
        spans=[(0, 4 * ms, "stage:streaming_gram"),
               (4 * ms, 7 * ms, "stage:streaming_eigh_vectors"),
               (7 * ms, 10 * ms, "stage:streaming_projection"),
               (0, 10 * ms, "bench:run_pipeline")])
    gemm = lambda n: "gemm" in n
    assert tr.kernel_seconds(gemm) == (5e-3, 5)
    s, n = tr.kernel_seconds(gemm, stages=("streaming_gram",
                                           "streaming_projection"))
    assert n == 3 and abs(s - 3e-3) < 1e-12
    assert tr.kernel_seconds(gemm, stages=("streaming_mean",)) == (0, 0)


def test_model_s_reads_any_entry_of_whole_models(tmp_path, monkeypatch):
    """``model_s`` (and ``model_s.stream`` and ``model_s.window``, which
    delegate) reads a window of an entry that declares whole models,
    whatever its name, and nothing where an entry's units are calls or
    undeclared."""
    here = tmp_path / "h100bench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    (here / "entries/sharded_models.py").write_text('UNITS = "models"\n')
    (here / "entries/undeclared.py").write_text("")
    monkeypatch.setattr(harness, "HERE", str(here))
    cell = tiny_cell("main512.inmem")
    run = harness.Run(cell=cell, elapsed=6.0, units=[{}, {}, {}])
    for entry, want in (("sharded_models", 2.0), ("pipeline", 2.0),
                        ("compress", 2.0), ("replay", None),
                        ("undeclared", None)):
        cell.traffic = {"entry": entry}
        for name in ("model_s", "model_s.stream", "model_s.window"):
            assert harness.metric_reader(name).read(run) == want, entry
