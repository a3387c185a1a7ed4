"""The four-card cell ``flagship.sharded4`` (the flagship in memory on a
2 x 2 mesh): its discovery, its six per-layer readers on synthetic
counters and traces, the FLOP count its roofline uses, and the cell itself
cut to a tiny plane as a traced job of four gloo ranks on the CPU."""

import json
import os

import pytest

from h100bench import harness, mesh_work
from h100bench.tests.test_h100bench_job import checkout, job, processes_of
from h100bench.tests.test_h100bench_job import result as result_line
from h100bench.tests.tiny import SIZES
from h100bench.trace import Trace

CELL = "flagship.sharded4"
#: the cell's readers of the program's spans and counters
SPANS = {"gram_s.sharded4": "pod.gram", "eigh_s.sharded4": "pod.eigh",
         "generate_s.sharded4": "sharded.generate"}
READERS = sorted(SPANS) + ["collective_s.sharded4",
                           "collective_gbps.sharded4",
                           "gram_roofline.sharded4"]
#: accepted per-layer metrics whose cells this one was appended to
SHARED = ["model_s.window", "device_idle_pct.model", "unstaged_s.inmem",
          "pod_s", "export_s"]


def test_discovery_accepts_the_cell():
    """Its mesh is its four cards; it reports ``setup_s`` and the peak end
    to end, the six readers of this cell and, per layer, the model time,
    idle share, host glue, POD and export stages of the in-memory cell; its configuration cuts no width and keeps the flagship's
    sizes with neither streaming nor K1."""
    cell = harness.find_cell(CELL)
    assert cell.chips == 4 and harness.mesh_size(cell.config["sizes"]) == 4
    s = cell.config["sizes"]
    assert (s["shard_time"], s["shard_space"]) == (2, 2)
    assert (s["jma"], s["kma"], s["nsteps"], s["num_modes"]) == (
        1024, 512, 10240, 20)
    assert s["pallas"] is False and "streaming_block" not in s
    assert cell.config["reduced"] == ["halo_exchange"]
    assert cell.extra["reference_block"] == 512
    # its model times spread past half of model_s.stream's bound: the
    # model time is read per layer, as in the main-size cells
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"setup_s", "peak_mem_gib"}
    assert sorted(m["name"] for m in cell.per_layer) == sorted(
        READERS + SHARED)
    for m in cell.per_layer:
        assert m["moves"] == "peak_mem_gib"
        assert m["workloads"] == [CELL] or (
            m["name"] in SHARED and m["workloads"][-1] == CELL)
    # no reader of the one-card cells' whole-configuration work
    for name in ("gemm_roofline", "k1_roofline", "k1_roofline.stream"):
        assert name not in {m["name"] for m in cell.per_layer}


def test_gram_flops_by_hand():
    """The symmetric Gram's distinct entries, ``Ns (Ns + 1) / 2`` of them
    at 2 FLOPs a row each, shared over the ranks: at ``Ns = 10`` over 72
    rows, 55 entries x 144 FLOPs over 6 ranks."""
    small = dict(jma=4, kma=6, nsteps=10, shard_time=2, shard_space=3)
    assert mesh_work.gram_flops_rank(small) == 55 * 144 / 6
    flagship = harness.find_cell(CELL).config["sizes"]
    assert mesh_work.gram_flops_rank(flagship) == \
        (10_240 * 10_241 // 2) * 2 * 1_572_864 / 4


def _run(units=2, trace=None):
    run = harness.Run(cell=harness.find_cell(CELL), trace=trace)
    run.units = [dict(seed=i, dir="", wall=1.0, times={}, launches=0,
                      bytes=0) for i in range(units)]
    return run


@pytest.fixture
def counters(monkeypatch):
    """Sets the program's counters that the readers see."""
    counts = harness.load_module(os.path.join(harness.HERE, "metrics",
                                              "_counts.py"))

    def use(values):
        monkeypatch.setattr(counts, "counts", lambda: dict(values))
    return use


def test_span_readers_on_synthetic_counters(counters):
    """Per model over two models; the collectives' seconds sum every
    ``mesh.*`` span's ``_s`` (the calls of ``mesh.shift_s`` are not
    seconds); their rate is their bytes over those seconds."""
    counters({"pod.gram": 2, "pod.gram_s": 3.0, "pod.eigh": 2,
              "pod.eigh_s": 2.2, "sharded.generate": 20,
              "sharded.generate_s": 5.0,
              "mesh.all_reduce": 8, "mesh.all_reduce_s": 1.0,
              "mesh.all_reduce_bytes": 4e9,
              "mesh.exchange_t": 20, "mesh.exchange_t_s": 2.0,
              "mesh.exchange_t_bytes": 8e9,
              "mesh.shift_s": 7, "mesh.shift_s_s": 1.0})
    run = _run(2)
    read = lambda name: harness.metric_reader(name).read(run)
    assert read("gram_s.sharded4") == pytest.approx(1.5)
    assert read("eigh_s.sharded4") == pytest.approx(1.1)
    assert read("generate_s.sharded4") == pytest.approx(2.5)
    assert read("collective_s.sharded4") == pytest.approx(2.0)
    assert read("collective_gbps.sharded4") == pytest.approx(3.0)


def test_readers_read_nothing_without_their_spans(counters):
    """A program without these spans (as the parent of this cell's
    program), or an untraced run: every reader gives None."""
    counters({"pipeline.result_to_host": 1, "pipeline.result_to_host_s": 1.0})
    run = _run(2, trace=Trace(window_s=1.0, busy_s=0.5, kernels={}))
    for name in READERS:
        assert harness.metric_reader(name).read(run) is None, name
    counters({})
    for name in READERS:
        assert harness.metric_reader(name).read(_run(2)) is None, name


def test_gram_roofline_on_a_synthetic_trace():
    """Rank 0's strip FLOPs for each model over the ``gemm`` kernels that
    run inside its ``pod.gram`` spans: a GEMV, and a GEMM outside the
    spans, are not counted."""
    ns = 10 ** 9
    spans = [(0, 2 * ns, "stage:pod.gram"), (5 * ns, 7 * ns, "stage:pod.gram"),
             (0, 8 * ns, "bench:run_pipeline")]
    events = [(ns // 10, ns, "sm90_xmma_gemm_f32f32_f32f32_f32_nt_n"),
              (ns, 3 * ns // 2, "void cutlass_80_simt_sgemm_256x128"),
              (3 * ns // 2, 2 * ns, "gemv2T_kernel"),
              (3 * ns, 4 * ns, "sm90_xmma_gemm_outside"),
              (5 * ns, 6 * ns, "ampere_sgemm_128x64_nn")]
    trace = Trace(window_s=8.0, busy_s=4.0, kernels={}, events=events,
                  spans=spans)
    run = _run(2, trace=trace)
    flops = mesh_work.gram_flops_rank(run.cell.config["sizes"]) * 2
    got = harness.metric_reader("gram_roofline.sharded4").read(run)
    assert got == pytest.approx(100.0 * flops / 2.4 / 67e12)
    run.trace = Trace(window_s=8.0, busy_s=4.0, kernels={}, events=events,
                      spans=spans[2:])
    assert harness.metric_reader("gram_roofline.sharded4").read(run) is None


def test_tiny_cell_as_a_traced_job_of_four_ranks(tmp_path):
    """The cell's own files, its configuration cut to a 24 x 20 plane and
    96 snapshots in a copy of the checkout, run as a job of four gloo ranks
    on the CPU with ``--trace 1``: correct under the cell's limits, its
    mesh 2 x 2, and rank 0's span, stage and counter readers read (the
    roofline reads no device kernel on the CPU); no process left."""
    root, _ = checkout(tmp_path)
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    conf_path = root / "h100bench/configs/inlet1024x512_ns10240_inmem2x2.json"
    conf = json.loads(conf_path.read_text())
    conf["sizes"].update(SIZES)
    conf_path.write_text(json.dumps(conf))
    cell_path = root / f"h100bench/cells/{CELL}.json"
    cell = json.loads(cell_path.read_text())
    cell["reference_block"] = 32
    cell_path.write_text(json.dumps(cell))

    rc, out, err, _ = job(root, CELL, seconds=0.01, trace=1)
    assert rc == 0, err[-3000:]
    line = result_line(out)
    assert line["correct"] is True, line["compared"]
    assert line["device"]["count"] == 4
    assert "mesh: 2x2, backend gloo" in err
    for name in READERS[:-1] + [n for n in SHARED if "idle" not in n]:
        assert line["metrics"][name]["value"] > 0, name
    # no device events on the CPU
    assert "gram_roofline.sharded4" not in line["metrics"]
    assert "device_idle_pct.model" not in line["metrics"]
    assert processes_of(root) == []
