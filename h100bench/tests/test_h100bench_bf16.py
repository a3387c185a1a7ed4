"""The bfloat16 deployment ``main512.bf16``: its configuration and cell are
found by name and state the float32 cell's sizes in bf16; the reader
``tail_roofline.bf16`` on synthetic traces and counters; the fp8 control
that its limits are set against."""

import os

import pytest

from h100bench import harness, readings_fp8
from h100bench.trace import Trace

CELL = "main512.bf16"
BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))

#: the cells' shared per-layer metrics this cell was appended to, and its
#: own reader
PER_LAYER = ["model_s.window", "k1_roofline", "pod_s", "export_s",
             "device_idle_pct.model", "tail_roofline.bf16"]

#: one bf16 K5 launch at the main window: the f32 slabs (1,040 x 3 of
#: 512 x 512) read once, the bf16 block (3 x 512 x 512 x 1,024) written once
MAIN_BYTES = 4 * 3 * 512 * 512 * 1040 + 2 * 3 * 512 * 512 * 1024


def _reader():
    return harness.metric_reader("tail_roofline.bf16")


def test_discovery_finds_the_cell():
    """One card; the float32 cell's sizes with ``dtype`` bfloat16; no cut;
    the float32 cell's limit names; ``setup_s`` and the peak end to end,
    and the shared model metrics and its tail reader per layer."""
    cell = harness.find_cell(CELL)
    f32 = harness.find_cell("main512.inmem")
    assert cell.chips == 1 and harness.mesh_size(cell.config["sizes"]) == 1
    assert cell.entry == "pipeline"
    s = dict(cell.config["sizes"])
    assert s.pop("dtype") == "bfloat16" and s["pallas"] is True
    assert s == {k: v for k, v in f32.config["sizes"].items()
                 if k != "dtype"}
    assert cell.config["reduced"] == []
    conf = {c["name"]: c for c in BENCH["configs"]}[cell.config["name"]]
    assert conf["reduced"] == [] and conf["file"].startswith("h100bench/")
    assert set(cell.limits) == set(f32.limits)
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                     "peak_mem_gib"}
    assert sorted(m["name"] for m in cell.per_layer) == sorted(PER_LAYER)
    for m in cell.per_layer:
        assert m["moves"] == "peak_mem_gib" and CELL in m["workloads"]


def test_program_args_state_bf16():
    pipeline = harness.entry_module("pipeline")
    sizes = harness.find_cell(CELL).config["sizes"]
    argv = pipeline.program_args(sizes)
    assert argv[argv.index("--dtype") + 1] == "bfloat16"
    assert argv[-1] == "--pallas"
    from pods_digital_filter_tpu_torch import cli

    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert cfg.dtype == "bfloat16" and cfg.use_pallas


def test_tail_bytes_by_hand():
    """At the main window (512 x 512, 1,024 steps, nf 8): 4,882,169,856 B,
    a bound of 1.457 ms at 3.35 TB/s."""
    r = _reader()
    assert r.tail_bytes(1024, 512, 512, 8) == MAIN_BYTES == 4_882_169_856
    assert round(MAIN_BYTES / 3.35e12 * 1e3, 3) == 1.457


def _run(cell_name, traced=2, sec=4e-3):
    cell = harness.find_cell(cell_name)
    trace = Trace(window_s=10.0, busy_s=5.0, kernels={
        "void (anonymous namespace)::tail_kernel<8, __nv_bfloat16>"
        "((anonymous namespace)::Params)": [sec, traced],
        "walk_kernel<8, false, 0, 0, false>": [5e-3, traced]})
    return harness.Run(cell=cell, units=[{}, {}], trace=trace)


@pytest.mark.parametrize("cell,launches,traced,want", [
    (CELL, 2, 2, 100.0 * (MAIN_BYTES / 3.35e12) / 2e-3),
    (CELL, 3, 2, None),            # a launch the trace did not see
    (CELL, None, 2, None),         # a program without the counter
    ("main512.inmem", 2, 2, None),  # a float32 configuration
])
def test_tail_roofline_bf16_reads(monkeypatch, cell, launches, traced, want):
    r = _reader()
    counts = {} if launches is None else {"fused_tail.bf16_launches": launches,
                                          "fused_tail.launches": launches}
    monkeypatch.setattr(r._counts, "counts", lambda: counts)
    got = r.read(_run(cell, traced))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want) and 0 < got < 100


def test_tail_roofline_bf16_untraced_reads_nothing(monkeypatch):
    r = _reader()
    monkeypatch.setattr(r._counts, "counts",
                        lambda: {"fused_tail.bf16_launches": 2})
    run = _run(CELL)
    run.trace = None
    assert r.read(run) is None


def test_fp8_rounds_and_restores():
    """The control rounds the block the POD takes to float8 e4m3 (3
    mantissa bits) in the block's type, and puts the program back."""
    import torch

    from pods_digital_filter_tpu_torch.ops import pod

    A = torch.tensor([[1.0, 1.0625, 1.125, 0.02]], dtype=torch.bfloat16)
    r = readings_fp8.round_fp8(A)
    assert r.dtype == torch.bfloat16
    assert r[0].tolist() == [1.0, 1.0, 1.125, 0.01953125]
    orig = pod.center_and_gram
    B = torch.tensor([[1.0625, 0.9], [0.5, 2.1]])
    with readings_fp8.fp8_block():
        mean, Ac, _ = pod.center_and_gram(B)
    assert pod.center_and_gram is orig
    want = B.to(torch.float8_e4m3fn).float()
    assert torch.equal(mean, want.mean(dim=1))
    assert torch.equal(Ac, want - want.mean(dim=1)[:, None])


def test_readings_fp8_refuses_a_float32_cell():
    with pytest.raises(SystemExit, match="not a bfloat16 model cell"):
        readings_fp8.main(["--workload", "main512.inmem", "--seeds", "1"])
