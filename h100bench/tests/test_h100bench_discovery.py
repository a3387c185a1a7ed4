"""The benchmark's files, found by name, and the contract's rules on
``BENCHMARK.json``; a cell is added by adding files and an entry alone."""

import json
import os
import re
import shutil

import pytest

from h100bench import harness
from h100bench.tests.tiny import run_tiny, tiny_cell

ROOT = harness.ROOT
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
            assert "\t" not in text
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}, w
    metric = {"name", "unit", "better", "source"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == metric | {"bound"}, m
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == metric | {"layer", "moves"}, m


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + \
        [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_cell_reports_what_it_needs():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = harness.find_cell(w["name"], BENCH)
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in {x["name"] for x in cell.end_to_end}
            assert m["moves"] in e2e
        assert cell.limits
        # the configuration's mesh takes the cell's cards
        assert harness.mesh_size(cell.config["sizes"]) == w["chips"]


@pytest.mark.parametrize("name", CELLS)
def test_files_found_by_name(name):
    cell = harness.find_cell(name, BENCH)
    assert callable(harness.entry_module(cell.entry).setup)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)
    conf = {c["name"]: c for c in BENCH["configs"]}
    w = {x["name"]: x for x in BENCH["workloads"]}[name]
    assert os.path.isfile(os.path.join(ROOT, conf[w["config"]]["file"]))


def test_config_files_state_their_source():
    for c in BENCH["configs"]:
        data = harness.load_json(os.path.join(ROOT, c["file"]))
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"].startswith(c["source"][:100])
        assert c["file"].startswith("h100bench/")


def test_sizes_agree_with_the_program_flags():
    """The reference reads ``sizes``; the program parses the flags that
    ``entries/pipeline.program_args`` makes of them."""
    from pods_digital_filter_tpu_torch import cli

    pipeline = harness.entry_module("pipeline")
    sizes = [harness.load_json(os.path.join(ROOT, c["file"]))["sizes"]
             for c in BENCH["configs"]]
    # a mesh, as a configuration over several cards states it
    sizes.append(dict(sizes[0], pallas=False, shard_time=2, shard_space=2))
    for s in sizes:
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            pipeline.program_args(s)))
        assert (cfg.plane.jma, cfg.plane.kma, cfg.nsteps) == (
            s["jma"], s["kma"], s["nsteps"])
        assert cfg.plane.res == s["res"] and cfg.dtype == s["dtype"]
        assert cfg.filt.length_scale_y == s["lengthscale"]
        assert cfg.filt.fwidth == s["fwidth"]
        assert (cfg.podfs.num_modes, cfg.podfs.energy_target) == (
            s["num_modes"], s["energy_target"])
        assert cfg.bulk_velocity == s["U0"]
        assert cfg.turbulence_intensity == s["u_dash"]
        assert tuple(cfg.plane.normal) == tuple(s["normal"])
        assert (cfg.mean_profile, cfg.turb_profile) == (
            s["mean_profile"], s["turb_profile"])
        assert cfg.streaming_block == s.get("streaming_block", 0)
        assert cfg.gram_group == s.get("gram_group", 1)
        assert cfg.use_pallas == s.get("pallas", False)
        assert cfg.eig_mode == s.get("eig_mode", "auto")
        assert (cfg.shard_time, cfg.shard_space) == (
            s.get("shard_time", 1), s.get("shard_space", 1))


#: each configuration's flags as the benchmark made them before a mesh
#: could be stated: a configuration without one makes the same argv
ARGV = {
    "inlet1024x512_ns10240": [
        "-j", "1024", "-k", "512", "-n", "10240", "-r", "0.1", "-l", "4.0",
        "-f", "2.0", "--U0", "1.0", "--u_dash", "0.02", "--nx", "1.0",
        "--ny", "0.0", "--nz", "0.0", "-p", "hyperbolic-tangent",
        "--turb_profile", "top-hat", "-m", "20", "-e", "0.9", "--dtype",
        "float32", "--streaming_block", "512", "--gram_group", "8",
        "--pallas", "--eig_mode", "topk"],
    "inlet512x512_ns1024": [
        "-j", "512", "-k", "512", "-n", "1024", "-r", "0.1", "-l", "4.0",
        "-f", "2.0", "--U0", "1.0", "--u_dash", "0.02", "--nx", "1.0",
        "--ny", "0.0", "--nz", "0.0", "-p", "hyperbolic-tangent",
        "--turb_profile", "top-hat", "-m", "20", "-e", "0.9", "--dtype",
        "float32", "--pallas"]}


@pytest.mark.parametrize("name", sorted(ARGV))
def test_program_args_as_before(name):
    pipeline = harness.entry_module("pipeline")
    conf = {c["name"]: c for c in BENCH["configs"]}[name]
    sizes = harness.load_json(os.path.join(ROOT, conf["file"]))["sizes"]
    assert pipeline.program_args(sizes) == ARGV[name]


def test_a_mesh_that_is_not_the_cells_cards_is_refused(tmp_path):
    """A configuration whose mesh takes 2 cards, run by a one-card cell, is
    refused when the cell is found."""
    shutil.copytree(os.path.join(ROOT, "h100bench"), tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = harness.load_json(os.path.join(
        ROOT, "h100bench/configs/inlet512x512_ns1024.json"))
    conf["sizes"].update(pallas=False, shard_space=2)
    (tmp_path / "h100bench/configs/mesh2.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "mesh2", "source": "a mesh of 2",
                             "file": "h100bench/configs/mesh2.json",
                             "reduced": [], "why": "a mesh of 2"})
    for chips in (1, 4):
        bench["workloads"].append({"name": f"mesh2.c{chips}",
                                   "config": "mesh2", "traffic": "models",
                                   "chips": chips, "why": "a mesh of 2"})
        shutil.copy(os.path.join(ROOT, "h100bench/cells/main512.inmem.json"),
                    tmp_path / f"h100bench/cells/mesh2.c{chips}.json")
        with pytest.raises(ValueError, match="mesh"):
            harness.find_cell(f"mesh2.c{chips}", bench, root=str(tmp_path))


def test_a_size_with_no_flag_is_refused():
    pipeline = harness.entry_module("pipeline")
    with pytest.raises(KeyError, match="no program flag"):
        pipeline.program_args({"jma": 8, "ring_radius": 0.5})


def test_a_cell_added_by_files_alone(tmp_path):
    """A throwaway cell: a traffic file, a cell file, a metric file and an
    entry of ``BENCHMARK.json``, with no existing file edited, is found and
    runs."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "h100bench"), root / "h100bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (root / "h100bench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "main512.models2", "config":
                               "inlet512x512_ns1024", "traffic": "models2",
                               "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "models_in_window", "unit": "models",
                               "better": "higher", "source": "host_clock",
                               "layer": "pipeline", "moves": "setup_s",
                               "workloads": ["main512.models2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "h100bench/traffic/models2.json").write_text(json.dumps(
        {"entry": "pipeline", "why": "throwaway"}))
    (root / "h100bench/cells/main512.models2.json").write_text(json.dumps(
        {"limits": {"mean_err": 1e-3}}))
    (root / "h100bench/metrics/models_in_window.py").write_text(
        "def read(run):\n    return float(len(run.units))\n")
    after = {p: p.read_bytes() for p in before}
    assert after == before
    cell = harness.find_cell("main512.models2", bench, root=str(root))
    assert cell.traffic["why"] == "throwaway"
    assert [m["name"] for m in cell.per_layer] == ["models_in_window"]
    here = harness.HERE
    try:
        harness.HERE = str(root / "h100bench")
        cell = tiny_cell_from(cell)
        line, _ = run_tiny(cell, trace=True)
    finally:
        harness.HERE = here
    assert line["correct"] is True
    assert line["metrics"]["models_in_window"]["value"] >= 1


def tiny_cell_from(cell):
    """``tiny_cell``'s cut applied to a cell already found."""
    small = tiny_cell("main512.inmem", BENCH)
    small.name, small.traffic, small.limits = cell.name, cell.traffic, \
        cell.limits
    small.per_layer, small.extra = cell.per_layer, cell.extra
    return small
