"""What the benchmark may import and where it may write.

Top-level module names are compared whole: the program's package
``pods_digital_filter_tpu_torch`` begins with the JAX package's name."""

import ast
import glob
import os
import sys

import pytest

from h100bench import harness

HERE = harness.HERE
SOURCES = sorted(glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True))
SOURCES = [p for p in SOURCES if os.sep + "tests" + os.sep not in p]
JAX = {"jax", "jaxlib", "flax", "pods_digital_filter_tpu"}


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def strings(path):
    """String constants that are not docstrings."""
    tree = ast.parse(open(path).read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) \
                and node.body and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            docs.add(id(node.body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_import(path):
    assert not set(imports(path)) & JAX


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "pods_digital_filter_tpu_torch" not in set(imports(path))
    assert set(imports(path)) <= {"__future__", "math", "os", "numpy",
                                  "torch"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, HERE))
def test_reads_nothing_of_the_jax_records(path):
    for s in strings(path):
        assert "benchmarks/" not in s and "bench.py" not in s, s
        assert not s.startswith(("/tmp", "/dev/shm", "/root")), s


def test_forbidden_modules_compare_whole_names():
    assert "pods_digital_filter_tpu_torch" in sys.modules or True
    found = harness.forbidden_modules()
    assert "pods_digital_filter_tpu" not in found or \
        "pods_digital_filter_tpu" in sys.modules
    sys.modules["jax_like_but_not"] = sys.modules["os"]
    try:
        assert "jax" not in harness.forbidden_modules()
    finally:
        del sys.modules["jax_like_but_not"]
    sys.modules["jax.numpy"] = sys.modules["os"]
    try:
        assert "jax" in harness.forbidden_modules()
    finally:
        del sys.modules["jax.numpy"]


def test_run_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "main512.inmem", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_outputs_under_tmpdir(tmp_path, monkeypatch):
    """A run's model files go under ``TMPDIR``; the build caches that
    ``run.py`` names are inside the checkout."""
    import tempfile

    from h100bench.tests.tiny import tiny_cell

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    out = tempfile.mkdtemp(prefix="h100bench-")
    assert out.startswith(str(tmp_path))
    import time

    ctx = harness.Context(cell=tiny_cell("main512.inmem"), seed=3,
                          seconds=0.2, trace=False, device="cpu", outdir=out)
    run, _ = harness.measure(ctx, time.perf_counter())
    dirs = [u["dir"] for u in run.units]
    assert dirs and all(os.path.realpath(d).startswith(
        os.path.realpath(str(tmp_path))) for d in dirs)
    src = open(os.path.join(HERE, "run.py")).read()
    assert 'os.path.join(ROOT, "h100bench", "_cache")' in src
