"""The ported experiment entry points
(pods_digital_filter_tpu_torch/experiments/) run end to end on the CPU at
a tiny size (EXP_SIZES=16, EXP_NF=2), where every kernel takes its plain
version: they print the originals' rows, in the originals' order and with
the originals' labels, and the difference lines are within their bounds.
The entry points run on the card only, so the tests hand them the CPU and
a one-call timer on the host clock in place of ``_timing.device`` and
``_timing.timed``; the kernels' times come only from the card
(chip_smoke.py runs both entry points there at their own sizes)."""

import os
import re
import time

import pytest

from torch_parity import REPO, load_experiment  # noqa: I001

from pods_digital_filter_tpu_torch.experiments import _timing
from pods_digital_filter_tpu_torch.experiments import pipelined_kernel as pk
from pods_digital_filter_tpu_torch.experiments import two_kernel_pipeline as tk
from pods_digital_filter_tpu_torch.ops import (fused_filter, fused_temporal,
                                               noise_probe, toeplitz_gemm)

# every variant of the original but ``fuseddummy``, whose (8, 128) input
# block needs kma >= 128 (its own test is test_torch_fused_modes.py)
VARIANTS = ("base,f32,bf16,xla,noise,noise16b,noise32,noise1seed,noprng,"
            "noisemin,storeonly,store2d,gemmonly,fusednoprng,storef32,"
            "noisebatch")
LABELS = ["base (fused)", "split_f32", "split_bf16", "xla_rng",
          "noise_only (bf16)", "noise16b_only (bf16)", "noise32_only (bf16)",
          "noise1seed_only (bf16)", "noprng_only (bf16)",
          "noisemin_only (bf16)", "storeonly_only (bf16)",
          "store2d (jma, kma) blocks", "gemm_only (zeros noise)",
          "fused_noprng", "storeonly_f32", "noise_batched_g4 (bf16)"]
_ROW = re.compile(r"^(.*\S) +(\d+\.\d{3}) ms/rep$")


def _host_timed(fn, dev, label=""):
    """``_timing.timed`` on the host clock: one call, the same row."""
    t = time.perf_counter()
    float(fn(1).sum())
    dt = time.perf_counter() - t
    print(f"{label:28s} {dt * 1e3:8.3f} ms/rep", flush=True)
    return dt


@pytest.fixture
def tiny(monkeypatch):
    import torch

    for k, v in (("EXP_SIZES", "16"), ("EXP_NF", "2")):
        monkeypatch.setenv(k, v)
    for mod in (tk, pk):
        monkeypatch.setattr(mod, "device", lambda: torch.device("cpu"))
        monkeypatch.setattr(mod, "timed", _host_timed)
    counts = [m.LAUNCHES for m in (fused_filter, toeplitz_gemm, noise_probe,
                                   fused_temporal)]
    yield
    # the CPU runs the plain versions: no kernel was launched
    assert counts == [m.LAUNCHES for m in (fused_filter, toeplitz_gemm,
                                           noise_probe, fused_temporal)]


def _rows(out):
    return [m.group(1) for m in map(_ROW.match, out.splitlines()) if m]


def _original(name):
    with open(os.path.join(REPO, "benchmarks", name)) as f:
        return f.read()


def test_labels_are_the_originals():
    src = _original("exp_two_kernel_pipeline.py")
    for label in LABELS:
        if not label.endswith("_only (bf16)"):
            assert f'label="{label}"' in src, label
    assert ('for nb in ("noise", "noise16b", "noise32", "noise1seed", '
            '"noprng", "noisemin", "storeonly"):') in src
    assert 'label=f"{nb}_only (bf16)"' in src
    src = _original("exp_pipelined_kernel.py")
    assert 'label=f"baseline ({name})"' in src
    assert 'label=f"pipelined ({name})"' in src


def test_two_kernel_main_on_cpu(tiny, monkeypatch, capsys):
    monkeypatch.setenv("EXP_VARIANTS", VARIANTS)
    assert tk.main() == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "=== plane 16x16, 68 slabs x3 comps ==="
    assert _rows(out) == LABELS
    diff = re.search(r"^split_f32 max abs diff vs base: (\S+)$", out, re.M)
    # K1 raw -> K2 against K1, both bf16 taps: within the bf16-tap bound
    b = fused_filter.filters.gaussian_fir_coeffs(2, 4.0)
    assert diff and float(diff.group(1)) <= fused_filter.bf16_tap_bound(b, b)
    assert re.search(r"^best speedup vs base: \d+\.\d{3}x$", out, re.M)


def test_two_kernel_default_variants(tiny, capsys):
    assert tk.main() == 0
    out = capsys.readouterr().out
    assert _rows(out) == LABELS[:4]
    assert "split_f32 max abs diff vs base" in out


def test_fused_temporal_entry_on_cpu(tiny, capsys):
    tk.run_fused_temporal()
    out = capsys.readouterr().out
    assert re.search(r"^fused_temporal out \(3, 64, 16, 16\) mean \S+ var \S+$",
                     out, re.M)
    diff = re.search(r"^fused_temporal max abs diff vs base \+ FIR: (\S+)$",
                     out, re.M)
    assert diff and float(diff.group(1)) <= 1e-5
    assert _rows(out) == ["fused_temporal (FIR in-kernel)",
                          "base + XLA temporal FIR"]


def test_pipelined_main_on_cpu(tiny, capsys):
    assert pk.main() == 0
    out = capsys.readouterr().out
    for name in ("f32", "bf16"):
        assert (f"--- matmul_dtype={name}  max rel diff vs base: 0.00e+00"
                in out.splitlines())
    assert _rows(out) == ["baseline (f32)", "pipelined (f32)",
                          "baseline (bf16)", "pipelined (bf16)"]
    assert len(re.findall(r"^speedup: \d+\.\d{3}x$", out, re.M)) == 2


def test_cuda_device_without_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs a host without one")
    with pytest.raises(RuntimeError, match="cuda"):
        pk.main()


def test_loading_an_original_restores_jax_options():
    """The original sets jax's compilation-cache options at import; the
    loader puts them back."""
    import jax

    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    mod = load_experiment("exp_two_kernel_pipeline")
    assert mod.NF == 8 and mod.REPS == _timing.REPS == 8
    assert (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs) == before
