"""The bfloat16 ``--pallas`` route end to end on the CPU, as the benchmark's
cell ``main512.bf16`` states it but on a small plane: the model that
``run_pipeline`` writes is judged by the benchmark's plain reference
(``h100bench/reference``, float64 from the seed) within the cell's limits,
and the same run with its block rounded through float8 before the POD (the
cell's control, ``h100bench/readings_fp8.py``) is judged not correct."""

import contextlib
import json
import os

import pytest

from pods_digital_filter_tpu_torch import cli
from pods_digital_filter_tpu_torch.pipeline import run_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the cell's plane cut to what the CPU runs in seconds; the rest of its
#: sizes (filter, profiles, modes, energy target, dtype, pallas) as stated.
#: The plane keeps enough points (36,864 rows) that a mode's projection
#: averages the bf16 rounding of the snapshots as the cell's does: on much
#: smaller planes the Fourier error alone grows past the cell's limit
SMALL = dict(jma=128, kma=96, nsteps=256)
SEED = 2 ** 40 + 3


def _cell():
    from h100bench import harness

    cell = harness.find_cell("main512.bf16")
    return dict(cell.config["sizes"], **SMALL), cell.limits


def _judged(tmp_path, control):
    from h100bench import harness, readings_fp8
    from h100bench.reference.inlet import Inlet
    from h100bench.reference.model import judge

    sizes, _ = _cell()
    argv = harness.entry_module("pipeline").program_args(sizes)
    out = str(tmp_path / ("control" if control else "program"))
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        argv + ["--outdir", out, "--seed", str(SEED), "--device", "cpu"]))
    assert cfg.dtype == "bfloat16" and cfg.use_pallas
    with readings_fp8.fp8_block() if control else contextlib.nullcontext():
        run_pipeline(cfg, device="cpu")
    inlet = Inlet(sizes, "cpu")
    numbers, _ = judge(out, lambda t, n: inlet.block(SEED, t, n), inlet.rows,
                       sizes["nsteps"], inlet.dt, sizes["num_modes"],
                       sizes["energy_target"], sizes["nsteps"], "cpu",
                       shift=inlet.mean_guess(),
                       files=("POD.spatial_mean_field_*.vtk",))
    return numbers


@pytest.mark.parametrize("control", [False, True])
def test_bf16_model_judged_by_the_reference(tmp_path, control):
    _, limits = _cell()
    numbers = _judged(tmp_path, control)
    over = {k: (numbers[k], v) for k, v in limits.items() if numbers[k] > v}
    if control:
        assert over, numbers
    else:
        assert not over, over


def test_the_limits_have_their_reasons():
    """Each limit of the cell is written with the reason for its value."""
    with open(os.path.join(ROOT, "h100bench/cells/main512.bf16.json")) as f:
        data = json.load(f)
    assert set(data) == {"limits", "reasons"}
    assert set(data["reasons"]) == set(data["limits"])
    assert all(isinstance(v, float) for v in data["limits"].values())
    assert all(isinstance(r, str) and len(r) > 20
               for r in data["reasons"].values())
