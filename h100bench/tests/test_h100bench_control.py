"""The control, kept as a test at a size a test run holds: on the card,
the program one precision below what a configuration states has to come
out not correct under each cell's limits, and the program itself correct.

* model cells: the program with TF32 products (``readings.tf32``), at a
  256 x 256 plane and 512 snapshots;
* the replay cell: the replayer's float32 path, at 65,536 points.

The readings at the cells' own sizes are made by ``h100bench/readings.py``
on the card (PERF.md gives them).  Run on the card with
``python3 -m pytest h100bench/tests -m cuda``; here they skip."""

import copy
import tempfile

import pytest

from h100bench import harness

SMALL = dict(jma=256, kma=256, nsteps=512)
STREAMING = dict(streaming_block=128, gram_group=2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the control's TF32 products and "
                    "the float32 replay run there only)")
    return "cuda"


def small_cell(name):
    cell = harness.find_cell(name)
    cfg = copy.deepcopy(cell.config)
    s = cfg["sizes"]
    s.update(SMALL)
    if "streaming_block" in s:
        s.update(STREAMING)
        cell.extra = dict(cell.extra,
                          reference_block=STREAMING["streaming_block"])
    cell.config = cfg
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["main512.inmem", "flagship.stream",
                                  "main512.compress", "flagship.replay"])
def test_control_fails_and_program_passes(name, card):
    from h100bench import readings

    cell = small_cell(name)
    entry = harness.entry_module(cell.entry)
    verdicts = {}
    for control in (False, True):
        ctx = harness.Context(cell=cell, seed=7_000_000_001, seconds=0.5,
                              trace=False, device=card,
                              outdir=tempfile.mkdtemp())
        state = entry.setup(ctx)
        numbers, _ = readings.reading(ctx, entry, state, control)
        verdicts[control] = harness.verdict(numbers, cell.limits)[0]
    assert verdicts == {False: True, True: False}
