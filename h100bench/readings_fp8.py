"""The control of the bfloat16 cells, one precision below bf16, and the
readings that their limits are set from, at the cell's own size, in one
process:

    python3 h100bench/readings_fp8.py --workload main512.bf16 \\
        --seeds 1,2,3 --control-seeds 4,5,6

The control is the program with its generated block rounded through
``torch.float8_e4m3fn`` (3 mantissa bits against bf16's 7) before the POD
(:func:`fp8_block`, which wraps the program's ``ops.pod.center_and_gram``);
it has to come out not correct.  TF32 (``readings.tf32``), the float32
cells' control, does not reach bf16: it carries more mantissa bits than
bf16, and the bf16 route runs no float32 product that it would touch.

Each reading is ``readings.reading``'s, with the control in place of TF32;
one JSON line per reading on standard output, as ``readings.py`` prints
them.  The benchmark's own runs do not run this."""

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100bench import harness, readings  # noqa: E402


def round_fp8(A):
    """``A`` rounded to the nearest ``float8_e4m3fn`` value, in ``A``'s
    type."""
    import torch

    return A.to(torch.float8_e4m3fn).to(A.dtype)


@contextlib.contextmanager
def fp8_block():
    """The program's POD takes its snapshot block rounded through fp8."""
    from pods_digital_filter_tpu_torch.ops import pod

    orig = pod.center_and_gram

    def center_and_gram(A):
        return orig(round_fp8(A))

    pod.center_and_gram = center_and_gram
    try:
        yield
    finally:
        pod.center_and_gram = orig


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    if cell.config["sizes"].get("dtype") != "bfloat16" or \
            cell.entry != "pipeline":
        raise SystemExit(f"{cell.name}: not a bfloat16 model cell; its "
                         f"readings are readings.py's")
    harness.check_device(cell.chips)
    entry = harness.entry_module(cell.entry)
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    state = None
    for seed, control in plan:
        tmp = tempfile.mkdtemp(prefix="h100bench-readings-")
        try:
            ctx = harness.Context(cell=cell, seed=seed, seconds=2.0,
                                  trace=False, device="cuda", outdir=tmp)
            t0 = time.perf_counter()
            if state is None:
                state = entry.setup(ctx)
            with fp8_block() if control else contextlib.nullcontext():
                numbers, run = readings.reading(ctx, entry, state, False)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "control": control, "numbers": numbers,
                              "seconds": round(time.perf_counter() - t0, 3),
                              "info": {k: v for k, v in run.info.items()
                                       if k != "fourier_counts"}}),
                  flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
