"""The readings that the limits of ``cells/<cell>.json`` are set from, at
the cell's own size, in one process:

    python3 h100bench/readings.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--seconds 2]

For each seed of ``--seeds`` the program's numbers (one model, or a short
window of replay calls); for each seed of ``--control-seeds`` the control's:
the program one precision below what the configuration states, which has
to come out not correct.

* Model cells state float32 with TF32 off; the control runs the program
  with TF32 on (``torch.backends.cuda.matmul.allow_tf32``, which the
  program's ``device.resolve_device`` turns off), so every cuBLAS product
  in float32 keeps about three decimal digits.
* The replay cell states float64; the control is the replayer's own
  float32 path (``Replayer(dtype="float32")``).

One JSON line per reading on standard output.  The benchmark's own runs do
not run this.
"""

import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100bench import harness  # noqa: E402


@contextlib.contextmanager
def tf32():
    """The program with TF32 products: every module's ``resolve_device``
    turns TF32 back on after the original turns it off."""
    import torch

    from pods_digital_filter_tpu_torch import device

    orig = device.resolve_device

    def resolve(name):
        dev = orig(name)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return dev

    mods = [m for m in list(sys.modules.values())
            if getattr(m, "resolve_device", None) is orig]
    for m in mods:
        m.resolve_device = resolve
    try:
        yield
    finally:
        for m in mods:
            m.resolve_device = orig
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def reading(ctx, entry, state, control):
    """One reading: a model (or a short window) and its numbers."""
    import gc

    import torch

    run = harness.Run(cell=ctx.cell)
    if ctx.cell.entry == "pipeline":
        with tf32() if control else contextlib.nullcontext():
            run.units.append(entry.one_model(ctx, state, 0))
    elif ctx.cell.entry == "compress":
        with tf32() if control else contextlib.nullcontext():
            entry.window(state, ctx, run)
            del run.units[1:]
    else:
        if control:
            from pods_digital_filter_tpu_torch import replay

            state.replayer = replay.Replayer(state.replayer.model,
                                             dtype="float32",
                                             device=ctx.device)
        entry.window(state, ctx, run)
    entry.release(state)
    gc.collect()
    torch.cuda.empty_cache()
    numbers = entry.check(state, ctx, run)
    return numbers, run


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    harness.check_device(cell.chips)
    entry = harness.entry_module(cell.entry)
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    state = None
    for seed, control in plan:
        tmp = tempfile.mkdtemp(prefix="h100bench-readings-")
        try:
            ctx = harness.Context(cell=cell, seed=seed, seconds=args.seconds,
                                  trace=False, device="cuda", outdir=tmp)
            t0 = time.perf_counter()
            if state is None or cell.entry != "pipeline":
                state = entry.setup(ctx)
            numbers, run = reading(ctx, entry, state, control)
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
