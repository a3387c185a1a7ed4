"""Entry ``pipeline``: whole models from the configuration to every model
file on disk, back to back, through ``pipeline.run_pipeline`` (in memory,
or out of core where the configuration streams).

The program's flags are made from the configuration's ``sizes``, the one
statement of the deployment that the reference reads too (``FLAGS``).
Model ``i`` of a run draws its noise with seed ``splitmix(seed + i)``.  Set-up
warms the cell's own shapes: a whole model without its export in memory;
one block generation and one Gram tile product on the streaming path; and
the native writer on a two-row file.  The check judges one model, drawn
from the seed, against the plain reference regenerated from its seed.

A configuration whose ``sizes`` state a mesh (``shard_time``,
``shard_space``) runs on every rank of the cell's job: set-up first makes
the program's mesh (``parallel.mesh.make_mesh``, which picks this rank's
card and the backend), then warms a whole model without its export (on
the streaming path, one block long, which holds every shape but the eigen
half's); rank 0 decides after each model where the window ends; only rank
0 writes model files, and the check reads them.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from dataclasses import dataclass

from h100bench.harness import dir_bytes, mesh_size, splitmix

#: the window's units are whole models (``metrics/model_s.py``)
UNITS = "models"

#: each key of a configuration's ``sizes`` and the program's flag for it;
#: a key with a list value gives one flag per element, ``True`` a bare flag
FLAGS = {"jma": "-j", "kma": "-k", "nsteps": "-n", "res": "-r",
         "lengthscale": "-l", "fwidth": "-f", "U0": "--U0",
         "u_dash": "--u_dash", "normal": ("--nx", "--ny", "--nz"),
         "mean_profile": "-p", "turb_profile": "--turb_profile",
         "num_modes": "-m", "energy_target": "-e", "dtype": "--dtype",
         "pallas": "--pallas", "streaming_block": "--streaming_block",
         "gram_group": "--gram_group", "eig_mode": "--eig_mode",
         "shard_time": "--shard_time", "shard_space": "--shard_space"}

#: the files a model of the pipeline writes besides ``reference.model``'s
FILES = ("POD.spatial_mean_field_*.vtk",)


def program_args(sizes):
    """The program's flags for a configuration's ``sizes``; a key with no
    flag is refused, so that nothing the reference reads is left out."""
    argv = []
    for key, value in sizes.items():
        if key not in FLAGS:
            raise KeyError(f"sizes key {key!r} has no program flag "
                           f"(known: {sorted(FLAGS)})")
        flag = FLAGS[key]
        if isinstance(flag, tuple):
            for f, v in zip(flag, value, strict=True):
                argv += [f, repr(float(v))]
        elif value is True:
            argv.append(flag)
        elif value is not False:
            argv += [flag, str(value)]
    return argv


@dataclass
class State:
    argv: list          # the program's flags for the configuration
    mesh: object = None  # the program's mesh, where the configuration has one


def _config(ctx, argv, outdir, seed):
    from pods_digital_filter_tpu_torch import cli

    args = cli.build_parser().parse_args(
        argv + ["--outdir", outdir, "--seed", str(seed), "--device",
                ctx.device])
    return cli.config_from_args(args)


def warm_writer(ctx):
    """Build the program's native ``.prf`` writer on a two-row file."""
    import numpy as np

    from pods_digital_filter_tpu_torch.io import prf

    d = os.path.join(ctx.outdir, "warm_writer")
    os.makedirs(d, exist_ok=True)
    prf.write_field_prf(os.path.join(d, "w.prf"), "warm", np.zeros((2, 3)),
                        np.ones((2, 3)))


def setup(ctx):
    import torch

    from pods_digital_filter_tpu_torch import pipeline

    sizes = ctx.cell.config["sizes"]
    argv = program_args(sizes)
    state = State(argv=argv)
    if mesh_size(sizes) > 1:
        from pods_digital_filter_tpu_torch.parallel.mesh import make_mesh

        state.mesh = make_mesh(int(sizes.get("shard_time", 1)),
                               int(sizes.get("shard_space", 1)), ctx.device)
    cfg = _config(ctx, argv, os.path.join(ctx.outdir, "warm"),
                  splitmix(ctx.seed ^ 0x3C6EF372))
    if cfg.streaming_block and state.mesh is None:
        fields, _, filt, cfg2, rotate = pipeline.resolve_profile(cfg)
        gen = pipeline.make_generator(cfg2, fields, filt,
                                      nsteps=cfg.streaming_block,
                                      rotate=rotate, device=ctx.device)
        X = gen(0)
        torch.mm(X.T, X)
        del X, gen
    else:
        if cfg.streaming_block:
            cfg = dataclasses.replace(cfg, nsteps=cfg.streaming_block)
        res = pipeline.run_pipeline(cfg, device=ctx.device,
                                    write_outputs=False)
        del res
    warm_writer(ctx)
    gc.collect()
    return state


def one_model(ctx, state, i):
    import torch
    from torch.profiler import record_function

    from pods_digital_filter_tpu_torch import pipeline
    from pods_digital_filter_tpu_torch.ops import fused_filter

    seed = splitmix(ctx.seed + i)
    d = os.path.join(ctx.outdir, f"m{i}")
    cfg = _config(ctx, state.argv, d, seed)
    launches = fused_filter.LAUNCHES
    t0 = time.perf_counter()
    with record_function("bench:run_pipeline"):
        res = pipeline.run_pipeline(cfg, device=ctx.device)
        if torch.device(ctx.device).type == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    unit = dict(seed=seed, dir=d, wall=wall, times=dict(res.timer.times),
                launches=fused_filter.LAUNCHES - launches, bytes=dir_bytes(d))
    del res
    return unit


def window(state, ctx, run):
    """Whole models back to back until the first model boundary after
    ``ctx.seconds``, or until the next model would take the run's files
    past the disk cap (rank 0's clock and files, in a job)."""
    written = dir_bytes(ctx.outdir)
    t0 = time.perf_counter()
    i = 0
    while True:
        unit = one_model(ctx, state, i)
        run.units.append(unit)
        written += unit["bytes"]
        run.elapsed = time.perf_counter() - t0
        ended = ("time" if run.elapsed >= ctx.seconds else
                 "disk cap" if written + unit["bytes"] > ctx.disk_cap else "")
        ended = ctx.decide(ended)
        if ended:
            run.ended_by = ended
            break
        i += 1
    run.bytes_written = written
    run.info["model walls (s)"] = [round(u["wall"], 4) for u in run.units]
    run.info["bytes per model"] = [u["bytes"] for u in run.units]
    if state.mesh is not None:
        m = state.mesh
        run.info["mesh"] = (f"{m.shard_time}x{m.shard_space}, backend "
                            f"{m.backend}, rank -> device " + ", ".join(
                                f"{r}: {d}" for r, d in enumerate(m.devices)))


def release(state):
    gc.collect()


def check(state, ctx, run):
    """Judge one model of the window, drawn from the seed, against the
    reference regenerated from that model's seed."""
    from h100bench.reference.inlet import Inlet
    from h100bench.reference.model import judge

    if not run.units:
        return {}
    k = splitmix(ctx.seed ^ 0x2545F491) % len(run.units)
    unit = run.units[k]
    sizes = ctx.cell.config["sizes"]
    inlet = Inlet(sizes, ctx.device)
    t0 = time.perf_counter()
    numbers, info = judge(
        unit["dir"], lambda t, n: inlet.block(unit["seed"], t, n),
        inlet.rows, int(sizes["nsteps"]), inlet.dt, int(sizes["num_modes"]),
        float(sizes["energy_target"]),
        int(ctx.cell.extra.get("reference_block", sizes["nsteps"])),
        ctx.device, shift=inlet.mean_guess(), files=FILES)
    run.info["judged model"] = k
    run.info["reference s"] = round(time.perf_counter() - t0, 3)
    run.info.update(info)
    return numbers
