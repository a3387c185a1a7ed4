"""Entry ``compress``: ``compress.compress_snapshot_matrix`` on a pageable
host float32 snapshot matrix that the generator did not make, model after
model, from the matrix to every model file on disk.

The matrix is made once from the seed, on the card, and copied to the host,
where users' snapshots live: ``bench_pod.py``'s recipe (a rank-``rank``
field with a decaying spectrum ``exp(-decay * i)``, ``harmonics``
narrowband temporal harmonics per mode below ``max_harmonic``, and
broadband noise of ``noise``) on a mean flow of ``mean`` plus a standard
normal per row, as LES snapshots carry one; rows ``3 * jma * kma`` by
``nsteps`` columns.  Set-up warms one whole compression; the check judges one model,
drawn from the seed, against the plain reference on the same matrix.
"""

from __future__ import annotations

import gc
import math
import os
import time
from dataclasses import dataclass

from h100bench.harness import dir_bytes, splitmix

#: the window's units are whole models (``metrics/model_s.py``)
UNITS = "models"


@dataclass
class State:
    A: object          # host numpy (rows, ns) float32
    points: object     # (Np, 3)
    dt: float
    num_modes: int
    energy_target: float


def make_matrix(traffic, rows, ns, seed, device):
    """The snapshot matrix of ``traffic``'s recipe, float32 on the host."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    k, h = int(traffic["rank"]), int(traffic["harmonics"])
    kw = dict(generator=g, device=device)
    U = torch.randn((rows, k), dtype=torch.float32, **kw)
    s = torch.exp(-float(traffic["decay"]) * torch.arange(
        k, dtype=torch.float64, device=device))
    t = torch.arange(ns, dtype=torch.float64, device=device) / ns
    freqs = torch.randint(1, int(traffic["max_harmonic"]) + 1, (k, h),
                          **kw).to(torch.float64)
    phases = torch.rand((k, h), dtype=torch.float64, **kw) * 2 * math.pi
    amps = 0.5 + 0.5 * torch.rand((k, h), dtype=torch.float64, **kw)
    V = torch.einsum("kh,kht->kt", amps, torch.cos(
        2 * math.pi * freqs[:, :, None] * t[None, None, :]
        + phases[:, :, None]))
    A = U @ (s[:, None] * V).to(torch.float32)
    A += float(traffic["mean"]) + torch.randn((rows, 1), dtype=torch.float32,
                                               **kw)
    A += float(traffic["noise"]) * torch.randn((rows, ns),
                                               dtype=torch.float32, **kw)
    return A.cpu().numpy()


def plane_points(jma, kma):
    import numpy as np

    j, k = np.meshgrid(np.arange(jma), np.arange(kma), indexing="ij")
    return np.stack([np.zeros(jma * kma), 0.01 * j.ravel(),
                     0.01 * k.ravel()], axis=1)


def setup(ctx):
    from pods_digital_filter_tpu_torch import compress

    sizes, traffic = ctx.cell.config["sizes"], ctx.cell.traffic
    jma, kma, ns = int(sizes["jma"]), int(sizes["kma"]), int(sizes["nsteps"])
    state = State(A=make_matrix(traffic, 3 * jma * kma, ns, ctx.seed,
                                ctx.device),
                  points=plane_points(jma, kma), dt=float(traffic["dt"]),
                  num_modes=int(sizes["num_modes"]),
                  energy_target=float(sizes["energy_target"]))
    compress.compress_snapshot_matrix(
        state.A, state.points, state.dt, state.num_modes,
        state.energy_target, os.path.join(ctx.outdir, "warm"),
        device=ctx.device)
    gc.collect()
    return state


def window(state, ctx, run):
    import torch
    from torch.profiler import record_function

    from pods_digital_filter_tpu_torch import compress

    cuda = torch.device(ctx.device).type == "cuda"
    written = dir_bytes(ctx.outdir)
    t0 = time.perf_counter()
    i = 0
    while True:
        d = os.path.join(ctx.outdir, f"m{i}")
        ts = time.perf_counter()
        with record_function("bench:compress_snapshot_matrix"):
            compress.compress_snapshot_matrix(
                state.A, state.points, state.dt, state.num_modes,
                state.energy_target, d, device=ctx.device)
            if cuda:
                torch.cuda.synchronize()
        unit = dict(dir=d, wall=time.perf_counter() - ts, bytes=dir_bytes(d))
        run.units.append(unit)
        written += unit["bytes"]
        run.elapsed = time.perf_counter() - t0
        if run.elapsed >= ctx.seconds:
            run.ended_by = "time"
            break
        if written + unit["bytes"] > ctx.disk_cap:
            run.ended_by = "disk cap"
            break
        i += 1
    run.bytes_written = written
    run.info["model walls (s)"] = [round(u["wall"], 4) for u in run.units]
    run.info["bytes per model"] = [u["bytes"] for u in run.units]


def release(state):
    gc.collect()


def check(state, ctx, run):
    import torch

    from h100bench.reference.model import judge

    if not run.units:
        return {}
    k = splitmix(ctx.seed ^ 0x2545F491) % len(run.units)
    A, ns = state.A, state.A.shape[1]
    block = int(ctx.cell.extra.get("reference_block", ns))
    columns = lambda t, n: torch.from_numpy(A[:, t:t + n]).to(
        ctx.device, torch.float64)
    t0 = time.perf_counter()
    numbers, info = judge(run.units[k]["dir"], columns, A.shape[0], ns,
                          state.dt, state.num_modes, state.energy_target,
                          block, ctx.device)
    run.info["judged model"] = k
    run.info["reference s"] = round(time.perf_counter() - t0, 3)
    run.info.update(info)
    return numbers
