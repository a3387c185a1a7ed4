"""Entry ``replay``: ``replay.Replayer.batch_device`` on a PODFS model of
the configuration's size, call after call, each call ``times_per_call``
consecutive solver time steps, as a GPU-resident solver pulls its inlet.

The model is made on the card from the seed with ``bench_replay.py``'s
recipe (standard-normal points, mean and modes; per mode ``n`` Fourier
terms at wavenumbers ``-n//2 .. n - n//2 - 1`` with normal coefficients
over ``1 + |k|``), ``num_modes`` modes, the term counts and the period the
configuration file states under ``assumed``; once the replayer holds it,
the benchmark's own copy waits on the host for the check.  Each call is
timed by CUDA events on the stream, from before the call to after its last
kernel, and the host waits for the second event, as a consumer of each
batch waits for it.  The outputs of a sample of calls drawn from the seed
are copied, on a stream of their own and while the next calls run, into
host buffers pinned in set-up; the last call's is copied once the window
has closed.  So the card holds no more than the replayer's own working set
and an output in flight.  All are judged against the plain reference once
the window has closed.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

from h100bench.harness import splitmix

#: at most this many calls' outputs are kept for the check, besides the
#: last call's
KEEP = 8


@dataclass
class State:
    arrays: dict
    period: float
    dt: float
    steps: int
    replayer: object = None
    kept: list = field(default_factory=list)
    host: object = None        # pinned (KEEP + 1, steps, 3 * points) buffers


def make_model(sizes, assumed, seed, device):
    """The model's arrays, float64, made on ``device`` from ``seed``."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    npts = int(sizes["jma"]) * int(sizes["kma"])
    counts = [int(c) for c in assumed["fourier_counts"]]
    nm, kmax = len(counts), max(counts)
    f64 = dict(dtype=torch.float64, device=device, generator=g)
    k = torch.zeros((nm, kmax), dtype=torch.float64, device=device)
    for i, n in enumerate(counts):
        k[i, :n] = torch.arange(n, dtype=torch.float64, device=device) - n // 2
    live = k.new_zeros(k.shape)
    for i, n in enumerate(counts):
        live[i, :n] = 1.0
    c = torch.randn((2, nm, kmax), **f64) / (1.0 + k.abs())[None] * live[None]
    return dict(points=torch.randn((npts, 3), **f64),
                mean=torch.randn(3 * npts, **f64),
                modes=torch.randn((nm, 3 * npts), **f64),
                k=k, c_re=c[0], c_im=c[1], counts=counts)


def setup(ctx):
    import numpy as np
    import torch

    from pods_digital_filter_tpu_torch import replay

    sizes, traffic = ctx.cell.config["sizes"], ctx.cell.traffic
    assumed = ctx.cell.config["assumed"]
    arrays = make_model(sizes, assumed, ctx.seed, ctx.device)
    period = float(assumed["period"])
    host = lambda t: t.cpu().numpy()
    fc = [np.stack([host(arrays["k"][i, :n]), host(arrays["c_re"][i, :n]),
                    host(arrays["c_im"][i, :n])], axis=1)
          for i, n in enumerate(arrays["counts"])]
    model = replay.PODFSModel.from_arrays(
        host(arrays["points"]), host(arrays["mean"]), host(arrays["modes"]),
        period, fc)
    state = State(arrays=arrays, period=period,
                  dt=period / int(sizes["nsteps"]),
                  steps=int(traffic["times_per_call"]))
    state.replayer = replay.Replayer(model, dtype=traffic.get("dtype"),
                                     device=ctx.device)
    del model
    # the reference's copy of the model waits on the host
    state.arrays = {k: v.cpu() if torch.is_tensor(v) else v
                    for k, v in arrays.items()}
    del arrays
    for c in range(3):
        out = state.replayer.batch_device(_times(state, c))
    if torch.device(ctx.device).type == "cuda":
        state.host = torch.empty((KEEP + 1,) + tuple(out.shape),
                                 dtype=out.dtype, pin_memory=True)
        torch.cuda.synchronize()
    del out
    gc.collect()
    return state


def _times(state, call):
    import numpy as np

    return (call * state.steps + np.arange(state.steps)) * state.dt


def window(state, ctx, run):
    import torch
    from torch.profiler import record_function

    cuda = torch.device(ctx.device).type == "cuda"
    ev0 = torch.cuda.Event(enable_timing=True) if cuda else None
    ev1 = torch.cuda.Event(enable_timing=True) if cuda else None
    side = torch.cuda.Stream() if cuda else None
    rp = state.replayer
    t0 = time.perf_counter()
    call = 0
    while True:
        ts = _times(state, call)
        with record_function("bench:batch_device"):
            if cuda:
                ev0.record()
                out = rp.batch_device(ts)
                ev1.record()
                ev1.synchronize()
                ms = ev0.elapsed_time(ev1)
            else:
                h = time.perf_counter()
                out = rp.batch_device(ts)
                ms = (time.perf_counter() - h) * 1e3
        run.units.append(ms)
        if (len(state.kept) < KEEP
                and splitmix(ctx.seed * 65537 + call) % 128 == 0):
            state.kept.append((call, _keep(state, out, side)))
        call += 1
        run.elapsed = time.perf_counter() - t0
        if run.elapsed >= ctx.seconds:
            break
    state.kept.append((call - 1, _keep(state, out, side)))
    del out
    if cuda:
        side.synchronize()
    run.ended_by = "time"
    run.info["points x steps per call"] = rp.model.num_points * state.steps
    run.info["calls kept for the check"] = len(state.kept)


def _keep(state, out, side):
    """A kept call's output: on the card, copied on ``side`` into the next
    pinned host buffer while the next calls run (the caching allocator
    holds ``out``'s memory until the copy is done); on the CPU, a clone."""
    import torch

    if side is None:
        return out.clone()
    buf = state.host[len(state.kept)]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        buf.copy_(out.to(buf.dtype), non_blocking=True)
    out.record_stream(side)
    return buf


def release(state):
    state.replayer = None
    gc.collect()


def reference(arrays, ts, period):
    """The replay equation in float64 as complex exponentials:
    ``mean + sum_i modes_i Re(sum_k c_ik exp(2 pi i k t / T))``."""
    import torch

    t = torch.as_tensor(ts, dtype=torch.float64, device=arrays["k"].device)
    phase = torch.exp(1j * (2 * torch.pi / period) * t[:, None, None]
                      * arrays["k"][None])
    c = torch.complex(arrays["c_re"], arrays["c_im"])
    b = (c[None] * phase).sum(dim=-1).real
    return arrays["mean"][None] + b @ arrays["modes"]


def check(state, ctx, run):
    """``replay_err``: the kept outputs against the reference, over the
    largest reference value."""
    arrays = {k: v.to(ctx.device) if hasattr(v, "to") else v
              for k, v in state.arrays.items()}
    worst = 0.0
    for call, out in state.kept:
        ref = reference(arrays, _times(state, call), state.period)
        out = out.to(ref.device, ref.dtype)
        err = float((out - ref).abs().max() / ref.abs().max())
        worst = max(worst, err)
    state.kept = []
    state.host = None
    return {"replay_err": worst}
