"""Rank bodies of the port's sharded-path tests
(``tests/test_torch_sharding.py``, ``tests/test_torch_sharded_streaming.py``).

``parallel.mesh.launch_local`` runs one of the ``*_case`` functions below
in every rank of a mesh; rank 0's return value — a dict of plain numpy
values — comes back to the test.  This module imports torch, numpy and the
port only, so the spawned ranks never load jax; the tests import it too, for
the inputs both sides share (made from a seed with numpy).

One spawn per mesh shape: a case function computes every part its tests
read, in a fixed order on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from pods_digital_filter_tpu_torch import cli as tcli
from pods_digital_filter_tpu_torch import config as tconfig
from pods_digital_filter_tpu_torch.parallel import mesh as mesh_lib
from pods_digital_filter_tpu_torch.parallel import pod as dpod
from pods_digital_filter_tpu_torch.parallel import sharding
from pods_digital_filter_tpu_torch.parallel import streaming as sstream
from pods_digital_filter_tpu_torch.pipeline import resolve_profile, run_pipeline

#: tests/test_sharding.py's ARGS
GEN = dict(jma=6, kma=8, nfx=2, nfy=2, nfz=2, lnx=1.0, lny=1.0, lnz=1.0)
#: tests/test_sharding.py::test_sharded_halo_statistics's arguments
HALO = dict(jma=16, kma=32, nfx=3, nfy=3, nfz=3, lnx=1.5, lny=1.5, lnz=1.5)
#: the halo exchange held to the serial filter: nfz = 2 of 2-wide tiles at
#: s = 4, steps from t0 = 3
HALO_EXACT = dict(seed=5, t0=3, nsteps=8, **GEN)
F64 = torch.float64
#: seconds a spawned mesh may run before its test fails
DEADLINE_S = 240
#: local steps a chunk of the exchanged Gram: 3 does not divide the 8-step
#: tile of ``pod_fields`` over t = 2, 4 does, 8 is the whole tile
GRAM_CHUNKS = (3, 4, 8)
#: the chunk of the distributed POD held to JAX's: three exchanges, the last
#: of 2 steps
POD_CHUNK = 3
#: global windows of the chunked generation of a 6-step tile over t = 2:
#: parts of 2 steps (dividing it) and of 5 (not dividing it)
GENERATE_WINDOWS = (4, 10)
#: a tiny in-memory 2 x 2 model that the benchmark's plain reference
#: judges, as a configuration's ``sizes`` state it (float32, torch-ops
#: generator)
JUDGED = dict(jma=12, kma=8, nsteps=32, res=0.1, lengthscale=1.5,
              fwidth=2.0, U0=1.0, u_dash=0.02, normal=(1.0, 0.0, 0.0),
              mean_profile="hyperbolic-tangent", turb_profile="top-hat",
              num_modes=4, energy_target=0.9, dtype="float32", pallas=False)
JUDGED_SEED = 2 ** 40 + 17


def launch(case, shape, outdir, *args):
    """``case`` in the ranks of a ``shape = (t, s)`` mesh, one torch thread
    each; rank 0's result."""
    return mesh_lib.launch_local(case, shape[0] * shape[1],
                                 (shape[0], shape[1], outdir) + args,
                                 deadline_s=DEADLINE_S, threads=1)


def cfg(outdir, nsteps=16, jma=9, kma=8, ln=2.0, modes=5, et=0.9, **kw):
    """tests/test_sharded_streaming.py's ``_cfg`` in the port's config."""
    d = dict(
        plane=tconfig.PlaneConfig(jma=jma, kma=kma, res=0.1),
        filt=tconfig.FilterConfig(length_scale_x=ln, length_scale_y=ln,
                                  length_scale_z=ln, fwidth=2.0),
        podfs=tconfig.PODFSConfig(num_modes=modes, energy_target=et),
        nsteps=nsteps, outdir=str(outdir), dtype="float64")
    d.update(kw)
    return tconfig.PipelineConfig(**d)


def judged_config(outdir, shard_time=1, shard_space=1):
    """:data:`JUDGED` through the CLI's parser, as the benchmark runs a
    configuration."""
    s = JUDGED
    argv = ["-j", str(s["jma"]), "-k", str(s["kma"]), "-n", str(s["nsteps"]),
            "-r", str(s["res"]), "-l", str(s["lengthscale"]),
            "-f", str(s["fwidth"]), "--U0", str(s["U0"]),
            "--u_dash", str(s["u_dash"]), "-p", s["mean_profile"],
            "--turb_profile", s["turb_profile"], "-m", str(s["num_modes"]),
            "-e", str(s["energy_target"]), "--dtype", s["dtype"],
            "--shard_time", str(shard_time), "--shard_space",
            str(shard_space), "--outdir", str(outdir), "--seed",
            str(JUDGED_SEED), "--device", "cpu"]
    for flag, v in zip(("--nx", "--ny", "--nz"), s["normal"]):
        argv += [flag, str(v)]
    return tcli.config_from_args(tcli.build_parser().parse_args(argv))


def _bf16_gram(real):
    """``gram_fields`` on operands rounded to bfloat16: a Gram about as far
    off as TF32 products make it."""
    r = lambda x: x.to(torch.bfloat16).to(x.dtype)
    return lambda Xi, Xj: real(r(Xi), r(Xj))


def pod_fields(ns=16, jma=6, kma=8):
    """Snapshot fields ``(3, ns, jma, kma)`` with a decaying spectrum
    around a mean of 1 (well-separated eigenvalues), from a seed."""
    rng = np.random.default_rng(11)
    rows = 3 * jma * kma
    U = rng.standard_normal((rows, 10)) * np.exp(-0.4 * np.arange(10))
    A = 1.0 + U @ rng.standard_normal((10, ns)) * 0.05 \
        + 1e-3 * rng.standard_normal((rows, ns))
    return A.reshape(3, jma, kma, ns).transpose(0, 3, 1, 2).copy()


def gram_input():
    """tests/test_sharding.py::test_distributed_gram's (48, 16) matrix, as
    numpy."""
    return np.random.default_rng(12).standard_normal((48, 16))


def _raises(fn):
    """The message of the ValueError ``fn()`` raises, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _gather(obj):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _thread_collective(mesh):
    """A collective from a worker thread: the message it raises."""
    box = {}

    def run():
        try:
            mesh.all_reduce(torch.ones(2, dtype=F64), "s")
        except RuntimeError as e:
            box["error"] = str(e)

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=30)
    return box.get("error")


def sharding_case(shard_time, shard_space, outdir, parts):
    """tests/test_torch_sharding.py on one mesh."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(shard_time, shard_space, "cpu")
    out = {"shape": mesh.shape, "backend": mesh.backend}
    field = lambda x: mesh_lib.to_host(x, mesh, mesh_lib.FIELD)
    if "exact" in parts:
        out["exact"] = field(sharding.generate_sharded(
            9, mesh, 0, 8, **GEN, num_components=3, dtype=F64))
    if "halo_exact" in parts:
        out["halo_exact"] = field(sharding.generate_sharded_halo(
            mesh=mesh, num_components=3, dtype=F64, **HALO_EXACT))
    if "halo_stats" in parts:
        out["halo_stats"] = field(sharding.generate_sharded_halo(
            10, mesh, 0, 64, **HALO, num_components=1, dtype=F64))
    if "wide_tiles" in parts:
        out["wide_tiles"] = _raises(lambda: sharding.generate_sharded_halo(
            0, mesh, 0, 8, jma=8, kma=8, nfx=4, nfy=4, nfz=4, lnx=2.0,
            lny=2.0, lnz=2.0))
    if "errors" in parts:
        out["mesh_4x4"] = _raises(lambda: mesh_lib.make_mesh(4, 4, "cpu"))
        out["global_mesh"] = mesh_lib.global_mesh(2, device="cpu").shape
        out["global_mesh_3"] = _raises(lambda: mesh_lib.global_mesh(3))
        out["nsteps_7"] = _raises(lambda: sharding.generate_sharded(
            0, mesh, 0, 7, **GEN))
        out["kma_9"] = _raises(lambda: sharding.generate_sharded(
            0, mesh, 0, 8, **{**GEN, "kma": 9}))
        out["thread"] = _thread_collective(mesh)
    for part, kw in (("pod", {}), ("pod_chunked", dict(chunk=POD_CHUNK))):
        if part not in parts:
            continue
        X = mesh_lib.put_global(pod_fields(), mesh, mesh_lib.FIELD)
        res = dpod.distributed_pod(X, mesh, num_modes_trunc=6, **kw)
        out[part] = dict(
            energy=res.energy, num_valid=res.num_valid,
            num_trunc=res.num_trunc, modes=res.spatial_modes_packed(),
            mean=res.mean_packed(),
            ranks_same=len({t.tobytes() for t in _gather(
                res.temporal_modes)}) == 1)
    if "gram" in parts:
        A = mesh_lib.put_global(gram_input(), mesh, mesh_lib.SNAPSHOT)
        out["gram"] = sharding.distributed_gram(A, 16, mesh).numpy()
    if "chunked_gram" in parts:
        X = mesh_lib.put_global(pod_fields(), mesh, mesh_lib.FIELD)
        grams = {c: dpod.distributed_gram_fields(X, mesh, c).numpy()
                 for c in GRAM_CHUNKS}
        out["chunked_gram"] = dict(grams=grams, ranks_same=len(set(_gather(
            b"".join(g.tobytes() for g in grams.values())))) == 1)
    if "chunked_generation" in parts:
        diffs = {}
        for halo in (False, True):
            c = cfg(outdir, nsteps=12, jma=6, kma=8, dtype="float32",
                    halo_exchange=halo)
            fields, _, filt, c2, rotate = resolve_profile(c)
            whole = sstream.make_sharded_generator(
                c2, fields, filt, mesh, c2.nsteps, rotate=rotate)(0)
            for w in GENERATE_WINDOWS:
                part = sstream.generate_tile(c2, fields, filt, mesh,
                                             rotate=rotate, window=w)
                assert part.shape == whole.shape
                diffs[(halo, w)] = max(_gather(
                    float((part - whole).abs().max())))
        out["chunked_generation"] = diffs
    if "judged" in parts:
        res = {}
        for name in ("program", "bf16_gram"):
            real = dpod.gram_fields
            if name == "bf16_gram":
                dpod.gram_fields = _bf16_gram(real)
            try:
                r = run_pipeline(judged_config(
                    os.path.join(outdir, "judged_" + name), shard_time,
                    shard_space), device="cpu")
            finally:
                dpod.gram_fields = real
            k = r.pod.num_trunc
            res[name] = dict(dir=os.path.join(outdir, "judged_" + name),
                             ranks=_gather((
                                 r.pod.energy.tobytes(), r.pod.num_valid, k,
                                 r.pod.temporal_modes[:, :k].tobytes())))
        out["judged"] = res
    if "verbose" in parts:
        c = cfg(os.path.join(outdir, "verbose"), nsteps=8, jma=10, kma=8,
                modes=4, et=1.0, verbose=True, shard_time=shard_time,
                shard_space=shard_space)
        r = run_pipeline(c, device="cpu")
        out["verbose"] = dict(num_valid=r.pod.num_valid,
                              num_trunc=r.pod.num_trunc)
    if "spans" in parts:
        from torch.profiler import ProfilerActivity, profile

        from pods_digital_filter_tpu_torch.utils import timing

        c = cfg(os.path.join(outdir, "spans"), nsteps=8, jma=10, kma=8,
                modes=4, et=1.0, shard_time=shard_time,
                shard_space=shard_space)
        timing.reset_counts()
        with profile(activities=[ProfilerActivity.CPU]):
            r = run_pipeline(c, device="cpu")
        out["spans"] = dict(num_trunc=r.pod.num_trunc,
                            ranks=_gather(timing.counts()))
        timing.reset_counts()
    if "pipeline" in parts:
        c = cfg(os.path.join(outdir, "sharded"), nsteps=8, jma=10, kma=8,
                modes=4, et=1.0, shard_time=shard_time,
                shard_space=shard_space)
        r = run_pipeline(c, device="cpu")
        out["pipeline"] = dict(mean=r.mean_field, energy=r.pod.energy,
                               num_valid=r.pod.num_valid, A_none=r.A is None)
    return out


def _pod_out(sp):
    k = sp.pod.num_trunc
    return dict(mean=sp.mean_field, energy=sp.pod.energy,
                num_valid=sp.pod.num_valid, num_trunc=k,
                spatial=sp.pod.spatial_modes[:, :k],
                temporal=sp.pod.temporal_modes[:, :k], route=sp.route)


def injected_generator(F, block):
    """``make_sharded_generator`` stand-in: the rank's tile of the window
    ``[t0, t0 + block)`` of the numpy field ``F`` (zeros past its end),
    minus ``center``."""
    ns = F.shape[1]
    pad = -ns % block
    Fp = np.concatenate([F, np.zeros(F.shape[:1] + (pad,) + F.shape[2:])],
                        axis=1)

    def make(cfg, fields, filt, mesh, block_, rotate=True, halo=None,
             center=None):
        def gen(t0):
            X = mesh_lib.put_global(Fp[:, t0:t0 + block_], mesh,
                                    mesh_lib.FIELD, F64)
            return X if center is None else X - center[:, None]
        return gen
    return make


def injected_field(ns=20, jma=9, kma=8):
    """The field both packages' sharded streaming POD take
    (``pod_fields``'s construction at the streaming tests' plane)."""
    return pod_fields(ns, jma, kma)


def _counting(calls):
    real = sstream.make_sharded_generator

    def make(*a, **kw):
        gen = real(*a, **kw)
        return lambda t0: calls.append(t0) or gen(t0)
    return make


def streaming_case(shard_time, shard_space, outdir, parts, block, ck=None):
    """tests/test_torch_sharded_streaming.py on one mesh (``ck``: the Gram
    store the ``resume`` part fills or resumes)."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(shard_time, shard_space, "cpu")
    out = {}
    sharded = dict(shard_time=shard_time, shard_space=shard_space)

    def sp(c, **kw):
        fields, _, filt, c2, rotate = resolve_profile(c)
        return sstream.streaming_pod_sharded(c2, fields, filt, mesh,
                                             rotate=rotate, **kw)

    if "parity" in parts:
        out["parity"] = _pod_out(sp(cfg(outdir), block=block))
    if "injected" in parts:
        F = injected_field()
        real = sstream.make_sharded_generator
        sstream.make_sharded_generator = injected_generator(F, 8)
        try:
            res = sp(cfg(outdir, nsteps=F.shape[1]), block=8)
            res.resolve()
        finally:
            sstream.make_sharded_generator = real
        out["injected"] = _pod_out(res)
    if "e2e" in parts:
        r = run_pipeline(cfg(os.path.join(outdir, "ss"), hdf5=True,
                             streaming_block=8, **sharded), device="cpu")
        out["e2e"] = dict(mean=r.mean_field, A_none=r.A is None)
    if "topk_e2e" in parts:
        r = run_pipeline(cfg(os.path.join(outdir, "sst"), streaming_block=8,
                             eig_mode="topk", **sharded), device="cpu")
        out["topk_e2e"] = dict(num_valid=r.pod.num_valid,
                               pending=r.finalize_pending, A_none=r.A is None)
    if "topk_defer" in parts:
        c = cfg(outdir, nsteps=16, eig_mode="topk")
        full = sp(dataclasses.replace(c, eig_mode="full"), block=4)
        ss = sp(c, block=4, defer_spectrum=True)
        out["topk_defer"] = dict(full=_pod_out(full), shrank=ss.resolve(),
                                 topk=_pod_out(ss))
    if "halo_stats" in parts:
        kw = dict(nsteps=256, jma=8, kma=32, ln=1.5, modes=3)
        r = {h: run_pipeline(cfg(os.path.join(outdir, h), halo_exchange=h ==
                                 "halo", **kw, **sharded),
                             device="cpu", write_outputs=False)
             for h in ("exact", "halo")}
        out["halo_stats"] = {h: dict(mean=x.mean_field, energy=x.pod.energy,
                                     num_valid=x.pod.num_valid)
                             for h, x in r.items()}
    if "halo_streaming" in parts:
        c = cfg(os.path.join(outdir, "hs"), nsteps=8, jma=8, kma=32, ln=1.0,
                streaming_block=4, halo_exchange=True, **sharded)
        out["halo_streaming"] = run_pipeline(c, device="cpu").pod.num_trunc
    if "resume" in parts:
        # fills the store on the first mesh, resumes it on the next
        calls = []
        real = sstream.make_sharded_generator
        sstream.make_sharded_generator = _counting(calls)
        try:
            res = sp(cfg(outdir, nsteps=8, checkpoint_dir=ck), block=4)
        finally:
            sstream.make_sharded_generator = real
        out["resume"] = dict(_pod_out(res), calls=list(calls))
    if "identical" in parts:
        # float32 top-k: the scalar Lanczos vectors and the deferred
        # spectrum, resolved by finalize() on every rank
        c = cfg(os.path.join(outdir, "same"), nsteps=16, dtype="float32",
                streaming_block=8, eig_mode="topk", **sharded)
        r = run_pipeline(c, device="cpu", defer_finalize=True)
        pending = r.finalize_pending
        r.finalize()
        ranks = _gather((r.pod.energy.tobytes(), r.pod.num_valid,
                         r.pod.num_trunc, r.pod.temporal_modes.tobytes(),
                         r.pod.spatial_modes.tobytes(),
                         r.mean_field.tobytes(), r.eig_route))
        out["identical"] = dict(pending=pending, ranks=ranks,
                                num_valid=r.pod.num_valid)
    if "thread" in parts:
        out["thread"] = _thread_collective(mesh)
    return out


def failing_case(failing_rank):
    """Rank ``failing_rank`` raises; the others wait in a collective with
    it (the job must end, not hang)."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(1, dist.get_world_size(), "cpu")
    if mesh.rank == failing_rank:
        raise RuntimeError(f"rank {failing_rank} fails on purpose")
    mesh.all_reduce(torch.ones(2, dtype=F64), "s")
