"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a host with a CUDA card, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA.  JAX is not needed and not imported.

Phases, one result line each; any failed check raises (exit code != 0):

1. the card (``nvidia-smi`` name and power limit) and the software versions;
2. build the kernels K1-K4 (csrc/*.cu, one nvcc per source, in parallel)
   from the checkout's sources;
3. K1 against its plain PyTorch version on the card, at the shapes the main
   path gives it: the raw Philox stream bit for bit, the filtered slabs
   (atol 1e-5), the noise-in mode, window independence, stream statistics,
   and both times at 512 x 512 x 1,040 slabs x 3 components;
4. the main path through the user's entry points, the CLI equivalent of
   ``-j 512 -k 512 -n 1024 -l 4 -f 2 -m 20 -e 0.9 --pallas --device cuda``:
   K1's launch count, the model files, the mean profile, a replay of the
   written model against the in-memory result, the target Reynolds
   stresses, stage times and peak device memory;
5. the same run without ``--pallas`` (the torch-ops generator);
6. the decomposition kernels against their plain versions, with both
   times, at the experiments' shape (512 x 512, nf 8, 80 slabs x 3) and, for
   K1's bf16 taps, K2 and K4, at the main path's (1,040 slabs x 3): K1's
   bf16 taps, iota, dummy-in and slab-pipelined modes at atol 1e-5 as its
   f32 modes (the same summation order as the plain version, and bf16 x
   bf16 products are exact in f32), the last also bit for bit against K1,
   with K1's f32 taps shown to miss that limit; the raw bf16 field and K3's
   probes bit for bit; K2 with f32 taps at 1e-5; K2 with bf16 taps and the
   split K1 raw -> K2 against K1 within ``bf16_tap_bound`` with at most 1 %
   of elements off by more than 1e-5 (they sum in another order), K2's f32
   taps shown to miss that share; K4 against K1 and the plain FIR (1e-5);
7. the main path of phase 4 with ``--dtype bfloat16``: K1 launched, its
   output made with bf16 taps (snapshots regenerated on the host by the
   port's generator with bf16 taps agree with the run's in all but 1 % of
   elements, with f32 taps they do not), replay and stresses as in phase 4;
8. the decomposition path: both experiment entry points
   (``experiments.two_kernel_pipeline`` with every variant, then with
   ``EXP_TEMPORAL=1``; ``experiments.pipelined_kernel``) at their own
   sizes, with the launch count of each kernel.

The last two lines are the kernel record and the result as JSON.
"""

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_ARGS = ["-j", "512", "-k", "512", "-n", "1024", "-l", "4", "-f", "2",
             "-m", "20", "-e", "0.9"]
U0 = 1.0


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, sync):
    """Wall time of one call of ``fn`` on the card, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    sync()
    return start.elapsed_time(end), out


def phase_card():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"phase 1 card: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")


def phase_build():
    from pods_digital_filter_tpu_torch.ops import _build

    stale = _build.library_path()
    if stale.exists():              # build from the sources, every run
        stale.unlink()
    t = time.perf_counter()
    _, info = _build.load()
    print(f"phase 2 build: K1-K4 built by nvcc (one process per source, in "
          f"parallel) in {info.seconds:.2f} s (load "
          f"{time.perf_counter() - t:.2f} s)")
    name = ""
    for line in info.log.splitlines():        # one line per kernel: ptxas -v
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:      # the mangled name after its file's namespace hash
            name = re.sub(r"^.*_cu_[0-9a-f]{8}", "", m.group(1))
        elif "registers" in line:
            print(f"    {name}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" \
                not in line:
            print(f"    {name}: {line.strip()}")


def phase_kernel(dev):
    import torch

    from pods_digital_filter_tpu_torch.ops import filters, fused_filter, philox

    sync = torch.cuda.synchronize
    seed = (3 << 32) | 12345

    for (c, s, jn, kn) in ((2, 5, 528, 528), (3, 4, 67, 133)):
        k = fused_filter.raw_noise(seed, 7, s, jn, kn, c, dev)
        p = philox.raw_noise(seed, 7, s, jn, kn, c, dev)
        sync()
        check(torch.equal(k, p), f"raw Philox stream {(c, s, jn, kn)}")
    print("phase 3a raw noise: K1 == plain Philox bit for bit "
          "(2x5x528x528, 3x4x67x133)")

    worst = 0.0
    for (jma, kma, nf, slabs) in ((512, 512, 8, 8), (200, 24, 2, 6),
                                  (1024, 1024, 8, 3)):
        by = filters.gaussian_fir_coeffs(nf, nf / 2.0, torch.float32, dev)
        k = fused_filter.fused_spatial(seed, 11, slabs, jma, kma, by, by, 3)
        p = fused_filter.fused_spatial_plain(seed, 11, slabs, jma, kma, by,
                                             by, 3)
        noise = philox.raw_noise(seed, 11, slabs, jma + 2 * nf, kma + 2 * nf,
                                 3, dev)
        kn_ = fused_filter.fused_spatial(seed, 11, slabs, jma, kma, by, by, 3,
                                         noise=noise)
        pn = filters.filter_spatial(noise, by, by, jma, kma)
        sync()
        err = float((k - p).abs().max())
        err_in = float((kn_ - pn).abs().max())
        print(f"phase 3b filtered {jma}x{kma} nf={nf}: max |K1 - plain| = "
              f"{err:.3e}; noise-in max |K1 - filter_spatial| = {err_in:.3e}")
        check(err <= 1e-5 and err_in <= 1e-5, f"filtered {jma}x{kma} nf={nf}")
        worst = max(worst, err, err_in)

    gen = lambda t0, n: fused_filter.generate_correlated_noise_fused(
        7, t0, n, 512, 512, 8, 8, 8, 4.0, 4.0, 4.0, device=dev)
    err = float((gen(8, 8) - gen(0, 16)[:, 8:]).abs().max())
    print(f"phase 3c window [8,16) vs slice of [0,16): max diff {err:.3e}")
    check(err <= 1e-6, "window consistency")

    x = fused_filter.raw_noise(7, 0, 30, 528, 528, 1, dev)[0].double()
    n, a = x.numel(), 3.0 ** 0.5
    var = float(x.var(unbiased=False))
    stats = {
        "n": n, "mean": float(x.mean()), "var": var,
        "m4": float((x ** 4).mean()),
        "rho_k": float((x[:, :, :-1] * x[:, :, 1:]).mean()) / var,
        "rho_j": float((x[:, :-1, :] * x[:, 1:, :]).mean()) / var,
        "rho_slab": float((x[:-1] * x[1:]).mean()) / var,
        "min": float(x.min()), "max": float(x.max()),
    }
    print("phase 3d stream statistics " + json.dumps(stats))
    check(abs(stats["mean"]) < 5.0 / n ** 0.5, "mean")
    check(abs(stats["var"] - 1.0) < 0.01, "variance")
    check(abs(stats["m4"] - 9.0 / 5.0) < 0.02, "fourth moment")
    for key in ("rho_k", "rho_j", "rho_slab"):
        check(abs(stats[key]) < 5.0 / n ** 0.5, key)
    check(stats["min"] < -a * 0.999 and stats["max"] > a * 0.999, "range")
    check(stats["min"] >= -a - 1e-5 and stats["max"] <= a + 1e-5, "bounds")
    del x

    by = filters.gaussian_fir_coeffs(8, 4.0, torch.float32, dev)
    kernel = lambda: fused_filter.fused_spatial(0, 0, 1040, 512, 512, by, by, 3)
    plain = lambda: fused_filter.fused_spatial_plain(0, 0, 1040, 512, 512, by,
                                                     by, 3)
    kernel(), plain()                               # warm up
    sync()
    times = {"plain": [], "kernel": []}
    last = {}
    for name in ("plain", "kernel", "kernel", "plain"):
        last.pop(name, None)
        ms, last[name] = cuda_ms(kernel if name == "kernel" else plain, sync)
        times[name].append(ms)
    err = float((last.pop("kernel") - last.pop("plain")).abs().max())
    ms = sum(times["kernel"]) / 2
    plain_ms = sum(times["plain"]) / 2
    print(f"phase 3e the main path's shape, 512x512 nf=8 x 1040 slabs x 3 "
          f"components from t0=0: max |K1 - plain| = {err:.3e}; time K1 "
          f"{times['kernel']} ms, plain {times['plain']} ms")
    check(err <= 1e-5, "filtered at the main path's shape")
    worst = max(worst, err)
    return worst, ms, plain_ms


def _read_model(outdir):
    from pods_digital_filter_tpu_torch.io.prf import read_field_prf, read_podfs_dat

    import numpy as np

    period, fc = read_podfs_dat(os.path.join(outdir, "PODFS.dat"))
    _, mean = read_field_prf(os.path.join(outdir, "PODFS_mean.prf"))
    modes = [read_field_prf(os.path.join(outdir, "PODFS_mode_%04d.prf"
                                         % (i + 1)))[1] for i in range(len(fc))]
    pack = lambda u: u.reshape(-1, order="F")
    return period, fc, pack(mean), np.stack([pack(m) for m in modes], axis=1)


def check_replay(res):
    """Replay 300 points of the written model at every step and hold it
    against the in-memory result: mean + spatial modes x the kept Fourier
    series (with et < 1 the model is the Fourier-truncated POD)."""
    import numpy as np

    period, fc, mean, modes = _read_model(res.config.outdir)
    npts = res.config.plane.num_points
    pts = np.random.default_rng(0).choice(npts, 300, replace=False)
    rows = np.concatenate([pts + c * npts for c in range(3)])
    ns = res.config.nsteps
    t = np.arange(ns) * res.dt
    a = np.stack([np.real(sum((re + 1j * im) * np.exp(2j * np.pi * k * t / period)
                              for k, re, im in tab)) for tab in fc], axis=1)
    replayed = mean[rows, None] + modes[rows] @ a.T
    model = (res.mean_field[rows, None]
             + res.pod.spatial_modes[rows] @ res.fourier.reconstruction.T)
    pod_rec = (res.mean_field[rows, None] + res.pod.spatial_modes[rows]
               @ res.pod.temporal_modes[:, :res.pod.num_trunc].T)
    err = float(np.abs(replayed - model).max())
    dev_pod = float(np.abs(replayed - pod_rec).max())
    print(f"    replay of 300 points x {ns} steps: max |replay - model| = "
          f"{err:.3e}; max |replay - truncated POD| = {dev_pod:.3e} "
          f"(Fourier truncation at et={res.config.podfs.energy_target})")
    check(err < 1e-6, "replay of the written model")


def check_stresses(res, fields):
    """Target mean profile and Reynolds stresses within the statistical
    bounds of tests/test_pipeline.py (normal (1,0,0): no rotation)."""
    import numpy as np

    jma, kma = res.config.plane.jma, res.config.plane.kma
    npts = jma * kma
    U_target = np.broadcast_to(np.asarray(fields.mean_u), (jma, kma))[0]
    uu_target = np.broadcast_to(np.asarray(fields.uu), (jma, kma))[0]
    U_mean = res.mean_field[:npts].reshape(jma, kma).mean(axis=0)
    core = slice(kma // 2 - 3, kma // 2 + 4)
    u = res.A[:npts].reshape(jma, kma, -1)[:, core].astype(np.float64)
    w = res.A[2 * npts:].reshape(jma, kma, -1)[:, core].astype(np.float64)
    uu_meas, uu_tgt = float((u * u).mean()), float(np.mean(uu_target[core]))
    uw = (u * w).mean(axis=2)
    err_U = float(np.abs(U_mean - U_target).max())
    print(f"    stresses: max |U - U_target| = {err_U:.4f}; core uu "
          f"{uu_meas:.4e} vs target {uu_tgt:.4e}; uw field mean "
          f"{float(uw.mean()):.3e}, max |uw| {float(np.abs(uw).max()):.3e}")
    check(err_U < 0.08, "mean profile")
    check(abs(uu_meas - uu_tgt) < 0.25 * uu_tgt, "core uu")
    check(abs(float(uw.mean())) < 0.05 * uu_tgt, "uw field mean")
    check(float(np.abs(uw).max()) < 0.5 * uu_tgt, "max |uw|")


def check_bf16_taps(res, t0=500, nsteps=2):
    """The bf16 main path's snapshots were made with bf16 taps: the port's
    generator on the host (K1's plain version) regenerates ``nsteps`` of
    them, centred by the run's own mean.  With bf16 taps at most 1 % of the
    elements may differ from the run's (a float32 sum taken in another
    order, as in the temporal FIR, can round to the neighbouring bf16
    value); with float32 taps more than 1 % must, or the check could not
    tell the two apart (about a third of them do)."""
    import numpy as np
    import torch

    from pods_digital_filter_tpu_torch.pipeline import (make_generator,
                                                        resolve_profile)

    fields, _, filt, cfg, rotate = resolve_profile(res.config)
    gen = make_generator(cfg, fields, filt, nsteps=nsteps, rotate=rotate,
                         device="cpu")
    mean = torch.as_tensor(res.mean_field).to(torch.bfloat16)[:, None]
    got = res.A[:, t0:t0 + nsteps]
    share = {}
    for md in (torch.bfloat16, torch.float32):
        gen.matmul_dtype = md
        ref = (gen(t0) - mean).float().numpy()
        share[md] = float(np.mean(ref != got))
    print(f"    steps {t0}..{t0 + nsteps - 1} regenerated on the host: "
          f"{share[torch.bfloat16]:.3e} of the elements differ with bf16 taps "
          f"(limit 1e-2), {share[torch.float32]:.3e} with f32 taps")
    check(share[torch.bfloat16] <= SHARE_LIMIT, "the run used bf16 taps")
    check(share[torch.float32] > SHARE_LIMIT, "f32 taps would be told apart")


def phase_main(label, extra, outdir, extra_check=None):
    import torch

    from pods_digital_filter_tpu_torch import cli
    from pods_digital_filter_tpu_torch.ops import fused_filter
    from pods_digital_filter_tpu_torch.pipeline import resolve_profile, run_pipeline

    args = cli.build_parser().parse_args(
        MAIN_ARGS + extra + ["--outdir", outdir, "--device", "cuda"])
    cfg = cli.config_from_args(args)
    check(cfg.filt.nfx == cfg.filt.nfy == cfg.filt.nfz == 8, "nf = 8")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_filter.LAUNCHES = 0
    t = time.perf_counter()
    res = run_pipeline(cfg, device=args.device)
    wall = time.perf_counter() - t
    launches = fused_filter.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    stages = {k: round(v, 4) for k, v in res.timer.times.items()}
    print(f"phase {label}: run_pipeline {wall:.3f} s, K1 launches {launches}, "
          f"peak device memory "
          f"{peak / 2 ** 30:.3f} GiB, stages (s) " + json.dumps(stages))
    files = ["PODFS.dat", "PODFS_mean.prf", "POD.eigenvalues.dat",
             "POD.spatial_mean_field_velocity.vtk"] + [
        "PODFS_mode_%04d.prf" % (i + 1) for i in range(20)]
    check(all(os.path.isfile(os.path.join(outdir, f)) for f in files),
          "model files written")
    check(res.pod.num_trunc == 20, f"num_trunc {res.pod.num_trunc} == 20")
    with open(os.path.join(outdir, "PODFS_mean.prf")) as f:
        first = f.readlines()[11].split(",")
    u0 = float(first[3])
    print(f"    first-row mean u = {u0:.6f} (0.5 * U0 = {0.5 * U0})")
    check(abs(u0 - 0.5 * U0) < 0.02, "first-row mean u ~ 0.5 U0")
    check_replay(res)
    fields = resolve_profile(cfg)[0]
    check_stresses(res, fields)
    if extra_check is not None:
        extra_check(res)
    return launches


EXP = dict(nf=8, jma=512, kma=512, slabs=80)       # the experiments' shape
MAIN = dict(nf=8, jma=512, kma=512, slabs=1040)     # the main path's shape
#: bf16-tap results summed in another order: the share of elements that may
#: differ by more than 1e-5 (tests/test_torch_pipeline.py's rule)
SHARE_LIMIT = 0.01


def turns(kernel, plain):
    """Kernel and plain version timed in turns (plain, kernel, kernel,
    plain) by CUDA events after a warm-up of each: ``(kernel ms, plain ms,
    kernel output, plain output)``, the times the mean of two."""
    import torch

    sync = torch.cuda.synchronize
    kernel(), plain()
    sync()
    times = {"plain": [], "kernel": []}
    last = {}
    for name in ("plain", "kernel", "kernel", "plain"):
        last.pop(name, None)
        ms, last[name] = cuda_ms(kernel if name == "kernel" else plain, sync)
        times[name].append(ms)
    return (sum(times["kernel"]) / 2, sum(times["plain"]) / 2,
            last["kernel"], last["plain"])


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def off_share(a, b):
    """The share of elements where ``a`` and ``b`` differ by more than 1e-5."""
    return float(((a.float() - b.float()).abs() > 1e-5).float().mean())


def phase_decomposition(dev):
    """Phase 6: every decomposition kernel and mode against its plain
    version, with both times; returns ``{name: (max_abs_err, ms,
    plain_ms)}`` for the kernel record and prints one table line."""
    import torch

    from pods_digital_filter_tpu_torch.ops import (filters, fused_filter as ff,
                                                   fused_temporal as ft,
                                                   noise_probe as npr, philox,
                                                   toeplitz_gemm as tg)

    bf16, f32 = torch.bfloat16, torch.float32
    table, record = {}, {}
    seed = (5 << 32) | 4242

    def row(name, err, ms, plain_ms, bound, what):
        table[name] = {"max_abs_err": err, "bound": bound, "ms": ms,
                       "plain_ms": plain_ms}
        print(f"phase 6 {name}: max |kernel - plain| = {err:.3e} "
              f"(bound {bound:.3e}{', ' + what if what else ''}); kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(err <= bound, f"{name} within {bound}")
        torch.cuda.empty_cache()

    def check_share(name, k, p):
        share = off_share(k, p)
        print(f"phase 6 {name}: {share:.3e} of the elements off by more than "
              f"1e-5 (limit {SHARE_LIMIT})")
        check(share <= SHARE_LIMIT, f"{name}: share of elements off")

    def taps(shape):
        b = filters.gaussian_fir_coeffs(shape["nf"], 4.0, f32, dev)
        jn, kn = shape["jma"] + 2 * shape["nf"], shape["kma"] + 2 * shape["nf"]
        return b, jn, kn

    # K1 with bf16 taps at the main path's shape (rows 1-2 with the
    # original's matmul_dtype=bfloat16)
    b, jn, kn = taps(MAIN)
    a = (seed, 0, MAIN["slabs"], MAIN["jma"], MAIN["kma"], b, b, 3)
    bound = ff.bf16_tap_bound(b, b)
    ms, pms, k, p = turns(lambda: ff.fused_spatial(*a, matmul_dtype=bf16),
                          lambda: ff.fused_spatial_plain(*a, matmul_dtype=bf16))
    row("K1 bf16 taps, 1040 x 3", max_err(k, p), ms, pms, 1e-5,
        "as f32 taps: the plain version's summation order")
    k1_bf16_main_ms = ms
    del k
    # a K1 that ignored its bf16 flag would miss that limit
    k = ff.fused_spatial(*a)
    err, share = max_err(k, p), off_share(k, p)
    print(f"phase 6 K1 f32 taps vs the bf16-tap plain version: max diff "
          f"{err:.3e}, {share:.3f} of the elements off by more than 1e-5")
    check(err > 1e-5 and share > SHARE_LIMIT, "bf16 taps change K1's output")
    del k, p

    b, jn, kn = taps(EXP)
    S = EXP["slabs"]
    a = (seed, 0, S, EXP["jma"], EXP["kma"], b, b, 3)
    # K1 raw mode, bf16 out (kernel A of split_bf16): bit for bit
    ms, pms, k, p = turns(
        lambda: ff.raw_noise(seed, 0, S, jn, kn, 3, dev, bf16),
        lambda: philox.raw_noise(seed, 0, S, jn, kn, 3, dev).to(bf16))
    row("K1 raw bf16", max_err(k, p), ms, pms, 0.0, "bit for bit")
    check(torch.equal(k, p), "K1 raw bf16 bit for bit")
    del k, p
    # slab-pipelined against K1 itself: bit for bit, both tap dtypes
    for md, name in ((f32, "f32"), (bf16, "bf16")):
        ms, pms, k, p = turns(
            lambda: ff.fused_spatial_pipelined(*a, matmul_dtype=md),
            lambda: ff.fused_spatial_plain(*a, matmul_dtype=md))
        base = ff.fused_spatial(*a, matmul_dtype=md)
        check(torch.equal(k, base), f"pipelined == K1 bit for bit ({name})")
        row(f"K1 pipelined {name}", max_err(k, p), ms, pms, 1e-5,
            "== K1 bit for bit")
        del k, p, base
    # iota source and dummy input, bf16 taps as in the experiment
    ms, pms, k, p = turns(
        lambda: ff.fused_spatial_iota(S, EXP["jma"], EXP["kma"], b, b, 3, bf16),
        lambda: ff.fused_spatial_iota_plain(S, EXP["jma"], EXP["kma"], b, b,
                                            3, bf16))
    row("K1 iota bf16", max_err(k, p), ms, pms, 1e-5, "")
    dummy = torch.randn((3 * S, 8, 128), device=dev)
    ms, pms, k, p = turns(
        lambda: ff.fused_spatial_dummy_in(*a[:-1], dummy, 3, bf16),
        lambda: ff.fused_spatial_dummy_in_plain(*a[:-1], dummy, 3, bf16))
    row("K1 dummy-in bf16", max_err(k, p), ms, pms, 1e-5, "")
    del k, p, dummy

    # K3: every probe bit for bit (bf16 as in the experiment; storeonly f32)
    for body, dt in [(nb, bf16) for nb in npr.BODIES] + [("storeonly", f32)]:
        pa = (body, seed, 0, S, jn, kn, 3, dt, dev)
        ms, pms, k, p = turns(lambda: npr.probe(*pa),
                              lambda: npr.probe_plain(*pa))
        check(torch.equal(k, p), f"K3 {body} bit for bit")
        row(f"K3 {body} {'bf16' if dt == bf16 else 'f32'}", max_err(k, p),
            ms, pms, 0.0, "bit for bit")
        if body == "noise" and dt == bf16:
            record["K3"] = (max_err(k, p), ms, pms)
    ms, pms, k, p = turns(
        lambda: npr.store2d(S, EXP["jma"], EXP["kma"], 3, dev),
        lambda: npr.store2d_plain(S, EXP["jma"], EXP["kma"], 3, dev))
    check(torch.equal(k, p), "K3 store2d bit for bit")
    row("K3 store2d", max_err(k, p), ms, pms, 0.0, "bit for bit")
    del k, p

    # K2 at the experiments' shape: on K1's raw noise (split) and alone
    ByM = {md: filters.toeplitz_band(b, EXP["jma"]).to(md) for md in (f32, bf16)}
    BzT = {md: filters.toeplitz_band(b, EXP["kma"]).T.contiguous().to(md)
           for md in (f32, bf16)}
    noise = ff.raw_noise(seed, 0, S, jn, kn, 3, dev).view(3 * S, jn, kn)
    for md, name in ((f32, "f32"), (bf16, "bf16")):
        ms, pms, k, p = turns(lambda: tg.toeplitz_gemm(noise, BzT[md], ByM[md]),
                              lambda: tg.toeplitz_gemm_plain(noise, BzT[md],
                                                             ByM[md]))
        row(f"K2 {name} taps, 80 x 3", max_err(k, p), ms, pms,
            1e-5 if md == f32 else bound, "")
        if md == bf16:
            check_share("K2 bf16 taps, 80 x 3", k, p)
        del k, p
    split = tg.toeplitz_gemm(noise, BzT[bf16], ByM[bf16]).view(3, S, EXP["jma"],
                                                               EXP["kma"])
    split16 = tg.toeplitz_gemm(noise.to(bf16), BzT[bf16], ByM[bf16])
    base = ff.fused_spatial(*a, matmul_dtype=bf16)
    err = max_err(split, base)
    print(f"phase 6 split_f32 (K1 raw -> K2, bf16 taps) vs K1 bf16 taps: max "
          f"diff {err:.3e} (bound {bound:.3e}); split_bf16 == split_f32: "
          f"{torch.equal(split16.view_as(split), split)}")
    check(err <= bound, "split_f32 vs K1 within the bf16-tap bound")
    check_share("split_f32 vs K1 bf16 taps", split, base)
    check(torch.equal(split16.view_as(split), split), "split_bf16 == split_f32")
    del noise, split, split16, base
    torch.cuda.empty_cache()

    # K2 at the main path's shape, against its plain version and K1
    b, jn, kn = taps(MAIN)
    noise = ff.raw_noise(seed, 0, MAIN["slabs"], jn, kn, 3, dev).view(-1, jn, kn)
    for md, name in ((f32, "f32"), (bf16, "bf16")):
        By = filters.toeplitz_band(b, MAIN["jma"]).to(md)
        Bz = filters.toeplitz_band(b, MAIN["kma"]).T.contiguous().to(md)
        ms, pms, k, p = turns(lambda: tg.toeplitz_gemm(noise, Bz, By),
                              lambda: tg.toeplitz_gemm_plain(noise, Bz, By))
        err = max_err(k, p)
        row(f"K2 {name} taps, 1040 x 3", err, ms, pms,
            1e-5 if md == f32 else bound,
            f"K1 bf16 taps {k1_bf16_main_ms:.3f} ms" if md == bf16 else "")
        if md == f32:
            k2_f32 = k
            del p
            continue
        record["K2"] = (err, ms, pms)
        check_share("K2 bf16 taps, 1040 x 3", k, p)
        # a K2 that ignored its bf16 taps would miss that share
        share = off_share(k2_f32, p)
        print(f"phase 6 K2 f32 taps vs the bf16-tap plain version: {share:.3f} "
              f"of the elements off by more than 1e-5")
        check(share > SHARE_LIMIT, "bf16 taps change K2's output")
        del k, p, k2_f32
    del noise
    torch.cuda.empty_cache()

    # K4 against K1 and the plain FIR, at both shapes (f32 taps), and bf16
    # taps at the experiments' shape
    for shape, md, name in ((EXP, f32, "f32, 64 steps"),
                            (EXP, bf16, "bf16, 64 steps"),
                            (MAIN, f32, "f32, 1024 steps")):
        b, jn, kn = taps(shape)
        n = shape["slabs"] - 2 * shape["nf"]
        ka = (seed, 0, n, shape["jma"], shape["kma"], b, b, b, 3)
        ms, pms, k, p = turns(lambda: ft.fused_temporal(*ka, matmul_dtype=md),
                              lambda: ft.fused_temporal_plain(*ka,
                                                              matmul_dtype=md))
        z = ff.fused_spatial(seed, 0, shape["slabs"], shape["jma"],
                             shape["kma"], b, b, 3, matmul_dtype=md)
        err = max_err(k, filters.filter_temporal(z, b, axis=-3))
        del z
        row(f"K4 {name}", max(err, max_err(k, p)), ms, pms, 1e-5,
            f"vs K1 + plain FIR {err:.3e}")
        if shape is MAIN:
            record["K4"] = (max(err, max_err(k, p)), ms, pms)
        elif md == f32:
            # noise-in mode on K1's raw field: the Philox mode's input, so
            # the same output bit for bit
            noise = ff.raw_noise(seed, 0, shape["slabs"], jn, kn, 3, dev)
            kin = ft.fused_temporal(*ka, noise=noise)
            err = max_err(kin, ft.fused_temporal_plain(*ka, noise=noise))
            print(f"phase 6 K4 noise-in on K1's raw field: == Philox mode "
                  f"{torch.equal(kin, k)}; max |kernel - plain| = {err:.3e}")
            check(torch.equal(kin, k) and err <= 1e-5, "K4 noise-in mode")
            del noise, kin
        del k, p
        torch.cuda.empty_cache()

    # ragged shapes (partial tiles, strips and word groups), general dense
    # matrices for K2: K1 and K4 at 1e-5, K2 within its bound
    g = torch.Generator(device=dev).manual_seed(3)
    for (jma, kma, nf, S) in ((70, 130, 3, 5), (37, 200, 2, 4)):
        b = filters.gaussian_fir_coeffs(nf, nf / 2.0, f32, dev)
        jn, kn = jma + 2 * nf, kma + 2 * nf
        errs = {}
        for md, name in ((f32, "f32"), (bf16, "bf16")):
            a = (seed, 3, S, jma, kma, b, b, 3)
            k1 = ff.fused_spatial(*a, matmul_dtype=md)
            errs[f"K1 {name}"] = (max_err(k1, ff.fused_spatial_plain(
                *a, matmul_dtype=md)), 1e-5)
            check(torch.equal(ff.fused_spatial_pipelined(*a, matmul_dtype=md),
                              k1), "pipelined == K1 on a ragged shape")
            ka = (seed, 3, S, jma, kma, b, b, b, 3)
            errs[f"K4 {name}"] = (max_err(ft.fused_temporal(*ka, matmul_dtype=md),
                                        ft.fused_temporal_plain(
                                            *ka, matmul_dtype=md)), 1e-5)
            noise = torch.rand((2, jn, kn), generator=g, device=dev) * 3.4 - 1.7
            Dz = torch.randn((kn, kma), generator=g, device=dev).to(md)
            Dy = torch.randn((jma, jn), generator=g, device=dev).to(md)
            p2 = tg.toeplitz_gemm_plain(noise, Dz, Dy)
            t = noise.to(md).float() @ Dz.float()
            ulp = 2.0 ** (math.floor(math.log2(float(t.abs().max()))) - 7)
            rows = float(Dy.float().abs().sum(1).max())
            errs[f"K2 dense {name}"] = (
                max_err(tg.toeplitz_gemm(noise, Dz, Dy), p2),
                1e-5 * (1 + float(t.abs().max()) * rows)
                + (ulp * rows if md == bf16 else 0.0))
        print(f"phase 6 ragged {jma}x{kma} nf={nf}: "
              + ", ".join(f"{k} {e:.2e} (bound {b_:.2e})"
                          for k, (e, b_) in errs.items()))
        for k, (e, b_) in errs.items():
            check(e <= b_, f"{k} on a ragged shape")
    for body in npr.BODIES:      # kn / 2 = 67: a partial group of words
        pa = (body, seed, 1, 4, 66, 134, 3, bf16, dev)
        check(torch.equal(npr.probe(*pa), npr.probe_plain(*pa)),
              f"K3 {body} on a ragged shape")
    print("phase 6 ragged K3 (66 x 134, every probe): bit for bit")

    print("phase 6 table " + json.dumps(table))
    return record


def phase_experiments():
    """Phase 8: the decomposition path through its entry points, every
    variant, at the originals' sizes; returns each kernel's launch count."""
    from pods_digital_filter_tpu_torch.experiments import (pipelined_kernel,
                                                          two_kernel_pipeline)
    from pods_digital_filter_tpu_torch.ops import (fused_filter,
                                                   fused_temporal,
                                                   noise_probe, toeplitz_gemm)

    mods = {"K1": fused_filter, "K2": toeplitz_gemm, "K3": noise_probe,
            "K4": fused_temporal}
    for m in mods.values():
        m.LAUNCHES = 0
    os.environ["EXP_VARIANTS"] = ALL_VARIANTS
    for k in ("EXP_NF", "EXP_SIZES", "EXP_TEMPORAL"):
        os.environ.pop(k, None)
    t = time.perf_counter()
    print("phase 8 experiments.two_kernel_pipeline (every variant):",
          flush=True)
    check(two_kernel_pipeline.main() == 0, "two_kernel_pipeline.main")
    print("phase 8 experiments.two_kernel_pipeline with EXP_TEMPORAL=1:",
          flush=True)
    two_kernel_pipeline.run_fused_temporal()
    print("phase 8 experiments.pipelined_kernel:", flush=True)
    check(pipelined_kernel.main() == 0, "pipelined_kernel.main")
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    print(f"phase 8 done in {time.perf_counter() - t:.1f} s; launches "
          + json.dumps(launches))
    for k, n in launches.items():
        check(n > 0, f"the decomposition path launched {k}")
    return launches


ALL_VARIANTS = ("base,f32,bf16,xla,noise,noise16b,noise32,noise1seed,noprng,"
                "noisemin,storeonly,store2d,fuseddummy,gemmonly,fusednoprng,"
                "storef32,noisebatch")
ROOT = "pods_digital_filter_tpu_torch/csrc/"
REPLACES = {
    "K1": ("fused_noise_filter", "fused_filter.cu",
           "pods_digital_filter_tpu/ops/pallas_filter.py:45"),
    "K2": ("toeplitz_gemm", "toeplitz_gemm.cu",
           "benchmarks/exp_two_kernel_pipeline.py:59"),
    "K3": ("noise_probe", "noise_probe.cu",
           "benchmarks/exp_two_kernel_pipeline.py:341"),
    "K4": ("fused_temporal", "fused_temporal.cu",
           "benchmarks/exp_two_kernel_pipeline.py:570"),
}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not os.path.isfile(os.path.join(HERE, "pods_digital_filter_tpu_torch",
                                       "csrc", "fused_filter.cu")):
        print("chip_smoke: run it from a checkout of the repository (the "
              "port's sources are not beside this script)", file=sys.stderr)
        return 1
    from pods_digital_filter_tpu_torch.device import resolve_device

    t0 = time.perf_counter()
    dev = resolve_device("cuda:0")
    phase_card()
    phase_build()
    worst, ms, plain_ms = phase_kernel(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main("4 main path --pallas", ["--pallas"],
                              os.path.join(tmp, "fused"))
        check(launches > 0, "the main path launched K1")
        torch.cuda.empty_cache()
        plain_launches = phase_main("5 main path, torch-ops generator", [],
                                    os.path.join(tmp, "plain"))
        check(plain_launches == 0, "the torch-ops path does not launch K1")
        torch.cuda.empty_cache()
        record = phase_decomposition(dev)
        record["K1"] = (worst, ms, plain_ms)
        torch.cuda.empty_cache()
        bf16_launches = phase_main(
            "7 main path --pallas --dtype bfloat16",
            ["--pallas", "--dtype", "bfloat16"], os.path.join(tmp, "bf16"),
            check_bf16_taps)
        check(bf16_launches > 0, "the bf16 main path launched K1")
    torch.cuda.empty_cache()
    exp_launches = phase_experiments()
    counts = {"K1": launches, **{k: exp_launches[k] for k in ("K2", "K3", "K4")}}
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"kernels": [{
        "name": REPLACES[k][0],
        "route": "cuda",
        "source": ROOT + REPLACES[k][1],
        "replaces": REPLACES[k][2],
        "launches": counts[k],
        "max_abs_err": record[k][0],
        "ms": record[k][1],
        "plain_ms": record[k][2],
    } for k in ("K1", "K2", "K3", "K4")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
