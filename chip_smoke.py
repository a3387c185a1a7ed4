"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a host with a CUDA card, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA.  JAX is not needed and not imported.

Phases, one result line each; any failed check raises (exit code != 0):

1. the card (``nvidia-smi`` name and power limit) and the software versions;
2. build the fused noise + filter kernel (K1, csrc/fused_filter.cu) from the
   checkout's sources;
3. K1 against its plain PyTorch version on the card, at the shapes the main
   path gives it: the raw Philox stream bit for bit, the filtered slabs
   (atol 1e-5), the noise-in mode, window independence, stream statistics,
   and both times at 512 x 512 x 1,040 slabs x 3 components;
4. the main path through the user's entry points, the CLI equivalent of
   ``-j 512 -k 512 -n 1024 -l 4 -f 2 -m 20 -e 0.9 --pallas --device cuda``:
   K1's launch count, the model files, the mean profile, a replay of the
   written model against the in-memory result, the target Reynolds
   stresses, stage times and peak device memory;
5. the same run without ``--pallas`` (the torch-ops generator).

The last two lines are the kernel record and the result as JSON.
"""

import json
import os
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
    print(f"phase 2 build: K1 built by nvcc in {info.seconds:.2f} s "
          f"(load {time.perf_counter() - t:.2f} s)")
    print(info.log.strip())


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


def phase_main(label, extra, outdir):
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
          f"peak device memory {peak / 2 ** 30:.3f} GiB, stages (s) "
          + json.dumps(stages))
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
    return launches


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
    print(json.dumps({"kernels": [{
        "name": "fused_noise_filter",
        "route": "cuda",
        "source": "pods_digital_filter_tpu_torch/csrc/fused_filter.cu",
        "replaces": "pods_digital_filter_tpu/ops/pallas_filter.py:45",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
