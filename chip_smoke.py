"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a host with a CUDA card, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA.  JAX is not needed and not imported.

Phases, one result line each; any failed check raises (exit code != 0):

1. the card (``nvidia-smi`` name and power limit) and the software versions;
2. build the kernels K1-K5 (csrc/*.cu, one nvcc per source, in parallel)
   from the checkout's sources, with each kernel's registers and spills
   (``-Xptxas -v``), the wgmma (HGMMA) count of K2's bf16-tap kernels, the
   static SASS counts of K1 and K4 (shared loads per FFMA, multiplies) and
   K1's strip step and K4's tile with their shared memory and the blocks
   an SM holds, as the card reports them;
3. K1 against its plain PyTorch version on the card, at the shapes the main
   path gives it: the raw Philox stream bit for bit, the filtered slabs
   (atol 1e-5), the noise-in mode, window independence, stream statistics,
   and both times at 512 x 512 x 1,040 slabs x 3 components; (3f) K5, the
   generation tail, against its plain chain (FIR, Lund, pack, rotation,
   centre) within 1e-5 of the largest output, at the flagship's block
   (1024 x 512, 512 steps) and the main window (512 x 512, 1,024 steps),
   raw and centred, and on ragged shapes (nf 8 and 3), with both times,
   K5's ms a launch and its share of the bound; then K5's bfloat16 mode
   against the plain bf16 chain at every shape (the ragged ones take the
   one-value stores and, at nf 3, the runtime-tap kernel), raw and centred
   with a tilted rotation: at most 1e-3 of the elements differ, none by
   more than 2 bf16 ulps of the element before centring, with both times
   and the share of its bound (the f32 slabs read, the bf16 block written)
   at the two large shapes;
4. the main path through the user's entry points, the CLI equivalent of
   ``-j 512 -k 512 -n 1024 -l 4 -f 2 -m 20 -e 0.9 --pallas --device cuda``:
   K1's launch count, the model files, the mean profile, a replay of the
   written model against the in-memory result, the target Reynolds
   stresses, stage times and peak device memory;
5. the same run without ``--pallas`` (the torch-ops generator);
6. the decomposition kernels against their plain versions, with both
   times, the bound (the least time for the work: bytes over 3.35 TB/s or
   FLOPs over the peak of their type) and, where one PyTorch call computes
   the same function, that call's time (``torch.full`` for K3's constant
   stores; two f32 matmuls, or a bf16 matmul and a bmm with f32 output,
   for K2), at the experiments' shape (512 x 512, nf 8, 80 slabs x 3) and,
   for K1's bf16 taps, K2 (bf16 taps also on bf16 noise) and K4, at the
   main path's (1,040 slabs x 3): K1's
   bf16 taps, iota, dummy-in and slab-pipelined modes at atol 1e-5 as its
   f32 modes (the same summation order as the plain version, and bf16 x
   bf16 products are exact in f32), the last also bit for bit against K1,
   with K1's f32 taps shown to miss that limit; the raw bf16 field and K3's
   probes bit for bit; K2 with f32 taps at 1e-5; K2 with bf16 taps and the
   split K1 raw -> K2 against K1 within ``bf16_tap_bound`` with at most 1 %
   of elements off by more than 1e-5 (they sum in another order), K2's f32
   taps shown to miss that share; K4 against K1 and the plain FIR (1e-5);
   ragged shapes for every kernel, K3 in both output types; K1 timed at a
   1024 x 1024 window (row 2: 3 x 260 slabs, the main window's bytes); K1
   in every filtering mode and K4, f32 and bf16 taps, on shapes ragged
   against K1's 128 x 32 strip steps and K4's 32 x 32 tiles, with nfy !=
   nfz (nfx != nfy), nf 1 and the largest nf each takes (1e-5; pipelined
   == K1 and K4 noise-in == Philox bit for bit), and one nf more refused
   with the byte count;
7. the main path of phase 4 with ``--dtype bfloat16``: K1 launched, its
   output made with bf16 taps (snapshots regenerated on the host by the
   port's generator with bf16 taps agree with the run's in all but 1 % of
   elements, with f32 taps they do not), one bf16 K5 launch a model, a
   peak below phase 4's, replay and stresses as in phase 4; (7b) phase 9's
   streaming run in bf16, K5 centring every block: K5 after every K1, the
   mean and ``energy[:20]`` against phase 7's within bf16's rounding;
8. the decomposition path: both experiment entry points
   (``experiments.two_kernel_pipeline`` with every variant, then with
   ``EXP_TEMPORAL=1``; ``experiments.pipelined_kernel``) at their own
   sizes, with the launch count of each kernel;
9. the streaming POD at the main size (phase 4's arguments plus
   ``--streaming_block 256 --gram_group 2 --eig_mode topk``) against phase
   4's in-memory result: the mean (1e-5 of max|mean|), ``energy[:20]``
   (1e-4 relative), the truncation, the count of eigenvalues above the f32
   noise floor n eps lambda_0 (within 1; both valid counts at least that),
   the replay of its model, K1 launched once per block generation, on the
   dense f64 eigen route; (9a') the same run and checks with no room for
   the dense solve, so the card's Lanczos fallback runs, its m = n
   spectrum inside the eigen half's vectors stage; then twice with
   ``--checkpoint_dir`` (the second run loads every Gram row and takes the
   host eigen route, and writes the same model), and the checkpointed
   in-memory path against phase 4's ``A`` (1e-5);
10. the flagship, ``-j 1024 -k 512 -n 10240 -l 4 -f 2 -m 20 -e 0.9
    --pallas --streaming_block 512 --gram_group 8`` through the CLI parser
    and ``run_pipeline``: the stages, the eigen route, the Gram-pass memory
    estimate beside the measured peak, the 24 model files, the replay, the
    mean profile, the valid count and K1's 76 launches; then, on the
    rebuilt flagship Gram, the port's Lanczos (full spectrum, top 20)
    timed beside cuSOLVER's float64 ``eigvalsh``/``eigh`` (in turns, twice
    each), with the spectra's top-20 differences and valid counts;
11. slice 4 on phase 4's model and result (run before phase 10):
    (a) ``python -m pods_digital_filter_tpu_torch.replay`` on phase 4's
    model directory (64 steps, f64 on the card) against the port's C
    replayer (1e-9) and the in-memory model (1e-6), with the load, replay
    and write seconds; (b) replay throughput at
    ``benchmarks/bench_replay.py``'s size (32,768 points, 50 modes, 21
    coefficients, 512 steps): ``batch_device`` in f64 and f32 beside its
    bound, ``batch`` with the copy to the host and the C replayer;
    (c) ``compress_snapshot_matrix`` on phase 4's snapshots (3.2 GB, f32)
    against phase 4's energies (1e-5 relative) and model (replays within
    1e-5), with its peak memory, and the compress CLI through
    ``inflow.%06i`` files giving a rank-20 input back; (d) ``save_planes``
    on a 64^3-cell hex volume -> compression weighted by the plane's cell
    areas -> replay; (e) ``welch_psd``/``welch_csd``/``coherence``/
    ``cross_correlation`` and ``azimuthal_fourier_series`` on the card
    against the CPU in f64 (1e-10), ``phase_average`` on phase 4's
    snapshots against the CPU in f64 on a sub-plane (1e-5), the
    overlap-save noise scan against the batched generator (1e-5); (f) the
    CLI with ``-v --pallas`` at a small size: K1 launched, and the POD
    plots written, or the line saying matplotlib is absent;
12. the sharded paths (run after 11, before 10), through the CLI parser and
    ``run_pipeline`` in four ranks (``parallel.mesh.launch_local``) on card
    0: (a) the card count, the backend (gloo: the ranks share a card, and
    every collective is staged through the host) and the rank -> device
    map; (b) phase 5's arguments on a 2 x 2 mesh, in memory, against phase
    5's result (the exact path draws the same per-slab stream): the mean
    (1e-5 of max|mean|), ``energy[:20]`` (1e-4 relative), the truncation,
    the count above the f32 noise floor (within 1) and the written model's
    replay against phase 5's (1e-4 of the field's scale); (c) the same with
    ``--streaming_block 256 --gram_group 2 --eig_mode topk`` and its eigen
    route (dense f64), and (c') once more with no room for the dense
    solve (rank 0's Lanczos fallback, its spectrum synchronous); (d)
    ``--halo`` on 1 x 4: the target stresses and the v correlation across
    the three tile seams against the filter's (0.05);
    (e) a 256 x 256 streaming run with ``--checkpoint_dir`` filled on 2 x 2
    and resumed on 1 x 4 (no generation but the projection's; the same
    model); (f) with two cards or more, (b) with NCCL and one rank per card,
    else a line saying no multi-GPU run took place.  No K1 is launched on
    these paths (``--pallas`` is refused with sharding).

Phases 9, 10 and 12 each print their stage table, K1's launch count and
``torch.cuda.max_memory_allocated()`` (phase 12: of every rank).

The last two lines are the kernel record (with each kernel's bound and
library time) and the result as JSON.
"""

import contextlib
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


def cuda_ms(fn, sync, reps=1):
    """Device time of a call of ``fn`` on the card, by CUDA events around
    ``reps`` calls in a row, per call.  The card first spins for about 1 ms,
    so that the host has queued the calls' kernels before the start event
    fires: the time is the card's, without the host's launch overhead
    (which would otherwise dominate kernels of 0.1 ms).  An untimed call
    comes first, so that the caching allocator already holds the blocks
    the timed calls ask for (a 3.27 GB output that it has to map anew
    stalls the card for tens of ms); with ``reps`` > 1, two untimed calls
    whose results are alive together, as the timed loop holds one result
    while it makes the next."""
    import torch

    held = fn()
    if reps > 1:
        fn()
    del held
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps, out


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
    print(f"phase 2 build: K1-K5 built by nvcc (one process per source, in "
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
    # K2's bf16-tap kernels run on wgmma: count its SASS (HGMMA) in them
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(info.path)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn, mine = {}, "", []
    ops = {name: {} for name in SASS_KERNELS}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            mine = [n for n, pat in SASS_KERNELS.items() if pat in fn]
            continue
        if "HGMMA" in line and "gemm_bf16_kernel" in fn:
            key = "gemm_bf16_kernel<" + ("bf16" if "nv_bfloat16" in fn else
                                         "float") + ">"
            counts[key] = counts.get(key, 0) + 1
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if m and mine:
            op = m.group(1)
            op = "LDS" + (op[3:] if op.startswith("LDS.") else ".32") \
                if op.split(".")[0] == "LDS" else op.split(".")[0] + (
                    ".WIDE" if ".WIDE" in op else ".HI" if ".HI" in op else "")
            c = ops[mine[0]]
            c[op] = c.get(op, 0) + 1
            c["all"] = c.get("all", 0) + 1
    print(f"    K2 bf16 taps, HGMMA (wgmma) instructions in the SASS: "
          + json.dumps(counts))
    check(len(counts) == 2 and min(counts.values()) > 0,
          "K2's bf16-tap kernels issue wgmma")
    for name, c in ops.items():
        lds = sum(v for k, v in c.items() if k.startswith("LDS"))
        keep = {k: c.get(k, 0) for k in ("all", "FFMA", "LDS.32", "LDS.64",
                                        "LDS.128", "STS", "IMAD.WIDE",
                                        "IMAD.HI", "IMAD", "LOP3", "I2F",
                                        "F2F", "BAR")}
        print(f"    {name}, static SASS: shared loads per FFMA "
              f"{lds / max(1, c.get('FFMA', 0)):.3f}; " + json.dumps(keep))
        check(c.get("all", 0) > 0, f"{name} found in the SASS")


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


#: K5's shapes (label, jma, kma, steps, nf): the flagship's block, the main
#: path's window, and two ragged against its 128-point blocks and 32-step
#: tiles with an odd step count (its one-value stores), nf 8 and nf 3 (the
#: taps' slabs read through the cache)
TAIL_SHAPES = (("flagship block", 1024, 512, 512, 8), ("main", 512, 512, 1024, 8),
               ("ragged", 37, 29, 45, 8), ("ragged nf 3", 37, 29, 45, 3))


def _tail_case(dev, jma, kma, nsteps, nf):
    """K1's slabs and the generator's Lund fields, taps and rotation for a
    ``jma`` x ``kma`` x ``nsteps`` block (the CLI's default profile)."""
    from pods_digital_filter_tpu_torch import cli, pipeline
    from pods_digital_filter_tpu_torch.ops import fused_filter

    args = cli.build_parser().parse_args(
        ["-j", str(jma), "-k", str(kma), "-n", str(nsteps), "-l", str(nf / 2),
         "-f", "2", "--pallas", "--device", "cuda"])
    cfg = cli.config_from_args(args)
    fields, _, filt, cfg, rotate = pipeline.resolve_profile(cfg)
    check(filt.nfx == filt.nfy == filt.nfz == nf, f"nf = {nf}")
    gen = pipeline.make_generator(cfg, fields, filt, rotate=rotate, device=dev)
    z = fused_filter.fused_spatial(cfg.seed, 0, nsteps + 2 * nf, jma, kma,
                                   gen.by, gen.bz, 3)
    return z, gen


#: K5's bf16 mode against the plain bf16 chain: the share of the elements
#: that may differ, and the most one may differ by, in bf16 ulps of the
#: element before centring (the centring subtracts two close bf16 values
#: exactly, so a rounding moved before it keeps its absolute size)
BF16_SHARE, BF16_ULPS = 1e-3, 2


def bf16_ulp(x):
    """The spacing of bfloat16 values at ``|x|``, as float32."""
    import torch

    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def tail_bf16(z, gen, tilted, jma, kma, nsteps, nf, timed):
    """K5's bf16 mode against the plain bf16 chain (the FIR in f32, then
    Lund, pack, rotation and centre in bf16) on one shape, raw and centred
    with ``tilted``; with ``timed``, both times in turns, beside its
    bound."""
    import torch

    from pods_digital_filter_tpu_torch.ops import fused_tail

    bf = torch.bfloat16
    args = (z, gen.bx, gen.stresses.to(bf), gen.means.to(bf))
    rot, tilt = gen.rotation.to(bf), tilted.to(bf)
    plain_raw = fused_tail.fused_tail_plain(*args, rot, None)
    center = plain_raw.float().mean(dim=1).to(bf)
    out = {}
    for case, r, c in (("raw", rot, None), ("centred", tilt, center)):
        base = plain_raw if case == "raw" else \
            fused_tail.fused_tail_plain(*args, r, None)
        want = base if c is None else fused_tail.fused_tail_plain(*args, r, c)
        got = fused_tail.fused_tail(*args, r, c)
        torch.cuda.synchronize()
        check(got.dtype == bf and got.shape == want.shape, "K5 writes bf16")
        diff = (got.float() - want.float()).abs()
        share = float((diff > 0).float().mean())
        ulps = float((diff / bf16_ulp(base)).max())
        out[case] = (share, ulps, float(diff.max()))
        del got, want, base, diff
    print(f"phase 3f K5 bf16 {jma}x{kma} x {nsteps} steps, nf {nf}: "
          + "; ".join(f"{k} {s:.3e} of the elements differ, at most {u:g} "
                      f"bf16 ulps ({d:.3e})" for k, (s, u, d) in out.items()))
    check(max(s for s, _, _ in out.values()) <= BF16_SHARE,
          f"K5 bf16: at most {BF16_SHARE} of the elements differ")
    check(max(u for _, u, _ in out.values()) <= BF16_ULPS,
          f"K5 bf16: none by more than {BF16_ULPS} ulps")
    if not timed:
        return
    kernel = lambda: fused_tail.fused_tail(*args, rot, None)
    plain = lambda: fused_tail.fused_tail_plain(*args, rot, None)
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        ms, _ = cuda_ms(kernel if name == "kernel" else plain,
                        torch.cuda.synchronize,
                        reps=1 if name == "plain" else 5)
        times[name].append(ms)
    ms = sum(times["kernel"]) / 2
    nbytes = 3 * jma * kma * (4 * (nsteps + 2 * nf) + 2 * nsteps)
    bnd = bound(nbytes)
    print(f"    K5 bf16 {times['kernel']} ms a launch, plain bf16 chain "
          f"{times['plain']} ms; bound {bnd[0]:.3f} ms ({nbytes / 1e9:.2f} GB "
          f"at 3.35 TB/s): K5 at {100 * bnd[0] / ms:.1f} % of it")


def phase_tail(dev):
    """Phase 3f: K5 against its plain chain at the flagship's block and the
    main path's window, raw (the generator's own rotation, the identity for
    the default normal) and centred (with a tilted rotation at the main
    shape), and on ragged shapes; max |K5 - plain| within 1e-5 of
    max |plain|.  Both times in turns at the two large shapes, beside the
    bound (the slabs read once, the block written once, at 3.35 TB/s); then
    the bf16 mode at every shape (:func:`tail_bf16`), timed at the two
    large ones.
    Returns ``(max abs error, ms, plain ms, bound)`` at the flagship block."""
    import torch

    from pods_digital_filter_tpu_torch.ops import fused_tail, rotation

    sync = torch.cuda.synchronize
    tilted = torch.as_tensor(rotation.profile_rotation_matrix(1.0, 0.3, 0.2),
                             dtype=torch.float32, device=dev)
    record = None
    for label, jma, kma, nsteps, nf in TAIL_SHAPES:
        z, gen = _tail_case(dev, jma, kma, nsteps, nf)
        args = (z, gen.bx, gen.stresses, gen.means)
        plain_raw = fused_tail.fused_tail_plain(*args, gen.rotation, None)
        center = plain_raw.mean(dim=1)
        rot = gen.rotation if label == "flagship block" else tilted
        errs = {}
        for case, r, c in (("raw", gen.rotation, None),
                           ("centred", rot, center)):
            want = plain_raw if case == "raw" else \
                fused_tail.fused_tail_plain(*args, r, c)
            got = fused_tail.fused_tail(*args, r, c)
            sync()
            scale = float(want.abs().max())
            errs[case] = (float((got - want).abs().max()), scale)
            del got, want
        worst = max(e / s for e, s in errs.values())
        print(f"phase 3f K5 {label} {jma}x{kma} x {nsteps} steps, nf {nf}: "
              + "; ".join(f"{k} max |K5 - plain| {e:.3e} (max |plain| "
                          f"{s:.4f})" for k, (e, s) in errs.items()))
        check(worst <= 1e-5, f"K5 against the plain chain, {label}")
        if label in ("flagship block", "main"):
            kernel = lambda: fused_tail.fused_tail(*args, gen.rotation, None)
            plain = lambda: fused_tail.fused_tail_plain(*args, gen.rotation,
                                                         None)
            times = {"plain": [], "kernel": []}
            for name in ("plain", "kernel", "kernel", "plain"):
                ms, _ = cuda_ms(kernel if name == "kernel" else plain, sync,
                                reps=1 if name == "plain" else 5)
                times[name].append(ms)
            ms, plain_ms = (sum(times[k]) / 2 for k in ("kernel", "plain"))
            nbytes = 4 * 3 * jma * kma * ((nsteps + 2 * nf) + nsteps)
            bnd = bound(nbytes)
            print(f"    K5 {times['kernel']} ms a launch, plain "
                  f"{times['plain']} ms; bound {bnd[0]:.3f} ms "
                  f"({nbytes / 1e9:.2f} GB at 3.35 TB/s): K5 at "
                  f"{100 * bnd[0] / ms:.1f} % of it")
            if record is None:
                record = (errs["raw"][0], ms, plain_ms, bnd)
        torch.cuda.empty_cache()
        tail_bf16(z, gen, tilted, jma, kma, nsteps, nf,
                  timed=label in ("flagship block", "main"))
        del z, gen, args, plain_raw, center
        torch.cuda.empty_cache()
    return record


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
    """One main-path run; returns ``(K1 launches, result)``; the run's peak
    device memory is ``torch.cuda.max_memory_allocated()`` after it."""
    import torch

    from pods_digital_filter_tpu_torch import cli
    from pods_digital_filter_tpu_torch.ops import fused_filter, fused_tail
    from pods_digital_filter_tpu_torch.pipeline import resolve_profile, run_pipeline

    args = cli.build_parser().parse_args(
        MAIN_ARGS + extra + ["--outdir", outdir, "--device", "cuda"])
    cfg = cli.config_from_args(args)
    check(cfg.filt.nfx == cfg.filt.nfy == cfg.filt.nfz == 8, "nf = 8")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_filter.LAUNCHES = fused_tail.LAUNCHES = 0
    t = time.perf_counter()
    res = run_pipeline(cfg, device=args.device)
    wall = time.perf_counter() - t
    launches = fused_filter.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    stages = {k: round(v, 4) for k, v in res.timer.times.items()}
    print(f"phase {label}: run_pipeline {wall:.3f} s, K1 launches {launches}, "
          f"K5 launches {fused_tail.LAUNCHES}, peak device memory "
          f"{peak / 2 ** 30:.3f} GiB, stages (s) " + json.dumps(stages))
    takes = cfg.use_pallas and cfg.dtype in ("float32", "bfloat16")
    check(fused_tail.LAUNCHES == (launches if takes else 0),
          "K5 follows K1 on the float32 and bfloat16 --pallas routes only")
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
    return launches, res


#: kernels whose static SASS phase 2 counts (mangled-name fragments): K1 and
#: K4 as the main path and the experiments run them, K1's raw mode
SASS_KERNELS = {
    "K1 f32 taps, nf 8": "walk_kernelILi0ELb0ELi8ELi8ELb0E",
    "K1 bf16 taps, nf 8": "walk_kernelILi0ELb1ELi8ELi8ELb0E",
    "K1 any nf": "walk_kernelILi0ELb0ELi0ELi0ELb0E",
    "K1 raw bf16": "raw_kernelI13__nv_bfloat16E",
    "K4 f32 taps, nf 8": "fused_temporal_kernelILi0ELb0ELi8ELi8ELi8E",
    "K5 f32, nf 8": "tail_kernelILi8EfE",
    "K5 bf16, nf 8": "tail_kernelILi8E13__nv_bfloat16E",
}
EXP = dict(nf=8, jma=512, kma=512, slabs=80)       # the experiments' shape
MAIN = dict(nf=8, jma=512, kma=512, slabs=1040)     # the main path's shape
BIG = dict(nf=8, jma=1024, kma=1024, slabs=260)     # row 2: the same bytes
#: bf16-tap results summed in another order: the share of elements that may
#: differ by more than 1e-5 (tests/test_torch_pipeline.py's rule)
SHARE_LIMIT = 0.01
#: NVIDIA's H100 SXM data sheet at 700 W: device memory bytes/s and dense
#: FLOP/s (f32 without tensor cores; bf16 and f64 on them)
PEAK = {"bytes": 3.35e12, "f32": 67e12, "bf16": 989e12, "f64": 67e12}


def bound(nbytes, flops=0.0, kind="f32"):
    """The least time the card could take for the work, in ms: the bytes
    that must move (each input read once, each output written once) over
    the memory rate, or the FLOPs over the peak of their type, whichever is
    larger; with which of the two sets it."""
    by_bytes = nbytes / PEAK["bytes"] * 1e3
    by_ops = flops / PEAK[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def filter_work(slabs, jma, kma, nf, steps=0):
    """FLOPs of the separable spatial filter (z then y pass, 2nf+1 taps) over
    ``slabs`` slabs, plus the temporal FIR over ``steps`` output steps, for
    3 components."""
    jn, taps = jma + 2 * nf, 2 * nf + 1
    return 3 * 2 * taps * ((jn * kma + jma * kma) * slabs + jma * kma * steps)


def turns(kernel, plain, library=None):
    """Kernel, plain version and (where one PyTorch call computes the same
    function) the library call, timed in turns (plain, kernel, library,
    library, kernel, plain) by CUDA events after a warm-up of each:
    ``(kernel ms, plain ms, kernel output, plain output, library ms or
    None)``, the times the mean of two.  A function whose warm-up took
    under 1 ms is timed over enough calls in a row to fill about 1 ms, so
    that kernels of 0.05 ms are resolved to well under 1 us."""
    import torch

    sync = torch.cuda.synchronize
    fns = {"kernel": kernel, "plain": plain}
    if library is not None:
        fns["library"] = library
    reps = {}
    for name, fn in fns.items():
        ms, _ = cuda_ms(fn, sync)
        reps[name] = max(1, min(50, round(1.0 / max(ms, 1e-3))))
    order = ["plain", "kernel", "library", "library", "kernel", "plain"]
    times = {name: [] for name in fns}
    last = {}
    for name in (n for n in order if n in fns):
        last.pop(name, None)
        ms, last[name] = cuda_ms(fns[name], sync, reps[name])
        times[name].append(ms)
    mean = lambda name: sum(times[name]) / 2 if name in times else None
    return (mean("kernel"), mean("plain"), last["kernel"], last["plain"],
            mean("library"))


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def off_share(a, b):
    """The share of elements where ``a`` and ``b`` differ by more than 1e-5."""
    return float(((a.float() - b.float()).abs() > 1e-5).float().mean())


def gemm_work(total, jn, kn, jma, kma, noise_bytes, bf16_taps):
    """K2's work: its bytes (noise in, the taps, f32 out) and FLOPs."""
    tap_bytes = (kn * kma + jma * jn) * (2 if bf16_taps else 4)
    nbytes = total * (jn * kn * noise_bytes + jma * kma * 4) + tap_bytes
    flops = 2 * total * (jn * kn * kma + jma * jn * kma)
    return nbytes, flops, "bf16" if bf16_taps else "f32"


def phase_decomposition(dev):
    """Phase 6: every decomposition kernel and mode against its plain
    version, with both times, the bound and the library call's time;
    returns ``{name: (max_abs_err, ms, plain_ms, (bound_ms, bound_by),
    library_ms)}`` for the kernel record and prints one table line."""
    import torch

    from pods_digital_filter_tpu_torch.ops import (filters, fused_filter as ff,
                                                   fused_temporal as ft,
                                                   noise_probe as npr, philox,
                                                   toeplitz_gemm as tg)

    bf16, f32 = torch.bfloat16, torch.float32
    table, record = {}, {}
    seed = (5 << 32) | 4242

    def row(name, err, ms, plain_ms, tol, what, work, lib_ms=None):
        b_ms, b_by = work
        table[name] = {"max_abs_err": err, "tolerance": tol, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": lib_ms}
        lib = f"{lib_ms:.3f} ms" if lib_ms is not None else "none"
        print(f"phase 6 {name}: max |kernel - plain| = {err:.3e} "
              f"(tolerance {tol:.3e}{', ' + what if what else ''}); kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
              f"({b_by}), library {lib}")
        check(err <= tol, f"{name} within {tol}")
        torch.cuda.empty_cache()
        return (err, ms, plain_ms, work, lib_ms)

    def check_share(name, k, p):
        share = off_share(k, p)
        print(f"phase 6 {name}: {share:.3e} of the elements off by more than "
              f"1e-5 (limit {SHARE_LIMIT})")
        check(share <= SHARE_LIMIT, f"{name}: share of elements off")

    def taps(shape):
        b = filters.gaussian_fir_coeffs(shape["nf"], 4.0, f32, dev)
        jn, kn = shape["jma"] + 2 * shape["nf"], shape["kma"] + 2 * shape["nf"]
        return b, jn, kn

    def out_bytes(shape, slabs, esize=4):
        return 3 * slabs * shape["jma"] * shape["kma"] * esize

    # K1 with bf16 taps at the main path's shape (rows 1-2 with the
    # original's matmul_dtype=bfloat16)
    b, jn, kn = taps(MAIN)
    a = (seed, 0, MAIN["slabs"], MAIN["jma"], MAIN["kma"], b, b, 3)
    tap_bound = ff.bf16_tap_bound(b, b)
    ms, pms, k, p, _ = turns(
        lambda: ff.fused_spatial(*a, matmul_dtype=bf16),
        lambda: ff.fused_spatial_plain(*a, matmul_dtype=bf16))
    row("K1 bf16 taps, 1040 x 3", max_err(k, p), ms, pms, 1e-5,
        "as f32 taps: the plain version's summation order",
        bound(out_bytes(MAIN, MAIN["slabs"]),
              filter_work(MAIN["slabs"], MAIN["jma"], MAIN["kma"], 8)))
    k1_bf16_main_ms = ms
    del k
    # a K1 that ignored its bf16 flag would miss that limit
    k = ff.fused_spatial(*a)
    err, share = max_err(k, p), off_share(k, p)
    print(f"phase 6 K1 f32 taps vs the bf16-tap plain version: max diff "
          f"{err:.3e}, {share:.3f} of the elements off by more than 1e-5")
    check(err > 1e-5 and share > SHARE_LIMIT, "bf16 taps change K1's output")
    del k, p

    # row 2 (the original's tiled kernel, for planes past its VMEM guard): K1
    # at a 1024^2 window of 3 x 260 slabs, the main window's 3.27 GB
    b, jn, kn = taps(BIG)
    a = (seed, 0, BIG["slabs"], BIG["jma"], BIG["kma"], b, b, 3)
    ms, pms, k, p, _ = turns(lambda: ff.fused_spatial(*a),
                             lambda: ff.fused_spatial_plain(*a))
    row("K1 f32 1024^2, 260 x 3", max_err(k, p), ms, pms, 1e-5, "",
        bound(out_bytes(BIG, BIG["slabs"]),
              filter_work(BIG["slabs"], BIG["jma"], BIG["kma"], 8)))
    del k, p

    b, jn, kn = taps(EXP)
    S = EXP["slabs"]
    a = (seed, 0, S, EXP["jma"], EXP["kma"], b, b, 3)
    exp_filter = bound(out_bytes(EXP, S),
                       filter_work(S, EXP["jma"], EXP["kma"], 8))
    raw16 = bound(3 * S * jn * kn * 2)
    # K1 raw mode, bf16 out (kernel A of split_bf16): bit for bit
    ms, pms, k, p, _ = turns(
        lambda: ff.raw_noise(seed, 0, S, jn, kn, 3, dev, bf16),
        lambda: philox.raw_noise(seed, 0, S, jn, kn, 3, dev).to(bf16))
    row("K1 raw bf16", max_err(k, p), ms, pms, 0.0, "bit for bit", raw16)
    check(torch.equal(k, p), "K1 raw bf16 bit for bit")
    del k, p
    # slab-pipelined against K1 itself: bit for bit, both tap dtypes
    for md, name in ((f32, "f32"), (bf16, "bf16")):
        ms, pms, k, p, _ = turns(
            lambda: ff.fused_spatial_pipelined(*a, matmul_dtype=md),
            lambda: ff.fused_spatial_plain(*a, matmul_dtype=md))
        base = ff.fused_spatial(*a, matmul_dtype=md)
        check(torch.equal(k, base), f"pipelined == K1 bit for bit ({name})")
        row(f"K1 pipelined {name}", max_err(k, p), ms, pms, 1e-5,
            "== K1 bit for bit", exp_filter)
        del k, p, base
    # iota source and dummy input, bf16 taps as in the experiment
    ms, pms, k, p, _ = turns(
        lambda: ff.fused_spatial_iota(S, EXP["jma"], EXP["kma"], b, b, 3, bf16),
        lambda: ff.fused_spatial_iota_plain(S, EXP["jma"], EXP["kma"], b, b,
                                            3, bf16))
    row("K1 iota bf16", max_err(k, p), ms, pms, 1e-5, "", exp_filter)
    dummy = torch.randn((3 * S, 8, 128), device=dev)
    ms, pms, k, p, _ = turns(
        lambda: ff.fused_spatial_dummy_in(*a[:-1], dummy, 3, bf16),
        lambda: ff.fused_spatial_dummy_in_plain(*a[:-1], dummy, 3, bf16))
    row("K1 dummy-in bf16", max_err(k, p), ms, pms, 1e-5, "",
        bound(out_bytes(EXP, S) + dummy.numel() * 4,
              filter_work(S, EXP["jma"], EXP["kma"], 8)))
    del k, p, dummy

    # K3: every probe bit for bit (bf16 as in the experiment; storeonly f32),
    # the constant stores beside torch.full
    for body, dt in [(nb, bf16) for nb in npr.BODIES] + [("storeonly", f32)]:
        pa = (body, seed, 0, S, jn, kn, 3, dt, dev)
        full = ((lambda: torch.full((3 * S, jn, kn), 0.5, dtype=dt, device=dev))
                if body == "storeonly" else None)
        ms, pms, k, p, lms = turns(lambda: npr.probe(*pa),
                                   lambda: npr.probe_plain(*pa), full)
        check(torch.equal(k, p), f"K3 {body} bit for bit")
        res = row(f"K3 {body} {'bf16' if dt == bf16 else 'f32'}",
                  max_err(k, p), ms, pms, 0.0, "bit for bit",
                  bound(k.numel() * k.element_size()), lms)
        if body == "noise" and dt == bf16:
            record["K3"] = res
    shape2d = (EXP["jma"], 3 * S * EXP["kma"])
    ms, pms, k, p, lms = turns(
        lambda: npr.store2d(S, EXP["jma"], EXP["kma"], 3, dev),
        lambda: npr.store2d_plain(S, EXP["jma"], EXP["kma"], 3, dev),
        lambda: torch.full(shape2d, 0.5, dtype=f32, device=dev))
    check(torch.equal(k, p), "K3 store2d bit for bit")
    row("K3 store2d", max_err(k, p), ms, pms, 0.0, "bit for bit",
        bound(k.numel() * 4), lms)
    del k, p

    def k2_library(noise, Bz, By):
        """The library calls that compute K2's function: two f32 matmuls,
        or a bf16 matmul (its bf16 output is the rounded t) and a bmm with
        f32 output."""
        if Bz.dtype == f32:
            return lambda: torch.matmul(By, torch.matmul(noise.float(), Bz))
        return lambda: torch.bmm(By.expand(noise.shape[0], -1, -1),
                                 torch.matmul(noise.to(bf16), Bz),
                                 out_dtype=f32)

    launches0 = tg.LAUNCHES
    # K2 at the experiments' shape: on K1's raw noise (split) and alone
    ByM = {md: filters.toeplitz_band(b, EXP["jma"]).to(md) for md in (f32, bf16)}
    BzT = {md: filters.toeplitz_band(b, EXP["kma"]).T.contiguous().to(md)
           for md in (f32, bf16)}
    noise = ff.raw_noise(seed, 0, S, jn, kn, 3, dev).view(3 * S, jn, kn)
    for md, name in ((f32, "f32"), (bf16, "bf16")):
        ms, pms, k, p, lms = turns(
            lambda: tg.toeplitz_gemm(noise, BzT[md], ByM[md]),
            lambda: tg.toeplitz_gemm_plain(noise, BzT[md], ByM[md]),
            k2_library(noise, BzT[md], ByM[md]))
        row(f"K2 {name} taps, 80 x 3", max_err(k, p), ms, pms,
            1e-5 if md == f32 else tap_bound, "",
            bound(*gemm_work(3 * S, jn, kn, EXP["jma"], EXP["kma"], 4,
                             md == bf16)), lms)
        if md == bf16:
            check_share("K2 bf16 taps, 80 x 3", k, p)
        del k, p
    split = tg.toeplitz_gemm(noise, BzT[bf16], ByM[bf16]).view(3, S, EXP["jma"],
                                                               EXP["kma"])
    split16 = tg.toeplitz_gemm(noise.to(bf16), BzT[bf16], ByM[bf16])
    base = ff.fused_spatial(*a, matmul_dtype=bf16)
    err = max_err(split, base)
    print(f"phase 6 split_f32 (K1 raw -> K2, bf16 taps) vs K1 bf16 taps: max "
          f"diff {err:.3e} (bound {tap_bound:.3e}); split_bf16 == split_f32: "
          f"{torch.equal(split16.view_as(split), split)}")
    check(err <= tap_bound, "split_f32 vs K1 within the bf16-tap bound")
    check_share("split_f32 vs K1 bf16 taps", split, base)
    check(torch.equal(split16.view_as(split), split), "split_bf16 == split_f32")
    del noise, split, split16, base
    torch.cuda.empty_cache()

    # K2 at the main path's shape, against its plain version, the library
    # calls and K1; bf16 taps on f32 and on bf16 noise
    b, jn, kn = taps(MAIN)
    total = 3 * MAIN["slabs"]
    noise = ff.raw_noise(seed, 0, MAIN["slabs"], jn, kn, 3, dev).view(-1, jn, kn)
    k2_f32 = None
    for md, nd, name in ((f32, f32, "f32 taps"), (bf16, f32, "bf16 taps"),
                         (bf16, bf16, "bf16 taps, bf16 noise")):
        By = filters.toeplitz_band(b, MAIN["jma"]).to(md)
        Bz = filters.toeplitz_band(b, MAIN["kma"]).T.contiguous().to(md)
        x = noise if nd == f32 else noise.to(bf16)
        ms, pms, k, p, lms = turns(lambda: tg.toeplitz_gemm(x, Bz, By),
                                   lambda: tg.toeplitz_gemm_plain(x, Bz, By),
                                   k2_library(x, Bz, By))
        err = max_err(k, p)
        res = row(f"K2 {name}, 1040 x 3", err, ms, pms,
                  1e-5 if md == f32 else tap_bound,
                  f"K1 bf16 taps {k1_bf16_main_ms:.3f} ms" if md == bf16 else "",
                  bound(*gemm_work(total, jn, kn, MAIN["jma"], MAIN["kma"],
                                   x.element_size(), md == bf16)), lms)
        if md == f32:
            k2_f32 = k
            del p
            continue
        check_share(f"K2 {name}, 1040 x 3", k, p)
        if nd == f32:
            record["K2"] = res
            # a K2 that ignored its bf16 taps would miss that share
            share = off_share(k2_f32, p)
            print(f"phase 6 K2 f32 taps vs the bf16-tap plain version: "
                  f"{share:.3f} of the elements off by more than 1e-5")
            check(share > SHARE_LIMIT, "bf16 taps change K2's output")
        del k, p, x
    del noise, k2_f32
    torch.cuda.empty_cache()
    print(f"phase 6 K2 (wgmma bf16 / f32 SGEMM, csrc/toeplitz_gemm.cu) "
          f"launches in this phase: {tg.LAUNCHES - launches0}")

    # K4 against K1 and the plain FIR, at both shapes (f32 taps), and bf16
    # taps at the experiments' shape
    for shape, md, name in ((EXP, f32, "f32, 64 steps"),
                            (EXP, bf16, "bf16, 64 steps"),
                            (MAIN, f32, "f32, 1024 steps")):
        b, jn, kn = taps(shape)
        n = shape["slabs"] - 2 * shape["nf"]
        ka = (seed, 0, n, shape["jma"], shape["kma"], b, b, b, 3)
        ms, pms, k, p, _ = turns(
            lambda: ft.fused_temporal(*ka, matmul_dtype=md),
            lambda: ft.fused_temporal_plain(*ka, matmul_dtype=md))
        z = ff.fused_spatial(seed, 0, shape["slabs"], shape["jma"],
                             shape["kma"], b, b, 3, matmul_dtype=md)
        err = max_err(k, filters.filter_temporal(z, b, axis=-3))
        del z
        res = row(f"K4 {name}", max(err, max_err(k, p)), ms, pms, 1e-5,
                  f"vs K1 + plain FIR {err:.3e}",
                  bound(out_bytes(shape, n),
                        filter_work(shape["slabs"], shape["jma"],
                                    shape["kma"], shape["nf"], n)))
        if shape is MAIN:
            record["K4"] = res
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
            for nd in (f32, bf16):
                noise = (torch.rand((2, jn, kn), generator=g, device=dev) * 3.4
                         - 1.7).to(nd)
                Dz = torch.randn((kn, kma), generator=g, device=dev).to(md)
                Dy = torch.randn((jma, jn), generator=g, device=dev).to(md)
                p2 = tg.toeplitz_gemm_plain(noise, Dz, Dy)
                t = noise.to(md).float() @ Dz.float()
                ulp = 2.0 ** (math.floor(math.log2(float(t.abs().max()))) - 7)
                rows = float(Dy.float().abs().sum(1).max())
                errs[f"K2 dense {name} taps, {str(nd)[6:]} noise"] = (
                    max_err(tg.toeplitz_gemm(noise, Dz, Dy), p2),
                    1e-5 * (1 + float(t.abs().max()) * rows)
                    + (ulp * rows if md == bf16 else 0.0))
        print(f"phase 6 ragged {jma}x{kma} nf={nf}: "
              + ", ".join(f"{k} {e:.2e} (bound {b_:.2e})"
                          for k, (e, b_) in errs.items()))
        for k, (e, b_) in errs.items():
            check(e <= b_, f"{k} on a ragged shape")
    # K3: every probe in both output types, at an aligned and a ragged row
    # length (kn / 2 = 67: a partial group of words, rows off 16 bytes)
    for kn_ in (136, 134):
        for body in npr.BODIES:
            for dt in (bf16, f32):
                pa = (body, seed, 1, 4, 66, kn_, 3, dt, dev)
                check(torch.equal(npr.probe(*pa), npr.probe_plain(*pa)),
                      f"K3 {body} {dt} at kn={kn_}")
        check(torch.equal(npr.store2d(4, 66, kn_ // 2, 3, dev),
                          npr.store2d_plain(4, 66, kn_ // 2, 3, dev)),
              f"K3 store2d at kma={kn_ // 2}")
    print("phase 6 K3 at 66 x 136 and 66 x 134 (every probe, bf16 and f32; "
          "store2d at kma 68 and 67): bit for bit")

    check_walk(dev, seed)
    print("phase 6 table " + json.dumps(table))
    return record


def geometry(dev):
    """K1's strip step and K4's tile at the main path's nf and a few others:
    width x rows, shared memory per block and blocks an SM holds (the
    card's occupancy report); the registers are phase 2's ptxas lines."""
    import ctypes

    import torch

    from pods_digital_filter_tpu_torch.ops import (_build, fused_filter as ff,
                                                   fused_temporal as ft)

    lib, _ = _build.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    limit = lib.fused_filter_smem_limit(dev.index)
    lines = []
    for nfy, nfz in ((8, 8), (6, 6), (3, 5)):
        for mode, name in ((ff._PHILOX_FILTERED, "K1"),
                           (ff._PIPELINED, "K1 pipelined")):
            ks, ch, need = ff.walk_tile(nfy, nfz, mode == ff._PIPELINED,
                                        lib.fused_filter_smem_bytes, limit)
            for bf16 in (0, 1):
                slots = ctypes.c_int(0)
                err = lib.fused_filter_launch(
                    mode, bf16, 0, None, None, None, None, None, nfy, nfz,
                    512, 512, 3, 1040, ks, ch, 0, 0, 0, 1.0, 1.0, None,
                    ctypes.byref(slots))
                _build.check_launch(err, "occupancy query")
                lines.append(f"{name} nf ({nfy},{nfz}) {'bf16' if bf16 else 'f32'}"
                             f" taps: {ks} x {ch} step, {need} B, "
                             f"{slots.value / sms:g} blocks/SM")
    for nf in ((8, 8, 8), (2, 1, 3)):
        ks, ch, need = ft.temporal_tile(*nf, lib.fused_temporal_smem_bytes, limit)
        slots = lib.fused_temporal_slots(*nf, ks, ch, 0, 0, dev.index)
        lines.append(f"K4 nf {nf}: {ch} x {ks} tile, {need} B, "
                     f"{slots / sms:g} blocks/SM")
    print("phase 2 geometry: " + "; ".join(lines))


def largest_nf(accepts, start=1):
    """The largest n with accepts(n) true, accepts(start) being true and
    monotone in n."""
    hi = start
    while accepts(hi * 2):
        hi *= 2
    lo, hi = hi, hi * 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if accepts(mid) else (lo, mid)
    return lo


def check_walk(dev, seed):
    """K1 (every filtering mode, f32 and bf16 taps) and K4 on shapes ragged
    against K1's strip steps (128 x 32 at small nf) and K4's 32 x 32 tiles,
    with nfy != nfz (nfx != nfy for K4), nf = 1 and the largest nf each
    accepts; each at 1e-5 of its plain version, pipelined == K1 and K4's
    noise-in == its Philox mode bit for bit; one nf past the largest is
    refused with the byte count."""
    import torch

    from pods_digital_filter_tpu_torch.ops import (_build, filters,
                                                   fused_filter as ff,
                                                   fused_temporal as ft, philox)

    f32, bf16 = torch.float32, torch.bfloat16
    lib, _ = _build.load()
    limit = lib.fused_filter_smem_limit(dev.index)
    fits = lambda pipe: lambda n: _fits(lambda: ff.walk_tile(
        n, n, pipe, lib.fused_filter_smem_bytes, limit))
    nf_max, nf_pipe = largest_nf(fits(False)), largest_nf(fits(True))
    nfx_max = largest_nf(lambda n: _fits(lambda: ft.temporal_tile(
        n, 2, 2, lib.fused_temporal_smem_bytes, limit)))
    for fn, args in ((ff.walk_tile, (nf_max + 1, nf_max + 1, False,
                                     lib.fused_filter_smem_bytes, limit)),
                     (ft.temporal_tile, (nfx_max + 1, 2, 2,
                                         lib.fused_temporal_smem_bytes, limit))):
        try:
            fn(*args)
            check(False, f"{fn.__name__} refuses one past its largest nf")
        except ValueError as e:
            check("bytes of shared memory" in str(e), "refusal names the bytes")
    print(f"phase 6 walk: largest nf K1 accepts {nf_max} (pipelined "
          f"{nf_pipe}), K4's largest nfx {nfx_max} (nfy = nfz = 2); one "
          f"more is refused with the byte count")
    g = lambda nf: filters.gaussian_fir_coeffs(nf, max(nf, 1) / 2.0, f32, dev)
    cases = [(45, 259, 3, 5, 3), (70, 130, 1, 1, 2), (33, 131, 2, 7, 2),
             (100, 300, 8, 8, 2), (21, 140, 6, 6, 2), (9, 10, 13, 2, 2),
             (20, 24, nf_max, nf_max, 1), (16, 16, nf_pipe, nf_pipe, 1)]
    worst = {}
    for (jma, kma, nfy, nfz, S) in cases:
        by, bz = g(nfy), g(nfz)
        jn, kn = jma + 2 * nfy, kma + 2 * nfz
        noise = philox.raw_noise(seed, 2, S, jn, kn, 2, dev)
        dummy = torch.randn((2 * S, 8, 128), device=dev)
        for md, name in ((f32, "f32"), (bf16, "bf16")):
            a = (seed, 2, S, jma, kma, by, bz, 2)
            plain = ff.fused_spatial_plain(*a, matmul_dtype=md)
            k1 = ff.fused_spatial(*a, matmul_dtype=md)
            errs = {"philox": max_err(k1, plain),
                    "noise-in": max_err(ff.fused_spatial(
                        *a, noise=noise, matmul_dtype=md), plain),
                    "iota": max_err(
                        ff.fused_spatial_iota(S, jma, kma, by, bz, 2, md),
                        ff.fused_spatial_iota_plain(S, jma, kma, by, bz, 2, md))}
            if nfy <= nf_pipe and nfz <= nf_pipe:
                pipe = ff.fused_spatial_pipelined(*a, matmul_dtype=md)
                check(torch.equal(pipe, k1),
                      f"pipelined == K1 at {jma}x{kma} nf ({nfy},{nfz}) {name}")
            if jma >= 8 and kma >= 128:
                errs["dummy-in"] = max_err(
                    ff.fused_spatial_dummy_in(*a[:-1], dummy, 2, md),
                    ff.fused_spatial_dummy_in_plain(*a[:-1], dummy, 2, md))
            for mode, e in errs.items():
                key = f"K1 {mode} {name}"
                worst[key] = max(worst.get(key, 0.0), e)
                check(e <= 1e-5, f"{key} at {jma}x{kma} nf ({nfy},{nfz})")
        del noise, dummy
    for (jma, kma, nfx, nfy, nfz, n) in ((45, 67, 2, 3, 5, 3), (70, 33, 1, 1, 1, 4),
                                         (32, 96, 3, 1, 2, 2), (40, 36, 8, 8, 8, 3),
                                         (17, 12, nfx_max, 2, 2, 2)):
        bx, by, bz = g(nfx), g(nfy), g(nfz)
        noise = philox.raw_noise(seed, 2, n + 2 * nfx, jma + 2 * nfy,
                                 kma + 2 * nfz, 2, dev)
        for md, name in ((f32, "f32"), (bf16, "bf16")):
            ka = (seed, 2, n, jma, kma, bx, by, bz, 2)
            k4 = ft.fused_temporal(*ka, matmul_dtype=md)
            e = max_err(k4, ft.fused_temporal_plain(*ka, matmul_dtype=md))
            check(torch.equal(ft.fused_temporal(*ka, noise=noise, matmul_dtype=md),
                              k4), f"K4 noise-in == Philox at nf ({nfx},{nfy},{nfz})")
            key = f"K4 {name}"
            worst[key] = max(worst.get(key, 0.0), e)
            check(e <= 1e-5, f"{key} at {jma}x{kma} nf ({nfx},{nfy},{nfz})")
    print("phase 6 walk: ragged shapes "
          + ", ".join(f"{c[0]}x{c[1]} nf ({c[2]},{c[3]})" for c in cases)
          + "; worst max |kernel - plain| " + json.dumps(worst)
          + "; pipelined == K1 and K4 noise-in == Philox bit for bit")


def _fits(fn):
    try:
        fn()
        return True
    except ValueError:
        return False


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

#: phase 9: the streaming POD at the main size (block 256, group 2, the
#: device f64 eigh route on the Philox stream of phase 4)
STREAM_ARGS = ["--pallas", "--streaming_block", "256", "--gram_group", "2",
               "--eig_mode", "topk"]
#: phase 10: the flagship of benchmarks/bench_flagship.py:58-65
FLAGSHIP_ARGS = ["-j", "1024", "-k", "512", "-n", "10240", "-l", "4", "-f",
                 "2", "-m", "20", "-e", "0.9", "--pallas", "--streaming_block",
                 "512", "--gram_group", "8"]


def _opt(argv, flag):
    return int(argv[argv.index(flag) + 1])


def generations(ns, block, group):
    """K1 launches of one streaming run with no stored rows: the mean pass
    (B blocks), the Gram pass (each panel's blocks, then the column blocks
    after it) and the projection (B blocks), B = ceil(ns / block)."""
    nb = -(-ns // block)
    gram = sum(min(group, nb - g0) + nb - min(g0 + group, nb)
               for g0 in range(0, nb, group))
    return 2 * nb + gram


def run_cli(label, argv, outdir):
    """``run_pipeline`` on the parsed ``argv`` on the card; prints the
    stage table, K1's launches and the peak device memory; returns
    ``(result, K1 launches, peak bytes)``."""
    import torch

    from pods_digital_filter_tpu_torch import cli
    from pods_digital_filter_tpu_torch.ops import fused_filter, fused_tail
    from pods_digital_filter_tpu_torch.pipeline import run_pipeline

    args = cli.build_parser().parse_args(
        argv + ["--outdir", outdir, "--device", "cuda"])
    cfg = cli.config_from_args(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_filter.LAUNCHES = fused_tail.LAUNCHES = 0
    t = time.perf_counter()
    res = run_pipeline(cfg, device=args.device)
    wall = time.perf_counter() - t
    launches = fused_filter.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    stages = {k: round(v, 4) for k, v in res.timer.times.items()}
    print(f"phase {label}: run_pipeline {wall:.3f} s, K1 launches {launches}, "
          f"K5 launches {fused_tail.LAUNCHES}, peak device memory "
          f"{peak / 2 ** 30:.3f} GiB, stages (s) " + json.dumps(stages),
          flush=True)
    check(fused_tail.LAUNCHES == launches, "K5 launched after every K1")
    if res.eig_route is not None:
        print(f"    eigen route: {json.dumps(res.eig_route)}")
        if "gate" in res.eig_route:
            print(f"phase {label}: LANCZOS GATE TRIPPED: "
                  f"{res.eig_route['gate']}")
    return res, launches, peak


def noise_floor_counts(n, lam0, *spectra):
    """The float32 noise floor of an n x n Gram's spectrum, n eps lambda_0
    (eps = 2^-23: the backward error of its accumulation and of an f32
    eigensolve), and how many eigenvalues of each spectrum lie above it.
    The reference's valid count stops at the first eigenvalue <= 0; below
    the floor the signs are rounding noise, so two f32 solves of one
    spectrum may stop at different places there."""
    import numpy as np

    floor = n * 2.0 ** -23 * float(lam0)
    return floor, [int(np.sum(np.asarray(e) > floor)) for e in spectra]


def rel_err(a, b):
    import numpy as np

    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        / np.abs(np.asarray(b))))


@contextlib.contextmanager
def no_dense_eigh():
    """Within it the streaming eigen half finds no room for the dense f64
    solve, so a card takes its fallback: the f32 scalar Lanczos vectors,
    then the full spectrum from the m = n Lanczos scan, both before the
    projection."""
    from pods_digital_filter_tpu_torch import streaming

    fits = streaming.dense_eigh_fits
    streaming.dense_eigh_fits = lambda dev, ns: False
    try:
        yield
    finally:
        streaming.dense_eigh_fits = fits


def check_lanczos_fallback(res, what):
    """The card's fallback route ran: Lanczos top-k vectors and the m = n
    Lanczos spectrum, both inside the ``streaming_eigh_vectors`` stage (no
    ``streaming_eigh_spectrum`` stage: nothing is deferred)."""
    print(f"    {what}: eigen half "
          f"{res.timer.times.get('streaming_eigh_vectors')} s, spectrum by "
          f"{res.eig_route.get('spectrum')}")
    check(res.eig_route["vectors"].startswith("Lanczos top-k on cuda"),
          f"{what}: the device Lanczos route ran")
    check(res.eig_route.get("spectrum", "").startswith(
        "Lanczos m = n on cuda"), f"{what}: the Lanczos spectrum ran")
    check("streaming_eigh_spectrum" not in res.timer.times,
          f"{what}: no deferred spectrum stage")


def check_streaming(res, launches, mem, what):
    """9a/9a': a main-size streaming run against phase 4's ``mem``."""
    import numpy as np

    ns = _opt(MAIN_ARGS, "-n")
    block = _opt(STREAM_ARGS, "--streaming_block")
    group = _opt(STREAM_ARGS, "--gram_group")
    scale = float(np.abs(mem.mean_field).max())
    d_mean = float(np.abs(res.mean_field - mem.mean_field).max())
    d_e = rel_err(res.pod.energy[:20], mem.pod.energy[:20])
    floor, counts = noise_floor_counts(ns, mem.pod.energy[0],
                                       res.pod.energy, mem.pod.energy)
    print(f"    vs phase 4: max |mean - mean_4| = {d_mean:.3e} (limit "
          f"{1e-5 * scale:.3e}); energy[:20] max rel diff {d_e:.3e} (limit "
          f"1e-4); num_trunc {res.pod.num_trunc}; num_valid "
          f"{res.pod.num_valid} vs {mem.pod.num_valid}; eigenvalues above "
          f"the f32 noise floor n eps lambda_0 = {floor:.3e}: {counts[0]} vs "
          f"{counts[1]}; energy at the valid counts "
          f"{res.pod.energy[res.pod.num_valid - 1]:.3e} / "
          f"{mem.pod.energy[mem.pod.num_valid - 1]:.3e}; K1 launches "
          f"{launches} (expected {generations(ns, block, group)})")
    check(d_mean <= 1e-5 * scale, f"{what}: streaming mean vs in-memory")
    check(d_e <= 1e-4, f"{what}: streaming energy[:20] vs in-memory")
    check(res.pod.num_trunc == 20, f"{what}: streaming num_trunc 20")
    check(abs(counts[0] - counts[1]) <= 1,
          f"{what}: the same count above the f32 noise floor")
    check(min(res.pod.num_valid, mem.pod.num_valid) >= min(counts) - 1,
          f"{what}: the valid counts differ only below the noise floor")
    check(launches == generations(ns, block, group),
          f"{what}: K1 launched once per block generation")
    check_replay(res)


def phase_streaming_bf16(mem, tmp):
    """Phase 7b: phase 9's streaming run in bf16, where K5 writes each
    block centred in bf16, against phase 7's in-memory bf16 result
    ``mem``: K5 after every K1 (``run_cli``), the mean within 4 bf16 ulps
    of its largest value, ``energy[:20]`` within 1e-2 of ``energy[0]`` (the
    two routes round the block and the Gram at different points)."""
    import numpy as np

    res, launches, _ = run_cli("7b streaming --dtype bfloat16",
                               MAIN_ARGS + STREAM_ARGS + ["--dtype",
                                                          "bfloat16"],
                               os.path.join(tmp, "stream_bf16"))
    ns = _opt(MAIN_ARGS, "-n")
    block = _opt(STREAM_ARGS, "--streaming_block")
    group = _opt(STREAM_ARGS, "--gram_group")
    scale = float(np.abs(mem.mean_field).max())
    d_mean = float(np.abs(res.mean_field - mem.mean_field).max())
    d_e = float(np.abs(res.pod.energy[:20] - mem.pod.energy[:20]).max()
                / mem.pod.energy[0])
    print(f"    vs phase 7: max |mean - mean_7| = {d_mean:.3e} (limit "
          f"{2 ** -5 * scale:.3e}); energy[:20] max diff over energy[0] "
          f"{d_e:.3e} (limit 1e-2); num_trunc {res.pod.num_trunc}; K1 "
          f"launches {launches} (expected {generations(ns, block, group)})")
    check(d_mean <= 2 ** -5 * scale, "7b: streaming bf16 mean vs in-memory")
    check(d_e <= 1e-2, "7b: streaming bf16 energy[:20] vs in-memory")
    check(res.pod.num_trunc == 20, "7b: streaming num_trunc 20")
    check(launches == generations(ns, block, group),
          "7b: K1 launched once per block generation")


def phase_streaming(mem, tmp):
    """Phase 9: the streaming POD at the main size against phase 4's
    in-memory result ``mem`` (on the dense eigen route, then on the
    card's Lanczos fallback), its checkpoint resume, and the checkpointed
    in-memory path."""
    import numpy as np

    ns = _opt(MAIN_ARGS, "-n")
    block = _opt(STREAM_ARGS, "--streaming_block")
    group = _opt(STREAM_ARGS, "--gram_group")
    nb = -(-ns // block)
    res, launches, _ = run_cli("9a streaming", MAIN_ARGS + STREAM_ARGS,
                               os.path.join(tmp, "stream"))
    check_streaming(res, launches, mem, "9a")
    check(res.eig_route["vectors"] == "device eigh on cuda (f64)",
          "the device f64 eigh route ran")
    with no_dense_eigh():
        res, launches, _ = run_cli("9a' streaming, no room for the dense "
                                   "solve", MAIN_ARGS + STREAM_ARGS,
                                   os.path.join(tmp, "stream_lz"))
    check_streaming(res, launches, mem, "9a'")
    check_lanczos_fallback(res, "9a'")

    ck = os.path.join(tmp, "ck_stream")
    argv = MAIN_ARGS + STREAM_ARGS + ["--checkpoint_dir", ck]
    r1, l1, _ = run_cli("9b streaming --checkpoint_dir (fills the store)",
                        argv, os.path.join(tmp, "ck1"))
    check(l1 == generations(ns, block, group), "first checkpoint run launches")
    check_replay(r1)
    r2, l2, _ = run_cli("9c streaming --checkpoint_dir (resumes)", argv,
                        os.path.join(tmp, "ck2"))
    d_e = rel_err(r2.pod.energy[:20], r1.pod.energy[:20])
    print(f"    resume: K1 launches {l2} (the projection's {nb}); "
          f"energy[:20] max rel diff to 9b {d_e:.3e} (limit 1e-4); "
          f"num_valid {r2.pod.num_valid}")
    check(l2 == nb, "the resumed run loads the mean and every Gram row")
    check(r2.eig_route["vectors"].startswith("host top-k eigh"),
          "the resumed run takes the host eigen route")
    check(d_e <= 1e-4, "resumed energy[:20]")
    check_replay(r2)

    r3, l3, _ = run_cli("9d in-memory --checkpoint_dir",
                        MAIN_ARGS + ["--pallas", "--checkpoint_dir",
                                     os.path.join(tmp, "ck_mem")],
                        os.path.join(tmp, "ckmem"))
    d_a = float(np.abs(r3.A - mem.A).max())
    print(f"    checkpointed A vs phase 4's: max diff {d_a:.3e} (limit "
          f"1e-5); K1 launches {l3} (one per 256-step block)")
    check(d_a <= 1e-5, "checkpointed in-memory A vs phase 4")
    check(l3 == -(-ns // min(ns, 256)), "checkpointed generation launches")
    check_replay(r3)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def phase_flagship(dev, outdir):
    """Phase 10: the flagship through the CLI parser and run_pipeline, then
    the Lanczos routes against cuSOLVER's float64 solvers on its Gram."""
    import numpy as np
    import torch

    from pods_digital_filter_tpu_torch import streaming
    from pods_digital_filter_tpu_torch.ops import lanczos, pod
    from pods_digital_filter_tpu_torch.pipeline import resolve_profile

    ns = _opt(FLAGSHIP_ARGS, "-n")
    block = _opt(FLAGSHIP_ARGS, "--streaming_block")
    group = _opt(FLAGSHIP_ARGS, "--gram_group")
    res, launches, peak = run_cli("10 flagship", FLAGSHIP_ARGS, outdir)
    cfg = res.config
    np3 = 3 * cfg.plane.jma * cfg.plane.kma
    est = streaming.gram_pass_hbm_estimate(
        np3, block, group, 4, cfg.filt.nfx, ns,
        fused_tail=cfg.use_pallas and cfg.dtype == "float32")
    print(f"    Gram-pass memory estimate {est / 2 ** 30:.3f} GiB, measured "
          f"peak {peak / 2 ** 30:.3f} GiB (peak / estimate "
          f"{peak / est:.3f}); budget "
          f"{streaming.device_memory_budget(dev) / 2 ** 30:.3f} GiB")
    files = ["PODFS.dat", "PODFS_mean.prf", "POD.eigenvalues.dat",
             "POD.spatial_mean_field_velocity.vtk"] + [
        "PODFS_mode_%04d.prf" % (i + 1) for i in range(20)]
    have = [f for f in files if os.path.isfile(os.path.join(outdir, f))]
    print(f"    model files: {len(have)} of {len(files)}")
    check(len(have) == 24, "the 24 model files")
    check(res.pod.num_trunc == 20, "flagship num_trunc 20")
    with open(os.path.join(outdir, "PODFS_mean.prf")) as f:
        u0 = float(f.readlines()[11].split(",")[3])
    print(f"    first-row mean u = {u0:.6f} (0.5 * U0 = {0.5 * U0}); "
          f"num_valid {res.pod.num_valid}; K1 launches {launches} "
          f"(expected {generations(ns, block, group)})")
    check(abs(u0 - 0.5 * U0) < 0.02, "first-row mean u ~ 0.5 U0")
    check(launches == generations(ns, block, group),
          "K1 launched on every regeneration")
    check_replay(res)
    # what bounds the passes: the mean pass is nothing but generations, so
    # its time per block prices a generation; the Gram pass's remainder is
    # its tiles (the sub-diagonal tiles inside a panel included)
    nb = -(-ns // block)
    per_block = res.timer.times["streaming_mean"] / nb
    gram_gens = generations(ns, block, group) - 2 * nb
    flops = sum(2.0 * np3 * (min(g0 + group, nb) - g0) * block
                * (ns - g0 * block) for g0 in range(0, nb, group))
    tiles_s = res.timer.times["streaming_gram"] - gram_gens * per_block
    print(f"    per block generation {per_block:.4f} s (mean pass / {nb}); "
          f"Gram pass: {gram_gens} generations ~ "
          f"{gram_gens * per_block:.3f} s, tiles {flops:.3e} f32 FLOP in the "
          f"remaining {tiles_s:.3f} s = {flops / tiles_s / 1e12:.1f} TFLOP/s "
          f"(peak 67); generations in the run {launches * per_block:.3f} s "
          f"of {res.timer.times['streaming_pod']:.3f} s of streaming_pod")

    # the flagship Gram again (the run keeps none): the same mean, blocks
    # and products
    fields, _, filt, cfg, rotate = resolve_profile(cfg)
    m = torch.as_tensor(res.mean_field, device=dev).to(torch.float32)
    gen_c = streaming.make_centered_generator(cfg, fields, filt, block, ns,
                                              rotate, m, device=dev)
    t_gram, (_, C_dev) = _timed(lambda: streaming.streamed_gram(
        gen_c, ns, block, group=group, return_device=True, keep_host=False))
    C = streaming.symmetrize_gram_device(C_dev, ns)
    del C_dev, gen_c
    C64 = C.double()
    # in turns, each twice: the first call of a solver pays its set-up
    solvers = {"lanczos_full_spectrum_s": lambda: lanczos.full_spectrum(C),
               "lanczos_topk20_s": lambda: lanczos.topk_or_none(C, 20),
               "cusolver_eigvalsh_f64_s": lambda: torch.linalg.eigvalsh(C64),
               "cusolver_eigh_f64_s": lambda: torch.linalg.eigh(C64)}
    times, outs = {k: [] for k in solvers}, {}
    for name in list(solvers) + list(solvers)[::-1]:
        dt, outs[name] = _timed(solvers[name])
        times[name].append(round(dt, 4))
    e_lz = outs["lanczos_full_spectrum_s"]
    e_k = outs["lanczos_topk20_s"][0]
    e_cs = outs["cusolver_eigvalsh_f64_s"].cpu().numpy()[::-1].copy()
    e_cs2 = outs["cusolver_eigh_f64_s"][0].cpu().numpy()[::-1].copy()
    check(e_lz is not None and e_k is not None, "the Lanczos gates passed")
    nv = {name: pod.count_valid_modes(e, 1e-15)
          for name, e in (("lanczos", e_lz), ("eigvalsh", e_cs))}
    floor, above = noise_floor_counts(ns, e_cs[0], e_lz, e_cs,
                                      res.pod.energy)
    out = {"gram_rebuild_s": t_gram, **times,
           "full_vs_eigvalsh_top20_max_rel": rel_err(e_lz[:20], e_cs[:20]),
           "topk_vs_eigh_top20_max_rel": rel_err(e_k, e_cs2[:20]),
           "full_vs_eigvalsh_all_max_abs_over_l0": float(
               np.abs(e_lz - e_cs).max() / e_cs[0]),
           "num_valid_lanczos": nv["lanczos"],
           "num_valid_cusolver": nv["eigvalsh"],
           "num_valid_run": res.pod.num_valid,
           "f32_noise_floor": floor,
           "above_floor_lanczos_cusolver_run": above,
           "smallest_eigvalsh": float(e_cs[-1]),
           "largest_eigvalsh": float(e_cs[0])}
    print("phase 10 Lanczos vs cuSOLVER (f64) on the flagship Gram "
          + json.dumps(out), flush=True)
    del C, C64, outs


#: phase 11's sizes.  11a: replay steps of phase 4's model.  11b: the model
#: of benchmarks/bench_replay.py:37-58 (256x128 points, 50 modes, 21
#: coefficients a mode, 512 steps a call).  11c: the compress CLI's inflow
#: files (cells of phase 4's plane, snapshots).  11d: the hex volume (cells
#: a side), its snapshots and the plane's resolution.  11e: the signals'
#: length, the polar mesh (axial, radial, azimuthal), phase_average's CPU
#: sub-plane and the noise scan (phase 4's plane and filter).
SLICE4 = dict(replay_steps=64,
              replay_bench=dict(npts=256 * 128, nm=50, kmax=21, nsteps=512),
              inflow=dict(ncell=4096, ns=256),
              volume=dict(n=64, ns=32, res=50),
              signal=2 ** 16, polar=(8, 64, 256), sub=4096,
              scan=dict(jma=512, kma=512, nf=8, nsteps=1024, block=256))


def _fourier_series(fr, ts, period):
    """(Nt, nm) temporal factors of an in-memory FourierResult at times
    ``ts``: the kept coefficients' series, as the replay equation sums it."""
    import numpy as np

    return np.stack([np.real(np.exp(2j * np.pi * np.outer(ts, fr.wavenumbers(i))
                                    / period) @ fr.kept_coeffs(i))
                     for i in range(fr.num_modes)], axis=1)


def _write_prf_model(outdir, model):
    """A PODFSModel as the .prf flavor (PODFS.dat, mean and mode files), in
    the layout of ``io/prf.write_podfs_dat``."""
    from pods_digital_filter_tpu_torch.io.prf import write_field_prf

    os.makedirs(outdir, exist_ok=True)
    npts, ns = model.num_points, model.num_slots
    table = lambda packed: packed.reshape(ns, npts).T
    lines = [str(model.num_modes), str(float(model.period))]
    lines += [f"{i + 1}\t{int(n)}" for i, n in enumerate(model.counts)]
    for i, n in enumerate(model.counts):
        lines += [f"{int(model.k[i, j])}\t{float(model.c_re[i, j])}\t"
                  f"{float(model.c_im[i, j])}" for j in range(int(n))]
    with open(os.path.join(outdir, "PODFS.dat"), "w") as f:
        f.write("\n".join(lines))
    write_field_prf(os.path.join(outdir, "PODFS_mean.prf"), "PODFS_mean",
                    model.points, table(model.mean))
    for i in range(model.num_modes):
        write_field_prf(os.path.join(outdir, "PODFS_mode_%04d.prf" % (i + 1)),
                        "PODFS_mode", model.points, table(model.modes[i]))


def _packed(fields):
    """(Nt, Np, S) replayed fields -> (S*Np, Nt) snapshot columns."""
    return fields.transpose(0, 2, 1).reshape(fields.shape[0], -1).T


def phase_replay(mem, outdir, tmp):
    """Phase 11a-b: the replay CLI on phase 4's model against the C
    replayer and the in-memory result; replay throughput at
    benchmarks/bench_replay.py's size."""
    import numpy as np
    import torch

    from pods_digital_filter_tpu_torch import native, replay

    nsteps = SLICE4["replay_steps"]
    rdir = os.path.join(tmp, "replayed")
    wall, _ = _timed(lambda: replay.main([outdir, "-n", str(nsteps), "--format",
                                          "npy", "--outdir", rdir]))
    fields = np.load(os.path.join(rdir, "fields.npy"))
    ts = np.load(os.path.join(rdir, "times.npy"))
    # the CLI's load and replay again, each timed; its write (403 MB of
    # .npy at the full size) is the rest of its wall
    t_load, model = _timed(lambda: replay.load_model(outdir))
    t_replay, again = _timed(lambda: replay.Replayer(model).batch(ts))
    t_write = wall - t_load - t_replay
    check(np.array_equal(again, fields), "the CLI's fields == Replayer.batch")
    del again
    t_c, c = _timed(lambda: native.NativePODFSReplayer(outdir))
    with c:
        t_ce, cf = _timed(lambda: c.eval_batch(ts))
    d_c = float(np.abs(cf - fields).max())
    fr = mem.fourier
    want = (mem.mean_field[:, None] + mem.pod.spatial_modes
            @ _fourier_series(fr, ts, fr.period).T)
    d_mem = float(np.abs(_packed(fields) - want).max())
    print(f"phase 11a replay CLI: {nsteps} steps of phase 4's model "
          f"({model.num_modes} modes, {model.num_points} points, f64 on the "
          f"card) in {wall:.3f} s; load {t_load:.3f} s, replay (Replayer and "
          f"batch, with the copy to the host) {t_replay:.3f} s, write (the "
          f"rest) {t_write:.3f} s; "
          f"C replayer load {t_c:.3f} s, eval {t_ce:.3f} s; max |CLI - C| = "
          f"{d_c:.3e} (limit 1e-9); max |CLI - in-memory model| = {d_mem:.3e} "
          f"(limit 1e-6)", flush=True)
    check(d_c < 1e-9, "replay CLI vs the C replayer")
    check(d_mem < 1e-6, "replay CLI vs the in-memory model")

    # 11b: throughput at bench_replay.py's size (its synthetic model)
    b = SLICE4["replay_bench"]
    rng = np.random.RandomState(3)
    k = np.tile(np.arange(b["kmax"]) - b["kmax"] // 2, (b["nm"], 1)).astype(float)
    points = rng.standard_normal((b["npts"], 3))
    mean = rng.standard_normal(3 * b["npts"])
    modes = rng.standard_normal((b["nm"], 3 * b["npts"]))
    c_re = rng.standard_normal((b["nm"], b["kmax"])) / (1.0 + np.abs(k))
    c_im = rng.standard_normal((b["nm"], b["kmax"])) / (1.0 + np.abs(k))
    fc = [np.column_stack([k[i], c_re[i], c_im[i]]) for i in range(b["nm"])]
    synth = replay.PODFSModel.from_arrays(points, mean, modes, 1.0, fc)
    bdir = os.path.join(tmp, "bench_replay_model")
    _write_prf_model(bdir, synth)
    model = replay.load_prf(bdir)
    ts = np.linspace(0.0, 0.9, b["nsteps"])
    n_out = b["nsteps"] * 3 * b["npts"]
    rate = lambda seconds: b["npts"] * b["nsteps"] / seconds
    out = {}
    sync = torch.cuda.synchronize
    for dt in (torch.float64, torch.float32):
        rp = replay.Replayer(model, dtype=dt)
        ms, dev_out = cuda_ms(lambda: rp.batch_device(ts), sync, 5)
        # host times are uploaded by a blocking copy, which drains the queue
        # on every call, so ``ms`` holds each call's host launch time too;
        # with the times already on the card the calls queue behind the spin
        ts_card = torch.as_tensor(ts, dtype=dt, device=dev_out.device)
        card_ts_ms, card_out = cuda_ms(lambda: rp.batch_device(ts_card), sync, 5)
        check(torch.equal(card_out, dev_out), "batch_device: times on the card "
              "== times from the host")
        esize = dev_out.element_size()
        # bytes: the modes and mean read once, the fields written once;
        # operations: the (Nt, nm) @ (nm, 3 Np) product
        b_ms, b_by = bound((modes.size + 3 * b["npts"] + n_out) * esize,
                           2.0 * n_out * b["nm"], "f64" if esize == 8 else "f32")
        t_host, host = _timed(lambda: rp.batch(ts))
        # where batch_device's time goes: the product alone, and the product
        # with the mean added in its epilogue (one torch.addmm)
        dev = dev_out.device
        mt = torch.as_tensor(model.modes, dtype=dt, device=dev)
        mean_t = torch.as_tensor(model.mean, dtype=dt, device=dev)
        bt = torch.randn(b["nsteps"], b["nm"], dtype=dt, device=dev)
        gemm_ms, _ = cuda_ms(lambda: bt @ mt, sync, 5)
        addmm_ms, _ = cuda_ms(lambda: torch.addmm(mean_t, bt, mt), sync, 5)
        out[str(dt)[6:]] = {
            "batch_device_ms": ms, "card_ts_ms": card_ts_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "product_ms": gemm_ms, "addmm_ms": addmm_ms,
            "batch_ms": 1e3 * t_host,
            "batch_device_points_steps_per_s": rate(ms * 1e-3),
            "card_ts_points_steps_per_s": rate(card_ts_ms * 1e-3),
            "batch_points_steps_per_s": rate(t_host)}
        if dt == torch.float64:
            ref = host
        del dev_out, card_out, ts_card, rp, mt, mean_t, bt
    with native.NativePODFSReplayer(bdir) as c:
        t_c, cf = _timed(lambda: c.eval_batch(ts))
    d_c = float(np.abs(cf - ref).max())
    out["c_replayer"] = {"eval_batch_ms": 1e3 * t_c,
                         "points_steps_per_s": rate(t_c),
                         "max_abs_vs_f64": d_c}
    out["f32_max_abs_vs_f64"] = float(np.abs(host - ref).max())
    print(f"phase 11b replay throughput, {b['npts']} points x {b['nm']} modes "
          f"x {b['kmax']} coefficients, {b['nsteps']} steps a call "
          + json.dumps(out), flush=True)
    check(d_c < 1e-9 * float(np.abs(ref).max()), "C replayer vs the card (f64)")
    torch.cuda.empty_cache()


def phase_compress(dev, mem, outdir, tmp):
    """Phase 11c-d: compression of phase 4's snapshots at full size, the
    compress CLI through inflow files, and plane extraction -> weighted
    compression -> replay."""
    import numpy as np
    import torch

    from pods_digital_filter_tpu_torch import compress, replay
    from pods_digital_filter_tpu_torch.postproc import planes, probes
    from pods_digital_filter_tpu_torch.variables import VariableSet

    cfg = mem.config
    geom = mem.geometry
    cdir = os.path.join(tmp, "compressed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # phase 4's snapshots: its centred A plus its mean, made on the card
    A = torch.as_tensor(mem.A, device=dev)
    A += torch.as_tensor(mem.mean_field, dtype=A.dtype, device=dev)[:, None]
    wall, (pr, fr, _) = _timed(lambda: compress.compress_snapshot_matrix(
        A, geom.cell_centers, mem.dt, 20, 0.9, cdir, device="cuda"))
    del A
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    d_e = rel_err(pr.energy[:20], mem.pod.energy[:20])
    ts = np.linspace(0.0, mem.fourier.period, 64, endpoint=False)
    r_c = replay.Replayer(replay.load_prf(cdir)).batch(ts)
    r_4 = replay.Replayer(replay.load_prf(outdir)).batch(ts)
    d_r = float(np.abs(r_c - r_4).max())
    counts_equal = bool(np.array_equal(fr.counts, mem.fourier.counts))
    print(f"phase 11c compress_snapshot_matrix on phase 4's snapshots "
          f"({3 * geom.num_cells} x {cfg.nsteps}, f32, on the card): "
          f"{wall:.3f} s, peak device memory {peak / 2 ** 30:.3f} GiB; "
          f"energy[:20] max rel diff to phase 4 {d_e:.3e} (limit 1e-5); "
          f"Fourier counts equal: {counts_equal}; replay of both models at 64 "
          f"times: max diff {d_r:.3e} (limit 1e-5)", flush=True)
    check(d_e <= 1e-5, "compressed energy[:20] vs phase 4")
    check(d_r < 1e-5, "compressed model replays phase 4's")

    # the compress CLI through inflow.%06i files: cells x snapshots of phase
    # 4's plane, made rank 20 (its truncated POD), so the model (-m 20 -e 1)
    # must give the input back
    ncell, ns = SLICE4["inflow"]["ncell"], SLICE4["inflow"]["ns"]
    rows = np.concatenate([np.arange(ncell) + c * geom.num_cells
                           for c in range(3)])
    X = mem.A[rows, :ns].astype(np.float64)
    X -= X.mean(axis=1, keepdims=True)
    lam, V = np.linalg.eigh(X.T @ X)
    V = V[:, ::-1][:, :20]
    X = mem.mean_field[rows, None] + (X @ V) @ V.T
    idir = os.path.join(tmp, "inflow")
    t_w, _ = _timed(lambda: probes.write_inflow_data(X, ncell, 3, idir))
    np.savetxt(os.path.join(idir, "points.txt"), geom.cell_centers[:ncell])
    odir = os.path.join(tmp, "compressed_cli")
    t_cli, rc = _timed(lambda: compress.main([
        "--input-dir", idir, "--num-snapshots", str(ns), "--num-cells",
        str(ncell), "--dt", repr(mem.dt), "--points",
        os.path.join(idir, "points.txt"), "-m", "20", "-e", "1.0",
        "--outdir", odir]))
    check(rc == 0, "compress CLI")
    got = _packed(replay.Replayer(replay.load_prf(odir)).batch(
        np.arange(ns) * mem.dt))
    d_cli = float(np.abs(got - X).max())
    scale = float(np.abs(X - mem.mean_field[rows, None]).max())
    print(f"phase 11c compress CLI: {ns} inflow files of {ncell} cells written "
          f"in {t_w:.3f} s, read and compressed (-m 20 -e 1) in {t_cli:.3f} s; "
          f"replay at the snapshot times vs the rank-20 input: max diff "
          f"{d_cli:.3e} (limit {1e-5 * scale:.3e}, 1e-5 of max |X - mean|)",
          flush=True)
    check(d_cli <= 1e-5 * scale, "compress CLI model gives its input back")

    # 11d: a synthetic hex volume of n^3 cells (nodes jittered by up to a
    # tenth of a cell), two travelling patterns; save_planes -> compress
    # with the plane's cell areas -> replay
    n, ns, res = (SLICE4["volume"][k] for k in ("n", "ns", "res"))
    dt = 1e-3
    rng = np.random.default_rng(11)
    g = np.linspace(0.0, 1.0, n + 1)
    nodes = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1)
    nodes = nodes + rng.uniform(-0.05, 0.05, nodes.shape) / n
    cells = sum(nodes[i:n + i, j:n + j, k:n + k]
                for i in (0, 1) for j in (0, 1) for k in (0, 1)) / 8.0
    pts = cells.reshape(-1, 3)
    x, y, z = pts.T
    phi1 = np.stack([np.sin(np.pi * y), np.cos(np.pi * z), y * z], axis=1)
    phi2 = np.stack([z - y, np.sin(2 * np.pi * x), np.cos(np.pi * y)], axis=1)
    mean_v = np.stack([1.0 + 0.2 * y, 0.1 * z, 0.05 * x], axis=1)
    spec = planes.PlaneSpec("inlet", (1.0, 0.0, 0.0), save=False, pod=True)
    vs = VariableSet.parse("velocity:3,k,epsilon")
    pod_matrix = {"inlet": np.zeros((vs.num_slots * res * res, ns))}
    t_all = time.perf_counter()
    t_first = None
    for i in range(ns):
        a1, a2 = np.cos(2 * np.pi * i / 8), np.sin(2 * np.pi * i / 4)
        vel = mean_v + a1 * phi1 + a2 * phi2
        fields = {"velocity": vel, "k": 0.5 + 0.1 * a1 * x,
                  "epsilon": 0.2 + 0.05 * a2 * y}
        planes.save_planes(pts, fields, [spec], i * dt, i, tmp,
                           pod_matrix=pod_matrix, resolution=res,
                           pod_vars=["velocity", "k", "epsilon"])
        if t_first is None:
            t_first = time.perf_counter() - t_all
    t_all = time.perf_counter() - t_all
    plane = planes.extract_plane(pts, {"k": fields["k"]}, spec.normal,
                                 resolution=res)
    areas, centres = plane.areas()
    P = pod_matrix["inlet"]
    pdir = os.path.join(tmp, "compressed_planes")
    t_pc, _ = _timed(lambda: compress.compress_snapshot_matrix(
        P, centres, dt, 2, 1.0, pdir, cell_weights=areas, varset=vs,
        device="cuda"))
    got = _packed(replay.Replayer(replay.load_prf(pdir)).batch(np.arange(ns) * dt))
    d_p = float(np.abs(got - P).max())
    scale = float(np.abs(P).max())
    print(f"phase 11d plane extraction: {pts.shape[0]} cells, {ns} snapshots "
          f"x 3 fields to a {res}x{res} plane in {t_all:.3f} s (the first, "
          f"with the triangulation, {t_first:.3f} s); weighted compression "
          f"(5 slots, 2 modes, on the card) {t_pc:.3f} s; replay vs the plane "
          f"snapshots: max diff {d_p:.3e} (limit {1e-5 * scale:.3e})", flush=True)
    check(d_p <= 1e-5 * scale, "plane extraction -> compress -> replay")
    torch.cuda.empty_cache()


def phase_numerics(dev, mem):
    """Phase 11e: the signal and time numerics on the card against the same
    port functions on the CPU in float64."""
    import numpy as np
    import torch

    from pods_digital_filter_tpu_torch.ops import filters, signal
    from pods_digital_filter_tpu_torch.parallel import time_ops

    out = {}
    rng = np.random.default_rng(5)
    x = rng.standard_normal(SLICE4["signal"])
    y = np.roll(x, 7) + 0.5 * rng.standard_normal(x.size)
    for name in ("welch_psd", "welch_csd", "coherence", "cross_correlation"):
        fn = getattr(signal, name)
        args = (x,) if name == "welch_psd" else (x, y)
        t, got = _timed(lambda: fn(*args, 1000.0, 1024, 2, device="cuda"))
        want = fn(*args, 1000.0, 1024, 2, device="cpu")
        g, w = got[1].cpu().numpy(), want[1].numpy()
        out[name] = {"rel": float(np.abs(g - w).max() / np.abs(w).max()), "s": t}
        check(out[name]["rel"] <= 1e-10, f"{name} on the card vs the CPU")

    axiseg, rseg, aziseg = SLICE4["polar"]
    npts = axiseg * (rseg * aziseg + 1) + 1
    u = rng.standard_normal((npts, 1))
    theta = rng.uniform(0.0, 2 * np.pi, npts)
    idx = signal._ring_index(axiseg, rseg, aziseg)
    theta[idx] = np.sort(theta[idx], axis=-1)
    r, xa = rng.uniform(0.1, 1.0, npts), rng.standard_normal(npts)
    t_a, (m_a, _, _) = _timed(lambda: signal.azimuthal_fourier_series(
        u, r, theta, xa, 1, axiseg, rseg, aziseg, device="cuda"))
    t_l, (m_l, _, _) = _timed(lambda: signal.azimuthal_fourier_series_loop(
        u, r, theta, xa, 1, axiseg, rseg, aziseg))
    out["azimuthal"] = {"mesh": [axiseg, rseg, aziseg],
                        "rel": float(np.abs(m_a - m_l).max()
                                     / np.abs(m_l).max()),
                        "s": t_a, "loop_s": t_l}
    check(out["azimuthal"]["rel"] <= 1e-10, "azimuthal vs the loop")

    # phase_average of phase 4's snapshots (f32, 64 steps a period) against
    # the CPU in f64 on a sub-plane
    cfg = mem.config
    npl, ns = mem.geometry.num_cells, cfg.nsteps
    tv = np.arange(ns) * mem.dt
    freq = 1.0 / (64 * mem.dt)
    B = torch.as_tensor(mem.A, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_pa, pa = _timed(lambda: time_ops.phase_average(B, tv, freq, npl,
                                                     device="cuda"))
    peak = torch.cuda.max_memory_allocated()
    sub = SLICE4["sub"]
    rows = torch.as_tensor(np.concatenate([np.arange(sub) + c * npl
                                           for c in range(3)]), device=dev)
    ref = time_ops.phase_average(mem.A[rows.cpu().numpy()].astype(np.float64),
                                 tv, freq, sub, device="cpu")
    errs = {}
    for name in ("v_phase", "nrs_phase", "crs_phase", "B_fluct", "nrs", "crs"):
        g = getattr(pa, name)[rows].double().cpu().numpy()
        w = getattr(ref, name).numpy()
        errs[name] = float(np.abs(g - w).max() / np.abs(w).max())
    out["phase_average"] = {"s": t_pa, "peak_gib": peak / 2 ** 30,
                            "num_phase": int(pa.v_phase.shape[1]),
                            "dtype": str(pa.v_phase.dtype), "rel": errs}
    check(max(errs.values()) <= 1e-5, "phase_average on the card vs the CPU")
    del B, pa, rows
    torch.cuda.empty_cache()

    # the overlap-save scan against the batched generator (f32)
    sc = SLICE4["scan"]
    nf, ln = sc["nf"], sc["nf"] / 2.0
    a = (sc["jma"], sc["kma"], nf, nf, nf, ln, ln, ln)
    t_b, full = _timed(lambda: filters.generate_correlated_noise(
        7, 0, sc["nsteps"], *a, device="cuda"))
    t_s, scan = _timed(lambda: filters.generate_correlated_noise_scan(
        7, sc["nsteps"], sc["block"], *a, device="cuda"))
    out["noise_scan"] = {**sc, "max_abs": float((scan - full).abs().max()),
                         "scan_s": t_s, "batched_s": t_b}
    del full, scan
    torch.cuda.empty_cache()
    print("phase 11e numerics, card vs CPU float64 " + json.dumps(out),
          flush=True)
    check(out["noise_scan"]["max_abs"] <= 1e-5,
          "generate_correlated_noise_scan vs generate_correlated_noise")


def phase_plots(tmp):
    """Phase 11f: the CLI with -v at a small size (K1 counted); its POD
    plots, or, on a machine without matplotlib, the line that says they
    were skipped (the only error caught, and printed)."""
    import importlib.util

    from pods_digital_filter_tpu_torch import cli
    from pods_digital_filter_tpu_torch.ops import fused_filter

    h5py = importlib.util.find_spec("h5py") is not None
    try:
        import matplotlib
    except ImportError:
        matplotlib = None
        print(f"phase 11f plots: matplotlib is absent on this machine, so the "
              f"-v plots are skipped (h5py present: {h5py})", flush=True)
    out = os.path.join(tmp, "verbose")
    fused_filter.LAUNCHES = 0
    check(cli.main(["-j", "32", "-k", "24", "-n", "64", "-m", "3", "-v",
                    "--pallas", "--device", "cuda", "--outdir", out]) == 0,
          "-v run")
    launches = fused_filter.LAUNCHES
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    print(f"phase 11f plots: matplotlib "
          f"{getattr(matplotlib, '__version__', 'absent')}, h5py present: "
          f"{h5py}; -v --pallas run: K1 launches {launches}, {len(pngs)} PNGs",
          flush=True)
    check(launches > 0, "the -v run launched K1")
    if matplotlib is not None:
        want = ["POD_mode_energies.png"] + [
            f"POD_{k}{j}.png" for j in range(3)
            for k in ("PSD_mode_", "tmode_recon")]
        check(set(want) <= set(pngs), "the -v POD plots")


def phase_slice4(dev, mem, outdir, tmp):
    """Phase 11: slice 4 on the card, on phase 4's model and result."""
    t = time.perf_counter()
    phase_replay(mem, outdir, tmp)
    phase_compress(dev, mem, outdir, tmp)
    phase_numerics(dev, mem)
    phase_plots(tmp)
    print(f"phase 11 done in {time.perf_counter() - t:.1f} s", flush=True)


#: phase 12: the sharded paths.  12b/12c at the main size on a 2 x 2 mesh,
#: 12d with --halo on 1 x 4, 12e the Gram store filled on 2 x 2 and resumed
#: on 1 x 4 at a 256 x 256 plane
MESH_2X2 = ["--shard_time", "2", "--shard_space", "2"]
MESH_1X4 = ["--shard_space", "4"]
SHARD_STREAM = ["--streaming_block", "256", "--gram_group", "2",
                "--eig_mode", "topk"]
CKPT_ARGS = ["-j", "256", "-k", "256", "-n", "1024", "-l", "4", "-f", "2",
             "-m", "20", "-e", "0.9"] + SHARD_STREAM
#: every rank of 12b-12e on card 0: four ranks share it (gloo)
SHARD_DEVICE = "cuda:0"


def _rank_pieces(mesh, X, cols):
    """This rank's columns ``cols`` (global k) of the tile ``X``, as
    ``{k: X[..., k_local]}`` in float64 numpy."""
    tk = X.shape[-1]
    k0 = mesh.si * tk
    return {k: X[..., k - k0].double().cpu().numpy()
            for k in cols if k0 <= k < k0 + tk}


def _halo_stats(res):
    """12d in the ranks: the run's fields made again on the mesh (the run
    keeps none), and rank 0 gets the core columns' u, w and both edge
    columns of v of every tile."""
    import torch.distributed as dist

    from pods_digital_filter_tpu_torch.parallel import streaming as sstream
    from pods_digital_filter_tpu_torch.pipeline import resolve_profile

    mesh = res.mesh
    fields, _, filt, cfg, rotate = resolve_profile(res.config)
    X = sstream.make_sharded_generator(cfg, fields, filt, mesh, cfg.nsteps,
                                       rotate=rotate)(0)
    kma, tk = cfg.plane.kma, X.shape[-1]
    core = range(kma // 2 - 3, kma // 2 + 4)
    mine = {"u": _rank_pieces(mesh, X[0], core),
            "w": _rank_pieces(mesh, X[2], core),
            "v": _rank_pieces(mesh, X[1], (mesh.si * tk,
                                            mesh.si * tk + tk - 1))}
    del X
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, mine)
    merged = {c: {k: a for p in parts for k, a in p[c].items()}
              for c in ("u", "w", "v")}
    return dict(fields=fields, core=list(core), tk=tk, **merged)


def _sharded_rank(runs):
    """Phase 12 in one rank of a 4-rank job on the card: each ``(label,
    argv)`` of ``runs`` through the CLI parser and ``run_pipeline`` (the
    mesh shape from its flags, so 2 x 2 and 1 x 4 runs share the job).
    A run ``(label, argv, False)`` finds no room for the dense eigen
    solve.  Returns, from rank 0, each run's result (its mesh dropped) with every
    rank's peak device memory, wall, K1 launches and block generations."""
    import torch
    import torch.distributed as dist

    from pods_digital_filter_tpu_torch import cli
    from pods_digital_filter_tpu_torch.ops import fused_filter
    from pods_digital_filter_tpu_torch.parallel import streaming as sstream
    from pods_digital_filter_tpu_torch.parallel.mesh import make_mesh
    from pods_digital_filter_tpu_torch.pipeline import run_pipeline

    real = sstream.make_sharded_generator
    out = []
    for run in runs:
        label, argv = run[:2]
        dense = run[2] if len(run) > 2 else True
        args = cli.build_parser().parse_args(argv)
        cfg = cli.config_from_args(args)
        calls = []

        def counting(*a, **kw):
            gen = real(*a, **kw)
            return lambda t0: calls.append(t0) or gen(t0)

        # the mesh (made once; run_pipeline takes the same) picks the
        # rank's card before its first CUDA call
        make_mesh(cfg.shard_time, cfg.shard_space, args.device)
        sstream.make_sharded_generator = counting
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_filter.LAUNCHES = 0
        t = time.perf_counter()
        try:
            with contextlib.nullcontext() if dense else no_dense_eigh():
                res = run_pipeline(cfg, device=args.device)
            torch.cuda.synchronize()
        finally:
            sstream.make_sharded_generator = real
        wall = time.perf_counter() - t
        launches = fused_filter.LAUNCHES
        mine = (torch.cuda.max_memory_allocated(), wall, launches, len(calls))
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        stats = _halo_stats(res) if "--halo" in argv else None
        mesh = res.mesh
        res.mesh = None
        out.append(dict(label=label, res=res, ranks=ranks, stats=stats,
                        backend=mesh.backend, devices=mesh.devices,
                        shape=mesh.shape))
    return out


def replay_diff(dir_a, dir_b, ns, dt):
    """Max |replay a - replay b| over 300 points x ``ns`` steps, and the
    field's scale (max |replay b|)."""
    import numpy as np

    def replayed(d):
        period, fc, mean, modes = _read_model(d)
        npts = mean.shape[0] // 3
        pts = np.random.default_rng(0).choice(npts, min(300, npts),
                                              replace=False)
        rows = np.concatenate([pts + c * npts for c in range(3)])
        t = np.arange(ns) * dt
        a = np.stack([np.real(sum((re + 1j * im)
                                  * np.exp(2j * np.pi * k * t / period)
                                  for k, re, im in tab)) for tab in fc],
                     axis=1)
        return mean[rows, None] + modes[rows] @ a.T

    a, b = replayed(dir_a), replayed(dir_b)
    return float(np.abs(a - b).max()), float(np.abs(b).max())


def _print_run(r):
    res = r["res"]
    stages = {k: round(v, 4) for k, v in res.timer.times.items()}
    ranks = r["ranks"]
    print(f"phase {r['label']}: mesh {r['shape']['t']}x{r['shape']['s']}, "
          f"backend {r['backend']}; wall per rank (s) "
          f"{[round(x[1], 3) for x in ranks]}; peak device memory per rank "
          f"(GiB) {[round(x[0] / 2 ** 30, 3) for x in ranks]}; K1 launches "
          f"{[x[2] for x in ranks]}; block generations per rank "
          f"{[x[3] for x in ranks]}; rank 0 stages (s) " + json.dumps(stages),
          flush=True)
    if res.eig_route is not None:
        print(f"    eigen route: {json.dumps(res.eig_route)}")
    check(all(x[2] == 0 for x in ranks),
          "the sharded paths launch no K1 (the torch-ops generator)")


def check_against(r, oracle, what):
    """12b/12c: a main-size run against phase 5's result ``oracle``."""
    import numpy as np

    res = r["res"]
    ns = res.config.nsteps
    scale = float(np.abs(oracle["mean"]).max())
    d_mean = float(np.abs(res.mean_field - oracle["mean"]).max())
    d_e = rel_err(res.pod.energy[:20], oracle["energy"][:20])
    floor, counts = noise_floor_counts(ns, oracle["energy"][0],
                                       res.pod.energy, oracle["energy"])
    d_rep, fscale = replay_diff(res.config.outdir, oracle["outdir"], ns,
                                res.dt)
    print(f"    vs phase 5: max |mean - mean_5| = {d_mean:.3e} (limit "
          f"{1e-5 * scale:.3e}); energy[:20] max rel diff {d_e:.3e} (limit "
          f"1e-4); num_trunc {res.pod.num_trunc} vs {oracle['num_trunc']}; "
          f"num_valid {res.pod.num_valid} vs {oracle['num_valid']}; "
          f"eigenvalues above the f32 noise floor {floor:.3e}: {counts[0]} "
          f"vs {counts[1]}; replay of the written model vs phase 5's: max "
          f"diff {d_rep:.3e} = {d_rep / fscale:.3e} of the field's scale "
          f"{fscale:.4f} (limit 1e-4)")
    check(d_mean <= 1e-5 * scale, f"{what}: mean vs phase 5")
    check(d_e <= 1e-4, f"{what}: energy[:20] vs phase 5")
    check(res.pod.num_trunc == oracle["num_trunc"], f"{what}: truncation")
    check(abs(counts[0] - counts[1]) <= 1,
          f"{what}: the same count above the f32 noise floor")
    check(d_rep <= 1e-4 * fscale, f"{what}: replay vs phase 5's model")
    check_replay(res)


def check_halo(r):
    """12d: the target stresses (check_stresses's bounds) and the
    correlation across each tile seam against the filter's
    autocorrelation (tests/test_multiprocess.py:151)."""
    import numpy as np
    import torch

    from pods_digital_filter_tpu_torch.ops import filters

    res, st = r["res"], r["stats"]
    cfg = res.config
    jma, kma = cfg.plane.jma, cfg.plane.kma
    fields = st["fields"]
    U_target = np.broadcast_to(np.asarray(fields.mean_u), (jma, kma))[0]
    uu_target = np.broadcast_to(np.asarray(fields.uu), (jma, kma))[0]
    U_mean = res.mean_field[:jma * kma].reshape(jma, kma).mean(axis=0)
    core = st["core"]
    fluct = lambda a: a - a.mean(axis=0, keepdims=True)   # over time
    u = np.stack([fluct(st["u"][k]) for k in core], axis=-1)
    w = np.stack([fluct(st["w"][k]) for k in core], axis=-1)
    uu_meas = float((u * u).mean())
    uu_tgt = float(np.mean(uu_target[core]))
    uw = (u * w).mean(axis=0)
    err_U = float(np.abs(U_mean - U_target).max())
    b = filters.gaussian_fir_coeffs(cfg.filt.nfz, cfg.filt.length_scale_z,
                                    torch.float64).numpy()
    want = float(np.sum(b[:-1] * b[1:]))
    seams = {}
    for edge in range(st["tk"], kma, st["tk"]):
        a, c = st["v"][edge - 1], st["v"][edge]
        seams[f"{edge - 1}|{edge}"] = float(
            np.sum(a * c) / np.sqrt(np.sum(a * a) * np.sum(c * c)))
    print(f"    stresses: max |U - U_target| = {err_U:.4f}; core uu "
          f"{uu_meas:.4e} vs target {uu_tgt:.4e}; uw field mean "
          f"{float(uw.mean()):.3e}, max |uw| {float(np.abs(uw).max()):.3e}; "
          f"v correlation across the tile seams {json.dumps(seams)} vs the "
          f"filter's {want:.4f} (limit 0.05)")
    check(err_U < 0.08, "halo: mean profile")
    check(abs(uu_meas - uu_tgt) < 0.25 * uu_tgt, "halo: core uu")
    check(abs(float(uw.mean())) < 0.05 * uu_tgt, "halo: uw field mean")
    check(float(np.abs(uw).max()) < 0.5 * uu_tgt, "halo: max |uw|")
    check(all(abs(g - want) < 0.05 for g in seams.values()),
          "halo: correlation across the tile seams")
    check_replay(res)


def phase_sharded(oracle, tmp):
    """Phase 12: the sharded paths through the CLI parser and
    ``run_pipeline`` in four ranks on the card, held to phase 5's result
    (the torch-ops generator's per-slab stream, which the exact path
    draws too)."""
    import torch

    from pods_digital_filter_tpu_torch.parallel import mesh as mesh_lib

    t = time.perf_counter()
    count = torch.cuda.device_count()
    d = lambda name: ["--outdir", os.path.join(tmp, name), "--device",
                      SHARD_DEVICE]
    ck = os.path.join(tmp, "ck_sharded")
    runs = [("12b 2x2 in memory", MAIN_ARGS + MESH_2X2 + d("s12b")),
            ("12c 2x2 streaming", MAIN_ARGS + MESH_2X2 + SHARD_STREAM
             + d("s12c")),
            ("12c' 2x2 streaming, no room for the dense solve",
             MAIN_ARGS + MESH_2X2 + SHARD_STREAM + d("s12c_lz"), False),
            ("12d 1x4 --halo in memory", MAIN_ARGS + MESH_1X4 + ["--halo"]
             + d("s12d")),
            ("12e 2x2 streaming --checkpoint_dir (fills)",
             CKPT_ARGS + MESH_2X2 + ["--checkpoint_dir", ck] + d("s12e1")),
            ("12e 1x4 streaming --checkpoint_dir (resumes)",
             CKPT_ARGS + MESH_1X4 + ["--checkpoint_dir", ck] + d("s12e2"))]
    t_spawn = time.perf_counter()
    out = mesh_lib.launch_local(_sharded_rank, 4, (runs,), deadline_s=900)
    spawn_s = time.perf_counter() - t_spawn
    b, c, c_lz, h, e1, e2 = out
    print(f"phase 12a: torch.cuda.device_count() = {count}; 4 ranks, "
          f"backend {b['backend']} (several ranks share a card: gloo, CUDA "
          f"tensors staged through the host); rank -> device "
          + json.dumps(dict(enumerate(b["devices"]))), flush=True)
    check(b["backend"] == ("nccl" if len(set(b["devices"])) == 4
                           else "gloo"), "the backend follows the layout")
    for r, check_fn in ((b, lambda r: check_against(r, oracle, "12b")),
                        (c, lambda r: check_against(r, oracle, "12c")),
                        (c_lz, lambda r: check_against(r, oracle, "12c'")),
                        (h, check_halo)):
        _print_run(r)
        check_fn(r)
    check(c["res"].eig_route["vectors"] == "device eigh on cuda (f64)",
          "12c: rank 0's device f64 eigh route ran")
    check_lanczos_fallback(c_lz["res"], "12c' (rank 0)")
    for r in (e1, e2):
        _print_run(r)
    ns, block, group = (_opt(CKPT_ARGS, f) for f in
                        ("-n", "--streaming_block", "--gram_group"))
    nb = -(-ns // block)
    gens1, gens2 = e1["ranks"][0][3], e2["ranks"][0][3]
    r1, r2 = e1["res"], e2["res"]
    d_e = rel_err(r2.pod.energy[:20], r1.pod.energy[:20])
    d_rep, fscale = replay_diff(r2.config.outdir, r1.config.outdir, ns,
                                r1.dt)
    print(f"    resume on 1x4: block generations {gens2} (the projection's "
          f"{nb}; the fill made {gens1}, expected "
          f"{generations(ns, block, group)}); energy[:20] max rel diff to "
          f"the fill {d_e:.3e} (limit 1e-4); replay vs the fill's model "
          f"{d_rep / fscale:.3e} of the field's scale (limit 1e-4)")
    check(gens1 == generations(ns, block, group), "12e fill generations")
    check(gens2 == nb, "12e: the resume loads the mean and every Gram row")
    check(r2.eig_route["vectors"].startswith("host top-k eigh (f64, Gram "
                                             "rows from the checkpoint"),
          "12e: the resume's eigen half reads the stored rows")
    check(d_e <= 1e-4 and d_rep <= 1e-4 * fscale, "12e: the same model")
    check_replay(r2)
    if count >= 2:
        world = 4 if count >= 4 else 2
        mesh = MESH_2X2 if world == 4 else ["--shard_space", "2"]
        nccl = mesh_lib.launch_local(
            _sharded_rank, world,
            ([("12f NCCL, one rank per card", MAIN_ARGS + mesh + [
                "--outdir", os.path.join(tmp, "s12f"), "--device",
                "cuda"])],), deadline_s=900)[0]
        _print_run(nccl)
        check(nccl["backend"] == "nccl", "12f: one rank per card takes NCCL")
        check_against(nccl, oracle, "12f")
        print(f"    12f walls per rank {[round(x[1], 3) for x in nccl['ranks']]}"
              f" s beside 12b's {[round(x[1], 3) for x in b['ranks']]} s")
    else:
        print("phase 12f: one card, so no NCCL run and no multi-GPU "
              "measurement took place")
    print(f"phase 12 done in {time.perf_counter() - t:.1f} s (the 4-rank "
          f"job {spawn_s:.1f} s, spawn and CUDA start-up included)",
          flush=True)


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
    "K5": ("fused_tail", "fused_tail.cu",
           "none (the JAX package leaves the generation tail to XLA)"),
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
    geometry(dev)
    worst, ms, plain_ms = phase_kernel(dev)
    tail = phase_tail(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches, mem_res = phase_main("4 main path --pallas", ["--pallas"],
                                       os.path.join(tmp, "fused"))
        f32_peak = torch.cuda.max_memory_allocated()
        check(launches > 0, "the main path launched K1")
        torch.cuda.empty_cache()
        plain_launches, plain = phase_main("5 main path, torch-ops generator",
                                           [], os.path.join(tmp, "plain"))
        check(plain_launches == 0, "the torch-ops path does not launch K1")
        # phase 12's oracle: the exact sharded path draws the same stream
        oracle = {"mean": plain.mean_field, "energy": plain.pod.energy,
                  "num_valid": plain.pod.num_valid,
                  "num_trunc": plain.pod.num_trunc,
                  "outdir": os.path.join(tmp, "plain")}
        del plain
        torch.cuda.empty_cache()
        record = phase_decomposition(dev)
        # K1 at the main path's shape (phase 3e): the f32 output write
        record["K1"] = (worst, ms, plain_ms, bound(
            3 * 1040 * 512 * 512 * 4, filter_work(1040, 512, 512, 8)), None)
        record["K5"] = (*tail, None)
        torch.cuda.empty_cache()
        bf16_launches, bf16_res = phase_main(
            "7 main path --pallas --dtype bfloat16",
            ["--pallas", "--dtype", "bfloat16"], os.path.join(tmp, "bf16"),
            check_bf16_taps)
        check(bf16_launches == 1, "the bf16 main path launched K1 once")
        bf16_peak = torch.cuda.max_memory_allocated()
        print(f"    peak {bf16_peak / 2 ** 30:.3f} GiB against phase 4's "
              f"{f32_peak / 2 ** 30:.3f} GiB")
        check(bf16_peak < f32_peak, "the bf16 route peaks below float32")
        phase_streaming_bf16(bf16_res, tmp)
        del bf16_res
        torch.cuda.empty_cache()
        exp_launches = phase_experiments()
        torch.cuda.empty_cache()
        phase_streaming(mem_res, tmp)
        torch.cuda.empty_cache()
        phase_slice4(dev, mem_res, os.path.join(tmp, "fused"), tmp)
        del mem_res
        torch.cuda.empty_cache()
        phase_sharded(oracle, tmp)
        phase_flagship(dev, os.path.join(tmp, "flagship"))
    counts = {"K1": launches, "K5": launches,
              **{k: exp_launches[k] for k in ("K2", "K3", "K4")}}
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
        "bound_ms": record[k][3][0],
        "bound_by": record[k][3][1],
        "library_ms": record[k][4],
    } for k in ("K1", "K2", "K3", "K4", "K5")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
