"""Port of ``benchmarks/exp_two_kernel_pipeline.py``: where the fused
noise + filter kernel's time goes, split into the pieces the TPU experiment
split it into, measured with the port's kernels on the card.

Variants (``EXP_VARIANTS``, default ``base,f32,bf16,xla``), each at the
``EXP_SIZES`` planes (default 512 and 256), NSTEPS + 2 NF slabs x 3
components, bfloat16 taps as in the original:

  base        -- K1, the production fused kernel (``fused_spatial``)
  f32, bf16   -- ``split_pipeline``: K1's raw mode writes the noise (f32 or
                 bf16) to device memory, then K2 runs the two products on it
  xla         -- ``torch_rng_pipeline``: framework noise (``torch.rand``),
                 then K2
  noise, noise16b, noise32, noise1seed, noprng, noisemin, storeonly,
  storef32    -- ``noise_only``: one noise probe (K3; ``noise32`` is K1's raw
                 mode) and a strided sum, no filter
  noisebatch  -- ``noise_batched``: K3's batched probe, 4 slabs per group
  store2d     -- ``store2d``: K3's constant store into the 2-D layout
  fuseddummy  -- ``fused_dummy_in``: K1 plus a cycling 8 x 128 input
  gemmonly    -- ``gemm_only``: K2 on constant noise
  fusednoprng -- ``fused_noprng``: K1 with an iota in place of the draw

``EXP_TEMPORAL=1`` runs ``run_fused_temporal`` instead: K4 (spatial filter
and temporal FIR in one kernel) against K1 followed by the FIR product.
The labels are the original's, ``xla_rng`` and "XLA temporal FIR"
included, so the two tables line up row by row.
"""

from __future__ import annotations

import os
import sys

import torch

from pods_digital_filter_tpu_torch.experiments._timing import (
    LN, NSTEPS, SQRT3, band_taps, device, env_int, env_list, timed)
from pods_digital_filter_tpu_torch.ops import (filters, fused_filter,
                                               fused_temporal as ft,
                                               noise_probe, toeplitz_gemm)

_BF16 = torch.bfloat16


def _shape(BzT, ByM):
    return ByM.shape[1], BzT.shape[0]          # jn, kn


def fused(seed, BzT, ByM, num_slabs, jma, kma, num_components):
    """K1 (the original's ``pf._fused_spatial``), taps of ByM's dtype."""
    by, bz = band_taps(ByM, BzT)
    return fused_filter.fused_spatial(seed, 0, num_slabs, jma, kma, by, bz,
                                      num_components, matmul_dtype=ByM.dtype)


def split_pipeline(seed, BzT, ByM, num_slabs, jma, kma, num_components,
                   noise_dtype=torch.float32):
    """Kernel A (K1's raw mode) writes the noise in ``noise_dtype``; kernel
    B (K2) runs the two products on it."""
    jn, kn = _shape(BzT, ByM)
    noise = fused_filter.raw_noise(seed, 0, num_slabs, jn, kn, num_components,
                                   BzT.device, noise_dtype)
    out = toeplitz_gemm.toeplitz_gemm(
        noise.view(num_components * num_slabs, jn, kn), BzT, ByM)
    return out.view(num_components, num_slabs, jma, kma)


def fused_noprng(seed, BzT, ByM, num_slabs, jma, kma, num_components):
    """K1 with the draw replaced by an iota (``_fused_body_noprng``); the
    seed does not enter, as in the original."""
    by, bz = band_taps(ByM, BzT)
    return fused_filter.fused_spatial_iota(num_slabs, jma, kma, by, bz,
                                           num_components, ByM.dtype)


def fused_dummy_in(seed, BzT, ByM, num_slabs, jma, kma, num_components):
    """K1 plus a cycling (8, 128) input per slab (``_fused_body_dummy_in``)."""
    by, bz = band_taps(ByM, BzT)
    dummy = torch.zeros((num_components * num_slabs, 8, 128),
                        dtype=torch.float32, device=BzT.device)
    return fused_filter.fused_spatial_dummy_in(seed, 0, num_slabs, jma, kma,
                                               by, bz, dummy, num_components,
                                               ByM.dtype)


def gemm_only(seed, BzT, ByM, num_slabs, jma, kma, num_components,
              noise=None):
    """K2 alone, on constant noise ``seed`` in the tap dtype unless given."""
    jn, kn = _shape(BzT, ByM)
    total = num_components * num_slabs
    if noise is None:
        noise = torch.full((total, jn, kn), float(seed), dtype=BzT.dtype,
                           device=BzT.device)
    return toeplitz_gemm.toeplitz_gemm(noise, BzT, ByM).view(
        num_components, num_slabs, jma, kma)


def store2d(seed, BzT, ByM, num_slabs, jma, kma, num_components):
    """K3's constant store into ``(jma, total * kma)``, then the original's
    ``[:, ::257] * seed`` epilogue."""
    out = noise_probe.store2d(num_slabs, jma, kma, num_components, BzT.device)
    return out[:, ::257] * seed


def _strided_sum(noise, num_components, num_slabs):
    """The originals' epilogue: ``sum(noise[:, ::64, ::64])`` broadcast to
    ``(C, S, 1, 1)``, so that nothing is skipped and little is added."""
    s = noise[:, ::64, ::64].to(torch.float32).sum()
    return s * torch.ones((num_components, num_slabs, 1, 1),
                          dtype=torch.float32, device=noise.device)


def noise_batched(seed, BzT, ByM, num_slabs, jma, kma, num_components,
                  noise_dtype=_BF16, g=4):
    """K3's batched probe: ``g`` slabs per group from one key."""
    jn, kn = _shape(BzT, ByM)
    noise = noise_probe.probe("batched", seed, 0, num_slabs, jn, kn,
                              num_components, noise_dtype, BzT.device, g)
    return _strided_sum(noise, num_components, num_slabs)


def noise_only(seed, BzT, ByM, num_slabs, jma, kma, num_components,
               noise_dtype=_BF16, body="noise"):
    """One noise probe alone plus a cheap reduce: K3's ``body``, or K1's raw
    mode for ``noise32`` (the port's production 32-bit draw)."""
    jn, kn = _shape(BzT, ByM)
    if body == "noise32":
        noise = fused_filter.raw_noise(seed, 0, num_slabs, jn, kn,
                                       num_components, BzT.device,
                                       noise_dtype).view(-1, jn, kn)
    else:
        noise = noise_probe.probe(body, seed, 0, num_slabs, jn, kn,
                                  num_components, noise_dtype, BzT.device)
    return _strided_sum(noise, num_components, num_slabs)


def torch_rng_pipeline(seed, BzT, ByM, num_slabs, jma, kma, num_components):
    """Port of ``xla_rng_pipeline``: framework noise, uniform(-sqrt3, sqrt3)
    in f32 from ``torch.rand`` on a ``torch.Generator`` seeded with
    ``seed``, cast to the tap dtype, then K2."""
    jn, kn = _shape(BzT, ByM)
    gen = torch.Generator(device=BzT.device)
    gen.manual_seed(seed)
    noise = torch.rand((num_components * num_slabs, jn, kn), generator=gen,
                       dtype=torch.float32, device=BzT.device)
    noise = (noise * (2.0 * SQRT3) - SQRT3).to(BzT.dtype)
    return toeplitz_gemm.toeplitz_gemm(noise, BzT, ByM).view(
        num_components, num_slabs, jma, kma)


def _loop(kernel_fn, BzT, ByM, num_slabs, jma, kma, **kw):
    """``seed -> output`` of one variant (the original's ``make_loop``
    body; the loop itself is in :func:`timed`)."""
    return lambda seed: kernel_fn(seed, BzT, ByM, num_slabs=num_slabs,
                                  jma=jma, kma=kma, num_components=3, **kw)


def _matrices(nf, jma, kma, dev, dtype=_BF16):
    bz = filters.gaussian_fir_coeffs(nf, LN, torch.float32, dev)
    ByM = filters.toeplitz_band(bz, jma).to(dtype)
    BzT = filters.toeplitz_band(bz, kma).T.contiguous().to(dtype)
    return bz, ByM, BzT


def main():
    nf = env_int("EXP_NF", "8")
    num_slabs = NSTEPS + 2 * nf
    sizes = tuple(int(s) for s in env_list("EXP_SIZES", "512,256"))
    variants = env_list("EXP_VARIANTS", "base,f32,bf16,xla")
    dev = device()
    for jma in sizes:
        kma = jma
        print(f"=== plane {jma}x{kma}, {num_slabs} slabs x3 comps ===",
              flush=True)
        _, ByM, BzT = _matrices(nf, jma, kma, dev)
        loop = lambda fn, **kw: _loop(fn, BzT, ByM, num_slabs, jma, kma, **kw)

        if "base" in variants and "f32" in variants:
            base = fused(1, BzT, ByM, num_slabs, jma, kma, 3)
            sp32 = split_pipeline(1, BzT, ByM, num_slabs, jma, kma, 3,
                                  noise_dtype=torch.float32)
            # one stream: the split differs from K1 only in the order of
            # the f32 sums before t is rounded to bf16
            err = float((base - sp32).abs().max())
            print(f"split_f32 max abs diff vs base: {err:.2e}", flush=True)
            del base, sp32

        ts = {}
        if "base" in variants:
            ts["base"] = timed(loop(fused), dev, label="base (fused)")
        if "f32" in variants:
            ts["f32"] = timed(loop(split_pipeline, noise_dtype=torch.float32),
                              dev, label="split_f32")
        if "bf16" in variants:
            ts["bf16"] = timed(loop(split_pipeline, noise_dtype=_BF16), dev,
                               label="split_bf16")
        if "xla" in variants:
            ts["xla"] = timed(loop(torch_rng_pipeline), dev, label="xla_rng")
        for nb in ("noise", "noise16b", "noise32", "noise1seed", "noprng",
                   "noisemin", "storeonly"):
            if nb in variants:
                ts[nb] = timed(loop(noise_only, noise_dtype=_BF16, body=nb),
                               dev, label=f"{nb}_only (bf16)")
        if "store2d" in variants:
            ts["store2d"] = timed(loop(store2d), dev,
                                  label="store2d (jma, kma) blocks")
        if "fuseddummy" in variants:
            ts["fuseddummy"] = timed(loop(fused_dummy_in), dev,
                                     label="fused+dummy_vmem_in")
        if "gemmonly" in variants:
            ts["gemmonly"] = timed(loop(gemm_only), dev,
                                   label="gemm_only (zeros noise)")
        if "fusednoprng" in variants:
            ts["fusednoprng"] = timed(loop(fused_noprng), dev,
                                      label="fused_noprng")
        if "storef32" in variants:
            ts["storef32"] = timed(
                loop(noise_only, noise_dtype=torch.float32, body="storeonly"),
                dev, label="storeonly_f32")
        if "noisebatch" in variants:
            ts["noisebatch"] = timed(loop(noise_batched, noise_dtype=_BF16, g=4),
                                     dev, label="noise_batched_g4 (bf16)")
        if "base" in ts and len(ts) > 1:
            best = min(v for k, v in ts.items() if k != "base")
            print(f"best speedup vs base: {ts['base'] / best:.3f}x",
                  flush=True)
    return 0


def run_fused_temporal():
    """K4 (``fused_temporal``, FIR in the kernel) against K1 followed by
    the temporal FIR as a product, at the first ``EXP_SIZES`` plane, bf16
    taps for both."""
    nf = env_int("EXP_NF", "8")
    jma = kma = int(env_list("EXP_SIZES", "512")[0])
    dev = device()
    bz = filters.gaussian_fir_coeffs(nf, LN, torch.float32, dev)
    taps = bz.to(_BF16)

    def temporal(seed):
        return ft.fused_temporal(seed, 0, NSTEPS, jma, kma, bz, taps, taps, 3,
                                 matmul_dtype=_BF16)

    def base(seed):
        z = fused_filter.fused_spatial(seed, 0, NSTEPS + 2 * nf, jma, kma,
                                       taps, taps, 3, matmul_dtype=_BF16)
        return filters.filter_temporal(z, bz, axis=-3)

    y = temporal(1)
    yb = base(1)
    print("fused_temporal out", tuple(y.shape), "mean", float(y.mean()),
          "var", float(y.var()), flush=True)
    print(f"fused_temporal max abs diff vs base + FIR: "
          f"{float((y - yb).abs().max()):.2e}", flush=True)
    del y, yb
    timed(temporal, dev, label="fused_temporal (FIR in-kernel)")
    timed(base, dev, label="base + XLA temporal FIR")


if __name__ == "__main__":
    if os.environ.get("EXP_TEMPORAL") == "1":
        run_fused_temporal()
        sys.exit(0)
    sys.exit(main())
