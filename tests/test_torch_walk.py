"""K1's strip walk and K4's tiles (ops/fused_filter.py, ops/fused_temporal.py)
on the CPU, where the wrappers take their plain versions: the plain versions
against the Pallas bodies in interpret mode with nfy != nfz (nfx != nfy !=
nfz for K4) at shapes ragged against the kernels' new steps and tiles (128 x
32 and 32 x 32), and the Python arithmetic that picks a step, a tile and K4's
chunks, with the card's properties stubbed.  The CUDA kernels are held to
these plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from torch_parity import load_experiment, np_of  # noqa: I001

from pods_digital_filter_tpu.ops import filters as jf
from pods_digital_filter_tpu.ops import pallas_filter as pf
from pods_digital_filter_tpu_torch.ops import filters as tf
from pods_digital_filter_tpu_torch.ops import fused_filter as ff
from pods_digital_filter_tpu_torch.ops import fused_temporal as ft

SQRT3 = float(np.sqrt(3.0))
H100_SMEM = 232448          # dynamic shared memory a block may opt in to


def _round4(v):
    return (v + 3) // 4 * 4


def walk_smem(nfy, nfz, ks, ch, pipelined):
    """K1's shared memory (csrc/filter_tile.cuh walk_smem_floats), restated:
    one noise buffer (two pipelined) of ch + 2nfy rows at an odd-float4 pitch of at least
    ks + 2nfz + 4, t of ch + 2nfy + 4 rows at ks + 4, both taps padded to 4."""
    xp = _round4(ks + 2 * nfz + 4)
    xp += 0 if (xp // 4) % 2 else 4
    return 4 * ((1 + pipelined) * (ch + 2 * nfy) * xp + (ch + 2 * nfy + 4) * (ks + 4)
                + _round4(2 * nfy + 1) + _round4(2 * nfz + 1))


def temporal_smem(nfx, nfy, nfz, ks, ch):
    """K4's: K1's one-buffer walk, the ring of 2nfx+1 ch x ks tiles, bx."""
    return (walk_smem(nfy, nfz, ks, ch, 0)
            + 4 * ((2 * nfx + 1) * ch * ks + _round4(2 * nfx + 1)))


def _threefry_noise(seed, t0, total, jn, kn):
    import jax
    import jax.numpy as jnp

    key = jax.random.fold_in(jax.random.key(seed), t0)
    return np.array(jax.random.uniform(key, (total, jn, kn), jnp.float32,
                                       -SQRT3, SQRT3))


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,t0,slabs,jma,kma,nfy,nfz", [
    (3, 5, 2, 37, 131, 3, 5), (1, 0, 3, 70, 33, 1, 4), (2, 7, 2, 9, 140, 6, 2)])
def test_plain_matches_pallas_ragged(seed, t0, slabs, jma, kma, nfy, nfz,
                                     matmul_dtype):
    """K1's plain version (noise-in) against ``pf._fused_spatial`` in
    interpret mode with y and z bands of different widths, on planes that
    leave partial 128-column strips and 32-row steps.  f32 taps: atol 2e-5
    (float32 sums in other orders); bf16 taps: ``ff.bf16_tap_bound`` (an
    element of t may round to its neighbouring bf16 value)."""
    import jax.numpy as jnp

    md = getattr(jnp, matmul_dtype)
    by = jf.gaussian_fir_coeffs(nfy, nfy / 2.0, jnp.float32)
    bz = jf.gaussian_fir_coeffs(nfz, nfz / 2.0, jnp.float32)
    want = np.asarray(pf._fused_spatial(
        jnp.asarray([[seed, t0, slabs]], jnp.int32),
        jf.toeplitz_band(bz, kma).T.astype(md),
        jf.toeplitz_band(by, jma).astype(md), num_slabs=slabs, jma=jma,
        kma=kma, num_components=3, interpret=True))
    jn, kn = jma + 2 * nfy, kma + 2 * nfz
    raw = torch.as_tensor(_threefry_noise(seed, t0, 3 * slabs, jn, kn)
                          ).reshape(3, slabs, jn, kn)
    tby, tbz = (torch.as_tensor(np.array(b)) for b in (by, bz))
    got = ff.fused_spatial(seed, t0, slabs, jma, kma, tby, tbz, 3, noise=raw,
                           matmul_dtype=getattr(torch, matmul_dtype))
    assert got.shape == want.shape == (3, slabs, jma, kma)
    atol = 2e-5 if matmul_dtype == "float32" else ff.bf16_tap_bound(tby, tbz)
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=atol)


def _hash_bits(seed, shape):
    """uint32 bits of a (rows, cols) draw keyed by ``seed`` (uint32 array
    arithmetic, so numpy and jax agree): the stand-in for the TPU's on-core
    PRNG, which interpret mode does not emulate."""
    import jax.numpy as jnp

    xp = np if isinstance(seed, np.uint32) else jnp
    r = xp.arange(shape[0], dtype=xp.uint32)[:, None]
    k = xp.arange(shape[1], dtype=xp.uint32)[None, :]
    h = (seed * xp.uint32(0x9E3779B1) + r * xp.uint32(0x85EBCA77)
         + k * xp.uint32(0xC2B2AE3D))
    h = h ^ (h >> xp.uint32(15))
    h = h * xp.uint32(0x2C1B3C6D)
    h = h ^ (h >> xp.uint32(12))
    h = h * xp.uint32(0x297A2D39)
    return h ^ (h >> xp.uint32(15))


@pytest.mark.parametrize("jma,kma,nfx,nfy,nfz,nsteps", [
    (20, 36, 1, 2, 3, 4), (34, 18, 3, 1, 2, 3)])
def test_temporal_plain_matches_fused_temporal_body(monkeypatch, jma, kma, nfx,
                                                    nfy, nfz, nsteps):
    """K4's plain version against the experiment's ``_fused_temporal_body``
    (its ring of filtered slabs and in-kernel FIR) in interpret mode, with
    three different half-widths.  Interpret mode has no on-core PRNG, so
    ``pltpu.prng_seed``/``prng_random_bits`` are replaced by a hash of the
    body's own per-slab seed; the body's int16 noise (``pltpu.bitcast``
    puts a word's low half at row 2r and its high half at row 2r+1) times
    its scale is K4's noise-in input.  f32 taps and an f32 ring, K4's
    (ROADMAP C: the TPU's bf16 ring was not part of the meaning); the body
    folds the scale into ByM, K4 does not: atol 2e-5 for f32 sums in other
    orders."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    exp = load_experiment("exp_two_kernel_pipeline")
    seed, t0, C = 11, 4, 2
    num_slabs, depth = nsteps + 2 * nfx, 2 * nfx + 1
    jn, kn = jma + 2 * nfy, kma + 2 * nfz
    alpha = np.float32(2.0 * SQRT3 / 65536.0)
    state = {}
    monkeypatch.setattr(pltpu, "prng_seed",
                        lambda s: state.__setitem__("seed", s))
    monkeypatch.setattr(pltpu, "prng_random_bits", lambda shape: (
        jax.lax.bitcast_convert_type(
            _hash_bits(state["seed"].astype(jnp.uint32), shape), jnp.int32)))

    b = [jf.gaussian_fir_coeffs(n, n / 2.0 + 0.5, jnp.float32)
         for n in (nfx, nfy, nfz)]
    BzT = jf.toeplitz_band(b[2], kma).T
    ByM = jf.toeplitz_band(b[1], jma) * alpha
    out_map = lambda i: (i // num_slabs,
                         jnp.maximum(i % num_slabs - (depth - 1), 0), 0, 0)
    want = np.asarray(pl.pallas_call(
        exp._fused_temporal_body, grid=(C * num_slabs,),
        in_specs=[pl.BlockSpec((1, 3), lambda i: (0, 0),
                               memory_space=pltpu.SMEM),
                  pl.BlockSpec((kn, kma), lambda i: (0, 0)),
                  pl.BlockSpec((jma, jn), lambda i: (0, 0)),
                  pl.BlockSpec((1, depth), lambda i: (0, 0),
                               memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((1, 1, jma, kma), out_map),
        out_shape=jax.ShapeDtypeStruct((C, nsteps, jma, kma), jnp.float32),
        scratch_shapes=[pltpu.VMEM((depth, jma, kma), jnp.float32)],
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray([[seed, t0, num_slabs]], jnp.int32), BzT, ByM,
      jnp.asarray(b[0])[None, :]))

    noise = np.empty((C, num_slabs, jn, kn), np.float32)
    for c in range(C):
        for s in range(num_slabs):
            stream = np.int64(c) * (1 << 22) + t0 + s
            key = (seed + stream * -1640531527) & 0xFFFFFFFF
            with np.errstate(over="ignore"):
                w = _hash_bits(np.uint32(key), (jn // 2, kn))
            noise[c, s, 0::2] = (w & 0xFFFF).astype(np.uint16).view(np.int16)
            noise[c, s, 1::2] = (w >> 16).astype(np.uint16).view(np.int16)
    noise *= alpha
    tb = [torch.as_tensor(np.array(x)) for x in b]
    got = ft.fused_temporal(seed, t0, nsteps, jma, kma, *tb, C,
                            noise=torch.as_tensor(noise))
    assert got.shape == want.shape and np.abs(want).max() > 0.5
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("nfy,nfz,pipelined,want", [
    (8, 8, False, (128, 32)), (6, 6, False, (128, 32)),
    (8, 8, True, (128, 32)), (60, 60, False, (128, 16)),
    (100, 4, False, (64, 32)), (40, 40, True, (128, 16)), (4, 700, False, (128, 16)),
    (90, 90, False, (32, 8))])
def test_walk_tile_takes_the_largest_step_that_fits(nfy, nfz, pipelined,
                                                    want):
    ks, ch, need = ff.walk_tile(nfy, nfz, pipelined, walk_smem, H100_SMEM)
    assert (ks, ch) == want
    assert need == walk_smem(nfy, nfz, ks, ch, pipelined) <= H100_SMEM
    bigger = ff.WALK_TILES[:ff.WALK_TILES.index((ks, ch))]
    assert all(walk_smem(nfy, nfz, k, c, pipelined) > H100_SMEM
               for k, c in bigger)


def test_walk_accepts_every_nf_the_tiles_did():
    """Every (nfy, nfz) whose 32 x 64 tile fitted the first K1 (its own
    shared-memory count) still finds a strip step: the range only grows."""
    old = lambda y, z: 4 * ((32 + 2 * y) * (64 + 2 * z) + (32 + 2 * y) * 64
                            + 2 * y + 1 + 2 * z + 1)
    for nfy in range(0, 220, 7):
        for nfz in range(0, 900, 29):
            if old(nfy, nfz) <= H100_SMEM:
                ff.walk_tile(nfy, nfz, False, walk_smem, H100_SMEM)
    ff.walk_tile(120, 1, False, walk_smem, H100_SMEM)   # refused before


def test_walk_and_temporal_tiles_refuse_with_the_byte_count():
    with pytest.raises(ValueError, match=r"nfy=400, nfz=400 need \d+ bytes "
                                         r"of shared memory even for a 32 x 8"):
        ff.walk_tile(400, 400, False, walk_smem, H100_SMEM)
    with pytest.raises(ValueError, match=r"nfx=200, nfy=2, nfz=2 need \d+ "
                                         r"bytes of shared memory"):
        ft.temporal_tile(200, 2, 2, temporal_smem, H100_SMEM)


@pytest.mark.parametrize("nf,want", [
    ((8, 8, 8), (32, 32)), ((1, 2, 3), (32, 32)), ((40, 8, 8), (32, 16)),
    ((60, 2, 2), (32, 8))])
def test_temporal_tile_takes_the_largest_that_fits(nf, want):
    ks, ch, need = ft.temporal_tile(*nf, temporal_smem, H100_SMEM)
    assert (ks, ch) == want and need <= H100_SMEM


@pytest.mark.parametrize("nsteps,nfx,blocks,slots,want", [
    (1024, 8, 768, 264, 1024),   # main: 3 full waves of whole windows
    (64, 8, 768, 264, 64),       # the experiments' 64 steps
    (1024, 8, 10, 264, 40),      # a small plane: 26 chunks fill one wave
    (6, 2, 45, 264, 2),          # short windows: 3 chunks, one wave
    (100, 1, 100, 100, 100)])    # one wave already
def test_chunk_minimises_waves_times_slabs(nsteps, nfx, blocks, slots, want):
    chunk = ft._chunk(nsteps, nfx, blocks, slots)
    assert chunk == want
    c = -(-nsteps // chunk)
    cost = -(-blocks * c // slots) * (chunk + 2 * nfx)
    for c2 in range(1, nsteps + 1):
        ch2 = -(-nsteps // c2)
        assert cost <= -(-blocks * c2 // slots) * (ch2 + 2 * nfx)


def test_chunk_respects_the_grid_limit():
    assert ft._chunk(1000, 1, 1, 10 ** 6, max_chunks=10) == 100


@pytest.mark.parametrize("nfy,nfz", [(2, 2), (1, 4), (6, 3)])
def test_bf16_plain_sums_in_tap_order(nfy, nfz):
    """The bf16-tap plain version is K1's arithmetic bit for bit: noise and
    taps rounded to bf16, each pass one float32 sum in ascending tap order
    from 0 (a bf16 x bf16 product is exact, so that is an fmaf chain), t
    rounded to bf16 in between; stated here with numpy."""
    rng = np.random.default_rng(nfy * 10 + nfz)
    jma, kma = 9, 13
    x = rng.uniform(-SQRT3, SQRT3, (2, jma + 2 * nfy, kma + 2 * nfz)
                    ).astype(np.float32)
    by, bz = (tf.gaussian_fir_coeffs(n, n / 2.0) for n in (nfy, nfz))
    r = lambda a: np_of(torch.as_tensor(a).to(torch.bfloat16).float())
    xb, byb, bzb = r(x), r(np_of(by)), r(np_of(bz))
    t = np.zeros((2, x.shape[1], kma), np.float32)
    for d in range(2 * nfz + 1):
        t = t + bzb[d] * xb[:, :, d:d + kma]
    t = r(t)
    want = np.zeros((2, jma, kma), np.float32)
    for d in range(2 * nfy + 1):
        want = want + byb[d] * t[:, d:d + jma]
    got = ff.filter_taps(torch.as_tensor(x), by, bz, jma, kma, torch.bfloat16)
    np.testing.assert_array_equal(np_of(got), want)


def test_tile_trial_times_the_tiles_the_wrappers_take():
    from pods_digital_filter_tpu_torch.experiments import tile_trial

    assert ff.WALK_TILES[0] in tile_trial.K1_STEPS
    assert ft.TEMPORAL_TILES[0] in tile_trial.K4_TILES
