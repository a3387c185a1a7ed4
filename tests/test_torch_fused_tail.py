"""K5, the generation tail after K1 (ops/fused_tail.py), on the CPU where
the wrapper takes its plain version: that version is the chain the
generator ran before (filter_temporal -> apply_lund_stacked -> pack ->
apply_rotation_packed -> minus centre), bit for bit, in float32 and in
bfloat16 (the FIR in float32, rounded, the rest in bf16); the wrapper
refuses what the kernel does not take; the generator routes its float32 and
bfloat16 ``--pallas`` tails through it and nothing else; and the Gram pass's
memory estimate counts the route's transients.  The CUDA kernel is checked against the
plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from pods_digital_filter_tpu_torch import pipeline, streaming
from pods_digital_filter_tpu_torch.ops import filters, fused_tail, fused_temporal
from pods_digital_filter_tpu_torch.ops import lund, rotation
from pods_digital_filter_tpu_torch.utils import timing

#: (nsteps, jma, kma): even against K5's 32-step tiles and 128-point
#: blocks, and ragged against both (a last tile of 5 steps, 135 points)
SHAPES = {"even": (32, 8, 16), "ragged": (37, 9, 15)}


def _inputs(nfx, nsteps, jma, kma, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    z = f32(rng.standard_normal((3, nsteps + 2 * nfx, jma, kma)))
    bx = filters.gaussian_fir_coeffs(nfx, max(nfx / 2.0, 0.5))
    diag = rng.uniform(0.0, 0.02, (3, jma, kma))
    diag[:, 0, :2] = 0.0                   # zero pivots: the clamps
    off = rng.uniform(-0.005, 0.005, (3, jma, kma))
    stresses = f32(np.concatenate([diag, off]))
    means = f32(rng.uniform(0.5, 1.5, (3, jma, kma)))
    rot = f32(rotation.profile_rotation_matrix(1.0, 0.3, 0.2))
    center = f32(rng.uniform(0.5, 1.5, 3 * jma * kma))
    return z, bx, stresses, means, rot, center


def _chain(z, bx, stresses, means, rot, center):
    """The generator's tail as it was composed before the tail kernel."""
    y = filters.filter_temporal(z, bx, axis=-3)
    colored = lund.apply_lund_stacked(y, stresses, means)
    c, ns, jma, kma = colored.shape
    A = colored.permute(0, 2, 3, 1).reshape(c * jma * kma, ns)
    if rot is not None:
        A = rotation.apply_rotation_packed(A, rot)
    if center is not None:
        A = A - center[:, None]
    return A


def _chain_bf16(z, bx, stresses, means, rot, center):
    """The generator's bfloat16 tail as it was composed before the tail
    kernel took it: the dense FIR in float32, rounded to bf16, then Lund,
    pack, rotation and centre in bf16."""
    y = filters.filter_temporal(z, bx, axis=-3).to(torch.bfloat16)
    colored = lund.apply_lund_stacked(y, stresses, means)
    c, ns, jma, kma = colored.shape
    A = colored.permute(0, 2, 3, 1).reshape(c * jma * kma, ns)
    if rot is not None:
        A = rotation.apply_rotation_packed(A, rot)
    if center is not None:
        A = A - center[:, None]
    return A


def _bf16(*tensors):
    return [None if t is None else t.to(torch.bfloat16) for t in tensors]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("nfx", [1, 8])
@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("centre", [False, True])
def test_plain_route_is_the_chain(shape, nfx, rotate, centre):
    """The CPU route of the wrapper equals the chain bit for bit, with the
    rotation and the centre each on and off, and launches nothing."""
    nsteps, jma, kma = SHAPES[shape]
    z, bx, stresses, means, rot, center = _inputs(nfx, nsteps, jma, kma)
    rot, center = (rot if rotate else None), (center if centre else None)
    before = fused_tail.LAUNCHES
    got = fused_tail.fused_tail(z, bx, stresses, means, rot, center)
    want = _chain(z, bx, stresses, means, rot, center)
    assert got.shape == (3 * jma * kma, nsteps) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert fused_tail.LAUNCHES == before


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("nfx", [1, 8])
@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("centre", [False, True])
def test_plain_bf16_route_is_the_old_bf16_chain(shape, nfx, rotate, centre):
    """Given bf16 Lund fields, rotation and centre, the CPU route returns a
    bf16 block equal bit for bit to the chain the generator ran in bf16,
    and launches nothing."""
    nsteps, jma, kma = SHAPES[shape]
    z, bx, stresses, means, rot, center = _inputs(nfx, nsteps, jma, kma)
    stresses, means, rot, center = _bf16(stresses, means, rot, center)
    rot, center = (rot if rotate else None), (center if centre else None)
    before = fused_tail.LAUNCHES
    got = fused_tail.fused_tail(z, bx, stresses, means, rot, center)
    want = _chain_bf16(z, bx, stresses, means, rot, center)
    assert got.shape == (3 * jma * kma, nsteps)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    # bf16 rounding is visible: the float32 route gives another block
    f32 = fused_tail.fused_tail(z, bx, stresses.float(), means.float(),
                                None if rot is None else rot.float(),
                                None if center is None else center.float())
    assert not torch.equal(got.float(), f32)
    assert fused_tail.LAUNCHES == before


def test_plain_route_counts_no_launch():
    """The counter ``fused_tail.launches`` counts launches only: the plain
    route, even while a profiler records, adds nothing."""
    z, bx, stresses, means, rot, center = _inputs(2, 8, 4, 4)
    timing.reset_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fused_tail.fused_tail(z, bx, stresses, means, rot, center)
        fused_tail.fused_tail(z, bx, *_bf16(stresses, means, rot, center))
    assert "fused_tail.launches" not in timing.counts()
    assert "fused_tail.bf16_launches" not in timing.counts()


def _bad(case):
    z, bx, stresses, means, rot, center = _inputs(2, 8, 4, 6)
    args = dict(z=z, bx=bx, stresses=stresses, means=means, rotation=rot,
                center=center)
    change = {
        "z dtype": ("z", z.double()),
        "z layout": ("z", z.transpose(2, 3).contiguous().transpose(2, 3)),
        "z shape": ("z", z[:2]),
        "z rank": ("z", z[0]),
        "bx even": ("bx", bx[:4]),
        "bx too long": ("bx", filters.gaussian_fir_coeffs(6, 2.0)),
        "bx dtype": ("bx", bx.double()),
        "stresses shape": ("stresses", stresses[:, :, :5]),
        "means dtype": ("means", means.half()),
        "rotation shape": ("rotation", rot[:2]),
        "center shape": ("center", center[:-1]),
        "center device": ("center", center.to("meta")),
    }[case]
    args[change[0]] = change[1]
    return args


@pytest.mark.parametrize("case,match", [
    ("z dtype", "z must be float32"), ("z layout", "z must be contiguous"),
    ("z shape", "z must be"), ("z rank", "z must be"),
    ("bx even", "bx must be"), ("bx too long", "bx must be"),
    ("bx dtype", "bx must be float32"),
    ("stresses shape", "stresses must be"), ("means dtype", "means must be"),
    ("rotation shape", "rotation must be"), ("center shape", "center must be"),
    ("center device", "center is on meta")])
def test_wrapper_refuses(case, match):
    before = fused_tail.LAUNCHES
    with pytest.raises(ValueError, match=match):
        fused_tail.fused_tail(**_bad(case))
    assert fused_tail.LAUNCHES == before


@pytest.mark.parametrize("case,match", [
    ("means", "means must be bfloat16, not torch.float32"),
    ("rotation", "rotation must be bfloat16, not torch.float32"),
    ("center", "center must be bfloat16, not torch.float32"),
    ("f32 stresses", "means must be float32, not torch.bfloat16"),
    ("z", "z must be float32, not torch.bfloat16"),
    ("bx", "bx must be float32, not torch.bfloat16"),
    ("half", "stresses must be float32 or bfloat16, not torch.float16")])
def test_wrapper_refuses_mixed_types(case, match):
    """The Lund fields, rotation and centre share the type of the block;
    the slabs and the taps stay float32 on both routes; float16 is no
    block type of the kernel."""
    z, bx, stresses, means, rot, center = _inputs(2, 8, 4, 6)
    args = dict(z=z, bx=bx, **dict(zip(
        ("stresses", "means", "rotation", "center"),
        _bf16(stresses, means, rot, center))))
    if case == "f32 stresses":
        args["stresses"] = stresses
    elif case == "half":
        args.update(stresses=stresses.half(), means=means.half(),
                    rotation=rot.half(), center=center.half())
    elif case in ("z", "bx"):
        args[case] = args[case].to(torch.bfloat16)
    else:
        args[case] = dict(means=means, rotation=rot, center=center)[case]
    before = fused_tail.LAUNCHES
    with pytest.raises(ValueError, match=match):
        fused_tail.fused_tail(**args)
    assert fused_tail.LAUNCHES == before


@pytest.mark.parametrize("dtype,use_fused,takes", [
    ("float32", True, True), ("bfloat16", True, True),
    ("float64", False, False), ("float32", False, False)])
def test_generator_takes_the_tail_where_it_should(monkeypatch, dtype,
                                                  use_fused, takes):
    """``InletGenerator`` hands K1's slabs to the tail kernel's wrapper on
    the float32 and bfloat16 ``--pallas`` routes only (on the CPU its plain
    chain), and both routes give the chain's result in the generator's
    type."""
    torch_dtype = getattr(torch, dtype)
    jma, kma, nsteps, nf = 6, 5, 9, 2
    rng = np.random.default_rng(3)
    stresses = [rng.uniform(0.001, 0.02, (jma, kma)) for _ in range(3)] + \
        [rng.uniform(-0.002, 0.002, (jma, kma)) for _ in range(3)]
    means = [rng.uniform(0.5, 1.5, (jma, kma)) for _ in range(3)]
    rot = rotation.profile_rotation_matrix(1.0, 0.3, 0.2)
    center = rng.uniform(0.5, 1.5, 3 * jma * kma)
    gen = pipeline.InletGenerator(
        seed=7, nsteps=nsteps, jma=jma, kma=kma, nfx=nf, nfy=nf, nfz=nf,
        lnx=1.0, lny=1.0, lnz=1.0, stresses=stresses, means=means,
        dtype=torch_dtype, use_fused=use_fused, rotation_matrix=rot,
        center=center, device="cpu")
    calls = []
    real = fused_tail.fused_tail

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(fused_tail, "fused_tail", spy)
    got = gen(4)
    assert calls == ([(3, nsteps + 2 * nf, jma, kma)] if takes else [])
    assert got.shape == (3 * jma * kma, nsteps) and got.dtype == torch_dtype
    if takes:
        from pods_digital_filter_tpu_torch.ops import fused_filter

        z = fused_filter.fused_spatial(7, 4, nsteps + 2 * nf, jma, kma,
                                       gen.by, gen.bz, 3, None,
                                       gen.matmul_dtype)
        chain = _chain_bf16 if torch_dtype == torch.bfloat16 else _chain
        want = chain(z, gen.bx, gen.stresses, gen.means, gen.rotation,
                     gen.center)
        assert torch.equal(got, want)


def test_gram_estimate_counts_the_slabs_only():
    """On the tail kernel's route the generation's transient is K1's slabs
    alone (the kernel writes the column block itself): one block less than
    the plain chain's; at the flagship (1024x512, block 512, group 8, nfx 8,
    Ns 10,240, f32) the panel, the column block, the slabs and the
    accumulator: 30.80 GiB against 33.80."""
    np3 = 3 * 1024 * 512
    blk = np3 * 512 * 4
    for block, group, nfx, ns in ((512, 8, 8, 10240), (4, 2, 2, 14)):
        plain = streaming.gram_pass_hbm_estimate(np3, block, group, 4, nfx, ns)
        fused = streaming.gram_pass_hbm_estimate(np3, block, group, 4, nfx, ns,
                                                 fused_tail=True)
        assert plain - fused == np3 * block * 4
    fused = streaming.gram_pass_hbm_estimate(np3, 512, 8, 4, 8, 10240, True)
    slab = np3 * (512 + 16) * 4
    acc = 10240 ** 2 * 4 + 2 * 8 * 512 * 10240 * 4
    assert fused == 9 * blk + slab + acc
    assert round(fused / 2 ** 30, 2) == 30.80
    budget = (fused + blk // 2)
    with pytest.warns(UserWarning, match="gram_group 8"):
        streaming._warn_gram_hbm(np3, 512, 8, 4, 8, 10240, budget=budget)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        streaming._warn_gram_hbm(np3, 512, 8, 4, 8, 10240, budget=budget,
                                 fused_tail=True)


@pytest.mark.parametrize("nsteps,tiles,slots,want", [
    (512, 4096, 528, 512), (1024, 2048, 528, 1024), (37, 1, 528, 32),
    (100, 1, 132, 32), (64, 66, 132, 32)])
def test_chunk_in_whole_tiles(nsteps, tiles, slots, want):
    """A K5 block's chunk of steps is a multiple of its 32-step tile, and
    the wave count decides it as it does K4's."""
    got = fused_temporal._chunk(nsteps, 8, tiles, slots, 65535,
                                unit=fused_tail.TILE_STEPS)
    assert got == want and got % fused_tail.TILE_STEPS == 0
