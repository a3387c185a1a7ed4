"""The reference's frozen copies against the program's plain versions, at
a tiny size on the CPU (the tests may import the program; the reference may
not)."""

import numpy as np
import pytest
import torch

from h100bench.reference import inlet as ref

CONF = dict(jma=24, kma=20, nsteps=40, res=0.1, lengthscale=2.0, fwidth=2.0,
            U0=1.0, u_dash=0.02, normal=(1.0, 0.0, 0.0),
            mean_profile="hyperbolic-tangent", turb_profile="top-hat")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5])
def test_noise_is_the_programs_philox_stream(seed):
    from pods_digital_filter_tpu_torch.ops import philox

    want = philox.raw_noise(seed, 3, 5, 9, 13, 3, "cpu")
    for c in range(3):
        got = ref.noise(seed, c, 3, 5, 9, 13, "cpu")
        assert torch.equal(got, want[c])


def test_taps_and_rotation():
    from pods_digital_filter_tpu_torch.ops import filters, rotation

    np.testing.assert_array_equal(
        ref.taps(8, 4.0),
        filters.gaussian_fir_coeffs(8, 4.0, torch.float64).numpy())
    for n in [(1, 0, 0), (0.6, 0.8, 0), (0.3, -0.2, 0.9), (-1, 0, 0)]:
        np.testing.assert_array_equal(ref.rotation_matrix(*n),
                                      rotation.profile_rotation_matrix(*n))


def test_profile_and_dt():
    from pods_digital_filter_tpu_torch import cli
    from pods_digital_filter_tpu_torch.pipeline import resolve_profile

    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["-j", "24", "-k", "20", "-l", "2", "-f", "2"]))
    fields, dt, filt, _, _ = resolve_profile(cfg)
    inl = ref.Inlet(CONF, "cpu")
    assert inl.dt == dt and inl.nf == filt.nfy == filt.nfx
    np.testing.assert_array_equal(inl.U[0, 0].numpy(),
                                  np.asarray(fields.mean_u))
    np.testing.assert_array_equal(inl.lund[0][0, 0].numpy() ** 2,
                                  np.asarray(fields.uu))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 5])
def test_torch_noise_is_the_programs_stream(seed):
    from pods_digital_filter_tpu_torch.ops import filters

    assert all(ref.slab_seed(seed, s) == filters.slab_seed(seed, s)
               for s in (0, 1, 2 ** 31 + 3))
    want = filters.noise_slabs(seed, 3, 5, 9, 13, 3, torch.float32, "cpu")
    for c in range(3):
        got = ref.torch_noise(seed, c, 3, 5, 9, 13, "cpu")
        assert torch.equal(got, want[c])


@pytest.mark.parametrize("pallas", [True, False], ids=["k1", "torch_ops"])
@pytest.mark.parametrize("normal", [(1.0, 0.0, 0.0), (0.6, 0.0, 0.8)])
def test_block_is_the_programs_generator(normal, pallas):
    """Snapshots 8..27 of the reference against the program's generator
    (K1's plain version with ``pallas``, else the torch-ops generator, f32)
    at f32 rounding."""
    from pods_digital_filter_tpu_torch import cli, pipeline

    argv = ["-j", "24", "-k", "20", "-n", "40", "-l", "2", "-f", "2",
            "--seed", "99", "--device", "cpu",
            "--nx", str(normal[0]), "--ny", str(normal[1]),
            "--nz", str(normal[2])] + (["--pallas"] if pallas else [])
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    fields, _, filt, cfg, rotate = pipeline.resolve_profile(cfg)
    gen = pipeline.make_generator(cfg, fields, filt, nsteps=20,
                                  rotate=rotate, device="cpu")
    want = gen(8).double()
    got = ref.Inlet(dict(CONF, normal=normal, pallas=pallas),
                    "cpu").block(99, 8, 20)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-6 * float(want.abs().max())


def test_prf_reader_matches_the_programs():
    import tempfile

    from h100bench.reference.model import read_prf
    from pods_digital_filter_tpu_torch.io import prf

    rng = np.random.default_rng(3)
    path = tempfile.mkdtemp() + "/f.prf"
    u = rng.standard_normal((50, 3))
    prf.write_field_prf(path, "x", rng.standard_normal((50, 3)), u)
    _, want = prf.read_field_prf(path)
    np.testing.assert_array_equal(read_prf(path), want)
    assert np.max(np.abs(read_prf(path) - u)) < 1e-12
