"""PyTorch port of the Lund colouring and the velocity rotation
(pods_digital_filter_tpu_torch/ops/lund.py, ops/rotation.py): float64
parity with JAX (rtol 1e-10), the scalar clamp oracle, and the
reference's own input/output pairs in tests/golden/ref_unit.npz."""

import os

import numpy as np
import pytest
import torch

from torch_parity import np_of, to_jax, to_torch  # noqa: I001
from oracle import lund_point

from pods_digital_filter_tpu.models import profiles as prof
from pods_digital_filter_tpu.ops import lund as jl
from pods_digital_filter_tpu.ops import rotation as jr
from pods_digital_filter_tpu_torch.ops import lund as tl
from pods_digital_filter_tpu_torch.ops import rotation as tr

F64 = np.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def unit_npz():
    return np.load(os.path.join(GOLDEN, "ref_unit.npz"))


def _stress_cases(rng):
    cases = [rng.uniform(-0.5, 2.0, 3).tolist() + rng.uniform(-1, 1, 3).tolist()
             for _ in range(200)]
    cases += [(0, 1, 1, 0.5, 0.5, 0.2), (1, 0, 1, 0, 0.5, 0.3),
              (1, 1, 0, 0.9, 0.9, 0.9), (0, 0, 0, 0, 0, 0)]
    return np.array(cases, dtype=F64)


def test_lund_cholesky_matches_jax(rng):
    arr = _stress_cases(rng)
    got = tl.lund_cholesky(*[to_torch(arr[:, i], F64) for i in range(6)])
    want = jl.lund_cholesky(*[to_jax(arr[:, i], F64) for i in range(6)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_of(g), np.asarray(w), rtol=1e-10,
                                   atol=1e-15)


def test_lund_matches_reference_clamp_oracle(rng):
    arr = _stress_cases(rng)
    a00, a10, a11, a20, a21, a22 = (np_of(p) for p in tl.lund_cholesky(
        *[to_torch(arr[:, i], F64) for i in range(6)]))
    for n, c in enumerate(arr):
        A = np.array([[a00[n], 0, 0], [a10[n], a11[n], 0],
                      [a20[n], a21[n], a22[n]]])
        np.testing.assert_allclose(A, lund_point(*c), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10),
                                        (np.float32, 1e-5)])
def test_apply_lund_stacked_matches_jax(dtype, rtol):
    rng = np.random.default_rng(21)
    jma, kma = 5, 6
    noise = rng.standard_normal((3, 4, jma, kma)).astype(dtype)
    stresses = [rng.uniform(0.1, 1.0, (jma, kma)).astype(dtype)
                for _ in range(3)]
    stresses += [rng.uniform(-0.2, 0.2, (jma, kma)).astype(dtype)
                 for _ in range(3)]
    means = [rng.uniform(0.0, 1.0, (kma,)).astype(dtype) for _ in range(3)]
    got = tl.apply_lund_stacked(to_torch(noise, dtype),
                                [to_torch(s, dtype) for s in stresses],
                                [to_torch(m, dtype) for m in means])
    want = jl.apply_lund_stacked(to_jax(noise, dtype),
                                 [to_jax(s, dtype) for s in stresses],
                                 [to_jax(m, dtype) for m in means])
    assert got.dtype == (torch.float32 if dtype == np.float32
                         else torch.float64)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=rtol,
                               atol=rtol)


def test_lund_matches_reference_adapt1d(unit_npz):
    fields = prof.fields_1d(unit_npz["prof_U"], unit_npz["prof_uu"],
                            unit_npz["prof_vv"], unit_npz["prof_ww"],
                            unit_npz["prof_uw"])
    noise = to_torch(unit_npz["adapt_in"], F64)[:, None]   # (3, 1, jma, kma)
    out = np_of(tl.apply_lund_stacked(
        noise, [to_torch(s, F64) for s in fields.stresses()],
        [to_torch(m, F64) for m in fields.means()]))[:, 0]
    np.testing.assert_allclose(out, unit_npz["adapt_out"], rtol=1e-12,
                               atol=1e-13)


@pytest.mark.parametrize("normal", [(1.0, 0.0, 0.0), (1.0, 0.3, 0.2),
                                    (0.2, -1.0, 0.5), (-1.0, 0.0, -0.4)])
def test_rotation_matches_jax(normal):
    rng = np.random.default_rng(22)
    A = rng.standard_normal((3 * 20, 7))
    np.testing.assert_allclose(tr.profile_rotation_matrix(*normal),
                               jr.profile_rotation_matrix(*normal), rtol=1e-15)
    got = np_of(tr.rotate_velocity_packed(to_torch(A, F64), *normal))
    want = np.asarray(jr.rotate_velocity_packed(to_jax(A, F64), *normal))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
    X = rng.standard_normal((3, 4, 5, 6))
    got = np_of(tr.rotate_velocity_fields(to_torch(X, F64), *normal))
    want = np.asarray(jr.rotate_velocity_fields(to_jax(X, F64), *normal))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


def test_rodrigues_matches_jax():
    for axis, ang in (((0.0, -0.2, 1.0), 0.7), ((0.0, 0.0, 0.0), 1.0),
                      ((1.0, 2.0, 3.0), -2.1)):
        np.testing.assert_allclose(tr.rodrigues(np.array(axis), ang),
                                   jr.rodrigues(np.array(axis), ang),
                                   rtol=1e-15)


def test_rotation_matches_reference_rotate_velocity(unit_npz):
    nx, ny, nz = (float(v) for v in unit_npz["rot_normal"])
    col = to_torch(unit_npz["rot_in"], F64)[:, None]
    ours = np_of(tr.rotate_velocity_packed(col, nx, ny, nz))[:, 0]
    np.testing.assert_allclose(ours, unit_npz["rot_out"], rtol=1e-12,
                               atol=1e-13)
