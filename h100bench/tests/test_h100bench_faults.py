"""The check catches a broken timed path: the harness runs (on the CPU, at
a tiny size, the card's look skipped) with the program broken underneath,
and ``correct`` comes out false, once for each fault a cell can have:

* a step that hands on its input unchanged (the Lund colouring; the
  centring; the replay's mean pass);
* half of the batch left out and the mean taken over the rest (the
  snapshot mean; half of a replay call's times);
* an answer altered where it is produced (one value of a written mode; one
  value of a replay output);
* a model cut short where it is written: half of each mode's Fourier terms,
  a lower energy target than the configuration states, the mean's VTK file
  left out.

The exchange between chips has no place in a one-chip cell."""

import pytest
import torch

from h100bench.tests.tiny import run_tiny, tiny_cell


def lund_unchanged(mp):
    from pods_digital_filter_tpu_torch.ops import lund

    mp.setattr(lund, "apply_lund_stacked", lambda noise, s, m: noise)


def centring_unchanged(mp):
    from pods_digital_filter_tpu_torch.ops import pod

    def center_and_gram(A):
        return torch.zeros_like(A[:, 0]), A, (A.T @ A) / A.shape[1]

    mp.setattr(pod, "center_and_gram", center_and_gram)


def half_mean(mp):
    from pods_digital_filter_tpu_torch import streaming
    from pods_digital_filter_tpu_torch.ops import pod

    def center_and_gram(A):
        ns = A.shape[1]
        mean = A[:, :ns // 2].mean(dim=1)
        Ac = A - mean[:, None]
        return mean, Ac, (Ac.T @ Ac) / ns

    calls = []

    def colsum(s, A):
        calls.append(1)
        if len(calls) % 2 == 0:
            return s
        cs = 2 * A.sum(dim=1)
        return cs if s is None else s.add_(cs)

    mp.setattr(pod, "center_and_gram", center_and_gram)
    mp.setattr(streaming, "_colsum_acc", colsum)


def altered_mode(mp):
    from pods_digital_filter_tpu_torch import compress
    from pods_digital_filter_tpu_torch.io import prf

    write_mode, write_points = prf.write_mode_prf, compress._write_prf_points

    def bump(v):
        v = v.copy()
        v[len(v) // 3] += 1e-3 * abs(v).max()
        return v

    mp.setattr(prf, "write_mode_prf", lambda outdir, i, mode, *a, **k:
               write_mode(outdir, i, bump(mode) if i == 1 else mode, *a, **k))
    mp.setattr(compress, "_write_prf_points",
               lambda path, pts, packed, *a: write_points(
                   path, pts, bump(packed) if path.endswith("_0001.prf")
                   else packed, *a))


def half_terms(mp):
    from pods_digital_filter_tpu_torch.ops import fourier

    orig = fourier.select_by_energy
    mp.setattr(fourier, "select_by_energy",
               lambda cmod, et: max(1, orig(cmod, et) // 2))


def low_target(mp):
    from pods_digital_filter_tpu_torch.ops import fourier

    orig = fourier.fourier_compress
    mp.setattr(fourier, "fourier_compress",
               lambda y, nm, dt, et: orig(y, nm, dt, et - 0.05))


def no_mean_vtk(mp):
    import os

    from pods_digital_filter_tpu_torch.io import vtk

    mp.setattr(vtk, "write_mean_field_vtk", lambda outdir, *a, **k:
               os.path.join(outdir, "POD.spatial_mean_field_u.vtk"))


def replay_no_mean(mp):
    from pods_digital_filter_tpu_torch import replay

    orig = replay._eval
    mp.setattr(replay, "_eval", lambda ts, k, cr, ci, modes, mean, T, a:
               orig(ts, k, cr, ci, modes, mean * 0, T, a))


def replay_half_times(mp):
    from pods_digital_filter_tpu_torch import replay

    orig = replay._eval

    def half(ts, *a):
        out = orig(ts[: len(ts) // 2], *a)
        return torch.cat([out, out])

    mp.setattr(replay, "_eval", half)


def replay_altered(mp):
    from pods_digital_filter_tpu_torch import replay

    orig = replay._eval

    def altered(*a):
        out = orig(*a)
        out[0, out.shape[1] // 2] += 1e-6 * float(out.abs().max())
        return out

    mp.setattr(replay, "_eval", altered)


MODEL_FAULTS = {"unchanged": centring_unchanged, "half_mean": half_mean,
                "altered": altered_mode, "half_terms": half_terms,
                "low_target": low_target}
CASES = [(c, f) for c in ("main512.inmem", "main512.compress")
         for f in MODEL_FAULTS]
CASES += [("main512.inmem", "lund_unchanged"),
          ("flagship.stream", "lund_unchanged"),
          ("flagship.stream", "half_mean"), ("flagship.stream", "altered"),
          ("flagship.stream", "half_terms"), ("main512.inmem", "no_mean_vtk"),
          ("flagship.stream", "no_mean_vtk")]
FAULTS = dict(MODEL_FAULTS, lund_unchanged=lund_unchanged,
              no_mean_vtk=no_mean_vtk)


@pytest.mark.parametrize("cell,fault", CASES)
def test_model_fault_is_caught(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    line, _ = run_tiny(tiny_cell(cell))
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("fault", [replay_no_mean, replay_half_times,
                                   replay_altered])
def test_replay_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    line, _ = run_tiny(tiny_cell("flagship.replay"))
    assert line["correct"] is False, line["compared"]
