"""Command-line entry point of the port — the JAX package's flags
(``pods_digital_filter_tpu.cli.build_parser``, reused) plus ``--device``,
which is to this CLI what ``--platform`` is to the JAX one.

Usage:  python -m pods_digital_filter_tpu_torch.cli [options] [--device cuda|cpu]
"""

from __future__ import annotations

import contextlib
import os
import sys

from pods_digital_filter_tpu.cli import build_parser as _jax_build_parser
from pods_digital_filter_tpu.cli import config_from_args
from pods_digital_filter_tpu_torch import PROG


def build_parser():
    p = _jax_build_parser()
    p.prog = PROG
    p.description = ("LES Inflow Generator after Klein et al. — PyTorch/CUDA "
                     "port: digital-filter turbulence + PODFS compression")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    return p


@contextlib.contextmanager
def maybe_trace(trace_dir, device):
    """``torch.profiler`` trace (Chrome trace JSON) when a directory is
    given — the counterpart of the JAX CLI's ``jax.profiler`` trace."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        build_parser().parse_args(["--help"])
        return 0
    args = build_parser().parse_args(argv)
    if args.multihost:
        raise NotImplementedError(
            "--multihost is slice 4 of the port (ROADMAP.md, queue A item "
            "11); run it with the JAX package")
    if args.platform is not None:
        raise ValueError("--platform selects a JAX backend; use --device")
    cfg = config_from_args(args)

    from pods_digital_filter_tpu_torch.pipeline import run_pipeline

    with maybe_trace(args.profile_dir, args.device):
        result = run_pipeline(cfg, device=args.device)

    print(f"\nPODFS model written to {cfg.outdir}/ "
          f"({result.pod.num_trunc} modes, period {result.fourier.period:.6g} s)")
    if args.timings:
        print(result.timer.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
