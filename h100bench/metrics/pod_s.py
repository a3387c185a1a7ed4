"""``pod_s``: the program's ``pod`` stage (``PipelineResult.timer``),
seconds per model, mean over the window's models."""

import os

from h100bench.harness import load_module

_stages = load_module(os.path.join(os.path.dirname(__file__), "_stages.py"))


def read(run):
    return _stages.mean_stage(run, "pod")
