"""The traced run's reduction: ``torch.profiler`` (CPU and CUDA activity)
around the window, reduced to the device's busy time, kernel time by name
and the longest idle gaps by what the host was doing.

Host spans come from the benchmark's own ``record_function`` names
(``bench:*``, around each call into the program) and from the program's
stage timer (``stage:<name>``): in a traced run ``StageTimer.stage`` also
opens a ``record_function`` of the stage's name.  Every interval of a
device event (kernels, copies, sets) counts as busy.  A device event
belongs to a stage where it runs inside the stage's host span: the stages
that the per-layer metrics select by (the streaming passes) end in a
synchronize, so their kernels run inside them and no other's do.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "bench:window"
#: kernel names are cut to this many characters in the breakdown
NAME_CHARS = 120


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict                 # name -> [seconds, count]
    breakdown: dict = field(default_factory=dict)
    events: list = field(default_factory=list)   # (start_ns, end_ns, name)
    spans: list = field(default_factory=list)    # (start_ns, end_ns, name)

    def kernel_seconds(self, match, stages=None):
        """Seconds and launches of the kernels whose name ``match`` accepts;
        with ``stages``, only those that run inside a span of one of the
        program's stages of those names."""
        s = n = 0
        if stages is None:
            for name, (sec, cnt) in self.kernels.items():
                if match(name):
                    s += sec
                    n += cnt
            return s, n
        names = {"stage:" + st for st in stages}
        inside = _merge([(a, b) for a, b, nm in self.spans if nm in names])
        starts = [a for a, _ in inside]
        for a, b, name in self.events:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and b <= inside[i][1] and match(name):
                s += (b - a) * 1e-9
                n += 1
        return s, n


_original_stage = None


def _patch_stage_timer():
    """Make the program's stage timer open a ``record_function`` per stage,
    for this process (traced runs only)."""
    global _original_stage
    from torch.profiler import record_function

    from pods_digital_filter_tpu_torch.utils.timing import StageTimer

    if _original_stage is not None:
        return
    _original_stage = StageTimer.stage

    @contextlib.contextmanager
    def stage(self, name):
        with record_function("stage:" + name), _original_stage(self, name):
            yield

    StageTimer.stage = stage


class _Profile:
    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.span = record_function(WINDOW)

    def __enter__(self):
        self.prof.__enter__()
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)


def start(device):
    _patch_stage_timer()
    p = _Profile(device)
    p.__enter__()
    return p


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def stop(p, device):
    """Close the profile and reduce it."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    p.__exit__(None, None, None)
    events = p.prof.profiler.kineto_results.events()
    w0 = w1 = None
    dev, spans, found = [], [], []
    kernels = defaultdict(lambda: [0.0, 0])
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name == WINDOW:
                w0, w1 = e.start_ns(), e.end_ns()
            elif name.startswith(("bench:", "stage:")):
                spans.append((e.start_ns(), e.end_ns(), name))
            continue
        if e.is_user_annotation() or name.startswith(("bench:", "stage:")):
            continue          # the device timeline's copy of a host span
        a, b = e.start_ns(), e.end_ns()
        dev.append((a, b))
        found.append((a, b, name))
        k = kernels[name]
        k[0] += (b - a) * 1e-9
        k[1] += 1
    if w0 is None:
        w0 = min((a for a, _ in dev), default=0)
        w1 = max((b for _, b in dev), default=0)
    busy = _merge([(max(a, w0), min(b, w1)) for a, b in dev if b > w0
                   and a < w1])
    busy_ns = sum(b - a for a, b in busy)
    gaps = []
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) // 2
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        name = max(inner)[2] if inner else "host (no span)"
        named.append(((b - a) * 1e-9, name))
    window_s = (w1 - w0) * 1e-9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    breakdown = {"device_ops": [[n[:NAME_CHARS], v[0]] for n, v in top],
                 "idle_gaps": [[n, s] for s, n in named]}
    return Trace(window_s=window_s, busy_s=busy_ns * 1e-9,
                 kernels=dict(kernels), breakdown=breakdown, events=found,
                 spans=spans)
