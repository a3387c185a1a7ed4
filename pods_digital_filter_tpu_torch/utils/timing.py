"""The port's trace module: stage times, spans and counters.

* :class:`StageTimer` keeps each stage's host seconds (``times``, every
  stage ends in a device synchronize) for ``PipelineResult.timer`` and
  ``--timings``.
* :func:`span` marks a piece of work.  While a ``torch.profiler`` records
  (``torch.autograd.profiler._is_profiler_enabled``, the switch), it opens
  ``record_function("stage:" + name)`` and adds to three counters on the
  host clock at its own boundaries: ``name`` (calls), ``name + "_s"``
  (seconds) and, where ``nbytes`` is given, ``name + "_bytes"``.  Otherwise
  it returns a shared ``nullcontext`` after one flag check.  Every
  ``StageTimer`` stage is a span, so the program's stages appear in every
  trace under ``stage:<name>``; spans below a stage take dotted
  ``layer.what`` names.  A span given a CUDA ``device`` synchronizes it
  on entry and on exit while recording, so that its seconds are those of
  the device work queued inside it (a collective or a product returns to
  the host before the card is done); it costs nothing when no profiler
  records.
* :func:`count` adds to a counter under the same switch; :func:`counts`
  copies the counters and :func:`reset_counts` clears them.  Counters are
  global and thread-safe (one lock, taken only while recording), so they
  also count a worker thread that the profiler does not trace.  A trace's
  counts cover exactly its window.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict

import torch
import torch.autograd.profiler as _profiler

#: prefix of every span's ``record_function`` name
PREFIX = "stage:"

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_counts: dict = {}


def _add(name: str, n) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


class _Span:
    __slots__ = ("name", "nbytes", "device", "rf", "t0")

    def __init__(self, name: str, nbytes, device=None):
        self.name, self.nbytes, self.device = name, nbytes, device

    def __enter__(self):
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        self.rf = _profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and exc[0] is None:
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        with _lock:
            _counts[self.name] = _counts.get(self.name, 0) + 1
            key = self.name + "_s"
            _counts[key] = _counts.get(key, 0.0) + dt
            if self.nbytes:
                key = self.name + "_bytes"
                _counts[key] = _counts.get(key, 0) + self.nbytes
        return False


def span(name: str, nbytes: int = 0, device=None):
    """A context manager around a piece of work named ``name``; see the
    module's docstring."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if device is not None and torch.device(device).type != "cuda":
        device = None
    return _Span(name, int(nbytes), device)


def recording() -> bool:
    """Whether a profiler records (spans and counters count only then)."""
    return bool(_profiler._is_profiler_enabled)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        _add(name, n)


@contextlib.contextmanager
def written(path: str, name: str):
    """:func:`span` ``name`` around the writing of the file ``path``; once
    it is closed, its size is added to ``name + "_bytes"``."""
    if not _profiler._is_profiler_enabled:
        yield
        return
    with _Span(name, 0):
        yield
    _add(name + "_bytes", os.path.getsize(path))


def counts() -> dict:
    """A copy of the counters."""
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    with _lock:
        _counts.clear()


class StageTimer:
    def __init__(self):
        self.times = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return "\n".join(f"{k:<30s} {v:10.4f} s" for k, v in self.times.items())
