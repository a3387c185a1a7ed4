"""The port's copy of ``pods_digital_filter_tpu/native/__init__.py``, with
what the port calls: the ``.prf`` table writer and parser
(:func:`write_rows_fixed12`, :func:`parse_table`, :func:`parse_tables`) and
the solver-side C replay library (:class:`NativePODFSReplayer`).

``podfs_replay.c`` and ``podfs_replay.h`` are copies of the original's C
sources; ``fastio.c`` is a copy whose ``write_rows_fixed12`` formats a
large table on several threads and writes the same bytes.  Each library
is compiled on first use with the system C compiler into
``native/_build/`` beside this file (cached on the
source's mtime) and loaded with ctypes.  Without a compiler, or where that
directory is not writable, the table callers take their Python formatter
and ``np.loadtxt``, and :class:`NativePODFSReplayer` raises.  The replay
library is a host library by design, the code a CFD solver links: the
port's tests and ``chip_smoke.py`` hold the device replay
(:mod:`pods_digital_filter_tpu_torch.replay`) to it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from pods_digital_filter_tpu_torch.utils import timing

_SRC = os.path.join(os.path.dirname(__file__), "fastio.c")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _compile(src: str = _SRC, libname: str = "libfastio.so") -> str | None:
    """Compile ``src`` into ``BUILD_DIR/<libname>`` unless it is newer than
    the source; the library path, or None if no compiler succeeds."""
    out = os.path.join(BUILD_DIR, libname)
    for cc in ("cc", "gcc", "clang"):
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
                return out
            tmp = out + f".tmp{os.getpid()}"
            base = [cc, "-O3", "-shared", "-fPIC", "-o", tmp, src, "-lm"]
            try:
                # OpenMP parallelises parse_table's chunks and
                # podfs_eval_batch's timesteps; write_rows_fixed12 starts
                # POSIX threads of its own, with or without it (OpenMP's
                # ordered loop was slower there, PERF.md)
                subprocess.run(base + ["-fopenmp"], check=True,
                               capture_output=True, timeout=120)
            except subprocess.SubprocessError:
                subprocess.run(base, check=True, capture_output=True,
                               timeout=120)
            os.replace(tmp, out)
            return out
        except (OSError, subprocess.SubprocessError):
            continue
    return None


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            fn = lib.write_rows_fixed12
            fn.restype = ctypes.c_long
            fn.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_long, ctypes.c_long, ctypes.c_char,
            ]
            fn = lib.write_rows_fixed12_threads
            fn.restype = ctypes.c_int
            fn.argtypes = []
            fn = lib.parse_table
            fn.restype = ctypes.c_long
            fn.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_long),
            ]
            _LIB = lib
        except (OSError, AttributeError):
            _LIB = None
        return _LIB


def available() -> bool:
    return _load() is not None


def write_rows_fixed12(path: str, mode: str, rows: np.ndarray,
                       sep: str = ",") -> bool:
    """Append/write ``rows`` as sep-joined ``%0.12f`` lines.  Returns False
    (without writing) when the native library is unavailable.

    A table of 256 Ki values or more is formatted on up to 16 threads, one
    less than the processors the process may run on; their number is added
    to the counter ``io.prf.write_threads`` (1 for a table written on one
    thread).  At most 2 parts of text a thread, each about 1 MiB or less,
    wait to be written."""
    lib = _load()
    if lib is None:
        return False
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    if rows.ndim != 2:
        raise ValueError(f"rows must be 2-D; got shape {rows.shape}")
    n = lib.write_rows_fixed12(
        path.encode(), mode.encode(),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows.shape[0], rows.shape[1], sep.encode(),
    )
    if n != rows.shape[0]:
        raise OSError(f"native writer failed for {path!r} (wrote {n} rows)")
    timing.count("io.prf.write_threads", lib.write_rows_fixed12_threads())
    return True


def parse_table(path: str):
    """Parse an ASCII numeric table (whitespace/comma separated; header and
    comment lines skipped) into a 2-D float64 array, or ``None`` when the
    native library is unavailable or the table is ragged (callers fall back
    to the Python reader)."""
    lib = _load()
    if lib is None:
        return None
    try:
        size = os.path.getsize(path)
    except OSError:
        return None
    # every value needs >= 2 bytes ("0 ", "1,"), so size//2+1 bounds the count
    bound = size // 2 + 1
    out = np.empty(bound, dtype=np.float64)
    ncols = ctypes.c_long(0)
    n = lib.parse_table(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        bound, ctypes.byref(ncols))
    if n < 0 or ncols.value <= 0 or n % ncols.value != 0:
        return None
    return out[:n].reshape(n // ncols.value, ncols.value).copy()


def parse_tables(paths, max_workers: int | None = None):
    """Parse many tables concurrently (the native parser releases the GIL).

    Returns a list of 2-D arrays with ``None`` for any file the native path
    could not handle — or ``None`` entirely if the library is unavailable.
    """
    if _load() is None:
        return None
    from concurrent.futures import ThreadPoolExecutor

    paths = list(paths)
    if max_workers is None:
        max_workers = min(32, (os.cpu_count() or 4), max(1, len(paths)))
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(parse_table, paths))


# ---------------------------------------------------------------------------
# podfs_replay.c — the solver-side C replay library (native/podfs_replay.h)
# ---------------------------------------------------------------------------

_REPLAY_SRC = os.path.join(os.path.dirname(__file__), "podfs_replay.c")
_REPLAY_LIB = None
_REPLAY_TRIED = False


def _load_replay():
    global _REPLAY_LIB, _REPLAY_TRIED
    with _LOCK:
        if _REPLAY_TRIED:
            return _REPLAY_LIB
        _REPLAY_TRIED = True
        path = _compile(_REPLAY_SRC, "libpodfs_replay.so")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.podfs_load.restype = ctypes.c_void_p
            lib.podfs_load.argtypes = [ctypes.c_char_p]
            lib.podfs_free.restype = None
            lib.podfs_free.argtypes = [ctypes.c_void_p]
            for name, res in (("podfs_num_points", ctypes.c_long),
                              ("podfs_num_vars", ctypes.c_long),
                              ("podfs_num_modes", ctypes.c_long),
                              ("podfs_period", ctypes.c_double),
                              ("podfs_points",
                               ctypes.POINTER(ctypes.c_double))):
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = [ctypes.c_void_p]
            lib.podfs_eval.restype = ctypes.c_int
            lib.podfs_eval.argtypes = [
                ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double)]
            lib.podfs_eval_batch.restype = ctypes.c_int
            lib.podfs_eval_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                ctypes.c_long, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double)]
            _REPLAY_LIB = lib
        except (OSError, AttributeError):
            _REPLAY_LIB = None
        return _REPLAY_LIB


def podfs_replay_available() -> bool:
    return _load_replay() is not None


class NativePODFSReplayer:
    """ctypes handle to the C solver-side replay library — the code a CFD
    solver links (``native/podfs_replay.h``).

    Loads only the ``.prf`` model flavor (the dependency-free on-disk
    format); raises ``RuntimeError`` if the library or the model cannot be
    loaded.  Use as a context manager or call :meth:`close`.
    """

    def __init__(self, model_dir: str):
        lib = _load_replay()
        if lib is None:
            raise RuntimeError("native podfs_replay library unavailable "
                               "(no C compiler?)")
        self._lib = lib
        self._h = lib.podfs_load(os.fsencode(model_dir))
        if not self._h:
            raise RuntimeError(f"podfs_load failed for {model_dir!r}")
        self.num_points = int(lib.podfs_num_points(self._h))
        self.num_vars = int(lib.podfs_num_vars(self._h))
        self.num_modes = int(lib.podfs_num_modes(self._h))
        self.period = float(lib.podfs_period(self._h))
        pts = lib.podfs_points(self._h)
        self.points = np.ctypeslib.as_array(
            pts, shape=(self.num_points, 3)).copy()

    def eval(self, t: float, alpha: float = 1.0) -> np.ndarray:
        """Field at one time -> (Np, num_vars); (Np, 3) u,v,w for velocity
        models."""
        out = np.empty((self.num_points, self.num_vars), dtype=np.float64)
        rc = self._lib.podfs_eval(
            self._h, float(t), float(alpha),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if rc != 0:
            raise RuntimeError(f"podfs_eval failed (rc={rc})")
        return out

    def eval_batch(self, ts, alpha: float = 1.0) -> np.ndarray:
        """Fields at a batch of times -> (Nt, Np, num_vars)."""
        ts = np.ascontiguousarray(ts, dtype=np.float64).ravel()
        out = np.empty((ts.shape[0], self.num_points, self.num_vars),
                       dtype=np.float64)
        rc = self._lib.podfs_eval_batch(
            self._h, ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ts.shape[0], float(alpha),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if rc != 0:
            raise RuntimeError(f"podfs_eval_batch failed (rc={rc})")
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.podfs_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
