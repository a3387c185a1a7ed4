"""Build and bind the CUDA sources of ``csrc/`` (route: ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``).

Nothing is built when a module is imported: :func:`load` compiles on first
use, into ``csrc/_build/`` under a name keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.  Each
``csrc/*.cu`` is compiled by its own ``nvcc``, all started together, and the
objects are linked into one library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED = None          # (ctypes.CDLL, BuildInfo) once loaded


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float | None   # nvcc wall time; None when the library was cached
    log: str                # nvcc's output (ptxas register / smem report)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked for {cand} and on PATH); the CUDA "
            "kernels are built from csrc/ on first use and need the CUDA "
            "toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpodfs_kernels_{h.hexdigest()[:16]}.so"


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` unless the hashed library already exists: one
    ``nvcc -c`` per source, run in parallel, then one link."""
    out = library_path()
    if out.exists():
        return BuildInfo(out, None, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    t = time.perf_counter()
    procs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in procs:
        text = proc.communicate()[0]
        log.append(f"{os.path.basename(cmd[-1])}:\n{text}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}): "
                          f"{' '.join(cmd)}\n{text}")
    objs = [obj for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return BuildInfo(out, time.perf_counter() - t, "".join(log))


def _bind(lib: ctypes.CDLL) -> None:
    c_int, c_uint, c_void_p = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p
    c_float = ctypes.c_float
    lib.fused_filter_smem_bytes.argtypes = [c_int] * 5
    lib.fused_filter_smem_bytes.restype = c_int
    lib.fused_filter_smem_limit.argtypes = [c_int]
    lib.fused_filter_smem_limit.restype = c_int
    lib.fused_filter_error_string.argtypes = [c_int]
    lib.fused_filter_error_string.restype = ctypes.c_char_p
    lib.fused_filter_launch.argtypes = [
        c_int, c_int, c_int,                     # mode, bf16 taps, bf16 out
        c_void_p, c_void_p, c_void_p,            # noise, out, dummy
        c_void_p, c_void_p,                      # by, bz
        c_int, c_int, c_int, c_int,              # nfy, nfz, jma, kma
        c_int, c_int,                            # components, slabs
        c_int, c_int,                            # strip width, step rows
        c_uint, c_uint, c_uint,                  # t0, key0, key1
        c_float, c_float, c_void_p,              # scale, iota scale, stream
        ctypes.POINTER(c_int),                   # slots (a query) or None
    ]
    lib.fused_filter_launch.restype = c_int
    lib.toeplitz_gemm_smem_bytes.argtypes = [c_int, c_int]
    lib.toeplitz_gemm_smem_bytes.restype = c_int
    lib.toeplitz_gemm_launch.argtypes = [
        c_int, c_int,                            # bf16 taps, bf16 noise
        c_void_p, c_void_p, c_void_p, c_void_p,  # noise, bz, by, out
        c_void_p,                                # scratch (f32 taps: t)
        c_int, c_int, c_int, c_int, c_int,       # jn, kn, jma, kma, total
        c_int, c_int, c_int,                     # bz, by row lengths, chunk
        c_void_p,                                # stream
    ]
    lib.toeplitz_gemm_launch.restype = c_int
    lib.noise_probe_launch.argtypes = [
        c_int, c_int, c_void_p,                  # mode, bf16 out, out
        c_int, c_int, c_int, c_int, c_int,       # jn, kn, components, slabs, G
        c_uint, c_uint, c_uint,                  # t0, key0, key1
        c_float, c_float, c_void_p,              # scale16, scale32, stream
    ]
    lib.noise_probe_launch.restype = c_int
    lib.fused_temporal_smem_bytes.argtypes = [c_int] * 5
    lib.fused_temporal_smem_bytes.restype = c_int
    lib.fused_temporal_slots.argtypes = [c_int] * 8
    lib.fused_temporal_slots.restype = c_int
    lib.fused_temporal_launch.argtypes = [
        c_int, c_void_p, c_void_p,               # bf16 taps, noise, out
        c_void_p, c_void_p, c_void_p,            # bx, by, bz
        c_int, c_int, c_int, c_int, c_int,       # nfx, nfy, nfz, jma, kma
        c_int, c_int, c_int,                     # components, nsteps, chunk
        c_int, c_int,                            # tile width, tile rows
        c_uint, c_uint, c_uint,                  # t0, key0, key1
        c_float, c_void_p,                       # scale, stream
    ]
    lib.fused_temporal_launch.restype = c_int
    lib.fused_tail_smem_bytes.argtypes = [c_int]
    lib.fused_tail_smem_bytes.restype = c_int
    lib.fused_tail_slots.argtypes = [c_int, c_int, c_int]
    lib.fused_tail_slots.restype = c_int
    lib.fused_tail_launch.argtypes = [
        c_int,                                   # bf16 out
        c_void_p, c_void_p, c_void_p, c_void_p,  # z, out, factors, means
        c_void_p, c_void_p, c_void_p,            # center, bx, rotation
        c_int, ctypes.c_longlong, c_int,         # nfx, points, nsteps
        c_int, c_void_p,                         # chunk, stream
    ]
    lib.fused_tail_launch.restype = c_int


def load():
    """``(library, BuildInfo)``, building on first use."""
    global _LOADED
    with _LOCK:
        if _LOADED is None:
            info = build()
            lib = ctypes.CDLL(str(info.path))
            _bind(lib)
            _LOADED = (lib, info)
        return _LOADED


def check_launch(err: int, what: str) -> None:
    """Raise if a launch entry point returned a cudaError_t other than 0."""
    if err != 0:
        lib, _ = load()
        raise RuntimeError(
            f"{what} failed to launch: "
            f"{lib.fused_filter_error_string(err).decode()} (cudaError {err})")
