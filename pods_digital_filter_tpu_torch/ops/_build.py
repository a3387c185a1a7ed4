"""Build and bind the CUDA sources of ``csrc/`` (route: ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``).

Nothing is built when a module is imported: :func:`load` compiles on first
use, into ``csrc/_build/`` under a name keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    """Compile ``csrc/*.cu`` unless the hashed library already exists."""
    out = library_path()
    if out.exists():
        return BuildInfo(out, None, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return BuildInfo(out, seconds, proc.stdout + proc.stderr)


def _bind(lib: ctypes.CDLL) -> None:
    c_int, c_uint, c_void_p = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p
    lib.fused_filter_smem_bytes.argtypes = [c_int, c_int]
    lib.fused_filter_smem_bytes.restype = c_int
    lib.fused_filter_smem_limit.argtypes = [c_int]
    lib.fused_filter_smem_limit.restype = c_int
    lib.fused_filter_error_string.argtypes = [c_int]
    lib.fused_filter_error_string.restype = ctypes.c_char_p
    lib.fused_filter_launch.argtypes = [
        c_int, c_void_p, c_void_p, c_void_p, c_void_p,   # mode, noise, out, by, bz
        c_int, c_int, c_int, c_int,                      # nfy, nfz, jma, kma
        c_int, c_int,                                    # components, slabs
        c_uint, c_uint, c_uint,                          # t0, key0, key1
        ctypes.c_float, c_void_p,                        # scale, stream
    ]
    lib.fused_filter_launch.restype = c_int


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
