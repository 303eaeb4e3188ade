"""Builds the hand-written CUDA kernels and loads them with ctypes.

`load_library()` compiles every `csrc/*.cu` of the package with nvcc for
Hopper (sm_90a) into one shared library with a plain C interface, at first
use, into `_build/` beside this file (listed in .gitignore). The library's
name carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. A failed build raises with nvcc's
output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

from .utils.errors import GluError

_PKG = pathlib.Path(__file__).parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


def _sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob("*.cu"))


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in sorted(_CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return _BUILD / f"libglu_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[pathlib.Path, float, str]:
    """Compile the kernels if no library of the current sources exists.
    Returns (library path, seconds spent compiling, compiler output); the
    output holds ptxas's register and shared-memory report of each kernel."""
    so = _library_path()
    log = so.with_suffix(".log")
    if so.exists():
        return so, 0.0, log.read_text() if log.exists() else ""
    _BUILD.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, _sources())]
    start = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise GluError(f"cannot run nvcc ({' '.join(cmd)}): {e}") from e
    seconds = time.perf_counter() - start
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise GluError(f"nvcc failed with exit code {proc.returncode}:\n{output}")
    log.write_text(output)
    os.replace(tmp, so)  # atomic: a concurrent process sees no half-written library
    return so, seconds, output


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    if _lib is not None:
        return _lib
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    for name in ("glu_sort_tile", "glu_sort_single_tile_max", "glu_sort_max_streams"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = c_int
    lib.glu_error_string.argtypes = [c_int]
    lib.glu_error_string.restype = ctypes.c_char_p
    # (in pointers, out pointers, stream count, n, bit positions, count, ..., stream)
    lib.glu_group_tiles.argtypes = [ptr, ptr, c_int, c_int, ptr, c_int, ptr, ptr]
    lib.glu_scatter_runs.argtypes = [ptr, ptr, c_int, c_int, ptr, c_int, ptr, ptr, ptr]
    lib.glu_sort_single_tile.argtypes = [ptr, ptr, c_int, c_int, ptr, c_int, ptr]
    for name in ("glu_group_tiles", "glu_scatter_runs", "glu_sort_single_tile"):
        getattr(lib, name).restype = c_int
    _lib = lib
    return lib
