"""Builds the hand-written CUDA kernels and loads them with ctypes.

`load_library()` compiles every `*.cu` kernel source with nvcc for Hopper
(sm_90a), one nvcc process per source, all started together, and links the
objects into one shared library with a plain C interface, at first use,
into `_build/` beside this file (listed in .gitignore). The sources are
texts (`kernel_sources()`): the files of `csrc/` beside the package, or the
strings that the single-file distribution carries. `build()` writes them
into a staging directory under `_build/` and compiles them there, so that
their `#include "..."` lines resolve the same way in both. The library's
name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. A failed build raises with
nvcc's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import time

from .utils.errors import GluError

_PKG = pathlib.Path(__file__).parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_TIMEOUT = 600  # seconds, for the compiles and for the link

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


def nvcc_command(sources: list[pathlib.Path], output: pathlib.Path, *, shared: bool = False) -> list[str]:
    """nvcc's command that compiles sources with the package's flags into an
    object, or with shared=True into a shared library of their own."""
    return [_nvcc(), *_FLAGS, "-shared" if shared else "-c", "-o", str(output), *map(str, sources)]


def kernel_sources() -> dict[str, str]:
    """{file name: text} of every kernel source (`*.cu` and `*.cuh`), in name
    order: the package's `_CUDA_SOURCES` where it carries them as strings
    (the single-file distribution), else the files of `csrc/`."""
    carried = getattr(sys.modules[__package__], "_CUDA_SOURCES", None)
    if carried is not None:
        return dict(sorted(carried.items()))
    return {f.name: f.read_bytes().decode() for f in sorted(_CSRC.glob("*.cu*"))}


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name, text in kernel_sources().items():
        h.update(name.encode())
        h.update(text.encode())
    return _BUILD / f"libglu_kernels_{h.hexdigest()[:16]}.so"


def run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Run the commands at once; returns (exit code, output) of each. Every
    process is ended before this returns, whatever happens."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outputs = [p.communicate(timeout=_TIMEOUT)[0] for p in procs]
        return [(p.returncode, out) for p, out in zip(procs, outputs)]
    except (OSError, subprocess.TimeoutExpired) as e:
        raise GluError(f"cannot run nvcc ({' '.join(cmds[0])} ...): {e}") from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def build() -> tuple[pathlib.Path, float, str]:
    """Compile the kernels if no library of the current sources exists.
    Returns (library path, seconds spent compiling, compiler output); the
    output holds ptxas's register and shared-memory report of each kernel."""
    so = _library_path()
    log = so.with_suffix(".log")
    if so.exists():
        return so, 0.0, log.read_text() if log.exists() else ""
    _BUILD.mkdir(exist_ok=True)
    tag = f"{so.name}.{os.getpid()}"
    staging = _BUILD / f"{tag}.src"  # this build's sources and objects
    tmp = _BUILD / f"{tag}.tmp"
    start = time.perf_counter()
    try:
        staging.mkdir(exist_ok=True)
        for name, text in kernel_sources().items():
            (staging / name).write_bytes(text.encode())
        sources = sorted(staging.glob("*.cu"))
        objects = [src.with_suffix(".o") for src in sources]
        results = run_all([nvcc_command([src], o) for src, o in zip(sources, objects)])
        output = "".join(out for _, out in results)
        if any(rc != 0 for rc, _ in results):
            raise GluError(f"nvcc failed:\n{output}")
        [(rc, link_out)] = run_all([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objects)]])
        output += link_out
        if rc != 0:
            raise GluError(f"nvcc failed to link, exit code {rc}:\n{link_out}")
        log.write_text(output)
        os.replace(tmp, so)  # atomic: a concurrent process sees no half-written library
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(staging, ignore_errors=True)
    return so, time.perf_counter() - start, output


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    if _lib is not None:
        return _lib
    so, _, _ = build()
    _lib = bind_signatures(ctypes.CDLL(str(so)))
    return _lib


def bind_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of the kernels' entry points on lib; returns it."""
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    for name in ("glu_sort_tile", "glu_sort_single_tile_max", "glu_sort_max_streams", "glu_sort_bins",
                 "glu_fold_tile", "glu_scan_tile"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = c_int
    lib.glu_error_string.argtypes = [c_int]
    lib.glu_error_string.restype = ctypes.c_char_p
    # (keys, n, bit positions, bits per pass, passes, hist, stream)
    lib.glu_digit_histograms.argtypes = [ptr, c_int, ptr, ptr, c_int, ptr, ptr]
    # (in pointers, out pointers, stream count, n, bit positions, count, ..., stream)
    lib.glu_onesweep_pass.argtypes = [ptr, ptr, c_int, c_int, ptr, c_int, ptr, ptr, ptr]
    # (n, passes) -> int32 words of glu_onesweep_sort's work buffer
    lib.glu_onesweep_sort_work_words.argtypes = [c_int, c_int]
    # (in, out and tmp pointers, stream count, n, bit positions, bits per pass, passes, work, stream)
    lib.glu_onesweep_sort.argtypes = [ptr, ptr, ptr, c_int, c_int, ptr, ptr, c_int, ptr, ptr]
    # (in pointers, out pointers, stream count, n, bit positions, bits per pass, passes, stream)
    lib.glu_sort_single_tile.argtypes = [ptr, ptr, c_int, c_int, ptr, ptr, c_int, ptr]
    # (input, parts, len, components, ctas, dtype, op, tickets, partials, output, stream)
    lib.glu_reduce.argtypes = [ptr, c_int, ctypes.c_longlong, c_int, c_int, c_int, c_int, ptr, ptr, ptr, ptr]
    # (input, output, parts, len, dtype, op, zeroed status words, stream)
    lib.glu_scan_pass.argtypes = [ptr, ptr, c_int, ctypes.c_longlong, c_int, c_int, ptr, ptr]
    for name in ("glu_digit_histograms", "glu_onesweep_pass", "glu_onesweep_sort_work_words", "glu_onesweep_sort",
                 "glu_sort_single_tile", "glu_reduce", "glu_scan_pass"):
        getattr(lib, name).restype = c_int
    return lib
