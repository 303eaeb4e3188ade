# GENERATED by `python -m glu_tpu_torch.amalgamate` from glu_tpu_torch/: do not edit.
"""glu_tpu_torch in one file: copy it into a project and `import glu_tpu_torch_single as glu`.

It is the package glu_tpu_torch, the PyTorch/CUDA port of glu_tpu (every
name of glu_tpu_torch.__all__, and `glu.parallel`, `glu.entry`), and it
imports torch and nothing of the package it was made from. _MODULES holds
each module's source under its dotted name, _CUDA_SOURCES each CUDA kernel
source under its file name. On import the file makes itself a package and
installs an import hook that runs each module of _MODULES as a submodule of
this one, so each keeps its own globals and its relative imports. The
kernels are compiled at first use from _CUDA_SOURCES with nvcc (sm_90a)
into _build/ beside this file.
"""

import importlib.abc
import importlib.machinery
import linecache
import sys

_MODULES = {
    'glu_tpu_torch': r'''"""glu_tpu_torch — the port of glu_tpu to PyTorch and hand-written CUDA kernels
for NVIDIA Hopper (H100).

It mirrors glu_tpu's layout and public names. Ported so far: the utility
layer; the stable LSD radix sort of u32 key/value pairs (`radix_sort`,
`RadixSort`), whose engine runs three CUDA kernels (ops/_cuda_sort.py,
csrc/radix_sort.cu), and its variants on the same engine (keys-only,
multi-payload, argsort, f32/i32/u64 keys, `descending=`, `bits=`,
segmented); the reduce (`reduce`, `segmented_reduce`, `Reduce`,
kernel K5 in csrc/reduce.cu) and the scan (`exclusive_scan`,
`inclusive_scan`, `BlellochScan`, kernel K4 in csrc/scan.cu), and the
router that picks the kernels or torch's call for a sort or reduce given
`backend=None`, by a cost model measured per card (ops/router.py); and the
subpackage `glu_tpu_torch.parallel` (not imported here): the distributed
sort, reduce and scans over a torch.distributed process group; the module
`glu_tpu_torch.entry` (not imported here): the entry points, the
main path's sort and a dry run of the distributed layer; and
`python -m glu_tpu_torch.amalgamate`, which writes the whole package as one
file, dist/glu_tpu_torch_single.py. A function
given a tensor works on the tensor's device; a function that makes a tensor
(`from_numpy`, `DeviceBuffer`, `RadixSort.prepare_internal_buffers`) puts
it on the card unless given `device=`. The package imports torch and never
jax.
"""

from .utils.dtypes import DataType, dtype_info, to_torch_dtype, to_type_str
from .utils.errors import GluError, check_argument, check_state, fail
from .utils.math import (
    div_ceil,
    is_power_of_2,
    log2_ceil,
    log2_floor,
    log32_ceil,
    log32_floor,
    next_power_of_2,
)
from .utils.buffers import DeviceBuffer, copy_buffer, default_device, from_numpy, to_numpy
from .utils.timing import measure_elapsed_time
from .ops.radix_sort import (
    RadixSort,
    radix_argsort,
    radix_sort,
    radix_sort_f32,
    radix_sort_i32,
    radix_sort_keys,
    radix_sort_multi,
    radix_sort_segmented,
    radix_sort_u64,
    radix_sort_u64_parts,
    varying_key_bits,
)
from .ops.reduce import Reduce, ReduceOperator, reduce, segmented_reduce
from .ops.scan import BlellochScan, exclusive_scan, inclusive_scan

__version__ = "0.1.0"

__all__ = [
    "DataType",
    "dtype_info",
    "to_torch_dtype",
    "to_type_str",
    "GluError",
    "check_argument",
    "check_state",
    "fail",
    "div_ceil",
    "is_power_of_2",
    "log2_ceil",
    "log2_floor",
    "log32_ceil",
    "log32_floor",
    "next_power_of_2",
    "DeviceBuffer",
    "copy_buffer",
    "default_device",
    "from_numpy",
    "to_numpy",
    "measure_elapsed_time",
    "RadixSort",
    "radix_sort",
    "radix_sort_f32",
    "radix_sort_i32",
    "radix_sort_keys",
    "radix_sort_multi",
    "radix_sort_segmented",
    "radix_sort_u64",
    "radix_sort_u64_parts",
    "radix_argsort",
    "varying_key_bits",
    "Reduce",
    "ReduceOperator",
    "reduce",
    "segmented_reduce",
    "BlellochScan",
    "exclusive_scan",
    "inclusive_scan",
]
''',
    'glu_tpu_torch._build': r'''"""Builds the hand-written CUDA kernels and loads them with ctypes.

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
    for name in ("glu_sort_tile", "glu_sort_single_tile_max", "glu_sort_slice_max",
                 "glu_sort_max_cluster", "glu_sort_max_streams", "glu_sort_bins", "glu_fold_tile", "glu_scan_tile",
                 "glu_bucket_smem_splitters"):
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
    # (in pointers, out pointers, stream count, n, bit positions, bits per pass, passes, CTAs, stream)
    lib.glu_sort_single_tile.argtypes = [ptr, ptr, c_int, c_int, ptr, ptr, c_int, c_int, ptr]
    # (keys in, values in, keys out, values out, n, bit positions, bits per pass, passes, CTAs, stream)
    lib.glu_sort_pairs_single_tile.argtypes = [ptr, ptr, ptr, ptr, c_int, ptr, ptr, c_int, c_int, ptr]
    # (CTAs) -> clusters of K3 the device holds at once
    lib.glu_sort_single_tile_clusters.argtypes = [c_int]
    # (stream count) -> CTAs of a onesweep pass an SM holds at once
    lib.glu_onesweep_ctas_per_sm.argtypes = [c_int]
    # (input, parts, len, components, ctas, dtype, op, tickets, partials, output, stream)
    lib.glu_reduce.argtypes = [ptr, c_int, ctypes.c_longlong, c_int, c_int, c_int, c_int, ptr, ptr, ptr, ptr]
    # (input, output, parts, len, dtype, op, zeroed status words, stream)
    lib.glu_scan_pass.argtypes = [ptr, ptr, c_int, ctypes.c_longlong, c_int, c_int, ptr, ptr]
    # (keys, n, base, splitter keys, splitter indices, splitters, output, stream)
    lib.glu_bucket_of.argtypes = [ptr, ctypes.c_longlong, ctypes.c_longlong, ptr, ptr, c_int, ptr, ptr]
    # (hi, lo, n, base, splitter hi, splitter lo, splitter indices, splitters, output, stream)
    lib.glu_bucket_of64.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_longlong, ptr, ptr, ptr, c_int, ptr, ptr]
    for name in ("glu_digit_histograms", "glu_onesweep_pass", "glu_onesweep_sort_work_words", "glu_onesweep_sort",
                 "glu_sort_single_tile", "glu_sort_pairs_single_tile", "glu_sort_single_tile_clusters",
                 "glu_onesweep_ctas_per_sm", "glu_reduce", "glu_scan_pass", "glu_bucket_of", "glu_bucket_of64"):
        getattr(lib, name).restype = c_int
    return lib
''',
    'glu_tpu_torch.entry': r'''"""Entry points of the port (counterpart of __graft_entry__.py).

`entry()` gives the main path as a function and its example inputs: the
stable key/value sort of 65,536 u32 pairs, on the card. `dryrun_multichip(n)`
runs the distributed layer once over an n-rank process group on tiny
shapes, one spawned process a rank: the distributed sort under both local
backends, with 2 chunks, with `bits="auto"` on low-entropy keys and on
64-bit keys, and the distributed reduce and exclusive scan, each rank's
result checked against numpy.

On the card a rank is a process on its own card (NCCL); with
`device="cpu"` the ranks are CPU processes (gloo). Neither falls back to
the other: with no card, or fewer cards than ranks, both raise GluError
before anything starts.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import tempfile
import time
import traceback

import numpy as np
import torch

from .ops.backend import resolve_backend
from .ops.radix_sort import radix_sort
from .utils.buffers import default_device, from_numpy, to_numpy
from .utils.errors import GluError, check_argument, check_state

ENTRY_N = 65536  # pairs of entry()'s example: SINGLE_TILE_MAX, so K3 alone, on a cluster of CTAs
DRYRUN_N_LOCAL = 1024  # pairs a rank in dryrun_multichip
COLLECTIVE_TIMEOUT_S = 60  # the process group's: a collective that waits longer raises
DRYRUN_TIMEOUT_S = 300  # the whole dry run: spawn, import torch, join the group, the cases


def entry(device=None):
    """(fn, (keys, values)): the stable u32 key/value radix sort and its
    example inputs, 65,536 pairs of torch.uint32 on `device` (by default
    the card; raises GluError without one). The keys come from a
    torch.Generator seeded with 0 on the CPU, so every device gets the same
    ones; the values are arange(65,536). `fn(keys, values)` is radix_sort
    with the backend resolved once, here ("cuda" unless
    GLU_TPU_TORCH_BACKEND says otherwise): on the card, one sort_single_tile
    launch (K3 on a thread-block cluster), as the JAX entry's sort is one
    _single_block_sort."""
    device = default_device(device)
    gen = torch.Generator().manual_seed(0)
    keys = torch.randint(-(2**31), 2**31, (ENTRY_N,), dtype=torch.int32, generator=gen)
    keys = keys.to(device).view(torch.uint32)
    values = torch.arange(ENTRY_N, dtype=torch.int32, device=device).view(torch.uint32)
    backend = resolve_backend(None, keys)

    def fn(keys, values):
        return radix_sort(keys, values, backend=backend)

    return fn, (keys, values)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the distributed layer once over an n_devices-rank process group,
    one spawned process a rank (the cases of __graft_entry__.py's
    dryrun_multichip; see the module's docstring). device None (or "cuda")
    puts rank r on card r under NCCL, and raises GluError when fewer than
    n_devices cards are present; "cpu" runs gloo processes. Waits at most
    DRYRUN_TIMEOUT_S; any rank's failure or death ends every rank and
    raises GluError with its traceback."""
    check_argument(isinstance(n_devices, int) and n_devices >= 1, "n_devices must be a positive int, got %r",
                   n_devices)
    kind = default_device(device).type
    check_argument(kind in ("cpu", "cuda"), "dryrun_multichip runs on cpu or cuda, not %s", kind)
    if kind == "cuda":
        have = torch.cuda.device_count()
        check_state(have >= n_devices, "need %d CUDA devices, have %d", n_devices, have)
    ctx = mp.get_context("spawn")
    answers = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="glu_dryrun_") as tmp:
        procs = [ctx.Process(target=_dryrun_rank, args=(r, n_devices, f"{tmp}/store", kind, answers), daemon=True)
                 for r in range(n_devices)]
        try:
            for p in procs:
                p.start()
            _await_ranks(procs, answers, time.monotonic() + DRYRUN_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                if p.pid is not None:
                    p.join(10)
            answers.cancel_join_thread()
            answers.close()


def _await_ranks(procs, answers, deadline: float) -> None:
    """Wait for every rank's answer, (rank, None) or (rank, traceback), on
    `answers`; raise GluError at the first failure, at the first rank that
    ends without answering, or at the deadline."""
    done = set()
    while len(done) < len(procs):
        try:
            rank, failure = answers.get(timeout=0.2)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs) if r not in done and not p.is_alive()]
            if dead:
                try:  # an answer sent just before the process ended
                    rank, failure = answers.get(timeout=1)
                except queue.Empty:
                    raise GluError(f"dryrun_multichip: rank {dead[0]} of {len(procs)} ended with exit code "
                                   f"{procs[dead[0]].exitcode} and no answer") from None
            elif time.monotonic() > deadline:
                raise GluError(f"dryrun_multichip: ranks {sorted(set(range(len(procs))) - done)} of {len(procs)} "
                               "did not answer in time")
            else:
                continue
        if failure is not None:
            raise GluError(f"dryrun_multichip: rank {rank} of {len(procs)} failed:\n{failure}")
        done.add(rank)


def _dryrun_rank(rank: int, world: int, store_path: str, kind: str, answers) -> None:
    """A rank's process: join the group, run the cases, answer."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        device = torch.device("cuda", rank) if kind == "cuda" else torch.device("cpu")
        if kind == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            _dryrun_cases(rank, world, device)
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent raises it; a hung collective raises after the group's timeout
        answers.put((rank, traceback.format_exc()))
        return
    answers.put((rank, None))


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _dryrun_cases(rank: int, world: int, device: torch.device) -> None:
    """Every case on this rank's slice of one global array, the same on
    every rank (made from a seed), each checked against numpy."""
    from .ops.reduce import ReduceOperator
    from .parallel import (distributed_exclusive_scan, distributed_radix_sort, distributed_radix_sort_u64_parts,
                           distributed_reduce)

    n = DRYRUN_N_LOCAL * world
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    values = np.arange(n, dtype=np.uint32)
    mine = slice(rank * DRYRUN_N_LOCAL, (rank + 1) * DRYRUN_N_LOCAL)

    def shard(a: np.ndarray) -> torch.Tensor:
        return from_numpy(a[mine], device)

    def check_sort(label: str, out, order: np.ndarray, streams) -> None:
        """out: (*sorted streams, counts, overflow) of this rank; order:
        the global stable order; streams: the global arrays it permutes."""
        *got, counts, overflow = (to_numpy(t) for t in out)
        _expect(int(counts.sum()) == n and not overflow.any(),
                f"{label}: counts {counts.tolist()} (want a total of {n}), overflow {overflow.tolist()}")
        start = int(counts[:rank].sum())
        mine_sorted = order[start:start + int(counts[rank])]
        for i, (g, a) in enumerate(zip(got, streams)):
            _expect(np.array_equal(g, a[mine_sorted]), f"{label}: output {i} differs from numpy's stable sort")

    order = np.argsort(keys, kind="stable")
    for backend in ("torch", "cuda"):
        check_sort(f"distributed_radix_sort backend={backend}",
                   distributed_radix_sort(shard(keys), shard(values), backend=backend), order, (keys, values))
    check_sort("distributed_radix_sort pipeline_chunks=2",
               distributed_radix_sort(shard(keys), shard(values), backend="torch", pipeline_chunks=2),
               order, (keys, values))
    low = keys % np.uint32(1000)
    check_sort('distributed_radix_sort bits="auto"',
               distributed_radix_sort(shard(low), shard(values), backend="torch", bits="auto"),
               np.argsort(low, kind="stable"), (low, values))
    wide = (hi.astype(np.uint64) << np.uint64(32)) | keys
    check_sort("distributed_radix_sort_u64_parts",
               distributed_radix_sort_u64_parts(shard(hi), shard(keys), shard(values), backend="torch"),
               np.argsort(wide, kind="stable"), (hi, keys, values))

    total = to_numpy(distributed_reduce(shard(keys), None, ReduceOperator.SUM, backend="cuda"))
    _expect(int(total) == int(keys.sum(dtype=np.uint32)), f"distributed_reduce: {int(total)}")
    exclusive = to_numpy(distributed_exclusive_scan(shard(keys), backend="cuda"))
    _expect(np.array_equal(exclusive, (np.cumsum(keys, dtype=np.uint32) - keys)[mine]),
            "distributed_exclusive_scan differs from numpy")
''',
    'glu_tpu_torch.ops': r'''"""Operator layer of the port (counterpart of glu_tpu/ops).

Ported so far: the stable LSD radix sort and its variants (`radix_sort`,
`RadixSort`, `radix_sort_keys`, `radix_sort_multi`, `radix_argsort`,
`radix_sort_f32`, `radix_sort_i32`, `radix_sort_u64`,
`radix_sort_u64_parts`, `radix_sort_segmented`, `varying_key_bits`), the
reduce (`reduce`, `segmented_reduce`, `Reduce`) and the scan
(`exclusive_scan`, `inclusive_scan`, `BlellochScan`), each with two
backends: "cuda" (the hand-written Hopper kernels; their plain torch
versions on a CPU tensor) and "torch" (torch's own sort, scans and
reductions), and the router (router.py), which picks one of them for a
sort or reduce of a CUDA tensor given backend=None.
"""

from .radix_sort import (
    RadixSort,
    radix_argsort,
    radix_sort,
    radix_sort_f32,
    radix_sort_i32,
    radix_sort_keys,
    radix_sort_multi,
    radix_sort_segmented,
    radix_sort_u64,
    radix_sort_u64_parts,
    varying_key_bits,
)
from .reduce import Reduce, ReduceOperator, reduce, segmented_reduce
from .scan import BlellochScan, exclusive_scan, inclusive_scan
''',
    'glu_tpu_torch.ops._common': r'''"""Shared helpers of the kernel wrappers (counterpart of
glu_tpu/ops/_pallas_common.py; the GPU has no interpret mode, so the
arithmetic carries over, and the launch plumbing of the ctypes library takes
the place of pallas_call's)."""

from __future__ import annotations

import ctypes

import torch

from ..utils.errors import check_argument, check_state, fail
from ..utils.timing import start, stop


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def on_cuda(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the wrapper runs its plain version); True for
    a CUDA tensor (the wrapper launches its kernel or raises)."""
    if t.device.type == "cpu":
        return False
    check_argument(t.device.type == "cuda", "no kernel for tensors on %s", t.device)
    return True


_checked_geometry: set = set()  # (library, geometry) pairs already checked


def kernels(**geometry: int) -> ctypes.CDLL:
    """The kernel library (built on first use), with the compile-time
    geometry the caller relies on checked once per library: each keyword
    names a C entry glu_<name>() whose value must equal the keyword's."""
    from .. import _build

    lib = _build.load_library()
    key = (id(lib), tuple(sorted(geometry.items())))
    if key not in _checked_geometry:
        built = {name: getattr(lib, f"glu_{name}")() for name in geometry}
        check_state(built == geometry, "kernel geometry %s differs from the wrapper's %s", built, geometry)
        _checked_geometry.add(key)
    return lib


def current_stream(device: torch.device) -> int:
    """The handle of the current CUDA stream of `device` (an indexed CUDA
    device, whose runtime is up), read without switching devices and without
    building a torch.cuda.Stream, which costs several microseconds a call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(lib: ctypes.CDLL, fn_name: str, device: torch.device, *args, stream: int | None = None) -> None:
    """Call the library's entry `fn_name` with `args` and `stream` (by
    default the current stream of `device`), with `device` current; raise
    with CUDA's message if the launch was refused. The device is switched
    only when it is not the current one already. A span glu.launch."""
    opened = start("glu.launch")
    try:
        if stream is None:
            stream = current_stream(device)
        if device.index == torch._C._cuda_getDevice():  # torch.cuda.current_device() less its lazy-init check
            err = getattr(lib, fn_name)(*args, stream)
        else:
            with torch.cuda.device(device):
                err = getattr(lib, fn_name)(*args, stream)
    finally:
        stop(opened)
    if err != 0:
        fail("%s failed: %s (cudaError %d)", fn_name, lib.glu_error_string(err).decode(), err)
''',
    'glu_tpu_torch.ops._cuda_reduce': r'''"""K5: the reduce kernel, a hand-written Hopper fold in one launch (csrc/reduce.cu).

Counterpart of glu_tpu/ops/_pallas_reduce.py:52-150 (`_pallas_reduce_flat`,
body `_reduce_kernel`, and `pallas_reduce`'s vmap over the components of a
vector stream): it folds every row of a (P, L) tensor to one value, or of a
(P, L, C) tensor to C values, one per component, under sum, mul, min or
max, on int32, uint32, float32 or float64. The TPU kernel walks its tiles in
one sequential grid into an (8, 128) accumulator, needs the u32 -> i32
isomorphisms and a mul butterfly for Mosaic, and reads a vector stream as a
transposed (C, N) copy; none of that carries over. On the GPU one launch of
`glu_reduce` runs `ctas_per_partition` CTAs per row, CTA k taking tiles k,
k + ctas, ... of TILE flat elements: coalesced loads (16 bytes a thread
where aligned), a fold per component in each thread, a warp-shuffle tree
and a shared-memory tree. Each CTA writes its C partials and draws a ticket;
the last CTA of a row folds the row's partials in CTA order, so float
results are the same from run to run, and sets the ticket back to 0. The
ragged last tile is masked, not padded; an (N, C) stream is read where it
lies.

The tickets and partials live in one scratch buffer per (device, stream),
zeroed once when it is made: whenever a row has more than one CTA, P * ctas
<= MAX_CTAS, so its size is fixed, and since the kernel leaves every ticket
at 0, no call pays for a fill. One buffer per stream keeps two reduces on two
streams apart.

`reduce_partitions` checks its argument, allocates its output (one
new_empty), launches on the current stream and counts its launches; given a
CPU tensor it runs the plain version `reduce_partitions_ref` instead.
"""

from __future__ import annotations

import torch

from ..utils.errors import check_argument
from ..utils.timing import start, stop
from ._common import cdiv, current_stream, kernels, launch, on_cuda
from .reduce import ReduceOperator, _fold, _from_work, _to_work, _work_identity, check_kernel_dtype

# Fold tile in flat elements, fixed at compile time in csrc/fold.cuh
# (kFoldTile) and checked when the library is loaded. The plain version reads
# it at call time, so the CPU tests shrink it to reach many tiles and ragged
# tails at tiny n.
TILE = 4096
# CTAs in all, split over the rows: enough to fill the card (132 SMs, 8 CTAs
# of 256 threads each) at any P.
MAX_CTAS = 1056
# Components of a (P, L, C) input the kernel takes.
COMPONENTS = (1, 2, 4)
# Scratch of one (device, stream), in int64 words: MAX_CTAS u32 tickets, then
# MAX_CTAS * 4 partials of up to 8 bytes.
_TICKET_WORDS = MAX_CTAS // 2
_SCRATCH_WORDS = _TICKET_WORDS + MAX_CTAS * max(COMPONENTS)

DTYPE_CODES = {torch.int32: 0, torch.uint32: 1, torch.float32: 2, torch.float64: 3}

# Launch count, bumped only where the kernel is launched.
reduce_launches = 0

_lib = None  # the kernel library, its geometry checked, at the first launch
_scratch: dict = {}  # (device index, stream) -> (buffer, tickets pointer, partials pointer)


def reset_launch_counts() -> None:
    global reduce_launches
    reduce_launches = 0


def launch_counts() -> dict:
    return {"reduce": reduce_launches}


def check_partitions(x: torch.Tensor, *, components: bool = False) -> None:
    """x is a contiguous (P, L) tensor of a kernel dtype, or with
    components=True also (P, L, C) with C in COMPONENTS."""
    check_kernel_dtype(x.dtype)
    shape = x.shape
    check_argument(
        (len(shape) == 2 or (components and len(shape) == 3 and shape[2] in COMPONENTS)) and x.is_contiguous(),
        "want a contiguous (P, L)%s tensor, got %s", " or (P, L, C) with C in (1, 2, 4)" if components else "",
        tuple(shape),
    )
    check_argument(shape[0] >= 1 and shape[1] >= 1, "want P >= 1 and L >= 1, got %s", tuple(shape))


def ctas_per_partition(parts: int, length: int) -> int:
    """CTAs per row of `length` flat elements."""
    return max(1, min(cdiv(length, TILE), MAX_CTAS // parts))


def reduce_partitions_ref(x: torch.Tensor, op: ReduceOperator) -> torch.Tensor:
    """Plain version of K5: every row, as L * C flat elements, cut into tiles
    of TILE (the ragged tail filled with the identity), each tile folded per
    component, then the tile aggregates folded. Returns (P,) or (P, C)."""
    parts = x.shape[0]
    comps = x.shape[2] if x.dim() == 3 else 1
    check_argument(TILE % comps == 0, "TILE %d is not a whole number of %d-vectors", TILE, comps)
    flat = _to_work(x.reshape(parts, -1), op)
    length = flat.shape[1]
    tiles = cdiv(length, TILE)
    pad = torch.full((parts, tiles * TILE - length), _work_identity(op, x.dtype), dtype=flat.dtype, device=x.device)
    tiled = torch.cat([flat, pad], dim=1).view(parts, tiles, TILE // comps, comps)
    out = _from_work(_fold(_fold(tiled, op, 2), op, 1), op, x.dtype)
    return out if x.dim() == 3 else out.reshape(parts)


def _scratch_for(device: torch.device, stream: int) -> tuple:
    key = (device.index, stream)
    found = _scratch.get(key)
    if found is None:
        buf = torch.zeros(_SCRATCH_WORDS, dtype=torch.int64, device=device)  # on `stream`, the current one
        found = _scratch.setdefault(key, (buf, buf.data_ptr(), buf.data_ptr() + _TICKET_WORDS * 8))
    return found


def reduce_partitions(x: torch.Tensor, op: ReduceOperator) -> torch.Tensor:
    """K5 (replaces _pallas_reduce.py::_pallas_reduce_flat): fold each row
    of a contiguous (P, L) tensor, or each component of each row of a (P, L,
    C) one, under `op`, in one launch. Returns (P,) or (P, C) of x's dtype."""
    global reduce_launches, _lib
    opened = start("glu.engine.k5")
    try:
        check_partitions(x, components=True)
        check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
        if not on_cuda(x):
            return reduce_partitions_ref(x, op)
        if _lib is None:
            _lib = kernels(fold_tile=TILE)
        shape = x.shape
        parts, length = shape[0], shape[1]
        comps = shape[2] if len(shape) == 3 else 1
        ctas = ctas_per_partition(parts, length * comps)
        dev = x.device
        stream = current_stream(dev)
        _, tickets, partials = _scratch_for(dev, stream) if ctas > 1 else (None, None, None)
        out = x.new_empty(shape[:1] + shape[2:])
        launch(_lib, "glu_reduce", dev, x.data_ptr(), parts, length, comps, ctas, DTYPE_CODES[x.dtype], op.value,
               tickets, partials, out.data_ptr(), stream=stream)
        reduce_launches += 1
        return out
    finally:
        stop(opened)''',
    'glu_tpu_torch.ops._cuda_scan': r'''"""K4: the exclusive-scan kernel, a hand-written Hopper single-pass scan
with decoupled look-back (csrc/scan.cu, with the block scan of
csrc/fold.cuh and the status words of csrc/lookback.cuh).

Counterpart of glu_tpu/ops/_pallas_scan.py:131-243 (`pallas_exclusive_scan`,
body `_scan_kernel`): an exclusive scan of every partition of a (P, L)
tensor under sum, mul, min or max, on int32, uint32, float32 or float64,
seeded with the operator's identity in each partition. The TPU kernel
chains a carry through SMEM over a sequential grid of 2048 x 128 tiles and
needs the MXU byte-plane sum, the u32 -> i32 isomorphisms, a wide-column
sublane prefix and an identity-padded copy; none of that carries over.
CTAs run in no order on the GPU, so one launch of `glu_scan_pass` runs one
CTA per tile of TILE elements, each of which

  1. takes the next tile from a counter, so that the tiles before it in its
     partition belong to CTAs that are already running;
  2. reads its tile once and publishes the tile's aggregate; tile 0 of a
     partition publishes it as its inclusive value, its carry-in is the
     identity;
  3. looks back, 32 tiles at a time, for the nearest earlier tile of its
     partition that has published its inclusive value, and takes as its
     carry-in that value folded left to right with the aggregates it walked
     past, so that every tile's inclusive value is the sequential fold of
     the aggregates before it, whatever the timing: float results are the
     same from run to run;
  4. publishes its own inclusive value and writes carry op its local
     exclusive scan.

The only other device work is one `torch.zeros` of the status words and the
tile counter (`status_words`). The ragged tail of each partition is masked,
not padded.

`exclusive_scan_partitions` checks its argument, allocates with
torch.empty, launches on the current stream and counts its launches; given
a CPU tensor it runs the plain version `exclusive_scan_partitions_ref`.
"""

from __future__ import annotations

import torch

from ..utils.errors import check_argument
from ..utils.timing import start, stop
from ._common import cdiv, kernels, launch, on_cuda
from ._cuda_reduce import DTYPE_CODES, check_partitions
from .reduce import (
    ReduceOperator,
    _COMBINE,
    _cumulate,
    _fold,
    _from_work,
    _to_work,
    _work_identity,
)

# Scan tile, fixed at compile time in csrc/scan.cu (kScanTile) and checked
# when the library is loaded; the CPU tests shrink it.
TILE = 8192

# Launch count, bumped only where K4 is launched.
scan_launches = 0


def reset_launch_counts() -> None:
    global scan_launches
    scan_launches = 0


def launch_counts() -> dict:
    return {"exclusive_scan": scan_launches}


def status_words(tiles: int, dtype: torch.dtype) -> int:
    """64-bit status words of a scan of `tiles` tiles in all: one a tile,
    [flag | value], for the 4-byte types; a flag, the aggregate and the
    inclusive value for float64; then the tile counter."""
    return tiles * (3 if dtype == torch.float64 else 1) + 1


def _exclusive(w: torch.Tensor, op: ReduceOperator, dim: int, ident) -> torch.Tensor:
    """Exclusive scan of work-domain `w` along its last axis `dim`: the
    inclusive scan shifted one slot, the identity first."""
    inc = _cumulate(w, op, dim)
    first = torch.full(inc.shape[:-1] + (1,), ident, dtype=w.dtype, device=w.device)
    return torch.cat([first, inc[..., :-1]], dim=dim)


def tile_carries(aggregates: torch.Tensor, op: ReduceOperator, ident) -> torch.Tensor:
    """Each tile's carry-in from the (P, T) work-domain tile aggregates: the
    identity for tile 0 of a partition, agg[0] op agg[1] op ... op agg[j-1]
    for tile j, folded left to right as the kernel's look-back folds them.
    Float sums and products round at every step, so they are folded one
    tile at a time in that order; the other (op, dtype) pairs are exact in
    any order and take one cumulative scan."""
    if not (aggregates.dtype.is_floating_point and op in (ReduceOperator.SUM, ReduceOperator.MUL)):
        return _exclusive(aggregates, op, 1, ident)
    carries = torch.full_like(aggregates, ident)
    run = aggregates[:, 0]
    for j in range(1, aggregates.shape[1]):
        carries[:, j] = run
        run = _COMBINE[op](run, aggregates[:, j])
    return carries


def exclusive_scan_partitions_ref(x: torch.Tensor, op: ReduceOperator) -> torch.Tensor:
    """Plain version of K4, step by step: tiles of TILE elements (the ragged
    tail filled with the identity), the tile aggregates, each tile's carry-in
    the left fold of the aggregates before it in its partition
    (`tile_carries`), and each tile's exclusive scan combined with its
    carry-in."""
    parts, length = x.shape
    tiles = cdiv(length, TILE)
    w = _to_work(x, op)
    ident = _work_identity(op, x.dtype)
    pad = torch.full((parts, tiles * TILE - length), ident, dtype=w.dtype, device=x.device)
    tiled = torch.cat([w, pad], dim=1).view(parts, tiles, TILE)
    carries = tile_carries(_fold(tiled, op, 2), op, ident)
    out = _COMBINE[op](carries.unsqueeze(2), _exclusive(tiled, op, 2, ident))
    return _from_work(out.view(parts, tiles * TILE)[:, :length].contiguous(), op, x.dtype)


def exclusive_scan_partitions(x: torch.Tensor, op: ReduceOperator) -> torch.Tensor:
    """K4 (replaces _pallas_scan.py::pallas_exclusive_scan): exclusive scan
    of each row of a contiguous (P, L) tensor under `op`, in one launch.
    Returns a new (P, L) tensor of x's dtype."""
    global scan_launches
    opened = start("glu.engine.k4")
    try:
        check_partitions(x)
        check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
        if not on_cuda(x):
            return exclusive_scan_partitions_ref(x, op)
        parts, length = x.shape
        tiles = parts * cdiv(length, TILE)
        check_argument(tiles < 2**31, "too many tiles: %d partitions of %d", parts, length)
        lib, dev = kernels(scan_tile=TILE), x.device
        out = torch.empty_like(x)
        status = torch.zeros(status_words(tiles, x.dtype), dtype=torch.int64, device=dev)
        launch(lib, "glu_scan_pass", dev, x.data_ptr(), out.data_ptr(), parts, length, DTYPE_CODES[x.dtype], op.value,
               status.data_ptr())
        scan_launches += 1
        return out
    finally:
        stop(opened)''',
    'glu_tpu_torch.ops._cuda_sort': r'''"""CUDA radix-sort engine: hand-written Hopper kernels of the stable LSD sort.

Counterpart of glu_tpu/ops/_pallas_sort.py with the same contract: a stable
LSD radix sort of u32 keys carrying a LIST of u32 payload streams, over the
key bit positions given LSB-first, grouped into passes of up to 8 bits. Words
travel as int32 bit patterns (sort_streams takes uint32 ones too); the
kernels read them as uint32_t.

The TPU engine needed 1-bit splits, lane gathers and a DMA splicer because
the TPU has no atomics and no scatter. The GPU has both, so each kernel is
written anew from what it computes (csrc/radix_sort.cu):

  ONCE per sort:
    `digit_histograms` -- one read of the keys counts the digit of every
        pass; an exclusive cumsum of each pass's counts gives each digit's
        global start (in the sort, the kernel's last CTA computes it).
  PASS over bits g (LSB-first, up to 8 bits, 256 bins):
    `onesweep_pass` -- one CTA per tile of TILE elements ranks the tile
        stably by the digit of bits g, finds how many equal digits the
        earlier tiles hold by a decoupled look-back over their published
        counts, and writes every stream to its final place: each word is
        read once and written once (K1 + glue + K2 of the TPU engine, fused).
  An input of at most SINGLE_TILE_MAX elements instead takes
    K3 `sort_single_tile` -- one CTA runs every pass (the same passes of up
        to 8 bits) in shared memory; above CTA_MAX elements a thread-block
        cluster of MAX_CLUSTER CTAs does, each ranking a slice in its own
        shared memory and copying each element to the CTA whose slice holds
        its rank.

`onesweep_sort` runs a whole multi-tile sort, the histogram and every pass,
in one call to the library.

Each kernel has a wrapper that checks its arguments, allocates its outputs
with torch.empty, launches on the current stream and counts its launches,
inside a span glu.engine.k3 or glu.engine.onesweep (utils/timing.py), and a
plain torch version with the same contract (`*_ref`). A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises. `sort_streams` is the engine's entry for the sorts of
ops/radix_sort.py, whose streams and positions are checked by then, and
which may hand it uint32 words as they are: on the card it goes straight to
K3's or the multi-tile sort's launch, which the checked wrappers
`sort_single_tile` and `onesweep_sort` share; on CPU tensors it runs them
on int32 views, checks and all. The plain version of a onesweep pass
is built from the stages of the TPU engine's pass (`group_tiles_ref`,
`run_offsets`, `scatter_runs_ref`), which the tests hold against the Pallas
kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.errors import check_argument
from ..utils.timing import span, start, stop
from ._common import cdiv, kernels, launch, on_cuda

MAX_FIELD_BITS = 8      # widest onesweep pass (BINS bins)
BINS = 1 << MAX_FIELD_BITS
MAX_PASSES = 32 // MAX_FIELD_BITS  # passes digit_histograms counts at once

# Kernel geometry, fixed at compile time in csrc/radix_sort.cu (kTile,
# kSingleMax, kSliceMax, kMaxCluster, kMaxStreams, kMaxBins); the library
# is checked against it when loaded. The plain versions read TILE,
# SINGLE_TILE_MAX, SLICE_MAX and CTA_MAX at call time, so the CPU tests
# shrink them to reach many tiles, ragged tails, the single-tile path and
# K3's clusters at tiny n.
TILE = 6144
SINGLE_TILE_MAX = 65536  # K3's limit: the JAX engine's single block, _FUSE_MAX_R x LANES
SLICE_MAX = 16384        # the most elements a CTA of K3 holds (its shared memory)
MAX_CLUSTER = 8          # the portable cluster size
MAX_STREAMS = 8

# The most elements K3 sorts on one CTA; above, on a cluster of MAX_CLUSTER
# CTAs, which on the H100 is the faster from here on and 1.5x slower at
# 256-4,096 elements (tools/k3_ctas.py; PERF.md).
CTA_MAX = 6144

# Launch counts of each kernel, bumped only where the kernel is launched.
digit_histograms_launches = 0
onesweep_pass_launches = 0
sort_single_tile_launches = 0


def reset_launch_counts() -> None:
    global digit_histograms_launches, onesweep_pass_launches, sort_single_tile_launches
    digit_histograms_launches = onesweep_pass_launches = sort_single_tile_launches = 0


def launch_counts() -> dict:
    return {
        "digit_histograms": digit_histograms_launches,
        "onesweep_pass": onesweep_pass_launches,
        "sort_single_tile": sort_single_tile_launches,
    }


# ---------------------------------------------------------------------------
# argument checks and launch plumbing
# ---------------------------------------------------------------------------


def _check_streams(keys: torch.Tensor, payloads) -> list:
    streams = [keys, *payloads]
    check_argument(
        len(streams) <= MAX_STREAMS,
        "at most %d payload streams, got %d", MAX_STREAMS - 1, len(streams) - 1,
    )
    for i, s in enumerate(streams):
        check_argument(s.dtype == torch.int32, "stream %d must hold int32 words, got %s", i, s.dtype)
        check_argument(s.dim() == 1 and s.is_contiguous(), "stream %d must be 1-D and contiguous", i)
        check_argument(s.shape == keys.shape, "stream %d length mismatch", i)
        check_argument(s.device == keys.device, "stream %d is on %s, keys on %s", i, s.device, keys.device)
    check_argument(0 < keys.numel() < 2**31 - TILE, "stream length %d out of range", keys.numel())
    return streams


def _check_positions(positions, max_count: int) -> tuple:
    positions = tuple(int(p) for p in positions)
    check_argument(
        1 <= len(positions) <= max_count, "want 1..%d bit positions, got %d", max_count, len(positions)
    )
    check_argument(all(0 <= p < 32 for p in positions), "bit positions must be in 0..31")
    check_argument(len(set(positions)) == len(positions), "bit positions must be distinct")
    return positions


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


_lib = None  # the kernel library, its geometry checked, once loaded


def _sort_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = kernels(sort_tile=TILE, sort_single_tile_max=SINGLE_TILE_MAX, sort_slice_max=SLICE_MAX,
                       sort_max_cluster=MAX_CLUSTER, sort_max_streams=MAX_STREAMS, sort_bins=BINS)
    return _lib


def _launch(fn_name: str, device: torch.device, *args) -> None:
    launch(_sort_lib(), fn_name, device, *args)


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _plan_args(groups) -> tuple:
    """The passes over groups of key bits (LSB-first) in the form that
    glu_digit_histograms and glu_sort_single_tile take: every pass's bit
    positions one after another, the bit count of each pass, the pass
    count."""
    return _ints([b for g in groups for b in g]), _ints([len(g) for g in groups]), len(groups)


def _digits(words: torch.Tensor, positions) -> torch.Tensor:
    """int64 digit of each word formed by the bits at `positions` (LSB-first)."""
    d = torch.zeros(words.shape, dtype=torch.int64, device=words.device)
    for j, p in enumerate(positions):
        d |= ((words >> p) & 1).to(torch.int64) << j
    return d


# ---------------------------------------------------------------------------
# digit_histograms
# ---------------------------------------------------------------------------


def digit_histograms_ref(keys: torch.Tensor, groups) -> torch.Tensor:
    """Plain version of digit_histograms: one bincount per pass."""
    rows = [torch.bincount(_digits(keys, g), minlength=BINS) for g in groups]
    return torch.stack(rows).to(torch.int32)


def digit_histograms(keys: torch.Tensor, groups) -> torch.Tensor:
    """The counts half of K1 (_pallas_sort.py::_counts_row), for every pass
    of a sort in one read of the keys: hist[p][d] (int32, shape (len(groups),
    BINS)) is the number of keys whose digit of the bits groups[p] (1-8 of
    them, LSB-first) is d."""
    global digit_histograms_launches
    opened = start("glu.engine.onesweep")
    try:
        _check_streams(keys, [])
        groups = [_check_positions(g, MAX_FIELD_BITS) for g in groups]
        check_argument(1 <= len(groups) <= MAX_PASSES, "want 1..%d passes, got %d", MAX_PASSES, len(groups))
        if not on_cuda(keys):
            return digit_histograms_ref(keys, groups)
        hist = torch.zeros((len(groups), BINS), dtype=torch.int32, device=keys.device)
        _launch("glu_digit_histograms", keys.device, keys.data_ptr(), keys.numel(), *_plan_args(groups),
                hist.data_ptr())
        digit_histograms_launches += 1
        return hist
    finally:
        stop(opened)


# ---------------------------------------------------------------------------
# onesweep_pass and the stages of its plain version
# ---------------------------------------------------------------------------


def group_tiles_ref(keys: torch.Tensor, payloads, positions):
    """Stage 1 of a pass (what _pallas_sort.py::_group_pass computes): per
    tile, a stable sort on the digit, a gather, and the digit histogram.
    Returns (grouped keys, grouped payloads, counts[tile][digit] int32)."""
    n = keys.numel()
    bins = 1 << len(positions)
    tile = torch.arange(n, device=keys.device) // TILE
    slot = tile * bins + _digits(keys, positions)  # (tile, digit) in lexicographic order
    order = torch.sort(slot, stable=True).indices
    counts = torch.bincount(slot, minlength=cdiv(n, TILE) * bins).view(-1, bins)
    return keys[order], [v[order] for v in payloads], counts.to(torch.int32)


def run_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Stage 2: offsets[tile][d], where tile's run of digit d starts in the
    pass's output, i.e. the digit's base plus the same digit's counts in
    earlier tiles. That is one exclusive cumsum over the table in
    [digit][tile] order, the order of the runs in the output (the
    reference's scan of [digit][block], RadixSort.hpp:311; the run placement
    of _pallas_sort.py::_run_descriptors)."""
    tiles, bins = counts.shape
    by_digit = counts.t().reshape(-1)
    starts = torch.cumsum(by_digit, 0, dtype=torch.int32) - by_digit
    return starts.view(bins, tiles).t().contiguous()


def scatter_runs_ref(keys: torch.Tensor, payloads, counts: torch.Tensor, offsets: torch.Tensor, positions):
    """Stage 3 (what _pallas_sort.py::_splice_streams computes): every
    (digit, tile) run of stage 1's output, in every stream, goes to
    offsets[tile][digit]. Returns (keys, list of payloads)."""
    i = torch.arange(keys.numel(), device=keys.device)
    tile = i // TILE
    d = _digits(keys, positions)
    start = (torch.cumsum(counts, 1) - counts).to(torch.int64)  # in-tile start of each run
    dest = offsets.to(torch.int64)[tile, d] + (i - tile * TILE) - start[tile, d]
    outs = []
    for s in [keys, *payloads]:
        out = torch.empty_like(s)
        out[dest] = s
        outs.append(out)
    return outs[0], outs[1:]


def onesweep_pass_ref(keys: torch.Tensor, payloads, positions, digit_base: torch.Tensor):
    """Plain version of onesweep_pass, with the kernel's tiling and offset
    arithmetic: each tile grouped stably by digit; the place of its run of
    digit d is digit_base[d] plus d's counts in earlier tiles (what the
    look-back sums: run_offsets less its first row); then the scatter."""
    gk, gp, counts = group_tiles_ref(keys, payloads, positions)
    offsets = run_offsets(counts)
    offsets += digit_base - offsets[0]
    return scatter_runs_ref(gk, gp, counts, offsets, positions)


def onesweep_pass(keys: torch.Tensor, payloads, positions, digit_base: torch.Tensor):
    """K1 + K2 fused (replaces _pallas_sort.py::_group_pass, _run_descriptors
    and _splice_streams): one stable pass by the digit of the key bits at
    `positions` (1-8 of them, LSB-first), moving every payload stream alike.
    digit_base (int32, 2**len(positions)) is where each digit starts in the
    output: an exclusive cumsum of digit_histograms' row for this pass.
    Returns (keys, list of payloads)."""
    global onesweep_pass_launches
    opened = start("glu.engine.onesweep")
    try:
        streams = _check_streams(keys, payloads)
        positions = _check_positions(positions, MAX_FIELD_BITS)
        shape = (1 << len(positions),)
        check_argument(
            digit_base.dtype == torch.int32 and digit_base.is_contiguous() and tuple(digit_base.shape) == shape,
            "digit_base must be contiguous int32 of shape %s, got %s %s", shape, digit_base.dtype,
            tuple(digit_base.shape),
        )
        check_argument(digit_base.device == keys.device, "digit_base is on %s, keys on %s", digit_base.device,
                       keys.device)
        if not on_cuda(keys):
            return onesweep_pass_ref(keys, list(payloads), positions, digit_base)
        n = keys.numel()
        outs = [torch.empty_like(s) for s in streams]
        # a status word per (tile, bin), then the tile counter: zero at launch
        status = torch.zeros(cdiv(n, TILE) * BINS + 1, dtype=torch.int64, device=keys.device)
        _launch(
            "glu_onesweep_pass", keys.device, _pointers(streams), _pointers(outs), len(streams), n,
            _ints(positions), len(positions), digit_base.data_ptr(), status.data_ptr(),
        )
        onesweep_pass_launches += 1
        return outs[0], outs[1:]
    finally:
        stop(opened)


# ---------------------------------------------------------------------------
# K3: sort_single_tile
# ---------------------------------------------------------------------------


def sort_single_tile_ref(keys: torch.Tensor, payloads, positions):
    """Plain version of K3's function, pass by pass as the kernel runs them:
    one stable sort on the digit of each group of _pass_groups, LSB-first."""
    order = torch.arange(keys.numel(), device=keys.device)
    for g in _pass_groups(positions):
        order = order[torch.sort(_digits(keys[order], g), stable=True).indices]
    return keys[order], [v[order] for v in payloads]


def single_tile_ctas(n: int) -> int:
    """K3's CTAs for n elements: one up to CTA_MAX, else MAX_CLUSTER."""
    return 1 if n <= CTA_MAX else MAX_CLUSTER


def single_tile_slice(n: int, ctas: int) -> int:
    """The elements of each CTA's slice (the kernel's single_tile_slice): n
    split evenly, rounded up to whole 16-byte vectors, the last CTA taking
    what is left; n itself on one CTA."""
    return n if ctas == 1 else -(-cdiv(n, ctas) // 4) * 4


def sort_single_tile_cluster_ref(keys: torch.Tensor, payloads, positions, ctas: int):
    """Plain version of K3's arithmetic on `ctas` CTAs, pass by pass: CTA r
    holds the slots [r * slice, r * slice + slice) of the keys and of their
    source index; (a) each CTA counts its digits; (b) a digit's start in
    CTA r is its global start plus its count in the CTAs before r (one
    exclusive cumsum in (digit, CTA) order, run_offsets); (c) each slot goes
    to that start plus its rank among the CTA's equal digits in slot order
    (the kernel's warp, row, lane). The payloads are gathered by the final
    index."""
    n = keys.numel()
    slot = torch.arange(n, device=keys.device)
    cta = slot // single_tile_slice(n, ctas)
    index = slot  # the input position each slot holds
    for g in _pass_groups(positions):
        bins = 1 << len(g)
        group = cta * bins + _digits(keys, g)  # (CTA, digit), CTA-major
        counts = torch.bincount(group, minlength=ctas * bins)
        starts = run_offsets(counts.view(ctas, bins)).view(-1)
        in_group = torch.sort(group, stable=True).indices  # each group's slots in slot order
        first = torch.cumsum(counts, 0) - counts  # where each group starts in in_group
        rank = torch.empty_like(slot)
        rank[in_group] = starts[group[in_group]] + slot - first[group[in_group]]
        keys, index = keys.new_empty(n).index_put_((rank,), keys), index.new_empty(n).index_put_((rank,), index)
    return keys, [v[index] for v in payloads]


@functools.lru_cache(maxsize=64)
def _single_tile_plan(positions: tuple) -> tuple:
    """K3's checked bit positions and the C form of their passes, made once
    per tuple of positions: on the host they cost as much as the launch."""
    positions = _check_positions(positions, 32)
    return positions, _plan_args(_pass_groups(positions))


def sort_single_tile(keys: torch.Tensor, payloads, positions, ctas: int | None = None):
    """K3 (replaces _pallas_sort.py::_single_block_sort): the whole LSD sort
    by the bits at `positions` (1-32 of them, in passes of up to 8 bits) of
    at most SINGLE_TILE_MAX elements in one launch, on single_tile_ctas(n)
    CTAs (more than one: a thread-block cluster), or on `ctas` (1 to
    MAX_CLUSTER, each slice at most SLICE_MAX), which only the card's
    checks and timings give. Returns (keys, list of payloads)."""
    streams = _check_streams(keys, payloads)
    positions = _check_positions(positions, 32)
    n = keys.numel()
    check_argument(n <= SINGLE_TILE_MAX, "single-tile sort takes at most %d elements, got %d", SINGLE_TILE_MAX, n)
    ctas = single_tile_ctas(n) if ctas is None else ctas
    check_argument(1 <= ctas <= MAX_CLUSTER and single_tile_slice(n, ctas) <= SLICE_MAX,
                   "K3 takes 1 to %d CTAs of at most %d elements, got %d elements on %d", MAX_CLUSTER,
                   SLICE_MAX, n, ctas)
    if not on_cuda(keys):  # raises for a device with no kernel
        with span("glu.engine.k3"):
            return sort_single_tile_cluster_ref(keys, streams[1:], positions, ctas)
    return _single_tile(streams, n, positions, ctas)


def _single_tile(streams: list, n: int, positions: tuple, ctas: int):
    """K3's launch on checked CUDA streams of n 4-byte words, in a span
    glu.engine.k3: outputs empty_like the inputs (so they keep their dtype:
    the launch reads and writes the same words), the passes' plan, one
    launch on `ctas` CTAs. A (key, value) pair goes through
    glu_sort_pairs_single_tile, which takes the four pointers as integers,
    any other count of streams through glu_sort_single_tile's arrays of
    pointers. Returns (keys, list of payloads)."""
    global sort_single_tile_launches
    opened = start("glu.engine.k3")
    try:
        keys = streams[0]
        device, plan = keys.device, _single_tile_plan(positions)[1]
        outs = [torch.empty_like(s) for s in streams]
        if len(streams) == 2:
            launch(_sort_lib(), "glu_sort_pairs_single_tile", device, keys.data_ptr(), streams[1].data_ptr(),
                   outs[0].data_ptr(), outs[1].data_ptr(), n, *plan, ctas)
        else:
            launch(_sort_lib(), "glu_sort_single_tile", device, _pointers(streams), _pointers(outs), len(streams), n,
                   *plan, ctas)
        sort_single_tile_launches += 1
        return outs[0], outs[1:]
    finally:
        stop(opened)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _pass_groups(positions: tuple) -> list:
    """Passes of up to 8 bits, LSB-first: a full 32-bit sort is 4 passes,
    num_steps=3 (12 bits) 8 + 4. A stable LSD sort over the same positions
    gives the same permutation however they are grouped."""
    return [positions[i : i + MAX_FIELD_BITS] for i in range(0, len(positions), MAX_FIELD_BITS)]


def sort_streams(keys: torch.Tensor, payloads: list, positions: tuple):
    """Stable LSD radix sort of u32 keys with a list of payload streams
    permuted identically, by the key bits at `positions` (a tuple,
    LSB-first): the engine's entry for ops/radix_sort.py, whose checks the
    streams and positions have passed, n >= 2 and positions non-empty. The
    streams are 1-D and contiguous, of 4-byte words: uint32 or int32 bit
    patterns, each stream's dtype as the caller has it. Returns (sorted
    keys, list of permuted payloads), new tensors in the dtypes of the
    inputs, which are never modified.

    Up to SINGLE_TILE_MAX elements take K3 alone (above CTA_MAX on a cluster
    of CTAs); larger inputs the multi-tile sort: one digit_histograms launch
    and one onesweep_pass per group of 8 bits. CPU tensors run the checked
    wrappers and their plain versions on int32 views."""
    n = keys.numel()
    if not keys.is_cuda:
        sort = sort_single_tile if n <= SINGLE_TILE_MAX else onesweep_sort
        out_k, outs = sort(keys.view(torch.int32), [p.view(torch.int32) for p in payloads], positions)
        return out_k.view(keys.dtype), [o.view(p.dtype) for o, p in zip(outs, payloads)]
    # the C entries take the stream count and an int n
    check_argument(len(payloads) < MAX_STREAMS, "at most %d payload streams, got %d", MAX_STREAMS - 1, len(payloads))
    check_argument(0 < n < 2**31 - TILE, "stream length %d out of range", n)
    if n <= SINGLE_TILE_MAX:
        return _single_tile([keys, *payloads], n, positions, single_tile_ctas(n))
    return _onesweep([keys, *payloads], positions)


@functools.lru_cache(maxsize=64)
def _onesweep_plan(positions: tuple) -> tuple:
    """The checked passes of a multi-tile sort by `positions` and their C
    form, made once per tuple of positions."""
    groups = [_check_positions(g, MAX_FIELD_BITS) for g in _pass_groups(positions)]
    check_argument(1 <= len(groups) <= MAX_PASSES, "want 1..%d passes, got %d", MAX_PASSES, len(groups))
    return groups, _plan_args(groups)


def onesweep_sort(keys: torch.Tensor, payloads, positions):
    """The multi-tile sort: one digit_histograms launch for every pass, then
    one onesweep_pass per group of 8 key bits (LSB-first). On the card the
    whole sort is one library call (glu_onesweep_sort), so that the host
    pays one call a sort, not one a pass: the histogram's last CTA writes
    each pass's digit starts (no cumsum), each pass's status words are
    zeroed in the call, and the passes write the outputs and one scratch
    buffer in turn. Returns (keys, list of payloads), new tensors."""
    payloads = list(payloads)
    if not on_cuda(keys):
        groups = _pass_groups(tuple(positions))
        hist = digit_histograms(keys, groups)
        bases = torch.cumsum(hist, 1, dtype=torch.int32) - hist
        for g, base in zip(groups, bases):
            # rebinding at once frees each pass's input as soon as it is consumed
            keys, payloads = onesweep_pass(keys, payloads, g, base[: 1 << len(g)])
        return keys, payloads
    return _onesweep(_check_streams(keys, payloads), tuple(positions))


def _onesweep(streams: list, positions: tuple):
    """The multi-tile sort's one library call on checked CUDA streams of
    4-byte words, in a span glu.engine.onesweep. Returns (keys, list of
    payloads)."""
    global digit_histograms_launches, onesweep_pass_launches
    opened = start("glu.engine.onesweep")
    try:
        keys = streams[0]
        groups, plan = _onesweep_plan(positions)
        n, lib, npasses = keys.numel(), _sort_lib(), len(groups)
        outs = [torch.empty_like(s) for s in streams]
        # one allocation: the scratch streams (more than one pass), then the
        # work words from a 256-byte boundary (an allocation's own start)
        tmp_words = -(-len(streams) * n // 64) * 64 if npasses > 1 else 0
        buf = torch.empty(tmp_words + lib.glu_onesweep_sort_work_words(n, npasses), dtype=torch.int32,
                          device=keys.device)
        base = buf.data_ptr()
        tmp = None
        if npasses > 1:
            tmp = (ctypes.c_void_p * len(streams))(*[base + 4 * n * i for i in range(len(streams))])
        launch(lib, "glu_onesweep_sort", keys.device, _pointers(streams), _pointers(outs), tmp, len(streams), n,
               *plan, base + 4 * tmp_words)
        digit_histograms_launches += 1
        onesweep_pass_launches += npasses
        return outs[0], outs[1:]
    finally:
        stop(opened)
''',
    'glu_tpu_torch.ops._segments': r'''"""Validation of CUB-style segment boundary arrays (counterpart of
glu_tpu/ops/_segments.py:18-36).

The ragged (offsets=) forms of the scan and the reduce take S+1
nondecreasing integer boundaries with offsets[0] == 0 and offsets[-1] == n,
empty segments allowed. Eager torch always has the boundaries' values, so
the contract is always checked, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.errors import check_argument
from ..utils.timing import count


def validate_offsets(offsets, n: int, device) -> tuple[torch.Tensor, int]:
    """Returns (the boundaries as an int64 tensor on `device`, S).
    `offsets` may be a tensor on any device, a numpy array or a list. Each
    crossing between the card and the host waits for the card's stream:
    the boundaries' fetch from a card and their copy onto one."""
    offs = offsets if isinstance(offsets, torch.Tensor) else torch.from_numpy(np.asarray(offsets))
    check_argument(offs.ndim == 1, "offsets must be 1-D")
    check_argument(
        not (offs.dtype.is_floating_point or offs.dtype.is_complex or offs.dtype == torch.bool),
        "offsets must be integers, got %s", offs.dtype,
    )
    num_segments = offs.shape[0] - 1
    check_argument(num_segments >= 1, "offsets needs at least 2 entries")
    h = offs.cpu().to(torch.int64)
    check_argument(int(h[0]) == 0, "offsets[0] must be 0, got %d", int(h[0]))
    check_argument(int(h[-1]) == n, "offsets[-1] (%d) must equal the array length (%d)", int(h[-1]), n)
    check_argument(bool((h[1:] >= h[:-1]).all()), "offsets must be nondecreasing")
    out = h.to(device)
    count("host_syncs.offsets", int(offs.is_cuda) + int(out.is_cuda))
    return out, num_segments
''',
    'glu_tpu_torch.ops.backend': r'''"""Backend selection (counterpart of glu_tpu/ops/backend.py).

"cuda" means the hand-written kernels: the radix engine (ops/_cuda_sort.py),
the scan K4 (ops/_cuda_scan.py) and the reduce K5 (ops/_cuda_reduce.py). On
a CUDA tensor they launch, on a CPU tensor their plain torch versions run.
"torch" is the portable library path, the counterpart of the JAX package's
"xla" backend: one stable `torch.sort`, torch's cumulative scans, or one
torch reduction.

An explicit `backend=` wins, then the environment override
GLU_TPU_TORCH_BACKEND ("cuda" or "torch"; its own name, because glu_tpu
checks GLU_TPU_BACKEND against its own backends and both packages may share
a process). Otherwise a sort or reduce of a CUDA tensor is routed by the
per-device cost model of ops/router.py (`routable`), and everything else
takes "cuda", which on a CPU tensor runs the kernels' plain versions.
"""

from __future__ import annotations

import os

import torch

from ..utils.errors import check_argument

_VALID = ("cuda", "torch")

# Environment override, mostly for benchmarking and debugging.
_ENV_BACKEND = "GLU_TPU_TORCH_BACKEND"


def routable(backend: str | None, tensor: torch.Tensor) -> bool:
    """True when the router chooses the backend: no explicit choice, no
    override in the environment, and a tensor on the card (the counterpart
    of the JAX gate `backend is None and not env and is_tpu_backend()`)."""
    return backend is None and tensor.is_cuda and not os.environ.get(_ENV_BACKEND)


def resolve_backend(backend: str | None, tensor: torch.Tensor) -> str:
    """Resolve an explicit, environment or default backend choice for
    `tensor`, without the router."""
    check_argument(
        tensor.device.type in ("cpu", "cuda"),
        "tensors on %s are not supported (want cpu or cuda)",
        tensor.device,
    )
    if backend is None:
        backend = os.environ.get(_ENV_BACKEND) or "cuda"
    check_argument(backend in _VALID, "Invalid backend: %s (want one of %s)", backend, _VALID)
    return backend
''',
    'glu_tpu_torch.ops.radix_sort': r'''"""Stable LSD radix sort of u32 key / u32 value pairs (the reference's 4-bit
digits, 8 steps) and its variants: keys-only, any number of payloads,
argsort, f32 / i32 / u64 keys, `descending=`, `bits=` and segmented sorts.

Counterpart of glu_tpu/ops/radix_sort.py (reference glu/RadixSort.hpp:186-354)
for PyTorch on the GPU. Two backends:
  - "cuda", the radix engine of ops/_cuda_sort.py: one histogram kernel for
    every pass, then one fused onesweep kernel per 8 key bits (4 for a full
    sort; num_steps=k sorts 4k bits; bits= sorts exactly the bits given), or
    one single-tile kernel for small inputs (on a CPU tensor, their plain
    torch versions);
  - "torch", the portable path: one stable `torch.sort` on the compacted
    key, int64 for two-word keys (see _sort_torch: stable LSD passes compose
    to exactly that permutation).

Every variant is a composition over the same engine: float and signed keys
through order-preserving bijections onto u32, descending order through the
complement, u64 keys and segments through two chained sorts, more payloads
than a pass moves through an index payload and gathers, and bits="auto"
through one histogram launch that finds the varying key bits.

Contract parity: stable; u32 keys with u32 values; `num_steps` runs a partial
sort (RadixSort.hpp:273,332): after k passes the pairs are stably sorted by
the low 4k key bits; count <= 1 early-exits (:278-279). The public functions
take and return torch tensors of the JAX package's dtypes (`torch.uint32`
for u32); inside, u32 words reach the engine as they are, and wherever torch
computes on them they travel as their int32 bit patterns (`_words`), since
torch implements shifts, sums, comparisons and gathers of uint32 only by
promotion or not at all. The sorts work out of place: the inputs are never
modified (the JAX package donates them instead).
"""

from __future__ import annotations

import torch

from ..utils import timing
from ..utils.buffers import DeviceBuffer, default_device
from ..utils.errors import check_argument
from ..utils.timing import start_call, stop
from . import _cuda_sort as cs
from .backend import resolve_backend

RADIX_BITS = 4  # digit width (reference RadixSort.hpp:303: u_radix_shift = step << 2)
RADIX = 1 << RADIX_BITS  # 16 buckets
NUM_PASSES = 32 // RADIX_BITS  # 8 passes over u32 keys
FULL = tuple(range(32))

_SIGN = -(1 << 31)  # int32 sign bit: flipping it turns int32 order into u32 order
_BYTES = tuple(tuple(range(b, b + 8)) for b in range(0, 32, 8))  # the envelope's 4 digit groups
_STEP_BITS = tuple(tuple(range(s * RADIX_BITS)) for s in range(NUM_PASSES + 1))  # the key bits of num_steps=s

timing.declare("sort.two_word")  # two-word sorts (u64 keys, segments) chained on the engine
timing.declare("sort.two_word_passes")  # the 8-bit passes of both words of those sorts


# ---------------------------------------------------------------------------
# the sorts on int32-carried words
# ---------------------------------------------------------------------------


def _compact(words: torch.Tensor, positions: tuple) -> torch.Tensor:
    """The key bits at `positions` (LSB-first significance) gathered into the
    low bits of one int32-carried u32 word: the key itself for the full
    cover, the masked key for contiguous low bits."""
    if positions == FULL:
        return words
    if positions == tuple(range(len(positions))):
        return words & ((1 << len(positions)) - 1)
    c = torch.zeros_like(words)
    for j, p in enumerate(positions):
        c |= ((words >> p) & 1) << j
    return c


def _sort_torch(keys: torch.Tensor, payloads, positions: tuple):
    """Portable whole sort of 4-byte words by the key bits at `positions`:
    ONE stable torch.sort on the compacted key, sign-flipped so that int32
    order is u32 order, then a gather of every stream (counterpart of
    _sort_xla), as int32 words. k stable LSD passes over digits d0..d{k-1}
    ARE a stable sort by the concatenated value d{k-1}..d0, so the
    permutation is identical, partial and pruned sorts included."""
    keys, payloads = _words(keys), [_words(v) for v in payloads]
    order = torch.sort(_compact(keys, positions) ^ _SIGN, stable=True).indices
    return keys[order], [v[order] for v in payloads]


def _radix_sort_streams(keys: torch.Tensor, payloads: list, positions: tuple, backend: str):
    """Core entry: u32 keys + a list of payload streams permuted
    identically, as 4-byte words (uint32, or int32 bit patterns), stably
    sorted by the key bits at `positions` (LSB-first).
    Returns new tensors, except where there is nothing to sort (no
    positions, n <= 1): then the inputs come back. The inputs are not
    modified.

    A onesweep pass and K3 move at most MAX_STREAMS - 1 payloads (the JAX
    engine any number): past that the engine sorts the keys with an index
    payload, and every payload is gathered by it."""
    if not positions or keys.numel() <= 1:
        return keys, payloads
    if backend == "torch":
        return _sort_torch(keys, payloads, positions)
    if len(payloads) < cs.MAX_STREAMS:
        return cs.sort_streams(keys, payloads, positions)
    iota = torch.arange(keys.numel(), dtype=torch.int32, device=keys.device)
    out_k, (order,) = cs.sort_streams(keys, [iota], positions)
    return out_k, [_words(v).index_select(0, order) for v in payloads]


def _sort_two_words(major, minor, major_pos: tuple, minor_pos: tuple, payloads, backend: str):
    """Stable sort by the pair (major word, minor word), each word by the
    bits at its positions: u64 keys as (hi, lo), segments as (segment id,
    key). Returns (major, minor, list of payloads).

    "cuda" chains two engine sorts (LSD over the words): the minor word
    carrying (major, payloads), then the major word carrying (minor,
    payloads), whose stability keeps the minor order within equal major
    words. "torch" sorts once on the int64 of the two compacted words.

    The engine's chain counts itself (`sort.two_word`, and its passes in
    `sort.two_word_passes`) and opens a span around each of its two sorts
    (`glu.two_word.minor`, `glu.two_word.major`)."""
    if backend == "torch":
        wide = ((_compact(major, major_pos) ^ _SIGN).to(torch.int64) << 32) | (
            _compact(minor, minor_pos).to(torch.int64) & 0xFFFFFFFF
        )
        order = torch.sort(wide, stable=True).indices
        return major[order], minor[order], [v[order] for v in payloads]
    timing.count("sort.two_word")
    timing.count("sort.two_word_passes", len(cs._pass_groups(minor_pos)) + len(cs._pass_groups(major_pos)))
    opened = timing.start("glu.two_word.minor")
    try:
        minor, (major, *payloads) = _radix_sort_streams(minor, [major, *payloads], minor_pos, backend)
    finally:
        stop(opened)
    opened = timing.start("glu.two_word.major")
    try:
        major, (minor, *payloads) = _radix_sort_streams(major, [minor, *payloads], major_pos, backend)
    finally:
        stop(opened)
    return major, minor, payloads


# ---------------------------------------------------------------------------
# bits: the varying-bit envelope and the positions to sort
# ---------------------------------------------------------------------------


def _key_envelope(words: torch.Tensor, backend: str) -> torch.Tensor:
    """(OR, AND) of int32-carried words, as two u32 values in an int64
    tensor on their device (no host sync): the bits where OR ^ AND is set
    vary. Envelopes of several arrays fold into that of their union by OR
    and AND (the distributed sort's bits="auto"); an empty array's is the
    identity (0, 0xFFFFFFFF).

    "cuda": one digit_histograms launch over the four bytes (K1's counts,
    one read of the keys); bit b of byte j is set in the OR iff some byte
    value that occurs (count > 0) has it, and clear in the AND iff some
    byte value that occurs lacks it. "torch": the OR of every key's
    difference from the first, folded by halves: OR = first | diff, AND =
    first & ~diff."""
    dev = words.device
    if words.numel() == 0:
        if dev.type == "cuda":
            timing.count("host_syncs.bits_auto")  # the identity copied onto the card waits for the stream
        return torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64, device=dev)
    if backend == "torch" or words.numel() == 1:
        d = words ^ words[0]
        while d.numel() > 1:
            half = d.numel() // 2
            top = d[:half] | d[half : 2 * half]
            if d.numel() % 2:
                top[:1] |= d[-1:]
            d = top
        first = words[:1]
        return torch.cat([first | d, first & ~d]).to(torch.int64) & 0xFFFFFFFF
    occurs = (cs.digit_histograms(words, _BYTES) > 0)[:, None, :]  # (byte, 1, value)
    value = torch.arange(256, device=dev)
    has = ((value >> torch.arange(8, device=dev)[:, None]) & 1).bool()  # (bit, value)
    some_has, some_lacks = (occurs & has).any(2), (occurs & ~has).any(2)  # (byte, bit): key bit 8 * byte + bit
    weight = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(32, device=dev)
    return torch.stack([(some_has.reshape(32) * weight).sum(), (~some_lacks.reshape(32) * weight).sum()])


def _envelope_positions(or_word: int, and_word: int) -> tuple:
    """The varying bit positions, ascending, of an (OR, AND) envelope."""
    mask = or_word ^ and_word
    return tuple(b for b in range(32) if (mask >> b) & 1)


def _varying_bits(words: torch.Tensor, backend: str) -> tuple:
    """Positions of the bits of int32-carried words where they disagree:
    the set bits of OR(keys) ^ AND(keys) (_key_envelope), fetched to the
    host, which synchronises it with the device."""
    if words.numel() <= 1:
        return ()
    with timing.span("glu.bits_auto"):
        envelope = _key_envelope(words, backend).tolist()
        timing.count("host_syncs.bits_auto")
    return _envelope_positions(*envelope)


def varying_key_bits(keys: torch.Tensor) -> tuple:
    """Positions (ascending) of the key bits that actually VARY across
    `keys` (1-D torch.uint32): the bit set a stable radix sort must process;
    constant bits never change relative order. One histogram launch over the
    four bytes of the keys (its plain version on a CPU tensor) and a 4-byte
    fetch to the host, which synchronises it with the device (so it cannot be
    captured in a CUDA graph). Feed the result to radix_sort(..., bits=...),
    or pass bits="auto" to fuse the two steps, to sort in ceil(len(bits)/8)
    onesweep passes instead of 4."""
    call = start_call("glu.varying_key_bits")
    try:
        check_argument(keys.dim() == 1, "keys must be 1-D")
        check_argument(keys.dtype == torch.uint32, "keys must be uint32, got %s", keys.dtype)
        return _varying_bits(keys.view(torch.int32).contiguous(), resolve_backend(None, keys))
    finally:
        stop(call)


def _norm_steps(num_steps) -> int:
    steps = NUM_PASSES if num_steps in (0, None) else int(num_steps)
    check_argument(0 < steps <= NUM_PASSES, "num_steps must be in 1..%d or 0 for all", NUM_PASSES)
    return steps


def _norm_bits(bits, words: torch.Tensor, num_steps, backend):
    """Resolve the `bits` parameter: None -> None (the num_steps contract),
    "auto" -> the varying bits of `words` (a host sync), an iterable ->
    validated positions. Mutually exclusive with a partial num_steps.
    `backend` is the caller's: the envelope of a CUDA tensor is found by
    the kernel unless "torch" was asked for, whatever the router picks."""
    if bits is None:
        return None
    check_argument(num_steps in (0, None, NUM_PASSES), "bits cannot be combined with a partial num_steps")
    if isinstance(bits, str):
        check_argument(bits == "auto", 'bits must be None, "auto", or bit positions')
        return _varying_bits(_words(words), resolve_backend(backend, words))
    positions = tuple(int(b) for b in bits)
    for p in positions:
        check_argument(0 <= p < 32, "bit positions must be in 0..31, got %d", p)
    check_argument(len(set(positions)) == len(positions), "bit positions must be distinct")
    return positions


def _router():
    """ops/router.py, imported at the first call that routes and kept: an
    import with this module would make `python -m glu_tpu_torch.ops.router`
    load the router twice, and one inside each call costs as much as a
    check."""
    global _ROUTER
    if _ROUTER is None:
        from . import router

        _ROUTER = router
    return _ROUTER


_ROUTER = None


def _sort_words(words, payloads: list, backend, *, num_steps=0, descending: bool = False, bits=None):
    """Sort u32 keys (already in their sortable form) with a list of
    payloads, as contiguous 4-byte words (uint32, or int32 bit patterns):
    high to low through the complement, which keeps ties in input order and
    the set of varying bits; `bits` refers to the complemented key. The bit
    positions come first, then the route (ops/router.py), on (n, payloads,
    passes, whether the bits are the whole key): bits="auto" has
    synchronised the host by then. Returns (keys, list of payloads), each in
    its input's dtype or as int32 words."""
    steps = _norm_steps(num_steps)
    if descending:
        words = ~_words(words)
    positions = _STEP_BITS[steps] if bits is None else _norm_bits(bits, words, num_steps, backend)
    router = _router()
    route = router._sort_backend(backend, words, words.numel(), len(payloads), router._npasses_of(positions),
                                 positions == FULL)
    out_k, outs = _radix_sort_streams(words, payloads, positions, route)
    return (~out_k if descending else out_k), outs


# ---------------------------------------------------------------------------
# public functions
# ---------------------------------------------------------------------------


def _check_inputs(keys: torch.Tensor, key_dtype: torch.dtype, **payloads) -> None:
    """keys of key_dtype and torch.uint32 payloads: 1-D, one length, one device."""
    check_argument(keys.dim() == 1, "keys must be 1-D")
    check_argument(keys.dtype == key_dtype, "keys must be %s, got %s", key_dtype, keys.dtype)
    for name, p in payloads.items():
        check_argument(p.shape == keys.shape, "%s must be 1-D and as long as the keys", name)
        check_argument(p.dtype == torch.uint32, "%s must be uint32, got %s", name, p.dtype)
        check_argument(p.device == keys.device, "keys on %s, %s on %s", keys.device, name, p.device)


def _words(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32).contiguous()


def _u32(w: torch.Tensor) -> torch.Tensor:
    return w if w.dtype == torch.uint32 else w.view(torch.uint32)


def radix_sort(
    keys: torch.Tensor,
    values: torch.Tensor,
    num_steps: int = 0,
    *,
    backend: str | None = None,
    descending: bool = False,
    bits=None,
):
    """Stably sort (keys, values) pairs by key. Returns (sorted_keys, permuted_values).

    keys, values: 1-D torch.uint32 tensors of equal length on one device
    (CPU or CUDA). num_steps=0 runs the full 8-pass sort; num_steps=k returns
    the state after k LSD passes (stably sorted by the low 4k key bits), the
    reference's debugging affordance (RadixSort.hpp:273,332).
    descending=True sorts keys high to low, still stable (ties keep their
    input order), through complemented keys, and requires the full sort.

    bits (an extension beyond the reference): "auto" finds the key bits
    that actually vary (one histogram launch and a 4-byte fetch, which
    synchronises the host and cannot be captured in a CUDA graph) and sorts
    ONLY those: an exact, stable full sort in ceil(v/8) onesweep passes when
    v bits vary. An iterable of bit positions (LSB-first significance,
    distinct, in 0..31) sorts by exactly that bit sequence; the result is a
    full sort iff the set covers every varying bit. Incompatible with a
    partial num_steps.

    The sort works out of place: the inputs are not modified, and the
    results are new tensors except where there is nothing to sort (n <= 1,
    bits=() or bits="auto" on equal keys), when `values` (and, ascending,
    `keys`) come back as they are. backend: "cuda" for the radix engine,
    "torch" for one stable torch.sort, None for the override
    GLU_TPU_TORCH_BACKEND or, on a CUDA tensor, the router's choice by the
    card's cost model (ops/router.py; on a CPU tensor "cuda"). The route is
    chosen after bits="auto" has found the bits to sort.
    """
    call = start_call("glu.radix_sort")
    try:
        _check_inputs(keys, torch.uint32, values=values)
        check_argument(
            not (descending and num_steps not in (0, None, NUM_PASSES)),
            "descending requires the full sort (num_steps=0)",
        )
        if keys.shape[0] <= 1:  # already sorted x) (reference :278-279)
            return keys, values
        out_k, (out_v,) = _sort_words(
            keys.contiguous(), [values.contiguous()], backend, num_steps=num_steps, descending=descending, bits=bits
        )
        return _u32(out_k), _u32(out_v)
    finally:
        stop(call)


def radix_sort_keys(keys: torch.Tensor, num_steps: int = 0, *, backend: str | None = None, bits=None):
    """Stably sort u32 keys only (the reference mandates values,
    README.md:88-89; keys-only is a natural extension with the same
    kernels). See radix_sort for `num_steps` and `bits`."""
    call = start_call("glu.radix_sort_keys")
    try:
        _check_inputs(keys, torch.uint32)
        if keys.shape[0] <= 1:
            return keys
        out_k, _ = _sort_words(keys.contiguous(), [], backend, num_steps=num_steps, bits=bits)
        return _u32(out_k)
    finally:
        stop(call)


def radix_sort_multi(keys: torch.Tensor, payloads, num_steps: int = 0, *, backend: str | None = None, bits=None):
    """Stably sort u32 keys with ANY number of u32 payload streams permuted
    identically: the N-stream generalization of the reference's mandatory
    (key, value) contract (README.md:88-89). Returns (sorted_keys,
    tuple_of_permuted_payloads).

    Up to 7 payloads ride the engine's passes with the keys (one read and
    one write of every stream a pass); past 7 the keys carry an index
    payload and every payload is gathered by it once. See radix_sort for
    `num_steps`, `bits` and when inputs come back as they are."""
    call = start_call("glu.radix_sort_multi")
    try:
        payloads = tuple(payloads)
        _check_inputs(keys, torch.uint32, **{f"payload {i}": p for i, p in enumerate(payloads)})
        if keys.shape[0] <= 1:
            return keys, payloads
        out_k, outs = _sort_words(keys.contiguous(), [p.contiguous() for p in payloads], backend, num_steps=num_steps,
                                  bits=bits)
        return _u32(out_k), tuple(_u32(p) for p in outs)
    finally:
        stop(call)


def radix_argsort(keys: torch.Tensor, *, backend: str | None = None, descending: bool = False, bits=None):
    """Stable argsort of u32 keys: returns (sorted_keys, order) where
    `order` (torch.uint32) is the permutation such that sorted_keys ==
    keys[order]: the index-payload composition every "give me the
    permutation" caller otherwise writes by hand (the reference has no
    argsort; test/radix_sort_tests.cpp:111-141 sorts the user's own iota).
    Supports descending= and bits= as radix_sort does."""
    call = start_call("glu.radix_argsort")
    try:
        _check_inputs(keys, torch.uint32)
        n = keys.shape[0]
        check_argument(n < (1 << 32), "argsort indices exceed uint32")
        iota = _u32(torch.arange(n, dtype=torch.int32, device=keys.device))
        if n <= 1:
            return keys, iota
        return radix_sort(keys, iota, backend=backend, descending=descending, bits=bits)
    finally:
        stop(call)


def _f32_to_sortable(k: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection f32 -> u32 on int32 bit patterns (IEEE-754
    total order): flip every bit of a negative, the sign bit of the rest."""
    return k ^ ((k >> 31) | _SIGN)


def _sortable_to_f32(u: torch.Tensor) -> torch.Tensor:
    return (u ^ ((~u >> 31) | _SIGN)).view(torch.float32)


def radix_sort_f32(
    keys: torch.Tensor,
    values: torch.Tensor,
    *,
    backend: str | None = None,
    descending: bool = False,
    bits=None,
):
    """Stably sort (f32 key, u32 value) pairs, an extension beyond the
    reference, which sorts u32 keys only (reference README.md:88-89).

    Keys ride the same u32 engine through the standard order-preserving bit
    transform (negatives fully flipped, the rest sign-flipped), which
    realizes IEEE-754 total order: -inf < ... < -0.0 < +0.0 < ... < +inf,
    with NaNs at the ends by their sign bit. The keys are compared as bit
    patterns, never as floats. `descending` and `bits` refer to the
    TRANSFORMED keys (see radix_sort)."""
    call = start_call("glu.radix_sort_f32")
    try:
        _check_inputs(keys, torch.float32, values=values)
        if keys.shape[0] <= 1:
            return keys, values
        out_k, (out_v,) = _sort_words(
            _f32_to_sortable(keys.contiguous().view(torch.int32)), [values.contiguous()], backend,
            descending=descending, bits=bits,
        )
        return _sortable_to_f32(out_k), _u32(out_v)
    finally:
        stop(call)


def radix_sort_i32(
    keys: torch.Tensor,
    values: torch.Tensor,
    *,
    backend: str | None = None,
    descending: bool = False,
    bits=None,
):
    """Stably sort (i32 key, u32 value) pairs, an extension beyond the
    reference, which sorts u32 keys only (reference README.md:88-89).

    Signed order rides the u32 engine through the sign-bit flip (an
    order-preserving bijection i32 -> u32: INT32_MIN maps to 0, INT32_MAX to
    UINT32_MAX). `descending` and `bits` refer to the flipped keys."""
    call = start_call("glu.radix_sort_i32")
    try:
        _check_inputs(keys, torch.int32, values=values)
        if keys.shape[0] <= 1:
            return keys, values
        out_k, (out_v,) = _sort_words(keys.contiguous() ^ _SIGN, [values.contiguous()], backend,
                                      descending=descending, bits=bits)
        return out_k ^ _SIGN, _u32(out_v)
    finally:
        stop(call)


def _sort_u64_words(hi: torch.Tensor, lo: torch.Tensor, values: torch.Tensor, bits, backend):
    """The u64 sort of int32-carried words: the positions of each word,
    then the route (ops/router.py::_u64_backend), then the two-word sort.
    Returns (hi, lo, values)."""
    router = _router()
    pos_hi, pos_lo = _u64_positions(bits, hi, lo, backend)
    extra_ops = sum(1 for pos in (pos_hi, pos_lo) if pos and pos != FULL)
    npasses = router._npasses_of
    b = router._u64_backend(backend, hi, hi.numel(), npasses(pos_hi), npasses(pos_lo), extra_ops)
    out_hi, out_lo, (out_v,) = _sort_two_words(hi, lo, pos_hi, pos_lo, [_words(values)], b)
    return out_hi, out_lo, out_v


def _u64_positions(bits, hi: torch.Tensor, lo: torch.Tensor, backend) -> tuple:
    """(hi positions, lo positions): full words, the varying bits of each
    word for "auto", or an explicit (hi_positions, lo_positions) pair."""
    if bits is None or isinstance(bits, str):
        pos_lo = _norm_bits(bits, lo, 0, backend)
        pos_hi = _norm_bits(bits, hi, 0, backend)
    else:
        pair = tuple(bits)
        check_argument(
            len(pair) == 2 and not any(isinstance(p, (int, str)) for p in pair),
            "u64 explicit bits must be a (hi_positions, lo_positions) pair",
        )
        pos_hi = _norm_bits(tuple(pair[0]), hi, 0, backend)
        pos_lo = _norm_bits(tuple(pair[1]), lo, 0, backend)
    return FULL if pos_hi is None else pos_hi, FULL if pos_lo is None else pos_lo


def radix_sort_u64_parts(
    keys_hi: torch.Tensor,
    keys_lo: torch.Tensor,
    values: torch.Tensor,
    *,
    backend: str | None = None,
    bits=None,
):
    """Stably sort by a 64-bit key given as (hi, lo) u32 halves, a
    multi-word-key extension beyond the reference (u32 only,
    README.md:88-89). Returns (sorted_hi, sorted_lo, permuted_values).

    LSD composition: a full stable sort by the low word carrying (hi,
    value), then a full stable sort by the high word carrying (lo, value),
    is a stable 64-bit sort: 2 histogram launches and 8 onesweep passes of 3
    streams; "torch" sorts once on the int64 key. bits="auto" prunes the
    constant bits of EACH word (u64 keys below 2^40 skip three passes of the
    hi word); explicit positions are a PAIR (hi_positions, lo_positions).
    The inputs are not modified; where no bit of either word is sorted they
    come back as they are."""
    call = start_call("glu.radix_sort_u64_parts")
    try:
        _check_inputs(keys_hi, torch.uint32, keys_lo=keys_lo, values=values)
        if keys_hi.shape[0] <= 1:
            return keys_hi, keys_lo, values
        out_hi, out_lo, out_v = _sort_u64_words(_words(keys_hi), _words(keys_lo), values, bits, backend)
        return _u32(out_hi), _u32(out_lo), _u32(out_v)
    finally:
        stop(call)


def radix_sort_u64(keys: torch.Tensor, values: torch.Tensor, *, backend: str | None = None, bits=None):
    """Stably sort (u64 key, u32 value) pairs (keys torch.uint64) through
    the two chained 32-bit sorts of radix_sort_u64_parts, including its
    per-word bits= pruning. The words are split and joined as the int32
    pairs the keys are made of (torch implements few operations on uint64),
    one copy each way."""
    call = start_call("glu.radix_sort_u64")
    try:
        _check_inputs(keys, torch.uint64, values=values)
        if keys.shape[0] <= 1:
            return keys, values
        pairs = keys.contiguous().view(torch.int32).view(-1, 2)  # little-endian: (lo, hi) of each key
        hi, lo = pairs[:, 1].contiguous(), pairs[:, 0].contiguous()
        out_hi, out_lo, out_v = _sort_u64_words(hi, lo, values, bits, backend)
        out = torch.empty_like(pairs)
        out[:, 0], out[:, 1] = out_lo, out_hi
        return out.view(torch.uint64).view(-1), _u32(out_v)
    finally:
        stop(call)


def _seg_bits(num_segments: int) -> tuple:
    """The low bits that hold every segment id in 0..num_segments-1 (the JAX
    package's _seg_steps in 4-bit steps): the engine's passes take any bit
    count, so 300 segments cost 9 bits, one pass."""
    return tuple(range(max(1, (num_segments - 1).bit_length())))


def radix_sort_segmented(
    keys: torch.Tensor,
    values: torch.Tensor,
    num_partitions: int = 1,
    *,
    offsets=None,
    backend: str | None = None,
    bits=None,
):
    """Stably sort (keys, values) independently within adjacent segments,
    the sort-side analog of the scan's partition batching (reference
    BlellochScan.hpp:125-138; the reference has no segmented sort). Returns
    (sorted_keys, permuted_values).

    Segments are given EITHER as `num_partitions` equal-length pieces OR as
    `offsets`: S+1 nondecreasing boundaries (a tensor, numpy array or list;
    CUB begin/end-offsets style: segment s is [offsets[s], offsets[s+1]),
    offsets[0] == 0, offsets[-1] == len(keys); empty segments allowed). The
    two forms are mutually exclusive.

    Each element's segment id is made on the original layout (a scatter-add
    of the interior boundaries and a cumsum for `offsets`, which fetches the
    boundaries to the host to check them). "cuda" then chains two engine
    sorts: a full key sort carrying (value, segment id), then a sort on the
    segment id over just the bits that hold it, carrying (key, value), whose
    stability keeps the key order within each segment. "torch" sorts once on
    the int64 of (segment id, key). bits= prunes the KEY sort (see
    radix_sort); the segment-id sort is already minimal.
    """
    call = start_call("glu.radix_sort_segmented")
    try:
        _check_inputs(keys, torch.uint32, values=values)
        n = keys.shape[0]
        if offsets is not None:
            check_argument(num_partitions in (1, None), "offsets and num_partitions are mutually exclusive")
            return _radix_sort_segmented_offsets(keys, values, offsets, backend, bits)
        p = int(num_partitions)
        check_argument(p >= 1, "num_partitions must be >= 1")
        check_argument(n % p == 0, "count (%d) must divide into %d partitions", n, p)
        if p == 1:
            return radix_sort(keys, values, backend=backend, bits=bits)
        if n <= 1:
            return keys, values
        seg = torch.arange(n, dtype=torch.int32, device=keys.device) // (n // p)
        return _segmented_sort(keys, values, seg, p, backend, bits)
    finally:
        stop(call)


def _radix_sort_segmented_offsets(keys, values, offsets, backend, bits):
    """The offsets= form of radix_sort_segmented: segment ids by one
    scatter-add of the interior boundaries and a cumsum, O(n), on the
    original layout. Duplicate boundaries accumulate, so an empty segment
    skips its id; a trailing offsets[s] == n falls off the end (the JAX
    package's mode="drop")."""
    from ._segments import validate_offsets

    n = keys.shape[0]
    offs, num_segments = validate_offsets(offsets, n, keys.device)
    if num_segments == 1:
        return radix_sort(keys, values, backend=backend, bits=bits)
    if n <= 1:
        return keys, values
    inner = offs[1:-1]
    marks = torch.zeros(n + 1, dtype=torch.int32, device=keys.device)
    marks.index_add_(0, inner, torch.ones(inner.shape, dtype=torch.int32, device=keys.device))
    seg = torch.cumsum(marks[:n], 0, dtype=torch.int32)
    return _segmented_sort(keys, values, seg, num_segments, backend, bits)


def _segmented_sort(keys, values, seg, num_segments: int, backend, bits):
    """The two-word sort by (segment id, key), routed by
    ops/router.py::_segmented_backend once the key's positions are known."""
    k = _words(keys)
    positions = _norm_bits(bits, k, 0, backend)
    positions = FULL if positions is None else positions
    seg_pos = _seg_bits(num_segments)
    router = _router()
    npasses = router._npasses_of
    b = router._segmented_backend(backend, k, k.numel(), npasses(positions), npasses(seg_pos), positions == FULL)
    _, out_k, (out_v,) = _sort_two_words(seg, k, seg_pos, positions, [_words(values)], b)
    return _u32(out_k), _u32(out_v)


class RadixSort:
    """Radix sort operator object (reference glu/RadixSort.hpp:186-354).

    `RadixSort()(key_buffer, val_buffer, count, num_steps=0)` sorts the first
    `count` pairs: in place into the buffers' tensors when given
    DeviceBuffers, and as new tensors (inputs untouched) when given tensors.
    `prepare_internal_buffers(count)` builds the kernels and runs one sort of
    that size, so that the first timed call is warm (the analog of the
    reference's lazy scratch growth, :237-271).
    """

    def __init__(self):
        self._warm: set = set()

    def prepare_internal_buffers(
        self, count: int, *, backend: str | None = None, device=None
    ) -> None:
        """Warm the sort for `count` pairs on `device` (default: the card;
        raises when there is none)."""
        call = start_call("glu.RadixSort.prepare_internal_buffers")
        try:
            router = _router()
            k = torch.zeros(count, dtype=torch.int32, device=default_device(device)).view(torch.uint32)
            b = router._sort_backend(backend, k, count, 1, router._npasses_of(FULL), True)  # a full pair sort's route
            key = (count, b, k.device)
            if count <= 1 or key in self._warm:
                return
            radix_sort(k, torch.zeros_like(k.view(torch.int32)).view(torch.uint32), backend=b)
            if k.is_cuda:
                timing.count("host_syncs.prepare")
                torch.cuda.synchronize(k.device)
            self._warm.add(key)
        finally:
            stop(call)

    def __call__(
        self,
        key_buffer: DeviceBuffer | torch.Tensor,
        val_buffer: DeviceBuffer | torch.Tensor,
        count: int,
        num_steps: int = 0,
        *,
        backend: str | None = None,
    ):
        call = start_call("glu.RadixSort")
        try:
            check_argument(key_buffer is not None, "Invalid key buffer")
            check_argument(val_buffer is not None, "Invalid value buffer")
            kdata = key_buffer.data if isinstance(key_buffer, DeviceBuffer) else key_buffer
            vdata = val_buffer.data if isinstance(val_buffer, DeviceBuffer) else val_buffer
            check_argument(count <= kdata.shape[0], "count exceeds key buffer size")
            check_argument(count <= vdata.shape[0], "count exceeds value buffer size")
            if count <= 1:
                return kdata[:count], vdata[:count]
            out_k, out_v = radix_sort(kdata[:count], vdata[:count], num_steps, backend=backend)
            if isinstance(key_buffer, DeviceBuffer):
                kdata[:count].view(torch.int32).copy_(out_k.view(torch.int32))
                out_k = kdata[:count]
            if isinstance(val_buffer, DeviceBuffer):
                vdata[:count].view(torch.int32).copy_(out_v.view(torch.int32))
                out_v = vdata[:count]
            return out_k, out_v
        finally:
            stop(call)
''',
    'glu_tpu_torch.ops.reduce': r'''"""Parallel reduce (sum / mul / min / max) of axis 0.

Counterpart of glu_tpu/ops/reduce.py (reference glu/Reduce.hpp) for PyTorch
on the GPU. Two backends:
  - "cuda", K5 of ops/_cuda_reduce.py: one launch of a hand-written fold
    kernel, whose last CTA folds the per-CTA partials; an (N, C) vector
    stream is read where it lies (on a CPU tensor, its plain torch version);
  - "torch", the portable path: one torch.sum / prod / amin / amax with the
    accumulator pinned to the input's dtype (the counterpart of "xla").

Types: int32, uint32, float32 and float64, the base types of the 12
DataTypes; (N, C) inputs carry the components of a vector DataType in the
trailing axis. torch has little arithmetic for uint32, so the torch paths
carry u32 as its int32 bit patterns (`_to_work`): sums and products in the
int32 ring, which is the u32 ring mod 2^32, and min/max with the sign bit
flipped, which turns u32 order into int32 order.

Differences from the reference, as in the JAX package: the input is not
destroyed, and the class form `Reduce(dtype, op)(buffer, count)` writes only
the result, to buffer[0] (Reduce.hpp:131-134).
"""

from __future__ import annotations

import enum

import torch

from ..utils.buffers import DeviceBuffer, _words
from ..utils.dtypes import DataType, check_dtype_supported
from ..utils.errors import check_argument
from ..utils.timing import start_call, stop


class ReduceOperator(enum.Enum):
    """Reduction operators (reference glu/Reduce.hpp:42-48)."""

    SUM = 0
    MUL = 1
    MIN = 2
    MAX = 3


KERNEL_DTYPES = (torch.int32, torch.uint32, torch.float32, torch.float64)

_SIGN = -(1 << 31)  # int32 sign bit: flipping it turns u32 order into int32 order
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def check_kernel_dtype(dtype: torch.dtype) -> None:
    check_argument(
        dtype in KERNEL_DTYPES,
        "dtype %s is not supported (want int32, uint32, float32 or float64)", dtype,
    )


def identity_for(op: ReduceOperator, dtype: torch.dtype):
    """Identity of `op` on `dtype`, as a Python number: 0, 1, +-inf or the
    integer extremes. A uint32 identity is given as its int32 bit pattern
    (MIN's 0xFFFFFFFF is -1), the form in which the port fills u32 words."""
    floating = dtype.is_floating_point
    if op == ReduceOperator.SUM:
        return 0.0 if floating else 0
    if op == ReduceOperator.MUL:
        return 1.0 if floating else 1
    if op == ReduceOperator.MIN:
        return float("inf") if floating else (-1 if dtype == torch.uint32 else _INT32_MAX)
    if op == ReduceOperator.MAX:
        return float("-inf") if floating else (0 if dtype == torch.uint32 else _INT32_MIN)
    raise ValueError(f"invalid op {op}")


# ---------------------------------------------------------------------------
# arithmetic in the work domain: the dtype itself, or int32 words for u32
# ---------------------------------------------------------------------------


def _to_work(x: torch.Tensor, op: ReduceOperator) -> torch.Tensor:
    """x in the domain where torch's signed arithmetic and order are the
    op's: u32 as int32 words (sign-flipped for MIN/MAX), others as they are."""
    if x.dtype != torch.uint32:
        return x
    w = x.view(torch.int32)
    return w ^ _SIGN if op in (ReduceOperator.MIN, ReduceOperator.MAX) else w


def _from_work(w: torch.Tensor, op: ReduceOperator, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of _to_work for a result of `dtype`."""
    if dtype != torch.uint32:
        return w
    if op in (ReduceOperator.MIN, ReduceOperator.MAX):
        w = w ^ _SIGN
    return w.contiguous().view(torch.uint32)


def _work_identity(op: ReduceOperator, dtype: torch.dtype):
    """The identity in the work domain: u32's is int32's (0 and 1 are the
    same words; the flipped u32 extremes are the int32 extremes)."""
    return identity_for(op, torch.int32 if dtype == torch.uint32 else dtype)


_COMBINE = {
    ReduceOperator.SUM: torch.add,
    ReduceOperator.MUL: torch.mul,
    ReduceOperator.MIN: torch.minimum,  # propagates NaN, as jnp.minimum
    ReduceOperator.MAX: torch.maximum,
}


def _fold(w: torch.Tensor, op: ReduceOperator, dim: int) -> torch.Tensor:
    """Fold of work-domain `w` along `dim`, accumulating in its own dtype."""
    if op == ReduceOperator.SUM:
        return torch.sum(w, dim, dtype=w.dtype)
    if op == ReduceOperator.MUL:
        return torch.prod(w, dim, dtype=w.dtype)
    return torch.amin(w, dim) if op == ReduceOperator.MIN else torch.amax(w, dim)


def _cumulate(w: torch.Tensor, op: ReduceOperator, dim: int) -> torch.Tensor:
    """Inclusive scan of work-domain `w` along `dim`, in its own dtype."""
    if op == ReduceOperator.SUM:
        return torch.cumsum(w, dim, dtype=w.dtype)
    if op == ReduceOperator.MUL:
        return torch.cumprod(w, dim, dtype=w.dtype)
    if op == ReduceOperator.MIN:
        return torch.cummin(w, dim).values
    return torch.cummax(w, dim).values


def combine_fn(op: ReduceOperator):
    """Binary combiner of an operator (associative and commutative) on
    tensors of the supported dtypes, uint32 included."""
    comb = _COMBINE[op]

    def combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.dtype != torch.uint32:
            return comb(a, b)
        return _from_work(comb(_to_work(a, op), _to_work(b, op)), op, torch.uint32)

    return combine


def _full(shape, value, dtype: torch.dtype, device) -> torch.Tensor:
    """torch.full that takes a u32 value as its int32 bit pattern."""
    if dtype == torch.uint32:
        return torch.full(shape, value, dtype=torch.int32, device=device).view(torch.uint32)
    return torch.full(shape, value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# reduce
# ---------------------------------------------------------------------------


def _reduce_impl(x: torch.Tensor, op: ReduceOperator, backend: str) -> torch.Tensor:
    if backend == "cuda":
        from ._cuda_reduce import COMPONENTS, reduce_partitions

        # one row, (1, N) or (1, N, C), read where it lies; a vector of
        # another width goes as C rows of one (C, N) copy
        rows = x.unsqueeze(0) if x.ndim == 1 or x.shape[1] in COMPONENTS else x.t()
        return reduce_partitions(rows.contiguous(), op).reshape(x.shape[1:])
    return _from_work(_fold(_to_work(x, op), op, 0), op, x.dtype)


def reduce(x: torch.Tensor, op: ReduceOperator = ReduceOperator.SUM, *, backend: str | None = None) -> torch.Tensor:
    """Reduce x along axis 0. x: (N,) scalar stream or (N, C) vector stream.

    Any N >= 1. Returns a 0-d tensor (or (C,) for vectors) of x's dtype on
    x's device; the input is untouched. backend: "cuda" for the K5 kernel,
    "torch" for one torch reduction, None for the override
    GLU_TPU_TORCH_BACKEND or, on a CUDA tensor, the router's choice by the
    card's cost model (ops/router.py::_reduce_backend; on a CPU tensor
    "cuda").
    """
    call = start_call("glu.reduce")
    try:
        from .router import _reduce_backend  # here, so `python -m glu_tpu_torch.ops.router` loads it once

        check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
        check_argument(x.ndim in (1, 2), "reduce expects (N,) or (N, C) input, got shape %s", tuple(x.shape))
        check_argument(x.shape[0] >= 1, "reduce requires count >= 1")
        check_kernel_dtype(x.dtype)
        return _reduce_impl(x, op, _reduce_backend(backend, x))
    finally:
        stop(call)


def segmented_reduce(
    x: torch.Tensor,
    offsets,
    op: ReduceOperator = ReduceOperator.SUM,
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """Per-segment reduction over variable-length adjacent segments
    (counterpart of glu_tpu/ops/reduce.py:137-181): `offsets` holds S+1
    nondecreasing boundaries with offsets[0] == 0 and offsets[-1] == n; an
    empty segment reduces to the operator's identity. Returns (S,) of x's
    dtype.

    Integer SUM: boundary differences of ONE inclusive scan (K4 on the
    "cuda" backend), exact in the wrapping ring. Every other (op, dtype)
    takes the flagged-combine segmented scan (scan.py::_flagged_scan) and
    picks each segment's last inclusive value. backend goes to
    inclusive_scan, which has no router (as in the JAX package): None is
    the override GLU_TPU_TORCH_BACKEND or "cuda".
    """
    call = start_call("glu.segmented_reduce")
    try:
        check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
        check_argument(x.ndim == 1, "segmented_reduce expects a 1-D array, got shape %s", tuple(x.shape))
        check_kernel_dtype(x.dtype)
        from ._segments import validate_offsets

        n = x.shape[0]
        offs, num_segments = validate_offsets(offsets, n, x.device)
        ident = identity_for(op, x.dtype)
        if n == 0:
            return _full((num_segments,), ident, x.dtype, x.device)
        if op != ReduceOperator.SUM or x.dtype.is_floating_point:
            from .scan import _flagged_scan, _segment_start_flags

            incl = _words(_flagged_scan(x, _segment_start_flags(offs, n), op, inclusive=True))
            picked = incl[(offs[1:] - 1).clamp(min=0)]
            empty = torch.full((), ident, dtype=picked.dtype, device=x.device)
            return torch.where(offs[1:] > offs[:-1], picked, empty).view(x.dtype)
        from .scan import inclusive_scan

        incl = _words(inclusive_scan(x, op=op, backend=backend))
        # prefix value BEFORE each boundary: 0 at boundary 0, incl[o-1] else
        pref = torch.where(offs > 0, incl[(offs - 1).clamp(min=0)], torch.zeros((), dtype=incl.dtype, device=x.device))
        return (pref[1:] - pref[:-1]).view(x.dtype)
    finally:
        stop(call)


class Reduce:
    """Constructor-specialized reduce operator (reference glu/Reduce.hpp:51-136).

    `Reduce(DataType.UINT, ReduceOperator.SUM)(buffer, count)` reduces the
    first `count` elements of a DeviceBuffer and, like the reference, leaves
    the result at buffer[0], written in place (Reduce.hpp:131-134); the rest
    of the buffer is not clobbered with partials. Given a tensor, it only
    returns the result. Returns the result.
    """

    def __init__(self, data_type: DataType, operator: ReduceOperator):
        self.info = check_dtype_supported(data_type)
        check_argument(isinstance(operator, ReduceOperator), "Invalid operator: %s", operator)
        self.data_type = data_type
        self.operator = operator

    def __call__(self, buffer: DeviceBuffer | torch.Tensor, count: int, *, backend: str | None = None):
        call = start_call("glu.Reduce")
        try:
            data = buffer.data if isinstance(buffer, DeviceBuffer) else buffer
            check_argument(count >= 1, "Count must be >= 1")
            check_argument(count <= data.shape[0], "count %d exceeds buffer size %d", count, data.shape[0])
            result = reduce(data[:count], self.operator, backend=backend)
            if isinstance(buffer, DeviceBuffer):
                _words(data[0]).copy_(_words(result))
            return result
        finally:
            stop(call)
''',
    'glu_tpu_torch.ops.reference': r'''"""Golden references in plain torch (counterpart of glu_tpu/ops/reference.py):
the simplest correct expression of each op's contract, independent of the
kernels' code. u32 travels as int32 words, where torch's sums wrap mod 2^32
and its order is u32 order after the sign-bit flip."""

from __future__ import annotations

import torch

_SIGN = -(1 << 31)


def ref_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """Reduce along axis 0 with `op` in {sum, mul, min, max} (reference
    glu/Reduce.hpp:42-48): a scalar for (N,), the per-component (C,) for
    (N, C)."""
    u32 = x.dtype == torch.uint32
    w = x.view(torch.int32) if u32 else x
    if op in ("min", "max"):
        w = w ^ _SIGN if u32 else w
        r = torch.amin(w, 0) if op == "min" else torch.amax(w, 0)
        r = r ^ _SIGN if u32 else r
    else:
        r = (torch.sum if op == "sum" else torch.prod)(w, 0, dtype=w.dtype)
    return r.view(torch.uint32) if u32 else r


def ref_exclusive_scan(x: torch.Tensor, num_partitions: int = 1) -> torch.Tensor:
    """Exclusive prefix sum over `num_partitions` adjacent equal partitions
    (reference glu/BlellochScan.hpp:125-138); sums wrap in the dtype."""
    u32 = x.dtype == torch.uint32
    w = x.view(torch.int32) if u32 else x
    seg = w.reshape(num_partitions, -1)
    exc = (torch.cumsum(seg, 1, dtype=w.dtype) - seg).reshape(-1)
    return exc.view(torch.uint32) if u32 else exc


def ref_radix_sort(keys: torch.Tensor, values: torch.Tensor, num_steps: int = 0):
    """Stable sort of u32 (key, value) pairs by the low 4*num_steps key bits.

    num_steps=0 means a full 8-pass sort (reference glu/RadixSort.hpp:289,332).
    A partial sort's observable state equals a stable sort by the masked low
    bits: LSD passes never look at higher bits. The sort key is widened to
    int64, where u32 order is plain integer order.
    """
    steps = 8 if num_steps in (0, None) else min(int(num_steps), 8)
    if steps == 0:
        return keys, values
    k, v = keys.view(torch.int32), values.view(torch.int32)
    wide = k.to(torch.int64) & ((1 << (4 * steps)) - 1)
    order = torch.sort(wide, stable=True).indices
    return k[order].view(torch.uint32), v[order].view(torch.uint32)


def ref_csr(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor, num_vertices: int):
    """The compressed sparse rows of a weighted edge list (u32 src, dst and
    weight words, vertex ids below num_vertices <= 2^31): (row starts, int32
    of num_vertices; the columns, u32; the weights, u32). Each row holds its
    edges ascending by dst, edges of equal
    (src, dst) in input order, and the weights travel with their edges; row
    v spans [starts[v], starts[v + 1]), the last row ending at the edge
    count. The key (src, dst) is widened to int64, where u32 order is plain
    integer order."""
    s, d = src.view(torch.int32).to(torch.int64) & 0xFFFFFFFF, dst.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    order = torch.sort((s << 32) | d, stable=True).indices
    counts = torch.bincount(s, minlength=num_vertices)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    return starts, dst.view(torch.int32)[order].view(torch.uint32), weights.view(torch.int32)[order].view(torch.uint32)
''',
    'glu_tpu_torch.ops.router': r'''"""The router: a per-device cost model that picks the backend of a sort or a
reduce when the caller asked for none (counterpart of the router in
glu_tpu/ops/radix_sort.py:44-211, :497-513, :683-700 and of
glu_tpu/ops/reduce.py::_reduce_backend).

No fixed choice is right on every card and host: the engine's multi-tile
sort pays a fixed time a call (the host's call, the launches' latency and
each pass's chain of tiles) that torch.sort's route may undercut at small
sizes, while the reduce of a few elements is faster through torch's own
call. So a sort or reduce of a CUDA tensor given `backend=None`, with
GLU_TPU_TORCH_BACKEND unset (ops/backend.py::routable), runs whichever
backend the model says is faster; a sort goes to torch only where the model
has it faster by more than TORCH_MARGIN (`_faster`). On the H100 the
engine wins every sort size (since the whole multi-tile sort became one
library call) and torch's call every reduce up to 2^28. The model is a dict
of measured rates, one per card: the calibration file when it exists and
parses (`router_calibration_path()`, written by `python -m
glu_tpu_torch.ops.router --calibrate`), else the shipped table measured on
an H100 (`_H100_MODEL`). It is read once per device and kept.

The model's form is the engine's (ops/_cuda_sort.py): up to SINGLE_TILE_MAX
pairs K3 alone, costing a fixed time (the wrapper's host time) plus n x
passes x a rate, one pair of them for one CTA (up to CTA_MAX) and one for a
cluster of CTAs (the cluster's barriers and its stores into the other CTAs'
shared memory); above it one histogram launch and one onesweep pass per 8
key bits, costing the larger of a fixed time plus a time a pass (the
host's call and the launches' latency) and the card's (n x (the
histogram's rate + passes x the pass's rate)). The
per-key rates are given for 0, 1 and 2 payloads and extended linearly past
2. The torch side is a table of ns per key by log2 n of each form of the
"torch" backend's core sort (key/value, keys only, two payloads, the int64
sort of u64 keys, the (segment, key) sort), interpolated geometrically
between its points and extended past its end by a slope, plus a masking
pass where the sorted bits are not the whole key. Work that both backends
do alike (float and signed key transforms, the u64 word split and join,
segment ids, gathers of payloads past the seventh) is not counted. Two
chained engine sorts (u64 keys, segments) cost their sum less the second's
fixed time, spent on the host while the card runs the first. The model is
read as it was measured: the host's speed moves from one second to the
next on the H100's machines, by more than any probe taken once can tell
(PERF.md), and since the engine's sort is one library call no route on
the H100 turns on it.

The router chooses before the call, from the model; it never retries a
failed kernel on torch. The scans have no router, as in the JAX package:
they take the override or "cuda".
"""

from __future__ import annotations

import bisect
import importlib
import json
import math
import os
import subprocess
import sys
import time

import torch

from ..utils.errors import check_argument
from ..utils.log import vlog
from ..utils.timing import count, start, stop
from . import _cuda_sort as cs
from . import backend as _backend

# The shipped model: the output of one full `python -m glu_tpu_torch.ops.router
# --calibrate` on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, pasted in
# (PERF.md, section 5, names the run). Times in us, rates in ns a key; torch's
# tables are [log2 n, ns a key] points.
_H100_MODEL = {
    "device": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "k3_fixed_us": 48.474,
    "k3_ns_per_key_pass": [0.50313, 0.58125, 1.2703],
    "k3_cluster_fixed_us": 69.493,
    "k3_cluster_ns_per_key_pass": [0.15283, 0.16764, 0.23226],
    "onesweep_fixed_us": 56.331,
    "onesweep_pass_us": 17.077,
    "onesweep_hist_ns_per_key": 0.0045567,
    "onesweep_ns_per_key_pass": [0.0087576, 0.0098899, 0.014531],
    "torch_ns_per_key": {
        "keys": [
            [10.0, 86.562], [12.0, 23.422], [14.0, 6.3594], [15.0, 3.3564], [16.0, 1.7114], [16.000022, 1.665],
            [17.0, 0.83105], [18.0, 0.42383], [20.0, 0.14789], [22.0, 0.091736], [24.0, 0.085606], [26.0, 0.091563],
            [28.0, 0.090247],
        ],
        "kv": [
            [10.0, 90.781], [12.0, 23.469], [14.0, 6.6348], [15.0, 3.4639], [16.0, 1.771], [16.000022, 1.873],
            [17.0, 0.85913], [18.0, 0.4563], [20.0, 0.16495], [22.0, 0.10208], [24.0, 0.111], [26.0, 0.12458],
            [28.0, 0.12617],
        ],
        "multi2": [
            [10.0, 119.41], [12.0, 28.344], [14.0, 7.2129], [15.0, 3.5117], [16.0, 1.8071], [16.000022, 1.8022],
            [17.0, 0.98804], [18.0, 0.52197], [20.0, 0.18335], [22.0, 0.11366], [24.0, 0.13539], [26.0, 0.15837],
            [28.0, 0.16177],
        ],
        "u64": [
            [10.0, 170.78], [12.0, 47.398], [14.0, 13.541], [15.0, 6.7842], [16.0, 3.4224], [16.000022, 3.6479],
            [17.0, 1.812], [18.0, 0.91553], [20.0, 0.35721], [22.0, 0.22616], [24.0, 0.24047], [26.0, 0.26618],
        ],
        "segmented": [
            [10.0, 170.44], [12.0, 47.695], [14.0, 13.398], [15.0, 6.8437], [16.0, 3.585], [16.000022, 3.5278],
            [17.0, 2.0225], [18.0, 0.93823], [20.0, 0.32623], [22.0, 0.2218], [24.0, 0.18338], [26.0, 0.17985],
        ],
    },
    "torch_slope": {"keys": 0.0, "kv": 0.000795, "multi2": 0.0017, "u64": 0.012855, "segmented": 0.0},
    "compact_us": 0.608,
    "compact_ns_per_key": 0.0,
    "reduce_torch_max_n": 268435456,
}

_ENV_CALIBRATION = "GLU_TPU_TORCH_ROUTER_CALIBRATION"
TORCH_MARGIN = 0.20  # a sort goes to torch only where the model has it faster by more than this
TORCH_FORMS = ("keys", "kv", "multi2", "u64", "segmented")


def router_calibration_path() -> str:
    """GLU_TPU_TORCH_ROUTER_CALIBRATION, or $XDG_CACHE_HOME (default
    ~/.cache)/glu_tpu_torch/router.json."""
    p = os.environ.get(_ENV_CALIBRATION)
    if p:
        return p
    return os.path.join(
        os.path.expanduser(os.environ.get("XDG_CACHE_HOME", "~/.cache")), "glu_tpu_torch", "router.json"
    )


class _CostModel:
    """A model dict in the form the estimates read: per-payload tuples and,
    for each torch form, (log2 n points, log ns/key points, slope)."""

    def __init__(self, model: dict):
        self.model = model
        self.k3_fixed_us = float(model["k3_fixed_us"])
        self.k3_ns = tuple(model["k3_ns_per_key_pass"])
        self.k3_cluster_fixed_us = float(model["k3_cluster_fixed_us"])
        self.k3_cluster_ns = tuple(model["k3_cluster_ns_per_key_pass"])
        self.os_fixed_us = float(model["onesweep_fixed_us"])
        self.os_pass_us = float(model["onesweep_pass_us"])
        self.hist_ns = float(model["onesweep_hist_ns_per_key"])
        self.os_ns = tuple(model["onesweep_ns_per_key_pass"])
        self.torch = {}
        for form in TORCH_FORMS:
            pts = sorted(model["torch_ns_per_key"][form])
            self.torch[form] = (
                [float(lg) for lg, _ in pts],
                [math.log(ns) for _, ns in pts],
                float(model["torch_slope"][form]),
            )
        self.compact_us = float(model["compact_us"])
        self.compact_ns = float(model["compact_ns_per_key"])
        self.reduce_torch_max_n = int(model["reduce_torch_max_n"])


_models: dict = {}  # device index (None for the CPU) -> _CostModel


def _cost_model(device: torch.device) -> _CostModel:
    m = _models.get(device.index)
    if m is None:
        m = _models[device.index] = _CostModel(_load_model(device))
    return m


def _router_model(device=None) -> dict:
    """The active cost model of `device` (default: the current CUDA device):
    the calibration file if it exists and parses, else the shipped H100
    table, read once per device. vlog names the source, and warns when the
    model was measured on another card than this one."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _cost_model(device).model


def _load_model(device: torch.device) -> dict:
    path = router_calibration_path()
    model = dict(_H100_MODEL)
    if os.path.exists(path):
        try:
            with open(path) as f:
                model.update(json.load(f))
            vlog("router: loaded calibration %s (device: %s)", path, model.get("device"))
        except (OSError, ValueError) as e:
            vlog("router: unreadable calibration %s (%s); using the shipped H100 table", path, e)
    else:
        vlog("router: no calibration at %s; using the shipped H100 table "
             "(run `python -m glu_tpu_torch.ops.router --calibrate` on another card)", path)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        if model.get("device") != name:
            vlog("router: WARNING: the model was measured on %s, this card is %s; "
                 "run `python -m glu_tpu_torch.ops.router --calibrate`", model.get("device"), name)
    return model


def _reset_router_model() -> None:
    """Drop the cached models (tests point GLU_TPU_TORCH_ROUTER_CALIBRATION
    at fixture files and must read them again)."""
    _models.clear()


# ---------------------------------------------------------------------------
# the estimates
# ---------------------------------------------------------------------------


def _per_payloads(values: tuple, payloads: int) -> float:
    """A rate given for 0, 1 and 2 payloads, extended past 2 by the step
    from 1 to 2."""
    if payloads <= 2:
        return values[payloads]
    return values[2] + (payloads - 2) * (values[2] - values[1])


def _table_s(table, n: int) -> float:
    """Seconds of n keys by a (log2 n, log ns/key, slope) table: geometric
    between its points, constant time below its first, ns/key growing by
    `slope` a doubling past its last."""
    lgs, log_ns, slope = table
    lg = math.log2(n) if n > 1 else 0.0
    if lg <= lgs[0]:
        return math.exp(log_ns[0]) * 2.0 ** lgs[0] * 1e-9
    if lg >= lgs[-1]:
        return n * (math.exp(log_ns[-1]) + slope * (lg - lgs[-1])) * 1e-9
    i = bisect.bisect_left(lgs, lg)
    x0, x1 = lgs[i - 1], lgs[i]
    return n * math.exp(log_ns[i - 1] + (log_ns[i] - log_ns[i - 1]) * (lg - x0) / (x1 - x0)) * 1e-9


def _compact_s(m: _CostModel, n: int) -> float:
    """The "torch" backend's masking of the key to the sorted bits."""
    return (m.compact_us + n * m.compact_ns * 1e-3) * 1e-6


def _torch_sort_est_s(m: _CostModel, n: int, num_streams: int, full_cover: bool = True) -> float:
    """Estimated seconds of the "torch" backend's sort of n keys with
    num_streams payloads (radix_sort.py::_sort_torch): one stable
    torch.sort and a gather a payload."""
    if num_streams == 0:
        t = _table_s(m.torch["keys"], n)
    else:
        t = _table_s(m.torch["kv"], n)
        if num_streams > 1:
            t += (num_streams - 1) * (_table_s(m.torch["multi2"], n) - t)
    return t if full_cover else t + _compact_s(m, n)


def _cuda_sort_est_s(m: _CostModel, n: int, num_streams: int, npasses: int) -> float:
    """Estimated seconds of the engine's sort of n keys with num_streams
    payloads in npasses passes of up to 8 bits: K3 alone up to
    SINGLE_TILE_MAX (its host time, then its one launch, on one CTA or a
    cluster), else one histogram and npasses onesweep passes (the host's
    time or the card's, whichever is longer)."""
    if npasses == 0 or n <= 1:
        return 0.0
    if n <= cs.SINGLE_TILE_MAX:
        fixed_us, rates = _k3_terms(m, n)
        return (fixed_us + n * npasses * _per_payloads(rates, num_streams) * 1e-3) * 1e-6
    # the host launches each pass while the card runs the one before, so the
    # call takes the longer of the two (a sum overestimated 2^22 pairs by a
    # third on the H100, past torch's time, where the engine was faster)
    host_s = (m.os_fixed_us + npasses * m.os_pass_us) * 1e-6
    return max(host_s, n * (m.hist_ns + npasses * _per_payloads(m.os_ns, num_streams)) * 1e-9)


def _chain_est_s(m: _CostModel, n: int, first: tuple, second: tuple) -> float:
    """Estimated seconds of two engine sorts of n keys run one after the
    other, each given as (payloads, passes): their sum less the second's
    fixed time, which the host spends while the card runs the first's
    passes."""
    a, b = _cuda_sort_est_s(m, n, *first), _cuda_sort_est_s(m, n, *second)
    if a == 0.0 or b == 0.0:
        return a + b
    fixed = _k3_terms(m, n)[0] if n <= cs.SINGLE_TILE_MAX else m.os_fixed_us
    return a + b - min(fixed * 1e-6, b)


def _k3_terms(m: _CostModel, n: int) -> tuple:
    """K3's (fixed us, ns a key a pass by payloads) at n: one CTA's up to
    CTA_MAX, the cluster's above."""
    if n <= cs.CTA_MAX:
        return m.k3_fixed_us, m.k3_ns
    return m.k3_cluster_fixed_us, m.k3_cluster_ns


def _npasses_of(positions: tuple) -> int:
    """The engine's passes over these key bits: one per 8 of them."""
    return -(-len(positions) // cs.MAX_FIELD_BITS)


# ---------------------------------------------------------------------------
# the routers
# ---------------------------------------------------------------------------


def _faster(torch_s: float, cuda_s: float) -> str:
    """The route of a sort by its two estimates: "torch" only where the
    model has it faster than the engine by more than TORCH_MARGIN. Within
    that the estimates cannot tell the backends apart, and a tie goes to
    the engine: where both are bound by their fixed times, the host's speed,
    which moves by up to 2x from one second to the next on the H100's
    machines, moves torch.sort's route (several launches and allocations)
    more than the engine's one library call, so that a calibration taken at
    a fast moment can read torch.sort's route the faster where later calls
    find it the slower (PERF.md §6, PR 10: the largest margin a model needed
    in five runs of the guard was 0.127).
    """
    return "torch" if torch_s * (1 + TORCH_MARGIN) < cuda_s else "cuda"


def _routed(op: str, backend: str) -> str:
    """Counts the route of one decision (route.<op>.<backend>) and returns it."""
    count(f"route.{op}.{backend}")
    return backend


def _sort_backend(backend, tensor: torch.Tensor, n: int, num_streams: int, npasses: int,
                  full_cover: bool | None = None) -> str:
    """The backend of a sort of n keys of `tensor` with num_streams
    payloads in npasses 8-bit passes; full_cover: whether the sorted bits
    are the whole key (default: 4 passes), else the "torch" backend masks
    the key first. Routed only where ops/backend.py::routable says so."""
    opened = start("glu.route")
    try:
        if not _backend.routable(backend, tensor):
            return _routed("sort", _backend.resolve_backend(backend, tensor))
        m = _cost_model(tensor.device)
        if num_streams >= cs.MAX_STREAMS:  # both backends sort an index and gather the payloads by it
            num_streams = 1
        if full_cover is None:
            full_cover = npasses >= cs.MAX_PASSES
        torch_s = _torch_sort_est_s(m, n, num_streams, full_cover)
        return _routed("sort", _faster(torch_s, _cuda_sort_est_s(m, n, num_streams, npasses)))
    finally:
        stop(opened)


def _u64_backend(backend, tensor: torch.Tensor, n: int, p_hi: int, p_lo: int, extra_ops: int) -> str:
    """The backend of a sort of n u64 keys (radix_sort.py::_sort_two_words):
    the engine chains a sort of the low word and one of the high word, each
    carrying 2 payloads, in p_lo and p_hi passes (0: no bit of that word is
    sorted); "torch" sorts once on the int64 key, masking `extra_ops` words."""
    opened = start("glu.route")
    try:
        if not _backend.routable(backend, tensor):
            return _routed("u64", _backend.resolve_backend(backend, tensor))
        m = _cost_model(tensor.device)
        torch_s = _table_s(m.torch["u64"], n) + extra_ops * _compact_s(m, n)
        return _routed("u64", _faster(torch_s, _chain_est_s(m, n, (2, p_lo), (2, p_hi))))
    finally:
        stop(opened)


def _segmented_backend(backend, tensor: torch.Tensor, n: int, key_passes: int, seg_passes: int,
                       full_cover: bool = True) -> str:
    """The backend of a segmented sort of n keys: the engine chains the key
    sort (key_passes) and the segment-id sort (seg_passes), each carrying 2
    payloads; "torch" sorts once on the int64 of (segment id, key), masking
    the key unless full_cover."""
    opened = start("glu.route")
    try:
        if not _backend.routable(backend, tensor):
            return _routed("segmented", _backend.resolve_backend(backend, tensor))
        m = _cost_model(tensor.device)
        torch_s = _table_s(m.torch["segmented"], n) + (0.0 if full_cover else _compact_s(m, n))
        return _routed("segmented", _faster(torch_s, _chain_est_s(m, n, (2, key_passes), (2, seg_passes))))
    finally:
        stop(opened)


def _reduce_backend(backend, x: torch.Tensor) -> str:
    """The backend of a reduce of x: "torch" up to the model's
    reduce_torch_max_n elements (the calibration's sizes up to which
    torch's call beat K5 at every one in every reading; 0 where it did not
    at the smallest, which makes this the constant "cuda"), "cuda" above. segmented_reduce is not routed: its integer SUM is a scan."""
    opened = start("glu.route")
    try:
        if not _backend.routable(backend, x):
            return _routed("reduce", _backend.resolve_backend(backend, x))
        return _routed("reduce", "torch" if x.numel() <= _cost_model(x.device).reduce_torch_max_n else "cuda")
    finally:
        stop(opened)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

# sizes of the calibration ladder: doublings, and around the K3 limit
# (65,536); the engine's sorts are timed where K3 leaves one CTA (CTA_MAX) too
LADDER = (1 << 10, 1 << 12, 1 << 14, 1 << 15, 1 << 16, 65537, 1 << 17, 1 << 18,
          1 << 20, 1 << 22, 1 << 24, 1 << 26, 1 << 28)
QUICK_MAX = 1 << 26  # --quick stops here
TWO_WORD_MAX = 1 << 26  # the u64 and segmented forms stop here
HOST_BOUND_MAX = 1 << 20  # the engine's 1-pass sorts are timed up to here, and all sizes to here at once
REDUCE_READINGS = 5  # the reduce's two backends are timed this many times a size
SEGMENTS = 4096
SEED = 20260
# the guard: a routed call is within this of the faster backend's time
GUARD_REL = 0.10
GUARD_ABS_MS = 0.010


def within_guard(routed_ms: float, cuda_ms: float, torch_ms: float) -> bool:
    """True when the routed time is within 10% plus 0.010 ms of the faster
    backend's."""
    return routed_ms <= (1 + GUARD_REL) * min(cuda_ms, torch_ms) + GUARD_ABS_MS


def l2_flush(device: torch.device):
    """A function that evicts the card's 50 MB L2 cache (a write of 128 MB)
    and waits for it: called before each timed call, so that every call
    finds its inputs in device memory, whichever call ran before it."""
    scratch = torch.empty(1 << 25, dtype=torch.int32, device=device)

    def flush() -> None:
        scratch.zero_()
        torch.cuda.synchronize(device)

    return flush


def _event_timer(device: torch.device):
    """The calibration's timer on the card: for a dict of calls, the
    seconds of one call of each, timed one call at a time in rounds that
    visit every call in a new order (seeded), so that the host's drift and
    the cost of following the other backend fall on every call alike: each
    after an L2 flush, between CUDA events, followed by a sync; the median
    (a warm-up first)."""
    import random

    flush = l2_flush(device)
    shuffle = random.Random(SEED).shuffle

    def timer(calls: dict) -> dict:
        points = list(calls)
        rounds = 21 if max(p[2] for p in points) <= 1 << 20 else 5
        for fn in calls.values():
            fn()
        times = {p: [] for p in points}
        for _ in range(rounds):
            shuffle(points)
            for p in points:
                flush()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                calls[p]()
                end.record()
                end.synchronize()
                times[p].append(start.elapsed_time(end))
        return {p: sorted(t)[rounds // 2] * 1e-3 for p, t in times.items()}

    return timer


def _power_limit_w(device: torch.device):
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sig(x: float) -> float:
    """x to 5 significant digits (a onesweep pass is about 0.0085 ns/key)."""
    return float(f"{x:.5g}")


def calibrate(device=None, ladder=None, timer=None, *, quick: bool = False, out: str | None = None,
              echo=print) -> dict:
    """Measure the router's model on `device` (default: the card) and write
    it to `out` (default: router_calibration_path()); returns the model.

    Both backends of each form are timed over `ladder` (default LADDER;
    quick: up to 2^26; u64 and segmented up to 2^26), the engine also at
    CTA_MAX / 2, CTA_MAX and SINGLE_TILE_MAX (so that K3 on one CTA has two
    sizes whatever the ladder), and at 1 pass with 0, 1 and 2 payloads at
    the sizes above SINGLE_TILE_MAX up to 2^20 and at the largest up to
    2^26, which fix its fixed times and rates, and the reduce
    REDUCE_READINGS times. `timer(calls)` takes a dict of functions by point, (backend,
    form, n, passes), and returns the seconds of one call of each; the calls
    of every size up to HOST_BOUND_MAX are timed together, those of each
    larger size together. The default times on the card as
    chip_smoke.py's guard does (in rounds, each call after an L2 flush,
    between CUDA events; the median). `echo` gets one line per
    measurement."""
    from ..utils.buffers import default_device
    from .reduce import ReduceOperator, _reduce_impl

    rs = importlib.import_module(__package__ + ".radix_sort")  # the module; the package re-exports a function of its name

    device = default_device(device)
    if timer is None:
        check_argument(device.type == "cuda", "calibration times the card: pass timer= to calibrate on %s", device)
        timer = _event_timer(device)
    sizes = sorted(set(LADDER if ladder is None else ladder))
    if quick:
        sizes = [n for n in sizes if n <= QUICK_MAX]
    k3_n, cta_n = cs.SINGLE_TILE_MAX, min(cs.CTA_MAX, cs.SINGLE_TILE_MAX)
    above = [n for n in sizes if k3_n < n <= TWO_WORD_MAX]
    check_argument(len(above) >= 2, "the ladder needs two sizes from SINGLE_TILE_MAX (%d) to 2^26", k3_n)
    n_big = above[-1]
    top = max(sizes[-1], k3_n)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    words = torch.randint(-(2**31), 2**31, (top,), dtype=torch.int32, device=device, generator=gen)
    words2 = torch.randint(-(2**31), 2**31, (top,), dtype=torch.int32, device=device, generator=gen)
    iota = torch.arange(top, dtype=torch.int32, device=device)
    full, one_pass = rs.FULL, tuple(range(cs.MAX_FIELD_BITS))
    streams_of = {"keys": 0, "kv": 1, "multi2": 2}
    measured: dict = {}

    def measure(calls: dict) -> dict:
        got = timer(calls)
        for point, s in got.items():
            measured[point] = s
            echo(f"calibrate {point[0]} {point[1]} n={point[2]}"
                 f"{'' if point[3] is None else f' passes={point[3]}'}: {s * 1e3:.4f} ms")
        return got

    def sort_fn(b, form, n, positions):
        k, pays = words[:n], [iota[:n], words2[:n]][: streams_of[form]]
        if b == "torch":
            return lambda: rs._sort_torch(k, pays, positions)
        return lambda: rs._radix_sort_streams(k, pays, positions, "cuda")

    def two_word_fn(b, form, n):
        if form == "u64":
            major, minor, major_pos = words[:n], words2[:n], full
        else:
            major = (iota[:n].to(torch.int64) * SEGMENTS // n).to(torch.int32)
            minor, major_pos = words[:n], rs._seg_bits(SEGMENTS)
        return lambda: rs._sort_two_words(major, minor, major_pos, full, [iota[:n]], b)

    # the calls of each size, with the engine's 1-pass sorts beside its full
    # ones where the fit compares them: at the sizes where the multi-tile
    # path is bound by its fixed time, and at n_big. Every
    # size up to HOST_BOUND_MAX is timed in one group, so that each point's
    # median is taken over the same moments of the host, whose speed moves
    # by up to 2x from one second to the next on the H100's machines:
    # torch's route is host-bound there, and timed a size at a time, one
    # size that met a fast moment would be set against the engine's fixed
    # time, a median pooled over all the sizes. The larger sizes, a call of
    # which is up to 1,000x longer, a size at a time.
    one_pass_sizes = {n_big} | {n for n in sizes if k3_n < n <= HOST_BOUND_MAX}
    host_bound = {}
    for n in sorted(set(sizes) | {cta_n // 2, cta_n, k3_n}):
        calls = {}
        for form in ("keys", "kv", "multi2"):
            if n in sizes:
                calls[("torch", form, n, None)] = sort_fn("torch", form, n, full)
            calls[("cuda", form, n, cs.MAX_PASSES)] = sort_fn("cuda", form, n, full)
            if n in one_pass_sizes:
                calls[("cuda", form, n, 1)] = sort_fn("cuda", form, n, one_pass)
        if n in one_pass_sizes and n > k3_n:  # the masking of the key, by difference
            calls[("torch", "kv", n, 1)] = sort_fn("torch", "kv", n, one_pass)
        if n <= TWO_WORD_MAX and n in sizes:
            for form in ("u64", "segmented"):
                for b in ("torch", "cuda"):
                    calls[(b, form, n, None)] = two_word_fn(b, form, n)
        if n <= HOST_BOUND_MAX:
            host_bound.update(calls)
        else:
            measure(calls)
    measure(host_bound)

    model = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
             "power_limit_w": _power_limit_w(device) if device.type == "cuda" else None}
    model.update(_fit_model(measured, sizes, k3_n, cta_n))
    # reduce: K5 and torch's, timed together REDUCE_READINGS times a size,
    # each reading of the two in the same rounds (the host's drift, which
    # moves these times by 2x from one reading to the next on the H100,
    # falls on both). torch wins at a size where it is the faster in every
    # reading; it takes the sizes up to the first at which it does not win
    model["reduce_torch_max_n"], prefix = 0, True
    for n in sizes:
        x = words[:n].view(torch.uint32)
        calls = {(b, "reduce", n, None): (lambda b=b: _reduce_impl(x, ReduceOperator.SUM, b)) for b in ("cuda", "torch")}
        readings = [timer(calls) for _ in range(REDUCE_READINGS)]
        pairs = [(r[("cuda", "reduce", n, None)], r[("torch", "reduce", n, None)]) for r in readings]
        wins = all(t < c for c, t in pairs)
        echo(f"calibrate reduce n={n}: cuda/torch {' '.join(f'{c * 1e3:.4f}/{t * 1e3:.4f}' for c, t in pairs)} ms: "
             f"{'torch wins' if wins else 'torch does not win'}")
        prefix = prefix and wins
        if prefix:
            model["reduce_torch_max_n"] = n

    _echo_model_check(model, measured, sizes, echo)
    path = out or router_calibration_path()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(model, f, indent=1)
    _reset_router_model()
    echo(f"calibrate: wrote {path}")
    return model


def _fit_model(measured: dict, sizes: list, k3_n: int, cta_n: int) -> dict:
    """The model's rates from calibrate's measurements, a dict of seconds by
    (backend, form, n, passes)."""
    n_big = max(n for n in sizes if k3_n < n <= TWO_WORD_MAX)
    # the engine. K3 on one CTA (up to CTA_MAX) and on a cluster (above):
    # each one's per-key rate a pass by payloads from its full sorts at its
    # smallest and largest sizes, and its fixed time, the median over its
    # points of what the rate leaves (a cluster without two sizes of its
    # own, as where the two limits meet, takes one CTA's terms). Not from 1 and 4
    # passes at one size: each pass also has a fixed part (its scans and, in
    # a cluster, its barriers), which that rate counted as keys and so
    # overestimated the largest sorts (on the H100 by a tenth at 65,536
    # pairs). The multi-tile path: the card's rates by payloads from 1 and 4
    # passes at n_big; the fixed times from the medians of the 1-pass and of
    # the 4-pass sorts where the card's estimate is under half the time:
    # fixed + 1 pass and fixed + 4 passes (the host's call, the launches'
    # latency and the chain of each pass's tiles, which hardly depend on the
    # payloads: pooled over the forms).
    def quantile(values, q):
        values = sorted(values)
        return values[int(q * (len(values) - 1) + 0.5)]

    def median(values):
        return quantile(values, 0.5)

    extra = cs.MAX_PASSES - 1
    forms = ("keys", "kv", "multi2")

    def rate(form, n):  # ns a key a pass of the engine's sort of n keys, from 1 and 4 passes
        t1, t4 = measured[("cuda", form, n, 1)], measured[("cuda", form, n, cs.MAX_PASSES)]
        return max((t4 - t1) / (extra * n), 0.0)

    def k3_terms(lo_n, hi_n):
        """K3's (fixed s, s a key a pass by payloads) from its points in
        (lo_n, hi_n], or None where they are of one size."""
        points = {(form, n, p): t for (b, form, n, p), t in measured.items()
                  if b == "cuda" and form in forms and lo_n < n <= hi_n}
        lo, hi = min(n for _, n, _ in points), max(n for _, n, _ in points)
        if lo == hi:
            return None
        full = {(form, n): t for (form, n, p), t in points.items() if p == cs.MAX_PASSES}
        rates = [max((full[(form, hi)] - full[(form, lo)]) / (cs.MAX_PASSES * (hi - lo)), 0.0) for form in forms]
        return median([t - n * p * rates[forms.index(form)] for (form, n, p), t in points.items()]), rates

    os_ns, hist = [], []
    for form in forms:
        os_ns.append(rate(form, n_big))
        hist.append(measured[("cuda", form, n_big, 1)] / n_big - os_ns[-1])
    hist = max(median(hist), 0.0)
    host = {1: [], cs.MAX_PASSES: []}
    for (b, form, n, p), t in measured.items():
        if b == "cuda" and form in forms and n > k3_n and n * (hist + p * os_ns[forms.index(form)]) < t / 2:
            host[p].append(t)
    one, full = median(host[1]), median(host[cs.MAX_PASSES])
    per_pass = max((full - one) / extra, 0.0)
    k3_fixed, k3_ns = k3_terms(0, cta_n)
    k3c_fixed, k3c_ns = (k3_terms(cta_n, k3_n) if cta_n < k3_n else None) or (k3_fixed, k3_ns)
    model = {
        "k3_fixed_us": _sig(max(k3_fixed, 0.0) * 1e6),
        "k3_ns_per_key_pass": [_sig(r * 1e9) for r in k3_ns],
        "k3_cluster_fixed_us": _sig(max(k3c_fixed, 0.0) * 1e6),
        "k3_cluster_ns_per_key_pass": [_sig(r * 1e9) for r in k3c_ns],
        "onesweep_fixed_us": _sig(max(one - per_pass, 0.0) * 1e6),
        "onesweep_pass_us": _sig(per_pass * 1e6),
        "onesweep_hist_ns_per_key": _sig(hist * 1e9),
        "onesweep_ns_per_key_pass": [_sig(r * 1e9) for r in os_ns],
    }
    # torch: ns/key by log2 n of each form, a slope past the last point
    tables, slopes = {}, {}
    for form in TORCH_FORMS:
        pts = [[round(math.log2(n), 6), _sig(measured[("torch", form, n, None)] / n * 1e9)]
               for n in sizes if ("torch", form, n, None) in measured]
        tables[form] = pts
        slopes[form] = _sig(max((pts[-1][1] - pts[-2][1]) / (pts[-1][0] - pts[-2][0]), 0.0)) if len(pts) > 1 else 0.0
    model["torch_ns_per_key"], model["torch_slope"] = tables, slopes
    # the masking: the torch key/value sort of 8 bits less the full one, timed
    # together; its rate from the smallest and largest of those sizes, its
    # fixed time the median of what the rate leaves
    masked = {n: t - measured[("torch", "kv", n, None)] for (b, f, n, p), t in measured.items()
              if (b, f, p) == ("torch", "kv", 1)}
    lo = min(masked)
    rate = max((masked[n_big] - masked[lo]) / (n_big - lo), 0.0)
    fixed = median([d - n * rate for n, d in masked.items()])
    model["compact_us"], model["compact_ns_per_key"] = _sig(max(fixed, 0.0) * 1e6), _sig(rate * 1e9)
    return model


def _echo_model_check(model: dict, measured: dict, sizes: list, echo) -> None:
    """One line per form and ladder size: the model's estimate of each
    backend beside its measured time, its route and the faster backend."""
    rs = importlib.import_module(__package__ + ".radix_sort")
    check = _CostModel({**_H100_MODEL, **model})
    streams_of = {"keys": 0, "kv": 1, "multi2": 2}
    seg_passes = _npasses_of(rs._seg_bits(SEGMENTS))
    estimates = {
        "keys": lambda n: (_cuda_sort_est_s(check, n, 0, cs.MAX_PASSES), _torch_sort_est_s(check, n, 0)),
        "kv": lambda n: (_cuda_sort_est_s(check, n, 1, cs.MAX_PASSES), _torch_sort_est_s(check, n, 1)),
        "multi2": lambda n: (_cuda_sort_est_s(check, n, 2, cs.MAX_PASSES), _torch_sort_est_s(check, n, 2)),
        "u64": lambda n: (_chain_est_s(check, n, (2, cs.MAX_PASSES), (2, cs.MAX_PASSES)), _table_s(check.torch["u64"], n)),
        "segmented": lambda n: (_chain_est_s(check, n, (2, cs.MAX_PASSES), (2, seg_passes)),
                                _table_s(check.torch["segmented"], n)),
    }
    for n in sizes:
        for form in TORCH_FORMS:
            if ("torch", form, n, None) not in measured:
                continue
            est = estimates[form](n)
            got = (measured[("cuda", form, n, cs.MAX_PASSES if form in streams_of else None)],
                   measured[("torch", form, n, None)])
            echo(f"calibrate model {form} n={n}: cuda {est[0] * 1e3:.4f} ms (measured {got[0] * 1e3:.4f}), "
                 f"torch {est[1] * 1e3:.4f} ms (measured {got[1] * 1e3:.4f}), route "
                 f"{'torch' if est[1] < est[0] else 'cuda'}, faster {'torch' if got[1] < got[0] else 'cuda'}")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m glu_tpu_torch.ops.router",
        description="Measure the router's cost model on this card and write the calibration file.",
    )
    ap.add_argument("--calibrate", action="store_true", help="measure and write the model")
    ap.add_argument("--quick", action="store_true", help="a ladder up to 2^26 instead of 2^28")
    ap.add_argument("--out", help=f"where to write it (default: {router_calibration_path()})")
    args = ap.parse_args(argv)
    if not args.calibrate:
        ap.print_help()
        return 2
    print(json.dumps(calibrate(quick=args.quick, out=args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
''',
    'glu_tpu_torch.ops.scan': r'''"""Blelloch exclusive prefix scan (sum / mul / min / max), with batched
adjacent partitions.

Counterpart of glu_tpu/ops/scan.py (reference glu/BlellochScan.hpp) for
PyTorch on the GPU. Two backends:
  - "cuda", K4 of ops/_cuda_scan.py: one single-pass launch over tiles with
    decoupled look-back, seeded per partition with the operator's identity
    (on a CPU tensor, its plain torch version);
  - "torch", the portable path: torch.cumsum / cumprod / cummin / cummax
    with the accumulator pinned to the input's dtype, shifted one slot (the
    counterpart of "xla", scan.py:55-76).

Both write the exact exclusive scan. For float SUM that departs from the
JAX package, whose `inclusive - x` puts NaN at the slot of an inf input and
a NaN one slot before its exclusive place; an integer SUM keeps
`inclusive - x`, which is exact in the wrapping ring.

The reference's `num_partitions` batch mode (BlellochScan.hpp:125-138) is
a segmented scan over adjacent equal-length partitions; (N, C) vector inputs
scan per component, as C x num_partitions partitions of one (C, N) copy.
Types and the u32 carrier are those of ops/reduce.py. Parity notes of the
JAX package hold: the default operator is `+`; the class form requires a
power-of-2 partition length (BlellochScan.hpp:134), the functional form
does not; u32 sums wrap mod 2^32.
"""

from __future__ import annotations

import torch

from ..utils.buffers import DeviceBuffer, _words
from ..utils.dtypes import DataType, check_dtype_supported
from ..utils.errors import check_argument
from ..utils.math import is_power_of_2
from ..utils.timing import count, start_call, stop
from .backend import resolve_backend
from .reduce import (
    ReduceOperator,
    _COMBINE,
    _cumulate,
    _from_work,
    _to_work,
    _work_identity,
    check_kernel_dtype,
    combine_fn,
)


def _scan_impl(x: torch.Tensor, num_partitions: int, op: ReduceOperator, backend: str) -> torch.Tensor:
    if x.ndim == 2:
        # vector dtypes: one (C, N) copy scanned as C * num_partitions
        # partitions, in place of the JAX package's vmap (scan.py:45-51)
        n, c = x.shape
        cols = x.t().contiguous().reshape(c * n)
        return _scan_flat(cols, c * num_partitions, op, backend).reshape(c, n).t().contiguous()
    return _scan_flat(x, num_partitions, op, backend)


def _scan_flat(x: torch.Tensor, num_partitions: int, op: ReduceOperator, backend: str) -> torch.Tensor:
    n = x.shape[0]
    if n == 0:
        return torch.empty_like(x)
    if backend == "cuda":
        from ._cuda_scan import exclusive_scan_partitions

        seg = x.reshape(num_partitions, n // num_partitions).contiguous()
        return exclusive_scan_partitions(seg, op).reshape(n)
    seg = _to_work(x, op).reshape(num_partitions, n // num_partitions)
    inc = _cumulate(seg, op, 1)
    if op == ReduceOperator.SUM and not x.dtype.is_floating_point:
        exc = inc - seg  # exact in the wrapping integer ring
    else:
        # the inclusive scan shifted right one slot, the identity seeding
        # each partition's slot 0: the exact exclusive scan, as K4 writes it
        first = torch.full((num_partitions, 1), _work_identity(op, x.dtype), dtype=seg.dtype, device=x.device)
        exc = torch.cat([first, inc[:, :-1]], dim=1)
    return _from_work(exc.reshape(n), op, x.dtype)


def _check_scan_args(x: torch.Tensor, num_partitions: int, op) -> None:
    check_argument(
        x.ndim in (1, 2),
        "scan expects (N,) or (N, C) input (vector dtypes scan per component), got shape %s",
        tuple(x.shape),
    )
    check_argument(num_partitions >= 1, "num_partitions must be >= 1")
    check_argument(
        x.shape[0] % num_partitions == 0,
        "size %d not divisible by num_partitions %d", x.shape[0], num_partitions,
    )
    check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
    check_kernel_dtype(x.dtype)


def _segment_start_flags(offs: torch.Tensor, n: int) -> torch.Tensor:
    """Bool start-of-segment flags from validated offsets: one mark per
    interior boundary below n (empty segments collapse to the same start).
    Element 0 always starts a segment."""
    inner = offs[1:-1]
    flags = torch.zeros(n, dtype=torch.bool, device=offs.device)
    count("host_syncs.offsets_mask")  # a boolean mask's selection fetches its count
    flags[inner[inner < n]] = True
    flags[0] = True
    if flags.is_cuda:
        count("host_syncs.scalar_write", 2)  # each write of a Python scalar copies it onto the card
    return flags


def _flagged_scan(x: torch.Tensor, flags: torch.Tensor, op: ReduceOperator, inclusive: bool) -> torch.Tensor:
    """Ragged scan under any operator via the segmented-scan lift (Blelloch
    1990): `op` on (start_flag, value) pairs,
    (af, av) . (bf, bv) = (af | bf, bv if bf else op(av, bv)), is
    associative, so a log-step Hillis-Steele scan over the pairs gives
    every segment's inclusive scan (O(n log n), as the JAX package's
    associative_scan). The exclusive form shifts one slot right and seeds
    segment starts with the identity."""
    comb = _COMBINE[op]
    n = x.shape[0]
    f, v = flags, _to_work(x, op)
    s = 1
    while s < n:
        v = torch.cat([v[:s], torch.where(f[s:], v[s:], comb(v[:-s], v[s:]))])
        f = torch.cat([f[:s], f[s:] | f[:-s]])
        s *= 2
    if not inclusive:
        ident = _work_identity(op, x.dtype)
        shifted = torch.cat([torch.full((1,), ident, dtype=v.dtype, device=v.device), v[:-1]])
        v = torch.where(flags, torch.full_like(shifted, ident), shifted)
    return _from_work(v, op, x.dtype)


def _segmented_scan_offsets(x, offsets, op, backend, inclusive: bool) -> torch.Tensor:
    """Ragged segmented scan (offsets form; counterpart of scan.py:128-159).
    Integer SUM: one global exclusive scan, minus each element's
    segment-base prefix, built from an S-sized gather, a scatter of the
    base increments at the boundaries and one more scan of those: exact in
    the wrapping integer ring. On the "cuda" backend both scans run on K4.
    Every other (op, dtype) takes the flagged-combine path (_flagged_scan)."""
    check_argument(x.ndim == 1, "offsets= expects a 1-D array, got shape %s", tuple(x.shape))
    from ._segments import validate_offsets

    n = x.shape[0]
    offs, _ = validate_offsets(offsets, n, x.device)
    backend = resolve_backend(backend, x)
    if n == 0:
        return torch.empty_like(x)
    if op != ReduceOperator.SUM or x.dtype.is_floating_point:
        return _flagged_scan(x, _segment_start_flags(offs, n), op, inclusive)
    b = _words(_scan_impl(x, 1, op, backend))  # global exclusive, as int32 words
    vals = b[offs[:-1].clamp(max=n - 1)]  # (S,): a tiny gather
    incs = vals.clone()
    incs[1:] -= vals[:-1]
    keep = offs[:-1] < n
    count("host_syncs.offsets_mask", 2)  # each boolean mask's selection fetches its count
    sparse = torch.zeros(n, dtype=torch.int32, device=x.device).index_add_(0, offs[:-1][keep], incs[keep])
    base = _scan_impl(sparse, 1, ReduceOperator.SUM, backend) + sparse  # inclusive
    out = b - base
    if inclusive:
        out = out + _words(x)
    return out.view(x.dtype)


def exclusive_scan(
    x: torch.Tensor,
    num_partitions: int = 1,
    op: ReduceOperator = ReduceOperator.SUM,
    *,
    backend: str | None = None,
    offsets=None,
) -> torch.Tensor:
    """Exclusive prefix scan of x under `op` (default sum), independently over
    `num_partitions` adjacent equal-length partitions. Returns a new tensor
    on x's device; x is untouched.

    x: (N,) scalar stream or (N, C) vector stream (per-component scan), with
    N divisible by num_partitions; any partition length (power of 2 not
    required). N == 0 returns an empty tensor.

    offsets: S+1 nondecreasing segment boundaries scan each variable-length
    segment independently (see _segmented_scan_offsets); 1-D only, and
    mutually exclusive with num_partitions > 1.

    backend: "cuda" for the K4 kernel, "torch" for torch's scans, None for
    the override GLU_TPU_TORCH_BACKEND or "cuda" (the scans have no router,
    as in the JAX package).
    """
    call = start_call("glu.exclusive_scan")
    try:
        _check_scan_args(x, num_partitions, op)
        if offsets is not None:
            check_argument(num_partitions in (1, None), "offsets and num_partitions are mutually exclusive")
            return _segmented_scan_offsets(x, offsets, op, backend, inclusive=False)
        return _scan_impl(x, num_partitions, op, resolve_backend(backend, x))
    finally:
        stop(call)


def inclusive_scan(
    x: torch.Tensor,
    num_partitions: int = 1,
    op: ReduceOperator = ReduceOperator.SUM,
    *,
    backend: str | None = None,
    offsets=None,
) -> torch.Tensor:
    """Inclusive prefix scan: `out[i] = op(x[j] for j <= i)` within each
    partition, derived as `op(exclusive, x)` elementwise, exact for every
    operator (wrapping u32 sums and products included). See exclusive_scan
    for the arguments."""
    call = start_call("glu.inclusive_scan")
    try:
        _check_scan_args(x, num_partitions, op)
        if offsets is not None:
            check_argument(num_partitions in (1, None), "offsets and num_partitions are mutually exclusive")
            return _segmented_scan_offsets(x, offsets, op, backend, inclusive=True)
        exc = _scan_impl(x, num_partitions, op, resolve_backend(backend, x))
        return combine_fn(op)(exc, x)
    finally:
        stop(call)


class BlellochScan:
    """Constructor-specialized scan operator (reference glu/BlellochScan.hpp:80-191).

    `BlellochScan(DataType.UINT)(buffer, count, num_partitions)` scans the
    first count*num_partitions elements: in place when given a
    DeviceBuffer (returning that slice of its tensor), as a new tensor when
    given a tensor. Enforces the reference's power-of-2 `count` check
    (BlellochScan.hpp:134). `operator` (default SUM, the reference's
    hardcoded op) extends the class to mul/min/max. Vector DataTypes take
    (N, C) buffers and scan per component.
    """

    def __init__(self, data_type: DataType, operator: ReduceOperator = ReduceOperator.SUM):
        self.info = check_dtype_supported(data_type)
        check_argument(isinstance(operator, ReduceOperator), "Invalid operator: %s", operator)
        self.data_type = data_type
        self.operator = operator

    def __call__(
        self,
        buffer: DeviceBuffer | torch.Tensor,
        count: int,
        num_partitions: int = 1,
        *,
        backend: str | None = None,
    ):
        call = start_call("glu.BlellochScan")
        try:
            data = buffer.data if isinstance(buffer, DeviceBuffer) else buffer
            check_argument(count >= 1, "Count must be >= 1")
            check_argument(is_power_of_2(count), "Count must be a power of 2 (got %d)", count)
            if self.info.components > 1:
                check_argument(
                    data.ndim == 2 and data.shape[1] == self.info.components,
                    "%s buffers carry components in the trailing axis (N, %d), got shape %s",
                    self.info.name, self.info.components, tuple(data.shape),
                )
            total = count * num_partitions
            check_argument(
                total <= data.shape[0], "count*num_partitions %d exceeds buffer size %d", total, data.shape[0]
            )
            result = exclusive_scan(data[:total], num_partitions, self.operator, backend=backend)
            if isinstance(buffer, DeviceBuffer):
                _words(data[:total]).copy_(_words(result))
                return data[:total]
            return result
        finally:
            stop(call)
''',
    'glu_tpu_torch.parallel': r'''"""Multi-process layer of the port (counterpart of glu_tpu/parallel).

The sort, reduce and scans over a torch.distributed process group in place
of the JAX mesh: each rank passes its own equal-length shard. The sort is
the sampled-splitter pipeline of dist_sort.py (splitters from gathered
samples, a stable bucket partition on the radix engine, one
all_to_all_single a stream with uneven split sizes, the stable local
sort); reduce and scan fold the D local results (dist_primitives.py). A
group serves the device type of its backend: NCCL serves CUDA tensors,
gloo CPU tensors.
"""

from .dist_primitives import (
    distributed_exclusive_scan,
    distributed_inclusive_scan,
    distributed_reduce,
)
from .dist_sort import (
    distributed_radix_sort,
    distributed_radix_sort_f32,
    distributed_radix_sort_i32,
    distributed_radix_sort_u64,
    distributed_radix_sort_u64_parts,
    make_sort_mesh,
)

__all__ = [
    "distributed_exclusive_scan",
    "distributed_inclusive_scan",
    "distributed_reduce",
    "distributed_radix_sort",
    "distributed_radix_sort_f32",
    "distributed_radix_sort_i32",
    "distributed_radix_sort_u64",
    "distributed_radix_sort_u64_parts",
    "make_sort_mesh",
]
''',
    'glu_tpu_torch.parallel._cuda_bucket': r'''"""KB: the bucket stage of the distributed sort, a hand-written Hopper
streaming kernel (csrc/bucket.cu).

Counterpart of glu_tpu/parallel/dist_sort.py:94-110 (`_bucket_of`) and
:133-147 (`_bucket_of64`), which are not pallas_calls: they unroll the D - 1
splitter comparisons so that XLA fuses them into one elementwise pass over
the shard. Each element's destination rank is the count of splitters <=
(key, global index) in lexicographic order, keys compared unsigned; the
global index of element i is base + i (base = rank * n), an int64 here
(the JAX package's uint32 wraps above 2**32 global elements; below, the two
agree). One launch of `glu_bucket_of` / `glu_bucket_of64` reads the keys
once and writes the int32 ids once: no global-index array, no (D-1)
elementwise passes, no int64 key arrays.

Precondition: the splitters are in non-decreasing lexicographic order (key,
index), or (hi, lo, index), as dist_sort's `_sample_splitters` and
`_sample_splitters64` return them (quantile positions of one stable sort
whose gathered indices ascend). The kernel searches them (binary lifting,
ceil(log2 D) steps); on unsorted splitters it does not count them.

`bucket_of` and `bucket_of64` check their arguments, allocate with
torch.empty, launch on the current stream and count their launches; given
CPU tensors they run the plain versions `bucket_of_ref` and
`bucket_of64_ref`, which count splitter by splitter.
"""

from __future__ import annotations

import torch

from ..ops._common import kernels, launch, on_cuda
from ..ops.radix_sort import _SIGN
from ..utils.errors import check_argument
from ..utils.timing import start, stop

# Splitters staged in shared memory, fixed at compile time in csrc/bucket.cu
# (kSmemSplitters) and checked when the library is loaded; more are searched
# in global memory.
SMEM_SPLITTERS = 2048

# Launch count of KB (both forms), bumped only where it is launched.
bucket_launches = 0


def reset_launch_counts() -> None:
    global bucket_launches
    bucket_launches = 0


def launch_counts() -> dict:
    return {"bucket_of": bucket_launches}


def ordered(t: torch.Tensor) -> torch.Tensor:
    """int32 whose signed order is the u32 order of t's words."""
    return t.view(torch.int32) ^ _SIGN


def wide_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the u64 order of (hi, lo) u32 words."""
    return (ordered(hi).to(torch.int64) << 32) | (lo.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)


def _count_below(keys: torch.Tensor, base: int, s_keys: torch.Tensor, s_idx: torch.Tensor) -> torch.Tensor:
    """The count of splitters <= (key, base + i) for each key, keys and
    splitter keys in a form whose signed order is the key order; one
    elementwise pass a splitter, int32."""
    n = keys.shape[0]
    gidx = base + torch.arange(n, dtype=torch.int64, device=keys.device)
    bucket = torch.zeros(n, dtype=torch.int32, device=keys.device)
    for i in range(s_keys.shape[0]):
        bucket += (s_keys[i] < keys) | ((s_keys[i] == keys) & (s_idx[i] <= gidx))
    return bucket


def bucket_of_ref(words: torch.Tensor, base: int, s_words: torch.Tensor, s_idx: torch.Tensor) -> torch.Tensor:
    """Plain version of `bucket_of`, splitter by splitter (needs no order of
    the splitters)."""
    return _count_below(ordered(words), base, ordered(s_words), s_idx)


def bucket_of64_ref(hi, lo, base: int, s_hi, s_lo, s_idx) -> torch.Tensor:
    """Plain version of `bucket_of64`, on int64 keys built from the words."""
    return _count_below(wide_key(hi, lo), base, wide_key(s_hi, s_lo), s_idx)


def _check(words: list, base: int, s_words: list, s_idx: torch.Tensor) -> None:
    first = words[0]
    for name, ts, dtype in (("keys", words, torch.uint32), ("splitter keys", s_words, torch.uint32),
                            ("splitter indices", [s_idx], torch.int64)):
        for t in ts:
            check_argument(t.dtype == dtype, "%s must be %s, got %s", name, dtype, t.dtype)
            check_argument(t.dim() == 1 and t.is_contiguous(), "%s must be 1-D and contiguous", name)
            check_argument(t.device == first.device, "keys on %s, %s on %s", first.device, name, t.device)
    check_argument(all(w.shape == first.shape for w in words), "key word length mismatch")
    check_argument(all(s.shape == s_idx.shape for s in s_words), "splitter length mismatch")
    check_argument(s_idx.shape[0] < 2**31, "too many splitters: %d", s_idx.shape[0])
    check_argument(0 <= int(base) <= 2**63 - 1 - first.shape[0], "base %s out of range", base)


def _launch(fn_name: str, words: list, base: int, s_words: list, s_idx: torch.Tensor) -> torch.Tensor:
    global bucket_launches
    n = words[0].shape[0]
    out = torch.empty(n, dtype=torch.int32, device=words[0].device)
    if n == 0:
        return out
    lib = kernels(bucket_smem_splitters=SMEM_SPLITTERS)
    launch(lib, fn_name, out.device, *(w.data_ptr() for w in words), n, int(base),
           *(s.data_ptr() for s in s_words), s_idx.data_ptr(), s_idx.shape[0], out.data_ptr())
    bucket_launches += 1
    return out


def bucket_of(words: torch.Tensor, base: int, s_words: torch.Tensor, s_idx: torch.Tensor) -> torch.Tensor:
    """KB (replaces dist_sort.py::_bucket_of): for each of the n u32 keys
    `words`, the count of the D - 1 splitters (s_words[j] u32, s_idx[j]
    int64), in non-decreasing lexicographic order, that are <= (words[i],
    base + i). Returns n int32, in one launch on a CUDA tensor."""
    opened = start("glu.engine.kb")
    try:
        _check([words], base, [s_words], s_idx)
        if not on_cuda(words):
            return bucket_of_ref(words, base, s_words, s_idx)
        return _launch("glu_bucket_of", [words], base, [s_words], s_idx)
    finally:
        stop(opened)


def bucket_of64(hi: torch.Tensor, lo: torch.Tensor, base: int, s_hi: torch.Tensor, s_lo: torch.Tensor,
                s_idx: torch.Tensor) -> torch.Tensor:
    """KB's 64-bit form (replaces dist_sort.py::_bucket_of64): the same count
    under lexicographic (hi, lo, global index) order, keys given as u32
    words."""
    opened = start("glu.engine.kb")
    try:
        _check([hi, lo], base, [s_hi, s_lo], s_idx)
        if not on_cuda(hi):
            return bucket_of64_ref(hi, lo, base, s_hi, s_lo, s_idx)
        return _launch("glu_bucket_of64", [hi, lo], base, [s_hi, s_lo], s_idx)
    finally:
        stop(opened)''',
    'glu_tpu_torch.parallel.dist_primitives': r'''"""Distributed reduce and exclusive scan over a torch.distributed process group.

Counterpart of glu_tpu/parallel/dist_primitives.py, with a process group in
place of the JAX mesh: each rank passes its own shard of a 1-D array, and
every shard has the same length (the JAX contract "global length divisible
by D"); global element i of rank r is r * n_local + i. Both compose the
single-card operators:

  - reduce: the local reduce (K5 on a CUDA tensor, or the router's choice
    for backend=None), one all_gather of the D partials, and their fold in
    rank order 0..D-1 on every rank;
  - exclusive scan: the local exclusive scan (K4 on a CUDA tensor), one
    all_gather of the D shard totals, and the fold of the totals of the
    ranks below this one, combined into every element. The rank is known on
    the host, so the fold runs over exactly those ranks.

Both support sum/mul/min/max (ReduceOperator); u32 sums and products wrap
as the single-card ops do, and u32 travels through the collectives as int32
bit patterns.

A group serves the device type of its backend: NCCL serves CUDA tensors and
gloo CPU tensors. A tensor on the other raises GluError before any
collective; it is never staged through the host. The helpers here (the
group, the device check, the all_gather and the shard-length check) are
shared with dist_sort.py.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.reduce import ReduceOperator, _full, check_kernel_dtype, combine_fn, identity_for, reduce
from ..ops.scan import exclusive_scan
from ..utils.errors import check_argument, check_state
from ..utils.timing import count, span, start_call, stop

_SERVES = {"nccl": "cuda", "gloo": "cpu"}  # backend -> the device type its collectives take


def _resolve_group(group):
    """`group`, or the default group for None; raises when torch.distributed
    is not initialised or this process is not a member."""
    check_state(dist.is_available() and dist.is_initialized(),
                "torch.distributed is not initialized: call init_process_group first")
    group = dist.group.WORLD if group is None else group
    check_state(dist.get_rank(group) >= 0, "this process is not a member of the group")
    return group


def _check_device(t: torch.Tensor, group) -> None:
    """Raise unless `group`'s backend serves t's device type (a group of
    several backends, "cpu:gloo,cuda:nccl", serves each of theirs)."""
    backends = str(dist.get_backend(group))
    served = {_SERVES.get(part.split(":")[-1]) for part in backends.split(",")}
    check_argument(
        t.device.type in served,
        "a tensor on %s cannot go through a group of backend %s (NCCL serves cuda tensors, gloo cpu tensors)",
        t.device, backends,
    )


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(D, *t.shape): every rank's t in rank order, on t's device. u32
    travels as its int32 bit patterns; a group of one rank needs no
    collective."""
    world = dist.get_world_size(group)
    if world == 1:
        return t.unsqueeze(0)
    w = (t.view(torch.int32) if t.dtype == torch.uint32 else t).contiguous()
    parts = [torch.empty_like(w) for _ in range(world)]
    dist.all_gather(parts, w, group=group)
    out = torch.stack(parts)
    return out.view(torch.uint32) if t.dtype == torch.uint32 else out


def _check_1d_sharded(x: torch.Tensor, group):
    """(group, rank, world size) after checking that x is a 1-D tensor on a
    device the group serves and that every rank's shard has x's length: one
    all_gather of the lengths (and a host sync), after which every rank
    raises together. One rank has nothing to compare. A span glu.dist.check."""
    check_argument(x.ndim == 1, "expected a 1-D shard, got shape %s", tuple(x.shape))
    group = _resolve_group(group)
    _check_device(x, group)
    if dist.get_world_size(group) == 1:
        return group, 0, 1
    with span("glu.dist.check"):
        length = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
        lengths = _all_gather(length, group).view(-1).tolist()
        # the lengths' fetch, and on the card the copy of this rank's length onto it
        count("host_syncs.dist_check", 1 + int(length.is_cuda))
    check_argument(len(set(lengths)) == 1, "shards must have equal lengths, got %s by rank", lengths)
    return group, dist.get_rank(group), len(lengths)


def distributed_reduce(
    x: torch.Tensor,
    group=None,
    op: ReduceOperator = ReduceOperator.SUM,
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """Reduce a 1-D array sharded over `group` (None: the default group) to
    one global scalar, the same 0-d tensor on every rank. x is this rank's
    shard. Wrapping u32 sum/mul semantics match the single-card reduce;
    `backend` goes to it."""
    call = start_call("glu.distributed_reduce")
    try:
        check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
        check_kernel_dtype(x.dtype)
        group, _, world = _check_1d_sharded(x, group)
        check_argument(x.shape[0] >= 1, "reduce requires count >= 1")
        combine = combine_fn(op)
        partials = _all_gather(reduce(x, op, backend=backend).reshape(1), group)[:, 0]  # (D,) tiny
        total = partials[0]
        for d in range(1, world):
            total = combine(total, partials[d])
        return total
    finally:
        stop(call)


def distributed_exclusive_scan(
    x: torch.Tensor,
    group=None,
    op: ReduceOperator = ReduceOperator.SUM,
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """Exclusive prefix scan under `op` of a 1-D array sharded over `group`,
    sharded the same way on output: element i of this rank's shard receives
    the op-fold of the elements before it in GLOBAL order (rank-major
    shards, the distributed sort's index convention)."""
    call = start_call("glu.distributed_exclusive_scan")
    try:
        check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
        check_kernel_dtype(x.dtype)
        group, rank, _ = _check_1d_sharded(x, group)
        if x.shape[0] == 0:
            return torch.empty_like(x)
        combine = combine_fn(op)
        local_exc = exclusive_scan(x, 1, op, backend=backend)
        # shard total = op(exclusive[-1], x[-1]): no second reduction
        totals = _all_gather(combine(local_exc[-1:], x[-1:]), group)[:, 0]  # (D,) tiny
        prefix = _full((), identity_for(op, x.dtype), x.dtype, x.device)
        for d in range(rank):
            prefix = combine(prefix, totals[d])
        return combine(local_exc, prefix)
    finally:
        stop(call)


def distributed_inclusive_scan(
    x: torch.Tensor,
    group=None,
    op: ReduceOperator = ReduceOperator.SUM,
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """Inclusive variant: `op(exclusive, x)` elementwise (exact for every
    operator, wrapping arithmetic included)."""
    call = start_call("glu.distributed_inclusive_scan")
    try:
        exc = distributed_exclusive_scan(x, group, op, backend=backend)
        return combine_fn(op)(exc, x)
    finally:
        stop(call)
''',
    'glu_tpu_torch.parallel.dist_sort': r'''"""Distributed stable radix sort over a torch.distributed process group.

Counterpart of glu_tpu/parallel/dist_sort.py, with a process group in place
of the JAX mesh. Each rank passes its own shard; every shard has the same
length, and global index i of rank r is r * n_local + i (rank-major, the
global input order that stability refers to). The pipeline, on every rank:

  1. splitter sampling: strided (key, global index) samples of the shard
     (`_local_samples`), one all_gather, and D-1 quantiles of the gathered
     samples in LEXICOGRAPHIC (key, index) order (`_sample_splitters`): the
     index tiebreak makes every sample distinct, so runs of equal keys are
     split over ranks as evenly as distinct keys;
  2. bucket partition: the destination rank of each element
     (`_bucket_of`: KB, one launch of csrc/bucket.cu on a CUDA tensor and
     backend "cuda", one read of the keys; parallel/_cuda_bucket.py), then
     one stable partial sort on the
     bucket ids over exactly ceil(log2 D) bits that carries every stream
     (`_partition_by_bucket`, the radix engine on a CUDA tensor);
  3. the exchange: one all_gather of every rank's counts a destination,
     brought to the host (a host sync: all_to_all_single takes its split
     sizes as host lists), the plan (`ragged_exchange_plan`), and one
     all_to_all_single per stream with uneven split sizes; blocks arrive in
     source order;
  4. the stable local sort of what arrived, with the caller's backend and
     the global `bits`.

Stability: blocks are exchanged in source order, each block keeps source
order (step 2 is a stable sort), and the local sort is stable, so ties keep
their global input order. The shard is cut into `pipeline_chunks` adjacent
chunks: chunk c's exchange is issued (async) before chunk c+1 is
partitioned, so the two overlap; blocks are placed source-major,
chunk-minor, which is global index order, so the result is bit-identical
to one chunk. One rank (D = 1) sorts its shard alone.

Differences from the JAX package, which sizes XLA's static buffers: eager
torch knows every split size on the host, so the exchange is exact. There
are no padded blocks (`_spread_to_padded`, `_compact_blocks`), capacities,
overflow retries (`_attempt_capacities`, `_run_attempts`), cached programs
or exchange choice; the arguments capacity_factor, recv_capacity_factor,
max_retries and exchange do not exist. `keys`/`values` hold exactly this
rank's received elements, sorted, with no pad tail; `counts` is the (D,)
int32 tensor of every rank's count, the same on every rank; `overflow` is
a (D,) int32 tensor of zeros.

Every stage operates on a LIST of u32 streams permuted identically, so one
pipeline serves u32 keys (keys, values), f32 and i32 keys (bijected to
u32) and 64-bit keys ((hi, lo, values), lexicographic splitters, the
chained local sort); descending order is complemented keys throughout.
The stage functions (`_local_samples*`, `_sample_splitters*`,
`_bucket_of*`, `_partition_by_bucket`, `ragged_exchange_plan`) take a rank,
a world size and tensors and touch no group; only the public functions and
the exchange call torch.distributed. A group serves the device type of its
backend (NCCL cuda, gloo cpu); a tensor on the other raises GluError
before any collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.backend import _VALID, resolve_backend
from ..ops.radix_sort import (
    _SIGN,
    _check_inputs,
    _envelope_positions,
    _f32_to_sortable,
    _key_envelope,
    _norm_bits,
    _sortable_to_f32,
    radix_sort,
    radix_sort_multi,
    radix_sort_u64_parts,
)
from ..utils.errors import check_argument
from ..utils.timing import count, span, start_call, stop
from ._cuda_bucket import bucket_of, bucket_of64, bucket_of64_ref, bucket_of_ref, ordered, wide_key
from .dist_primitives import _all_gather, _check_1d_sharded, _resolve_group


def make_sort_mesh(ranks=None):
    """The process group the distributed functions take: the default group
    for ranks=None, else `dist.new_group(ranks)`, which every process of the
    default group must call. torch.distributed must be initialised (the
    library does not own the runtime); callers with a group pass it
    directly."""
    group = _resolve_group(None)
    return group if ranks is None else dist.new_group(sorted(int(r) for r in ranks))


def _words(t: torch.Tensor) -> torch.Tensor:
    """u32 words as their int32 bit patterns: torch indexes, compares and
    shifts uint32 tensors on the card only that way."""
    return t.view(torch.int32)


def _u32(w: torch.Tensor) -> torch.Tensor:
    return w.view(torch.uint32)


# ---------------------------------------------------------------------------
# stage functions: a rank, a world size and tensors; no group
# ---------------------------------------------------------------------------


def _local_samples(keys: torch.Tensor, rank: int, num_samples: int):
    """This rank's strided samples of its u32 shard and their global
    indices (int64): the local half of the JAX _sample_splitters. The
    stride is a ceiling, so that the samples SPAN the shard (a floor stride
    of 1 on shards of n in (num_samples, 2 * num_samples) would sample only
    a prefix)."""
    n = keys.shape[0]
    stride = -(-n // num_samples)
    take = min(num_samples, -(-n // stride))
    idx = rank * n + torch.arange(take, dtype=torch.int64, device=keys.device) * stride
    return _u32(_words(keys)[::stride][:take].contiguous()), idx


def _quantiles(ordered: torch.Tensor, num_devices: int) -> torch.Tensor:
    """Positions among the gathered samples of the D-1 splitters: quantile
    (i + 1) / D of one stable sort by `ordered`. The gathered (rank-major)
    indices ascend, so ties keep index order and this is the lexicographic
    (key, global index) order of the JAX lax.sort(num_keys=2|3)."""
    order = torch.sort(ordered, stable=True).indices
    m = order.shape[0]
    return order[torch.arange(1, num_devices, dtype=torch.int64, device=order.device) * m // num_devices]


def _sample_splitters(all_samples: torch.Tensor, all_idx: torch.Tensor, num_devices: int):
    """Global quantile splitters from the gathered samples in lexicographic
    (key, global index) order, keys compared unsigned: the pure half of the
    JAX _sample_splitters. Bucket i takes the pairs in [s_{i-1}, s_i).
    Returns (splitter keys u32, splitter indices int64), D - 1 each, in
    non-decreasing lexicographic order (KB's precondition)."""
    q = _quantiles(ordered(all_samples), num_devices)
    return _u32(_words(all_samples)[q]), all_idx[q]


def _bucket_of(keys: torch.Tensor, rank: int, splitter_keys: torch.Tensor, splitter_idx: torch.Tensor,
               backend=None):
    """Destination rank of each element of this rank's u32 shard under
    lexicographic (key, global index) order: KB (`bucket_of`), or its plain
    version where the backend resolves to "torch". Returns int32 bucket
    ids."""
    keys = keys.contiguous()
    if resolve_backend(backend, keys) == "torch":
        return bucket_of_ref(keys, rank * keys.shape[0], splitter_keys, splitter_idx)
    return bucket_of(keys, rank * keys.shape[0], splitter_keys, splitter_idx)


def _local_samples64(hi: torch.Tensor, lo: torch.Tensor, rank: int, num_samples: int):
    """64-bit analog of _local_samples: (hi samples, lo samples, global
    indices)."""
    s_hi, idx = _local_samples(hi, rank, num_samples)
    s_lo, _ = _local_samples(lo, rank, num_samples)
    return s_hi, s_lo, idx


def _sample_splitters64(all_hi, all_lo, all_idx, num_devices: int):
    """64-bit analog of _sample_splitters: quantiles in lexicographic (hi,
    lo, global index) order. Returns (s_hi, s_lo, s_idx), in non-decreasing
    lexicographic order."""
    q = _quantiles(wide_key(all_hi, all_lo), num_devices)
    return _u32(_words(all_hi)[q]), _u32(_words(all_lo)[q]), all_idx[q]


def _bucket_of64(hi, lo, rank: int, s_hi, s_lo, s_idx, backend=None):
    """Destination rank under lexicographic (hi, lo, global index) order:
    KB's 64-bit form (`bucket_of64`), or its plain version where the backend
    resolves to "torch"."""
    hi, lo = hi.contiguous(), lo.contiguous()
    if resolve_backend(backend, hi) == "torch":
        return bucket_of64_ref(hi, lo, rank * hi.shape[0], s_hi, s_lo, s_idx)
    return bucket_of64(hi, lo, rank * hi.shape[0], s_hi, s_lo, s_idx)


def _partition_by_bucket(bucket: torch.Tensor, arrays, num_devices: int, backend):
    """Stable grouping of the shard's u32 streams by destination bucket:
    ONE stable partial sort keyed on the bucket ids over exactly ceil(log2
    D) bits, carrying every stream (radix_sort_multi: on a CUDA tensor and
    backend "cuda", one histogram and one onesweep pass for D <= 256).
    Offsets come from a binary search over the sorted bucket ids. Returns
    (arrays, counts, offsets), int32, buckets contiguous in ascending
    order."""
    n = bucket.shape[0]
    dev = bucket.device
    if num_devices == 1:
        return list(arrays), torch.full((1,), n, dtype=torch.int32, device=dev), torch.zeros(1, dtype=torch.int32, device=dev)
    nbits = max((num_devices - 1).bit_length(), 1)
    sb, outs = radix_sort_multi(_u32(bucket), tuple(arrays), backend=backend, bits=tuple(range(nbits)))
    ids = torch.arange(num_devices, dtype=torch.int32, device=dev)
    offsets = torch.searchsorted(_words(sb), ids, side="left", out_int32=True)
    ends = torch.cat([offsets[1:], offsets.new_full((1,), n)])
    return list(outs), ends - offsets, offsets


def ragged_exchange_plan(row_counts: torch.Tensor, recv_capacity):
    """Descriptor algebra of the bucket exchange (the JAX package's, ported
    as it is). row_counts: (R, D), row r sends row_counts[r, d] elements to
    rank d; rows are sources, or (source, chunk) pairs in source-major,
    chunk-minor order, placed in ascending row order in each receiver's
    buffer of `recv_capacity` slots.

    Returns (starts, sizes, total_recv) in row_counts' dtype: starts[r, d],
    where row r's block lands in rank d's buffer; sizes[r, d], the elements
    written, clamped so that starts + sizes <= recv_capacity always;
    total_recv[d], the true total (pre-clamp). The port's exchange is exact:
    it passes the whole count as the capacity, so nothing is clamped, and
    sizes[:, d] are rank d's receive sizes."""
    starts_all = torch.cumsum(row_counts, 0, dtype=row_counts.dtype) - row_counts
    total_recv = torch.sum(row_counts, 0, dtype=row_counts.dtype)
    starts = torch.clamp(starts_all, max=recv_capacity)
    sizes = torch.minimum(row_counts, recv_capacity - starts)
    return starts, sizes, total_recv


# ---------------------------------------------------------------------------
# the exchange and the shard pipelines (these call torch.distributed)
# ---------------------------------------------------------------------------


def _resolve_chunks(pipeline_chunks, num_devices: int, local_n: int) -> int:
    """Resolve pipeline_chunks="auto": 2 chunks at D >= 2 when the shard
    divides evenly, else 1. Explicit ints are validated and honoured."""
    if pipeline_chunks == "auto":
        return 2 if (num_devices > 1 and local_n % 2 == 0 and local_n >= 2) else 1
    chunks = int(pipeline_chunks)
    check_argument(chunks >= 1, "pipeline_chunks must be >= 1")
    check_argument(local_n % chunks == 0, "local shard length %d not divisible by pipeline_chunks=%d",
                   local_n, chunks)
    return chunks


def _exchange_and_sort(arrays, bucket, local_sort, *, group, rank: int, num_devices: int, backend,
                       num_chunks: int):
    """Partition, exchange and sort this rank's u32 streams (bucket ids
    given), chunk by chunk: the chunk's partition, one all_gather of its
    counts a destination brought to the host (a host sync a chunk: the
    split sizes of all_to_all_single are host lists), the plan, and one
    async all_to_all_single per stream, issued before the next chunk is
    partitioned so that the two overlap. Once every transfer is waited on,
    the blocks are placed source-major, chunk-minor and sorted by
    `local_sort`. Returns (sorted streams, counts (D,) int32). Spans: a
    chunk's glu.dist.partition, glu.dist.counts and glu.dist.exchange, then
    glu.dist.place, glu.dist.local_sort and glu.dist.total (the counts'
    copy onto the card); the counter dist.bytes_sent counts the bytes this
    rank sends to the others."""
    chunk_len = bucket.shape[0] // num_chunks
    received = [[] for _ in arrays]  # [stream][chunk]: (what arrived, its sizes by source)
    total = torch.zeros(num_devices, dtype=torch.int32)
    pending = []
    for c in range(num_chunks):
        cut = slice(c * chunk_len, (c + 1) * chunk_len)
        with span("glu.dist.partition"):
            parts, counts, _ = _partition_by_bucket(bucket[cut], [a[cut] for a in arrays], num_devices, backend)
        with span("glu.dist.counts"):
            rows = _all_gather(counts, group).cpu()  # (source, destination)
            count("host_syncs.dist_counts")
        with span("glu.dist.exchange"):
            _, sizes, total_c = ragged_exchange_plan(rows, int(rows.sum()))  # exact: nothing is clamped
            send, recv = rows[rank].tolist(), sizes[:, rank].tolist()
            total += total_c
            for stream, part in enumerate(parts):
                out = torch.empty(sum(recv), dtype=torch.int32, device=part.device)
                work = dist.all_to_all_single(out, _words(part), recv, send, group=group, async_op=True)
                pending.append((work, part))
                received[stream].append((out, recv))
            count("dist.bytes_sent", 4 * len(parts) * (sum(send) - send[rank]))

    def placed(chunks):
        # the plan over (source, chunk) rows puts block (s, c) at the running
        # count in (source, chunk) order; one chunk arrived in that order
        if len(chunks) == 1:
            return _u32(chunks[0][0])
        blocks = [out.split(recv) for out, recv in chunks]
        return _u32(torch.cat([blocks[c][s] for s in range(num_devices) for c in range(num_chunks)]))

    with span("glu.dist.place"):
        for work, _ in pending:
            work.wait()
        streams = [placed(chunks) for chunks in received]
    with span("glu.dist.local_sort"):
        result = list(local_sort(*streams))
    with span("glu.dist.total"):
        total = total.to(bucket.device)
        if total.is_cuda:
            count("host_syncs.dist_total")  # the counts' copy onto the card waits for its stream
    return result, total


def _dist_sort_shard(keys, values, local_sort, *, group, rank: int, num_devices: int, num_samples: int,
                     backend, num_chunks: int):
    """The u32 pipeline on this rank's shard. D == 1 is the exact fast path:
    nothing to sample, bucket or exchange, so the composition is the local
    sort. Returns ([keys, values], counts)."""
    dev = keys.device
    if num_devices == 1:
        with span("glu.dist.local_sort"):
            return list(local_sort(keys, values)), torch.full((1,), keys.shape[0], dtype=torch.int32, device=dev)
    with span("glu.dist.splitters"):
        samples, idx = _local_samples(keys, rank, num_samples)
        sk, si = _sample_splitters(_all_gather(samples, group).reshape(-1), _all_gather(idx, group).reshape(-1),
                                   num_devices)
    with span("glu.dist.bucket"):
        bucket = _bucket_of(keys, rank, sk, si, backend)
    return _exchange_and_sort([keys, values], bucket, local_sort, group=group, rank=rank,
                              num_devices=num_devices, backend=backend, num_chunks=num_chunks)


def _dist_sort_shard64(hi, lo, values, local_sort, *, group, rank: int, num_devices: int, num_samples: int,
                       backend, num_chunks: int):
    """The (hi, lo) 64-bit pipeline on this rank's shard. Returns ([hi, lo,
    values], counts)."""
    dev = hi.device
    if num_devices == 1:
        with span("glu.dist.local_sort"):
            return list(local_sort(hi, lo, values)), torch.full((1,), hi.shape[0], dtype=torch.int32, device=dev)
    with span("glu.dist.splitters"):
        s_hi, s_lo, idx = _local_samples64(hi, lo, rank, num_samples)
        gathered = [_all_gather(t, group).reshape(-1) for t in (s_hi, s_lo, idx)]
        shi, slo, sidx = _sample_splitters64(*gathered, num_devices)
    with span("glu.dist.bucket"):
        bucket = _bucket_of64(hi, lo, rank, shi, slo, sidx, backend)
    return _exchange_and_sort([hi, lo, values], bucket, local_sort, group=group, rank=rank,
                              num_devices=num_devices, backend=backend, num_chunks=num_chunks)


def _global_positions(key_words, group, backend):
    """bits="auto" over the GLOBAL array: each rank's (OR, AND) envelope of
    every key word, one all_gather, folded on the host (NCCL has no bitwise
    reduce op). Returns the positions of each word."""
    with span("glu.bits_auto"):
        env = torch.cat([_key_envelope(_words(w), resolve_backend(backend, w)) for w in key_words])
        rows = _all_gather(env, group).tolist()  # (D, 2 * words): a host sync
        count("host_syncs.dist_bits_auto")
    positions = []
    for j in range(len(key_words)):
        or_word, and_word = 0, 0xFFFFFFFF
        for row in rows:
            or_word |= row[2 * j]
            and_word &= row[2 * j + 1]
        positions.append(_envelope_positions(or_word, and_word))
    return positions


def _check_common(num_samples, backend) -> None:
    check_argument(backend is None or backend in _VALID, "Invalid backend: %s (want None or one of %s)", backend,
                   _VALID)
    check_argument(int(num_samples) >= 1, "num_samples must be >= 1, got %s", num_samples)


# ---------------------------------------------------------------------------
# public functions
# ---------------------------------------------------------------------------


def distributed_radix_sort(
    keys: torch.Tensor,
    values: torch.Tensor,
    group=None,
    *,
    num_samples: int = 8192,
    backend: str | None = None,
    descending: bool = False,
    pipeline_chunks="auto",
    bits=None,
):
    """Globally sort u32 (key, value) pairs sharded over `group` (None: the
    default group). keys/values: this rank's shard, 1-D torch.uint32 of
    equal length on every rank, on a device the group's backend serves.

    Returns (keys, values, counts, overflow): this rank's keys and values,
    the r-th global key range for rank r, sorted and stable (ties keep
    their global input order), exactly counts[rank] of them; counts, the
    (D,) int32 counts of every rank, the same on every rank; overflow, (D,)
    int32 zeros (the exchange is exact). descending=True sorts high to low
    (rank 0 holds the LARGEST keys), stable, via complemented keys.

    num_samples: samples a rank (at most its shard) for the splitters.
    backend: the single-card sorts' ("cuda", "torch" or None, routed).
    pipeline_chunks: "auto" (2 chunks at D >= 2 when the shard divides
    evenly, else 1) or an int dividing the shard: each chunk is partitioned
    and its exchange issued before the next chunk's partition. bits: None,
    explicit positions, or "auto", the varying bits of the GLOBAL array
    (an envelope a rank, one all_gather and a host sync), to which every
    rank's local sort prunes; splitters order by the full key.
    """
    call = start_call("glu.distributed_radix_sort")
    try:
        _check_inputs(keys, torch.uint32, values=values)
        _check_common(num_samples, backend)
        group, rank, world = _check_1d_sharded(keys, group)
        local_n = keys.shape[0]
        chunks = _resolve_chunks(pipeline_chunks, world, local_n)
        words = ~_words(keys) if descending else _words(keys)  # NOT reverses u32 order; stability is kept
        if bits == "auto":
            positions = _global_positions([words], group, backend)[0]
        else:
            positions = _norm_bits(bits, words, 0, backend)
        dev = keys.device
        overflow = torch.zeros(world, dtype=torch.int32, device=dev)
        if local_n == 0:
            return keys, values, torch.zeros(world, dtype=torch.int32, device=dev), overflow
        (out_k, out_v), counts = _dist_sort_shard(
            _u32(words), values, lambda k, v: radix_sort(k, v, backend=backend, bits=positions),
            group=group, rank=rank, num_devices=world, num_samples=min(int(num_samples), local_n),
            backend=backend, num_chunks=chunks,
        )
        if descending:
            out_k = _u32(~_words(out_k))
        return out_k, out_v, counts, overflow
    finally:
        stop(call)


def distributed_radix_sort_f32(keys: torch.Tensor, values: torch.Tensor, group=None, *, descending: bool = False,
                               **kwargs):
    """Globally sort f32 (key, value) pairs sharded over `group`, via the
    order-preserving f32 -> u32 bijection of radix_sort_f32 (IEEE-754 total
    order: -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN). The
    bijection is monotonic, so splitters, buckets and every rank's range
    carry over. Same contract as distributed_radix_sort, with float32 keys."""
    call = start_call("glu.distributed_radix_sort_f32")
    try:
        _check_inputs(keys, torch.float32, values=values)
        out = distributed_radix_sort(_u32(_f32_to_sortable(keys.contiguous().view(torch.int32))), values, group,
                                     descending=descending, **kwargs)
        return (_sortable_to_f32(_words(out[0])), *out[1:])
    finally:
        stop(call)


def distributed_radix_sort_i32(keys: torch.Tensor, values: torch.Tensor, group=None, *, descending: bool = False,
                               **kwargs):
    """Globally sort i32 (key, value) pairs sharded over `group`, via the
    sign-bit flip of radix_sort_i32 (an order-preserving bijection onto
    u32). Same contract as distributed_radix_sort, with int32 keys."""
    call = start_call("glu.distributed_radix_sort_i32")
    try:
        _check_inputs(keys, torch.int32, values=values)
        out = distributed_radix_sort(_u32(keys.contiguous() ^ _SIGN), values, group, descending=descending, **kwargs)
        return (_words(out[0]) ^ _SIGN, *out[1:])
    finally:
        stop(call)


def distributed_radix_sort_u64_parts(
    keys_hi: torch.Tensor,
    keys_lo: torch.Tensor,
    values: torch.Tensor,
    group=None,
    *,
    num_samples: int = 8192,
    backend: str | None = None,
    descending: bool = False,
    pipeline_chunks="auto",
    bits=None,
):
    """Globally sort 64-bit keys given as (hi, lo) u32 halves, with u32
    values, sharded over `group`: the distributed form of
    radix_sort_u64_parts. Splitters and buckets use lexicographic (hi, lo,
    global index) order, the partition carries the three streams, and the
    local sort is the chained 32-bit composition. Returns (hi, lo, values,
    counts, overflow). bits: None or "auto", which prunes the constant bits
    of EACH word of the global array."""
    call = start_call("glu.distributed_radix_sort_u64_parts")
    try:
        _check_inputs(keys_hi, torch.uint32, keys_lo=keys_lo, values=values)
        _check_common(num_samples, backend)
        check_argument(bits in (None, "auto"), 'distributed u64 sorts accept only bits=None or "auto"')
        group, rank, world = _check_1d_sharded(keys_hi, group)
        local_n = keys_hi.shape[0]
        chunks = _resolve_chunks(pipeline_chunks, world, local_n)
        hi, lo = _words(keys_hi), _words(keys_lo)
        if descending:  # complementing both words reverses u64 order
            hi, lo = ~hi, ~lo
        positions = tuple(_global_positions([hi, lo], group, backend)) if bits == "auto" else None
        dev = keys_hi.device
        overflow = torch.zeros(world, dtype=torch.int32, device=dev)
        if local_n == 0:
            return keys_hi, keys_lo, values, torch.zeros(world, dtype=torch.int32, device=dev), overflow
        (out_hi, out_lo, out_v), counts = _dist_sort_shard64(
            _u32(hi), _u32(lo), values,
            lambda h, l, v: radix_sort_u64_parts(h, l, v, backend=backend, bits=positions),
            group=group, rank=rank, num_devices=world, num_samples=min(int(num_samples), local_n),
            backend=backend, num_chunks=chunks,
        )
        if descending:
            out_hi, out_lo = _u32(~_words(out_hi)), _u32(~_words(out_lo))
        return out_hi, out_lo, out_v, counts, overflow
    finally:
        stop(call)


def distributed_radix_sort_u64(keys: torch.Tensor, values: torch.Tensor, group=None, **kwargs):
    """Globally sort (u64 key, u32 value) pairs (keys torch.uint64) sharded
    over `group`, via distributed_radix_sort_u64_parts on the int32 pairs
    the keys are made of. Returns (keys, values, counts, overflow)."""
    call = start_call("glu.distributed_radix_sort_u64")
    try:
        _check_inputs(keys, torch.uint64, values=values)
        pairs = keys.contiguous().view(torch.int32).view(-1, 2)  # little-endian: (lo, hi) of each key
        out_hi, out_lo, out_v, counts, overflow = distributed_radix_sort_u64_parts(
            _u32(pairs[:, 1].contiguous()), _u32(pairs[:, 0].contiguous()), values, group, **kwargs
        )
        out = torch.empty((out_hi.shape[0], 2), dtype=torch.int32, device=out_hi.device)
        out[:, 0], out[:, 1] = _words(out_lo), _words(out_hi)
        return out.view(torch.uint64).view(-1), out_v, counts, overflow
    finally:
        stop(call)
''',
    'glu_tpu_torch.utils': r'''"""Runtime utility layer of the port (counterpart of glu_tpu/utils)."""

from .errors import GluError, check_argument, check_state, fail
from .dtypes import DataType, check_dtype_supported, dtype_info, to_torch_dtype, to_type_str
from .math import (
    div_ceil,
    is_power_of_2,
    log2_ceil,
    log2_floor,
    log32_ceil,
    log32_floor,
    next_power_of_2,
)
from .buffers import DeviceBuffer, copy_buffer, default_device, from_numpy, to_numpy
from .timing import measure_elapsed_time
from .debug import print_buffer, print_buffer_hex, print_container
''',
    'glu_tpu_torch.utils.buffers': r'''"""Device buffers and the numpy bridge (counterpart of glu_tpu/utils/buffers.py).

`from_numpy` / `to_numpy` carry arrays between the host and the port: a u32
numpy array (what `np.asarray(jax_array)` gives) becomes a `torch.uint32`
tensor on the requested device and comes back as u32. The tests feed the JAX
package and the port identical inputs through them.

Where a function makes a tensor and is given no device, the tensor goes to
the card (`default_device()`); without one it raises rather than falling
back to the CPU. Work on the CPU is asked for with `device="cpu"`.

torch implements little arithmetic for `uint32`, so every copy and fill here
works on the tensor's int32 view (`_words`): the bits are the same.

`DeviceBuffer` is the reference's ShaderStorageBuffer (gl_utils.hpp:146-246)
over a torch tensor. Unlike the JAX handle, which swaps immutable arrays, it
writes into its tensor in place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .errors import check_argument, check_state


def default_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the card, torch.device("cuda").
    Raises when None is given and no CUDA device is available."""
    if device is not None:
        return torch.device(device)
    check_state(
        torch.cuda.is_available(),
        "no CUDA device is available: pass device='cpu' to work on the CPU",
    )
    return torch.device("cuda")


def _words(t: torch.Tensor) -> torch.Tensor:
    """The same storage, viewed as int32 when it holds u32 words."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """Copy a numpy array to a new tensor on `device`, by default the card
    (u32 stays u32)."""
    device = default_device(device)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device, copy=True).view(torch.uint32)
    return torch.from_numpy(a).to(device, copy=True)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Copy a tensor to a new host numpy array (u32 stays u32)."""
    host = _words(t.detach()).cpu().numpy().copy()
    return host.view(np.uint32) if t.dtype == torch.uint32 else host


def _zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    _words(out).zero_()
    return out


def _resized(data: torch.Tensor, size: int) -> torch.Tensor:
    if size <= data.shape[0]:
        return data[:size]
    out = _zeros((size,) + tuple(data.shape[1:]), data.dtype, data.device)
    _words(out[: data.shape[0]]).copy_(_words(data))
    return out


def copy_buffer(src: torch.Tensor, dst_size: Optional[int] = None) -> torch.Tensor:
    """Device-device copy (reference gl_utils.hpp:13-22). Optionally resizes,
    padding with zeros."""
    out = _words(src).clone().view(src.dtype)
    if dst_size is not None and dst_size != src.shape[0]:
        out = _resized(out, dst_size)
    return out


class DeviceBuffer:
    """A growable device tensor handle (reference ShaderStorageBuffer,
    gl_utils.hpp:146-246).

    size/resize/clear/write_data/get_data mirror the SSBO surface; `data`
    exposes the current tensor for use with the functional ops. `init` may be
    a numpy array (copied to `device`, by default the card) or a tensor (kept
    as it is, unless `device` is given); `size=` makes zeros on `device`, by
    default the card.
    """

    def __init__(self, init=None, *, size: int = 0, dtype=torch.uint32, device=None):
        if init is None:
            self._data = _zeros((size,), dtype, default_device(device))
        elif isinstance(init, torch.Tensor):
            self._data = init if device is None else init.to(device)
        else:
            self._data = from_numpy(np.asarray(init), device)

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @data.setter
    def data(self, value: torch.Tensor) -> None:
        self._data = value

    @property
    def size(self) -> int:
        """Element count (the reference tracks bytes; elements are the natural
        unit for typed tensors)."""
        return int(self._data.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def device(self) -> torch.device:
        return self._data.device

    def resize(self, size: int, keep_data: bool = False) -> None:
        """Grow/shrink, optionally preserving contents
        (reference gl_utils.hpp:194-212)."""
        check_argument(size >= 0, "Invalid size: %d", size)
        if size == self.size:
            return
        if keep_data:
            self._data = _resized(self._data, size)
        else:
            self._data = _zeros((size,) + tuple(self._data.shape[1:]), self.dtype, self.device)

    def clear(self, value=0) -> None:
        """Fill with a constant (reference gl_utils.hpp:215-219, which clears
        via GL_R32UI fill)."""
        if self.dtype == torch.uint32:
            value = int(np.uint32(value).view(np.int32))
        _words(self._data).fill_(value)

    def write_data(self, host_data) -> None:
        """Upload host data starting at offset 0 (reference gl_utils.hpp:222-227)."""
        arr = np.asarray(host_data).astype(_numpy_dtype(self.dtype), copy=False)
        check_argument(
            arr.shape[0] <= self.size,
            "write of %d elements exceeds buffer size %d",
            arr.shape[0],
            self.size,
        )
        _words(self._data[: arr.shape[0]]).copy_(_words(from_numpy(arr, self.device)))

    def get_data(self, count: Optional[int] = None) -> np.ndarray:
        """Read back to host (reference gl_utils.hpp:230-238)."""
        return to_numpy(self._data if count is None else self._data[:count])
''',
    'glu_tpu_torch.utils.debug': r'''"""Host-side debug printers (counterpart of glu_tpu/utils/debug.py).

Analog of reference glu/gl_utils.hpp:304-329 (print_stl_container,
print_buffer, print_buffer_hex): dump any container / tensor in decimal or
hex for eyeballing intermediate state (e.g. a partial sort via `num_steps`).
"""

from __future__ import annotations

import sys

from .buffers import to_numpy


def print_container(values, *, name: str = "", file=sys.stdout) -> None:
    """Print an iterable of values on one line (reference gl_utils.hpp:304-312)."""
    if name:
        print(f"{name}: ", end="", file=file)
    print(" ".join(str(v) for v in values), file=file)


def print_buffer(buffer, count: int | None = None, *, name: str = "", file=sys.stdout) -> None:
    """Print a tensor / DeviceBuffer in decimal (reference gl_utils.hpp:314-321)."""
    data = getattr(buffer, "data", buffer)
    host = to_numpy(data if count is None else data[:count])
    print_container(host.reshape(host.shape[0], -1).squeeze().tolist(), name=name, file=file)


def print_buffer_hex(buffer, count: int | None = None, *, name: str = "", file=sys.stdout) -> None:
    """Print a tensor / DeviceBuffer in hex (reference gl_utils.hpp:323-329)."""
    data = getattr(buffer, "data", buffer)
    host = to_numpy(data if count is None else data[:count])
    print_container([hex(int(v)) for v in host.reshape(-1)], name=name, file=file)
''',
    'glu_tpu_torch.utils.dtypes': r'''"""Element type registry (counterpart of glu_tpu/utils/dtypes.py).

The same 12 logical element types as the reference (glu/data_types.hpp:8-44),
each mapped to a torch dtype plus a number of components. Vector types are
tensors with a trailing component axis of size 2 or 4, the layout of the JAX
package. Unlike the TPU, the GPU has f64 ALUs, so DOUBLE and DVEC* need no
special mode.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from .errors import check_argument


class DataType(enum.Enum):
    """The 12 GLU element types (reference glu/data_types.hpp:8-22)."""

    FLOAT = 0
    DOUBLE = 1
    INT = 2
    UINT = 3
    VEC2 = 4
    VEC4 = 5
    DVEC2 = 6
    DVEC4 = 7
    UVEC2 = 8
    UVEC4 = 9
    IVEC2 = 10
    IVEC4 = 11


@dataclass(frozen=True)
class DTypeInfo:
    """Resolved layout of a DataType: base torch dtype + component count."""

    data_type: DataType
    dtype: torch.dtype
    components: int  # 1 for scalars; trailing axis size for vec2/vec4
    name: str

    @property
    def is_vector(self) -> bool:
        return self.components > 1

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize * self.components

    def element_shape(self) -> tuple:
        """Trailing shape of one element: () for scalars, (2,)/(4,) for vectors."""
        return () if self.components == 1 else (self.components,)


_REGISTRY = {
    DataType.FLOAT: ("float", torch.float32, 1),
    DataType.DOUBLE: ("double", torch.float64, 1),
    DataType.INT: ("int", torch.int32, 1),
    DataType.UINT: ("uint", torch.uint32, 1),
    DataType.VEC2: ("vec2", torch.float32, 2),
    DataType.VEC4: ("vec4", torch.float32, 4),
    DataType.DVEC2: ("dvec2", torch.float64, 2),
    DataType.DVEC4: ("dvec4", torch.float64, 4),
    DataType.UVEC2: ("uvec2", torch.uint32, 2),
    DataType.UVEC4: ("uvec4", torch.uint32, 4),
    DataType.IVEC2: ("ivec2", torch.int32, 2),
    DataType.IVEC4: ("ivec4", torch.int32, 4),
}


def dtype_info(data_type: DataType) -> DTypeInfo:
    """Resolve a DataType to its layout info."""
    check_argument(data_type in _REGISTRY, "Invalid data type: %s", data_type)
    name, dt, comps = _REGISTRY[data_type]
    return DTypeInfo(data_type=data_type, dtype=dt, components=comps, name=name)


def to_torch_dtype(data_type: DataType) -> torch.dtype:
    """Base torch dtype for a DataType."""
    return dtype_info(data_type).dtype


def to_type_str(data_type: DataType) -> str:
    """Human name for a DataType (analog of to_glsl_type_str, data_types.hpp:24-44)."""
    return dtype_info(data_type).name


def check_dtype_supported(data_type: DataType) -> DTypeInfo:
    """Resolve a DataType (counterpart of glu_tpu/utils/dtypes.py:107-116).
    The JAX package rejects the f64 types where x64 is off; the GPU has f64
    ALUs, so every DataType is supported here."""
    return dtype_info(data_type)
''',
    'glu_tpu_torch.utils.errors': r'''"""Fail-fast error checks.

Counterpart of glu_tpu/utils/errors.py (reference glu/errors.hpp:8-18:
GLU_CHECK_STATE, GLU_CHECK_ARGUMENT, GLU_FAIL): the library raises typed
exceptions instead of exiting the process.
"""

from __future__ import annotations


class GluError(RuntimeError):
    """Base error for glu_tpu_torch precondition violations."""


class GluStateError(GluError):
    """An internal state invariant was violated (analog of GLU_CHECK_STATE)."""


class GluArgumentError(GluError, ValueError):
    """A user-supplied argument was invalid (analog of GLU_CHECK_ARGUMENT)."""


def fail(fmt: str, *args) -> None:
    """Unconditional failure (analog of GLU_FAIL, reference glu/errors.hpp:17)."""
    raise GluError(fmt % args if args else fmt)


def check_state(cond: bool, fmt: str = "state check failed", *args) -> None:
    """Analog of GLU_CHECK_STATE (reference glu/errors.hpp:8-11)."""
    if not cond:
        raise GluStateError(fmt % args if args else fmt)


def check_argument(cond: bool, fmt: str = "invalid argument", *args) -> None:
    """Analog of GLU_CHECK_ARGUMENT (reference glu/errors.hpp:12-15)."""
    if not cond:
        raise GluArgumentError(fmt % args if args else fmt)
''',
    'glu_tpu_torch.utils.log': r'''"""Verbose logging gate (counterpart of glu_tpu/utils/log.py).

GLU_TPU_VERBOSE=1 sends diagnostics to stderr: which cost model the router
loaded, once a process. A sort's path is named by its engine span
(utils/timing.py).
"""

from __future__ import annotations

import os
import sys


def verbose_enabled() -> bool:
    return os.environ.get("GLU_TPU_VERBOSE", "0") == "1"


def vlog(fmt: str, *args) -> None:
    """Print a diagnostic line to stderr when GLU_TPU_VERBOSE=1."""
    if verbose_enabled():
        print("glu_tpu_torch: " + (fmt % args if args else fmt), file=sys.stderr)
''',
    'glu_tpu_torch.utils.math': r'''"""Integer math helpers.

Counterpart of glu_tpu/utils/math.py, itself the analog of reference
glu/gl_utils.hpp:267-302 (div_ceil,
is_power_of_2, next_power_of_2, log32_floor/ceil). Python ints are unbounded
so the bit-smearing implementation of next_power_of_2 is replaced with
bit_length arithmetic; semantics match the reference for all uint64 inputs.
"""

from __future__ import annotations


def div_ceil(num: int, den: int) -> int:
    """Ceiling division (reference gl_utils.hpp:286-289)."""
    return -(-num // den)


def is_power_of_2(n: int) -> bool:
    """True for 1, 2, 4, ... (reference gl_utils.hpp:291-294)."""
    return n > 0 and (n & (n - 1)) == 0


def next_power_of_2(n: int) -> int:
    """Smallest power of two >= n (reference gl_utils.hpp:296-302)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def log2_floor(n: int) -> int:
    """floor(log2(n)) for n >= 1."""
    if n < 1:
        raise ValueError("log2_floor requires n >= 1")
    return n.bit_length() - 1


def log2_ceil(n: int) -> int:
    """ceil(log2(n)) for n >= 1."""
    if n < 1:
        raise ValueError("log2_ceil requires n >= 1")
    return (n - 1).bit_length()


def log32_floor(n: int) -> int:
    """floor(log32(n)) — depth of a radix-32 reduction tree (reference gl_utils.hpp:267-277)."""
    return log2_floor(n) // 5


def log32_ceil(n: int) -> int:
    """ceil(log32(n)) (reference gl_utils.hpp:279-284)."""
    return div_ceil(log2_ceil(n), 5)
''',
    'glu_tpu_torch.utils.timing': r'''"""Timing and tracing (counterpart of glu_tpu/utils/timing.py).

The reference times a callback with a GL_TIME_ELAPSED query
(gl_utils.hpp:249-265). On the GPU the counterpart is a pair of CUDA events
on the current stream around the callback; on the CPU it is the host clock.
`trace()` wraps torch.profiler, the counterpart of jax.profiler.

The port's own tracing is one store a process, kept here:
  - `span(name)`: a context manager around a stage of a call, and
    `start(name)` / `stop()`, the same span at the cost of a call and a
    test when tracing is off. Each record holds the name, start and end
    (time.perf_counter_ns), its parent span and a call id: a public
    function opens a call id (`start_call`), and every span under it
    shares that id; nesting is tracked per thread.
  - `count(name, n=1)`: a counter, always on (an integer add);
    `declare(name)` lists a counter in summary() before it first counts.
  - `enable()` / `disable()`: spans on for an operator's own runs.
  - `summary()`: for each span name its count, total and self microseconds
    (duration less what its child spans cover), every counter, and each
    kernel module's launch counts as `launches.<kernel>`.
  - `records()`, `reset()`.

Spans record while enable() holds or while a torch.profiler records. The
profiler is checked once a public call, at its top-level span; the spans
inside read a module flag, so that with tracing off a span costs a call
and a test. While a profiler records, each span also enters the
profiler's own record function, so that it stands in the Chrome trace as
a `cpu_op` event of the same name, on the trace's clock. The store keeps
MAX_RECORDS raw records; past them summary() goes on counting.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import Callable

import torch


def _tensors(result):
    """Every tensor in result, through nested tuples, lists and dicts."""
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, (tuple, list, dict)):
        for item in result.values() if isinstance(result, dict) else result:
            yield from _tensors(item)


def measure_elapsed_time(callback: Callable[[], object], device=None) -> tuple[int, object]:
    """Run `callback`, returning (elapsed nanoseconds, result).

    On a CUDA `device` the time is the device time between two CUDA events
    recorded around the callback on the current stream, read after a
    synchronize. Otherwise it is host wall-clock time up to the end of the
    callback's device work: the device of every CUDA tensor in the result
    (through nested tuples, lists and dicts) is synchronized before the
    clock stops, as the JAX function blocks on its result.
    """
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = callback()
            end.record()
            end.synchronize()
            return int(start.elapsed_time(end) * 1e6), result
    start_ns = time.perf_counter_ns()
    result = callback()
    for dev in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return time.perf_counter_ns() - start_ns, result


def ns_to_human_string(ns: float) -> str:
    """Autoscaling time formatter (reference test/util/StopWatch.hpp:11-32)."""
    if ns >= 1e9:
        return f"{ns / 1e9:.3f} s"
    if ns >= 1e6:
        return f"{ns / 1e6:.3f} ms"
    if ns >= 1e3:
        return f"{ns / 1e3:.3f} us"
    return f"{ns:.0f} ns"


class StopWatch:
    """Wall-clock stopwatch (reference test/util/StopWatch.hpp:34-59)."""

    def __init__(self):
        self._start = time.perf_counter_ns()

    def restart(self) -> None:
        self._start = time.perf_counter_ns()

    def elapsed_ns(self) -> int:
        return time.perf_counter_ns() - self._start

    def elapsed_human(self) -> str:
        return ns_to_human_string(self.elapsed_ns())


# ---------------------------------------------------------------------------
# the port's tracing: spans and counters
# ---------------------------------------------------------------------------

MAX_RECORDS = 1_000_000  # raw span records kept; past them summary() still counts every span

# the modules whose launch counts summary() reports, under the package's root
# (glu_tpu_torch, or the single file's module name)
_ROOT = __name__.rsplit(".", 2)[0]
_LAUNCH_MODULES = ("ops._cuda_sort", "ops._cuda_scan", "ops._cuda_reduce", "parallel._cuda_bucket")

_profiler_enabled = torch._C._autograd._profiler_enabled
_trace_event = torch._C._profiler._RecordFunctionFast

Record = collections.namedtuple("Record", "name start_ns end_ns parent call")

_enabled = False  # enable() holds
_on = False  # spans record: enable() holds, or a public call runs under a profiler
_profiling = False  # the running top-level public call is profiled: spans enter its trace too
_local = threading.local()  # .stack: the open spans of this thread, innermost last
_records: list = []  # [name, start, end, parent record or -1, call id], in the order they opened
_stats: dict = {}  # name -> [count, total ns, self ns]
_counters: dict = {}
_declared: set = set()  # counters that summary() lists from 0
_dropped = 0  # spans closed past MAX_RECORDS
_calls = 0  # call ids given out
_anchor = (time.perf_counter_ns(), time.time_ns())  # one reading of both clocks, for records()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One span: see span(), start() and start_call()."""

    __slots__ = ("name", "public", "top", "parent", "call", "index", "inner_ns", "event", "start")

    def __init__(self, name: str, public: bool = False):
        self.name, self.public = name, public

    def open(self):
        global _on, _profiling, _calls
        stack = _stack()
        self.top = False
        if stack:
            self.parent, self.call = stack[-1].index, stack[-1].call
        else:
            _calls += 1
            self.parent, self.call = -1, _calls
            if self.public:  # a public call at the top: the profiler is checked here, once a call
                self.top = True
                _profiling = _profiler_enabled()
                _on = True
        self.event = _trace_event(self.name) if _profiling else None
        if self.event is not None:
            self.event.__enter__()
        self.index = len(_records) if len(_records) < MAX_RECORDS else -1
        if self.index >= 0:
            _records.append([self.name, 0, 0, self.parent, self.call])
        self.inner_ns = 0
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def close(self) -> None:
        global _on, _profiling, _dropped
        end = time.perf_counter_ns()
        took = end - self.start
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].inner_ns += took
        if self.event is not None:
            self.event.__exit__(None, None, None)
        stat = _stats.get(self.name)
        if stat is None:
            stat = _stats[self.name] = [0, 0, 0]
        stat[0] += 1
        stat[1] += took
        stat[2] += took - self.inner_ns
        if self.index >= 0:
            record = _records[self.index]
            record[1], record[2] = self.start, end
        else:
            _dropped += 1
        if self.top:
            _profiling = False
            _on = _enabled

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()


class _Off:
    """The span of tracing off: a null context."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


def span(name: str):
    """A context manager that records a span `name` while tracing is on
    (enable(), or a public call under a profiler), else does nothing: for a
    stage that costs far more than a `with` statement (a host sync, a
    collective). On a call's own path use start() and stop()."""
    return _Span(name) if _on else _OFF


def start(name: str):
    """Opens a span `name` while tracing is on and returns it, else None;
    stop() closes it, in a `finally`. Off, it costs a call and a test,
    where a `with` statement costs several times more (PERF.md §6)."""
    return _Span(name).open() if _on else None


def start_call(name: str):
    """start() for a public function: a call at the top, with tracing off,
    checks whether a profiler records, and turns the spans on for the call
    if one does."""
    return _Span(name, public=True).open() if _on or _profiler_enabled() else None


def stop(opened) -> None:
    """Closes what start() or start_call() returned."""
    if opened is not None:
        opened.close()


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name`, whether tracing is on or off."""
    _counters[name] = _counters.get(name, 0) + n


def declare(name: str) -> None:
    """Makes summary() list the counter `name`, at 0 until it counts, so that
    a reader can tell a path that never ran from a counter that is not
    there."""
    _declared.add(name)


def enable() -> None:
    """Spans record from now on, with or without a profiler."""
    global _enabled, _on
    _enabled = _on = True


def disable() -> None:
    """Spans record only inside public calls under a profiler again."""
    global _enabled, _on
    _enabled = _on = False


def _launch_modules():
    """The kernel modules of this package that are loaded (a module not
    loaded has launched nothing)."""
    return [m for m in (sys.modules.get(f"{_ROOT}.{name}") for name in _LAUNCH_MODULES) if m is not None]


def summary() -> dict:
    """{"spans": {name: {"count", "total_us", "self_us"}}, "counters": {name:
    value}, "dropped": records not kept}: the counters include the declared
    ones and each loaded kernel module's launch counts, as launches.<kernel>."""
    counters = dict.fromkeys(_declared, 0)
    counters.update(_counters)
    for module in _launch_modules():
        counters.update((f"launches.{kernel}", n) for kernel, n in module.launch_counts().items())
    spans = {name: {"count": c, "total_us": t / 1e3, "self_us": own / 1e3} for name, (c, t, own) in _stats.items()}
    return {"spans": dict(sorted(spans.items())), "counters": dict(sorted(counters.items())), "dropped": _dropped}


def records() -> list:
    """The kept spans as Records, in the order they opened: name, start and
    end in nanoseconds on the Unix clock (time.time_ns's; a profiler's
    Chrome trace puts an event at baseTimeNanoseconds + 1000 * ts), the
    index of the parent record (-1: none kept) and the call id. A span still
    open has end_ns None."""
    shift = _anchor[1] - _anchor[0]
    return [Record(name, start + shift, end + shift if end else None, parent, call)
            for name, start, end, parent, call in _records]


def reset() -> None:
    """Empties the store (records, span totals, counters) and the loaded
    kernel modules' launch counts, and reads the two clocks again."""
    global _dropped, _anchor
    _records.clear()
    _stats.clear()
    _counters.clear()
    _dropped = 0
    for module in _launch_modules():
        module.reset_launch_counts()
    _anchor = (time.perf_counter_ns(), time.time_ns())


def _since(before: dict, after: dict) -> dict:
    """What summary() gained from `before` to `after`."""
    spans = {}
    for name, s in after["spans"].items():
        b = before["spans"].get(name)
        gained = s if b is None else {k: s[k] - b[k] for k in s}
        if gained["count"]:
            spans[name] = gained
    counters = {k: v - before["counters"].get(k, 0) for k, v in after["counters"].items()}
    return {"spans": spans, "counters": {k: v for k, v in counters.items() if v},
            "dropped": after["dropped"] - before["dropped"]}


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler context over the CPU and, where there is one, the GPU,
    with the program's spans on (every public call under it records them,
    and they stand in the trace beside the caller's events). Yields the
    profiler; on exit writes a Chrome trace to `log_dir`/trace.json and
    what summary() gained inside to `log_dir`/summary.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    before = summary()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    gained = _since(before, summary())
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "summary.json"), "w") as f:
        json.dump(gained, f, indent=1)
''',
}

_CUDA_SOURCES = {
    'bucket.cu': r'''// KB, the bucket stage of the distributed sort: a hand-written Hopper
// (sm_90a) pass that gives each element of a rank's shard its destination
// rank (glu_tpu_torch/parallel/_cuda_bucket.py).
//
// Replaces glu_tpu/parallel/dist_sort.py::_bucket_of and _bucket_of64, which
// are not pallas_calls: they unroll the D - 1 splitter comparisons so that
// XLA fuses them into one elementwise pass over the shard. out[i] is the
// count of splitters j with (s_hi[j], s_lo[j], s_idx[j]) <= (hi[i], lo[i],
// base + i) in lexicographic order, the words compared unsigned and the
// global index as a 64-bit integer (the u32 form has no lo word). The
// splitters are quantiles of one sorted sample, so they come in
// non-decreasing lexicographic order, and the count is the length of the
// prefix of splitters <= the element: a binary search of ceil(log2 D) fixed
// steps (binary lifting), the same in every lane of a warp.
//
// Bound by device-memory bytes: each key word read once and each bucket id
// written once, 8 bytes an element for u32 keys (0.160 ms for 2^26 at 3.35
// TB/s) and 12 for 64-bit keys. So the kernel streams: a grid of 8 CTAs of
// 256 threads an SM strides over the shard, each thread with kUnroll
// 16-byte loads of 4 keys in flight, and writes 4 ids with one 16-byte store
// where the output shares the keys' alignment. A shard may be a slice of a
// larger tensor, aligned to 4 bytes only: the elements before the keys' first
// 16-byte boundary and the ragged tail are taken one by one. Up to
// kSmemSplitters splitters are staged in shared memory once a CTA; more are
// searched where they lie, through L1. No atomics, no scratch.
//
// Plain C interface for ctypes; every entry returns a cudaError_t.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBucketThreads = 256;
constexpr int kCtasPerSm = 2048 / kBucketThreads;
constexpr int kSmemSplitters = 2048;  // at most 32 KB of splitters (64-bit form): no opt-in needed
constexpr int kUnroll = 2;

// D - 1 splitters in non-decreasing lexicographic order; lo is unused in the
// u32 form (WORDS == 1).
struct Splitters {
  const uint32_t* hi;
  const uint32_t* lo;
  const long long* idx;
  int m;
};

// splitter j <= (hi, lo, gidx)
template <int WORDS>
__device__ __forceinline__ bool splitter_le(const Splitters& s, int j, uint32_t hi, uint32_t lo, long long gidx) {
  const uint32_t sh = s.hi[j];
  if (sh != hi) return sh < hi;
  if constexpr (WORDS == 2) {
    const uint32_t sl = s.lo[j];
    if (sl != lo) return sl < lo;
  }
  return s.idx[j] <= gidx;
}

// The number of splitters <= (hi, lo, gidx): the longest prefix of the
// sorted splitters that is <= it, found in steps of top, top / 2, ..., 1
// (top: the largest power of two <= m).
template <int WORDS>
__device__ __forceinline__ int count_le(const Splitters& s, int top, uint32_t hi, uint32_t lo, long long gidx) {
  int pos = 0;
  for (int step = top; step > 0; step >>= 1) {
    const int next = pos + step;
    if (next <= s.m && splitter_le<WORDS>(s, next - 1, hi, lo, gidx)) pos = next;
  }
  return pos;
}

// Elements [head, head + 4 * groups) as groups of 4 (their keys on 16-byte
// boundaries), the rest one by one. vec_out: out + head is on a 16-byte
// boundary too.
template <int WORDS>
__global__ void __launch_bounds__(kBucketThreads)
    bucket_kernel(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo, long long n, long long base,
                  Splitters s, long long head, long long groups, bool vec_out, int* __restrict__ out) {
  extern __shared__ long long staged[];  // idx[m], hi[m], lo[m] when m <= kSmemSplitters
  if (s.m <= kSmemSplitters) {
    long long* idx = staged;
    uint32_t* shi = reinterpret_cast<uint32_t*>(idx + s.m);
    uint32_t* slo = shi + s.m;
    for (int j = threadIdx.x; j < s.m; j += kBucketThreads) {
      idx[j] = s.idx[j];
      shi[j] = s.hi[j];
      if constexpr (WORDS == 2) slo[j] = s.lo[j];
    }
    __syncthreads();
    s.idx = idx;
    s.hi = shi;
    s.lo = slo;
  }
  const int top = s.m > 0 ? 1 << (31 - __clz(s.m)) : 0;
  const long long stride = static_cast<long long>(gridDim.x) * kBucketThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kBucketThreads + threadIdx.x;

  const uint4* vhi = reinterpret_cast<const uint4*>(hi + head);
  const uint4* vlo = reinterpret_cast<const uint4*>(lo + head);
  for (long long g0 = t; g0 < groups; g0 += kUnroll * stride) {
    uint4 kh[kUnroll], kl[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load issued before any search
      const long long g = g0 + u * stride;
      if (g < groups) {
        kh[u] = __ldcs(vhi + g);
        if constexpr (WORDS == 2) kl[u] = __ldcs(vlo + g);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = g0 + u * stride;
      if (g >= groups) break;
      const long long i = head + 4 * g;
      const long long gi = base + i;
      uint4 l = make_uint4(0, 0, 0, 0);
      if constexpr (WORDS == 2) l = kl[u];
      int4 r;
      r.x = count_le<WORDS>(s, top, kh[u].x, l.x, gi);
      r.y = count_le<WORDS>(s, top, kh[u].y, l.y, gi + 1);
      r.z = count_le<WORDS>(s, top, kh[u].z, l.z, gi + 2);
      r.w = count_le<WORDS>(s, top, kh[u].w, l.w, gi + 3);
      if (vec_out) {
        __stcs(reinterpret_cast<int4*>(out + i), r);
      } else {
        out[i] = r.x;
        out[i + 1] = r.y;
        out[i + 2] = r.z;
        out[i + 3] = r.w;
      }
    }
  }
  const long long tail = head + 4 * groups;  // the scalar head [0, head) and tail [tail, n)
  for (long long k = t; k < head + (n - tail); k += stride) {
    const long long i = k < head ? k : tail + (k - head);
    out[i] = count_le<WORDS>(s, top, hi[i], WORDS == 2 ? lo[i] : 0u, base + i);
  }
}

template <int WORDS>
cudaError_t launch_bucket(const uint32_t* hi, const uint32_t* lo, long long n, long long base, Splitters s,
                          int* out, cudaStream_t stream) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(hi);
  long long head = static_cast<long long>((16 - at % 16) % 16 / 4);
  if (WORDS == 2 && (reinterpret_cast<uintptr_t>(lo) - at) % 16 != 0) head = n;  // no common 16-byte boundary
  head = std::min(head, n);
  const long long groups = (n - head) / 4;
  const bool vec_out = reinterpret_cast<uintptr_t>(out + head) % 16 == 0;
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long work = std::max((groups + kUnroll - 1) / kUnroll, n - 4 * groups);  // a thread's items
  const int ctas = static_cast<int>(std::max(
      1LL, std::min(static_cast<long long>(sms) * kCtasPerSm, (work + kBucketThreads - 1) / kBucketThreads)));
  const size_t smem = s.m <= kSmemSplitters ? static_cast<size_t>(s.m) * (8 + 4 * WORDS) : 0;
  bucket_kernel<WORDS><<<ctas, kBucketThreads, smem, stream>>>(hi, lo, n, base, s, head, groups, vec_out, out);
  return cudaGetLastError();
}

bool valid(const void* keys, long long n, long long base, const void* s_idx, int m, const void* out) {
  return n >= 1 && base >= 0 && base <= 0x7fffffffffffffffLL - n && m >= 0 && keys != nullptr && out != nullptr &&
         (m == 0 || s_idx != nullptr) && reinterpret_cast<uintptr_t>(keys) % 4 == 0;
}

}  // namespace

extern "C" {

int glu_bucket_smem_splitters() { return kSmemSplitters; }

// out[i] = the number of the m splitters (s_keys[j], s_idx[j]) <= (keys[i],
// base + i), for the n u32 keys; the splitters in non-decreasing
// lexicographic order. out: n int32.
int glu_bucket_of(const void* keys, long long n, long long base, const void* s_keys, const void* s_idx, int m,
                  void* out, void* stream) {
  if (!valid(keys, n, base, s_idx, m, out) || (m > 0 && s_keys == nullptr)) return cudaErrorInvalidValue;
  const Splitters s{static_cast<const uint32_t*>(s_keys), nullptr, static_cast<const long long*>(s_idx), m};
  return launch_bucket<1>(static_cast<const uint32_t*>(keys), nullptr, n, base, s, static_cast<int*>(out),
                          static_cast<cudaStream_t>(stream));
}

// The same for 64-bit keys given as (hi, lo) u32 words and splitters
// (s_hi[j], s_lo[j], s_idx[j]).
int glu_bucket_of64(const void* hi, const void* lo, long long n, long long base, const void* s_hi, const void* s_lo,
                    const void* s_idx, int m, void* out, void* stream) {
  if (!valid(hi, n, base, s_idx, m, out) || lo == nullptr || reinterpret_cast<uintptr_t>(lo) % 4 != 0 ||
      (m > 0 && (s_hi == nullptr || s_lo == nullptr)))
    return cudaErrorInvalidValue;
  const Splitters s{static_cast<const uint32_t*>(s_hi), static_cast<const uint32_t*>(s_lo),
                    static_cast<const long long*>(s_idx), m};
  return launch_bucket<2>(static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo), n, base, s,
                          static_cast<int*>(out), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
''',
    'fold.cuh': r'''// Operators, identities and block-wide folds and scans shared by the reduce
// (K5, reduce.cu) and exclusive-scan (K4, scan.cu) kernels.
//
// Every kernel is a template on (OP, T): OP one of glu_tpu_torch's
// ReduceOperator values, T one of int32_t, uint32_t, float, double (the
// base types of the 12 DataTypes). uint32_t wraps and compares as unsigned
// natively, so the TPU's u32 -> i32 isomorphisms are not needed; int32_t
// sums and products are taken in uint32_t, where wrapping is defined.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace glu {

enum Op { kSum = 0, kMul = 1, kMin = 2, kMax = 3 };
enum DType { kInt32 = 0, kUint32 = 1, kFloat32 = 2, kFloat64 = 3 };

constexpr int kFoldThreads = 256;
constexpr int kFoldItems = 16;
constexpr int kFoldTile = kFoldThreads * kFoldItems;  // 4096 elements per tile
constexpr int kFoldWarps = kFoldThreads / 32;

// VEC values of T loaded or stored as one access (16 bytes for VEC = 16 / sizeof(T)).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  return v != v;  // false for every integer
}

template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  return a + b;
}
template <>
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
template <typename T>
__device__ __forceinline__ T mul(T a, T b) {
  return a * b;
}
template <>
__device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// a op b. min and max propagate NaN, as jnp.minimum / jnp.maximum and
// torch.minimum / torch.maximum do (fminf / fmaxf would drop it).
template <int OP, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (OP == kSum) {
    return add(a, b);
  } else if constexpr (OP == kMul) {
    return mul(a, b);
  } else {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    if constexpr (OP == kMin) {
      return b < a ? b : a;
    } else {
      return a < b ? b : a;
    }
  }
}

template <typename T>
__device__ __forceinline__ T highest();
template <>
__device__ __forceinline__ int32_t highest() { return INT32_MAX; }
template <>
__device__ __forceinline__ uint32_t highest() { return UINT32_MAX; }
template <>
__device__ __forceinline__ float highest() { return __int_as_float(0x7f800000); }  // +inf
template <>
__device__ __forceinline__ double highest() { return __longlong_as_double(0x7ff0000000000000LL); }

template <typename T>
__device__ __forceinline__ T lowest();
template <>
__device__ __forceinline__ int32_t lowest() { return INT32_MIN; }
template <>
__device__ __forceinline__ uint32_t lowest() { return 0u; }
template <>
__device__ __forceinline__ float lowest() { return __int_as_float(0xff800000); }  // -inf
template <>
__device__ __forceinline__ double lowest() { return __longlong_as_double(0xfff0000000000000LL); }

template <int OP, typename T>
__device__ __forceinline__ T identity() {
  if constexpr (OP == kSum) return T(0);
  else if constexpr (OP == kMul) return T(1);
  else if constexpr (OP == kMin) return highest<T>();
  else return lowest<T>();
}

// How a thread's VEC lanes meet the C components of an (N, C) stream read
// as flat elements: lane e of thread t holds flat element (t * VEC + e) plus a
// multiple of kFoldThreads * VEC, which is a multiple of C, so its component
// (t * VEC + e) % C is the same in every load. The lanes fold into kSlots =
// min(C, VEC) accumulators, lane e into slot e % kSlots; slot s of thread t
// holds component (t * VEC + s) % C, and threads t and t + kStride hold the
// same components.
template <int C, int VEC>
struct Lanes {
  static_assert(C == 1 || C == 2 || C == 4, "components: 1, 2 or 4");
  static constexpr int kSlots = C < VEC ? C : VEC;
  static constexpr int kStride = C / kSlots;
  static __device__ __forceinline__ int component(int t, int s) { return (t * VEC + s) % C; }
};

// Fold of each component over the block, in a fixed order: a warp's shuffle
// tree with offsets 16 .. kStride (which keep components apart), then warp 0
// folds the warps' values of each component, lower warps on the left.
// total[c] is valid in thread 0. warp_vals holds C * kFoldWarps values; the
// caller syncs before warp_vals is written again.
template <int OP, int C, int VEC, typename T>
__device__ __forceinline__ void block_fold(T (&acc)[Lanes<C, VEC>::kSlots], T* warp_vals, T (&total)[C]) {
  using L = Lanes<C, VEC>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < L::kSlots; ++s) {
#pragma unroll
    for (int o = 16; o >= L::kStride; o >>= 1) {
      const T other = __shfl_down_sync(0xffffffffu, acc[s], o);
      if (lane + o < 32) acc[s] = combine<OP>(acc[s], other);
    }
  }
  if (lane < L::kStride) {
#pragma unroll
    for (int s = 0; s < L::kSlots; ++s) warp_vals[L::component(lane, s) * kFoldWarps + warp] = acc[s];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T v = lane < kFoldWarps ? warp_vals[c * kFoldWarps + lane] : identity<OP, T>();
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const T other = __shfl_down_sync(0xffffffffu, v, o);
        if (lane + o < 32) v = combine<OP>(v, other);
      }
      total[c] = v;
    }
  }
}

// Exclusive scan of one value per thread over a block of WARPS warps, in
// thread order: thread t gets op(v_0 .. v_{t-1}), thread 0 the identity;
// *total gets the fold of all. warp_vals holds WARPS + 1 values. Ends with a
// barrier, so the caller may reuse warp_vals at once.
template <int OP, int WARPS, typename T>
__device__ T block_exclusive_scan(T v, T* warp_vals, T* total) {
  static_assert(WARPS >= 1 && WARPS <= 32, "one warp scans the warp totals");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T left = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc = combine<OP>(left, inc);
  }
  T exc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) exc = identity<OP, T>();
  if (lane == 31) warp_vals[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < WARPS ? warp_vals[lane] : identity<OP, T>();
    T s = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T left = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = combine<OP>(left, s);
    }
    T before = __shfl_up_sync(0xffffffffu, s, 1);
    if (lane == 0) before = identity<OP, T>();
    if (lane < WARPS) warp_vals[lane] = before;
    if (lane == WARPS - 1) warp_vals[WARPS] = s;
  }
  __syncthreads();
  *total = warp_vals[WARPS];
  const T result = combine<OP>(warp_vals[warp], exc);
  __syncthreads();
  return result;
}

// Calls f(std::integral_constant<int, OP>, T()) for the runtime (dtype, op).
template <typename T, typename F>
cudaError_t with_op(int op, F&& f) {
  switch (op) {
    case kSum: return f(std::integral_constant<int, kSum>(), T());
    case kMul: return f(std::integral_constant<int, kMul>(), T());
    case kMin: return f(std::integral_constant<int, kMin>(), T());
    case kMax: return f(std::integral_constant<int, kMax>(), T());
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_dtype_op(int dtype, int op, F&& f) {
  switch (dtype) {
    case kInt32: return with_op<int32_t>(op, f);
    case kUint32: return with_op<uint32_t>(op, f);
    case kFloat32: return with_op<float>(op, f);
    case kFloat64: return with_op<double>(op, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace glu
''',
    'lookback.cuh': r'''// Device-side building blocks of single-pass kernels on Hopper (sm_90a):
// the status words of a decoupled look-back, and cp.async copies from device
// memory into shared memory.
//
// A status word is 64 bits: a flag in the high half and a count in the low
// half, so that one atomic store publishes both and a count can reach 2^32 - 1
// (the sort takes n < 2^31). The word is 0 until its tile publishes.
//
// Stores and loads of status words are relaxed atomics at device scope: a
// reader uses nothing but the one word it loaded, which holds the flag and
// the count together, so no other memory has to be ordered with it. Release
// stores and acquire loads would be correct too, and slower (PERF.md). A
// flag that stands for a value kept elsewhere (the scan's 8-byte values,
// scan.cu) is stored with release and loaded with acquire semantics instead.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace glu {

constexpr unsigned long long kStatusAggregate = 1ull << 32;  // the tile's own count
constexpr unsigned long long kStatusInclusive = 2ull << 32;  // the count of this and every earlier tile
// A look-back that waits this many times on one status word reports a fault
// (a trap) instead of holding the card forever.
constexpr long long kLookbackSpinLimit = 1ll << 26;

__device__ __forceinline__ unsigned long long status_word(unsigned long long flag, uint32_t count) {
  return flag | count;
}

__device__ __forceinline__ void publish_status(unsigned long long* word, unsigned long long value) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(value) : "memory");
}

__device__ __forceinline__ unsigned long long read_status(const unsigned long long* word) {
  unsigned long long value;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(value) : "l"(word) : "memory");
  return value;
}

// A flag whose value was written before it: every store this thread made
// before the release is visible to a thread whose acquire load sees the flag.
__device__ __forceinline__ void publish_flag(unsigned long long* word, unsigned long long flag) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(flag) : "memory");
}

__device__ __forceinline__ unsigned long long read_flag(const unsigned long long* word) {
  unsigned long long flag;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(flag) : "l"(word) : "memory");
  return flag;
}

// Sum of the counts that tiles 0..tile-1 published in the column of status
// words that starts at `column` (stride `stride` words per tile): walks back
// from tile-1, adding aggregates, until it meets an inclusive count.
__device__ __forceinline__ uint32_t look_back(const unsigned long long* column, int stride, int tile) {
  uint32_t sum = 0;
  for (int p = tile - 1; p >= 0; --p) {
    const unsigned long long* word = column + static_cast<long long>(p) * stride;
    unsigned long long value = read_status(word);
    for (long long spins = 0; value == 0; value = read_status(word)) {
      if (++spins == kLookbackSpinLimit) __trap();
    }
    sum += static_cast<uint32_t>(value);
    if ((value & ~0xffffffffull) == kStatusInclusive) break;
  }
  return sum;
}

// cp.async: 16 bytes (both addresses 16-byte aligned) or 4 bytes from device
// memory into shared memory, in flight until cp_async_wait.
__device__ __forceinline__ void cp_async16(void* smem, const void* global) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(global) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* global) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(global) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Waits until at most PENDING of this thread's committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

}  // namespace glu
''',
    'radix_sort.cu': r'''// Hand-written Hopper (sm_90a) kernels of the stable LSD radix sort of u32
// keys carrying u32 payload streams (glu_tpu_torch/ops/_cuda_sort.py).
//
// A sort runs digit_histograms once, which counts the digit of every pass in
// one read of the keys (its last CTA turning the counts into each digit's
// start), then one onesweep_pass per digit of 1-8 key bits:
// each tile is ranked, finds its place through a decoupled look-back over
// the tiles before it, and writes every stream to its final place, so each
// word is read once and written once per pass (Adinets & Merrill,
// "Onesweep", 2022). An input of up to 65,536 elements takes
// sort_single_tile (K3), which runs every pass in one launch: one CTA, or a
// thread-block cluster whose CTAs share their shared memory.
//
// Bit positions (LSB-first) and stream pointers travel by value, so one
// compiled kernel serves every pass and every payload count. Words are
// uint32_t here; the Python side carries them as int32 bit patterns.
//
// Plain C interface for ctypes (no PyTorch headers, so nvcc takes seconds):
// every entry returns a cudaError_t, cudaGetLastError() after its launch.
// glu_onesweep_sort runs a whole multi-tile sort (the histogram and every
// pass) in one call, so that the host pays one call a sort, not one a pass.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using namespace glu;
namespace cg = cooperative_groups;

constexpr int kMaxStreams = 8;       // keys + up to 7 payload streams
constexpr int kMaxPassBits = 8;      // a onesweep pass takes 1-8 key bits
constexpr int kMaxBins = 1 << kMaxPassBits;
constexpr int kMaxPasses = 4;        // 32 key bits in passes of 8

// 6144 elements per onesweep tile, 2 CTAs an SM. The shared memory, which
// holds every stream's tile, has room for 3 with up to one payload stream
// (about 75,960 bytes a CTA, of the SM's 233,472), 2 with two, 1 with three
// to seven (glu_onesweep_ctas_per_sm). 3 would need at most 56 registers a
// thread (65,536 / (3 x 384), in steps of 8), which the kernel fits with no
// spill when it ranks 4 rows and stores 4 ranks at a time; but on the H100 a
// two-stream pass then runs 10-12% slower: with 1.5 times the tiles in
// flight, the scattered stores and the look-back each cost 2.5-3 times as
// much (PERF.md). A thread stores kStoreItems ranks at a time, so that
// nothing spills. Larger tiles write longer runs of one digit, so fewer and
// fuller sectors; the variants that tools/onesweep_variants.py times are in
// PERF.md.
constexpr int kTileThreads = 384;
constexpr int kTileItems = 16;
constexpr int kTileCtasPerSm = 2;                 // __launch_bounds__ occupancy target
constexpr int kStoreItems = 8;                    // ranks a thread moves at once in step (d)
constexpr int kTile = kTileThreads * kTileItems;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kWarpItems = kTile / kTileWarps;    // each warp ranks a contiguous run of 512
static_assert(kTileThreads >= kMaxBins, "one thread per digit in the look-back");
static_assert(kTileItems % kStoreItems == 0, "a thread's ranks in whole chunks");

constexpr int kHistThreads = 1024;

// K3: CTAs of 1024 threads, each holding a slice of at most kSliceMax
// elements, 16 items a thread. A CTA of a cluster holds its slice's keys
// and their u16 source index twice each (12 bytes an element) and every
// warp's 256 running counts: 229,376 bytes, where the 232,448 bytes a block
// may take end. A cluster has up to kMaxCluster CTAs (the portable cluster
// size), so K3 takes up to kSingleMax elements: the JAX engine's
// single-block limit, _FUSE_MAX_R x LANES.
constexpr int kSingleThreads = 1024;
constexpr int kSliceMax = 16384;
constexpr int kMaxCluster = 8;
constexpr int kSingleMax = 65536;  // K3's limit
constexpr int kSingleWarps = kSingleThreads / 32;
constexpr int kSingleItems = kSliceMax / kSingleThreads;
constexpr int kRankRows = 2;  // rows of 32 items ranked at once
static_assert(kSingleThreads >= kMaxBins, "one thread per digit in the scan");
static_assert(kSliceMax % (kSingleThreads * kRankRows) == 0, "a slice in whole chunks of rows");
static_assert(kSingleMax <= kMaxCluster * kSliceMax, "K3's limit fits a cluster");
static_assert(kSingleMax <= 65536, "u16 source index");

struct Streams {
  const uint32_t* in[kMaxStreams];
  uint32_t* out[kMaxStreams];
  int count;
};

// The digit of one pass: key bits bit[0..nbits) (LSB-first). When they are
// contiguous, shift is the lowest of them and one shift and mask take the
// digit; otherwise shift is -1.
struct Digit {
  int bit[kMaxPassBits];
  int nbits;
  int shift;

  __device__ __forceinline__ uint32_t of(uint32_t key) const {
    if (shift >= 0) return (key >> shift) & ((1u << nbits) - 1u);
    uint32_t d = 0;
#pragma unroll
    for (int j = 0; j < kMaxPassBits; ++j) {
      if (j < nbits) d |= ((key >> bit[j]) & 1u) << j;
    }
    return d;
  }
};

struct PassDigits {
  Digit pass[kMaxPasses];
  int count;
};

// Exclusive sum of one int per thread over the block; *total gets the sum of
// all. warp_sums holds THREADS/32 + 1 ints. Ends with a barrier, so the
// caller may reuse warp_sums at once.
template <int THREADS>
__device__ int block_exclusive_sum(int value, int* warp_sums, int* total) {
  constexpr int kWarps = THREADS / 32;
  static_assert(THREADS % 32 == 0 && kWarps <= 32, "block scan shape");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = value;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_sums[lane] : 0;
    int sum = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, sum, o);
      if (lane >= o) sum += y;
    }
    if (lane < kWarps) warp_sums[lane] = sum - w;
    if (lane == 31) warp_sums[kWarps] = sum;
  }
  __syncthreads();
  *total = warp_sums[kWarps];
  const int result = warp_sums[warp] + x - value;
  __syncthreads();
  return result;
}

// The counts half of K1 (glu_tpu/ops/_pallas_sort.py::_counts_row, one row
// per block there), for every pass of the sort at once.
//
// hist[p][d] (int32, zeroed by the caller) receives the number of keys whose
// digit of pass p is d. Bound by device-memory bytes: one read of the keys,
// 1.07 GB at 2^28. Two CTAs of 1024 threads per SM read 16 bytes a thread in
// a grid-stride loop; each CTA counts in shared memory with shared atomics
// and adds its counts to hist with one global atomic per non-zero bin.
// Integer adds are exact in any order, so the result is deterministic.
// Where bases is given, the last CTA to finish (counted in *ctas_done, zero
// at launch) writes bases[p][d], the exclusive sum of hist[p] up to d: where
// digit d starts in pass p's output (the cumsum that the TPU engine ran in
// XLA between its kernels).
__global__ void __launch_bounds__(kHistThreads)
    digit_histograms_kernel(const uint32_t* __restrict__ keys, int n, PassDigits plan,
                            int* hist, int* bases, unsigned int* ctas_done) {
  __shared__ int counts[kMaxPasses * kMaxBins];
  __shared__ int warp_sums[kHistThreads / 32 + 1];
  __shared__ bool last;
  const int t = threadIdx.x;
  for (int i = t; i < kMaxPasses * kMaxBins; i += kHistThreads) counts[i] = 0;
  __syncthreads();

  auto count = [&](uint32_t key) {
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (p < plan.count) atomicAdd(&counts[p * kMaxBins + plan.pass[p].of(key)], 1);
    }
  };
  const long long stride = static_cast<long long>(gridDim.x) * kHistThreads;
  const bool aligned = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  const long long nvec = aligned ? n / 4 : 0;  // 16-byte vectors, then single words
  const uint4* vec = reinterpret_cast<const uint4*>(keys);
  for (long long i = static_cast<long long>(blockIdx.x) * kHistThreads + t; i < nvec; i += stride) {
    const uint4 q = vec[i];
    count(q.x);
    count(q.y);
    count(q.z);
    count(q.w);
  }
  for (long long j = nvec * 4 + static_cast<long long>(blockIdx.x) * kHistThreads + t; j < n;
       j += stride)
    count(keys[j]);
  __syncthreads();
  for (int k = t; k < plan.count * kMaxBins; k += kHistThreads) {
    if (counts[k]) atomicAdd(&hist[k], counts[k]);
  }
  if (bases == nullptr) return;
  __threadfence();  // this CTA's adds, before its count of finished CTAs
  __syncthreads();
  if (t == 0) last = atomicAdd(ctas_done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int p = 0; p < plan.count; ++p) {
    const int c = t < kMaxBins ? __ldcg(hist + p * kMaxBins + t) : 0;  // from L2, where the adds landed
    int total;
    const int start = block_exclusive_sum<kHistThreads>(c, warp_sums, &total);
    if (t < kMaxBins) bases[p * kMaxBins + t] = start;
  }
}

// The lanes of the warp whose digit equals d (d < 2^nbits; 0 for the
// kMaxBins that marks a lane past the ragged end): one ballot per digit bit.
__device__ __forceinline__ unsigned match_digit(uint32_t d, int nbits) {
  unsigned peers = __ballot_sync(0xffffffffu, d < kMaxBins);
  for (int b = 0; b < nbits; ++b) {
    const unsigned bit = __ballot_sync(0xffffffffu, (d >> b) & 1u);
    peers &= (d >> b) & 1u ? bit : ~bit;
  }
  return d < kMaxBins ? peers : 0u;
}

// The stable ranker of both sort kernels: ROWS rows of 32 digits of one
// warp (d < 2^nbits, or kMaxBins for a lane past the ragged end), ranked row
// by row in order. runs[d] holds the warp's next rank of digit d. The rows
// are independent until the running ranks: every row's peer mask first, then
// the leaders' adds (the lowest lane of each group of peers advances runs[d]
// by their number), then the ranks. place(j, rank) is called for every lane
// of row j that has a digit; lanes of one row that share a digit rank in
// lane order, so the order is (row, lane): input order.
template <int ROWS, typename Place>
__device__ __forceinline__ void rank_rows(const uint32_t (&dig)[ROWS], int nbits, int* runs, Place place) {
  const int lane = threadIdx.x & 31;
  unsigned peers[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) peers[j] = match_digit(dig[j], nbits);
  int run[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    run[j] = 0;
    if (peers[j] && lane == __ffs(peers[j]) - 1) run[j] = atomicAdd(&runs[dig[j]], __popc(peers[j]));
    __syncwarp();  // orders the adds of successive rows, made by different leader lanes
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int leader = peers[j] ? __ffs(peers[j]) - 1 : lane;
    const int rank = __shfl_sync(0xffffffffu, run[j], leader) + __popc(peers[j] & ((1u << lane) - 1u));
    if (peers[j]) place(j, rank);
  }
}

// Starts the copy of one stream's tile (tile_n <= kTile words at `in`) into
// buf, in input order: 16 bytes a copy where `in` is 16-byte aligned, 4 at the
// ragged end or where it is not.
__device__ __forceinline__ void stage_tile_async(const uint32_t* in, uint32_t* buf, int tile_n) {
  const bool vec = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  for (int c = threadIdx.x; c < kTile / 4; c += kTileThreads) {
    const int i = 4 * c;
    if (vec && i + 4 <= tile_n) {
      cp_async16(buf + i, in + i);
    } else {
      for (int e = i; e < min(i + 4, tile_n); ++e) cp_async4(buf + e, in + e);
    }
  }
}

// K1 + K2 fused. Replaces glu_tpu/ops/_pallas_sort.py::_group_pass (the
// stable grouping of _split_round) and ::_splice_streams, with the run
// placement of _run_descriptors.
//
// One stable pass over the digit of 1-8 key bits for the keys and every
// payload stream. digit_base[d] is where digit d starts in the output (an
// exclusive sum of digit_histograms' counts). status holds one 64-bit word
// per (tile, bin) and, after them, the tile counter; all zero at launch.
// Each CTA:
//  (a) takes the next tile from the counter, so that every tile it waits on
//      in (c) belongs to a CTA that is already running;
//  (e) starts cp.async copies of every stream's tile into shared memory, in
//      input order; the payloads fly while (b) and (c) run;
//  (b) counts the tile's digits per warp (shared atomics), then publishes
//      the tile's count of each digit at once, so that later tiles can look
//      back past it while it ranks; a scan over (digit, warp) gives each
//      warp the first in-tile rank of each digit. Each warp then ranks its
//      contiguous run of items in order, 32 at a time: ballots over the
//      digit's bits find the lanes that share it (cheaper here than
//      __match_any_sync), and the lowest of them advances the warp's running
//      rank of that digit by their number. The order is (digit, warp, item,
//      lane), which is input order within a digit, so the pass is stable;
//  (c) walks back over earlier tiles (decoupled look-back, one thread per
//      digit) for the number of equal digits before this tile, then
//      publishes its inclusive count;
//  (d) writes, for every stream, the element of in-tile rank r with digit d
//      to digit_base[d] + (equal digits in earlier tiles) + r - (first
//      in-tile rank of d), gathering from shared memory in rank order, so
//      that a warp's stores fall on few contiguous runs; a thread finds the
//      source and place of kStoreItems ranks, then moves them in every
//      stream;
//  (f) masks the ragged last tile: only its tile_n elements are moved.
// Bound by device-memory bytes: each word read once and written once, plus
// the status words. What holds it back is the latency of one tile's chain of
// steps, so the steps that wait on device memory (the tile counter, the
// copies, the look-back) start as early as they can.
__global__ void __launch_bounds__(kTileThreads, kTileCtasPerSm)
    onesweep_pass_kernel(Streams s, int n, Digit digit, const int* __restrict__ digit_base,
                         unsigned long long* status) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* stage = smem;                                                   // [s.count][kTile]
  uint16_t* source = reinterpret_cast<uint16_t*>(stage + s.count * kTile);  // [kTile]: input position of rank r
  int* warp_runs = reinterpret_cast<int*>(source + kTile);                  // [kTileWarps][kMaxBins]
  __shared__ const uint32_t* s_in[kMaxStreams];
  __shared__ uint32_t* s_out[kMaxStreams];
  __shared__ int shift[kMaxBins];  // output position minus in-tile rank, per digit
  __shared__ int warp_sums[kTileThreads / 32 + 1];
  __shared__ int s_tile;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int bins = 1 << digit.nbits;
  const bool owns_digit = t < bins;  // thread t counts, publishes and looks back for digit t
  const int tiles = static_cast<int>((static_cast<long long>(n) + kTile - 1) / kTile);
  // (a)
  if (t == 0) {
    s_tile = static_cast<int>(atomicAdd(reinterpret_cast<unsigned int*>(status + static_cast<long long>(tiles) * kMaxBins), 1u));
#pragma unroll
    for (int j = 0; j < kMaxStreams; ++j) {
      s_in[j] = s.in[j];
      s_out[j] = s.out[j];
    }
  }
  const int base_d = owns_digit ? digit_base[t] : 0;
  for (int i = t; i < kTileWarps * kMaxBins; i += kTileThreads) warp_runs[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const long long base = static_cast<long long>(tile) * kTile;
  const int tile_n = static_cast<int>(min(static_cast<long long>(kTile), n - base));

  // (e) group 0: the keys; group 1: the payloads
  stage_tile_async(s_in[0] + base, stage, tile_n);
  cp_async_commit();
  for (int st = 1; st < s.count; ++st) stage_tile_async(s_in[st] + base, stage + st * kTile, tile_n);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // (b) items first + 32 j + lane of this warp, j = 0..kTileItems-1
  const int first = warp * kWarpItems;
  int* runs = warp_runs + warp * kMaxBins;
  uint32_t dig[kTileItems];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const int i = first + 32 * j + lane;
    dig[j] = i < tile_n ? digit.of(stage[i]) : kMaxBins;  // the ragged end: a digit of its own
    if (i < tile_n) atomicAdd(&runs[dig[j]], 1);
  }
  __syncthreads();
  int count = 0;  // this tile's items of digit t; each warp's count becomes its start among them
  if (owns_digit) {
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      const int c = warp_runs[w * kMaxBins + t];
      warp_runs[w * kMaxBins + t] = count;
      count += c;
    }
  }
  unsigned long long* word = status + static_cast<long long>(tile) * kMaxBins + t;
  if (owns_digit) publish_status(word, status_word(tile == 0 ? kStatusInclusive : kStatusAggregate, count));
  int tile_count;
  const int start = block_exclusive_sum<kTileThreads>(count, warp_sums, &tile_count);
  if (owns_digit) {
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) warp_runs[w * kMaxBins + t] += start;
  }
  __syncthreads();
  rank_rows(dig, digit.nbits, runs,
            [&](int j, int rank) { source[rank] = static_cast<uint16_t>(first + 32 * j + lane); });

  // (c)
  if (owns_digit) {
    int before = 0;
    if (tile > 0) {
      before = static_cast<int>(look_back(status + t, kMaxBins, tile));
      publish_status(word, status_word(kStatusInclusive, before + count));
    }
    shift[t] = base_d + before - start;
  }
  cp_async_wait<0>();
  __syncthreads();

  // (d) ranks t + kTileThreads (c + k), kStoreItems of them at a time: each
  // rank's source and place, found with its key, serve every stream
#pragma unroll
  for (int c = 0; c < kTileItems; c += kStoreItems) {
    int from[kStoreItems];
    int dst[kStoreItems];
#pragma unroll
    for (int k = 0; k < kStoreItems; ++k) {
      const int r = kTileThreads * (c + k) + t;
      if (r < tile_n) {
        from[k] = source[r];
        const uint32_t key = stage[from[k]];
        dst[k] = shift[digit.of(key)] + r;
        s_out[0][dst[k]] = key;
      }
    }
    for (int st = 1; st < s.count; ++st) {
      const uint32_t* buf = stage + st * kTile;
      uint32_t* out = s_out[st];
#pragma unroll
      for (int k = 0; k < kStoreItems; ++k) {
        if (kTileThreads * (c + k) + t < tile_n) out[dst[k]] = buf[from[k]];
      }
    }
  }
}

// Copies n words from device memory to buf in shared memory, in order: 16
// bytes a load where `in` is 16-byte aligned, then single words.
__device__ __forceinline__ void load_words(const uint32_t* in, uint32_t* buf, int n) {
  const bool vec = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  for (int c = threadIdx.x; 4 * c < n; c += blockDim.x) {
    const int i = 4 * c;
    if (vec && i + 4 <= n) {
      *reinterpret_cast<uint4*>(buf + i) = *reinterpret_cast<const uint4*>(in + i);
    } else {
      for (int e = i; e < min(i + 4, n); ++e) buf[e] = in[e];
    }
  }
}

// K3. Replaces glu_tpu/ops/_pallas_sort.py::_single_block_sort.
//
// One launch sorts all of an input of at most kSingleMax elements, one
// stable pass per Digit of plan (1-4 passes of 1-8 key bits: a 32-bit sort
// is 4 passes). The keys and a u16 source index stay in shared memory
// through every pass, and the payload streams are gathered by that index
// once at the end, so device memory sees one read and one write of each word
// and the shared memory need does not depend on the payload count.
//
// What bounds it on this card is not device bytes (65,536 pairs move 1 MB,
// 0.3 microseconds at 3.35 TB/s) but latency: each pass's chain of steps,
// most of it in the ranking of step (c), where each row of 32 waits on the
// leaders' adds of the row before it (after nine ballots). So the design
// shortens the chain: passes of 8 bits (4 for 32 bits, not 8 of 4 bits),
// the onesweep kernel's ballot ranker (rank_rows: no per-thread counter
// table to scan), and 32 warps a CTA, each ranking only its own rows, so
// that a warp's chain is about slice / 1024 rows; a small sort takes few
// warps. A small input runs on one CTA; a larger one on a cluster of CTAs
// (CLUSTER; faster on the H100 from about 6,000 elements, and the only way
// past one SM's shared memory), CTA r holding the contiguous slice
// [r * slice, r * slice + slice) of the input and of the output, which
// shortens each CTA's chain as well. The cluster's CTAs exchange their
// elements through distributed shared memory, where a store costs far more
// than in a CTA's own, and most when a warp's 32 stores fall apart: so each
// CTA ranks into its own shared memory as one CTA does, then copies its
// elements out in rank order, where a warp's stores fall on few runs of
// consecutive places in one other CTA. A gather of 4-byte words from device
// memory costs one SM a sector a word, so each payload stream is copied
// whole into the keys' buffers once the keys are written out, gathered
// there and written in order. Each pass:
//  (a) every warp takes the contiguous run of items first + 32 j + lane of
//      its CTA's slice, holds its keys in registers and counts their digits
//      into its own row of warp_runs with shared atomics;
//  (b) a scan over (digit, warp), digit-major, gives each warp its first
//      rank of each digit in its CTA; in a cluster each CTA also publishes
//      its count of each digit in cta_counts;
//  (c) the warp ranks its rows in order, kRankRows at a time, and writes
//      each key (from its registers) and its source index (from the index
//      buffer it read) to its rank, in the CTA's own staged buffers. The
//      order is (digit, warp, row, lane), input order within a digit, so
//      the pass is stable. One CTA alone rewrites its keys in place (every
//      key was read in (a)) and alternates its two index buffers: that is
//      the pass. In a cluster:
//  (d) after a cluster barrier (every CTA's counts published and its
//      elements staged, so every CTA's buffers 0 are free), each CTA reads
//      every CTA's counts: a digit's count over the cluster, and in the
//      CTAs before it; a scan over the digits gives each digit's start in
//      the cluster's order (digit, CTA, warp, row, lane), still stable, and
//      so the shift from a digit's rank in the CTA to its rank in the
//      cluster;
//  (e) each CTA copies its staged keys and indices, in rank order, to their
//      ranks: into buffers 0 of the CTA whose slice holds each, and a
//      cluster barrier ends the pass.
// The index is the element's position in the whole input (a u16: at most
// 65,536 elements). A cluster's last barrier comes after its last read of
// another CTA's shared memory, so that no CTA exits while it is read.
template <bool CLUSTER>
__global__ void __launch_bounds__(kSingleThreads)
    sort_single_tile_kernel(Streams s, int n, int slice, PassDigits plan) {
  constexpr int kKeyBuffers = CLUSTER ? 2 : 1;
  extern __shared__ __align__(16) uint32_t smem_single[];
  uint32_t* keys = smem_single;                                                   // [kKeyBuffers][kSliceMax]
  uint16_t* index = reinterpret_cast<uint16_t*>(keys + kKeyBuffers * kSliceMax);  // [2][kSliceMax]
  int* warp_runs = reinterpret_cast<int*>(index + 2 * kSliceMax);                 // [kSingleWarps][kMaxBins]
  __shared__ const uint32_t* s_in[kMaxStreams];
  __shared__ uint32_t* s_out[kMaxStreams];
  __shared__ Digit s_digit[kMaxPasses];
  __shared__ int warp_sums[kSingleWarps + 1];
  // a cluster's: this CTA's count of each digit in the pass, the shift from
  // a digit's rank in the CTA to its rank in the cluster, and every CTA's
  // buffers 0 and counts as this CTA addresses them
  __shared__ int cta_counts[kMaxBins];
  __shared__ int shift[kMaxBins];
  __shared__ uint32_t* s_keys[kMaxCluster];
  __shared__ uint16_t* s_index[kMaxCluster];
  __shared__ const int* s_counts[kMaxCluster];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int cta = 0, ctas = 1;
  if constexpr (CLUSTER) {
    cta = static_cast<int>(cg::this_cluster().block_rank());
    ctas = static_cast<int>(cg::this_cluster().num_blocks());
  }
  auto cluster_sync = [] {
    if constexpr (CLUSTER) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  };
  const int lo = cta * slice;                  // this CTA's slice of the input and the output
  const int mine = max(0, min(slice, n - lo));  // its elements: the last CTA's may be fewer, or none
  if (t == 0) {  // the launch arguments indexed at run time, with static indices
#pragma unroll
    for (int j = 0; j < kMaxStreams; ++j) {
      s_in[j] = s.in[j];
      s_out[j] = s.out[j];
    }
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) s_digit[p] = plan.pass[p];
    if constexpr (CLUSTER) {
      for (int c = 0; c < ctas; ++c) {
        s_keys[c] = cg::this_cluster().map_shared_rank(keys, c);
        s_index[c] = cg::this_cluster().map_shared_rank(index, c);
        s_counts[c] = cg::this_cluster().map_shared_rank(cta_counts, c);
      }
    }
  }
  for (int i = t; i < kSingleWarps * kMaxBins; i += kSingleThreads) warp_runs[i] = 0;
  load_words(s.in[0] + lo, keys, mine);
  for (int i = t; i < mine; i += kSingleThreads) index[i] = static_cast<uint16_t>(lo + i);
  __syncthreads();

  // rows of 32 items per warp, in whole chunks of kRankRows, so that no warp
  // ranks an empty row and a small sort takes few warps
  const int rows = (slice + kSingleThreads * kRankRows - 1) / (kSingleThreads * kRankRows) * kRankRows;
  const int first = warp * rows * 32;
  int* runs = warp_runs + warp * kMaxBins;
  uint32_t* staged = keys + (CLUSTER ? kSliceMax : 0);  // the keys in rank order in the CTA (one CTA: in place)
  for (int p = 0; p < plan.count; ++p) {
    const Digit digit = s_digit[p];
    const uint16_t* src = index + (CLUSTER ? 0 : (p & 1) * kSliceMax);
    uint16_t* dst = index + (CLUSTER ? kSliceMax : ((p + 1) & 1) * kSliceMax);
    // (a)
    uint32_t key[kSingleItems];
#pragma unroll
    for (int j = 0; j < kSingleItems; ++j) {
      const int i = first + 32 * j + lane;
      key[j] = 0;
      if (j < rows && i < mine) {
        key[j] = keys[i];
        atomicAdd(&runs[digit.of(key[j])], 1);
      }
    }
    __syncthreads();
    // (b) thread t < bins sums digit t over the warps, then places each warp
    const bool owns_digit = t < (1 << digit.nbits);
    int count = 0;
    if (owns_digit) {
#pragma unroll 8
      for (int w = 0; w < kSingleWarps; ++w) count += warp_runs[w * kMaxBins + t];
      if constexpr (CLUSTER) cta_counts[t] = count;
    }
    int total;
    const int start = block_exclusive_sum<kSingleThreads>(count, warp_sums, &total);
    if (owns_digit) {
      int run = start;
#pragma unroll 8
      for (int w = 0; w < kSingleWarps; ++w) {
        const int c = warp_runs[w * kMaxBins + t];
        warp_runs[w * kMaxBins + t] = run;
        run += c;
      }
    }
    __syncthreads();
    // (c)
#pragma unroll
    for (int c = 0; c < kSingleItems; c += kRankRows) {
      if (c < rows) {
        uint32_t dig[kRankRows];
#pragma unroll
        for (int j = 0; j < kRankRows; ++j) {
          const int i = first + 32 * (c + j) + lane;
          dig[j] = c + j < rows && i < mine ? digit.of(key[c + j]) : kMaxBins;
        }
        rank_rows(dig, digit.nbits, runs, [&](int j, int rank) {
          staged[rank] = key[c + j];
          dst[rank] = src[first + 32 * (c + j) + lane];
        });
      }
    }
    for (int d = lane; d < kMaxBins; d += 32) runs[d] = 0;  // after rank_rows' last __syncwarp
    if constexpr (CLUSTER) {
      cg::this_cluster().sync();
      // (d) the counts of every CTA, their loads all in flight at once
      int counts[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) counts[c] = owns_digit && c < ctas ? s_counts[c][t] : 0;
      int all = 0, before = 0;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
        all += counts[c];
        before += c < cta ? counts[c] : 0;
      }
      const int cluster_start = block_exclusive_sum<kSingleThreads>(all, warp_sums, &total);
      if (owns_digit) shift[t] = cluster_start + before - start;
      __syncthreads();
      // (e)
      for (int q = t; q < mine; q += kSingleThreads) {
        const uint32_t k = staged[q];
        const int rank = q + shift[digit.of(k)];
        const int owner = rank / slice;
        const int at = rank - owner * slice;
        s_keys[owner][at] = k;
        s_index[owner][at] = dst[q];
      }
    }
    cluster_sync();
  }

  // the output slice's keys and source indices: buffers 0 in a cluster
  const uint16_t* order = index + (CLUSTER ? 0 : (plan.count & 1) * kSliceMax);
  for (int i = t; i < mine; i += kSingleThreads) s_out[0][lo + i] = keys[i];
  for (int st = 1; st < s.count; ++st) {  // each payload through the keys' buffers 0
    cluster_sync();  // every read of the buffers (this CTA's, and the gathers of the stream before) done
    load_words(s_in[st] + lo, keys, mine);
    cluster_sync();
    uint32_t* out = s_out[st] + lo;
    for (int i = t; i < mine; i += kSingleThreads) {
      const int from = order[i];
      if constexpr (CLUSTER) {
        const int owner = from / slice;
        out[i] = s_keys[owner][from - owner * slice];
      } else {
        out[i] = keys[from];
      }
    }
  }
  if constexpr (CLUSTER) {
    if (s.count > 1) cg::this_cluster().sync();  // the gathers' reads of the other CTAs
  }
}

constexpr int onesweep_smem(int nstreams) {
  return nstreams * kTile * 4 + kTile * 2 + kTileWarps * kMaxBins * 4;
}
constexpr int kSingleTileSmem = 2 * kSliceMax * 4 + 2 * kSliceMax * 2 + kSingleWarps * kMaxBins * 4;  // both forms

bool fill_streams(Streams* s, const void* const* in, void* const* out, int count) {
  if (in == nullptr || out == nullptr || count < 1 || count > kMaxStreams) return false;
  for (int i = 0; i < kMaxStreams; ++i) {
    s->in[i] = i < count ? static_cast<const uint32_t*>(in[i]) : nullptr;
    s->out[i] = i < count ? static_cast<uint32_t*>(out[i]) : nullptr;
    if (i < count && (s->in[i] == nullptr || s->out[i] == nullptr)) return false;
  }
  s->count = count;
  return true;
}

bool fill_digit(Digit* d, const int* bits, int nbits) {
  if (bits == nullptr || nbits < 1 || nbits > kMaxPassBits) return false;
  d->nbits = nbits;
  d->shift = bits[0];
  for (int j = 0; j < kMaxPassBits; ++j) {
    const int b = j < nbits ? bits[j] : 0;
    if (b < 0 || b > 31) return false;
    if (j < nbits && b != bits[0] + j) d->shift = -1;
    d->bit[j] = b;
  }
  return true;
}

// bits: the passes' key bits one after another, nbits[p] of them for pass p.
bool fill_plan(PassDigits* plan, const int* bits, const int* nbits, int npasses) {
  if (nbits == nullptr || npasses < 1 || npasses > kMaxPasses) return false;
  plan->count = npasses;
  for (int p = 0, at = 0; p < kMaxPasses; ++p) {
    if (p < npasses) {
      if (!fill_digit(&plan->pass[p], bits + at, nbits[p])) return false;
      at += nbits[p];
    } else {
      plan->pass[p] = plan->pass[0];
    }
  }
  return true;
}

// Lets `kernel` take `bytes` of dynamic shared memory, and with max_carveout
// asks for the largest shared-memory carveout of L1, so that CUDA never
// picks one that holds fewer CTAs than the shared memory allows: once per
// device and process (a bit of `done` per device), not on every launch.
cudaError_t allow_smem(const void* kernel, int bytes, std::atomic<unsigned long long>* done,
                       bool max_carveout = false) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (done->load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && max_carveout)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done->fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <bool CLUSTER>
cudaError_t allow_single_tile_smem() {
  static std::atomic<unsigned long long> done{0};
  return allow_smem(reinterpret_cast<const void*>(sort_single_tile_kernel<CLUSTER>), kSingleTileSmem, &done);
}

// K3's launch on a cluster of ctas CTAs (2..kMaxCluster) in one row: the
// configuration of the launch and of cudaOccupancyMaxActiveClusters.
struct ClusterLaunch {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attribute[1];

  ClusterLaunch(int ctas, cudaStream_t stream) {
    config.gridDim = dim3(ctas);
    config.blockDim = dim3(kSingleThreads);
    config.dynamicSmemBytes = kSingleTileSmem;
    config.stream = stream;
    attribute[0].id = cudaLaunchAttributeClusterDimension;
    attribute[0].val.clusterDim.x = ctas;
    attribute[0].val.clusterDim.y = 1;
    attribute[0].val.clusterDim.z = 1;
    config.attrs = attribute;
    config.numAttrs = 1;
  }
};

// The slice of each CTA of K3 on ctas CTAs: n split evenly, rounded up to
// whole 16-byte vectors (the last CTA takes what is left); n itself on one.
int single_tile_slice(int n, int ctas) { return ctas == 1 ? n : ((n + ctas - 1) / ctas + 3) / 4 * 4; }

// The most any onesweep launch takes (kMaxStreams streams), from the largest
// carveout; a launch with fewer streams asks for less.
cudaError_t allow_onesweep_smem() {
  static std::atomic<unsigned long long> done{0};
  return allow_smem(reinterpret_cast<const void*>(onesweep_pass_kernel), onesweep_smem(kMaxStreams), &done, true);
}

int num_tiles(int n) { return static_cast<int>((static_cast<long long>(n) + kTile - 1) / kTile); }

// One digit_histograms launch: a grid of up to two CTAs per SM, each
// taking whole 16-byte vectors of 4 keys a thread.
cudaError_t launch_histograms(const void* keys, int n, const PassDigits& plan, int* hist, int* bases,
                              unsigned int* ctas_done, cudaStream_t stream) {
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long per_cta = static_cast<long long>(kHistThreads) * 4;
  const int ctas = static_cast<int>(
      std::max(1LL, std::min(static_cast<long long>(sms) * (2048 / kHistThreads), (n + per_cta - 1) / per_cta)));
  digit_histograms_kernel<<<ctas, kHistThreads, 0, stream>>>(
      static_cast<const uint32_t*>(keys), n, plan, hist, bases, ctas_done);
  return cudaGetLastError();
}

// glu_onesweep_sort's work buffer, in int32 words: hist and bases
// ([kMaxPasses][kMaxBins] each), the histogram's count of finished CTAs,
// then, from a 256-byte boundary, the status words of the passes: a region
// for every pass (num_tiles(n) * kMaxBins + 1 64-bit words, each region
// from a 256-byte boundary, as a fresh allocation's are: a warp's look-back
// reads 32 adjacent words), all zeroed at once, where they take at most
// kSeparateStatusBytes, else one region zeroed before each pass. One
// zeroing instead of one a pass spares the host a call a pass where the
// sort is small and the host's calls are most of its time; a region a pass
// would hold 358 MB at 2^28 pairs.
constexpr long long kWorkHead = (2LL * kMaxPasses * kMaxBins + 1 + 63) / 64 * 64;
constexpr long long kSeparateStatusBytes = 64LL << 20;

// 64-bit words from one status region to the next
long long status_words(int n) { return (static_cast<long long>(num_tiles(n)) * kMaxBins + 1 + 31) / 32 * 32; }

int status_regions(int n, int npasses) {
  return npasses * status_words(n) * 8 <= kSeparateStatusBytes ? npasses : 1;
}

}  // namespace

extern "C" {

int glu_sort_tile() { return kTile; }
int glu_sort_single_tile_max() { return kSingleMax; }
int glu_sort_slice_max() { return kSliceMax; }
int glu_sort_max_cluster() { return kMaxCluster; }
int glu_sort_max_streams() { return kMaxStreams; }
int glu_sort_bins() { return kMaxBins; }
const char* glu_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// bits, nbits, npasses: the passes, as fill_plan takes them.
int glu_digit_histograms(const void* keys, int n, const int* bits, const int* nbits, int npasses,
                         int* hist, void* stream) {
  PassDigits plan;
  if (keys == nullptr || n < 1 || hist == nullptr || !fill_plan(&plan, bits, nbits, npasses))
    return cudaErrorInvalidValue;
  return launch_histograms(keys, n, plan, hist, nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

// status: num_tiles(n) * kMaxBins + 1 zeroed 64-bit words.
int glu_onesweep_pass(const void* const* in, void* const* out, int nstreams, int n,
                      const int* bits, int nbits, const int* digit_base, void* status,
                      void* stream) {
  Streams s;
  Digit digit;
  if (n < 1 || digit_base == nullptr || status == nullptr || !fill_streams(&s, in, out, nstreams) ||
      !fill_digit(&digit, bits, nbits))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_onesweep_smem();
  if (err != cudaSuccess) return err;
  onesweep_pass_kernel<<<num_tiles(n), kTileThreads, onesweep_smem(nstreams), static_cast<cudaStream_t>(stream)>>>(
      s, n, digit, digit_base, static_cast<unsigned long long*>(status));
  return cudaGetLastError();
}

// How many CTAs of a onesweep pass over nstreams streams an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the attributes that
// every launch sets), or minus the CUDA error that stopped the query.
int glu_onesweep_ctas_per_sm(int nstreams) {
  if (nstreams < 1 || nstreams > kMaxStreams) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_onesweep_smem();
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, onesweep_pass_kernel, kTileThreads,
                                                        onesweep_smem(nstreams));
  cudaGetLastError();
  return err != cudaSuccess ? -static_cast<int>(err) : ctas;
}

// The int32 words of the work buffer that glu_onesweep_sort takes for n
// elements in npasses passes (under 2^28 for any n below 2^31); the buffer
// starts at a 256-byte boundary.
int glu_onesweep_sort_work_words(int n, int npasses) {
  if (n < 1 || npasses < 1 || npasses > kMaxPasses) return -1;
  return static_cast<int>(kWorkHead + 2 * status_regions(n, npasses) * status_words(n));
}

// A whole multi-tile sort in one call: digit_histograms, whose last CTA
// writes every pass's digit starts, then one onesweep_pass per pass of plan
// (bits, nbits, npasses as fill_plan takes them). Pass p reads `in` (p = 0)
// or the pass before's output, and writes `out` when npasses - 1 - p is
// even, else `tmp`, so that the last pass writes `out`; tmp (nstreams
// buffers of n words) is read only when npasses > 1. work:
// glu_onesweep_sort_work_words(n, npasses) int32 words from a 256-byte
// boundary. The inputs are not written.
int glu_onesweep_sort(const void* const* in, void* const* out, void* const* tmp, int nstreams, int n,
                      const int* bits, const int* nbits, int npasses, void* work, void* stream) {
  PassDigits plan;
  Streams check;
  if (n < 1 || work == nullptr || !fill_plan(&plan, bits, nbits, npasses) ||
      !fill_streams(&check, in, out, nstreams) || (npasses > 1 && !fill_streams(&check, in, tmp, nstreams)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* hist = static_cast<int*>(work);
  int* bases = hist + kMaxPasses * kMaxBins;
  unsigned int* ctas_done = reinterpret_cast<unsigned int*>(bases + kMaxPasses * kMaxBins);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(hist + kWorkHead);
  const int regions = status_regions(n, npasses);
  const size_t region_bytes = static_cast<size_t>(status_words(n)) * sizeof(unsigned long long);
  // the head, and every region where there is one a pass
  cudaError_t err = cudaMemsetAsync(work, 0, kWorkHead * sizeof(int) + (regions > 1 ? regions * region_bytes : 0), st);
  if (err == cudaSuccess) err = launch_histograms(in[0], n, plan, hist, bases, ctas_done, st);
  if (err == cudaSuccess) err = allow_onesweep_smem();
  const void* const* src = in;
  for (int p = 0; p < npasses && err == cudaSuccess; ++p) {
    void* const* dst = (npasses - 1 - p) % 2 == 0 ? out : tmp;
    unsigned long long* pass_status = status + (regions > 1 ? p * status_words(n) : 0);
    if (regions == 1) {
      err = cudaMemsetAsync(pass_status, 0, region_bytes, st);
      if (err != cudaSuccess) break;
    }
    Streams pass;
    fill_streams(&pass, src, dst, nstreams);
    onesweep_pass_kernel<<<num_tiles(n), kTileThreads, onesweep_smem(nstreams), st>>>(
        pass, n, plan.pass[p], bases + p * kMaxBins, pass_status);
    err = cudaGetLastError();
    src = const_cast<const void* const*>(dst);
  }
  return err;
}

// K3 on ctas CTAs (1..kMaxCluster; each CTA's slice, single_tile_slice(n,
// ctas), at most kSliceMax): one CTA, or a cluster of ctas CTAs. bits,
// nbits, npasses: the passes, as fill_plan takes them.
int glu_sort_single_tile(const void* const* in, void* const* out, int nstreams, int n,
                         const int* bits, const int* nbits, int npasses, int ctas, void* stream) {
  Streams s;
  PassDigits plan;
  if (n < 1 || n > kSingleMax || ctas < 1 || ctas > kMaxCluster || single_tile_slice(n, ctas) > kSliceMax ||
      !fill_streams(&s, in, out, nstreams) || !fill_plan(&plan, bits, nbits, npasses))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ctas == 1) {
    const cudaError_t err = allow_single_tile_smem<false>();
    if (err != cudaSuccess) return err;
    sort_single_tile_kernel<false><<<1, kSingleThreads, kSingleTileSmem, st>>>(s, n, n, plan);
    return cudaGetLastError();
  }
  cudaError_t err = allow_single_tile_smem<true>();
  if (err != cudaSuccess) return err;
  ClusterLaunch launch(ctas, st);
  err = cudaLaunchKernelEx(&launch.config, sort_single_tile_kernel<true>, s, n, single_tile_slice(n, ctas), plan);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// K3 on one (key, value) pair of streams: glu_sort_single_tile with the
// four pointers given one by one, so that a caller passes plain integers
// and builds no arrays of pointers.
int glu_sort_pairs_single_tile(const void* keys_in, const void* values_in, void* keys_out, void* values_out, int n,
                               const int* bits, const int* nbits, int npasses, int ctas, void* stream) {
  const void* const in[2] = {keys_in, values_in};
  void* const out[2] = {keys_out, values_out};
  return glu_sort_single_tile(in, out, 2, n, bits, nbits, npasses, ctas, stream);
}

// How many clusters of ctas CTAs of K3 the device can hold at once
// (cudaOccupancyMaxActiveClusters; 0: such a launch is refused), or minus
// the CUDA error that stopped the query.
int glu_sort_single_tile_clusters(int ctas) {
  if (ctas < 2 || ctas > kMaxCluster) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_single_tile_smem<true>();
  int clusters = 0;
  if (err == cudaSuccess) {
    ClusterLaunch launch(ctas, nullptr);
    err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(sort_single_tile_kernel<true>),
                                         &launch.config);
  }
  cudaGetLastError();
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

}  // extern "C"
''',
    'reduce.cu': r'''// K5, the reduce: a hand-written Hopper (sm_90a) fold of every row of a
// (parts, len, comps) row-major tensor to (parts, comps), in one launch
// (glu_tpu_torch/ops/_cuda_reduce.py).
//
// Replaces glu_tpu/ops/_pallas_reduce.py::_pallas_reduce_flat (body
// _reduce_kernel), which walks 2048 x 128 tiles in one sequential grid into
// an (8, 128) accumulator, and pallas_reduce's vmap of it over a transposed
// copy of an (N, C) vector stream. Here CTAs run in parallel and in no order:
// `ctas` CTAs share a row, each folds its tiles into C partials, and the
// last CTA of the row to finish folds the row's partials (the
// threadFenceReduction pattern of the CUDA programming guide). The last CTA
// folds them in CTA order whichever CTA it is, so float results are the same
// from run to run; no atomics touch the values (mul has none).
//
// Bound by device-memory bytes: each input word is read once, at 3.35 TB/s
// 0.320 ms for 2^28 u32. So every load is coalesced, 16 bytes a thread
// where the rows are 16-byte aligned, with a tile's loads issued together
// before they are folded, and enough CTAs (the host asks for about 1056) are
// resident to keep the loads in flight. An (N, C) stream is read where it
// lies, with no transposed copy: a tile is kFoldTile flat elements, a whole
// number of vectors, and each lane of a thread meets one component
// (fold.cuh, Lanes). The only other traffic is one partial per CTA and one
// ticket per row, in a scratch buffer the wrapper zeroes once: the last CTA
// sets its row's ticket back to 0, so no launch needs a fill before it.
//
// Plain C interface for ctypes; every entry returns a cudaError_t.

#include "fold.cuh"

namespace {

using namespace glu;

// CTA blockIdx.x = p * ctas + k folds tiles k, k + ctas, k + 2 ctas, ... of
// row p of x (len flat elements, C components). A full tile is read with
// VEC-wide loads (VEC > 1 only when every row starts on a 16-byte boundary);
// the ragged last tile of a row is masked item by item in the same lanes, so
// no padded copy of the input is made. With ctas == 1 the CTA writes
// out[p][0..C) itself; else it writes partials[p][k][0..C), draws a ticket
// from tickets[p], and the CTA that draws ctas - 1 folds the row's partials
// into out[p] and sets tickets[p] back to 0.
template <int OP, typename T, int VEC, int C>
__global__ void __launch_bounds__(kFoldThreads)
    reduce_onepass_kernel(const T* __restrict__ x, long long len, int ctas, unsigned* __restrict__ tickets,
                          T* __restrict__ partials, T* __restrict__ out) {
  using L = Lanes<C, VEC>;
  __shared__ T warp_vals[C * kFoldWarps];
  __shared__ bool last;
  const int t = threadIdx.x;
  const long long p = blockIdx.x / ctas;
  const int k0 = static_cast<int>(blockIdx.x % ctas);
  const T* row = x + p * len;
  const long long tiles = (len + kFoldTile - 1) / kFoldTile;
  constexpr int kLoads = kFoldTile / (kFoldThreads * VEC);
  T acc[L::kSlots];
#pragma unroll
  for (int s = 0; s < L::kSlots; ++s) acc[s] = identity<OP, T>();
  for (long long j = k0; j < tiles; j += ctas) {
    const long long base = j * kFoldTile;
    const T* tile = row + base;
    const int tile_n = static_cast<int>(len - base < kFoldTile ? len - base : kFoldTile);
    if (VEC > 1 && tile_n == kFoldTile) {
      const Vec<T, VEC>* vt = reinterpret_cast<const Vec<T, VEC>*>(tile);
      Vec<T, VEC> v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) v[k] = vt[k * kFoldThreads + t];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e % L::kSlots] = combine<OP>(acc[e % L::kSlots], v[k].v[e]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int i = (k * kFoldThreads + t) * VEC + e;
          if (i < tile_n) acc[e % L::kSlots] = combine<OP>(acc[e % L::kSlots], tile[i]);
        }
      }
    }
  }
  T total[C];
  block_fold<OP, C, VEC>(acc, warp_vals, total);
  if (ctas == 1) {
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) out[p * C + c] = total[c];
    }
    return;
  }
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) partials[static_cast<long long>(blockIdx.x) * C + c] = total[c];
    __threadfence();  // the partials are visible device-wide before the ticket is drawn
    last = atomicAdd(tickets + p, 1u) == static_cast<unsigned>(ctas - 1);
    if (last) __threadfence();  // and the others' partials before they are read
  }
  __syncthreads();
  if (!last) return;
  // The row's partials, in CTA order: thread t folds CTAs t, t + kFoldThreads,
  // ..., then the block tree; read through L2 (__ldcg), never a stale L1.
  const T* mine = partials + p * ctas * C;
  T part[C];
#pragma unroll
  for (int c = 0; c < C; ++c) part[c] = identity<OP, T>();
  for (int i = t; i < ctas; i += kFoldThreads) {
#pragma unroll
    for (int c = 0; c < C; ++c) part[c] = combine<OP>(part[c], __ldcg(mine + static_cast<long long>(i) * C + c));
  }
  block_fold<OP, C, C>(part, warp_vals, total);
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[p * C + c] = total[c];
    tickets[p] = 0;
  }
}

template <int OP, typename T, int C>
cudaError_t launch_reduce(const T* x, int parts, long long len, int ctas, unsigned* tickets, T* partials, T* out,
                          cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       (parts == 1 || (len * static_cast<long long>(sizeof(T))) % 16 == 0);
  const unsigned grid = static_cast<unsigned>(static_cast<long long>(parts) * ctas);
  if (aligned) {
    reduce_onepass_kernel<OP, T, kVec, C><<<grid, kFoldThreads, 0, stream>>>(x, len, ctas, tickets, partials, out);
  } else {
    reduce_onepass_kernel<OP, T, 1, C><<<grid, kFoldThreads, 0, stream>>>(x, len, ctas, tickets, partials, out);
  }
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, C>()) for the runtime component count.
template <typename F>
cudaError_t with_components(int comps, F&& f) {
  switch (comps) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int glu_fold_tile() { return kFoldTile; }

// out[p][0..comps) = fold of row p of the (parts, len, comps) input x, each
// component on its own, under op, in one launch of parts * ctas CTAs. With
// ctas > 1, tickets holds parts zeroed unsigned words and partials room for
// parts * ctas * comps values; the kernel leaves every ticket at 0. dtype and
// op are the DType and Op codes of fold.cuh.
int glu_reduce(const void* x, int parts, long long len, int comps, int ctas, int dtype, int op, void* tickets,
               void* partials, void* out, void* stream) {
  if (x == nullptr || out == nullptr || parts < 1 || len < 1 || ctas < 1 ||
      static_cast<long long>(parts) * ctas > 0x7fffffffLL || (ctas > 1 && (tickets == nullptr || partials == nullptr)))
    return cudaErrorInvalidValue;
  return with_components(comps, [&](auto c_c) {
    return with_dtype_op(dtype, op, [&](auto op_c, auto t_c) {
      using T = decltype(t_c);
      return launch_reduce<decltype(op_c)::value, T, decltype(c_c)::value>(
          static_cast<const T*>(x), parts, len * comps, ctas, static_cast<unsigned*>(tickets),
          static_cast<T*>(partials), static_cast<T*>(out), static_cast<cudaStream_t>(stream));
    });
  });
}

}  // extern "C"
''',
    'scan.cu': r'''// K4, the exclusive scan: a hand-written Hopper (sm_90a) single-pass scan of
// every row of a (parts, len) row-major tensor (glu_tpu_torch/ops/_cuda_scan.py).
//
// Replaces glu_tpu/ops/_pallas_scan.py::pallas_exclusive_scan (body
// _scan_kernel), which chains a carry through SMEM over a sequential grid of
// 2048 x 128 tiles and resets it at each partition. CTAs run in no order
// here, so each tile finds its carry-in by a decoupled look-back over the
// tiles before it in its row (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016). One launch, one CTA per
// tile of kScanTile elements:
//  (a) the CTA takes the next tile id from a counter, (row, j) =
//      divmod(id, tiles), so every tile it waits on in (d) belongs to a CTA
//      that is already running;
//  (b) it loads the tile once, coalesced (16 bytes a thread where the rows
//      are 16-byte aligned and the tile is full, masked item by item at a
//      ragged end), through a padded shared-memory transpose that gives each
//      thread kScanItems consecutive items;
//  (c) a serial fold per thread and a block scan give the tile's aggregate,
//      which is published at once; tile 0 of a row publishes it as its
//      inclusive value, and its carry-in is the identity: the reset at each
//      partition, so no look-back crosses into an earlier row;
//  (d) one warp looks back, 32 tiles at a time, for the nearest earlier
//      tile that has published its inclusive value, keeping the aggregates
//      it walks past, while the other warps write the tile's local
//      exclusive scan to shared memory; it publishes inclusive = carry op
//      aggregate;
//  (e) every item is written as carry op (its local exclusive value).
//
// Float results are the same from run to run: the look-back folds what it
// read left to right, carry = inc[k] op agg[k+1] op ... op agg[j-1], so by
// induction every inclusive value is the sequential fold agg[0] op ... op
// agg[j], whichever tile the look-back happens to stop at. The walk past
// a window that holds no inclusive value is what keeps the tiles flowing:
// waiting instead for one of the 32 tiles before it to turn inclusive
// limits the card to about 32 tiles per round trip to L2 (PERF.md).
//
// Bound by device-memory bytes: each word read once and written once, 2.15
// GB for 2^28 u32, 0.641 ms at 3.35 TB/s. The design adds 8 bytes of status
// a tile for 4-byte types (24 for float64), zeroed by the caller.
//
// Plain C interface for ctypes; every entry returns a cudaError_t.

#include <cstring>

#include "fold.cuh"
#include "lookback.cuh"

namespace {

using namespace glu;

constexpr int kScanThreads = 256;
constexpr int kScanItems = 32;
constexpr int kScanTile = kScanThreads * kScanItems;  // 8192 elements per tile (PERF.md: 4096 was slower)
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kWindow = 32;  // tiles a look-back reads at once, one a lane
constexpr int kWindows = 8;  // windows a look-back walks down before it waits

// One word of padding after every 32, so that threads reading their
// kScanItems consecutive items fall on different banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }
constexpr int kTileBuf = padded(kScanTile);

// The status of every tile of one scan: a flag, 0 until the tile publishes,
// then kStatusAggregate or kStatusInclusive, and the value that goes with
// it. After the tiles' status, one word holds the tile counter.
template <typename T, bool PACKED = sizeof(T) == 4>
struct TileStatus;

// 4-byte T: one 64-bit word a tile, [flag | the value's bits], stored and
// loaded as one relaxed atomic.
template <typename T>
struct TileStatus<T, true> {
  static constexpr int kWordsPerTile = 1;
  unsigned long long* words;

  __device__ TileStatus(unsigned long long* status, long long) : words(status) {}

  __device__ void publish(long long k, unsigned long long flag, T v) const {
    uint32_t bits;
    memcpy(&bits, &v, sizeof bits);
    publish_status(words + k, status_word(flag, bits));
  }

  // The flag of tile k; when it is not 0, *v gets the value.
  __device__ unsigned long long read(long long k, T* v) const {
    const unsigned long long word = read_status(words + k);
    const uint32_t bits = static_cast<uint32_t>(word);
    memcpy(v, &bits, sizeof bits);
    return word & ~0xffffffffull;
  }
};

// 8-byte T (float64): the value does not fit beside the flag. agg[k] and
// inc[k] are written once each, before the flag that names them is stored
// with release semantics, and read after it is loaded with acquire
// semantics, so a reader gets the value its flag stands for.
template <typename T>
struct TileStatus<T, false> {
  static constexpr int kWordsPerTile = 3;
  unsigned long long* flags;
  T* agg;
  T* inc;

  __device__ TileStatus(unsigned long long* status, long long tiles)
      : flags(status), agg(reinterpret_cast<T*>(status + tiles)), inc(reinterpret_cast<T*>(status + 2 * tiles)) {}

  __device__ void publish(long long k, unsigned long long flag, T v) const {
    (flag == kStatusInclusive ? inc : agg)[k] = v;
    publish_flag(flags + k, flag);
  }

  __device__ unsigned long long read(long long k, T* v) const {
    const unsigned long long flag = read_flag(flags + k);
    if (flag != 0) *v = __ldcg((flag == kStatusInclusive ? inc : agg) + k);
    return flag;
  }
};

// The carry-in of tile j >= 1 of the row whose tile 0 has status index
// `row`: inc[k] op agg[k+1] op ... op agg[j-1], folded left to right, where
// k is the highest tile below j that has published its inclusive value.
// The warp reads windows of 32 tiles, lane l tile top-32+l, from top = j
// down: a window in which every tile has published its aggregate and none
// its inclusive value goes to `passed` and the walk moves one window down;
// otherwise the window is read again, until one of its tiles is inclusive
// and every tile above that one has published its aggregate. Holding only
// kWindows - 1 windows, a walk that reaches that depth waits there instead.
// Tile 0 is inclusive from its start and every tile below j belongs to a
// running CTA, so the wait ends; kLookbackSpinLimit reads trap, so a fault
// shows as a CUDA error and not as a hung card. Run by one whole warp; the
// carry is in every lane.
template <int OP, typename T, typename Status>
__device__ T look_back(const Status& status, long long row, int j, T (*passed)[kWindow]) {
  const int lane = threadIdx.x & 31;
  int top = j, held = 0;
  T v = identity<OP, T>();
  unsigned inclusive;
  for (long long spins = 0;; ) {
    const int k = top - kWindow + lane;
    const unsigned long long flag = k >= 0 ? status.read(row + k, &v) : kStatusAggregate;
    inclusive = __ballot_sync(0xffffffffu, flag == kStatusInclusive);
    const unsigned ready = __ballot_sync(0xffffffffu, flag != 0);
    if (inclusive) {
      const unsigned from = ~0u << (31 - __clz(inclusive));  // the highest inclusive lane and those above it
      if ((ready & from) == from) break;
    } else if (ready == ~0u && held < kWindows - 1) {
      passed[held++][lane] = v;
      top -= kWindow;
      continue;
    }
    if (++spins == kLookbackSpinLimit) __trap();
  }
  __syncwarp();
  const int first = 31 - __clz(inclusive);
  T carry = __shfl_sync(0xffffffffu, v, first);
  for (int l = first + 1; l < kWindow; ++l) carry = combine<OP>(carry, __shfl_sync(0xffffffffu, v, l));
  for (int w = held - 1; w >= 0; --w) {
    for (int l = 0; l < kWindow; ++l) carry = combine<OP>(carry, passed[w][l]);
  }
  return carry;
}

// One CTA per tile of the (parts, len) input x: y = its exclusive scan
// under OP, row by row. status holds TileStatus<T> of parts * tiles tiles
// and the tile counter, all zero at launch. VEC > 1 only when x, y and every
// row start on a 16-byte boundary.
template <int OP, typename T, int VEC>
__global__ void __launch_bounds__(kScanThreads)
    scan_onepass_kernel(const T* __restrict__ x, T* __restrict__ y, long long len, int tiles,
                        unsigned long long* status_words) {
  extern __shared__ __align__(16) unsigned char scan_smem[];
  T* buf = reinterpret_cast<T*>(scan_smem);  // [kTileBuf]
  __shared__ T warp_vals[kScanWarps + 1];
  __shared__ T passed[kWindows][kWindow];  // the aggregates a look-back walked past (kWindows - 1 used)
  __shared__ T s_carry;
  __shared__ int s_id;
  using Status = TileStatus<T>;
  const long long all_tiles = gridDim.x;
  const Status status(status_words, all_tiles);
  const int t = threadIdx.x;

  // (a)
  if (t == 0) {
    unsigned* counter = reinterpret_cast<unsigned*>(status_words + Status::kWordsPerTile * all_tiles);
    s_id = static_cast<int>(atomicAdd(counter, 1u));
  }
  __syncthreads();
  const int id = s_id;
  const int j = id % tiles;
  const long long row = id - j;
  const long long start = static_cast<long long>(j) * kScanTile;
  const int tile_n = static_cast<int>(min(static_cast<long long>(kScanTile), len - start));
  const long long offset = static_cast<long long>(id / tiles) * len + start;
  const bool vec = VEC > 1 && tile_n == kScanTile;

  // (b) striped, coalesced loads
  if (vec) {
    constexpr int kLoads = kScanTile / (kScanThreads * VEC);
    const Vec<T, VEC>* in = reinterpret_cast<const Vec<T, VEC>*>(x + offset);
    Vec<T, VEC> v[kLoads];
#pragma unroll
    for (int c = 0; c < kLoads; ++c) v[c] = in[c * kScanThreads + t];
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) buf[padded((c * kScanThreads + t) * VEC + e)] = v[c].v[e];
    }
  } else {
#pragma unroll
    for (int c = 0; c < kScanItems; ++c) {
      const int i = c * kScanThreads + t;
      buf[padded(i)] = i < tile_n ? x[offset + i] : identity<OP, T>();
    }
  }
  __syncthreads();

  // (c) this thread's consecutive items
  const int first = t * kScanItems;
  T items[kScanItems];
  T own = identity<OP, T>();
#pragma unroll
  for (int c = 0; c < kScanItems; ++c) {
    items[c] = buf[padded(first + c)];
    own = combine<OP>(own, items[c]);
  }
  T aggregate;
  T run = block_exclusive_scan<OP, kScanWarps>(own, warp_vals, &aggregate);
  if (t == 0) status.publish(row + j, j == 0 ? kStatusInclusive : kStatusAggregate, aggregate);

  // (d)
  if (t < 32) {
    const T carry = j == 0 ? identity<OP, T>() : look_back<OP, T>(status, row, j, passed);
    if (t == 0) {
      s_carry = carry;
      if (j > 0) status.publish(row + j, kStatusInclusive, combine<OP>(carry, aggregate));
    }
  }
#pragma unroll
  for (int c = 0; c < kScanItems; ++c) {
    buf[padded(first + c)] = run;
    run = combine<OP>(run, items[c]);
  }
  __syncthreads();

  // (e) striped, coalesced stores
  const T carry = s_carry;
  if (vec) {
    constexpr int kStores = kScanTile / (kScanThreads * VEC);
    Vec<T, VEC>* out = reinterpret_cast<Vec<T, VEC>*>(y + offset);
#pragma unroll
    for (int c = 0; c < kStores; ++c) {
      Vec<T, VEC> v;
#pragma unroll
      for (int e = 0; e < VEC; ++e) v.v[e] = combine<OP>(carry, buf[padded((c * kScanThreads + t) * VEC + e)]);
      out[c * kScanThreads + t] = v;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kScanItems; ++c) {
      const int i = c * kScanThreads + t;
      if (i < tile_n) y[offset + i] = combine<OP>(carry, buf[padded(i)]);
    }
  }
}

template <int OP, typename T, int VEC>
cudaError_t launch_onepass(const T* x, T* y, long long len, long long grid, int tiles,
                           unsigned long long* status, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(T) * kTileBuf;
  if constexpr (kSmem > 48 * 1024) {  // a tile larger than static shared memory allows
    const cudaError_t err = cudaFuncSetAttribute(scan_onepass_kernel<OP, T, VEC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  scan_onepass_kernel<OP, T, VEC><<<static_cast<unsigned>(grid), kScanThreads, kSmem, stream>>>(
      x, y, len, tiles, status);
  return cudaGetLastError();
}

template <int OP, typename T>
cudaError_t launch_scan(const T* x, T* y, int parts, long long len, unsigned long long* status,
                        cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long tiles = (len + kScanTile - 1) / kScanTile;
  const long long grid = parts * tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       (len * static_cast<long long>(sizeof(T))) % 16 == 0;
  if (aligned) return launch_onepass<OP, T, kVec>(x, y, len, grid, static_cast<int>(tiles), status, stream);
  return launch_onepass<OP, T, 1>(x, y, len, grid, static_cast<int>(tiles), status, stream);
}

}  // namespace

extern "C" {

int glu_scan_tile() { return kScanTile; }

// y = exclusive scan of each row of the (parts, len) input x under op,
// seeded per row with the identity. status: zeroed 64-bit words, one per
// tile (three for float64) and one more for the tile counter, tiles =
// parts * ceil(len / glu_scan_tile()). dtype and op are the codes of
// fold.cuh.
int glu_scan_pass(const void* x, void* y, int parts, long long len, int dtype, int op, void* status,
                  void* stream) {
  if (x == nullptr || y == nullptr || status == nullptr || parts < 1 || len < 1) return cudaErrorInvalidValue;
  return with_dtype_op(dtype, op, [&](auto op_c, auto t_c) {
    using T = decltype(t_c);
    return launch_scan<decltype(op_c)::value, T>(static_cast<const T*>(x), static_cast<T*>(y), parts, len,
                                                 static_cast<unsigned long long*>(status),
                                                 static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
''',
}


class _Importer(importlib.abc.MetaPathFinder, importlib.abc.InspectLoader):
    """Finds the modules of _MODULES under this file's module name and runs
    them; a traceback shows their lines (linecache) under
    <this file>/glu_tpu_torch/<module path>."""

    def __init__(self, name: str):
        self.name = name

    def _source_name(self, fullname: str):
        if fullname == self.name or fullname.startswith(self.name + "."):
            source_name = "glu_tpu_torch" + fullname[len(self.name):]
            if source_name in _MODULES:
                return source_name
        return None

    def find_spec(self, fullname, path=None, target=None):
        if fullname == self.name or self._source_name(fullname) is None:
            return None
        return importlib.machinery.ModuleSpec(fullname, self, origin=__file__, is_package=self.is_package(fullname))

    def is_package(self, fullname: str) -> bool:
        source_name = self._source_name(fullname)
        return any(name.startswith(source_name + ".") for name in _MODULES)

    def get_source(self, fullname: str) -> str:
        return _MODULES[self._source_name(fullname)]

    def get_code(self, fullname: str):
        source = self.get_source(fullname)
        path = self._source_name(fullname).replace(".", "/") + ("/__init__.py" if self.is_package(fullname) else ".py")
        filename = f"{__file__}/{path}"
        linecache.cache[filename] = (len(source), None, source.splitlines(True), filename)
        return compile(source, filename, "exec", dont_inherit=True)

    def exec_module(self, module) -> None:
        module.__file__ = __file__
        exec(self.get_code(module.__name__), module.__dict__)


__path__ = []  # a package, whose submodules _Importer finds
if __spec__ is not None:
    __spec__.submodule_search_locations = __path__
__package__ = __name__
_importer = _Importer(__name__)
sys.meta_path.append(_importer)
exec(_importer.get_code(__name__), globals())  # the package's __init__
from . import entry, parallel  # noqa: E402
