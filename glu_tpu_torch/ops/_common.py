"""Shared helpers of the kernel wrappers (counterpart of
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
