"""Host-side debug printers (counterpart of glu_tpu/utils/debug.py).

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
