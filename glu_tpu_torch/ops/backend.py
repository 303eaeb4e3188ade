"""Backend selection (counterpart of glu_tpu/ops/backend.py).

"cuda" is the radix engine (ops/_cuda_sort.py): on a CUDA tensor it launches
the hand-written kernels, on a CPU tensor it runs their plain torch versions.
"torch" is the portable path, one stable `torch.sort`, the counterpart of the
JAX package's "xla" backend. The default is the engine; the cost-model router
of the JAX package is not ported yet.
"""

from __future__ import annotations

import torch

from ..utils.errors import check_argument

_VALID = ("cuda", "torch")


def resolve_backend(backend: str | None, tensor: torch.Tensor) -> str:
    """Resolve an explicit or default backend choice for `tensor`."""
    check_argument(
        tensor.device.type in ("cpu", "cuda"),
        "tensors on %s are not supported (want cpu or cuda)",
        tensor.device,
    )
    if backend is None:
        return "cuda"
    check_argument(backend in _VALID, "Invalid backend: %s (want one of %s)", backend, _VALID)
    return backend
