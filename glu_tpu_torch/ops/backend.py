"""Backend selection (counterpart of glu_tpu/ops/backend.py).

"cuda" means the hand-written kernels: the radix engine (ops/_cuda_sort.py),
the scan K4 (ops/_cuda_scan.py) and the reduce K5 (ops/_cuda_reduce.py). On
a CUDA tensor they launch, on a CPU tensor their plain torch versions run.
"torch" is the portable library path, the counterpart of the JAX package's
"xla" backend: one stable `torch.sort`, torch's cumulative scans, or one
torch reduction. The default is "cuda"; the cost-model router of the JAX
package is not ported yet.
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
