"""Backend selection (counterpart of glu_tpu/ops/backend.py).

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
