"""Stable LSD radix sort of u32 key / u32 value pairs (4-bit digits, 8 passes).

Counterpart of glu_tpu/ops/radix_sort.py (reference glu/RadixSort.hpp:186-354)
for PyTorch on the GPU. Two backends:
  - "cuda", the radix engine of ops/_cuda_sort.py: per 4-bit pass a tile
    grouping kernel, a cumsum glue and a run scatter kernel, or one
    single-tile kernel for small inputs (on a CPU tensor, their plain torch
    versions);
  - "torch", the portable path: one stable `torch.sort` on the masked key
    (see _sort_torch: stable LSD passes compose to exactly that
    permutation).

Contract parity: stable; u32 keys with u32 values; `num_steps` runs a partial
sort (RadixSort.hpp:273,332): after k passes the pairs are stably sorted by
the low 4k key bits; count <= 1 early-exits (:278-279). The public functions
take and return `torch.uint32` tensors; inside, words travel as their int32
bit patterns, since torch implements shifts, sums and comparisons of uint32
only by promotion or not at all.
"""

from __future__ import annotations

import torch

from ..utils.buffers import DeviceBuffer, default_device
from ..utils.errors import check_argument
from .backend import resolve_backend

RADIX_BITS = 4  # digit width (reference RadixSort.hpp:303: u_radix_shift = step << 2)
RADIX = 1 << RADIX_BITS  # 16 buckets
NUM_PASSES = 32 // RADIX_BITS  # 8 passes over u32 keys

_SIGN = -(1 << 31)  # int32 sign bit: flipping it turns int32 order into u32 order


def _sort_torch(keys: torch.Tensor, payloads, nbits: int):
    """Portable whole sort of int32-carried words by their low `nbits` key
    bits: ONE stable torch.sort on the masked key (sign-flipped when all 32
    bits count, so that int32 order is u32 order), then a gather of every
    stream (counterpart of _sort_xla). k stable LSD passes over digits
    d0..d{k-1} ARE a stable sort by the concatenated value d{k-1}..d0, so
    the permutation is identical, partial num_steps sorts included."""
    composite = keys ^ _SIGN if nbits == 32 else keys & ((1 << nbits) - 1)
    order = torch.sort(composite, stable=True).indices
    return keys[order], [v[order] for v in payloads]


def _radix_sort_streams(keys, payloads, num_steps: int, backend: str):
    """Core entry: int32-carried keys + a list of payload streams permuted
    identically, sorted by the low 4*num_steps key bits. Returns new
    tensors; the inputs are not modified."""
    if backend == "cuda":
        from ._cuda_sort import radix_sort_streams

        return radix_sort_streams(keys, payloads, num_steps)
    return _sort_torch(keys, payloads, num_steps * RADIX_BITS)


def _norm_steps(num_steps) -> int:
    steps = NUM_PASSES if num_steps in (0, None) else int(num_steps)
    check_argument(0 < steps <= NUM_PASSES, "num_steps must be in 1..%d or 0 for all", NUM_PASSES)
    return steps


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
    reference's debugging affordance (RadixSort.hpp:273,332). The sort works
    out of place: the inputs are not modified (the JAX package donates them
    instead), and the results are new tensors except for count <= 1, where
    the inputs come back as they are.

    backend: None or "cuda" for the radix engine, "torch" for one stable
    torch.sort. `descending` and `bits` are not ported yet.
    """
    check_argument(keys.dim() == 1 and values.dim() == 1, "keys/values must be 1-D")
    check_argument(keys.shape == values.shape, "keys/values length mismatch")
    check_argument(keys.dtype == torch.uint32, "keys must be uint32, got %s", keys.dtype)
    check_argument(values.dtype == torch.uint32, "values must be uint32, got %s", values.dtype)
    check_argument(keys.device == values.device, "keys on %s, values on %s", keys.device, values.device)
    if descending or bits is not None:
        raise NotImplementedError(
            "radix_sort(descending=, bits=) is not ported yet (ROADMAP.md queue 1 item 4)"
        )
    if keys.shape[0] <= 1:  # already sorted x) (reference :278-279)
        return keys, values
    steps = _norm_steps(num_steps)
    b = resolve_backend(backend, keys)
    k = keys.view(torch.int32).contiguous()
    v = values.view(torch.int32).contiguous()
    out_k, out_vs = _radix_sort_streams(k, [v], steps, b)
    return out_k.view(torch.uint32), out_vs[0].view(torch.uint32)


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
        k = torch.zeros(count, dtype=torch.int32, device=default_device(device)).view(torch.uint32)
        b = resolve_backend(backend, k)
        key = (count, b, k.device)
        if count <= 1 or key in self._warm:
            return
        radix_sort(k, torch.zeros_like(k.view(torch.int32)).view(torch.uint32), backend=b)
        if k.is_cuda:
            torch.cuda.synchronize(k.device)
        self._warm.add(key)

    def __call__(
        self,
        key_buffer: DeviceBuffer | torch.Tensor,
        val_buffer: DeviceBuffer | torch.Tensor,
        count: int,
        num_steps: int = 0,
        *,
        backend: str | None = None,
    ):
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
