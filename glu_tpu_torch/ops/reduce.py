"""Parallel reduce (sum / mul / min / max) of axis 0.

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
from .backend import resolve_backend


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
    x's device; the input is untouched. backend: None or "cuda" for the K5
    kernel, "torch" for one torch reduction.
    """
    check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
    check_argument(x.ndim in (1, 2), "reduce expects (N,) or (N, C) input, got shape %s", tuple(x.shape))
    check_argument(x.shape[0] >= 1, "reduce requires count >= 1")
    check_kernel_dtype(x.dtype)
    return _reduce_impl(x, op, resolve_backend(backend, x))


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
    picks each segment's last inclusive value.
    """
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
        data = buffer.data if isinstance(buffer, DeviceBuffer) else buffer
        check_argument(count >= 1, "Count must be >= 1")
        check_argument(count <= data.shape[0], "count %d exceeds buffer size %d", count, data.shape[0])
        result = reduce(data[:count], self.operator, backend=backend)
        if isinstance(buffer, DeviceBuffer):
            _words(data[0]).copy_(_words(result))
        return result
