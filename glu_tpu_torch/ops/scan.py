"""Blelloch exclusive prefix scan (sum / mul / min / max), with batched
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
