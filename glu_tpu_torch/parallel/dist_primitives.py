"""Distributed reduce and exclusive scan over a torch.distributed process group.

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
