"""K5: the reduce kernel, a hand-written Hopper fold in one launch (csrc/reduce.cu).

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
