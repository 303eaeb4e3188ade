"""K4: the exclusive-scan kernel, a hand-written Hopper single-pass scan
with decoupled look-back (csrc/scan.cu, with the block scan of
csrc/fold.cuh and the status words of csrc/lookback.cuh).

Counterpart of glu_tpu/ops/_pallas_scan.py:131-243 (`pallas_exclusive_scan`,
body `_scan_kernel`): an exclusive scan of every partition of a (P, L)
tensor under sum, mul, min or max, on int32, uint32, float32 or float64,
seeded with the operator's identity in each partition. The TPU kernel
chains a carry through SMEM over a sequential grid of 2048 x 128 tiles and
needs the MXU byte-plane sum, the u32 -> i32 isomorphisms, a wide-column
sublane prefix and an identity-padded copy; none of that carries over.
CTAs run in no order on the GPU, so one launch of `glu_scan_pass` runs one
CTA per tile of TILE elements, each of which

  1. takes the next tile from a counter, so that the tiles before it in its
     partition belong to CTAs that are already running;
  2. reads its tile once and publishes the tile's aggregate; tile 0 of a
     partition publishes it as its inclusive value, its carry-in is the
     identity;
  3. looks back, 32 tiles at a time, for the nearest earlier tile of its
     partition that has published its inclusive value, and takes as its
     carry-in that value folded left to right with the aggregates it walked
     past, so that every tile's inclusive value is the sequential fold of
     the aggregates before it, whatever the timing: float results are the
     same from run to run;
  4. publishes its own inclusive value and writes carry op its local
     exclusive scan.

The only other device work is one `torch.zeros` of the status words and the
tile counter (`status_words`). The ragged tail of each partition is masked,
not padded.

`exclusive_scan_partitions` checks its argument, allocates with
torch.empty, launches on the current stream and counts its launches; given
a CPU tensor it runs the plain version `exclusive_scan_partitions_ref`.
"""

from __future__ import annotations

import torch

from ..utils.errors import check_argument
from ..utils.timing import start, stop
from ._common import cdiv, kernels, launch, on_cuda
from ._cuda_reduce import DTYPE_CODES, check_partitions
from .reduce import (
    ReduceOperator,
    _COMBINE,
    _cumulate,
    _fold,
    _from_work,
    _to_work,
    _work_identity,
)

# Scan tile, fixed at compile time in csrc/scan.cu (kScanTile) and checked
# when the library is loaded; the CPU tests shrink it.
TILE = 8192

# Launch count, bumped only where K4 is launched.
scan_launches = 0


def reset_launch_counts() -> None:
    global scan_launches
    scan_launches = 0


def launch_counts() -> dict:
    return {"exclusive_scan": scan_launches}


def status_words(tiles: int, dtype: torch.dtype) -> int:
    """64-bit status words of a scan of `tiles` tiles in all: one a tile,
    [flag | value], for the 4-byte types; a flag, the aggregate and the
    inclusive value for float64; then the tile counter."""
    return tiles * (3 if dtype == torch.float64 else 1) + 1


def _exclusive(w: torch.Tensor, op: ReduceOperator, dim: int, ident) -> torch.Tensor:
    """Exclusive scan of work-domain `w` along its last axis `dim`: the
    inclusive scan shifted one slot, the identity first."""
    inc = _cumulate(w, op, dim)
    first = torch.full(inc.shape[:-1] + (1,), ident, dtype=w.dtype, device=w.device)
    return torch.cat([first, inc[..., :-1]], dim=dim)


def tile_carries(aggregates: torch.Tensor, op: ReduceOperator, ident) -> torch.Tensor:
    """Each tile's carry-in from the (P, T) work-domain tile aggregates: the
    identity for tile 0 of a partition, agg[0] op agg[1] op ... op agg[j-1]
    for tile j, folded left to right as the kernel's look-back folds them.
    Float sums and products round at every step, so they are folded one
    tile at a time in that order; the other (op, dtype) pairs are exact in
    any order and take one cumulative scan."""
    if not (aggregates.dtype.is_floating_point and op in (ReduceOperator.SUM, ReduceOperator.MUL)):
        return _exclusive(aggregates, op, 1, ident)
    carries = torch.full_like(aggregates, ident)
    run = aggregates[:, 0]
    for j in range(1, aggregates.shape[1]):
        carries[:, j] = run
        run = _COMBINE[op](run, aggregates[:, j])
    return carries


def exclusive_scan_partitions_ref(x: torch.Tensor, op: ReduceOperator) -> torch.Tensor:
    """Plain version of K4, step by step: tiles of TILE elements (the ragged
    tail filled with the identity), the tile aggregates, each tile's carry-in
    the left fold of the aggregates before it in its partition
    (`tile_carries`), and each tile's exclusive scan combined with its
    carry-in."""
    parts, length = x.shape
    tiles = cdiv(length, TILE)
    w = _to_work(x, op)
    ident = _work_identity(op, x.dtype)
    pad = torch.full((parts, tiles * TILE - length), ident, dtype=w.dtype, device=x.device)
    tiled = torch.cat([w, pad], dim=1).view(parts, tiles, TILE)
    carries = tile_carries(_fold(tiled, op, 2), op, ident)
    out = _COMBINE[op](carries.unsqueeze(2), _exclusive(tiled, op, 2, ident))
    return _from_work(out.view(parts, tiles * TILE)[:, :length].contiguous(), op, x.dtype)


def exclusive_scan_partitions(x: torch.Tensor, op: ReduceOperator) -> torch.Tensor:
    """K4 (replaces _pallas_scan.py::pallas_exclusive_scan): exclusive scan
    of each row of a contiguous (P, L) tensor under `op`, in one launch.
    Returns a new (P, L) tensor of x's dtype."""
    global scan_launches
    opened = start("glu.engine.k4")
    try:
        check_partitions(x)
        check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
        if not on_cuda(x):
            return exclusive_scan_partitions_ref(x, op)
        parts, length = x.shape
        tiles = parts * cdiv(length, TILE)
        check_argument(tiles < 2**31, "too many tiles: %d partitions of %d", parts, length)
        lib, dev = kernels(scan_tile=TILE), x.device
        out = torch.empty_like(x)
        status = torch.zeros(status_words(tiles, x.dtype), dtype=torch.int64, device=dev)
        launch(lib, "glu_scan_pass", dev, x.data_ptr(), out.data_ptr(), parts, length, DTYPE_CODES[x.dtype], op.value,
               status.data_ptr())
        scan_launches += 1
        return out
    finally:
        stop(opened)