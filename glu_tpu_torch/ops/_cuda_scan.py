"""K4: the exclusive-scan kernel, a hand-written Hopper reduce-then-scan
(csrc/scan.cu, with the fold of csrc/fold.cuh).

Counterpart of glu_tpu/ops/_pallas_scan.py:131-243 (`pallas_exclusive_scan`,
body `_scan_kernel`): an exclusive scan of every partition of a (P, L)
tensor under sum, mul, min or max, on int32, uint32, float32 or float64,
seeded with the operator's identity in each partition. The TPU kernel
chains a carry through SMEM over a sequential grid of 2048 x 128 tiles and
needs the MXU byte-plane sum, the u32 -> i32 isomorphisms, a wide-column
sublane prefix and an identity-padded copy; none of that carries over.
CTAs run in no order on the GPU, so the carry comes from a first pass:

  1. `glu_reduce_pass` with one CTA per tile: the aggregate of every tile
     of TILE elements, (P, T);
  2. `glu_scan_pass` without carries: one CTA per partition scans its T
     aggregates in order, from the identity: each tile's carry-in, (P, T);
  3. `glu_scan_pass` with those carries: one CTA per tile scans its tile
     (coalesced loads through shared memory, a per-thread serial scan, a
     warp __shfl_up_sync scan and a shared-memory scan of the warp totals),
     seeded with its carry-in, and writes the exclusive scan directly.

A partition that fits one tile (T == 1) needs only step 2 run on the input
itself: one launch. The ragged tail of each partition is masked, not
padded. Single-pass decoupled look-back is later work.

`exclusive_scan_partitions` checks its argument, allocates with
torch.empty, launches on the current stream and counts its launches; given
a CPU tensor it runs the plain version `exclusive_scan_partitions_ref`.
"""

from __future__ import annotations

import torch

from ..utils.errors import check_argument
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

# Scan tile, fixed at compile time in csrc/fold.cuh (kFoldTile) and checked
# when the library is loaded; the CPU tests shrink it.
TILE = 4096

# Launch count, bumped only where a kernel of K4 is launched.
scan_launches = 0


def reset_launch_counts() -> None:
    global scan_launches
    scan_launches = 0


def launch_counts() -> dict:
    return {"exclusive_scan": scan_launches}


def _exclusive(w: torch.Tensor, op: ReduceOperator, dim: int, ident) -> torch.Tensor:
    """Exclusive scan of work-domain `w` along its last axis `dim`: the
    inclusive scan shifted one slot, the identity first."""
    inc = _cumulate(w, op, dim)
    first = torch.full(inc.shape[:-1] + (1,), ident, dtype=w.dtype, device=w.device)
    return torch.cat([first, inc[..., :-1]], dim=dim)


def exclusive_scan_partitions_ref(x: torch.Tensor, op: ReduceOperator) -> torch.Tensor:
    """Plain version of K4, step by step: tiles of TILE elements (the ragged
    tail filled with the identity), the tile aggregates, their exclusive
    scan from the identity as each tile's carry-in, and each tile's
    exclusive scan combined with its carry-in."""
    parts, length = x.shape
    tiles = cdiv(length, TILE)
    w = _to_work(x, op)
    ident = _work_identity(op, x.dtype)
    pad = torch.full((parts, tiles * TILE - length), ident, dtype=w.dtype, device=x.device)
    tiled = torch.cat([w, pad], dim=1).view(parts, tiles, TILE)
    carries = _exclusive(_fold(tiled, op, 2), op, 1, ident)
    out = _COMBINE[op](carries.unsqueeze(2), _exclusive(tiled, op, 2, ident))
    return _from_work(out.view(parts, tiles * TILE)[:, :length].contiguous(), op, x.dtype)


def exclusive_scan_partitions(x: torch.Tensor, op: ReduceOperator) -> torch.Tensor:
    """K4 (replaces _pallas_scan.py::pallas_exclusive_scan): exclusive scan
    of each row of a contiguous (P, L) tensor under `op`. Returns a new
    (P, L) tensor of x's dtype."""
    global scan_launches
    check_partitions(x)
    check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
    if not on_cuda(x):
        return exclusive_scan_partitions_ref(x, op)
    parts, length = x.shape
    tiles = cdiv(length, TILE)
    check_argument(parts * tiles < 2**31, "too many tiles: %d partitions of %d", parts, length)
    lib, code, dev = kernels(fold_tile=TILE), DTYPE_CODES[x.dtype], x.device
    out = torch.empty_like(x)
    if tiles == 1:
        launch(lib, "glu_scan_pass", dev, x.data_ptr(), out.data_ptr(), parts, length, code, op.value, None)
        scan_launches += 1
        return out
    aggregates = torch.empty((parts, tiles), dtype=x.dtype, device=dev)
    carries = torch.empty_like(aggregates)
    launch(lib, "glu_reduce_pass", dev, x.data_ptr(), parts, length, tiles, code, op.value, aggregates.data_ptr())
    scan_launches += 1
    launch(lib, "glu_scan_pass", dev, aggregates.data_ptr(), carries.data_ptr(), parts, tiles, code, op.value, None)
    scan_launches += 1
    launch(lib, "glu_scan_pass", dev, x.data_ptr(), out.data_ptr(), parts, length, code, op.value,
           carries.data_ptr())
    scan_launches += 1
    return out
