"""K5: the reduce kernel, a hand-written Hopper fold (csrc/reduce.cu).

Counterpart of glu_tpu/ops/_pallas_reduce.py:52-150 (`_pallas_reduce_flat`,
body `_reduce_kernel`): it folds every partition of a (P, L) tensor to one
value under sum, mul, min or max, on int32, uint32, float32 or float64. The
TPU kernel walks its tiles in one sequential grid into an (8, 128)
accumulator and needs the u32 -> i32 isomorphisms and a mul butterfly for
Mosaic; none of that carries over. On the GPU:

  launch 1 -- `ctas_per_partition` CTAs per partition fold tiles of TILE
      elements, CTA c taking tiles c, c + ctas, ...: coalesced loads
      (16 bytes a thread where aligned), a per-thread fold, a warp-shuffle
      tree and a shared-memory tree; each CTA writes one partial to (P, ctas);
  launch 2 -- the same kernel folds each partition's partials to (P,).

No atomics (mul has none), so float results are the same from run to run.
The ragged last tile is masked, not padded. (N, C) vector inputs come in as
one (C, N) copy, so no strided variant is needed.

`reduce_partitions` checks its argument, allocates with torch.empty,
launches on the current stream and counts its launches; given a CPU tensor
it runs the plain version `reduce_partitions_ref` instead.
"""

from __future__ import annotations

import torch

from ..utils.errors import check_argument
from ._common import cdiv, kernels, launch, on_cuda
from .reduce import ReduceOperator, _fold, _from_work, _to_work, _work_identity, check_kernel_dtype

# Fold tile, fixed at compile time in csrc/fold.cuh (kFoldTile) and checked
# when the library is loaded. The plain version reads it at call time, so
# the CPU tests shrink it to reach many tiles and ragged tails at tiny n.
TILE = 4096
# Launch 1's CTAs in all, split over the partitions: enough to fill the card
# (132 SMs, 8 CTAs of 256 threads each) at any P.
MAX_CTAS = 1056

DTYPE_CODES = {torch.int32: 0, torch.uint32: 1, torch.float32: 2, torch.float64: 3}

# Launch count, bumped only where the kernel is launched.
reduce_launches = 0


def reset_launch_counts() -> None:
    global reduce_launches
    reduce_launches = 0


def launch_counts() -> dict:
    return {"reduce": reduce_launches}


def check_partitions(x: torch.Tensor) -> None:
    check_kernel_dtype(x.dtype)
    check_argument(x.dim() == 2 and x.is_contiguous(), "want a contiguous (P, L) tensor, got %s", tuple(x.shape))
    check_argument(x.shape[0] >= 1 and x.shape[1] >= 1, "want P >= 1 and L >= 1, got %s", tuple(x.shape))


def ctas_per_partition(parts: int, length: int) -> int:
    return max(1, min(cdiv(length, TILE), MAX_CTAS // parts))


def reduce_partitions_ref(x: torch.Tensor, op: ReduceOperator) -> torch.Tensor:
    """Plain version of K5: every partition cut into tiles of TILE elements
    (the ragged tail filled with the identity), each tile folded, then the
    tile aggregates folded."""
    parts, length = x.shape
    tiles = cdiv(length, TILE)
    w = _to_work(x, op)
    pad = torch.full((parts, tiles * TILE - length), _work_identity(op, x.dtype), dtype=w.dtype, device=x.device)
    aggregates = _fold(torch.cat([w, pad], dim=1).view(parts, tiles, TILE), op, 2)
    return _from_work(_fold(aggregates, op, 1), op, x.dtype)


def reduce_partitions(x: torch.Tensor, op: ReduceOperator) -> torch.Tensor:
    """K5 (replaces _pallas_reduce.py::_pallas_reduce_flat): fold each row
    of a contiguous (P, L) tensor under `op`. Returns (P,) of x's dtype."""
    global reduce_launches
    check_partitions(x)
    check_argument(isinstance(op, ReduceOperator), "Invalid operator: %s", op)
    if not on_cuda(x):
        return reduce_partitions_ref(x, op)
    parts, length = x.shape
    ctas = ctas_per_partition(parts, length)
    partials = torch.empty((parts, ctas), dtype=x.dtype, device=x.device)
    out = torch.empty((parts,), dtype=x.dtype, device=x.device)
    lib, code = kernels(fold_tile=TILE), DTYPE_CODES[x.dtype]
    launch(lib, "glu_reduce_pass", x.device, x.data_ptr(), parts, length, ctas, code, op.value, partials.data_ptr())
    reduce_launches += 1
    launch(lib, "glu_reduce_pass", x.device, partials.data_ptr(), parts, ctas, 1, code, op.value, out.data_ptr())
    reduce_launches += 1
    return out
