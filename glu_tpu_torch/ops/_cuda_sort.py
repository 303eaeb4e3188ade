"""CUDA radix-sort engine: hand-written Hopper kernels of the stable LSD sort.

Counterpart of glu_tpu/ops/_pallas_sort.py with the same contract: a stable
LSD radix sort of u32 keys carrying a LIST of u32 payload streams, over the
key bit positions given LSB-first, grouped into passes of 4 bits (one pass of
5-6 bits when that is all there is). Words travel as int32 bit patterns; the
kernels read them as uint32_t.

The TPU engine needed 1-bit splits, lane gathers and a DMA splicer because
the TPU has no atomics and no scatter. The GPU has both, so each kernel is
written anew from what it computes (csrc/radix_sort.cu):

  PASS over bits g:
    K1 `group_tiles` -- one CTA per tile of TILE elements groups the tile
        stably by the digit of bits g, for every stream, and writes the
        tile's row of the [tile][bin] counts.
    glue -- exclusive cumsums over that table in plain torch give each
        (digit, tile) run its global start (`run_offsets`).
    K2 `scatter_runs` -- one CTA per tile moves every run of every stream
        to its global place.
  An input of at most SINGLE_TILE_MAX elements instead takes
    K3 `sort_single_tile` -- one CTA runs every pass in shared memory.

Each kernel has a wrapper that checks its arguments, allocates its outputs
with torch.empty, launches on the current stream and counts its launches,
and a plain torch version with the same contract (`*_ref`). A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.errors import check_argument
from ..utils.log import vlog
from ._common import cdiv, kernels, launch, on_cuda

FIELD_BITS = 4          # bits per pass: one reference-visible 4-bit digit
MAX_FIELD_BITS = 6      # widest pass K1/K2 take (64 bins)

# Kernel geometry, fixed at compile time in csrc/radix_sort.cu (kTile,
# kSingleMax, kMaxStreams); the library is checked against it when loaded.
# The plain versions read these at call time, so the CPU tests shrink them
# to reach many tiles, ragged tails and the single-tile path at tiny n.
TILE = 4096
SINGLE_TILE_MAX = 16384
MAX_STREAMS = 8

# Launch counts of each kernel, bumped only where the kernel is launched.
group_tiles_launches = 0
scatter_runs_launches = 0
sort_single_tile_launches = 0


def reset_launch_counts() -> None:
    global group_tiles_launches, scatter_runs_launches, sort_single_tile_launches
    group_tiles_launches = scatter_runs_launches = sort_single_tile_launches = 0


def launch_counts() -> dict:
    return {
        "group_tiles": group_tiles_launches,
        "scatter_runs": scatter_runs_launches,
        "sort_single_tile": sort_single_tile_launches,
    }


# ---------------------------------------------------------------------------
# argument checks and launch plumbing
# ---------------------------------------------------------------------------


def _check_streams(keys: torch.Tensor, payloads) -> list:
    streams = [keys, *payloads]
    check_argument(
        len(streams) <= MAX_STREAMS,
        "at most %d payload streams, got %d", MAX_STREAMS - 1, len(streams) - 1,
    )
    for i, s in enumerate(streams):
        check_argument(s.dtype == torch.int32, "stream %d must hold int32 words, got %s", i, s.dtype)
        check_argument(s.dim() == 1 and s.is_contiguous(), "stream %d must be 1-D and contiguous", i)
        check_argument(s.shape == keys.shape, "stream %d length mismatch", i)
        check_argument(s.device == keys.device, "stream %d is on %s, keys on %s", i, s.device, keys.device)
    check_argument(0 < keys.numel() < 2**31 - TILE, "stream length %d out of range", keys.numel())
    return streams


def _check_positions(positions, max_count: int) -> tuple:
    positions = tuple(int(p) for p in positions)
    check_argument(
        1 <= len(positions) <= max_count, "want 1..%d bit positions, got %d", max_count, len(positions)
    )
    check_argument(all(0 <= p < 32 for p in positions), "bit positions must be in 0..31")
    check_argument(len(set(positions)) == len(positions), "bit positions must be distinct")
    return positions


def _check_table(t: torch.Tensor, name: str, keys: torch.Tensor, nbits: int) -> None:
    shape = (cdiv(keys.numel(), TILE), 1 << nbits)
    check_argument(t.dtype == torch.int32 and t.is_contiguous(), "%s must be contiguous int32", name)
    check_argument(tuple(t.shape) == shape, "%s must have shape %s, got %s", name, shape, tuple(t.shape))
    check_argument(t.device == keys.device, "%s is on %s, keys on %s", name, t.device, keys.device)


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch(fn_name: str, device: torch.device, *args) -> None:
    lib = kernels(sort_tile=TILE, sort_single_tile_max=SINGLE_TILE_MAX, sort_max_streams=MAX_STREAMS)
    launch(lib, fn_name, device, *args)


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _digits(words: torch.Tensor, positions) -> torch.Tensor:
    """int64 digit of each word formed by the bits at `positions` (LSB-first)."""
    d = torch.zeros(words.shape, dtype=torch.int64, device=words.device)
    for j, p in enumerate(positions):
        d |= ((words >> p) & 1).to(torch.int64) << j
    return d


# ---------------------------------------------------------------------------
# K1: group_tiles
# ---------------------------------------------------------------------------


def group_tiles_ref(keys: torch.Tensor, payloads, positions):
    """Plain version of K1: per tile, a stable sort on the digit, a gather,
    and the digit histogram."""
    n = keys.numel()
    bins = 1 << len(positions)
    tile = torch.arange(n, device=keys.device) // TILE
    slot = tile * bins + _digits(keys, positions)  # (tile, digit) in lexicographic order
    order = torch.sort(slot, stable=True).indices
    counts = torch.bincount(slot, minlength=cdiv(n, TILE) * bins).view(-1, bins)
    return keys[order], [v[order] for v in payloads], counts.to(torch.int32)


def group_tiles(keys: torch.Tensor, payloads, positions):
    """K1 (replaces _pallas_sort.py::_group_pass): group every tile of TILE
    elements stably by the digit of the key bits at `positions` (1-6 of
    them), moving the payload streams alike. Returns (grouped keys, list of
    grouped payloads, counts) with counts[tile][digit] int32."""
    global group_tiles_launches
    streams = _check_streams(keys, payloads)
    positions = _check_positions(positions, MAX_FIELD_BITS)
    if not on_cuda(keys):
        return group_tiles_ref(keys, list(payloads), positions)
    n = keys.numel()
    outs = [torch.empty_like(s) for s in streams]
    counts = torch.empty((cdiv(n, TILE), 1 << len(positions)), dtype=torch.int32, device=keys.device)
    _launch(
        "glu_group_tiles", keys.device, _pointers(streams), _pointers(outs), len(streams), n,
        _ints(positions), len(positions), counts.data_ptr(),
    )
    group_tiles_launches += 1
    return outs[0], outs[1:], counts


# ---------------------------------------------------------------------------
# glue: global start of every run
# ---------------------------------------------------------------------------


def run_offsets(counts: torch.Tensor) -> torch.Tensor:
    """offsets[tile][d]: where tile's run of digit d starts in the pass's
    output, i.e. the digit's base plus the same digit's counts in earlier
    tiles. That is one exclusive cumsum over the table in [digit][tile]
    order, the order of the runs in the output (the reference's scan of
    [digit][block], RadixSort.hpp:311; the run placement of
    _pallas_sort.py::_run_descriptors). Empty runs need no compaction here,
    since CTAs do not run in order."""
    tiles, bins = counts.shape
    by_digit = counts.t().reshape(-1)
    starts = torch.cumsum(by_digit, 0, dtype=torch.int32) - by_digit
    return starts.view(bins, tiles).t().contiguous()


# ---------------------------------------------------------------------------
# K2: scatter_runs
# ---------------------------------------------------------------------------


def scatter_runs_ref(keys: torch.Tensor, payloads, counts: torch.Tensor, offsets: torch.Tensor, positions):
    """Plain version of K2: computed destinations and an index write."""
    i = torch.arange(keys.numel(), device=keys.device)
    tile = i // TILE
    d = _digits(keys, positions)
    start = (torch.cumsum(counts, 1) - counts).to(torch.int64)  # in-tile start of each run
    dest = offsets.to(torch.int64)[tile, d] + (i - tile * TILE) - start[tile, d]
    outs = []
    for s in [keys, *payloads]:
        out = torch.empty_like(s)
        out[dest] = s
        outs.append(out)
    return outs[0], outs[1:]


def scatter_runs(keys: torch.Tensor, payloads, counts: torch.Tensor, offsets: torch.Tensor, positions):
    """K2 (replaces _pallas_sort.py::_splice_streams): move every (digit,
    tile) run of K1's output, in every stream, to offsets[tile][digit].
    Returns (keys, list of payloads) of the finished pass."""
    global scatter_runs_launches
    streams = _check_streams(keys, payloads)
    positions = _check_positions(positions, MAX_FIELD_BITS)
    _check_table(counts, "counts", keys, len(positions))
    _check_table(offsets, "offsets", keys, len(positions))
    if not on_cuda(keys):
        return scatter_runs_ref(keys, list(payloads), counts, offsets, positions)
    outs = [torch.empty_like(s) for s in streams]
    _launch(
        "glu_scatter_runs", keys.device, _pointers(streams), _pointers(outs), len(streams),
        keys.numel(), _ints(positions), len(positions), counts.data_ptr(), offsets.data_ptr(),
    )
    scatter_runs_launches += 1
    return outs[0], outs[1:]


# ---------------------------------------------------------------------------
# K3: sort_single_tile
# ---------------------------------------------------------------------------


def sort_single_tile_ref(keys: torch.Tensor, payloads, positions):
    """Plain version of K3: one stable sort on the digit of all positions."""
    order = torch.sort(_digits(keys, positions), stable=True).indices
    return keys[order], [v[order] for v in payloads]


def sort_single_tile(keys: torch.Tensor, payloads, positions):
    """K3 (replaces _pallas_sort.py::_single_block_sort): the whole LSD sort
    by the bits at `positions` (1-32 of them) of at most SINGLE_TILE_MAX
    elements in one launch. Returns (keys, list of payloads)."""
    global sort_single_tile_launches
    streams = _check_streams(keys, payloads)
    positions = _check_positions(positions, 32)
    check_argument(
        keys.numel() <= SINGLE_TILE_MAX,
        "single-tile sort takes at most %d elements, got %d", SINGLE_TILE_MAX, keys.numel(),
    )
    if not on_cuda(keys):
        return sort_single_tile_ref(keys, list(payloads), positions)
    outs = [torch.empty_like(s) for s in streams]
    _launch(
        "glu_sort_single_tile", keys.device, _pointers(streams), _pointers(outs), len(streams),
        keys.numel(), _ints(positions), len(positions),
    )
    sort_single_tile_launches += 1
    return outs[0], outs[1:]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _pass_groups(positions: tuple) -> list:
    """4-bit passes, LSB-first; 5-6 bits in all take one wide pass (one
    scatter instead of two), as the JAX engine groups them."""
    if FIELD_BITS < len(positions) <= MAX_FIELD_BITS:
        return [positions]
    return [positions[i : i + FIELD_BITS] for i in range(0, len(positions), FIELD_BITS)]


def radix_sort_streams(keys: torch.Tensor, payloads, num_steps: int, bit_positions=None):
    """Stable LSD radix sort of int32-carried u32 keys with a LIST of payload
    streams permuted identically (counterpart of pallas_radix_sort_streams).
    Returns (sorted keys, list of permuted payloads): new tensors, unless
    there is nothing to sort (n <= 1 or no bits), when the inputs come back.
    The inputs are never modified.

    bit_positions (optional, LSB-first) restricts the sort to those key
    bits; None means bits 0..4*num_steps-1 (the reference contract)."""
    payloads = list(payloads)
    if bit_positions is None:
        positions = tuple(range(num_steps * FIELD_BITS))
    else:
        positions = tuple(int(b) for b in bit_positions)
    n = keys.numel()
    if not positions or n <= 1:
        return keys, payloads
    if n <= SINGLE_TILE_MAX:
        vlog("radix_sort n=%d: single tile, streams=%d bits=%d", n, 1 + len(payloads), len(positions))
        return sort_single_tile(keys, payloads, positions)
    groups = _pass_groups(positions)
    vlog(
        "radix_sort n=%d: tiles=%d streams=%d passes=%d",
        n, cdiv(n, TILE), 1 + len(payloads), len(groups),
    )
    for g in groups:
        # rebinding at once frees each pass's input as soon as it is consumed
        keys, payloads, counts = group_tiles(keys, payloads, g)
        keys, payloads = scatter_runs(keys, payloads, counts, run_offsets(counts), g)
    return keys, payloads
