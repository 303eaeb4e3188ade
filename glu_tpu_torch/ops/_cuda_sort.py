"""CUDA radix-sort engine: hand-written Hopper kernels of the stable LSD sort.

Counterpart of glu_tpu/ops/_pallas_sort.py with the same contract: a stable
LSD radix sort of u32 keys carrying a LIST of u32 payload streams, over the
key bit positions given LSB-first, grouped into passes of up to 8 bits. Words
travel as int32 bit patterns; the kernels read them as uint32_t.

The TPU engine needed 1-bit splits, lane gathers and a DMA splicer because
the TPU has no atomics and no scatter. The GPU has both, so each kernel is
written anew from what it computes (csrc/radix_sort.cu):

  ONCE per sort:
    `digit_histograms` -- one read of the keys counts the digit of every
        pass; an exclusive cumsum of each pass's counts gives each digit's
        global start (in the sort, the kernel's last CTA computes it).
  PASS over bits g (LSB-first, up to 8 bits, 256 bins):
    `onesweep_pass` -- one CTA per tile of TILE elements ranks the tile
        stably by the digit of bits g, finds how many equal digits the
        earlier tiles hold by a decoupled look-back over their published
        counts, and writes every stream to its final place: each word is
        read once and written once (K1 + glue + K2 of the TPU engine, fused).
  An input of at most SINGLE_TILE_MAX elements instead takes
    K3 `sort_single_tile` -- one CTA runs every pass (the same passes of up
        to 8 bits) in shared memory; above CTA_MAX elements a thread-block
        cluster of MAX_CLUSTER CTAs does, each ranking a slice in its own
        shared memory and copying each element to the CTA whose slice holds
        its rank.

`onesweep_sort` runs a whole multi-tile sort, the histogram and every pass,
in one call to the library. On the card it counts its passes in the counter
sort.onesweep_passes_3cta where an SM holds 3 CTAs of them at once (the
library's answer for the launch's stream count, asked once per device and
count); on the H100 the pass runs 2 CTAs an SM, so the counter stays at 0.

Each kernel has a wrapper that checks its arguments, allocates its outputs
with torch.empty, launches on the current stream and counts its launches,
inside a span glu.engine.k3 or glu.engine.onesweep (utils/timing.py), and a
plain torch version with the same contract (`*_ref`). A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises. `sort_pairs_single_tile` is K3's wrapper for one (keys,
values) pair that radix_sort has checked already: it only allocates and
launches. The plain version of a onesweep pass is built from the
stages of the TPU engine's pass (`group_tiles_ref`, `run_offsets`,
`scatter_runs_ref`), which the tests hold against the Pallas kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.errors import check_argument, fail
from ..utils.timing import count, declare, start, stop
from ._common import cdiv, kernels, launch, on_cuda

FIELD_BITS = 4          # key bits per num_step: the reference's 4-bit digit
MAX_FIELD_BITS = 8      # widest onesweep pass (BINS bins)
BINS = 1 << MAX_FIELD_BITS
MAX_PASSES = 32 // MAX_FIELD_BITS  # passes digit_histograms counts at once

# Kernel geometry, fixed at compile time in csrc/radix_sort.cu (kTile,
# kSingleMax, kSliceMax, kMaxCluster, kMaxStreams, kMaxBins); the library
# is checked against it when loaded. The plain versions read TILE,
# SINGLE_TILE_MAX, SLICE_MAX and CTA_MAX at call time, so the CPU tests
# shrink them to reach many tiles, ragged tails, the single-tile path and
# K3's clusters at tiny n.
TILE = 6144
SINGLE_TILE_MAX = 65536  # K3's limit: the JAX engine's single block, _FUSE_MAX_R x LANES
SLICE_MAX = 16384        # the most elements a CTA of K3 holds (its shared memory)
MAX_CLUSTER = 8          # the portable cluster size
MAX_STREAMS = 8

# The most elements K3 sorts on one CTA; above, on a cluster of MAX_CLUSTER
# CTAs, which on the H100 is the faster from here on and 1.5x slower at
# 256-4,096 elements (tools/k3_ctas.py; PERF.md).
CTA_MAX = 6144

declare("sort.onesweep_passes_3cta")  # onesweep passes launched where an SM holds 3 of their CTAs

# Launch counts of each kernel, bumped only where the kernel is launched.
digit_histograms_launches = 0
onesweep_pass_launches = 0
sort_single_tile_launches = 0


def reset_launch_counts() -> None:
    global digit_histograms_launches, onesweep_pass_launches, sort_single_tile_launches
    digit_histograms_launches = onesweep_pass_launches = sort_single_tile_launches = 0


def launch_counts() -> dict:
    return {
        "digit_histograms": digit_histograms_launches,
        "onesweep_pass": onesweep_pass_launches,
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


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


_lib = None  # the kernel library, its geometry checked, once loaded


def _sort_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = kernels(sort_tile=TILE, sort_single_tile_max=SINGLE_TILE_MAX, sort_slice_max=SLICE_MAX,
                       sort_max_cluster=MAX_CLUSTER, sort_max_streams=MAX_STREAMS, sort_bins=BINS)
    return _lib


def _launch(fn_name: str, device: torch.device, *args) -> None:
    launch(_sort_lib(), fn_name, device, *args)


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _plan_args(groups) -> tuple:
    """The passes over groups of key bits (LSB-first) in the form that
    glu_digit_histograms and glu_sort_single_tile take: every pass's bit
    positions one after another, the bit count of each pass, the pass
    count."""
    return _ints([b for g in groups for b in g]), _ints([len(g) for g in groups]), len(groups)


def _digits(words: torch.Tensor, positions) -> torch.Tensor:
    """int64 digit of each word formed by the bits at `positions` (LSB-first)."""
    d = torch.zeros(words.shape, dtype=torch.int64, device=words.device)
    for j, p in enumerate(positions):
        d |= ((words >> p) & 1).to(torch.int64) << j
    return d


# ---------------------------------------------------------------------------
# digit_histograms
# ---------------------------------------------------------------------------


def digit_histograms_ref(keys: torch.Tensor, groups) -> torch.Tensor:
    """Plain version of digit_histograms: one bincount per pass."""
    rows = [torch.bincount(_digits(keys, g), minlength=BINS) for g in groups]
    return torch.stack(rows).to(torch.int32)


def digit_histograms(keys: torch.Tensor, groups) -> torch.Tensor:
    """The counts half of K1 (_pallas_sort.py::_counts_row), for every pass
    of a sort in one read of the keys: hist[p][d] (int32, shape (len(groups),
    BINS)) is the number of keys whose digit of the bits groups[p] (1-8 of
    them, LSB-first) is d."""
    global digit_histograms_launches
    opened = start("glu.engine.onesweep")
    try:
        _check_streams(keys, [])
        groups = [_check_positions(g, MAX_FIELD_BITS) for g in groups]
        check_argument(1 <= len(groups) <= MAX_PASSES, "want 1..%d passes, got %d", MAX_PASSES, len(groups))
        if not on_cuda(keys):
            return digit_histograms_ref(keys, groups)
        hist = torch.zeros((len(groups), BINS), dtype=torch.int32, device=keys.device)
        _launch("glu_digit_histograms", keys.device, keys.data_ptr(), keys.numel(), *_plan_args(groups),
                hist.data_ptr())
        digit_histograms_launches += 1
        return hist
    finally:
        stop(opened)


# ---------------------------------------------------------------------------
# onesweep_pass and the stages of its plain version
# ---------------------------------------------------------------------------


def group_tiles_ref(keys: torch.Tensor, payloads, positions):
    """Stage 1 of a pass (what _pallas_sort.py::_group_pass computes): per
    tile, a stable sort on the digit, a gather, and the digit histogram.
    Returns (grouped keys, grouped payloads, counts[tile][digit] int32)."""
    n = keys.numel()
    bins = 1 << len(positions)
    tile = torch.arange(n, device=keys.device) // TILE
    slot = tile * bins + _digits(keys, positions)  # (tile, digit) in lexicographic order
    order = torch.sort(slot, stable=True).indices
    counts = torch.bincount(slot, minlength=cdiv(n, TILE) * bins).view(-1, bins)
    return keys[order], [v[order] for v in payloads], counts.to(torch.int32)


def run_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Stage 2: offsets[tile][d], where tile's run of digit d starts in the
    pass's output, i.e. the digit's base plus the same digit's counts in
    earlier tiles. That is one exclusive cumsum over the table in
    [digit][tile] order, the order of the runs in the output (the
    reference's scan of [digit][block], RadixSort.hpp:311; the run placement
    of _pallas_sort.py::_run_descriptors)."""
    tiles, bins = counts.shape
    by_digit = counts.t().reshape(-1)
    starts = torch.cumsum(by_digit, 0, dtype=torch.int32) - by_digit
    return starts.view(bins, tiles).t().contiguous()


def scatter_runs_ref(keys: torch.Tensor, payloads, counts: torch.Tensor, offsets: torch.Tensor, positions):
    """Stage 3 (what _pallas_sort.py::_splice_streams computes): every
    (digit, tile) run of stage 1's output, in every stream, goes to
    offsets[tile][digit]. Returns (keys, list of payloads)."""
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


def onesweep_pass_ref(keys: torch.Tensor, payloads, positions, digit_base: torch.Tensor):
    """Plain version of onesweep_pass, with the kernel's tiling and offset
    arithmetic: each tile grouped stably by digit; the place of its run of
    digit d is digit_base[d] plus d's counts in earlier tiles (what the
    look-back sums: run_offsets less its first row); then the scatter."""
    gk, gp, counts = group_tiles_ref(keys, payloads, positions)
    offsets = run_offsets(counts)
    offsets += digit_base - offsets[0]
    return scatter_runs_ref(gk, gp, counts, offsets, positions)


def onesweep_pass(keys: torch.Tensor, payloads, positions, digit_base: torch.Tensor):
    """K1 + K2 fused (replaces _pallas_sort.py::_group_pass, _run_descriptors
    and _splice_streams): one stable pass by the digit of the key bits at
    `positions` (1-8 of them, LSB-first), moving every payload stream alike.
    digit_base (int32, 2**len(positions)) is where each digit starts in the
    output: an exclusive cumsum of digit_histograms' row for this pass.
    Returns (keys, list of payloads)."""
    global onesweep_pass_launches
    opened = start("glu.engine.onesweep")
    try:
        streams = _check_streams(keys, payloads)
        positions = _check_positions(positions, MAX_FIELD_BITS)
        shape = (1 << len(positions),)
        check_argument(
            digit_base.dtype == torch.int32 and digit_base.is_contiguous() and tuple(digit_base.shape) == shape,
            "digit_base must be contiguous int32 of shape %s, got %s %s", shape, digit_base.dtype,
            tuple(digit_base.shape),
        )
        check_argument(digit_base.device == keys.device, "digit_base is on %s, keys on %s", digit_base.device,
                       keys.device)
        if not on_cuda(keys):
            return onesweep_pass_ref(keys, list(payloads), positions, digit_base)
        n = keys.numel()
        outs = [torch.empty_like(s) for s in streams]
        # a status word per (tile, bin), then the tile counter: zero at launch
        status = torch.zeros(cdiv(n, TILE) * BINS + 1, dtype=torch.int64, device=keys.device)
        _launch(
            "glu_onesweep_pass", keys.device, _pointers(streams), _pointers(outs), len(streams), n,
            _ints(positions), len(positions), digit_base.data_ptr(), status.data_ptr(),
        )
        onesweep_pass_launches += 1
        return outs[0], outs[1:]
    finally:
        stop(opened)


# ---------------------------------------------------------------------------
# K3: sort_single_tile
# ---------------------------------------------------------------------------


def sort_single_tile_ref(keys: torch.Tensor, payloads, positions):
    """Plain version of K3's function, pass by pass as the kernel runs them:
    one stable sort on the digit of each group of _pass_groups, LSB-first."""
    order = torch.arange(keys.numel(), device=keys.device)
    for g in _pass_groups(positions):
        order = order[torch.sort(_digits(keys[order], g), stable=True).indices]
    return keys[order], [v[order] for v in payloads]


def single_tile_ctas(n: int) -> int:
    """K3's CTAs for n elements: one up to CTA_MAX, else MAX_CLUSTER."""
    return 1 if n <= CTA_MAX else MAX_CLUSTER


def single_tile_slice(n: int, ctas: int) -> int:
    """The elements of each CTA's slice (the kernel's single_tile_slice): n
    split evenly, rounded up to whole 16-byte vectors, the last CTA taking
    what is left; n itself on one CTA."""
    return n if ctas == 1 else -(-cdiv(n, ctas) // 4) * 4


def sort_single_tile_cluster_ref(keys: torch.Tensor, payloads, positions, ctas: int):
    """Plain version of K3's arithmetic on `ctas` CTAs, pass by pass: CTA r
    holds the slots [r * slice, r * slice + slice) of the keys and of their
    source index; (a) each CTA counts its digits; (b) a digit's start in
    CTA r is its global start plus its count in the CTAs before r (one
    exclusive cumsum in (digit, CTA) order, run_offsets); (c) each slot goes
    to that start plus its rank among the CTA's equal digits in slot order
    (the kernel's warp, row, lane). The payloads are gathered by the final
    index."""
    n = keys.numel()
    slot = torch.arange(n, device=keys.device)
    cta = slot // single_tile_slice(n, ctas)
    index = slot  # the input position each slot holds
    for g in _pass_groups(positions):
        bins = 1 << len(g)
        group = cta * bins + _digits(keys, g)  # (CTA, digit), CTA-major
        counts = torch.bincount(group, minlength=ctas * bins)
        starts = run_offsets(counts.view(ctas, bins)).view(-1)
        in_group = torch.sort(group, stable=True).indices  # each group's slots in slot order
        first = torch.cumsum(counts, 0) - counts  # where each group starts in in_group
        rank = torch.empty_like(slot)
        rank[in_group] = starts[group[in_group]] + slot - first[group[in_group]]
        keys, index = keys.new_empty(n).index_put_((rank,), keys), index.new_empty(n).index_put_((rank,), index)
    return keys, [v[index] for v in payloads]


@functools.lru_cache(maxsize=64)
def _single_tile_plan(positions: tuple) -> tuple:
    """K3's checked bit positions and the C form of their passes, made once
    per tuple of positions: on the host they cost as much as the launch."""
    positions = _check_positions(positions, 32)
    return positions, _plan_args(_pass_groups(positions))


def sort_single_tile(keys: torch.Tensor, payloads, positions, ctas: int | None = None):
    """K3 (replaces _pallas_sort.py::_single_block_sort): the whole LSD sort
    by the bits at `positions` (1-32 of them, in passes of up to 8 bits) of
    at most SINGLE_TILE_MAX elements in one launch, on single_tile_ctas(n)
    CTAs (more than one: a thread-block cluster), or on `ctas` (1 to
    MAX_CLUSTER, each slice at most SLICE_MAX), which only the card's
    checks and timings give. Returns (keys, list of payloads)."""
    global sort_single_tile_launches
    opened = start("glu.engine.k3")
    try:
        streams = _check_streams(keys, payloads)
        positions, plan = _single_tile_plan(tuple(positions))
        n = keys.numel()
        check_argument(n <= SINGLE_TILE_MAX, "single-tile sort takes at most %d elements, got %d", SINGLE_TILE_MAX,
                       n)
        ctas = single_tile_ctas(n) if ctas is None else ctas
        check_argument(1 <= ctas <= MAX_CLUSTER and single_tile_slice(n, ctas) <= SLICE_MAX,
                       "K3 takes 1 to %d CTAs of at most %d elements, got %d elements on %d", MAX_CLUSTER,
                       SLICE_MAX, n, ctas)
        if not on_cuda(keys):
            return sort_single_tile_cluster_ref(keys, list(payloads), positions, ctas)
        outs = [torch.empty_like(s) for s in streams]
        _launch_single_tile(keys.device, streams, outs, n, plan, ctas)
        sort_single_tile_launches += 1
        return outs[0], outs[1:]
    finally:
        stop(opened)


def sort_pairs_single_tile(keys: torch.Tensor, values: torch.Tensor, positions: tuple):
    """K3 on one (keys, values) pair, without sort_single_tile's checks: for
    a caller that has checked both as contiguous 1-D CUDA tensors of 4-byte
    words, one device and 2 to SINGLE_TILE_MAX of them (radix_sort's direct
    path), with `positions` a tuple that _single_tile_plan takes. The
    outputs are empty_like the inputs, so they keep their dtype; the launch
    reads and writes the same words. Returns (keys, values)."""
    global sort_single_tile_launches
    opened = start("glu.engine.k3")
    try:
        n = keys.shape[0]
        out_k, out_v = torch.empty_like(keys), torch.empty_like(values)
        _launch_single_tile(keys.device, (keys, values), (out_k, out_v), n, _single_tile_plan(positions)[1],
                            single_tile_ctas(n))
        sort_single_tile_launches += 1
        return out_k, out_v
    finally:
        stop(opened)


def _launch_single_tile(device: torch.device, streams, outs, n: int, plan: tuple, ctas: int) -> None:
    """K3's launch: a (key, value) pair through glu_sort_pairs_single_tile,
    which takes the four pointers as integers, any other count of streams
    through glu_sort_single_tile's arrays of pointers."""
    if len(streams) == 2:
        launch(_sort_lib(), "glu_sort_pairs_single_tile", device, streams[0].data_ptr(), streams[1].data_ptr(),
               outs[0].data_ptr(), outs[1].data_ptr(), n, *plan, ctas)
    else:
        launch(_sort_lib(), "glu_sort_single_tile", device, _pointers(streams), _pointers(outs), len(streams), n,
               *plan, ctas)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _pass_groups(positions: tuple) -> list:
    """Passes of up to 8 bits, LSB-first: a full 32-bit sort is 4 passes,
    num_steps=3 (12 bits) 8 + 4. A stable LSD sort over the same positions
    gives the same permutation however they are grouped."""
    return [positions[i : i + MAX_FIELD_BITS] for i in range(0, len(positions), MAX_FIELD_BITS)]


def radix_sort_streams(keys: torch.Tensor, payloads, num_steps: int, bit_positions=None):
    """Stable LSD radix sort of int32-carried u32 keys with a LIST of payload
    streams permuted identically (counterpart of pallas_radix_sort_streams).
    Returns (sorted keys, list of permuted payloads): new tensors, unless
    there is nothing to sort (n <= 1 or no bits), when the inputs come back.
    The inputs are never modified.

    bit_positions (optional, LSB-first) restricts the sort to those key
    bits; None means bits 0..4*num_steps-1 (the reference contract).

    Up to SINGLE_TILE_MAX elements take K3 alone (above CTA_MAX on a
    cluster of CTAs); larger inputs take onesweep_sort: one
    digit_histograms launch and one onesweep_pass per group of 8 bits."""
    payloads = list(payloads)
    if bit_positions is None:
        positions = tuple(range(num_steps * FIELD_BITS))
    else:
        positions = tuple(int(b) for b in bit_positions)
    n = keys.numel()
    if not positions or n <= 1:
        return keys, payloads
    if n <= SINGLE_TILE_MAX:
        return sort_single_tile(keys, payloads, positions)
    return onesweep_sort(keys, payloads, positions)


_ctas_per_sm: dict = {}  # (device index, stream count) -> CTAs of a onesweep pass an SM holds


def onesweep_ctas_per_sm(device: torch.device, nstreams: int) -> int:
    """How many CTAs of a onesweep pass over nstreams streams an SM of
    `device` holds at once, asked of the library once per device and count."""
    key = (device.index, nstreams)
    ctas = _ctas_per_sm.get(key)
    if ctas is None:
        with torch.cuda.device(device):
            ctas = _sort_lib().glu_onesweep_ctas_per_sm(nstreams)
        if ctas < 0:
            fail("glu_onesweep_ctas_per_sm failed: %s (cudaError %d)", _sort_lib().glu_error_string(-ctas).decode(),
                 -ctas)
        _ctas_per_sm[key] = ctas
    return ctas


@functools.lru_cache(maxsize=64)
def _onesweep_plan(positions: tuple) -> tuple:
    """The checked passes of a multi-tile sort by `positions` and their C
    form, made once per tuple of positions."""
    groups = [_check_positions(g, MAX_FIELD_BITS) for g in _pass_groups(positions)]
    check_argument(1 <= len(groups) <= MAX_PASSES, "want 1..%d passes, got %d", MAX_PASSES, len(groups))
    return groups, _plan_args(groups)


def onesweep_sort(keys: torch.Tensor, payloads, positions):
    """The multi-tile sort: one digit_histograms launch for every pass, then
    one onesweep_pass per group of 8 key bits (LSB-first). On the card the
    whole sort is one library call (glu_onesweep_sort), so that the host
    pays one call a sort, not one a pass: the histogram's last CTA writes
    each pass's digit starts (no cumsum), each pass's status words are
    zeroed in the call, and the passes write the outputs and one scratch
    buffer in turn. Returns (keys, list of payloads), new tensors."""
    global digit_histograms_launches, onesweep_pass_launches
    payloads = list(payloads)
    if not on_cuda(keys):
        groups = _pass_groups(tuple(positions))
        hist = digit_histograms(keys, groups)
        bases = torch.cumsum(hist, 1, dtype=torch.int32) - hist
        for g, base in zip(groups, bases):
            # rebinding at once frees each pass's input as soon as it is consumed
            keys, payloads = onesweep_pass(keys, payloads, g, base[: 1 << len(g)])
        return keys, payloads
    opened = start("glu.engine.onesweep")
    try:
        streams = _check_streams(keys, payloads)
        groups, plan = _onesweep_plan(tuple(positions))
        n, lib, npasses = keys.numel(), _sort_lib(), len(groups)
        outs = [torch.empty_like(s) for s in streams]
        # one allocation: the scratch streams (more than one pass), then the
        # work words from a 256-byte boundary (an allocation's own start)
        tmp_words = -(-len(streams) * n // 64) * 64 if npasses > 1 else 0
        buf = torch.empty(tmp_words + lib.glu_onesweep_sort_work_words(n, npasses), dtype=torch.int32,
                          device=keys.device)
        base = buf.data_ptr()
        tmp = None
        if npasses > 1:
            tmp = (ctypes.c_void_p * len(streams))(*[base + 4 * n * i for i in range(len(streams))])
        launch(lib, "glu_onesweep_sort", keys.device, _pointers(streams), _pointers(outs), tmp, len(streams), n,
               *plan, base + 4 * tmp_words)
        digit_histograms_launches += 1
        onesweep_pass_launches += npasses
        if onesweep_ctas_per_sm(keys.device, len(streams)) >= 3:
            count("sort.onesweep_passes_3cta", npasses)
        return outs[0], outs[1:]
    finally:
        stop(opened)
