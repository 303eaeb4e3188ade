"""Stable LSD radix sort of u32 key / u32 value pairs (the reference's 4-bit
digits, 8 steps) and its variants: keys-only, any number of payloads,
argsort, f32 / i32 / u64 keys, `descending=`, `bits=` and segmented sorts.

Counterpart of glu_tpu/ops/radix_sort.py (reference glu/RadixSort.hpp:186-354)
for PyTorch on the GPU. Two backends:
  - "cuda", the radix engine of ops/_cuda_sort.py: one histogram kernel for
    every pass, then one fused onesweep kernel per 8 key bits (4 for a full
    sort; num_steps=k sorts 4k bits; bits= sorts exactly the bits given), or
    one single-tile kernel for small inputs (on a CPU tensor, their plain
    torch versions);
  - "torch", the portable path: one stable `torch.sort` on the compacted
    key, int64 for two-word keys (see _sort_torch: stable LSD passes compose
    to exactly that permutation).

Every variant is a composition over the same engine: float and signed keys
through order-preserving bijections onto u32, descending order through the
complement, u64 keys and segments through two chained sorts, more payloads
than a pass moves through an index payload and gathers, and bits="auto"
through one histogram launch that finds the varying key bits.

Contract parity: stable; u32 keys with u32 values; `num_steps` runs a partial
sort (RadixSort.hpp:273,332): after k passes the pairs are stably sorted by
the low 4k key bits; count <= 1 early-exits (:278-279). The public functions
take and return torch tensors of the JAX package's dtypes (`torch.uint32`
for u32); inside, u32 words reach the engine as they are, and wherever torch
computes on them they travel as their int32 bit patterns (`_words`), since
torch implements shifts, sums, comparisons and gathers of uint32 only by
promotion or not at all. The sorts work out of place: the inputs are never
modified (the JAX package donates them instead).
"""

from __future__ import annotations

import torch

from ..utils import timing
from ..utils.buffers import DeviceBuffer, default_device
from ..utils.errors import check_argument
from ..utils.timing import start_call, stop
from . import _cuda_sort as cs
from .backend import resolve_backend

RADIX_BITS = 4  # digit width (reference RadixSort.hpp:303: u_radix_shift = step << 2)
RADIX = 1 << RADIX_BITS  # 16 buckets
NUM_PASSES = 32 // RADIX_BITS  # 8 passes over u32 keys
FULL = tuple(range(32))

_SIGN = -(1 << 31)  # int32 sign bit: flipping it turns int32 order into u32 order
_BYTES = tuple(tuple(range(b, b + 8)) for b in range(0, 32, 8))  # the envelope's 4 digit groups
_STEP_BITS = tuple(tuple(range(s * RADIX_BITS)) for s in range(NUM_PASSES + 1))  # the key bits of num_steps=s

timing.declare("sort.two_word")  # two-word sorts (u64 keys, segments) chained on the engine
timing.declare("sort.two_word_passes")  # the 8-bit passes of both words of those sorts


# ---------------------------------------------------------------------------
# the sorts on int32-carried words
# ---------------------------------------------------------------------------


def _compact(words: torch.Tensor, positions: tuple) -> torch.Tensor:
    """The key bits at `positions` (LSB-first significance) gathered into the
    low bits of one int32-carried u32 word: the key itself for the full
    cover, the masked key for contiguous low bits."""
    if positions == FULL:
        return words
    if positions == tuple(range(len(positions))):
        return words & ((1 << len(positions)) - 1)
    c = torch.zeros_like(words)
    for j, p in enumerate(positions):
        c |= ((words >> p) & 1) << j
    return c


def _sort_torch(keys: torch.Tensor, payloads, positions: tuple):
    """Portable whole sort of 4-byte words by the key bits at `positions`:
    ONE stable torch.sort on the compacted key, sign-flipped so that int32
    order is u32 order, then a gather of every stream (counterpart of
    _sort_xla), as int32 words. k stable LSD passes over digits d0..d{k-1}
    ARE a stable sort by the concatenated value d{k-1}..d0, so the
    permutation is identical, partial and pruned sorts included."""
    keys, payloads = _words(keys), [_words(v) for v in payloads]
    order = torch.sort(_compact(keys, positions) ^ _SIGN, stable=True).indices
    return keys[order], [v[order] for v in payloads]


def _radix_sort_streams(keys: torch.Tensor, payloads: list, positions: tuple, backend: str):
    """Core entry: u32 keys + a list of payload streams permuted
    identically, as 4-byte words (uint32, or int32 bit patterns), stably
    sorted by the key bits at `positions` (LSB-first).
    Returns new tensors, except where there is nothing to sort (no
    positions, n <= 1): then the inputs come back. The inputs are not
    modified.

    A onesweep pass and K3 move at most MAX_STREAMS - 1 payloads (the JAX
    engine any number): past that the engine sorts the keys with an index
    payload, and every payload is gathered by it."""
    if not positions or keys.numel() <= 1:
        return keys, payloads
    if backend == "torch":
        return _sort_torch(keys, payloads, positions)
    if len(payloads) < cs.MAX_STREAMS:
        return cs.sort_streams(keys, payloads, positions)
    iota = torch.arange(keys.numel(), dtype=torch.int32, device=keys.device)
    out_k, (order,) = cs.sort_streams(keys, [iota], positions)
    return out_k, [_words(v).index_select(0, order) for v in payloads]


def _sort_two_words(major, minor, major_pos: tuple, minor_pos: tuple, payloads, backend: str):
    """Stable sort by the pair (major word, minor word), each word by the
    bits at its positions: u64 keys as (hi, lo), segments as (segment id,
    key). Returns (major, minor, list of payloads).

    "cuda" chains two engine sorts (LSD over the words): the minor word
    carrying (major, payloads), then the major word carrying (minor,
    payloads), whose stability keeps the minor order within equal major
    words. "torch" sorts once on the int64 of the two compacted words.

    The engine's chain counts itself (`sort.two_word`, and its passes in
    `sort.two_word_passes`) and opens a span around each of its two sorts
    (`glu.two_word.minor`, `glu.two_word.major`)."""
    if backend == "torch":
        wide = ((_compact(major, major_pos) ^ _SIGN).to(torch.int64) << 32) | (
            _compact(minor, minor_pos).to(torch.int64) & 0xFFFFFFFF
        )
        order = torch.sort(wide, stable=True).indices
        return major[order], minor[order], [v[order] for v in payloads]
    timing.count("sort.two_word")
    timing.count("sort.two_word_passes", len(cs._pass_groups(minor_pos)) + len(cs._pass_groups(major_pos)))
    opened = timing.start("glu.two_word.minor")
    try:
        minor, (major, *payloads) = _radix_sort_streams(minor, [major, *payloads], minor_pos, backend)
    finally:
        stop(opened)
    opened = timing.start("glu.two_word.major")
    try:
        major, (minor, *payloads) = _radix_sort_streams(major, [minor, *payloads], major_pos, backend)
    finally:
        stop(opened)
    return major, minor, payloads


# ---------------------------------------------------------------------------
# bits: the varying-bit envelope and the positions to sort
# ---------------------------------------------------------------------------


def _key_envelope(words: torch.Tensor, backend: str) -> torch.Tensor:
    """(OR, AND) of int32-carried words, as two u32 values in an int64
    tensor on their device (no host sync): the bits where OR ^ AND is set
    vary. Envelopes of several arrays fold into that of their union by OR
    and AND (the distributed sort's bits="auto"); an empty array's is the
    identity (0, 0xFFFFFFFF).

    "cuda": one digit_histograms launch over the four bytes (K1's counts,
    one read of the keys); bit b of byte j is set in the OR iff some byte
    value that occurs (count > 0) has it, and clear in the AND iff some
    byte value that occurs lacks it. "torch": the OR of every key's
    difference from the first, folded by halves: OR = first | diff, AND =
    first & ~diff."""
    dev = words.device
    if words.numel() == 0:
        if dev.type == "cuda":
            timing.count("host_syncs.bits_auto")  # the identity copied onto the card waits for the stream
        return torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64, device=dev)
    if backend == "torch" or words.numel() == 1:
        d = words ^ words[0]
        while d.numel() > 1:
            half = d.numel() // 2
            top = d[:half] | d[half : 2 * half]
            if d.numel() % 2:
                top[:1] |= d[-1:]
            d = top
        first = words[:1]
        return torch.cat([first | d, first & ~d]).to(torch.int64) & 0xFFFFFFFF
    occurs = (cs.digit_histograms(words, _BYTES) > 0)[:, None, :]  # (byte, 1, value)
    value = torch.arange(256, device=dev)
    has = ((value >> torch.arange(8, device=dev)[:, None]) & 1).bool()  # (bit, value)
    some_has, some_lacks = (occurs & has).any(2), (occurs & ~has).any(2)  # (byte, bit): key bit 8 * byte + bit
    weight = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(32, device=dev)
    return torch.stack([(some_has.reshape(32) * weight).sum(), (~some_lacks.reshape(32) * weight).sum()])


def _envelope_positions(or_word: int, and_word: int) -> tuple:
    """The varying bit positions, ascending, of an (OR, AND) envelope."""
    mask = or_word ^ and_word
    return tuple(b for b in range(32) if (mask >> b) & 1)


def _varying_bits(words: torch.Tensor, backend: str) -> tuple:
    """Positions of the bits of int32-carried words where they disagree:
    the set bits of OR(keys) ^ AND(keys) (_key_envelope), fetched to the
    host, which synchronises it with the device."""
    if words.numel() <= 1:
        return ()
    with timing.span("glu.bits_auto"):
        envelope = _key_envelope(words, backend).tolist()
        timing.count("host_syncs.bits_auto")
    return _envelope_positions(*envelope)


def varying_key_bits(keys: torch.Tensor) -> tuple:
    """Positions (ascending) of the key bits that actually VARY across
    `keys` (1-D torch.uint32): the bit set a stable radix sort must process;
    constant bits never change relative order. One histogram launch over the
    four bytes of the keys (its plain version on a CPU tensor) and a 4-byte
    fetch to the host, which synchronises it with the device (so it cannot be
    captured in a CUDA graph). Feed the result to radix_sort(..., bits=...),
    or pass bits="auto" to fuse the two steps, to sort in ceil(len(bits)/8)
    onesweep passes instead of 4."""
    call = start_call("glu.varying_key_bits")
    try:
        check_argument(keys.dim() == 1, "keys must be 1-D")
        check_argument(keys.dtype == torch.uint32, "keys must be uint32, got %s", keys.dtype)
        return _varying_bits(keys.view(torch.int32).contiguous(), resolve_backend(None, keys))
    finally:
        stop(call)


def _norm_steps(num_steps) -> int:
    steps = NUM_PASSES if num_steps in (0, None) else int(num_steps)
    check_argument(0 < steps <= NUM_PASSES, "num_steps must be in 1..%d or 0 for all", NUM_PASSES)
    return steps


def _norm_bits(bits, words: torch.Tensor, num_steps, backend):
    """Resolve the `bits` parameter: None -> None (the num_steps contract),
    "auto" -> the varying bits of `words` (a host sync), an iterable ->
    validated positions. Mutually exclusive with a partial num_steps.
    `backend` is the caller's: the envelope of a CUDA tensor is found by
    the kernel unless "torch" was asked for, whatever the router picks."""
    if bits is None:
        return None
    check_argument(num_steps in (0, None, NUM_PASSES), "bits cannot be combined with a partial num_steps")
    if isinstance(bits, str):
        check_argument(bits == "auto", 'bits must be None, "auto", or bit positions')
        return _varying_bits(_words(words), resolve_backend(backend, words))
    positions = tuple(int(b) for b in bits)
    for p in positions:
        check_argument(0 <= p < 32, "bit positions must be in 0..31, got %d", p)
    check_argument(len(set(positions)) == len(positions), "bit positions must be distinct")
    return positions


def _router():
    """ops/router.py, imported at the first call that routes and kept: an
    import with this module would make `python -m glu_tpu_torch.ops.router`
    load the router twice, and one inside each call costs as much as a
    check."""
    global _ROUTER
    if _ROUTER is None:
        from . import router

        _ROUTER = router
    return _ROUTER


_ROUTER = None


def _sort_words(words, payloads: list, backend, *, num_steps=0, descending: bool = False, bits=None):
    """Sort u32 keys (already in their sortable form) with a list of
    payloads, as contiguous 4-byte words (uint32, or int32 bit patterns):
    high to low through the complement, which keeps ties in input order and
    the set of varying bits; `bits` refers to the complemented key. The bit
    positions come first, then the route (ops/router.py), on (n, payloads,
    passes, whether the bits are the whole key): bits="auto" has
    synchronised the host by then. Returns (keys, list of payloads), each in
    its input's dtype or as int32 words."""
    steps = _norm_steps(num_steps)
    if descending:
        words = ~_words(words)
    positions = _STEP_BITS[steps] if bits is None else _norm_bits(bits, words, num_steps, backend)
    router = _router()
    route = router._sort_backend(backend, words, words.numel(), len(payloads), router._npasses_of(positions),
                                 positions == FULL)
    out_k, outs = _radix_sort_streams(words, payloads, positions, route)
    return (~out_k if descending else out_k), outs


# ---------------------------------------------------------------------------
# public functions
# ---------------------------------------------------------------------------


def _check_inputs(keys: torch.Tensor, key_dtype: torch.dtype, **payloads) -> None:
    """keys of key_dtype and torch.uint32 payloads: 1-D, one length, one device."""
    check_argument(keys.dim() == 1, "keys must be 1-D")
    check_argument(keys.dtype == key_dtype, "keys must be %s, got %s", key_dtype, keys.dtype)
    for name, p in payloads.items():
        check_argument(p.shape == keys.shape, "%s must be 1-D and as long as the keys", name)
        check_argument(p.dtype == torch.uint32, "%s must be uint32, got %s", name, p.dtype)
        check_argument(p.device == keys.device, "keys on %s, %s on %s", keys.device, name, p.device)


def _words(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32).contiguous()


def _u32(w: torch.Tensor) -> torch.Tensor:
    return w if w.dtype == torch.uint32 else w.view(torch.uint32)


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
    reference's debugging affordance (RadixSort.hpp:273,332).
    descending=True sorts keys high to low, still stable (ties keep their
    input order), through complemented keys, and requires the full sort.

    bits (an extension beyond the reference): "auto" finds the key bits
    that actually vary (one histogram launch and a 4-byte fetch, which
    synchronises the host and cannot be captured in a CUDA graph) and sorts
    ONLY those: an exact, stable full sort in ceil(v/8) onesweep passes when
    v bits vary. An iterable of bit positions (LSB-first significance,
    distinct, in 0..31) sorts by exactly that bit sequence; the result is a
    full sort iff the set covers every varying bit. Incompatible with a
    partial num_steps.

    The sort works out of place: the inputs are not modified, and the
    results are new tensors except where there is nothing to sort (n <= 1,
    bits=() or bits="auto" on equal keys), when `values` (and, ascending,
    `keys`) come back as they are. backend: "cuda" for the radix engine,
    "torch" for one stable torch.sort, None for the override
    GLU_TPU_TORCH_BACKEND or, on a CUDA tensor, the router's choice by the
    card's cost model (ops/router.py; on a CPU tensor "cuda"). The route is
    chosen after bits="auto" has found the bits to sort.
    """
    call = start_call("glu.radix_sort")
    try:
        _check_inputs(keys, torch.uint32, values=values)
        check_argument(
            not (descending and num_steps not in (0, None, NUM_PASSES)),
            "descending requires the full sort (num_steps=0)",
        )
        if keys.shape[0] <= 1:  # already sorted x) (reference :278-279)
            return keys, values
        out_k, (out_v,) = _sort_words(
            keys.contiguous(), [values.contiguous()], backend, num_steps=num_steps, descending=descending, bits=bits
        )
        return _u32(out_k), _u32(out_v)
    finally:
        stop(call)


def radix_sort_keys(keys: torch.Tensor, num_steps: int = 0, *, backend: str | None = None, bits=None):
    """Stably sort u32 keys only (the reference mandates values,
    README.md:88-89; keys-only is a natural extension with the same
    kernels). See radix_sort for `num_steps` and `bits`."""
    call = start_call("glu.radix_sort_keys")
    try:
        _check_inputs(keys, torch.uint32)
        if keys.shape[0] <= 1:
            return keys
        out_k, _ = _sort_words(keys.contiguous(), [], backend, num_steps=num_steps, bits=bits)
        return _u32(out_k)
    finally:
        stop(call)


def radix_sort_multi(keys: torch.Tensor, payloads, num_steps: int = 0, *, backend: str | None = None, bits=None):
    """Stably sort u32 keys with ANY number of u32 payload streams permuted
    identically: the N-stream generalization of the reference's mandatory
    (key, value) contract (README.md:88-89). Returns (sorted_keys,
    tuple_of_permuted_payloads).

    Up to 7 payloads ride the engine's passes with the keys (one read and
    one write of every stream a pass); past 7 the keys carry an index
    payload and every payload is gathered by it once. See radix_sort for
    `num_steps`, `bits` and when inputs come back as they are."""
    call = start_call("glu.radix_sort_multi")
    try:
        payloads = tuple(payloads)
        _check_inputs(keys, torch.uint32, **{f"payload {i}": p for i, p in enumerate(payloads)})
        if keys.shape[0] <= 1:
            return keys, payloads
        out_k, outs = _sort_words(keys.contiguous(), [p.contiguous() for p in payloads], backend, num_steps=num_steps,
                                  bits=bits)
        return _u32(out_k), tuple(_u32(p) for p in outs)
    finally:
        stop(call)


def radix_argsort(keys: torch.Tensor, *, backend: str | None = None, descending: bool = False, bits=None):
    """Stable argsort of u32 keys: returns (sorted_keys, order) where
    `order` (torch.uint32) is the permutation such that sorted_keys ==
    keys[order]: the index-payload composition every "give me the
    permutation" caller otherwise writes by hand (the reference has no
    argsort; test/radix_sort_tests.cpp:111-141 sorts the user's own iota).
    Supports descending= and bits= as radix_sort does."""
    call = start_call("glu.radix_argsort")
    try:
        _check_inputs(keys, torch.uint32)
        n = keys.shape[0]
        check_argument(n < (1 << 32), "argsort indices exceed uint32")
        iota = _u32(torch.arange(n, dtype=torch.int32, device=keys.device))
        if n <= 1:
            return keys, iota
        return radix_sort(keys, iota, backend=backend, descending=descending, bits=bits)
    finally:
        stop(call)


def _f32_to_sortable(k: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection f32 -> u32 on int32 bit patterns (IEEE-754
    total order): flip every bit of a negative, the sign bit of the rest."""
    return k ^ ((k >> 31) | _SIGN)


def _sortable_to_f32(u: torch.Tensor) -> torch.Tensor:
    return (u ^ ((~u >> 31) | _SIGN)).view(torch.float32)


def radix_sort_f32(
    keys: torch.Tensor,
    values: torch.Tensor,
    *,
    backend: str | None = None,
    descending: bool = False,
    bits=None,
):
    """Stably sort (f32 key, u32 value) pairs, an extension beyond the
    reference, which sorts u32 keys only (reference README.md:88-89).

    Keys ride the same u32 engine through the standard order-preserving bit
    transform (negatives fully flipped, the rest sign-flipped), which
    realizes IEEE-754 total order: -inf < ... < -0.0 < +0.0 < ... < +inf,
    with NaNs at the ends by their sign bit. The keys are compared as bit
    patterns, never as floats. `descending` and `bits` refer to the
    TRANSFORMED keys (see radix_sort)."""
    call = start_call("glu.radix_sort_f32")
    try:
        _check_inputs(keys, torch.float32, values=values)
        if keys.shape[0] <= 1:
            return keys, values
        out_k, (out_v,) = _sort_words(
            _f32_to_sortable(keys.contiguous().view(torch.int32)), [values.contiguous()], backend,
            descending=descending, bits=bits,
        )
        return _sortable_to_f32(out_k), _u32(out_v)
    finally:
        stop(call)


def radix_sort_i32(
    keys: torch.Tensor,
    values: torch.Tensor,
    *,
    backend: str | None = None,
    descending: bool = False,
    bits=None,
):
    """Stably sort (i32 key, u32 value) pairs, an extension beyond the
    reference, which sorts u32 keys only (reference README.md:88-89).

    Signed order rides the u32 engine through the sign-bit flip (an
    order-preserving bijection i32 -> u32: INT32_MIN maps to 0, INT32_MAX to
    UINT32_MAX). `descending` and `bits` refer to the flipped keys."""
    call = start_call("glu.radix_sort_i32")
    try:
        _check_inputs(keys, torch.int32, values=values)
        if keys.shape[0] <= 1:
            return keys, values
        out_k, (out_v,) = _sort_words(keys.contiguous() ^ _SIGN, [values.contiguous()], backend,
                                      descending=descending, bits=bits)
        return out_k ^ _SIGN, _u32(out_v)
    finally:
        stop(call)


def _sort_u64_words(hi: torch.Tensor, lo: torch.Tensor, values: torch.Tensor, bits, backend):
    """The u64 sort of int32-carried words: the positions of each word,
    then the route (ops/router.py::_u64_backend), then the two-word sort.
    Returns (hi, lo, values)."""
    router = _router()
    pos_hi, pos_lo = _u64_positions(bits, hi, lo, backend)
    extra_ops = sum(1 for pos in (pos_hi, pos_lo) if pos and pos != FULL)
    npasses = router._npasses_of
    b = router._u64_backend(backend, hi, hi.numel(), npasses(pos_hi), npasses(pos_lo), extra_ops)
    out_hi, out_lo, (out_v,) = _sort_two_words(hi, lo, pos_hi, pos_lo, [_words(values)], b)
    return out_hi, out_lo, out_v


def _u64_positions(bits, hi: torch.Tensor, lo: torch.Tensor, backend) -> tuple:
    """(hi positions, lo positions): full words, the varying bits of each
    word for "auto", or an explicit (hi_positions, lo_positions) pair."""
    if bits is None or isinstance(bits, str):
        pos_lo = _norm_bits(bits, lo, 0, backend)
        pos_hi = _norm_bits(bits, hi, 0, backend)
    else:
        pair = tuple(bits)
        check_argument(
            len(pair) == 2 and not any(isinstance(p, (int, str)) for p in pair),
            "u64 explicit bits must be a (hi_positions, lo_positions) pair",
        )
        pos_hi = _norm_bits(tuple(pair[0]), hi, 0, backend)
        pos_lo = _norm_bits(tuple(pair[1]), lo, 0, backend)
    return FULL if pos_hi is None else pos_hi, FULL if pos_lo is None else pos_lo


def radix_sort_u64_parts(
    keys_hi: torch.Tensor,
    keys_lo: torch.Tensor,
    values: torch.Tensor,
    *,
    backend: str | None = None,
    bits=None,
):
    """Stably sort by a 64-bit key given as (hi, lo) u32 halves, a
    multi-word-key extension beyond the reference (u32 only,
    README.md:88-89). Returns (sorted_hi, sorted_lo, permuted_values).

    LSD composition: a full stable sort by the low word carrying (hi,
    value), then a full stable sort by the high word carrying (lo, value),
    is a stable 64-bit sort: 2 histogram launches and 8 onesweep passes of 3
    streams; "torch" sorts once on the int64 key. bits="auto" prunes the
    constant bits of EACH word (u64 keys below 2^40 skip three passes of the
    hi word); explicit positions are a PAIR (hi_positions, lo_positions).
    The inputs are not modified; where no bit of either word is sorted they
    come back as they are."""
    call = start_call("glu.radix_sort_u64_parts")
    try:
        _check_inputs(keys_hi, torch.uint32, keys_lo=keys_lo, values=values)
        if keys_hi.shape[0] <= 1:
            return keys_hi, keys_lo, values
        out_hi, out_lo, out_v = _sort_u64_words(_words(keys_hi), _words(keys_lo), values, bits, backend)
        return _u32(out_hi), _u32(out_lo), _u32(out_v)
    finally:
        stop(call)


def radix_sort_u64(keys: torch.Tensor, values: torch.Tensor, *, backend: str | None = None, bits=None):
    """Stably sort (u64 key, u32 value) pairs (keys torch.uint64) through
    the two chained 32-bit sorts of radix_sort_u64_parts, including its
    per-word bits= pruning. The words are split and joined as the int32
    pairs the keys are made of (torch implements few operations on uint64),
    one copy each way."""
    call = start_call("glu.radix_sort_u64")
    try:
        _check_inputs(keys, torch.uint64, values=values)
        if keys.shape[0] <= 1:
            return keys, values
        pairs = keys.contiguous().view(torch.int32).view(-1, 2)  # little-endian: (lo, hi) of each key
        hi, lo = pairs[:, 1].contiguous(), pairs[:, 0].contiguous()
        out_hi, out_lo, out_v = _sort_u64_words(hi, lo, values, bits, backend)
        out = torch.empty_like(pairs)
        out[:, 0], out[:, 1] = out_lo, out_hi
        return out.view(torch.uint64).view(-1), _u32(out_v)
    finally:
        stop(call)


def _seg_bits(num_segments: int) -> tuple:
    """The low bits that hold every segment id in 0..num_segments-1 (the JAX
    package's _seg_steps in 4-bit steps): the engine's passes take any bit
    count, so 300 segments cost 9 bits, one pass."""
    return tuple(range(max(1, (num_segments - 1).bit_length())))


def radix_sort_segmented(
    keys: torch.Tensor,
    values: torch.Tensor,
    num_partitions: int = 1,
    *,
    offsets=None,
    backend: str | None = None,
    bits=None,
):
    """Stably sort (keys, values) independently within adjacent segments,
    the sort-side analog of the scan's partition batching (reference
    BlellochScan.hpp:125-138; the reference has no segmented sort). Returns
    (sorted_keys, permuted_values).

    Segments are given EITHER as `num_partitions` equal-length pieces OR as
    `offsets`: S+1 nondecreasing boundaries (a tensor, numpy array or list;
    CUB begin/end-offsets style: segment s is [offsets[s], offsets[s+1]),
    offsets[0] == 0, offsets[-1] == len(keys); empty segments allowed). The
    two forms are mutually exclusive.

    Each element's segment id is made on the original layout (a scatter-add
    of the interior boundaries and a cumsum for `offsets`, which fetches the
    boundaries to the host to check them). "cuda" then chains two engine
    sorts: a full key sort carrying (value, segment id), then a sort on the
    segment id over just the bits that hold it, carrying (key, value), whose
    stability keeps the key order within each segment. "torch" sorts once on
    the int64 of (segment id, key). bits= prunes the KEY sort (see
    radix_sort); the segment-id sort is already minimal.
    """
    call = start_call("glu.radix_sort_segmented")
    try:
        _check_inputs(keys, torch.uint32, values=values)
        n = keys.shape[0]
        if offsets is not None:
            check_argument(num_partitions in (1, None), "offsets and num_partitions are mutually exclusive")
            return _radix_sort_segmented_offsets(keys, values, offsets, backend, bits)
        p = int(num_partitions)
        check_argument(p >= 1, "num_partitions must be >= 1")
        check_argument(n % p == 0, "count (%d) must divide into %d partitions", n, p)
        if p == 1:
            return radix_sort(keys, values, backend=backend, bits=bits)
        if n <= 1:
            return keys, values
        seg = torch.arange(n, dtype=torch.int32, device=keys.device) // (n // p)
        return _segmented_sort(keys, values, seg, p, backend, bits)
    finally:
        stop(call)


def _radix_sort_segmented_offsets(keys, values, offsets, backend, bits):
    """The offsets= form of radix_sort_segmented: segment ids by one
    scatter-add of the interior boundaries and a cumsum, O(n), on the
    original layout. Duplicate boundaries accumulate, so an empty segment
    skips its id; a trailing offsets[s] == n falls off the end (the JAX
    package's mode="drop")."""
    from ._segments import validate_offsets

    n = keys.shape[0]
    offs, num_segments = validate_offsets(offsets, n, keys.device)
    if num_segments == 1:
        return radix_sort(keys, values, backend=backend, bits=bits)
    if n <= 1:
        return keys, values
    inner = offs[1:-1]
    marks = torch.zeros(n + 1, dtype=torch.int32, device=keys.device)
    marks.index_add_(0, inner, torch.ones(inner.shape, dtype=torch.int32, device=keys.device))
    seg = torch.cumsum(marks[:n], 0, dtype=torch.int32)
    return _segmented_sort(keys, values, seg, num_segments, backend, bits)


def _segmented_sort(keys, values, seg, num_segments: int, backend, bits):
    """The two-word sort by (segment id, key), routed by
    ops/router.py::_segmented_backend once the key's positions are known."""
    k = _words(keys)
    positions = _norm_bits(bits, k, 0, backend)
    positions = FULL if positions is None else positions
    seg_pos = _seg_bits(num_segments)
    router = _router()
    npasses = router._npasses_of
    b = router._segmented_backend(backend, k, k.numel(), npasses(positions), npasses(seg_pos), positions == FULL)
    _, out_k, (out_v,) = _sort_two_words(seg, k, seg_pos, positions, [_words(values)], b)
    return _u32(out_k), _u32(out_v)


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
        call = start_call("glu.RadixSort.prepare_internal_buffers")
        try:
            router = _router()
            k = torch.zeros(count, dtype=torch.int32, device=default_device(device)).view(torch.uint32)
            b = router._sort_backend(backend, k, count, 1, router._npasses_of(FULL), True)  # a full pair sort's route
            key = (count, b, k.device)
            if count <= 1 or key in self._warm:
                return
            radix_sort(k, torch.zeros_like(k.view(torch.int32)).view(torch.uint32), backend=b)
            if k.is_cuda:
                timing.count("host_syncs.prepare")
                torch.cuda.synchronize(k.device)
            self._warm.add(key)
        finally:
            stop(call)

    def __call__(
        self,
        key_buffer: DeviceBuffer | torch.Tensor,
        val_buffer: DeviceBuffer | torch.Tensor,
        count: int,
        num_steps: int = 0,
        *,
        backend: str | None = None,
    ):
        call = start_call("glu.RadixSort")
        try:
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
        finally:
            stop(call)
