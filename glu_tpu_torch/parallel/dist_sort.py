"""Distributed stable radix sort over a torch.distributed process group.

Counterpart of glu_tpu/parallel/dist_sort.py, with a process group in place
of the JAX mesh. Each rank passes its own shard; every shard has the same
length, and global index i of rank r is r * n_local + i (rank-major, the
global input order that stability refers to). The pipeline, on every rank:

  1. splitter sampling: strided (key, global index) samples of the shard
     (`_local_samples`), one all_gather, and D-1 quantiles of the gathered
     samples in LEXICOGRAPHIC (key, index) order (`_sample_splitters`): the
     index tiebreak makes every sample distinct, so runs of equal keys are
     split over ranks as evenly as distinct keys;
  2. bucket partition: the destination rank of each element
     (`_bucket_of`: KB, one launch of csrc/bucket.cu on a CUDA tensor and
     backend "cuda", one read of the keys; parallel/_cuda_bucket.py), then
     one stable partial sort on the
     bucket ids over exactly ceil(log2 D) bits that carries every stream
     (`_partition_by_bucket`, the radix engine on a CUDA tensor);
  3. the exchange: one all_gather of every rank's counts a destination,
     brought to the host (a host sync: all_to_all_single takes its split
     sizes as host lists), the plan (`ragged_exchange_plan`), and one
     all_to_all_single per stream with uneven split sizes; blocks arrive in
     source order;
  4. the stable local sort of what arrived, with the caller's backend and
     the global `bits`.

Stability: blocks are exchanged in source order, each block keeps source
order (step 2 is a stable sort), and the local sort is stable, so ties keep
their global input order. The shard is cut into `pipeline_chunks` adjacent
chunks: chunk c's exchange is issued (async) before chunk c+1 is
partitioned, so the two overlap; blocks are placed source-major,
chunk-minor, which is global index order, so the result is bit-identical
to one chunk. One rank (D = 1) sorts its shard alone.

Differences from the JAX package, which sizes XLA's static buffers: eager
torch knows every split size on the host, so the exchange is exact. There
are no padded blocks (`_spread_to_padded`, `_compact_blocks`), capacities,
overflow retries (`_attempt_capacities`, `_run_attempts`), cached programs
or exchange choice; the arguments capacity_factor, recv_capacity_factor,
max_retries and exchange do not exist. `keys`/`values` hold exactly this
rank's received elements, sorted, with no pad tail; `counts` is the (D,)
int32 tensor of every rank's count, the same on every rank; `overflow` is
a (D,) int32 tensor of zeros.

Every stage operates on a LIST of u32 streams permuted identically, so one
pipeline serves u32 keys (keys, values), f32 and i32 keys (bijected to
u32) and 64-bit keys ((hi, lo, values), lexicographic splitters, the
chained local sort); descending order is complemented keys throughout.
The stage functions (`_local_samples*`, `_sample_splitters*`,
`_bucket_of*`, `_partition_by_bucket`, `ragged_exchange_plan`) take a rank,
a world size and tensors and touch no group; only the public functions and
the exchange call torch.distributed. A group serves the device type of its
backend (NCCL cuda, gloo cpu); a tensor on the other raises GluError
before any collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.backend import _VALID, resolve_backend
from ..ops.radix_sort import (
    _SIGN,
    _check_inputs,
    _envelope_positions,
    _f32_to_sortable,
    _key_envelope,
    _norm_bits,
    _sortable_to_f32,
    radix_sort,
    radix_sort_multi,
    radix_sort_u64_parts,
)
from ..utils.errors import check_argument
from ..utils.timing import count, span, start_call, stop
from ._cuda_bucket import bucket_of, bucket_of64, bucket_of64_ref, bucket_of_ref, ordered, wide_key
from .dist_primitives import _all_gather, _check_1d_sharded, _resolve_group


def make_sort_mesh(ranks=None):
    """The process group the distributed functions take: the default group
    for ranks=None, else `dist.new_group(ranks)`, which every process of the
    default group must call. torch.distributed must be initialised (the
    library does not own the runtime); callers with a group pass it
    directly."""
    group = _resolve_group(None)
    return group if ranks is None else dist.new_group(sorted(int(r) for r in ranks))


def _words(t: torch.Tensor) -> torch.Tensor:
    """u32 words as their int32 bit patterns: torch indexes, compares and
    shifts uint32 tensors on the card only that way."""
    return t.view(torch.int32)


def _u32(w: torch.Tensor) -> torch.Tensor:
    return w.view(torch.uint32)


# ---------------------------------------------------------------------------
# stage functions: a rank, a world size and tensors; no group
# ---------------------------------------------------------------------------


def _local_samples(keys: torch.Tensor, rank: int, num_samples: int):
    """This rank's strided samples of its u32 shard and their global
    indices (int64): the local half of the JAX _sample_splitters. The
    stride is a ceiling, so that the samples SPAN the shard (a floor stride
    of 1 on shards of n in (num_samples, 2 * num_samples) would sample only
    a prefix)."""
    n = keys.shape[0]
    stride = -(-n // num_samples)
    take = min(num_samples, -(-n // stride))
    idx = rank * n + torch.arange(take, dtype=torch.int64, device=keys.device) * stride
    return _u32(_words(keys)[::stride][:take].contiguous()), idx


def _quantiles(ordered: torch.Tensor, num_devices: int) -> torch.Tensor:
    """Positions among the gathered samples of the D-1 splitters: quantile
    (i + 1) / D of one stable sort by `ordered`. The gathered (rank-major)
    indices ascend, so ties keep index order and this is the lexicographic
    (key, global index) order of the JAX lax.sort(num_keys=2|3)."""
    order = torch.sort(ordered, stable=True).indices
    m = order.shape[0]
    return order[torch.arange(1, num_devices, dtype=torch.int64, device=order.device) * m // num_devices]


def _sample_splitters(all_samples: torch.Tensor, all_idx: torch.Tensor, num_devices: int):
    """Global quantile splitters from the gathered samples in lexicographic
    (key, global index) order, keys compared unsigned: the pure half of the
    JAX _sample_splitters. Bucket i takes the pairs in [s_{i-1}, s_i).
    Returns (splitter keys u32, splitter indices int64), D - 1 each, in
    non-decreasing lexicographic order (KB's precondition)."""
    q = _quantiles(ordered(all_samples), num_devices)
    return _u32(_words(all_samples)[q]), all_idx[q]


def _bucket_of(keys: torch.Tensor, rank: int, splitter_keys: torch.Tensor, splitter_idx: torch.Tensor,
               backend=None):
    """Destination rank of each element of this rank's u32 shard under
    lexicographic (key, global index) order: KB (`bucket_of`), or its plain
    version where the backend resolves to "torch". Returns int32 bucket
    ids."""
    keys = keys.contiguous()
    if resolve_backend(backend, keys) == "torch":
        return bucket_of_ref(keys, rank * keys.shape[0], splitter_keys, splitter_idx)
    return bucket_of(keys, rank * keys.shape[0], splitter_keys, splitter_idx)


def _local_samples64(hi: torch.Tensor, lo: torch.Tensor, rank: int, num_samples: int):
    """64-bit analog of _local_samples: (hi samples, lo samples, global
    indices)."""
    s_hi, idx = _local_samples(hi, rank, num_samples)
    s_lo, _ = _local_samples(lo, rank, num_samples)
    return s_hi, s_lo, idx


def _sample_splitters64(all_hi, all_lo, all_idx, num_devices: int):
    """64-bit analog of _sample_splitters: quantiles in lexicographic (hi,
    lo, global index) order. Returns (s_hi, s_lo, s_idx), in non-decreasing
    lexicographic order."""
    q = _quantiles(wide_key(all_hi, all_lo), num_devices)
    return _u32(_words(all_hi)[q]), _u32(_words(all_lo)[q]), all_idx[q]


def _bucket_of64(hi, lo, rank: int, s_hi, s_lo, s_idx, backend=None):
    """Destination rank under lexicographic (hi, lo, global index) order:
    KB's 64-bit form (`bucket_of64`), or its plain version where the backend
    resolves to "torch"."""
    hi, lo = hi.contiguous(), lo.contiguous()
    if resolve_backend(backend, hi) == "torch":
        return bucket_of64_ref(hi, lo, rank * hi.shape[0], s_hi, s_lo, s_idx)
    return bucket_of64(hi, lo, rank * hi.shape[0], s_hi, s_lo, s_idx)


def _partition_by_bucket(bucket: torch.Tensor, arrays, num_devices: int, backend):
    """Stable grouping of the shard's u32 streams by destination bucket:
    ONE stable partial sort keyed on the bucket ids over exactly ceil(log2
    D) bits, carrying every stream (radix_sort_multi: on a CUDA tensor and
    backend "cuda", one histogram and one onesweep pass for D <= 256).
    Offsets come from a binary search over the sorted bucket ids. Returns
    (arrays, counts, offsets), int32, buckets contiguous in ascending
    order."""
    n = bucket.shape[0]
    dev = bucket.device
    if num_devices == 1:
        return list(arrays), torch.full((1,), n, dtype=torch.int32, device=dev), torch.zeros(1, dtype=torch.int32, device=dev)
    nbits = max((num_devices - 1).bit_length(), 1)
    sb, outs = radix_sort_multi(_u32(bucket), tuple(arrays), backend=backend, bits=tuple(range(nbits)))
    ids = torch.arange(num_devices, dtype=torch.int32, device=dev)
    offsets = torch.searchsorted(_words(sb), ids, side="left", out_int32=True)
    ends = torch.cat([offsets[1:], offsets.new_full((1,), n)])
    return list(outs), ends - offsets, offsets


def ragged_exchange_plan(row_counts: torch.Tensor, recv_capacity):
    """Descriptor algebra of the bucket exchange (the JAX package's, ported
    as it is). row_counts: (R, D), row r sends row_counts[r, d] elements to
    rank d; rows are sources, or (source, chunk) pairs in source-major,
    chunk-minor order, placed in ascending row order in each receiver's
    buffer of `recv_capacity` slots.

    Returns (starts, sizes, total_recv) in row_counts' dtype: starts[r, d],
    where row r's block lands in rank d's buffer; sizes[r, d], the elements
    written, clamped so that starts + sizes <= recv_capacity always;
    total_recv[d], the true total (pre-clamp). The port's exchange is exact:
    it passes the whole count as the capacity, so nothing is clamped, and
    sizes[:, d] are rank d's receive sizes."""
    starts_all = torch.cumsum(row_counts, 0, dtype=row_counts.dtype) - row_counts
    total_recv = torch.sum(row_counts, 0, dtype=row_counts.dtype)
    starts = torch.clamp(starts_all, max=recv_capacity)
    sizes = torch.minimum(row_counts, recv_capacity - starts)
    return starts, sizes, total_recv


# ---------------------------------------------------------------------------
# the exchange and the shard pipelines (these call torch.distributed)
# ---------------------------------------------------------------------------


def _resolve_chunks(pipeline_chunks, num_devices: int, local_n: int) -> int:
    """Resolve pipeline_chunks="auto": 2 chunks at D >= 2 when the shard
    divides evenly, else 1. Explicit ints are validated and honoured."""
    if pipeline_chunks == "auto":
        return 2 if (num_devices > 1 and local_n % 2 == 0 and local_n >= 2) else 1
    chunks = int(pipeline_chunks)
    check_argument(chunks >= 1, "pipeline_chunks must be >= 1")
    check_argument(local_n % chunks == 0, "local shard length %d not divisible by pipeline_chunks=%d",
                   local_n, chunks)
    return chunks


def _exchange_and_sort(arrays, bucket, local_sort, *, group, rank: int, num_devices: int, backend,
                       num_chunks: int):
    """Partition, exchange and sort this rank's u32 streams (bucket ids
    given), chunk by chunk: the chunk's partition, one all_gather of its
    counts a destination brought to the host (a host sync a chunk: the
    split sizes of all_to_all_single are host lists), the plan, and one
    async all_to_all_single per stream, issued before the next chunk is
    partitioned so that the two overlap. Once every transfer is waited on,
    the blocks are placed source-major, chunk-minor and sorted by
    `local_sort`. Returns (sorted streams, counts (D,) int32). Spans: a
    chunk's glu.dist.partition, glu.dist.counts and glu.dist.exchange, then
    glu.dist.place, glu.dist.local_sort and glu.dist.total (the counts'
    copy onto the card); the counter dist.bytes_sent counts the bytes this
    rank sends to the others."""
    chunk_len = bucket.shape[0] // num_chunks
    received = [[] for _ in arrays]  # [stream][chunk]: (what arrived, its sizes by source)
    total = torch.zeros(num_devices, dtype=torch.int32)
    pending = []
    for c in range(num_chunks):
        cut = slice(c * chunk_len, (c + 1) * chunk_len)
        with span("glu.dist.partition"):
            parts, counts, _ = _partition_by_bucket(bucket[cut], [a[cut] for a in arrays], num_devices, backend)
        with span("glu.dist.counts"):
            rows = _all_gather(counts, group).cpu()  # (source, destination)
            count("host_syncs.dist_counts")
        with span("glu.dist.exchange"):
            _, sizes, total_c = ragged_exchange_plan(rows, int(rows.sum()))  # exact: nothing is clamped
            send, recv = rows[rank].tolist(), sizes[:, rank].tolist()
            total += total_c
            for stream, part in enumerate(parts):
                out = torch.empty(sum(recv), dtype=torch.int32, device=part.device)
                work = dist.all_to_all_single(out, _words(part), recv, send, group=group, async_op=True)
                pending.append((work, part))
                received[stream].append((out, recv))
            count("dist.bytes_sent", 4 * len(parts) * (sum(send) - send[rank]))

    def placed(chunks):
        # the plan over (source, chunk) rows puts block (s, c) at the running
        # count in (source, chunk) order; one chunk arrived in that order
        if len(chunks) == 1:
            return _u32(chunks[0][0])
        blocks = [out.split(recv) for out, recv in chunks]
        return _u32(torch.cat([blocks[c][s] for s in range(num_devices) for c in range(num_chunks)]))

    with span("glu.dist.place"):
        for work, _ in pending:
            work.wait()
        streams = [placed(chunks) for chunks in received]
    with span("glu.dist.local_sort"):
        result = list(local_sort(*streams))
    with span("glu.dist.total"):
        total = total.to(bucket.device)
        if total.is_cuda:
            count("host_syncs.dist_total")  # the counts' copy onto the card waits for its stream
    return result, total


def _dist_sort_shard(keys, values, local_sort, *, group, rank: int, num_devices: int, num_samples: int,
                     backend, num_chunks: int):
    """The u32 pipeline on this rank's shard. D == 1 is the exact fast path:
    nothing to sample, bucket or exchange, so the composition is the local
    sort. Returns ([keys, values], counts)."""
    dev = keys.device
    if num_devices == 1:
        with span("glu.dist.local_sort"):
            return list(local_sort(keys, values)), torch.full((1,), keys.shape[0], dtype=torch.int32, device=dev)
    with span("glu.dist.splitters"):
        samples, idx = _local_samples(keys, rank, num_samples)
        sk, si = _sample_splitters(_all_gather(samples, group).reshape(-1), _all_gather(idx, group).reshape(-1),
                                   num_devices)
    with span("glu.dist.bucket"):
        bucket = _bucket_of(keys, rank, sk, si, backend)
    return _exchange_and_sort([keys, values], bucket, local_sort, group=group, rank=rank,
                              num_devices=num_devices, backend=backend, num_chunks=num_chunks)


def _dist_sort_shard64(hi, lo, values, local_sort, *, group, rank: int, num_devices: int, num_samples: int,
                       backend, num_chunks: int):
    """The (hi, lo) 64-bit pipeline on this rank's shard. Returns ([hi, lo,
    values], counts)."""
    dev = hi.device
    if num_devices == 1:
        with span("glu.dist.local_sort"):
            return list(local_sort(hi, lo, values)), torch.full((1,), hi.shape[0], dtype=torch.int32, device=dev)
    with span("glu.dist.splitters"):
        s_hi, s_lo, idx = _local_samples64(hi, lo, rank, num_samples)
        gathered = [_all_gather(t, group).reshape(-1) for t in (s_hi, s_lo, idx)]
        shi, slo, sidx = _sample_splitters64(*gathered, num_devices)
    with span("glu.dist.bucket"):
        bucket = _bucket_of64(hi, lo, rank, shi, slo, sidx, backend)
    return _exchange_and_sort([hi, lo, values], bucket, local_sort, group=group, rank=rank,
                              num_devices=num_devices, backend=backend, num_chunks=num_chunks)


def _global_positions(key_words, group, backend):
    """bits="auto" over the GLOBAL array: each rank's (OR, AND) envelope of
    every key word, one all_gather, folded on the host (NCCL has no bitwise
    reduce op). Returns the positions of each word."""
    with span("glu.bits_auto"):
        env = torch.cat([_key_envelope(_words(w), resolve_backend(backend, w)) for w in key_words])
        rows = _all_gather(env, group).tolist()  # (D, 2 * words): a host sync
        count("host_syncs.dist_bits_auto")
    positions = []
    for j in range(len(key_words)):
        or_word, and_word = 0, 0xFFFFFFFF
        for row in rows:
            or_word |= row[2 * j]
            and_word &= row[2 * j + 1]
        positions.append(_envelope_positions(or_word, and_word))
    return positions


def _check_common(num_samples, backend) -> None:
    check_argument(backend is None or backend in _VALID, "Invalid backend: %s (want None or one of %s)", backend,
                   _VALID)
    check_argument(int(num_samples) >= 1, "num_samples must be >= 1, got %s", num_samples)


# ---------------------------------------------------------------------------
# public functions
# ---------------------------------------------------------------------------


def distributed_radix_sort(
    keys: torch.Tensor,
    values: torch.Tensor,
    group=None,
    *,
    num_samples: int = 8192,
    backend: str | None = None,
    descending: bool = False,
    pipeline_chunks="auto",
    bits=None,
):
    """Globally sort u32 (key, value) pairs sharded over `group` (None: the
    default group). keys/values: this rank's shard, 1-D torch.uint32 of
    equal length on every rank, on a device the group's backend serves.

    Returns (keys, values, counts, overflow): this rank's keys and values,
    the r-th global key range for rank r, sorted and stable (ties keep
    their global input order), exactly counts[rank] of them; counts, the
    (D,) int32 counts of every rank, the same on every rank; overflow, (D,)
    int32 zeros (the exchange is exact). descending=True sorts high to low
    (rank 0 holds the LARGEST keys), stable, via complemented keys.

    num_samples: samples a rank (at most its shard) for the splitters.
    backend: the single-card sorts' ("cuda", "torch" or None, routed).
    pipeline_chunks: "auto" (2 chunks at D >= 2 when the shard divides
    evenly, else 1) or an int dividing the shard: each chunk is partitioned
    and its exchange issued before the next chunk's partition. bits: None,
    explicit positions, or "auto", the varying bits of the GLOBAL array
    (an envelope a rank, one all_gather and a host sync), to which every
    rank's local sort prunes; splitters order by the full key.
    """
    call = start_call("glu.distributed_radix_sort")
    try:
        _check_inputs(keys, torch.uint32, values=values)
        _check_common(num_samples, backend)
        group, rank, world = _check_1d_sharded(keys, group)
        local_n = keys.shape[0]
        chunks = _resolve_chunks(pipeline_chunks, world, local_n)
        words = ~_words(keys) if descending else _words(keys)  # NOT reverses u32 order; stability is kept
        if bits == "auto":
            positions = _global_positions([words], group, backend)[0]
        else:
            positions = _norm_bits(bits, words, 0, backend)
        dev = keys.device
        overflow = torch.zeros(world, dtype=torch.int32, device=dev)
        if local_n == 0:
            return keys, values, torch.zeros(world, dtype=torch.int32, device=dev), overflow
        (out_k, out_v), counts = _dist_sort_shard(
            _u32(words), values, lambda k, v: radix_sort(k, v, backend=backend, bits=positions),
            group=group, rank=rank, num_devices=world, num_samples=min(int(num_samples), local_n),
            backend=backend, num_chunks=chunks,
        )
        if descending:
            out_k = _u32(~_words(out_k))
        return out_k, out_v, counts, overflow
    finally:
        stop(call)


def distributed_radix_sort_f32(keys: torch.Tensor, values: torch.Tensor, group=None, *, descending: bool = False,
                               **kwargs):
    """Globally sort f32 (key, value) pairs sharded over `group`, via the
    order-preserving f32 -> u32 bijection of radix_sort_f32 (IEEE-754 total
    order: -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN). The
    bijection is monotonic, so splitters, buckets and every rank's range
    carry over. Same contract as distributed_radix_sort, with float32 keys."""
    call = start_call("glu.distributed_radix_sort_f32")
    try:
        _check_inputs(keys, torch.float32, values=values)
        out = distributed_radix_sort(_u32(_f32_to_sortable(keys.contiguous().view(torch.int32))), values, group,
                                     descending=descending, **kwargs)
        return (_sortable_to_f32(_words(out[0])), *out[1:])
    finally:
        stop(call)


def distributed_radix_sort_i32(keys: torch.Tensor, values: torch.Tensor, group=None, *, descending: bool = False,
                               **kwargs):
    """Globally sort i32 (key, value) pairs sharded over `group`, via the
    sign-bit flip of radix_sort_i32 (an order-preserving bijection onto
    u32). Same contract as distributed_radix_sort, with int32 keys."""
    call = start_call("glu.distributed_radix_sort_i32")
    try:
        _check_inputs(keys, torch.int32, values=values)
        out = distributed_radix_sort(_u32(keys.contiguous() ^ _SIGN), values, group, descending=descending, **kwargs)
        return (_words(out[0]) ^ _SIGN, *out[1:])
    finally:
        stop(call)


def distributed_radix_sort_u64_parts(
    keys_hi: torch.Tensor,
    keys_lo: torch.Tensor,
    values: torch.Tensor,
    group=None,
    *,
    num_samples: int = 8192,
    backend: str | None = None,
    descending: bool = False,
    pipeline_chunks="auto",
    bits=None,
):
    """Globally sort 64-bit keys given as (hi, lo) u32 halves, with u32
    values, sharded over `group`: the distributed form of
    radix_sort_u64_parts. Splitters and buckets use lexicographic (hi, lo,
    global index) order, the partition carries the three streams, and the
    local sort is the chained 32-bit composition. Returns (hi, lo, values,
    counts, overflow). bits: None or "auto", which prunes the constant bits
    of EACH word of the global array."""
    call = start_call("glu.distributed_radix_sort_u64_parts")
    try:
        _check_inputs(keys_hi, torch.uint32, keys_lo=keys_lo, values=values)
        _check_common(num_samples, backend)
        check_argument(bits in (None, "auto"), 'distributed u64 sorts accept only bits=None or "auto"')
        group, rank, world = _check_1d_sharded(keys_hi, group)
        local_n = keys_hi.shape[0]
        chunks = _resolve_chunks(pipeline_chunks, world, local_n)
        hi, lo = _words(keys_hi), _words(keys_lo)
        if descending:  # complementing both words reverses u64 order
            hi, lo = ~hi, ~lo
        positions = tuple(_global_positions([hi, lo], group, backend)) if bits == "auto" else None
        dev = keys_hi.device
        overflow = torch.zeros(world, dtype=torch.int32, device=dev)
        if local_n == 0:
            return keys_hi, keys_lo, values, torch.zeros(world, dtype=torch.int32, device=dev), overflow
        (out_hi, out_lo, out_v), counts = _dist_sort_shard64(
            _u32(hi), _u32(lo), values,
            lambda h, l, v: radix_sort_u64_parts(h, l, v, backend=backend, bits=positions),
            group=group, rank=rank, num_devices=world, num_samples=min(int(num_samples), local_n),
            backend=backend, num_chunks=chunks,
        )
        if descending:
            out_hi, out_lo = _u32(~_words(out_hi)), _u32(~_words(out_lo))
        return out_hi, out_lo, out_v, counts, overflow
    finally:
        stop(call)


def distributed_radix_sort_u64(keys: torch.Tensor, values: torch.Tensor, group=None, **kwargs):
    """Globally sort (u64 key, u32 value) pairs (keys torch.uint64) sharded
    over `group`, via distributed_radix_sort_u64_parts on the int32 pairs
    the keys are made of. Returns (keys, values, counts, overflow)."""
    call = start_call("glu.distributed_radix_sort_u64")
    try:
        _check_inputs(keys, torch.uint64, values=values)
        pairs = keys.contiguous().view(torch.int32).view(-1, 2)  # little-endian: (lo, hi) of each key
        out_hi, out_lo, out_v, counts, overflow = distributed_radix_sort_u64_parts(
            _u32(pairs[:, 1].contiguous()), _u32(pairs[:, 0].contiguous()), values, group, **kwargs
        )
        out = torch.empty((out_hi.shape[0], 2), dtype=torch.int32, device=out_hi.device)
        out[:, 0], out[:, 1] = _words(out_lo), _words(out_hi)
        return out.view(torch.uint64).view(-1), out_v, counts, overflow
    finally:
        stop(call)
