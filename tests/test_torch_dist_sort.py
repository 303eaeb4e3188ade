"""The port's distributed sort (glu_tpu_torch.parallel) against glu_tpu's.

The same numpy-seeded global arrays go to both. The JAX side runs in this
process on make_sort_mesh(jax.devices()[:D]) with backend "xla" and
capacity factors of D, which fit any input at once (no overflow retry, so
one compile a configuration; the result does not depend on them). The
port's side runs in D gloo processes (tests/torch_dist_pool.py), each with
its own shard, under both of the port's backends: "cuda", the radix
engine's plain torch versions on the CPU, and "torch".

Every shard holds 16,384 keys and num_samples is 512, so the sampling is
strided (a shard shorter than num_samples would make every key a sample).
Checks: the port's counts equal JAX's; rank d's keys and values equal the
first counts[d] slots of JAX's shard d, bit for bit (floats as bit
patterns); the ranks' concatenation is numpy's stable sort, values being
the global indices.

The stage functions (splitters, buckets, partition, exchange plan) are
checked without processes, rank by rank.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glu_tpu import parallel as jpar
from glu_tpu.parallel import dist_sort as jds
from glu_tpu_torch import GluError, from_numpy, to_numpy, varying_key_bits
from glu_tpu_torch import parallel as tpar
from glu_tpu_torch.parallel import dist_sort as tds
from test_ragged_plan import _random_case
from torch_dist_pool import RankPool, results

N_LOCAL = 16384
NUM_SAMPLES = 512
WORLD_SIZES = (1, 2, 3, 4)
PORT_BACKENDS = ("cuda", "torch")
U32_MAX = 0xFFFFFFFF


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """One pool of D gloo processes for each D, all started at once."""
    store_dir = str(tmp_path_factory.mktemp("gloo"))
    pools = {d: RankPool(d, store_dir) for d in WORLD_SIZES}
    yield pools
    for pool in pools.values():
        pool.stop()
    for pool in pools.values():
        pool.close()


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _f32_specials(rng, n):
    """Normal floats with +-0.0, +-inf and NaNs of both signs sprinkled in."""
    k = rng.standard_normal(n).astype(np.float32)
    patterns = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
                         0xFFFFFFFF], dtype=np.uint32)
    at = rng.integers(0, n, n // 50)
    k.view(np.uint32)[at] = patterns[rng.integers(0, patterns.size, at.size)]
    return k


def _u64_duplicates(rng, n):
    distinct = rng.integers(0, 2**64, n // 4, dtype=np.uint64)
    return distinct[rng.integers(0, n // 4, n)]


def _u64_parts(rng, n):
    k = _u64_duplicates(rng, n)
    return [(k >> np.uint64(32)).astype(np.uint32), (k & np.uint64(U32_MAX)).astype(np.uint32)]


def _sortable_f32(k):
    bits = k.view(np.uint32)
    return bits ^ np.where(bits >> 31, np.uint32(U32_MAX), np.uint32(0x80000000))


# name: (function, n -> global key arrays, keyword arguments, key arrays -> the order numpy sorts by)
CASES = {
    "uniform": ("distributed_radix_sort", lambda rng, n: [_u32(rng, n)], {}, None),
    "16 values": ("distributed_radix_sort",
                  lambda rng, n: [rng.integers(0, 16, n).astype(np.uint32) * np.uint32(0x10000001)], {}, None),
    "constant": ("distributed_radix_sort", lambda rng, n: [np.full(n, 0xABCD1234, np.uint32)], {}, None),
    "presorted": ("distributed_radix_sort", lambda rng, n: [np.sort(_u32(rng, n))], {}, None),
    "reversed": ("distributed_radix_sort", lambda rng, n: [np.sort(_u32(rng, n))[::-1].copy()], {}, None),
    "all 0xFFFFFFFF": ("distributed_radix_sort", lambda rng, n: [np.full(n, U32_MAX, np.uint32)], {}, None),
    "skewed": ("distributed_radix_sort", lambda rng, n: [rng.zipf(1.3, n).astype(np.uint32)], {}, None),
    "descending": ("distributed_radix_sort", lambda rng, n: [_u32(rng, n) & np.uint32(0xFFFF)],
                   {"descending": True}, lambda k: ~k),
    # presorted, so that each rank's varying bits differ from the global ones
    "bits auto": ("distributed_radix_sort", lambda rng, n: [np.sort(_u32(rng, n) & np.uint32(0x3FF))],
                  {"bits": "auto"}, None),
    "1 chunk": ("distributed_radix_sort", lambda rng, n: [_u32(rng, n) & np.uint32(0xFFF)],
                {"pipeline_chunks": 1}, None),
    "2 chunks": ("distributed_radix_sort", lambda rng, n: [_u32(rng, n) & np.uint32(0xFFF)],
                 {"pipeline_chunks": 2}, None),
    "f32 specials": ("distributed_radix_sort_f32", lambda rng, n: [_f32_specials(rng, n)], {}, _sortable_f32),
    "i32": ("distributed_radix_sort_i32", lambda rng, n: [_u32(rng, n).view(np.int32) >> 8], {}, None),
    "u64 parts": ("distributed_radix_sort_u64_parts", _u64_parts, {},
                  lambda hi, lo: (hi.astype(np.uint64) << np.uint64(32)) | lo),
    "u64 descending": ("distributed_radix_sort_u64", lambda rng, n: [_u64_duplicates(rng, n)],
                       {"descending": True}, lambda k: ~k),
}


def _jax_shards(fn_name, arrays, world_size, kw):
    """glu_tpu.parallel's result: ([rank d's outputs, first counts[d] slots], counts)."""
    mesh = jpar.make_sort_mesh(jax.devices()[:world_size])
    sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("shards"))
    args = [jax.device_put(jnp.asarray(a), sharding) for a in arrays]
    out = getattr(jpar, fn_name)(*args, mesh, backend="xla", num_samples=NUM_SAMPLES,
                                 capacity_factor=float(world_size), recv_capacity_factor=float(world_size), **kw)
    out = [np.asarray(o) for o in out]
    counts, overflow = out[-2], out[-1]
    assert not overflow.any()
    return [[o.reshape(world_size, -1)[d, : counts[d]] for o in out[:-2]] for d in range(world_size)], counts


def _assert_bits_equal(got, want, label):
    assert got.dtype == want.dtype and got.shape == want.shape, (label, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=label)


def _shards(a, world_size):
    return np.split(a, world_size)


def _port_results(pool, fn_name, arrays, world_size, kw):
    per_rank = [(fn_name, [s[r] for s in (_shards(a, world_size) for a in arrays)], kw) for r in range(world_size)]
    return results(pool.run("parallel_call", per_rank))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_distributed_sort_matches_jax(pools, world_size, case):
    fn_name, make, kw, sort_key = CASES[case]
    rng = np.random.default_rng([list(CASES).index(case), world_size])
    n = world_size * N_LOCAL
    keys = make(rng, n)
    arrays = [*keys, np.arange(n, dtype=np.uint32)]
    want, want_counts = _jax_shards(fn_name, arrays, world_size, kw)
    order = np.argsort(sort_key(*keys) if sort_key else keys[0], kind="stable")
    for backend in PORT_BACKENDS:
        got = _port_results(pools[world_size], fn_name, arrays, world_size,
                            dict(kw, backend=backend, num_samples=NUM_SAMPLES))
        for d, out in enumerate(got):
            label = f"{case} D={world_size} backend={backend} rank {d}"
            assert len(out) == len(want[d]) + 2, label
            np.testing.assert_array_equal(out[-2], want_counts.astype(np.int32), err_msg=label)
            assert out[-2].dtype == np.int32 and out[-1].dtype == np.int32, label
            np.testing.assert_array_equal(out[-1], np.zeros(world_size, np.int32), err_msg=label)
            for i, (g, w) in enumerate(zip(out[:-2], want[d])):
                _assert_bits_equal(g, w, f"{label} output {i}")
        for i, a in enumerate(arrays):
            joined = np.concatenate([out[i] for out in got])
            _assert_bits_equal(joined, a[order], f"{case} D={world_size} backend={backend}: output {i} is not numpy's "
                                                 f"stable sort")


def test_sort_on_a_subgroup(pools):
    # make_sort_mesh(ranks): ranks 0, 2 and 3 of 4 sort as a group of 3 (its
    # ranks 0, 1, 2), rank 1 stands by; the result is JAX's on 3 devices
    rng = np.random.default_rng(7)
    n = 3 * N_LOCAL
    keys = _u32(rng, n) & np.uint32(0xFFFF)
    values = np.arange(n, dtype=np.uint32)
    want, want_counts = _jax_shards("distributed_radix_sort", [keys, values], 3, {})
    members = [0, 2, 3]
    ks, vs = np.split(keys, 3), np.split(values, 3)
    per_rank = []
    for r in range(4):
        j = members.index(r) if r in members else 0
        per_rank.append((members, ks[j], vs[j], {"num_samples": NUM_SAMPLES}))
    got = results(pools[4].run("sort_on_subgroup", per_rank))
    assert got[1] is None
    for j, r in enumerate(members):
        out_k, out_v, counts, overflow = got[r]
        np.testing.assert_array_equal(counts, want_counts)
        np.testing.assert_array_equal(out_k, want[j][0])
        np.testing.assert_array_equal(out_v, want[j][1])
        assert not overflow.any()


def test_traced_sort_counts_one_host_sync_a_chunk_and_the_length_check(pools):
    # two gloo ranks, pipeline_chunks "auto" = 2: the length check's fetch,
    # then one fetch of the gathered counts a chunk; every stage's span
    # under the one call id of the public call
    rng = np.random.default_rng(11)
    keys, values = _u32(rng, 2 * N_LOCAL), np.arange(2 * N_LOCAL, dtype=np.uint32)
    per_rank = [("distributed_radix_sort", (k, v), {"num_samples": NUM_SAMPLES})
                for k, v in zip(np.split(keys, 2), np.split(values, 2))]
    got = results(pools[2].run("traced_call", per_rank))
    order = np.argsort(keys, kind="stable")
    _assert_bits_equal(np.concatenate([g[0][0] for g in got]), keys[order], "traced sort keys")
    chunks = 2
    # the rank each element leaves from and the rank it goes to, in the global order
    src, dest = order // N_LOCAL, np.repeat(np.arange(2), got[0][0][2])
    for rank, (_, summary, records) in enumerate(got):
        counters = summary["counters"]
        syncs = {k: v for k, v in counters.items() if k.startswith("host_syncs.")}
        assert syncs == {"host_syncs.dist_check": 1, "host_syncs.dist_counts": chunks}, rank
        assert sum(syncs.values()) == 1 + chunks
        assert counters["dist.bytes_sent"] == 2 * 4 * int(np.sum((src == rank) & (dest != rank)))  # keys, values
        spans = summary["spans"]
        assert spans["glu.distributed_radix_sort"]["count"] == 1
        for stage in ("check", "splitters", "bucket", "place", "local_sort", "total"):
            assert spans[f"glu.dist.{stage}"]["count"] == 1, stage
        for stage in ("partition", "counts", "exchange"):
            assert spans[f"glu.dist.{stage}"]["count"] == chunks, stage
        assert records[0] == ("glu.distributed_radix_sort", -1, records[0][2])
        assert all(call == records[0][2] for _, _, call in records)
        assert [name for name, parent, _ in records if parent == 0] == [
            "glu.dist.check", "glu.dist.splitters", "glu.dist.bucket"] + [
            "glu.dist.partition", "glu.dist.counts", "glu.dist.exchange"] * chunks + [
            "glu.dist.place", "glu.dist.local_sort", "glu.dist.total"]


@pytest.mark.parametrize("call, match", [
    (("distributed_radix_sort", "unequal"), "equal lengths"),
    (("distributed_radix_sort", "int32 keys"), "keys must be"),
    (("distributed_radix_sort", "chunks"), "pipeline_chunks"),
    (("distributed_radix_sort_u64_parts", "explicit bits"), "bits=None or"),
    (("distributed_radix_sort_f32", "u32 keys"), "keys must be"),
    (("distributed_radix_sort", "backend"), "Invalid backend"),
])
def test_sort_errors_raise_on_every_rank(pools, call, match):
    fn_name, what = call
    world_size = 2
    per_rank = []
    for r in range(world_size):
        n = N_LOCAL + (r if what == "unequal" else 0)
        keys = np.arange(n, dtype=np.uint32)
        if what == "int32 keys":
            keys = keys.view(np.int32)
        args = [keys, keys, keys] if fn_name.endswith("parts") else [keys, keys]
        kw = {"pipeline_chunks": 3} if what == "chunks" else {}
        kw = {"bits": ((0,), (1,))} if what == "explicit bits" else kw
        kw = {"backend": "xla"} if what == "backend" else kw
        per_rank.append((fn_name, args, kw))
    for status, payload in pools[world_size].run("parallel_call", per_rank):
        assert status == "error" and payload[2], payload
        assert match in payload[1], payload


def test_sort_needs_an_initialized_group():
    # the checks of the arguments come first; then the group: none here
    k = from_numpy(np.arange(8, dtype=np.uint32), "cpu")
    with pytest.raises(GluError, match="keys must be"):
        tpar.distributed_radix_sort(k.view(torch.int32), k)
    with pytest.raises(GluError, match="not initialized"):
        tpar.distributed_radix_sort(k, k)
    with pytest.raises(GluError, match="not initialized"):
        tpar.make_sort_mesh()


# ---------------------------------------------------------------------------
# the stage functions, rank by rank, without processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_key_envelopes_fold_to_the_global_one(backend):
    # bits="auto" over ranks: each piece's (OR, AND), an empty piece's the
    # identity, folded by OR and AND, are the whole array's, whose varying
    # bits are varying_key_bits' on the whole
    rs = importlib.import_module("glu_tpu_torch.ops.radix_sort")
    keys = np.sort(_u32(np.random.default_rng(5), 3000) & np.uint32(0x00F0F0FF)) | np.uint32(0x10000000)
    pieces = np.split(keys, [0, 1, 1000, 2999])
    envs = [rs._key_envelope(torch.from_numpy(p.view(np.int32)), backend).tolist() for p in pieces]
    or_word, and_word = 0, 0xFFFFFFFF
    for o, a in envs:
        or_word, and_word = or_word | o, and_word & a
    assert envs[0] == [0, 0xFFFFFFFF] and envs[1] == [int(keys[0])] * 2
    assert (or_word, and_word) == (int(np.bitwise_or.reduce(keys)), int(np.bitwise_and.reduce(keys)))
    assert rs._envelope_positions(or_word, and_word) == varying_key_bits(from_numpy(keys, "cpu"))


def _jax_stages(keys, world_size, num_samples, wide=False):
    """JAX's splitters (replicated) and buckets (sharded) under shard_map."""
    mesh = jpar.make_sort_mesh(jax.devices()[:world_size])
    spec = jax.sharding.PartitionSpec("shards")
    rep = jax.sharding.PartitionSpec()

    def body(*words):
        if wide:
            s = jds._sample_splitters64(*words, "shards", world_size, num_samples)
            return (*s, jds._bucket_of64(*words, "shards", *s))
        s = jds._sample_splitters(*words, "shards", world_size, num_samples)
        return (*s, jds._bucket_of(*words, "shards", *s))

    nout = 4 if wide else 3
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,) * len(keys),
                               out_specs=(rep,) * (nout - 1) + (spec,), check_vma=False))
    return [np.asarray(o) for o in fn(*(jnp.asarray(k) for k in keys))]


def _port_stages(keys, world_size, num_samples, wide, backend):
    shards = [[from_numpy(s, "cpu") for s in np.split(k, world_size)] for k in keys]
    local = [(tds._local_samples64 if wide else tds._local_samples)(*(s[r] for s in shards), r, num_samples)
             for r in range(world_size)]
    gathered = [torch.cat([loc[i] for loc in local]) for i in range(len(local[0]))]
    splitters = (tds._sample_splitters64 if wide else tds._sample_splitters)(*gathered, world_size)
    buckets = [(tds._bucket_of64 if wide else tds._bucket_of)(*(s[r] for s in shards), r, *splitters, backend)
               for r in range(world_size)]
    return [to_numpy(s) for s in splitters] + [to_numpy(torch.cat(buckets))]


@pytest.mark.parametrize("wide", [False, True], ids=["u32", "u64"])
@pytest.mark.parametrize("kind", ["uniform", "16 values", "constant"])
@pytest.mark.parametrize("world_size", [2, 3, 4])
def test_splitters_and_buckets_match_jax(world_size, kind, wide):
    rng = np.random.default_rng(world_size)
    n = world_size * 4096
    words = 2 if wide else 1
    if kind == "uniform":
        keys = [_u32(rng, n) for _ in range(words)]
    elif kind == "16 values":
        keys = [rng.integers(0, 4, n).astype(np.uint32) * np.uint32(0x40000001) for _ in range(words)]
    else:
        keys = [np.full(n, 0x80000001, np.uint32) for _ in range(words)]
    num_samples = 300  # a stride of 14 over shards of 4,096, the last sample short of the end
    want = _jax_stages(keys, world_size, num_samples, wide)
    for backend in PORT_BACKENDS:  # KB's wrapper ("cuda"; its plain version on the CPU) and "torch"
        got = _port_stages(keys, world_size, num_samples, wide, backend)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=f"{backend} output {i}")
        assert got[-1].dtype == np.int32
    # the buckets are balanced: index tiebreaks split even a constant array
    assert np.bincount(got[-1], minlength=world_size).max() <= 2 * n // world_size


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("world_size", [1, 2, 3, 5, 8])
def test_partition_by_bucket_matches_jax(world_size, backend):
    rng = np.random.default_rng(world_size)
    n = 5000
    bucket = rng.integers(0, world_size, n).astype(np.int32)
    arrays = [_u32(rng, n), np.arange(n, dtype=np.uint32)]
    j_arrays, j_counts, j_offsets = jds._partition_by_bucket(jnp.asarray(bucket), [jnp.asarray(a) for a in arrays],
                                                             world_size, "xla")
    t_arrays, t_counts, t_offsets = tds._partition_by_bucket(
        torch.from_numpy(bucket), [from_numpy(a, "cpu") for a in arrays], world_size, backend)
    for g, w in zip(t_arrays, j_arrays):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    np.testing.assert_array_equal(to_numpy(t_counts), np.asarray(j_counts))
    np.testing.assert_array_equal(to_numpy(t_offsets), np.asarray(j_offsets))
    assert t_counts.dtype == t_offsets.dtype == torch.int32


@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("skew", ["uniform", "one-hot", "empty-heavy"])
@pytest.mark.parametrize("world_size", [2, 4, 8])
def test_ragged_exchange_plan_matches_jax(world_size, skew, chunks):
    # the count matrices of tests/test_ragged_plan.py, as (source, chunk)
    # rows, at a capacity that fits, a tight one and one that clamps
    rng = np.random.default_rng(world_size * 100 + len(skew) + chunks)
    local_n = 257
    for _ in range(3):
        rows = np.concatenate([_random_case(rng, world_size, local_n, skew)[1] for _ in range(chunks)])
        rows = rows.reshape(chunks, world_size, world_size).transpose(1, 0, 2).reshape(-1, world_size)
        for cap in (world_size * local_n * chunks, local_n * chunks, local_n // 2):
            want = jds.ragged_exchange_plan(jnp.asarray(rows), cap)
            got = tds.ragged_exchange_plan(torch.from_numpy(rows), cap)
            for g, w in zip(got, want):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
