"""KB, the bucket stage of the distributed sort (glu_tpu_torch/parallel/
_cuda_bucket.py), on the CPU: the wrappers run their plain versions there,
held against a numpy oracle of the lexicographic count and against a numpy
model of the kernel's search (csrc/bucket.cu: binary lifting over the
sorted splitters), which is right only because the splitters come sorted.

Splitters are made as the distributed sort makes them: `_sample_splitters`
(or `_sample_splitters64`) of samples whose global indices ascend. Shards of
2,003 keys (not a multiple of 4), global indices from base = rank * n with
a rank that puts some above 2**32; uniform keys, 4 distinct values and one
constant value (every bucket then decided by the index); D - 1 splitters
from 2 to 1025 ranks, with fewer samples than ranks at 1025 (repeated
splitters). The port's bucket stage is held against the JAX package's
under shard_map in tests/test_torch_dist_sort.py."""

import numpy as np
import pytest
import torch

from glu_tpu_torch import GluError, from_numpy, to_numpy
from glu_tpu_torch.parallel import _cuda_bucket as cb
from glu_tpu_torch.parallel import dist_sort as ds

N = 2003
RANKS = (0, 2**32 // N + 1)  # the second: global indices above 2**32


def _keys(rng, kind: str, n: int) -> np.ndarray:
    if kind == "uniform":
        return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "4 values":
        return (rng.integers(0, 4, n).astype(np.uint32) * np.uint32(0x55555555)) ^ np.uint32(0x80000000)
    return np.full(n, 0xDEADBEEF, np.uint32)


def _splitter_input(rng, kind: str, world: int, rank: int, words: int):
    """Gathered samples as the distributed sort gathers them: keys of the
    shard's kind, global indices ascending over the world's range, and
    fewer samples than ranks at 1025."""
    m = 600 if world > 1000 else 40 * world
    idx = np.sort(rng.choice(world * N, m, replace=False)).astype(np.int64)
    idx += rank * N - min(rank, world // 2) * N  # the shard lies among the sampled indices
    return [_keys(rng, kind, m) for _ in range(words)], idx


def _oracle(key, gidx, s_key, s_idx) -> np.ndarray:
    """Count of splitters <= (key, gidx), lexicographic, from every pair."""
    k, g = key[:, None], gidx[:, None]
    return ((s_key[None] < k) | ((s_key[None] == k) & (s_idx[None] <= g))).sum(1).astype(np.int32)


def _lifting(key, gidx, s_key, s_idx) -> np.ndarray:
    """The kernel's search: the longest prefix of the splitters <= (key,
    gidx), in steps top, top / 2, ..., 1 (top the largest power of two <=
    D - 1), every element at once."""
    m = s_key.shape[0]
    pos = np.zeros(key.shape[0], np.int64)
    step = 1 << (m.bit_length() - 1) if m else 0
    while step:
        j = np.minimum(pos + step, m) - 1
        le = (s_key[j] < key) | ((s_key[j] == key) & (s_idx[j] <= gidx))
        pos = np.where((pos + step <= m) & le, pos + step, pos)
        step >>= 1
    return pos.astype(np.int32)


def _wide(hi, lo) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("kind", ["uniform", "4 values", "constant"])
@pytest.mark.parametrize("world", [2, 3, 8, 64, 1025])
@pytest.mark.parametrize("wide", [False, True], ids=["u32", "u64"])
def test_bucket_of_matches_the_oracle(wide, world, kind, rank):
    rng = np.random.default_rng(world * 10 + len(kind) + rank % 7)
    words = 2 if wide else 1
    shard = [_keys(rng, kind, N) for _ in range(words)]
    samples, idx = _splitter_input(rng, kind, world, rank, words)
    t_shard = [from_numpy(w, "cpu") for w in shard]
    t_samples = [from_numpy(w, "cpu") for w in samples]
    if wide:
        splitters = ds._sample_splitters64(*t_samples, torch.from_numpy(idx), world)
    else:
        splitters = ds._sample_splitters(*t_samples, torch.from_numpy(idx), world)
    base = rank * N
    s_np = [to_numpy(s) for s in splitters]
    key = _wide(*shard) if wide else shard[0].astype(np.uint64)
    s_key = _wide(*s_np[:2]) if wide else s_np[0].astype(np.uint64)
    s_idx = s_np[-1]
    gidx = base + np.arange(N, dtype=np.int64)
    want = _oracle(key, gidx, s_key, s_idx)
    # the precondition of the kernel's search: non-decreasing (key, index)
    assert s_key.shape[0] == world - 1
    assert all((a, b) <= (c, d) for a, b, c, d in zip(s_key[:-1], s_idx[:-1], s_key[1:], s_idx[1:]))
    np.testing.assert_array_equal(_lifting(key, gidx, s_key, s_idx), want)
    if world > 1000:
        assert len(set(zip(s_key.tolist(), s_idx.tolist()))) < world - 1  # repeated splitters
    if wide:
        got = [cb.bucket_of64(*t_shard, base, *splitters), cb.bucket_of64_ref(*t_shard, base, *splitters)]
        got += [ds._bucket_of64(*t_shard, rank, *splitters, backend=b) for b in (None, "torch")]
    else:
        got = [cb.bucket_of(*t_shard, base, *splitters), cb.bucket_of_ref(*t_shard, base, *splitters)]
        got += [ds._bucket_of(*t_shard, rank, *splitters, backend=b) for b in (None, "torch")]
    for g in got:
        assert g.dtype == torch.int32 and g.shape == (N,)
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("wide", [False, True], ids=["u32", "u64"])
def test_bucket_of_empty_shard_and_no_splitters(wide):
    u32 = lambda a: torch.tensor(a, dtype=torch.int64).to(torch.int32).view(torch.uint32)  # noqa: E731
    keys = [u32([5, 0, 2**31 + 7])] * (2 if wide else 1)
    none = [u32([])] * (2 if wide else 1)
    fn = cb.bucket_of64 if wide else cb.bucket_of
    assert fn(*keys, 0, *none, torch.zeros(0, dtype=torch.int64)).tolist() == [0, 0, 0]
    assert fn(*none, 9, *keys, torch.arange(3)).shape == (0,)


def _bad_calls():
    k = torch.arange(8, dtype=torch.int32).view(torch.uint32)
    s, si = k[:3].clone(), torch.arange(3, dtype=torch.int64)
    return {
        "int32 keys": lambda: cb.bucket_of(k.view(torch.int32), 0, s, si),
        "int32 splitter keys": lambda: cb.bucket_of(k, 0, s.view(torch.int32), si),
        "int32 splitter indices": lambda: cb.bucket_of(k, 0, s, si.to(torch.int32)),
        "splitter lengths": lambda: cb.bucket_of(k, 0, s, si[:2]),
        "2-D keys": lambda: cb.bucket_of(k.view(2, 4), 0, s, si),
        "non-contiguous keys": lambda: cb.bucket_of(k[::2], 0, s, si),
        "negative base": lambda: cb.bucket_of(k, -1, s, si),
        "base past int64": lambda: cb.bucket_of(k, 2**63 - 4, s, si),
        "hi/lo lengths": lambda: cb.bucket_of64(k, k[:7], 0, s, s, si),
        "64-bit splitter lengths": lambda: cb.bucket_of64(k, k, 0, s, s[:2], si),
        "int64 lo": lambda: cb.bucket_of64(k, k.to(torch.int64), 0, s, s, si),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_bucket_of_rejects_bad_arguments(case):
    with pytest.raises(GluError):
        _bad_calls()[case]()
