"""The plain versions of the port's sort kernels (glu_tpu_torch/ops/_cuda_sort.py)
against the Pallas kernels they replace (glu_tpu/ops/_pallas_sort.py), run
directly in interpret mode at the smallest geometry: blocks of R=8 rows of
128 lanes, so the port's tile is shrunk to 1024 elements to match. Inputs
come from one seeded numpy generator and go to both; every output (keys,
payloads, counts) must be bit-identical.

The JAX kernels take whole blocks padded with 0xFFFFFFFF keys; the port masks
its ragged last tile instead. A pad holds the top digit of every pass and
comes last, so the port's outputs equal the JAX outputs cut to n, and only
the top bin of the last block's counts differs, by the pad count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glu_tpu.ops import _pallas_sort as ps
from glu_tpu.ops.radix_sort import _radix_sort_streams as jax_sort_streams
from glu_tpu_torch.ops import _cuda_sort as cs
from glu_tpu_torch.utils import GluError

R = 8
BLOCK = R * ps.LANES  # 1024
N = 3 * BLOCK - 200   # three blocks, the last one ragged
PAD = 3 * BLOCK - N


@pytest.fixture
def block_tiles(monkeypatch):
    monkeypatch.setattr(cs, "TILE", BLOCK)


def _keys(rng, kind: str, n: int) -> np.ndarray:
    if kind == "uniform":
        return rng.sample_int_vector(n, 0, 0xFFFFFFFF)
    return rng.sample_int_vector(n, 0, 2)  # mod3: few digits, many empty runs


def _jax_2d(a: np.ndarray, fill: int, rows: int):
    padded = np.full(rows * ps.LANES, fill, dtype=np.uint32)
    padded[: a.size] = a
    return jnp.asarray(padded.reshape(rows, ps.LANES))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("positions", [(0, 1, 2, 3), (8, 9, 10, 11), (5, 17)])
def test_group_tiles_matches_group_pass(positions, seeded_rng, block_tiles):
    rng = seeded_rng(31)
    keys = _keys(rng, "uniform", N)
    vals = rng.sample_int_vector(N, 0, 0xFFFFFFFF)
    jk, jvs, jc = ps._group_pass(
        jnp.asarray(positions, jnp.int32), _jax_2d(keys, 0xFFFFFFFF, 3 * R), [_jax_2d(vals, 0, 3 * R)],
        R, True, nbits=len(positions),
    )
    tk, tvs, tc = cs.group_tiles(_t(keys), [_t(vals)], positions)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk).reshape(-1)[:N])
    np.testing.assert_array_equal(_u32(tvs[0]), np.asarray(jvs[0]).reshape(-1)[:N])
    want = np.asarray(jc).copy()
    want[-1, -1] -= PAD
    np.testing.assert_array_equal(tc.numpy(), want)


@pytest.mark.parametrize("kind", ["uniform", "mod3"])
def test_scatter_runs_matches_splice(kind, seeded_rng, block_tiles):
    # the JAX engine's multi-block pass, _pallas_sort.py:788-799
    rng = seeded_rng(41)
    keys = _keys(rng, kind, N)
    vals = np.arange(N, dtype=np.uint32)
    positions = (0, 1, 2, 3)
    ch, rd = ps._chunk_rows(R)
    slack = ps._slack_rows(ch, rd)
    rows = 3 * R + slack
    pos = jnp.asarray(positions, jnp.int32)
    gk, gvs, counts = ps._group_pass(
        pos, _jax_2d(keys, 0xFFFFFFFF, rows), [_jax_2d(vals, 0, rows)], R, True, 3
    )
    srcs, dsts, lens, nruns = ps._run_descriptors(counts, R)
    jk, jv = ps._splice_streams(srcs, dsts, lens, nruns, [gk] + gvs, rows, ch, rd, True)

    tk, tvs, tc = cs.group_tiles(_t(keys), [_t(vals)], positions)
    sk, svs = cs.scatter_runs(tk, tvs, tc, cs.run_offsets(tc), positions)
    np.testing.assert_array_equal(_u32(sk), np.asarray(jk).reshape(-1)[:N])
    np.testing.assert_array_equal(_u32(svs[0]), np.asarray(jv).reshape(-1)[:N])


@pytest.mark.parametrize("positions,streams", [(tuple(range(32)), 1), (tuple(range(12)), 0)])
def test_sort_single_tile_matches_single_block_sort(positions, streams, seeded_rng):
    rng = seeded_rng(51)
    n = BLOCK - 77
    keys = _keys(rng, "uniform", n)
    vals = np.arange(n, dtype=np.uint32)
    jk, jvs = ps._single_block_sort(
        _jax_2d(keys, 0xFFFFFFFF, R), [_jax_2d(vals, 0, R)][:streams], R, positions, True
    )
    tk, tvs = cs.sort_single_tile(_t(keys), [_t(vals)][:streams], positions)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk).reshape(-1)[:n])
    assert len(tvs) == streams
    for tv, jv in zip(tvs, jvs):
        np.testing.assert_array_equal(_u32(tv), np.asarray(jv).reshape(-1)[:n])


@pytest.mark.parametrize(
    "bit_positions,streams",
    [(None, 0), (None, 3), ((3, 9, 17, 30, 31), 2), ((0, 4, 8, 12, 16, 20, 24), 1)],
)
def test_engine_streams_match_jax(bit_positions, streams, seeded_rng, monkeypatch):
    # the engine's N-stream contract and its pass grouping (a 5-bit wide
    # pass; 7 bits as 4 + 3) against the JAX engine's portable path
    monkeypatch.setattr(cs, "TILE", 256)
    monkeypatch.setattr(cs, "SINGLE_TILE_MAX", 512)
    rng = seeded_rng(61)
    n = 5000
    keys = _keys(rng, "uniform", n)
    pays = [rng.sample_int_vector(n, 0, 0xFFFFFFFF) for _ in range(streams)]
    jk, jps = jax_sort_streams(
        jnp.asarray(keys), tuple(jnp.asarray(p) for p in pays), 8, "xla", bit_positions
    )
    tk, tps = cs.radix_sort_streams(_t(keys), [_t(p) for p in pays], 8, bit_positions)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    assert len(tps) == streams
    for tp, jp in zip(tps, jps):
        np.testing.assert_array_equal(_u32(tp), np.asarray(jp))


def test_run_offsets_matches_descriptors(seeded_rng):
    # the glue against _run_descriptors' destinations of the non-empty runs
    rng = seeded_rng(71)
    counts = rng.sample_int_vector(5 * 16, 0, 3).reshape(5, 16).astype(np.int32)
    counts[:, 7] = 0  # a digit with no run in any tile
    srcs, dsts, lens, nruns = ps._run_descriptors(jnp.asarray(counts), R)
    offsets = cs.run_offsets(torch.from_numpy(counts)).numpy()
    nonempty = counts.T.reshape(-1) > 0
    np.testing.assert_array_equal(offsets.T.reshape(-1)[nonempty], np.asarray(dsts)[: int(nruns)])


def test_wrappers_check_arguments():
    k = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(GluError, match="int32 words"):
        cs.group_tiles(k.view(torch.uint32), [], (0,))
    with pytest.raises(GluError, match="payload streams"):
        cs.group_tiles(k, [k] * cs.MAX_STREAMS, (0,))
    with pytest.raises(GluError, match="contiguous"):
        cs.group_tiles(torch.zeros(20, dtype=torch.int32)[::2], [], (0,))
    with pytest.raises(GluError, match="length mismatch"):
        cs.group_tiles(k, [k[:5]], (0,))
    with pytest.raises(GluError, match="bit positions"):
        cs.group_tiles(k, [], tuple(range(7)))
    with pytest.raises(GluError, match="distinct"):
        cs.sort_single_tile(k, [], (3, 3))
    with pytest.raises(GluError, match="0..31"):
        cs.sort_single_tile(k, [], (32,))
    with pytest.raises(GluError, match="single-tile"):
        cs.sort_single_tile(torch.zeros(cs.SINGLE_TILE_MAX + 1, dtype=torch.int32), [], (0,))
    counts = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(GluError, match="shape"):
        cs.scatter_runs(k, [], counts, counts, (0, 1))
    assert cs.launch_counts() == {"group_tiles": 0, "scatter_runs": 0, "sort_single_tile": 0}
