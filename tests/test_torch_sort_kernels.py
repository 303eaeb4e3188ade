"""The plain versions of the port's sort kernels (glu_tpu_torch/ops/_cuda_sort.py)
against the Pallas kernels they replace (glu_tpu/ops/_pallas_sort.py), run
directly in interpret mode at the smallest geometry: blocks of R=8 rows of
128 lanes, so the port's tile is shrunk to 1024 elements to match. Inputs
come from one seeded numpy generator and go to both; every output (keys,
payloads, counts) must be bit-identical. The kernels' own CPU path is their
plain version, so the wrappers are called where one exists.

A onesweep pass of 7-8 bits has no Pallas counterpart (its counts would not
fit the (8, 128) counts row), so those passes, and the engine's grouping of
bit positions into passes, are held against the JAX engine's portable path.

The JAX kernels take whole blocks padded with 0xFFFFFFFF keys; the port masks
its ragged last tile instead. A pad holds the top digit of every pass and
comes last, so the port's outputs equal the JAX outputs cut to n, and only
the top bin of the last block's counts differs, by the pad count.
"""

import functools

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
    tk, tvs, tc = cs.group_tiles_ref(_t(keys), [_t(vals)], positions)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk).reshape(-1)[:N])
    np.testing.assert_array_equal(_u32(tvs[0]), np.asarray(jvs[0]).reshape(-1)[:N])
    want = np.asarray(jc).copy()
    want[-1, -1] -= PAD
    np.testing.assert_array_equal(tc.numpy(), want)


def _jax_pass(keys, payloads, positions):
    """One pass of the JAX engine's multi-block path (_pallas_sort.py:788-799):
    _group_pass, then _run_descriptors, then _splice_streams; cut to N."""
    ch, rd = ps._chunk_rows(R)
    rows = 3 * R + ps._slack_rows(ch, rd)
    gk, gvs, counts = ps._group_pass(
        jnp.asarray(positions, jnp.int32), _jax_2d(keys, 0xFFFFFFFF, rows),
        [_jax_2d(p, 0, rows) for p in payloads], R, True, 3, nbits=len(positions),
    )
    srcs, dsts, lens, nruns = ps._run_descriptors(counts, R)
    outs = ps._splice_streams(srcs, dsts, lens, nruns, [gk] + gvs, rows, ch, rd, True)
    return [np.asarray(o).reshape(-1)[:N] for o in outs]


def _onesweep(keys, payloads, positions):
    """The port's pass as the engine runs it: the digit's base from
    digit_histograms, then onesweep_pass (their plain versions here)."""
    tk = _t(keys)
    hist = cs.digit_histograms(tk, [positions])[0, : 1 << len(positions)]
    ok, ops = cs.onesweep_pass(tk, [_t(p) for p in payloads], positions, torch.cumsum(hist, 0, dtype=torch.int32) - hist)
    return [_u32(o) for o in [ok, *ops]]


@pytest.mark.parametrize("kind", ["uniform", "mod3"])
def test_scatter_runs_matches_splice(kind, seeded_rng, block_tiles):
    # the plain stages of a pass, and the onesweep pass, against one JAX pass
    rng = seeded_rng(41)
    keys = _keys(rng, kind, N)
    vals = np.arange(N, dtype=np.uint32)
    positions = (0, 1, 2, 3)
    jk, jv = _jax_pass(keys, [vals], positions)

    tk, tvs, tc = cs.group_tiles_ref(_t(keys), [_t(vals)], positions)
    sk, svs = cs.scatter_runs_ref(tk, tvs, tc, cs.run_offsets(tc), positions)
    np.testing.assert_array_equal(_u32(sk), jk)
    np.testing.assert_array_equal(_u32(svs[0]), jv)
    for got, want in zip(_onesweep(keys, [vals], positions), [jk, jv]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "kind,streams,positions",
    [("uniform", 0, (0, 1, 2, 3, 4, 5)), ("mod3", 0, (0, 1, 2, 3)),
     ("uniform", 3, (5, 17)), ("mod3", 3, (1, 0, 9))],
)
def test_onesweep_pass_matches_jax_pass(kind, streams, positions, seeded_rng, block_tiles):
    # 0 and 3 payloads, 2-6 bits, non-contiguous and out-of-order positions
    # (1 payload: test_scatter_runs_matches_splice)
    rng = seeded_rng(43)
    keys = _keys(rng, kind, N)
    pays = [rng.sample_int_vector(N, 0, 0xFFFFFFFF) for _ in range(streams)]
    want = _jax_pass(keys, pays, positions)
    got = _onesweep(keys, pays, positions)
    assert len(got) == len(want) == 1 + streams
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("groups", [[(0, 1, 2, 3), (8, 9, 10, 11)], [(31, 2), (6,), (12, 13, 14, 15, 16, 17)]])
def test_digit_histograms_matches_group_pass_counts(groups, seeded_rng, block_tiles):
    # every pass's histogram in one call, against _group_pass's per-block
    # counts summed over the blocks (the pads hold the top digit)
    rng = seeded_rng(47)
    keys = _keys(rng, "uniform", N)
    hist = cs.digit_histograms(_t(keys), groups).numpy()
    assert hist.shape == (len(groups), cs.BINS) and hist.dtype == np.int32
    for p, g in enumerate(groups):
        _, _, jc = ps._group_pass(jnp.asarray(g, jnp.int32), _jax_2d(keys, 0xFFFFFFFF, 3 * R), [], R, True, nbits=len(g))
        want = np.asarray(jc).sum(axis=0)
        want[-1] -= PAD
        np.testing.assert_array_equal(hist[p, : 1 << len(g)], want)
        assert not hist[p, 1 << len(g):].any()


# 32 bits (4 passes of 8), 12 bits (8 + 4), 5 scattered bits out of order
# (one pass); 0, 1 and 3 payload streams
SINGLE_BLOCK_CASES = [(tuple(range(32)), 1), (tuple(range(12)), 0), (tuple(range(12)), 1), ((31, 0, 17, 5, 9), 1),
                      (tuple(range(32)), 3)]


@functools.lru_cache(maxsize=None)
def _single_block_case(rng_cls, positions, streams):
    """(keys, payloads, JAX keys, JAX payloads) of one block of BLOCK - 77
    elements sorted by _single_block_sort in interpret mode, run once per
    case for the tests of K3 on one CTA and on clusters."""
    rng = rng_cls(51)
    n = BLOCK - 77
    keys = _keys(rng, "uniform", n)
    vals = [np.arange(n, dtype=np.uint32)] + [rng.sample_int_vector(n, 0, 0xFFFFFFFF) for _ in range(streams - 1)]
    vals = vals[:streams]
    jk, jvs = ps._single_block_sort(
        _jax_2d(keys, 0xFFFFFFFF, R), [_jax_2d(v, 0, R) for v in vals], R, positions, True
    )
    return keys, vals, np.asarray(jk).reshape(-1)[:n], [np.asarray(jv).reshape(-1)[:n] for jv in jvs]


def _assert_single_block(got, case, streams) -> None:
    tk, tvs = got
    _, _, jk, jvs = case
    np.testing.assert_array_equal(_u32(tk), jk)
    assert len(tvs) == len(jvs) == streams
    for tv, jv in zip(tvs, jvs):
        np.testing.assert_array_equal(_u32(tv), jv)


@pytest.mark.parametrize("positions,streams", SINGLE_BLOCK_CASES)
def test_sort_single_tile_matches_single_block_sort(positions, streams, seeded_rng):
    case = _single_block_case(seeded_rng, positions, streams)
    keys, vals = case[:2]
    assert cs.single_tile_ctas(keys.size) == 1
    _assert_single_block(cs.sort_single_tile(_t(keys), [_t(v) for v in vals], positions), case, streams)
    # the function's plain reference, which K3 on the card is held against
    _assert_single_block(cs.sort_single_tile_ref(_t(keys), [_t(v) for v in vals], positions), case, streams)


@pytest.mark.parametrize("ctas", [2, 3, 4])
@pytest.mark.parametrize("positions,streams", SINGLE_BLOCK_CASES)
def test_sort_single_tile_cluster_matches_single_block_sort(positions, streams, ctas, seeded_rng):
    # K3 on a cluster of 2, 3 and 4 CTAs (its plain version: each CTA's
    # digit counts, the cluster-wide starts, each element's rank stored in
    # the CTA whose slice holds it): slices of 476 (the last CTA holds 471),
    # 316 (the last 315) and 240 (the last 227)
    case = _single_block_case(seeded_rng, positions, streams)
    keys, vals = case[:2]
    per_cta = cs.single_tile_slice(keys.size, ctas)
    assert 0 < keys.size - (ctas - 1) * per_cta < per_cta
    _assert_single_block(cs.sort_single_tile(_t(keys), [_t(v) for v in vals], positions, ctas=ctas), case, streams)


def test_single_tile_ctas_and_slices():
    # one CTA up to CTA_MAX, then a cluster of MAX_CLUSTER; slices of whole
    # 16-byte vectors, the last CTA holding what is left
    assert cs.SINGLE_TILE_MAX == ps._FUSE_MAX_R * ps.LANES == 65536
    assert cs.single_tile_ctas(cs.CTA_MAX) == 1 and cs.single_tile_slice(cs.CTA_MAX, 1) == cs.CTA_MAX
    assert cs.single_tile_ctas(cs.CTA_MAX + 1) == cs.MAX_CLUSTER == 8
    assert cs.single_tile_ctas(cs.SINGLE_TILE_MAX) == 8 and cs.single_tile_slice(65536, 8) == 8192
    assert [cs.single_tile_slice(65536, c) for c in (3, 4)] == [21848, 16384]
    assert cs.single_tile_slice(24577, 8) == 3076  # the last CTA holds 3,045
    assert cs.CTA_MAX <= cs.SLICE_MAX and cs.MAX_CLUSTER * cs.SLICE_MAX >= cs.SINGLE_TILE_MAX


@pytest.mark.parametrize("n,ctas", [(65536, 3), (16385, 1), (100, 0), (100, 9)])
def test_sort_single_tile_refuses_ctas_that_cannot_hold_it(n, ctas):
    # as the C entry does: 1 to MAX_CLUSTER CTAs, each slice at most SLICE_MAX
    keys = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(GluError, match="CTAs"):
        cs.sort_single_tile(keys, [], tuple(range(32)), ctas=ctas)


@pytest.mark.parametrize(
    "positions,nbits",
    [(tuple(range(32)), [8, 8, 8, 8]), (tuple(range(12)), [8, 4]), ((31, 0, 17, 5, 9), [5]),
     (tuple(range(24, 32)), [8])],
)
def test_plan_args_follow_the_passes(positions, nbits):
    # the C form of a sort's passes that digit_histograms and K3 both take:
    # every pass's bits one after another (LSB-first), the bits per pass,
    # the pass count; passes of up to 8 bits in the order given
    bits, per_pass, npasses = cs._plan_args(cs._pass_groups(positions))
    assert list(bits) == list(positions)
    assert list(per_pass) == nbits
    assert npasses == len(nbits)


@pytest.mark.parametrize(
    "bit_positions,streams",
    [(None, 0), (None, 3), ((3, 9, 17, 30, 31), 2), ((0, 4, 8, 12, 16, 20, 24), 1),
     (tuple(range(8)), 1), (tuple(range(7)), 0), (tuple(range(24, 32)), 7),
     ((30, 1, 17, 4, 22, 9, 13, 27, 0, 5, 11), 1), (tuple(range(4, 32)), 1)],
)
def test_engine_streams_match_jax(bit_positions, streams, seeded_rng, monkeypatch):
    # the engine's N-stream contract (up to 7 payloads) and its grouping into
    # passes of up to 8 bits (one 8-bit pass, one of 7 bits, 8 + 3 bits out
    # of order, 28 bits as 8 + 8 + 8 + 4) against the JAX engine's portable
    # path
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


def test_onesweep_look_back_over_sparse_tiles(seeded_rng, monkeypatch):
    # 40 tiles of 64 and a ragged one, where most digits are empty in most
    # tiles: every tile's place comes from the counts of the tiles before
    # it; against the JAX engine on the same single 8-bit pass
    monkeypatch.setattr(cs, "TILE", 64)
    rng = seeded_rng(67)
    n = 40 * 64 + 23
    low = np.sort(rng.sample_int_vector(n, 0, 255))          # few digits per tile, rising
    low[rng.sample_int_vector(50, 0, n - 1)] = 0xB7          # one digit scattered over some tiles
    keys = (rng.sample_int_vector(n, 0, 0xFFFFFF) << np.uint32(8)) | low
    vals = np.arange(n, dtype=np.uint32)
    for positions in (tuple(range(8)), (8, 1, 2, 3, 4, 5, 6, 7)):
        tk = _t(keys)
        hist = cs.digit_histograms(tk, [positions])
        np.testing.assert_array_equal(hist[0].numpy(), np.bincount(cs._digits(tk, positions).numpy(), minlength=cs.BINS))
        _, _, counts = cs.group_tiles_ref(tk, [], positions)
        assert (counts == 0).float().mean() > 0.8  # mostly empty (tile, digit) runs
        jk, (jv,) = jax_sort_streams(jnp.asarray(keys), (jnp.asarray(vals),), 8, "xla", positions)
        got = _onesweep(keys, [vals], positions)
        np.testing.assert_array_equal(got[0], np.asarray(jk))
        np.testing.assert_array_equal(got[1], np.asarray(jv))


def test_wrappers_check_arguments():
    k = torch.zeros(10, dtype=torch.int32)
    base = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(GluError, match="int32 words"):
        cs.onesweep_pass(k.view(torch.uint32), [], (0,), base)
    with pytest.raises(GluError, match="payload streams"):
        cs.onesweep_pass(k, [k] * cs.MAX_STREAMS, (0,), base)
    with pytest.raises(GluError, match="contiguous"):
        cs.onesweep_pass(torch.zeros(20, dtype=torch.int32)[::2], [], (0,), base)
    with pytest.raises(GluError, match="length mismatch"):
        cs.onesweep_pass(k, [k[:5]], (0,), base)
    with pytest.raises(GluError, match="bit positions"):
        cs.onesweep_pass(k, [], tuple(range(9)), torch.zeros(512, dtype=torch.int32))
    with pytest.raises(GluError, match="digit_base"):
        cs.onesweep_pass(k, [], (0, 1), base)
    with pytest.raises(GluError, match="digit_base"):
        cs.onesweep_pass(k, [], (0,), base.to(torch.int64))
    with pytest.raises(GluError, match="passes"):
        cs.digit_histograms(k, [])
    with pytest.raises(GluError, match="passes"):
        cs.digit_histograms(k, [(0,)] * (cs.MAX_PASSES + 1))
    with pytest.raises(GluError, match="bit positions"):
        cs.digit_histograms(k, [tuple(range(9))])
    with pytest.raises(GluError, match="distinct"):
        cs.sort_single_tile(k, [], (3, 3))
    with pytest.raises(GluError, match="0..31"):
        cs.sort_single_tile(k, [], (32,))
    with pytest.raises(GluError, match="single-tile"):
        cs.sort_single_tile(torch.zeros(cs.SINGLE_TILE_MAX + 1, dtype=torch.int32), [], (0,))
    assert cs.launch_counts() == {"digit_histograms": 0, "onesweep_pass": 0, "sort_single_tile": 0}
