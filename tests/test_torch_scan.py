"""The port's scan (glu_tpu_torch.exclusive_scan, inclusive_scan,
BlellochScan) against glu_tpu's, on the cases of tests/test_scan.py. Inputs
come from one seeded numpy generator and go to both packages.

The JAX side runs through the `backend` fixture: "xla", and "pallas", the K4
Pallas kernel in interpret mode. Each case runs through both of the port's
backends: "cuda", whose kernel wrappers here run their plain torch versions
with the tile shrunk to 64 elements, so that small inputs span many tiles,
ragged tails and several partitions; and "torch", torch's own scans.

Tolerance: integers bit for bit; floats rtol 1e-4, atol 1e-3, the JAX
package's own (tests/test_scan.py:299), since sums are taken in another
order. NaN must come out where the JAX package puts it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glu_tpu
import glu_tpu_torch
from glu_tpu.native import get_oracle
from glu_tpu_torch import BlellochScan, DataType, DeviceBuffer, ReduceOperator, from_numpy, to_numpy
from glu_tpu_torch.ops import _cuda_reduce as cr
from glu_tpu_torch.ops import _cuda_scan as cs
from glu_tpu_torch.ops.reference import ref_exclusive_scan

SMALL_TILE = 64
PORT_BACKENDS = ("cuda", "torch")
OPS = list(ReduceOperator)
NON_SUM = [ReduceOperator.MUL, ReduceOperator.MIN, ReduceOperator.MAX]
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64, torch.int32: np.int32, torch.uint32: np.uint32}


@pytest.fixture(autouse=True)
def small_tiles(monkeypatch):
    monkeypatch.setattr(cr, "TILE", SMALL_TILE)
    monkeypatch.setattr(cs, "TILE", SMALL_TILE)


def _jop(op: ReduceOperator):
    return glu_tpu.ReduceOperator(op.value)


def _t(a: np.ndarray) -> torch.Tensor:
    return from_numpy(a, "cpu")


def _assert_port(fn, want, floating: bool = False) -> None:
    """fn(backend) -> tensor, for each of the port's backends, against
    `want`: bit for bit, or rtol 1e-4 / atol 1e-3 for floats."""
    want = np.asarray(want)
    for b in PORT_BACKENDS:
        got = to_numpy(fn(b))
        assert got.dtype == want.dtype and got.shape == want.shape, b
        if floating:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3, err_msg=b)
        else:
            np.testing.assert_array_equal(got, want, err_msg=b)


def _check_exclusive(data, backend, num_partitions=1, op=ReduceOperator.SUM, floating=False):
    want = glu_tpu.exclusive_scan(jnp.asarray(data), num_partitions, _jop(op), backend=backend)
    _assert_port(lambda b: glu_tpu_torch.exclusive_scan(_t(data), num_partitions, op, backend=b), want, floating)
    return np.asarray(want)


@pytest.mark.parametrize("size", [1024, 4096, 65536])
def test_scan_multiple_sizes(size, backend, seeded_rng):
    # test_scan.py:49 (reference blelloch_scan_tests.cpp:28-46)
    data = seeded_rng(size).sample_int_vector(size, 0, 1000)
    want = _check_exclusive(data, backend)
    np.testing.assert_array_equal(to_numpy(ref_exclusive_scan(_t(data))), want)


@pytest.mark.parametrize("num_partitions", [1, 32, 100])
def test_scan_multiple_partitions(num_partitions, backend, seeded_rng):
    # test_scan.py:59: 1024-element partitions scanned independently
    data = seeded_rng(num_partitions).sample_int_vector(1024 * num_partitions, 0, 100)
    want = _check_exclusive(data, backend, num_partitions)
    np.testing.assert_array_equal(to_numpy(ref_exclusive_scan(_t(data), num_partitions)), want)


@pytest.mark.parametrize("size", [1, 5, 100, 1000, 12345, 99999])
def test_scan_non_power_of_2(size, backend, seeded_rng):
    # test_scan.py:70: ragged lengths never leak the masked tail
    _check_exclusive(seeded_rng(size).sample_int_vector(size, 0, 1000), backend)


def test_scan_wraps_mod_2_32(backend):
    _check_exclusive(np.full(1024, 0x80000001, dtype=np.uint32), backend)


def test_scan_int32(backend):
    _check_exclusive(np.array([3, -1, 4, -1, 5, -9, 2, 6] * 4, dtype=np.int32), backend)


@pytest.mark.parametrize("op", NON_SUM)
@pytest.mark.parametrize("size", [1, 100, 1024, 12345])
def test_scan_ops_u32(op, size, backend, seeded_rng):
    # test_scan.py:112: mul/min/max, ragged and multi-tile
    data = seeded_rng(size * 10 + op.value).sample_int_vector(size, 0, 0xFFFFFFFF)
    if op == ReduceOperator.MUL:
        data = (data | 1).astype(np.uint32)  # odd factors: u32 products wrap, stay nonzero
    _check_exclusive(data, backend, op=op)


@pytest.mark.parametrize("op", NON_SUM)
@pytest.mark.parametrize("num_partitions", [4, 100])
def test_scan_ops_partitions(op, num_partitions, backend, seeded_rng):
    # test_scan.py:125: the carry resets to the identity at every partition
    data = seeded_rng(num_partitions + op.value).sample_int_vector(512 * num_partitions, 0, 0xFFFFFFFF)
    want = _check_exclusive(data, backend, num_partitions, op)
    np.testing.assert_array_equal(want, get_oracle().exclusive_scan_op(data, num_partitions, op.name.lower()))


@pytest.mark.parametrize("op", OPS)
def test_scan_partitions_ragged_tiles(op, backend, seeded_rng):
    # 7 partitions of 1000: each partition ends in a ragged tile, and the
    # carry chains over 16 tiles within each
    data = seeded_rng(42 + op.value).sample_int_vector(7 * 1000, 0, 0xFFFFFFFF)
    data = data | 1 if op == ReduceOperator.MUL else data
    want = _check_exclusive(data, backend, 7, op)
    np.testing.assert_array_equal(want, get_oracle().exclusive_scan_op(data, 7, op.name.lower()))


@pytest.mark.parametrize("op", [ReduceOperator.MIN, ReduceOperator.MAX])
def test_scan_ops_int32_negatives(op, backend):
    # test_scan.py:148
    data = np.array([3, -1, 4, -1, 5, -9, 2, 6, -2147483648, 2147483647] * 200, dtype=np.int32)
    _check_exclusive(data, backend, op=op)


@pytest.mark.parametrize("op", [ReduceOperator.MIN, ReduceOperator.MAX])
def test_scan_ops_f32(op, backend, seeded_rng):
    # test_scan.py:155
    data = (seeded_rng(7 + op.value).sample_int_vector(5000, 0, 2_000_000).astype(np.int64) - 1_000_000)
    _check_exclusive(data.astype(np.float32), backend, op=op, floating=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("op", [ReduceOperator.MIN, ReduceOperator.MAX])
def test_scan_nan_propagates(op, dtype, backend, seeded_rng):
    # jnp.minimum / jnp.maximum propagate NaN: every prefix past it is NaN
    data = seeded_rng(13).rng.uniform(-1, 1, 700).astype(dtype)
    data[400] = np.nan
    want = _check_exclusive(data, backend, op=op, floating=True)
    assert np.isnan(want[401:]).all() and not np.isnan(want[:401]).any()


def test_scan_mul_wraps_mod_2_32(backend):
    _check_exclusive(np.full(4096, 0x80000003, dtype=np.uint32), backend, op=ReduceOperator.MUL)


@pytest.mark.parametrize("op", OPS)
def test_inclusive_scan(op, backend, seeded_rng):
    # test_scan.py:171
    data = seeded_rng(op.value).sample_int_vector(10000, 0, 0xFFFFFFFF)
    want = glu_tpu.inclusive_scan(jnp.asarray(data), op=_jop(op), backend=backend)
    _assert_port(lambda b: glu_tpu_torch.inclusive_scan(_t(data), op=op, backend=b), want)


def test_scan_empty():
    # n == 0: an empty result, and nothing runs
    for b in PORT_BACKENDS:
        for shape in ((0,), (0, 4)):
            out = glu_tpu_torch.exclusive_scan(torch.zeros(shape, dtype=torch.int32), backend=b)
            assert out.shape == shape and out.dtype == torch.int32
    assert cs.launch_counts() == {"exclusive_scan": 0}


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32, np.float64])
@pytest.mark.parametrize("op", OPS)
def test_scan_partitions_match_pallas_kernel(op, dtype, monkeypatch, seeded_rng):
    # K4 on its own: the plain version of the port's kernel against
    # pallas_exclusive_scan in interpret mode, 3 partitions of 1000 (16
    # tiles each, the last one ragged)
    from glu_tpu.ops._pallas_scan import pallas_exclusive_scan

    monkeypatch.setenv("GLU_TPU_PALLAS_INTERPRET", "1")
    rng = seeded_rng(17 + op.value)
    if np.issubdtype(dtype, np.floating):
        x = rng.rng.uniform(0.999, 1.001 if op == ReduceOperator.MUL else 2.0, 3000).astype(dtype)
    else:
        x = rng.sample_int_vector(3000, 0, 0xFFFFFFFF).astype(dtype)
    want = np.asarray(pallas_exclusive_scan(jnp.asarray(x), 3, _jop(op)))
    got = to_numpy(cs.exclusive_scan_partitions(_t(x).reshape(3, 1000), op)).reshape(-1)
    if np.issubdtype(dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


def test_plain_k4_carries_are_the_left_fold_of_tile_aggregates():
    # The kernel's look-back folds the aggregates left to right, so tile j's
    # carry is ((agg0 + agg1) + ...) + agg[j-1], rounded at every step. With
    # these f32 aggregates that is 1e8 for every tile past the first, where
    # the exact sum, or a tree that adds the 3s first, rounds to 100000008.
    aggs = np.array([1e8, 3, 3, 3, 5], dtype=np.float32)
    want, run = [np.float32(0)], aggs[0]
    for a in aggs[1:-1]:
        want.append(run)
        run = np.float32(run + a)
    want.append(run)
    assert want[-1] == np.float32(1e8) != np.float32(aggs[:-1].astype(np.float64).sum())
    carries = cs.tile_carries(_t(aggs).reshape(1, -1), ReduceOperator.SUM, 0.0)
    np.testing.assert_array_equal(to_numpy(carries)[0], np.array(want, dtype=np.float32))
    # through the plain version: one aggregate per tile, at its first slot,
    # so the scan at each tile's first slot is that tile's carry
    x = np.zeros((2, len(aggs) * SMALL_TILE), dtype=np.float32)
    x[:, ::SMALL_TILE] = aggs
    out = to_numpy(cs.exclusive_scan_partitions(_t(x), ReduceOperator.SUM))
    np.testing.assert_array_equal(out[:, ::SMALL_TILE], np.array([want, want], dtype=np.float32))


# Non-finite values of a float SUM (fault F1), inside and at the edges of the
# 64-element tiles: the first slot of a tile, the last one, and an inf and a
# -inf in different tiles, whose sum is NaN from the slot after the -inf on.
NON_FINITE = {
    "nan": [(130, np.nan)],
    "+inf": [(64, np.inf)],
    "-inf": [(127, -np.inf)],
    "+inf then -inf": [(63, np.inf), (300, -np.inf)],
}


@pytest.mark.parametrize("num_partitions", [1, 2])
@pytest.mark.parametrize("inclusive", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(NON_FINITE))
def test_scan_sum_non_finite_is_exact(case, dtype, inclusive, num_partitions):
    # Both port backends give the exact scan: NaN from one slot after a NaN
    # input, inf finite at its own slot in the exclusive scan. The reference
    # is a float64 cumsum, shifted one slot for the exclusive scan, not the
    # JAX package, whose backends disagree here (ROADMAP, fault F1).
    data = np.random.default_rng(21).uniform(0, 1, 700).astype(dtype)
    for i, v in NON_FINITE[case]:
        data[i] = v
    inc = np.cumsum(data.astype(np.float64).reshape(num_partitions, -1), axis=1)
    want = inc if inclusive else np.concatenate([np.zeros((num_partitions, 1)), inc[:, :-1]], axis=1)
    want = want.reshape(-1)
    fn = glu_tpu_torch.inclusive_scan if inclusive else glu_tpu_torch.exclusive_scan
    for b in PORT_BACKENDS:
        got = to_numpy(fn(_t(data), num_partitions, backend=b))
        assert got.dtype == dtype, b
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=b)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3, err_msg=b)


def test_scan_sum_inf_example():
    # [1, 2, inf, 3, 4]: the exclusive value at the inf's slot is finite
    data = np.array([1, 2, np.inf, 3, 4], dtype=np.float32)
    for b in PORT_BACKENDS:
        np.testing.assert_array_equal(to_numpy(glu_tpu_torch.exclusive_scan(_t(data), backend=b)),
                                      [0, 1, 3, np.inf, np.inf])
        np.testing.assert_array_equal(to_numpy(glu_tpu_torch.inclusive_scan(_t(data), backend=b)),
                                      [1, 3, np.inf, np.inf, np.inf])


def test_scan_class_requires_power_of_2():
    # test_scan.py:91 (reference BlellochScan.hpp:134)
    from glu_tpu_torch.utils.errors import GluArgumentError

    buf = DeviceBuffer(np.arange(100, dtype=np.uint32), device="cpu")
    with pytest.raises(GluArgumentError):
        BlellochScan(DataType.UINT)(buf, 100)


def test_scan_class_in_place(backend):
    # test_scan.py:99: the buffer's own storage takes the result
    data = np.arange(1, 17, dtype=np.uint32)
    jbuf = glu_tpu.DeviceBuffer(data)
    glu_tpu.BlellochScan(glu_tpu.DataType.UINT)(jbuf, 16, backend=backend)
    for b in PORT_BACKENDS:
        buf = DeviceBuffer(data, device="cpu")
        storage = buf.data.data_ptr()
        out = BlellochScan(DataType.UINT)(buf, 16, backend=b)
        np.testing.assert_array_equal(buf.get_data(), jbuf.get_data())
        assert buf.data.data_ptr() == storage and out.data_ptr() == storage


def test_scan_class_operator(backend):
    # test_scan.py:178: a non-default operator
    data = np.array([5, 3, 9, 1, 7, 2, 8, 4] * 2, dtype=np.uint32)
    jbuf = glu_tpu.DeviceBuffer(data)
    glu_tpu.BlellochScan(glu_tpu.DataType.UINT, glu_tpu.ReduceOperator.MAX)(jbuf, 16, backend=backend)
    for b in PORT_BACKENDS:
        buf = DeviceBuffer(data, device="cpu")
        BlellochScan(DataType.UINT, ReduceOperator.MAX)(buf, 16, backend=b)
        np.testing.assert_array_equal(buf.get_data(), jbuf.get_data())


def test_scan_class_partitions_subset(backend):
    # test_scan.py:192: 4 partitions of 8 in a buffer of 64; the rest stays
    data = np.arange(64, dtype=np.uint32)
    jbuf = glu_tpu.DeviceBuffer(data)
    glu_tpu.BlellochScan(glu_tpu.DataType.UINT)(jbuf, 8, 4, backend=backend)
    for b in PORT_BACKENDS:
        buf = DeviceBuffer(data, device="cpu")
        BlellochScan(DataType.UINT)(buf, 8, 4, backend=b)
        np.testing.assert_array_equal(buf.get_data(), jbuf.get_data())
        # a tensor comes back as a new tensor; the caller's stays as it was
        t = _t(data)
        out = BlellochScan(DataType.UINT)(t, 8, 4, backend=b)
        np.testing.assert_array_equal(to_numpy(out), jbuf.get_data()[:32])
        np.testing.assert_array_equal(to_numpy(t), data)


@pytest.mark.parametrize("data_type", list(DataType))
@pytest.mark.parametrize("op", [ReduceOperator.SUM, ReduceOperator.MIN])
def test_scan_all_types(data_type, op, backend, seeded_rng):
    # test_scan.py:316: every DataType, 2 partitions, vectors per component,
    # under SUM and under MIN (its identity and, for u32, the unsigned
    # order); MUL and MAX on every base type are in the tests above and in
    # test_scan_partitions_match_pallas_kernel
    info = glu_tpu_torch.dtype_info(data_type)
    rng = seeded_rng(9)
    shape = (200,) + info.element_shape()
    if info.dtype.is_floating_point:
        host = rng.rng.uniform(0.5, 1.5, size=shape)
    elif info.dtype == torch.int32:
        host = rng.rng.integers(-3, 4, size=shape)
    else:
        host = rng.rng.integers(1, 3, size=shape)
    _check_exclusive(host.astype(_NP_DTYPE[info.dtype]), backend, 2, op, info.dtype.is_floating_point)


@pytest.mark.parametrize("data_type", [DataType.UVEC2, DataType.VEC4])
def test_blelloch_scan_class_vector(data_type, backend, seeded_rng):
    # test_scan.py:355, with the wrong trailing shape rejected
    from glu_tpu_torch.utils.errors import GluArgumentError

    info = glu_tpu_torch.dtype_info(data_type)
    host = seeded_rng(11).rng.integers(0, 9, size=(32, info.components)).astype(_NP_DTYPE[info.dtype])
    want = glu_tpu.BlellochScan(glu_tpu.DataType[data_type.name])(jnp.asarray(host), 32, backend=backend)
    _assert_port(lambda b: BlellochScan(data_type)(_t(host), 32, backend=b), want)
    with pytest.raises(GluArgumentError):
        BlellochScan(data_type)(_t(host[:, :1]), 32)


def test_scan_inclusive_vector(backend, seeded_rng):
    # test_scan.py:373
    host = seeded_rng(12).rng.integers(0, 9, size=(24, 4)).astype(np.uint32)
    want = glu_tpu.inclusive_scan(jnp.asarray(host), backend=backend)
    _assert_port(lambda b: glu_tpu_torch.inclusive_scan(_t(host), backend=b), want)


def test_scan_rejects_what_jax_rejects(backend):
    # test_scan.py:187, :241 and :380, and the argument checks of scan.py:79-92
    from glu_tpu.utils.errors import GluArgumentError as JaxArgumentError
    from glu_tpu_torch.utils.errors import GluArgumentError, GluError

    x = np.arange(10, dtype=np.uint32)
    bad = [
        (x, dict(op="sum")),
        (np.zeros((2, 2, 2), np.uint32), {}),
        (x, dict(num_partitions=3)),
        (x, dict(num_partitions=0)),
        (x, dict(offsets=np.array([1, 10], np.int32))),
        (x, dict(num_partitions=2, offsets=np.array([0, 10], np.int32))),
        (np.ones((8, 2), np.uint32), dict(offsets=np.array([0, 8], np.int32))),
    ]
    for data, kw in bad:
        with pytest.raises(JaxArgumentError):
            jkw = {k: jnp.asarray(v) if k == "offsets" else v for k, v in kw.items()}
            glu_tpu.exclusive_scan(jnp.asarray(data), backend=backend, **jkw)
        for b in PORT_BACKENDS:
            with pytest.raises(GluArgumentError):
                glu_tpu_torch.exclusive_scan(_t(data), backend=b, **kw)
    with pytest.raises(JaxArgumentError):
        glu_tpu.BlellochScan(glu_tpu.DataType.UINT)(glu_tpu.DeviceBuffer(x), 8, 2)  # 16 > 10
    with pytest.raises(GluArgumentError):
        BlellochScan(DataType.UINT)(DeviceBuffer(x, device="cpu"), 8, 2)
    # beyond the JAX package: the four kernel dtypes and the backend
    for dtype in (torch.int64, torch.float16, torch.bool):
        with pytest.raises(GluArgumentError, match="not supported"):
            glu_tpu_torch.exclusive_scan(torch.ones(4, dtype=dtype))
    with pytest.raises(GluError):
        glu_tpu_torch.inclusive_scan(_t(x), backend="xla")
