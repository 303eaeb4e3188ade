"""The port's reduce (glu_tpu_torch.reduce, segmented_reduce, Reduce) against
glu_tpu's, on the cases of tests/test_reduce.py. Inputs come from one seeded
numpy generator and go to both packages.

The JAX side runs through the `backend` fixture: "xla", and "pallas", the K5
Pallas kernel in interpret mode. Each case runs through both of the port's
backends: "cuda", whose kernel wrappers here run their plain torch versions
with the tile shrunk to 64 elements, so that small inputs span many tiles
and ragged tails; and "torch", torch's own reductions.

Tolerance: integers bit for bit; floats rtol 1e-4, atol 1e-3, the JAX
package's own (tests/test_reduce.py:63), since sums are taken in another
order. NaN must come out where the JAX package puts it.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glu_tpu
import glu_tpu_torch
from glu_tpu.native import get_oracle
from glu_tpu.ops.reduce import identity_for as jax_identity_for
from glu_tpu_torch import DataType, DeviceBuffer, Reduce, ReduceOperator, from_numpy, to_numpy
from glu_tpu_torch.ops import _cuda_reduce as cr
from glu_tpu_torch.ops import _cuda_scan as cs
from glu_tpu_torch.ops.reduce import identity_for
from glu_tpu_torch.ops.reference import ref_reduce

SMALL_TILE = 64
PORT_BACKENDS = ("cuda", "torch")
OPS = list(ReduceOperator)
_NP_OP = {ReduceOperator.SUM: np.add, ReduceOperator.MUL: np.multiply,
          ReduceOperator.MIN: np.minimum, ReduceOperator.MAX: np.maximum}


@pytest.fixture(autouse=True)
def small_tiles(monkeypatch):
    monkeypatch.setattr(cr, "TILE", SMALL_TILE)
    monkeypatch.setattr(cs, "TILE", SMALL_TILE)


def _jop(op: ReduceOperator):
    return glu_tpu.ReduceOperator(op.value)


def _t(a: np.ndarray) -> torch.Tensor:
    return from_numpy(a, "cpu")


def _assert_port(fn, want, floating: bool) -> None:
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


@pytest.mark.parametrize("op", OPS)
def test_reduce_simple_uint(op, backend):
    # test_reduce.py:27 (reference test/reduce_tests.cpp:14-52)
    data = np.arange(1, 101, dtype=np.uint32)
    want = glu_tpu.reduce(jnp.asarray(data), _jop(op), backend=backend)
    _assert_port(lambda b: glu_tpu_torch.reduce(_t(data), op, backend=b), want, False)


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64, torch.int32: np.int32, torch.uint32: np.uint32}


def _typed_data(info, rng, n):
    """test_reduce.py:51-58: small values, negatives for int32"""
    shape = (n,) + info.element_shape()
    if info.dtype.is_floating_point:
        host = rng.rng.uniform(0.5, 1.5, size=shape)
    elif info.dtype == torch.int32:
        host = rng.rng.integers(-3, 4, size=shape)
    else:
        host = rng.rng.integers(1, 3, size=shape)
    return host.astype(_NP_DTYPE[info.dtype])


@pytest.mark.parametrize("data_type", list(DataType))
@pytest.mark.parametrize("op", OPS)
def test_reduce_all_types(data_type, op, backend, seeded_rng):
    # test_reduce.py:43: every (DataType, op), vectors per component
    info = glu_tpu_torch.dtype_info(data_type)
    host = _typed_data(info, seeded_rng(3), 200)
    want = glu_tpu.reduce(jnp.asarray(host), _jop(op), backend=backend)
    _assert_port(lambda b: glu_tpu_torch.reduce(_t(host), op, backend=b), want, info.dtype.is_floating_point)


@pytest.mark.parametrize("size", [32, 1024, 4096, 131072])
def test_reduce_fitting_sizes(size, backend, seeded_rng):
    # test_reduce.py:69
    data = seeded_rng(1).sample_int_vector(size, 0, 100)
    want = glu_tpu.reduce(jnp.asarray(data), glu_tpu.ReduceOperator.SUM, backend=backend)
    _assert_port(lambda b: glu_tpu_torch.reduce(_t(data), backend=b), want, False)


@pytest.mark.parametrize("size", [1, 31, 201, 2087, 88289])
@pytest.mark.parametrize("op", OPS)
def test_reduce_non_fitting_sizes(size, op, backend, seeded_rng):
    # test_reduce.py:79: ragged sizes must not read the masked tail as data
    lo, hi = (1, 1) if op == ReduceOperator.MUL else (0, 1000)
    data = seeded_rng(size).sample_int_vector(size, lo, hi)
    want = glu_tpu.reduce(jnp.asarray(data), _jop(op), backend=backend)
    assert np.asarray(want) == get_oracle().reduce_u32(data, op.name.lower())
    _assert_port(lambda b: glu_tpu_torch.reduce(_t(data), op, backend=b), want, False)


@pytest.mark.parametrize("op", [ReduceOperator.SUM, ReduceOperator.MUL])
def test_reduce_wraps_mod_2_32(op, backend):
    # test_reduce.py:89: u32 sums (and products) wrap like GLSL uint
    data = np.full(1000, 0xF0000003, dtype=np.uint32)
    want = glu_tpu.reduce(jnp.asarray(data), _jop(op), backend=backend)
    _assert_port(lambda b: glu_tpu_torch.reduce(_t(data), op, backend=b), want, False)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("op", [ReduceOperator.MIN, ReduceOperator.MAX])
def test_reduce_nan_propagates(op, dtype, backend, seeded_rng):
    # jnp.minimum / jnp.maximum propagate NaN (CUDA's fminf / fmaxf would not)
    data = seeded_rng(5).rng.uniform(-1, 1, 500).astype(dtype)
    data[317] = np.nan
    want = glu_tpu.reduce(jnp.asarray(data), _jop(op), backend=backend)
    assert np.isnan(np.asarray(want))
    _assert_port(lambda b: glu_tpu_torch.reduce(_t(data), op, backend=b), want, True)


@pytest.mark.parametrize("op", OPS)
def test_reduce_partitions_match_pallas_kernel(op, monkeypatch, seeded_rng):
    # K5 on its own: the plain version of the port's kernel, row by row,
    # against _pallas_reduce_flat in interpret mode; rows of 1000 are
    # ragged against the 64-element tile
    from glu_tpu.ops._pallas_reduce import pallas_reduce

    monkeypatch.setenv("GLU_TPU_PALLAS_INTERPRET", "1")
    rng = seeded_rng(7 + op.value)
    x = rng.sample_int_vector(5 * 1000, 0, 0xFFFFFFFF).reshape(5, 1000)
    if op == ReduceOperator.MUL:
        x |= 1
    got = to_numpy(cr.reduce_partitions(_t(x), op))
    want = np.array([np.asarray(pallas_reduce(jnp.asarray(row), _jop(op))) for row in x], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _NP_OP[op].reduce(x, axis=1, dtype=np.uint32))
    assert cr.launch_counts() == {"reduce": 0}  # plain versions launch nothing


VECTOR_TYPES = [t for t in DataType if glu_tpu_torch.dtype_info(t).components > 1]


@pytest.mark.parametrize("comps", [2, 4])
@pytest.mark.parametrize("dtype", [np.uint32, np.float32])
@pytest.mark.parametrize("op", OPS)
def test_reduce_partitions_vectors_match_pallas_kernel(op, dtype, comps, monkeypatch, seeded_rng):
    # K5 on (P, L, C): the plain version, each row's 333 * C flat elements
    # ragged against the 64-element tile, against _pallas_reduce_flat in
    # interpret mode on each row's (L, C) through pallas_reduce
    from glu_tpu.ops._pallas_reduce import pallas_reduce

    monkeypatch.setenv("GLU_TPU_PALLAS_INTERPRET", "1")
    rng = seeded_rng(11 + 4 * op.value + comps)
    shape = (3, 333, comps)
    if dtype == np.uint32:
        x = rng.sample_int_vector(int(np.prod(shape)), 0, 0xFFFFFFFF).reshape(shape)
        if op == ReduceOperator.MUL:
            x |= 1
    else:
        x = rng.rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
    got = to_numpy(cr.reduce_partitions(_t(x), op))
    want = np.stack([np.asarray(pallas_reduce(jnp.asarray(row), _jop(op))) for row in x])
    assert got.shape == want.shape == (3, comps) and got.dtype == want.dtype
    if dtype == np.uint32:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _NP_OP[op].reduce(x, axis=1, dtype=np.uint32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert cr.launch_counts() == {"reduce": 0}


@pytest.mark.parametrize("data_type", VECTOR_TYPES)
@pytest.mark.parametrize("op", OPS)
def test_reduce_vector_types_over_many_tiles(data_type, op, backend, seeded_rng):
    # every vector DataType as an (N, C) stream over many 64-element tiles and
    # a ragged tail, which the "cuda" backend reads in place as one (1, N, C) row
    info = glu_tpu_torch.dtype_info(data_type)
    host = _typed_data(info, seeded_rng(13 + op.value), 1001)
    want = glu_tpu.reduce(jnp.asarray(host), _jop(op), backend=backend)
    _assert_port(lambda b: glu_tpu_torch.reduce(_t(host), op, backend=b), want, info.dtype.is_floating_point)


@pytest.mark.parametrize("shape,rows", [((1000,), (1, 1000)), ((1000, 1), (1, 1000, 1)), ((1000, 2), (1, 1000, 2)),
                                        ((1000, 4), (1, 1000, 4)), ((1000, 3), (3, 1000))])
@pytest.mark.parametrize("contiguous", [True, False])
def test_reduce_reads_vectors_in_place(shape, rows, contiguous, monkeypatch):
    # the "cuda" backend hands K5 a view of a contiguous (N,) or (N, C) input
    # with C in 1, 2, 4, no copy; other widths go as C rows of one (C, N)
    # copy, and a non-contiguous input is copied once
    seen = []
    real = cr.reduce_partitions

    def spy(x, op):
        seen.append(x)
        return real(x, op)

    monkeypatch.setattr(cr, "reduce_partitions", spy)
    base = torch.arange(2 * int(np.prod(shape)), dtype=torch.int32).reshape((2 * shape[0],) + shape[1:])
    x = base[: shape[0]] if contiguous else base[::2]
    got = glu_tpu_torch.reduce(x, ReduceOperator.MAX)
    assert [tuple(t.shape) for t in seen] == [rows]
    assert (seen[0].data_ptr() == x.data_ptr()) == (contiguous and len(shape) + 1 == len(rows))
    assert torch.equal(got, torch.amax(x, 0))


def test_reduce_class_vector_writes_index_0(backend):
    # a UVEC4 DeviceBuffer: the (C,) result lands at buffer[0], in place
    data = np.random.default_rng(17).integers(0, 2**32, (1000, 4), dtype=np.uint64).astype(np.uint32)
    jbuf = glu_tpu.DeviceBuffer(data)
    want = glu_tpu.Reduce(glu_tpu.DataType.UVEC4, glu_tpu.ReduceOperator.SUM)(jbuf, 700, backend=backend)
    np.testing.assert_array_equal(np.asarray(want), data[:700].sum(axis=0, dtype=np.uint32))
    for b in PORT_BACKENDS:
        buf = DeviceBuffer(data, device="cpu")
        storage = buf.data.data_ptr()
        result = Reduce(DataType.UVEC4, ReduceOperator.SUM)(buf, 700, backend=b)
        np.testing.assert_array_equal(to_numpy(result), np.asarray(want))
        np.testing.assert_array_equal(buf.get_data(), jbuf.get_data())
        assert buf.data.data_ptr() == storage


def test_reduce_class_writes_index_0(backend):
    # test_reduce.py:96: the class leaves the result at buffer[0], in place
    data = np.arange(1, 11, dtype=np.uint32)
    jbuf = glu_tpu.DeviceBuffer(data)
    want = glu_tpu.Reduce(glu_tpu.DataType.UINT, glu_tpu.ReduceOperator.SUM)(jbuf, 10, backend=backend)
    for b in PORT_BACKENDS:
        buf = DeviceBuffer(data, device="cpu")
        storage = buf.data.data_ptr()
        result = Reduce(DataType.UINT, ReduceOperator.SUM)(buf, 10, backend=b)
        assert int(result) == int(want) == 55
        np.testing.assert_array_equal(buf.get_data(), jbuf.get_data())
        assert buf.data.data_ptr() == storage


def test_reduce_count_subset(backend):
    # test_reduce.py:105: only the first `count` elements
    data = np.arange(1, 11, dtype=np.uint32)
    jop = glu_tpu.Reduce(glu_tpu.DataType.UINT, glu_tpu.ReduceOperator.SUM)
    want = jop(glu_tpu.DeviceBuffer(data), 4, backend=backend)
    for b in PORT_BACKENDS:
        got = Reduce(DataType.UINT, ReduceOperator.SUM)(DeviceBuffer(data, device="cpu"), 4, backend=b)
        assert int(got) == int(want) == 10
        # a tensor comes back untouched
        t = _t(data)
        assert int(Reduce(DataType.UINT, ReduceOperator.MAX)(t, 4, backend=b)) == 4
        np.testing.assert_array_equal(to_numpy(t), data)


@pytest.mark.parametrize("op", OPS)
def test_reduce_golden_reference(op, seeded_rng):
    # the port's golden oracle against the JAX package's on u32 and f32
    from glu_tpu.ops.reference import ref_reduce as jax_ref_reduce

    name = {ReduceOperator.SUM: "sum", ReduceOperator.MUL: "mul",
            ReduceOperator.MIN: "min", ReduceOperator.MAX: "max"}[op]
    u = seeded_rng(9).sample_int_vector(3000, 0, 0xFFFFFFFF).reshape(1000, 3)
    f = seeded_rng(9).sample_float_vector(300, 0.5, 1.5)
    np.testing.assert_array_equal(to_numpy(ref_reduce(_t(u), name)), np.asarray(jax_ref_reduce(jnp.asarray(u), name)))
    np.testing.assert_allclose(to_numpy(ref_reduce(_t(f), name)), np.asarray(jax_ref_reduce(jnp.asarray(f), name)),
                               rtol=1e-4, atol=1e-3)


def _jax_segmented(fn, data, offs, **kwargs):
    """A ragged form of the JAX package, jitted as a caller would: its
    flagged path run op by op costs seconds of XLA compiles per case on the
    CPU. Under jit the offsets are traced, so the host checks of their
    contract are left to the eager contract tests."""
    return jax.jit(partial(fn, **kwargs))(jnp.asarray(data), jnp.asarray(offs))


def _segred_oracle(data, offs):
    return np.array(
        [np.uint32(data[offs[s]: offs[s + 1]].astype(np.uint64).sum() & 0xFFFFFFFF)
         for s in range(len(offs) - 1)],
        dtype=np.uint32,
    )


def test_segmented_reduce(backend, seeded_rng):
    # test_reduce.py:121: empty first, middle and last segments
    offs = np.array([0, 0, 5, 5, 700, 701, 2999, 3000, 3000], np.int32)
    data = seeded_rng(73).sample_int_vector(3000, 0, 2**32 - 1)
    want = glu_tpu.segmented_reduce(jnp.asarray(data), jnp.asarray(offs), backend=backend)
    np.testing.assert_array_equal(np.asarray(want), _segred_oracle(data, offs))
    _assert_port(lambda b: glu_tpu_torch.segmented_reduce(_t(data), offs, backend=b), want, False)


@pytest.mark.parametrize("trial", range(4))
def test_segmented_reduce_fuzz(trial, backend, seeded_rng):
    # test_reduce.py:135
    rng = seeded_rng(800 + trial)
    n = int(rng.rng.integers(1, 4000))
    s = int(rng.rng.integers(1, 25))
    cuts = np.sort(rng.rng.integers(0, n + 1, s - 1)).astype(np.int32)
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    data = rng.sample_int_vector(n, 0, 2**32 - 1)
    want = _jax_segmented(glu_tpu.segmented_reduce, data, offs, backend=backend)
    np.testing.assert_array_equal(np.asarray(want), _segred_oracle(data, offs))
    _assert_port(lambda b: glu_tpu_torch.segmented_reduce(_t(data), torch.from_numpy(offs), backend=b), want, False)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_segmented_reduce_all_ops(op, dtype, backend, seeded_rng):
    # test_reduce.py:171: all four operators; empty segments give the identity
    rng = seeded_rng(600 + op.value)
    n = 257
    if np.issubdtype(dtype, np.floating):
        data = rng.rng.uniform(0.5, 1.5, size=n).astype(dtype)
    elif dtype == np.int32:
        data = rng.rng.integers(-3, 4, size=n).astype(dtype)
    else:
        data = rng.rng.integers(1, 3, size=n).astype(dtype)
    offs = np.concatenate([[0], np.sort(rng.rng.integers(0, n + 1, size=9)), [n]]).astype(np.int32)
    want = _jax_segmented(glu_tpu.segmented_reduce, data, offs, op=_jop(op), backend=backend)
    _assert_port(lambda b: glu_tpu_torch.segmented_reduce(_t(data), offs, op, backend=b), want,
                 np.issubdtype(dtype, np.floating))


@pytest.mark.parametrize("op", OPS)
def test_identity_matches_jax(op):
    # the u32 identities are int32 bit patterns of the JAX package's
    for dtype, np_dtype in ((torch.uint32, np.uint32), (torch.int32, np.int32),
                            (torch.float32, np.float32), (torch.float64, np.float64)):
        ident = jax_identity_for(_jop(op), np_dtype)
        mine = identity_for(op, dtype)
        if dtype == torch.uint32:
            assert np.int32(mine).view(np.uint32) == ident
        else:
            assert np_dtype(mine) == ident


def test_segmented_reduce_contract(backend):
    # test_reduce.py:150
    from glu_tpu.utils.errors import GluArgumentError as JaxArgumentError
    from glu_tpu_torch.utils.errors import GluArgumentError

    x = np.arange(10, dtype=np.uint32)
    for data, offs in ((x, np.array([0, 9], np.int32)), (np.ones((8, 2), np.uint32), np.array([0, 8], np.int32))):
        with pytest.raises(JaxArgumentError):
            glu_tpu.segmented_reduce(jnp.asarray(data), jnp.asarray(offs), backend=backend)
        for b in PORT_BACKENDS:
            with pytest.raises(GluArgumentError):
                glu_tpu_torch.segmented_reduce(_t(data), offs, backend=b)
    # the remaining contract, checked on the host
    for offs in ([5, 10], [0, 6, 4, 10], [0.0, 10.0], [0]):
        with pytest.raises(GluArgumentError):
            glu_tpu_torch.segmented_reduce(_t(x), np.asarray(offs))
    empty = glu_tpu_torch.segmented_reduce(_t(x[:0]), [0, 0, 0], ReduceOperator.MIN)
    np.testing.assert_array_equal(to_numpy(empty), [0xFFFFFFFF, 0xFFFFFFFF])


def test_reduce_rejects_what_jax_rejects():
    from glu_tpu.utils.errors import GluArgumentError as JaxArgumentError
    from glu_tpu_torch.utils.errors import GluArgumentError, GluError

    bad = [np.zeros((2, 2, 2), np.uint32), np.zeros(0, np.uint32), np.zeros((0, 4), np.uint32)]
    for data in bad:
        with pytest.raises(JaxArgumentError):
            glu_tpu.reduce(jnp.asarray(data), backend="xla")
        with pytest.raises(GluArgumentError):
            glu_tpu_torch.reduce(_t(data))
    x = np.arange(1, 11, dtype=np.uint32)
    for count in (0, 11):
        with pytest.raises(JaxArgumentError):
            glu_tpu.Reduce(glu_tpu.DataType.UINT, glu_tpu.ReduceOperator.SUM)(glu_tpu.DeviceBuffer(x), count)
        with pytest.raises(GluArgumentError):
            Reduce(DataType.UINT, ReduceOperator.SUM)(DeviceBuffer(x, device="cpu"), count)
    with pytest.raises(JaxArgumentError):
        glu_tpu.Reduce(glu_tpu.DataType.UINT, "sum")
    with pytest.raises(GluArgumentError):
        Reduce(DataType.UINT, "sum")
    # beyond the JAX package: the operator type, the four kernel dtypes, the backend
    with pytest.raises(GluArgumentError):
        glu_tpu_torch.reduce(_t(x), "sum")
    for dtype in (torch.int64, torch.float16, torch.bool, torch.uint8):
        with pytest.raises(GluArgumentError, match="not supported"):
            glu_tpu_torch.reduce(torch.ones(4, dtype=dtype))
    with pytest.raises(GluError):
        glu_tpu_torch.reduce(_t(x), backend="xla")
    with pytest.raises(GluArgumentError, match="contiguous"):
        cr.reduce_partitions(torch.ones((4, 2), dtype=torch.int32).t(), ReduceOperator.SUM)
    for bad in (torch.ones((2, 4, 3), dtype=torch.int32), torch.ones((2, 4, 2, 1), dtype=torch.int32),
                torch.ones((2, 2, 4), dtype=torch.int32).transpose(1, 2)):
        with pytest.raises(GluArgumentError):
            cr.reduce_partitions(bad, ReduceOperator.SUM)
