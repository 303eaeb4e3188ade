"""The port's ragged scans and reductions (the offsets= forms of
glu_tpu_torch.exclusive_scan and inclusive_scan, and segmented_reduce run
through the scan) against glu_tpu's, on the cases of tests/test_scan.py.
Inputs come from one seeded numpy generator and go to both packages.

The JAX side runs through the `backend` fixture ("xla", and "pallas", K4 in
interpret mode), jitted (see _jax_segmented). Each case runs through both
of the port's backends: "cuda", whose K4 wrapper here runs its plain torch
version with the tile shrunk to 64 elements, and "torch".

Tolerance: integers bit for bit; floats rtol 1e-4, atol 1e-3, the JAX
package's own (tests/test_scan.py:299).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glu_tpu
import glu_tpu_torch
from glu_tpu_torch import ReduceOperator, from_numpy, to_numpy
from glu_tpu_torch.ops import _cuda_reduce as cr
from glu_tpu_torch.ops import _cuda_scan as cs

SMALL_TILE = 64
PORT_BACKENDS = ("cuda", "torch")
OPS = list(ReduceOperator)


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


def _jax_segmented(fn, data, offs, **kwargs):
    """A ragged form of the JAX package, jitted as a caller would: its
    flagged path run op by op costs seconds of XLA compiles per case on the
    CPU. Under jit the offsets are traced, so the host checks of their
    contract are left to the eager contract tests."""
    return jax.jit(partial(fn, **kwargs))(jnp.asarray(data), jnp.asarray(offs))


def _seg_oracle(data, offs, inclusive):
    out = np.zeros_like(data)
    for s in range(len(offs) - 1):
        c = np.cumsum(data[offs[s]: offs[s + 1]].astype(np.uint64)).astype(data.dtype)
        out[offs[s]: offs[s + 1]] = c if inclusive else np.concatenate([[data.dtype.type(0)], c[:-1]])
    return out


@pytest.mark.parametrize("inclusive", [False, True])
def test_scan_segmented_offsets(inclusive, backend, seeded_rng):
    # test_scan.py:213: empty first, middle and last segments
    offs = np.array([0, 0, 5, 5, 700, 701, 2999, 3000, 3000], np.int32)
    data = seeded_rng(61).sample_int_vector(3000, 0, 2**32 - 1)
    jfn, tfn = ((glu_tpu.inclusive_scan, glu_tpu_torch.inclusive_scan) if inclusive
                else (glu_tpu.exclusive_scan, glu_tpu_torch.exclusive_scan))
    want = jfn(jnp.asarray(data), backend=backend, offsets=jnp.asarray(offs))
    np.testing.assert_array_equal(np.asarray(want), _seg_oracle(data, offs, inclusive))
    _assert_port(lambda b: tfn(_t(data), backend=b, offsets=offs), want)


@pytest.mark.parametrize("trial", range(4))
def test_scan_segmented_offsets_fuzz(trial, backend, seeded_rng):
    # test_scan.py:228
    rng = seeded_rng(600 + trial)
    n = int(rng.rng.integers(1, 5000))
    s = int(rng.rng.integers(1, 30))
    cuts = np.sort(rng.rng.integers(0, n + 1, s - 1)).astype(np.int32)
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    data = rng.sample_int_vector(n, 0, 2**32 - 1)
    want = _jax_segmented(lambda x, o, **kw: glu_tpu.exclusive_scan(x, offsets=o, **kw), data, offs, backend=backend)
    np.testing.assert_array_equal(np.asarray(want), _seg_oracle(data, offs, False))
    _assert_port(lambda b: glu_tpu_torch.exclusive_scan(_t(data), backend=b, offsets=torch.from_numpy(offs)), want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
@pytest.mark.parametrize("inclusive", [False, True])
def test_scan_segmented_offsets_all_ops(op, dtype, inclusive, backend, seeded_rng):
    # test_scan.py:277: mul/min/max and float sums take the flagged path,
    # integer sums the global-scan path; empty segments included
    rng = seeded_rng(500 + op.value)
    n = 300
    if np.issubdtype(dtype, np.floating):
        data = rng.rng.uniform(0.5, 1.5, size=n).astype(dtype)
    elif dtype == np.int32:
        data = rng.rng.integers(-3, 4, size=n).astype(dtype)
    else:
        data = rng.rng.integers(1, 3, size=n).astype(dtype)
    offs = np.concatenate([[0], np.sort(rng.rng.integers(0, n + 1, size=7)), [n]]).astype(np.int32)
    jfn, tfn = ((glu_tpu.inclusive_scan, glu_tpu_torch.inclusive_scan) if inclusive
                else (glu_tpu.exclusive_scan, glu_tpu_torch.exclusive_scan))
    want = _jax_segmented(lambda x, o, **kw: jfn(x, offsets=o, **kw), data, offs, op=_jop(op), backend=backend)
    _assert_port(lambda b: tfn(_t(data), op=op, backend=b, offsets=offs), want, np.issubdtype(dtype, np.floating))


def test_slice_segmented_reduce_through_the_scan(backend, seeded_rng, monkeypatch):
    # The slice as a whole: segmented_reduce on uneven offsets runs
    # inclusive_scan on K4 (its plain version here), then boundary gathers
    rng = seeded_rng(91)
    n = 5000
    cuts = np.sort(rng.rng.integers(0, n + 1, 40)).astype(np.int32)
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    data = rng.sample_int_vector(n, 0, 2**32 - 1)
    want = _jax_segmented(glu_tpu.segmented_reduce, data, offs, backend=backend)
    calls = []
    real = cs.exclusive_scan_partitions
    monkeypatch.setattr(cs, "exclusive_scan_partitions", lambda x, op: calls.append(x.shape) or real(x, op))
    got = glu_tpu_torch.segmented_reduce(_t(data), offs, backend="cuda")
    assert calls == [(1, n)]
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    sums = [int(data[offs[s]: offs[s + 1]].astype(np.uint64).sum()) & 0xFFFFFFFF for s in range(len(offs) - 1)]
    np.testing.assert_array_equal(to_numpy(got), np.array(sums, dtype=np.uint32))


def test_scan_segmented_offsets_contract(backend):
    # test_scan.py:241 and :380: bad boundaries, offsets with partitions,
    # vector input; the port checks the rest of the contract on the host
    from glu_tpu.utils.errors import GluArgumentError as JaxArgumentError
    from glu_tpu_torch.utils.errors import GluArgumentError

    x = np.arange(10, dtype=np.uint32)
    bad = [
        (x, 1, np.array([1, 10], np.int32)),
        (x, 2, np.array([0, 10], np.int32)),
        (np.ones((8, 2), np.uint32), 1, np.array([0, 8], np.int32)),
    ]
    for data, parts, offs in bad:
        with pytest.raises(JaxArgumentError):
            glu_tpu.exclusive_scan(jnp.asarray(data), parts, backend=backend, offsets=jnp.asarray(offs))
        for b in PORT_BACKENDS:
            for fn in (glu_tpu_torch.exclusive_scan, glu_tpu_torch.inclusive_scan):
                with pytest.raises(GluArgumentError):
                    fn(_t(data), parts, backend=b, offsets=offs)
    for offs in ([0, 9], [0, 6, 4, 10], [0.0, 10.0], [0], [[0, 10]]):
        with pytest.raises(GluArgumentError):
            glu_tpu_torch.exclusive_scan(_t(x), offsets=np.asarray(offs))
    for b in PORT_BACKENDS:
        empty = glu_tpu_torch.exclusive_scan(_t(x[:0]), backend=b, offsets=[0, 0])
        assert empty.shape == (0,) and empty.dtype == torch.uint32
