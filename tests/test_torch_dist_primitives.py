"""The port's distributed reduce and scans (glu_tpu_torch.parallel) against
glu_tpu's, on the same numpy-seeded global arrays.

The JAX side runs in this process on make_sort_mesh(jax.devices()[:D])
with backend "xla"; the port's in D gloo processes
(tests/torch_dist_pool.py), each with its own shard of 1,000 elements (a
length off the kernels' tiles), under both of the port's backends: "cuda",
the kernels' plain torch versions on the CPU, and "torch". Integers must
be bit-identical (u32 and i32 sums and products wrap); floats agree within
rtol 1e-4, atol 1e-3 (tests/test_reduce.py:63): the local folds run in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glu_tpu import parallel as jpar
from glu_tpu.ops.reduce import ReduceOperator as JaxOp
from glu_tpu_torch import GluError, ReduceOperator, from_numpy
from glu_tpu_torch import parallel as tpar
from torch_dist_pool import RankPool, results

N_LOCAL = 1000
WORLD_SIZES = (1, 2, 3, 4)
PORT_BACKENDS = ("cuda", "torch")
OPS = ("SUM", "MUL", "MIN", "MAX")
TOL = dict(rtol=1e-4, atol=1e-3)


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


def _input(rng, dtype: str, op: str, n: int) -> np.ndarray:
    """Values that keep every prefix meaningful: odd integer factors for
    MUL, float factors near 1, positive float addends."""
    if dtype in ("uint32", "int32"):
        x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        x = x | np.uint32(1) if op == "MUL" else x
        return x.view(np.int32) if dtype == "int32" else x
    if op == "SUM":
        return rng.random(n).astype(np.float32)
    if op == "MUL":
        return np.exp(rng.standard_normal(n) * 1e-3).astype(np.float32)
    return (rng.random(n) * 2 - 1).astype(np.float32)


def _jax_primitives(x, op: str, world_size: int):
    mesh = jpar.make_sort_mesh(jax.devices()[:world_size])
    xs = jax.device_put(jnp.asarray(x), jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("shards")))
    jop = JaxOp[op]
    return [np.asarray(f(xs, mesh, jop, backend="xla")) for f in
            (jpar.distributed_reduce, jpar.distributed_exclusive_scan, jpar.distributed_inclusive_scan)]


def _assert_match(got: np.ndarray, want: np.ndarray, label: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (label, got.dtype, want.dtype, got.shape, want.shape)
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, err_msg=label, **TOL)
    else:
        np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_distributed_primitives_match_jax(pools, world_size, op, dtype):
    rng = np.random.default_rng([world_size, OPS.index(op), len(dtype)])
    x = _input(rng, dtype, op, world_size * N_LOCAL)
    want_reduce, want_exc, want_inc = _jax_primitives(x, op, world_size)
    shards = np.split(x, world_size)
    got = results(pools[world_size].run("primitives", [(shards[r], op, PORT_BACKENDS) for r in range(world_size)]))
    for r, by_backend in enumerate(got):
        for backend, (red, exc, inc) in by_backend.items():
            label = f"{op} {dtype} D={world_size} backend={backend} rank {r}"
            _assert_match(red, want_reduce, f"{label} reduce")
            _assert_match(exc, want_exc[r * N_LOCAL:(r + 1) * N_LOCAL], f"{label} exclusive")
            _assert_match(inc, want_inc[r * N_LOCAL:(r + 1) * N_LOCAL], f"{label} inclusive")


@pytest.mark.parametrize("fn_name", ["distributed_reduce", "distributed_exclusive_scan",
                                     "distributed_inclusive_scan"])
@pytest.mark.parametrize("what, match", [("unequal", "equal lengths"), ("int64", "not supported"),
                                         ("2-D", "1-D")])
def test_primitive_errors_raise_on_every_rank(pools, fn_name, what, match):
    world_size = 2
    per_rank = []
    for r in range(world_size):
        x = np.arange(N_LOCAL + (r if what == "unequal" else 0), dtype=np.uint32)
        x = x.astype(np.int64) if what == "int64" else x
        x = x.reshape(2, -1) if what == "2-D" else x
        per_rank.append((fn_name, [x], {"op": "SUM"}))
    for status, payload in pools[world_size].run("parallel_call", per_rank):
        assert status == "error" and payload[2], payload
        assert match in payload[1], payload


def test_primitives_need_an_initialized_group():
    x = from_numpy(np.arange(8, dtype=np.uint32), "cpu")
    with pytest.raises(GluError, match="Invalid operator"):
        tpar.distributed_reduce(x, None, "sum")
    for fn in (tpar.distributed_reduce, tpar.distributed_exclusive_scan, tpar.distributed_inclusive_scan):
        with pytest.raises(GluError, match="not initialized"):
            fn(x, None, ReduceOperator.SUM)
    with pytest.raises(GluError, match="not supported"):
        tpar.distributed_reduce(torch.zeros(4, dtype=torch.int16))
