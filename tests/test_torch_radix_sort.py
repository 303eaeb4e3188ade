"""The port's sort (glu_tpu_torch.radix_sort, RadixSort) as a whole against
glu_tpu.radix_sort(..., backend="xla") and the native oracle, on the sort
cases of tests/test_radix_sort.py. Inputs come from one seeded numpy
generator and go to all three; keys and values must be bit-identical.

Each case runs through both of the port's backends: "cuda", the radix
engine, which here runs its kernels' plain torch versions with the tile
shrunk to 256 elements and the single-tile limit to 512, so that inputs
span many tiles with a ragged tail or take the single-tile path; and
"torch", one stable torch.sort.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glu_tpu
import glu_tpu_torch
from glu_tpu.native import get_oracle
from glu_tpu_torch import DeviceBuffer, RadixSort, from_numpy, to_numpy
from glu_tpu_torch.ops import _cuda_sort as cs
from glu_tpu_torch.ops.reference import ref_radix_sort
from glu_tpu_torch.utils import GluError

SMALL_TILE = 256
SMALL_SINGLE_MAX = 512


@pytest.fixture(autouse=True)
def small_tiles(monkeypatch):
    monkeypatch.setattr(cs, "TILE", SMALL_TILE)
    monkeypatch.setattr(cs, "SINGLE_TILE_MAX", SMALL_SINGLE_MAX)


def _uniform(seed, n):
    return lambda R: R(seed).sample_int_vector(n, 0, 0xFFFFFFFE)


# name -> (keys from the SeededRandom class, num_steps); test_radix_sort.py lines
CASES = {
    **{f"pow2-{n}": (_uniform(1, n), 0) for n in (128, 256, 512, 1024)},  # :41
    "low-entropy-2048": (lambda R: R(2).sample_int_vector(2048, 0, 9), 0),  # :52
    **{f"odd-{n}": (_uniform(n, n), 0) for n in (10993, 16447, 20771, 33377, 47487)},  # :62
    "presorted": (lambda R: np.arange(8192, dtype=np.uint32), 0),  # :76
    "reverse": (lambda R: np.arange(8192, dtype=np.uint32)[::-1].copy(), 0),
    "constant": (lambda R: np.full(8192, 0xDEADBEEF, dtype=np.uint32), 0),
    **{f"steps-{s}": (_uniform(7, 4096), s) for s in (1, 2, 4, 7)},  # :91
    "count-2": (lambda R: np.array([2, 1], dtype=np.uint32), 0),  # :104
    "extreme": (  # :125
        lambda R: np.array(
            [0xFFFFFFFF, 0, 0x80000000, 0x7FFFFFFF, 1, 0xFFFFFFFE, 0x00010000, 0xF0F0F0F0],
            dtype=np.uint32,
        ),
        0,
    ),
}


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("case", list(CASES))
def test_sort_matches_jax_and_oracle(case, backend, seeded_rng):
    make_keys, steps = CASES[case]
    keys = make_keys(seeded_rng)
    vals = np.arange(keys.size, dtype=np.uint32)
    jk, jv = glu_tpu.radix_sort(jnp.asarray(keys), jnp.asarray(vals), steps, backend="xla")
    ok, ov = get_oracle().radix_sort_kv(keys, vals, steps or 8)
    tkeys, tvals = from_numpy(keys, "cpu"), from_numpy(vals, "cpu")
    tk, tv = glu_tpu_torch.radix_sort(tkeys, tvals, steps, backend=backend)
    assert tk.dtype == tv.dtype == torch.uint32
    tk, tv = to_numpy(tk), to_numpy(tv)
    np.testing.assert_array_equal(tk, np.asarray(jk))
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_array_equal(tk, ok)
    np.testing.assert_array_equal(tv, ov)
    rk, rv = ref_radix_sort(tkeys, tvals, steps)  # the port's own golden oracle
    np.testing.assert_array_equal(to_numpy(rk), tk)
    np.testing.assert_array_equal(to_numpy(rv), tv)
    # out of place: the inputs are untouched
    np.testing.assert_array_equal(to_numpy(tkeys), keys)
    np.testing.assert_array_equal(to_numpy(tvals), vals)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_sort_tiny_counts(backend):
    # count <= 1 early-exits (reference RadixSort.hpp:278-279)
    for n in (0, 1):
        keys = np.arange(5, 5 + n, dtype=np.uint32)
        vals = np.arange(9, 9 + n, dtype=np.uint32)
        jk, jv = glu_tpu.radix_sort(jnp.asarray(keys), jnp.asarray(vals), backend="xla")
        tk, tv = glu_tpu_torch.radix_sort(from_numpy(keys, "cpu"), from_numpy(vals, "cpu"), backend=backend)
        assert tk.shape == (n,) and tk.dtype == torch.uint32
        np.testing.assert_array_equal(to_numpy(tk), np.asarray(jk))
        np.testing.assert_array_equal(to_numpy(tv), np.asarray(jv))


@pytest.mark.parametrize(
    "n,steps,calls",
    [(300, 0, (0, 0, 1)), (SMALL_SINGLE_MAX, 0, (0, 0, 1)), (SMALL_SINGLE_MAX + 1, 0, (8, 8, 0)),
     (3 * SMALL_TILE + 17, 3, (3, 3, 0))],
)
def test_engine_takes_each_kernel(n, steps, calls, seeded_rng, monkeypatch):
    # which kernel wrappers the engine calls: K3 alone up to its limit, else
    # one K1 and one K2 per 4-bit pass
    seen = {"group_tiles": 0, "scatter_runs": 0, "sort_single_tile": 0}
    for name in seen:
        def spy(*args, _name=name, _fn=getattr(cs, name)):
            seen[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(cs, name, spy)
    keys = seeded_rng(5).sample_int_vector(n, 0, 0xFFFFFFFF)
    glu_tpu_torch.radix_sort(from_numpy(keys, "cpu"), from_numpy(np.arange(n, dtype=np.uint32), "cpu"), steps)
    assert (seen["group_tiles"], seen["scatter_runs"], seen["sort_single_tile"]) == calls


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_sort_class_in_place(backend, seeded_rng):
    # reference call shape: RadixSort()(key_buffer, val_buffer, count) sorts
    # in place into the caller's buffers (test_radix_sort.py:136)
    keys = seeded_rng(3).sample_int_vector(3000, 0, 0xFFFFFFFE)
    vals = np.arange(3000, dtype=np.uint32)
    jkb, jvb = glu_tpu.DeviceBuffer(keys), glu_tpu.DeviceBuffer(vals)
    glu_tpu.RadixSort()(jkb, jvb, 3000, backend="xla")
    kbuf, vbuf = DeviceBuffer(keys, device="cpu"), DeviceBuffer(vals, device="cpu")
    sorter = RadixSort()
    sorter.prepare_internal_buffers(3000, backend=backend, device="cpu")
    out_k, out_v = sorter(kbuf, vbuf, 3000, backend=backend)
    np.testing.assert_array_equal(kbuf.get_data(), jkb.get_data())
    np.testing.assert_array_equal(vbuf.get_data(), jvb.get_data())
    assert out_k.data_ptr() == kbuf.data.data_ptr()


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_sort_class_count_subset(backend, seeded_rng):
    # only the first `count` pairs of larger buffers (test_radix_sort.py:149)
    keys = seeded_rng(4).sample_int_vector(100, 0, 1000)
    vals = np.arange(100, dtype=np.uint32)
    jkb, jvb = glu_tpu.DeviceBuffer(keys), glu_tpu.DeviceBuffer(vals)
    glu_tpu.RadixSort()(jkb, jvb, 60, backend="xla")
    kbuf, vbuf = DeviceBuffer(keys, device="cpu"), DeviceBuffer(vals, device="cpu")
    RadixSort()(kbuf, vbuf, 60, backend=backend)
    np.testing.assert_array_equal(kbuf.get_data(), jkb.get_data())
    np.testing.assert_array_equal(vbuf.get_data(), jvb.get_data())
    # tensors in, new tensors out; the caller's tensors stay as they were
    tkeys, tvals = from_numpy(keys, "cpu"), from_numpy(vals, "cpu")
    out_k, out_v = RadixSort()(tkeys, tvals, 60, backend=backend)
    np.testing.assert_array_equal(to_numpy(out_k), jkb.get_data()[:60])
    np.testing.assert_array_equal(to_numpy(out_v), jvb.get_data()[:60])
    np.testing.assert_array_equal(to_numpy(tkeys), keys)


def test_sort_rejects_what_jax_rejects():
    from glu_tpu.utils.errors import GluArgumentError as JaxArgumentError
    from glu_tpu_torch.utils.errors import GluArgumentError

    k = np.arange(4, dtype=np.uint32)
    bad = [
        (k.astype(np.int32), k),          # key dtype
        (k, k.astype(np.int32)),          # value dtype
        (k, k[:3]),                       # length mismatch
        (k.reshape(2, 2), k.reshape(2, 2)),  # not 1-D
    ]
    for keys, vals in bad:
        with pytest.raises(JaxArgumentError):
            glu_tpu.radix_sort(jnp.asarray(keys), jnp.asarray(vals), backend="xla")
        with pytest.raises(GluArgumentError):
            glu_tpu_torch.radix_sort(from_numpy(keys, "cpu"), from_numpy(vals, "cpu"))
    for steps in (-1, 9):
        with pytest.raises(GluArgumentError):
            glu_tpu_torch.radix_sort(from_numpy(k, "cpu"), from_numpy(k, "cpu"), steps)
    with pytest.raises(GluError):
        glu_tpu_torch.radix_sort(from_numpy(k, "cpu"), from_numpy(k, "cpu"), backend="xla")
    for kwargs in ({"descending": True}, {"bits": "auto"}):
        with pytest.raises(NotImplementedError, match="queue 1 item 4"):
            glu_tpu_torch.radix_sort(from_numpy(k, "cpu"), from_numpy(k, "cpu"), **kwargs)
