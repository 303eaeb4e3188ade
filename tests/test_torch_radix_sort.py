"""The port's sort (glu_tpu_torch.radix_sort, RadixSort) as a whole against
glu_tpu.radix_sort(..., backend="xla") and the native oracle, on the sort
cases of tests/test_radix_sort.py. Inputs come from one seeded numpy
generator and go to all three; keys and values must be bit-identical.

Each case runs through both of the port's backends: "cuda", the radix
engine, which here runs its kernels' plain torch versions with the tile
shrunk to 256 elements, the single-tile limit to 512 and a CTA's to 128,
so that inputs span many tiles with a ragged tail or take the single-tile
path on one CTA or on a cluster; and "torch", one stable torch.sort. The
engine's own geometry is held against the JAX package at K3's edges.
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
SMALL_CTA_MAX = 128
GEOMETRY = {name: getattr(cs, name) for name in ("TILE", "SINGLE_TILE_MAX", "CTA_MAX")}  # the engine's


@pytest.fixture(autouse=True)
def small_tiles(monkeypatch):
    monkeypatch.setattr(cs, "TILE", SMALL_TILE)
    monkeypatch.setattr(cs, "SINGLE_TILE_MAX", SMALL_SINGLE_MAX)
    monkeypatch.setattr(cs, "CTA_MAX", SMALL_CTA_MAX)


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
    [(300, 0, (0, 0, 1)), (SMALL_SINGLE_MAX, 0, (0, 0, 1)), (SMALL_SINGLE_MAX + 1, 0, (1, 4, 0)),
     (3 * SMALL_TILE + 17, 3, (1, 2, 0)), (SMALL_CTA_MAX, 0, (0, 0, 1))],
)
def test_engine_takes_each_kernel(n, steps, calls, seeded_rng, monkeypatch):
    # which kernel wrappers the engine calls: K3 alone up to its limit (on
    # one CTA up to CTA_MAX, on a cluster above), else one digit_histograms
    # and one onesweep_pass per 8 bits (32 bits: 4; num_steps=3, 12 bits:
    # 8 + 4)
    seen = {"digit_histograms": 0, "onesweep_pass": 0, "sort_single_tile": 0}
    for name in seen:
        def spy(*args, _name=name, _fn=getattr(cs, name)):
            seen[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(cs, name, spy)
    keys = seeded_rng(5).sample_int_vector(n, 0, 0xFFFFFFFF)
    glu_tpu_torch.radix_sort(from_numpy(keys, "cpu"), from_numpy(np.arange(n, dtype=np.uint32), "cpu"), steps)
    assert (seen["digit_histograms"], seen["onesweep_pass"], seen["sort_single_tile"]) == calls


@pytest.mark.parametrize("n,ctas,calls", [(24_577, 8, (0, 0, 1)), (65_536, 8, (0, 0, 1)), (65_537, None, (1, 4, 0))])
def test_sort_at_k3_edges_matches_jax(n, ctas, calls, monkeypatch):
    # the kernels' geometry: one pair past one CTA and K3's limit take K3 on
    # a cluster of 8 CTAs, one more pair the multi-tile engine; bit for bit
    # against glu_tpu on "xla"
    for name, value in GEOMETRY.items():
        monkeypatch.setattr(cs, name, value)
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    keys[::7] = keys[0]  # ties across the CTAs' slices
    vals = np.arange(n, dtype=np.uint32)
    jk, jv = glu_tpu.radix_sort(jnp.asarray(keys), jnp.asarray(vals), backend="xla")
    assert ctas is None or cs.single_tile_ctas(n) == ctas
    cs.reset_launch_counts()
    tk, tv = glu_tpu_torch.radix_sort(from_numpy(keys, "cpu"), from_numpy(vals, "cpu"), backend="cuda")
    assert tuple(cs.launch_counts().values()) == (0, 0, 0)  # the plain versions launch nothing
    np.testing.assert_array_equal(to_numpy(tk), np.asarray(jk))
    np.testing.assert_array_equal(to_numpy(tv), np.asarray(jv))
    seen = []
    for name in ("digit_histograms", "onesweep_pass", "sort_single_tile"):
        monkeypatch.setattr(cs, name, lambda *a, _name=name, _fn=getattr(cs, name), **k: seen.append(_name) or _fn(*a, **k))
    glu_tpu_torch.radix_sort(from_numpy(keys, "cpu"), from_numpy(vals, "cpu"), backend="cuda")
    assert tuple(seen.count(name) for name in ("digit_histograms", "onesweep_pass", "sort_single_tile")) == calls


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
    # the variants' contracts (test_radix_sort.py:289,330,364;
    # test_adaptive_sort.py:164): (function name, arrays, keywords)
    k10 = np.arange(10, dtype=np.uint32)
    bad_variants = [
        ("radix_sort", (k, k), {"num_steps": 2, "descending": True}),  # descending with a partial sort
        ("radix_sort", (k[:1], k[:1]), {"num_steps": 2, "descending": True}),  # checked before n <= 1
        ("radix_sort", (k, k), {"num_steps": 3, "bits": "auto"}),  # bits with a partial sort
        ("radix_sort_keys", (k,), {"num_steps": 3, "bits": (0, 1)}),
        ("radix_sort", (k, k), {"bits": (0, 0)}),  # repeated position
        ("radix_sort", (k, k), {"bits": (32,)}),  # out of range
        ("radix_sort", (k, k), {"bits": (-1,)}),
        ("radix_sort", (k, k), {"bits": "yes"}),  # unknown string
        ("radix_sort_u64_parts", (k, k, k), {"bits": (0, 1)}),  # u64 bits not a pair
        ("radix_sort_u64_parts", (k, k, k), {"bits": ((0, 1), (2,), (3,))}),
        ("radix_sort_u64_parts", (k, k, k), {"bits": ((0, 1), (40,))}),
        ("radix_sort_segmented", (k10, k10), {"num_partitions": 2, "offsets": np.array([0, 10])}),  # both forms
        ("radix_sort_segmented", (k10, k10), {"num_partitions": 3}),  # 3 does not divide 10
        ("radix_sort_segmented", (k10, k10), {"offsets": np.array([1, 10])}),  # offsets[0] != 0
        ("radix_sort_segmented", (k10, k10), {"offsets": np.array([0, 9])}),  # offsets[-1] != n
        ("radix_sort_segmented", (k10, k10), {"offsets": np.array([0, 7, 3, 10])}),  # decreasing
        ("radix_sort_f32", (k, k), {}),  # f32 keys must be float32
        ("radix_sort_i32", (k.astype(np.int32), k.astype(np.int32)), {}),  # values must be uint32
        ("radix_sort_u64", (k, k), {}),  # u64 keys must be uint64
        ("radix_sort_multi", (k, (k, k[:3])), {}),  # a payload's length
    ]
    for name, arrays, kwargs in bad_variants:
        with pytest.raises(JaxArgumentError):
            jax_kw = {a: jnp.asarray(b) if isinstance(b, np.ndarray) else b for a, b in kwargs.items()}
            args = [tuple(map(jnp.asarray, a)) if isinstance(a, tuple) else jnp.asarray(a) for a in arrays]
            getattr(glu_tpu, name)(*args, backend="xla", **jax_kw)
        for backend in ("cuda", "torch"):
            with pytest.raises(GluArgumentError):
                args = [tuple(from_numpy(b, "cpu") for b in a) if isinstance(a, tuple) else from_numpy(a, "cpu")
                        for a in arrays]
                getattr(glu_tpu_torch, name)(*args, backend=backend, **kwargs)
