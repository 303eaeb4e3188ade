"""The port's sort variants (keys-only, multi-payload, argsort, f32 / i32 /
u64 keys, descending=, bits= and segmented sorts) against glu_tpu's, on the
cases of tests/test_radix_sort.py, tests/test_adaptive_sort.py and the sort
parts of tests/test_fuzz.py. Inputs come from seeded numpy generators and go
to both packages; every output must be bit-identical (floats compared as
bit patterns, so -0.0 is not +0.0 and each NaN keeps its sign).

The JAX side runs backend="xla", jitted where the call allows it (bits="auto"
syncs the host and runs eagerly). Each case runs through both of the port's
backends: "cuda", the radix engine, which here runs its kernels' plain torch
versions with the tile shrunk to 256 elements and the single-tile limit to
512, so that inputs span many tiles with a ragged tail or take the
single-tile path; and "torch", one stable torch.sort.
"""

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glu_tpu
import glu_tpu_torch
from glu_tpu_torch import from_numpy, to_numpy
from glu_tpu_torch.ops import _cuda_sort as cs

rs = importlib.import_module("glu_tpu_torch.ops.radix_sort")

SMALL_TILE = 256
SMALL_SINGLE_MAX = 512
PORT_BACKENDS = ("cuda", "torch")
U32_MAX = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def small_tiles(monkeypatch):
    monkeypatch.setattr(cs, "TILE", SMALL_TILE)
    monkeypatch.setattr(cs, "SINGLE_TILE_MAX", SMALL_SINGLE_MAX)


def _map(fn, x):
    """fn on every numpy array of x, through nested tuples and lists."""
    if isinstance(x, np.ndarray):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return tuple(_map(fn, a) for a in x)
    return x


def _leaves(x) -> list:
    if isinstance(x, (tuple, list)):
        return [a for item in x for a in _leaves(item)]
    return [x]


def _jax_outputs(fn_name: str, args, kw) -> list:
    """glu_tpu.<fn_name>(*args, **kw, backend="xla") as numpy arrays; array
    keyword arguments (offsets) are traced, the rest static."""
    arrays = {k: v for k, v in kw.items() if isinstance(v, np.ndarray)}
    fn = partial(getattr(glu_tpu, fn_name), backend="xla", **{k: v for k, v in kw.items() if k not in arrays})

    def call(a, k):
        return fn(*a, **k)

    if kw.get("bits") != "auto":
        call = jax.jit(call)
    out = call(_map(jnp.asarray, args), {k: jnp.asarray(v) for k, v in arrays.items()})
    return [np.asarray(x) for x in _leaves(out)]


def _assert_bits_equal(got: np.ndarray, want: np.ndarray, label: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (label, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=label)


def _check(fn_name: str, args, **kw) -> None:
    """The port's fn_name under both of its backends against glu_tpu's, bit
    for bit; the port's inputs must come back unmodified."""
    want = _jax_outputs(fn_name, args, kw)
    for b in PORT_BACKENDS:
        targs = _map(lambda a: from_numpy(a, "cpu"), args)
        tkw = {k: from_numpy(v, "cpu") if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        got = [to_numpy(t) for t in _leaves(getattr(glu_tpu_torch, fn_name)(*targs, backend=b, **tkw))]
        assert len(got) == len(want), (b, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bits_equal(g, w, f"{fn_name} backend={b} output {i}")
        for t, a in zip(_leaves(targs), _leaves(args)):  # out of place
            _assert_bits_equal(to_numpy(t), a, f"{fn_name} backend={b}: an input was modified")


def _u32(rng, n: int, hi: int = U32_MAX) -> np.ndarray:
    return rng.integers(0, hi + 1, n, dtype=np.uint64).astype(np.uint32)


def _iota(n: int) -> np.ndarray:
    return np.arange(n, dtype=np.uint32)


def _f32_specials(rng) -> np.ndarray:
    k = np.concatenate([
        rng.uniform(-1e9, 1e9, 4000).astype(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, np.nan, -np.nan], dtype=np.float32),
        np.array([0x7FC00001, 0xFFC00001, 0x7F800001, 0xFF800001], dtype=np.uint32).view(np.float32),  # NaN payloads
    ])
    k[::97] = -0.0
    k[::89] = 0.0
    return rng.permutation(k)


def _i32_extremes(rng) -> np.ndarray:
    k = np.concatenate([
        rng.integers(-(1 << 31), 1 << 31, 4000).astype(np.int32),
        np.array([0, -1, 1, -(1 << 31), (1 << 31) - 1], dtype=np.int32),
    ])
    k[::11] = k[1]  # duplicates: ties keep input order
    return k


def _u64_dups(rng, n: int) -> np.ndarray:
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    k[: n // 8] |= np.uint64(1 << 63)  # keys >= 2**63
    k[n // 2 :] = k[: n - n // 2]  # duplicates across the array
    k[::5] = (k[::5] & np.uint64(0xFFFFFFFF00000000)) | np.uint64(7)  # equal hi words, small lo
    k[1::5] = k[0] & np.uint64(0xFFFFFFFF00000000) | _u32(rng, len(k[1::5])).astype(np.uint64)
    return k


def _ragged_offsets(rng, n: int, segments: int) -> np.ndarray:
    cuts = np.sort(rng.integers(0, n + 1, segments - 1))
    return np.concatenate([[0], cuts, [n]]).astype(np.int32)


# name -> rng -> (function name, positional arrays, keyword arguments);
# the tests/ file and line of the JAX case each mirrors
CASES = {
    # keys-only, multi-payload and argsort (test_radix_sort.py:117,
    # test_adaptive_sort.py:112,299)
    "keys": lambda r: ("radix_sort_keys", (_u32(r, 5000),), {}),
    "keys num_steps=3": lambda r: ("radix_sort_keys", (_u32(r, 3000),), {"num_steps": 3}),
    "keys auto 9 sparse bits": lambda r: ("radix_sort_keys", (_u32(r, 4000) & np.uint32(0b1011010011010),),
                                          {"bits": "auto"}),
    "multi 0 payloads": lambda r: ("radix_sort_multi", (_u32(r, 3000), ()), {}),
    "multi 2 payloads auto": lambda r: ("radix_sort_multi",
                                        (_u32(r, 4000) & np.uint32(0b1011010011010), (_iota(4000), _u32(r, 4000))),
                                        {"bits": "auto"}),
    "multi 7 payloads (the cap)": lambda r: ("radix_sort_multi", (_u32(r, 3000, 99), tuple(_u32(r, 3000) for _ in range(7))), {}),
    "multi 8 payloads": lambda r: ("radix_sort_multi", (_u32(r, 3000, 99), tuple(_u32(r, 3000) for _ in range(8))), {}),
    "multi 9 payloads bits": lambda r: ("radix_sort_multi", (_u32(r, 3000), tuple(_u32(r, 3000) for _ in range(9))),
                                        {"bits": (3, 1, 20, 31, 7)}),
    "multi 9 payloads num_steps=5": lambda r: ("radix_sort_multi", (_u32(r, 400), tuple(_u32(r, 400) for _ in range(9))),
                                               {"num_steps": 5}),
    "argsort": lambda r: ("radix_argsort", (_u32(r, 5000, 999),), {}),
    "argsort descending auto": lambda r: ("radix_argsort", (_u32(r, 5000, 999),), {"descending": True, "bits": "auto"}),
    "argsort single tile": lambda r: ("radix_argsort", (_u32(r, 300),), {"descending": True}),
    # descending (test_radix_sort.py:262, test_adaptive_sort.py:99)
    "descending duplicates": lambda r: ("radix_sort", (_u32(r, 4000, 100), _iota(4000)), {"descending": True}),
    "descending num_steps=8": lambda r: ("radix_sort", (_u32(r, 2000), _iota(2000)), {"descending": True, "num_steps": 8}),
    "descending auto": lambda r: ("radix_sort", (_u32(r, 5000, 99), _iota(5000)), {"descending": True, "bits": "auto"}),
    "descending constant": lambda r: ("radix_sort", (np.full(1000, 7, np.uint32), _iota(1000)), {"descending": True}),
    # f32 and i32 keys (test_radix_sort.py:165-224,276; test_adaptive_sort.py:131)
    "f32 specials": lambda r: ("radix_sort_f32", (_f32_specials(r), _iota(4012)), {}),
    "f32 specials descending": lambda r: ("radix_sort_f32", (_f32_specials(r), _iota(4012)), {"descending": True}),
    "f32 duplicates descending": lambda r: ("radix_sort_f32",
                                            (np.repeat(r.uniform(-100, 100, 500).astype(np.float32), 6), _iota(3000)),
                                            {"descending": True}),
    "f32 auto": lambda r: ("radix_sort_f32", (_u32(r, 3000, 255).astype(np.float32), _iota(3000)), {"bits": "auto"}),
    "f32 bits": lambda r: ("radix_sort_f32", (_f32_specials(r), _iota(4012)), {"bits": (31, 30, 23, 0)}),
    "i32 extremes": lambda r: ("radix_sort_i32", (_i32_extremes(r), _iota(4005)), {}),
    "i32 descending": lambda r: ("radix_sort_i32", (r.integers(-1000, 1000, 3000).astype(np.int32), _iota(3000)),
                                 {"descending": True}),
    "i32 auto": lambda r: ("radix_sort_i32", ((r.integers(0, 200, 3000) - 100).astype(np.int32), _iota(3000)),
                           {"bits": "auto"}),
    # bits= (test_adaptive_sort.py:49-96,156-180)
    **{
        f"bits {size} auto %10": (lambda r, size=size: (
            "radix_sort", (_u32(r, size) % np.uint32(10), _iota(size)), {"bits": "auto"}))
        for size in (100, 4096, 20000)
    },
    **{
        f"bits {pos}": (lambda r, pos=pos: ("radix_sort", (_u32(r, 6000), _iota(6000)), {"bits": pos}))
        for pos in [(0,), (31,), (1, 5, 17, 30, 31), tuple(range(4, 13)), tuple(range(32)), tuple(range(31, -1, -1)),
                    (0, 3, 9, 17, 31), ()]
    },
    "bits significance (8, 0)": lambda r: ("radix_sort", (np.array([0x100, 0, 0x101, 1], np.uint32), _iota(4)),
                                           {"bits": (8, 0)}),
    "bits auto constant": lambda r: ("radix_sort", (np.full(777, 42, np.uint32), _iota(777)), {"bits": "auto"}),
    "bits auto 6 low bits": lambda r: ("radix_sort", (_u32(r, 6000) & np.uint32(0x3F), _iota(6000)), {"bits": "auto"}),
    # u64 keys (test_radix_sort.py:226-259, test_adaptive_sort.py:147,283)
    "u64 parts": lambda r: ("radix_sort_u64_parts", (np.repeat(_u32(r, 2500), 2), _u32(r, 5000), _iota(5000)), {}),
    "u64 parts auto": lambda r: ("radix_sort_u64_parts", (_u32(r, 4000, 7), _u32(r, 4000), _iota(4000)), {"bits": "auto"}),
    "u64 parts bit pair": lambda r: ("radix_sort_u64_parts", (_u32(r, 3000, 7), _u32(r, 3000, 0xFFFF), _iota(3000)),
                                     {"bits": ((0, 1, 2), tuple(range(16)))}),
    "u64 parts constant auto": lambda r: ("radix_sort_u64_parts", (np.full(600, 3, np.uint32), np.full(600, 9, np.uint32),
                                                                   _iota(600)), {"bits": "auto"}),
    "u64 duplicates": lambda r: ("radix_sort_u64", (_u64_dups(r, 3000), _iota(3000)), {}),
    "u64 single tile": lambda r: ("radix_sort_u64", (_u64_dups(r, 400), _iota(400)), {}),
    "u64 below 2**40 auto": lambda r: ("radix_sort_u64", (r.integers(0, 1 << 40, 3000, dtype=np.uint64), _iota(3000)),
                                       {"bits": "auto"}),
    # segmented (test_radix_sort.py:298-410, test_adaptive_sort.py:330)
    **{
        f"segmented {p} partitions": (lambda r, p=p: (
            "radix_sort_segmented", (np.where(_iota(130 * p) < 43 * p, 5, _u32(r, 130 * p)).astype(np.uint32),
                                     _iota(130 * p)), {"num_partitions": p}))
        for p in (1, 4, 13, 100)
    },
    "segmented 16 partitions auto": lambda r: ("radix_sort_segmented", (_u32(r, 4096, 99), _iota(4096)),
                                               {"num_partitions": 16, "bits": "auto"}),
    **{
        f"segmented offsets {s} ragged": (lambda r, s=s: (
            "radix_sort_segmented", (np.where(_iota(4000) < 1333, 5, _u32(r, 4000)).astype(np.uint32), _iota(4000)),
            {"offsets": _ragged_offsets(r, 4000, s)}))
        for s in (1, 2, 7, 64, 300)
    },
    "segmented offsets empty and singleton": lambda r: (
        "radix_sort_segmented", (_u32(r, 1500, 1000), _iota(1500)),
        {"offsets": np.array([0, 0, 1, 1, 1, 2, 700, 700, 1499, 1500, 1500], np.int32)}),
    "segmented offsets equal partitions": lambda r: (
        "radix_sort_segmented", (_u32(r, 2048, 5000), _iota(2048)), {"offsets": np.arange(0, 2049, 256, dtype=np.int32)}),
    "segmented offsets bits": lambda r: ("radix_sort_segmented", (_u32(r, 3000), _iota(3000)),
                                         {"offsets": _ragged_offsets(r, 3000, 20), "bits": (2, 30, 11)}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_variant_matches_jax(case):
    fn_name, args, kw = CASES[case](np.random.default_rng(sum(map(ord, case))))
    _check(fn_name, args, **kw)


def test_segmented_offsets_equal_partitions_match_num_partitions(seeded_rng):
    # the offsets form with equal boundaries gives the num_partitions form
    # (test_radix_sort.py:392)
    keys = seeded_rng(123).sample_int_vector(2048, 0, 5000)
    for b in PORT_BACKENDS:
        a = glu_tpu_torch.radix_sort_segmented(from_numpy(keys, "cpu"), from_numpy(_iota(2048), "cpu"), 8, backend=b)
        c = glu_tpu_torch.radix_sort_segmented(from_numpy(keys, "cpu"), from_numpy(_iota(2048), "cpu"), backend=b,
                                               offsets=np.arange(0, 2049, 256))
        for x, y in zip(a, c):
            np.testing.assert_array_equal(to_numpy(x), to_numpy(y))


TINY = {  # fn name -> n -> (arrays, keywords); count <= 1 early-exits
    "radix_sort_keys": lambda n: ((_iota(n) + 5,), {}),
    "radix_sort_multi": lambda n: ((_iota(n) + 5, (_iota(n), _iota(n) + 9)), {}),
    "radix_argsort": lambda n: ((_iota(n) + 5,), {"descending": True}),
    "radix_sort_f32": lambda n: ((np.full(n, -0.0, np.float32), _iota(n)), {}),
    "radix_sort_i32": lambda n: ((np.full(n, -3, np.int32), _iota(n)), {"descending": True}),
    "radix_sort_u64": lambda n: ((np.full(n, 2**63 + 1, np.uint64), _iota(n)), {}),
    "radix_sort_u64_parts": lambda n: ((_iota(n) + 1, _iota(n) + 2, _iota(n)), {}),
    "radix_sort_segmented": lambda n: ((_iota(n) + 5, _iota(n)), {"offsets": np.array([0, n, n])}),
}


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("fn_name", list(TINY))
def test_variant_tiny_counts(fn_name, n):
    args, kw = TINY[fn_name](n)
    _check(fn_name, args, **kw)


# -- the sort parts of tests/test_fuzz.py, with fewer trials -------------------


def _fuzz_keys(rng, n):
    """Random keys from a randomly chosen distribution (test_fuzz.py:34)."""
    kind = rng.integers(0, 5)
    if kind == 0:
        return rng.integers(0, 1 << 32, n, dtype=np.uint32)
    if kind == 1:  # low entropy
        return rng.integers(0, max(int(rng.integers(1, 8)), 1), n, dtype=np.uint32)
    if kind == 2:
        return np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint32))
    if kind == 3:
        return np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint32))[::-1].copy()
    return np.full(n, rng.integers(0, 1 << 32), dtype=np.uint32)


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_sort(trial):
    # test_fuzz.py:47: random lengths, distributions and partial num_steps
    rng = np.random.default_rng(1000 + trial)
    n, steps = int(rng.integers(1, 8193)), int(rng.integers(1, 9))
    _check("radix_sort", (_fuzz_keys(rng, n), _iota(n)), num_steps=steps)


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_sort_multi(trial):
    # test_fuzz.py:84: 0-3 payload streams (here up to 9, past the cap)
    rng = np.random.default_rng(5000 + trial)
    n, steps, ns = int(rng.integers(1, 8193)), int(rng.integers(1, 9)), int(rng.integers(0, 10))
    pays = tuple(rng.integers(0, 1 << 32, n, dtype=np.uint32) for _ in range(ns))
    _check("radix_sort_multi", (_fuzz_keys(rng, n), pays), num_steps=steps)


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_adaptive_bits(trial):
    # test_fuzz.py:143: random explicit bit subsets, and bits="auto" on
    # randomly masked keys
    rng = np.random.default_rng(4000 + trial)
    n = int(rng.integers(2, 8193))
    if trial % 2 == 0:
        bits = tuple(int(b) for b in rng.choice(32, size=int(rng.integers(1, 33)), replace=False))
        k = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    else:
        mask = np.uint32(rng.integers(0, 1 << 32, dtype=np.uint64))
        base = np.uint32(rng.integers(0, 1 << 32, dtype=np.uint64)) & ~mask
        k = (rng.integers(0, 1 << 32, n, dtype=np.uint32) & mask) | base
        bits = "auto"
    _check("radix_sort", (k, _iota(n)), bits=bits)


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_segmented_offsets(trial):
    # test_fuzz.py:173: random boundaries with duplicates (empty segments)
    rng = np.random.default_rng(7000 + trial)
    n, s = int(rng.integers(2, 6000)), int(rng.integers(1, 40))
    k = rng.integers(0, int(rng.integers(1, 1 << 32)), n, dtype=np.uint32)
    _check("radix_sort_segmented", (k, _iota(n)), offsets=_ragged_offsets(rng, n, s))


# -- the envelope of bits="auto" ------------------------------------------------

ENVELOPE_KEYS = {
    "two bits": np.array([0b1010, 0b0010, 0b1000], np.uint32),  # test_adaptive_sort.py:39
    "constant": np.array([7, 7, 7], np.uint32),
    "one key": np.array([5], np.uint32),
    "full": np.array([0, U32_MAX], np.uint32),
    "top bit": np.array([1 << 31, 0, 1 << 31], np.uint32),
    **{f"masked {seed}": (lambda g: (g.integers(0, 1 << 32, 3000, dtype=np.uint32)
                                     & np.uint32(g.integers(0, 1 << 32)))
                          | np.uint32(g.integers(0, 1 << 32)))(np.random.default_rng(seed)) for seed in range(4)},
}


@pytest.mark.parametrize("name", list(ENVELOPE_KEYS))
def test_varying_key_bits_matches_jax(name):
    keys = ENVELOPE_KEYS[name]
    want = glu_tpu.varying_key_bits(jnp.asarray(keys))
    oracle = int(np.bitwise_or.reduce(keys) ^ np.bitwise_and.reduce(keys)) if keys.size else 0
    assert want == tuple(b for b in range(32) if (oracle >> b) & 1)
    assert glu_tpu_torch.varying_key_bits(from_numpy(keys, "cpu")) == want
    words = torch.from_numpy(keys.view(np.int32))
    for b in PORT_BACKENDS:  # digit_histograms' plain version, and the torch fold
        assert rs._varying_bits(words, b) == want, b


# -- the engine's plan for each variant ------------------------------------------


def _spy_engine(monkeypatch) -> dict:
    """Count the engine's kernel-wrapper calls and the payload streams that
    each sort hands the engine."""
    seen = {"digit_histograms": 0, "onesweep_pass": 0, "sort_single_tile": 0, "engine payloads": []}
    for name in ("digit_histograms", "onesweep_pass", "sort_single_tile"):
        def spy(*args, _name=name, _fn=getattr(cs, name)):
            seen[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(cs, name, spy)
    engine = cs.sort_streams

    def spy_engine(keys, payloads, positions):
        seen["engine payloads"].append(len(payloads))
        return engine(keys, payloads, positions)

    monkeypatch.setattr(cs, "sort_streams", spy_engine)
    return seen


N_MULTI = 4 * SMALL_SINGLE_MAX  # past the single-tile limit


PLANS = {  # name -> (call on the "cuda" backend, (histograms, passes, K3), payloads per engine sort)
    "keys": (lambda r: glu_tpu_torch.radix_sort_keys(_tu32(r, N_MULTI)), (1, 4, 0), [0]),
    "argsort descending": (lambda r: glu_tpu_torch.radix_argsort(_tu32(r, N_MULTI), descending=True), (1, 4, 0), [1]),
    "auto below 2**10": (lambda r: glu_tpu_torch.radix_sort(_tu32(r, N_MULTI, 1023), _tu32(r, N_MULTI), bits="auto"),
                         (2, 2, 0), [1]),
    "auto constant": (lambda r: glu_tpu_torch.radix_sort(_tu32(r, N_MULTI, 0), _tu32(r, N_MULTI), bits="auto"),
                      (1, 0, 0), []),
    "bits (0, 3, 9, 17, 31)": (lambda r: glu_tpu_torch.radix_sort(_tu32(r, N_MULTI), _tu32(r, N_MULTI),
                                                                  bits=(0, 3, 9, 17, 31)), (1, 1, 0), [1]),
    "u64": (lambda r: glu_tpu_torch.radix_sort_u64(torch.from_numpy(r.integers(0, 2**64, N_MULTI, dtype=np.uint64)),
                                                   _tu32(r, N_MULTI)), (2, 8, 0), [2, 2]),
    "segmented 4096 offsets": (lambda r: glu_tpu_torch.radix_sort_segmented(
        _tu32(r, N_MULTI), _tu32(r, N_MULTI), offsets=_ragged_offsets(r, N_MULTI, 4096)), (2, 6, 0), [2, 2]),
    "segmented 300 partitions, single tile": (lambda r: glu_tpu_torch.radix_sort_segmented(
        _tu32(r, 300), _tu32(r, 300), 300), (0, 0, 2), [2, 2]),
    "multi 7": (lambda r: glu_tpu_torch.radix_sort_multi(_tu32(r, N_MULTI), [_tu32(r, N_MULTI)] * 7), (1, 4, 0), [7]),
    "multi 9": (lambda r: glu_tpu_torch.radix_sort_multi(_tu32(r, N_MULTI), [_tu32(r, N_MULTI)] * 9), (1, 4, 0), [1]),
}


def _tu32(rng, n: int, hi: int = U32_MAX) -> torch.Tensor:
    return from_numpy(_u32(rng, n, hi), "cpu")


@pytest.mark.parametrize("name", list(PLANS))
def test_engine_plan_of_each_variant(name, monkeypatch):
    # the launches chip_smoke.py asserts on the card: v varying bits take
    # ceil(v/8) passes, bits="auto" one more histogram (its envelope), u64
    # and segments two engine sorts, 8+ payloads one index payload
    call, want, payloads = PLANS[name]
    seen = _spy_engine(monkeypatch)
    call(np.random.default_rng(3))
    assert (seen["digit_histograms"], seen["onesweep_pass"], seen["sort_single_tile"]) == want
    assert seen["engine payloads"] == payloads
