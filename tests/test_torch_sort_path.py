"""One path from every public sort to the engine, on the CPU: each public
sort routes once a call and reaches ops/_cuda_sort.py::sort_streams (twice
for the two-word chains) with a tuple of positions, on K3's side of
SINGLE_TILE_MAX and on the multi-tile side, bit for bit as backend="torch";
a pair sort sorts as ref_radix_sort and checks num_steps; sort_streams takes
uint32 words as they are and strided inputs sort as contiguous ones. The engine's
launches are held to backend="torch" on the card in tests/test_torch_cuda.py."""

import importlib

import numpy as np
import pytest
import torch

import glu_tpu_torch
from glu_tpu_torch.ops import _cuda_sort as cs
from glu_tpu_torch.ops.reference import ref_radix_sort
from glu_tpu_torch.utils import timing

rs = importlib.import_module("glu_tpu_torch.ops.radix_sort")  # the module; the package re-exports a function of its name


def _u32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint32).view(np.int32)).view(torch.uint32)


def _pairs(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    return _u32(rng.integers(0, 2**32, n, dtype=np.uint32)), _u32(np.arange(n))


def _assert_sorted_as_ref(out, keys, vals, num_steps=0) -> None:
    want = ref_radix_sort(keys, vals, num_steps)
    for got, w in zip(out, want):
        assert got.dtype == torch.uint32
        assert torch.equal(got.view(torch.int32), w.view(torch.int32))


@pytest.fixture
def engine_calls(monkeypatch):
    """The positions of each call of cs.sort_streams, which still sorts."""
    calls = []
    engine = cs.sort_streams

    def spy(keys, payloads, positions):
        calls.append(positions)
        return engine(keys, payloads, positions)

    monkeypatch.setattr(cs, "sort_streams", spy)
    monkeypatch.delenv("GLU_TPU_TORCH_BACKEND", raising=False)
    return calls


@pytest.mark.parametrize("kw", [
    pytest.param({}, id="default"),
    pytest.param({"num_steps": 3}, id="num_steps-3"),
    pytest.param({"backend": "cuda"}, id="cuda"),
    pytest.param({"backend": "torch"}, id="torch"),
])
@pytest.mark.parametrize("n", [2, 1000, 4097])
def test_a_cpu_pair_sort_matches_ref_radix_sort(n, kw):
    keys, vals = _pairs(n)
    _assert_sorted_as_ref(glu_tpu_torch.radix_sort(keys, vals, **kw), keys, vals, kw.get("num_steps", 0))


@pytest.mark.parametrize("route", ["cuda", "torch"])
def test_a_pair_sort_is_routed_once(engine_calls, route):
    # "cuda" reaches the engine once a call with the key bits of its
    # num_steps; "torch" never does
    keys, vals = _pairs(1000)
    before = timing.summary()["counters"]
    if route == "cuda":
        _assert_sorted_as_ref(glu_tpu_torch.radix_sort(keys, vals, backend="cuda"), keys, vals)
        _assert_sorted_as_ref(glu_tpu_torch.radix_sort(keys, vals, 3, backend="cuda"), keys, vals, 3)
        calls, positions = 2, [tuple(range(32)), tuple(range(12))]
    else:
        _assert_sorted_as_ref(glu_tpu_torch.radix_sort(keys, vals, backend="torch"), keys, vals)
        calls, positions = 1, []
    after = timing.summary()["counters"]
    assert after.get(f"route.sort.{route}", 0) - before.get(f"route.sort.{route}", 0) == calls
    assert engine_calls == positions


def test_a_pair_sort_checks_num_steps():
    keys, vals = _pairs(100)
    with pytest.raises(glu_tpu_torch.GluError, match="num_steps must be in 1..8"):
        glu_tpu_torch.radix_sort(keys, vals, 9)


def _inputs(n: int, seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    keys[::3] &= 0xFF  # ties: stability shows
    floats = rng.standard_normal(n).astype(np.float32)
    floats[::4] = floats[1::4]
    floats[::7] = -0.0
    return {
        "keys": _u32(keys),
        "vals": _u32(np.arange(n)),
        "f32": torch.from_numpy(floats),
        "i32": torch.from_numpy((rng.integers(-(2**31), 2**31, n) >> (rng.integers(0, 2, n) * 24)).astype(np.int32)),
        "hi": _u32(rng.integers(0, 5, n)),
        "pays": [_u32(rng.integers(0, 2**32, n, dtype=np.uint32)) for _ in range(9)],
    }


FORMS = {  # name -> (call with backend=, the engine's sorts a call)
    "radix_sort": (lambda x, b: glu_tpu_torch.radix_sort(x["keys"], x["vals"], backend=b), 1),
    "radix_sort num_steps=3": (lambda x, b: glu_tpu_torch.radix_sort(x["keys"], x["vals"], 3, backend=b), 1),
    "radix_sort descending": (lambda x, b: glu_tpu_torch.radix_sort(x["keys"], x["vals"], backend=b,
                                                                    descending=True), 1),
    "radix_sort bits 12": (lambda x, b: glu_tpu_torch.radix_sort(x["keys"], x["vals"], backend=b,
                                                                 bits=tuple(range(4, 16))), 1),
    "radix_sort_keys": (lambda x, b: glu_tpu_torch.radix_sort_keys(x["keys"], backend=b), 1),
    "radix_sort_multi 2": (lambda x, b: glu_tpu_torch.radix_sort_multi(x["keys"], x["pays"][:2], backend=b), 1),
    "radix_sort_multi 9": (lambda x, b: glu_tpu_torch.radix_sort_multi(x["keys"], x["pays"], backend=b), 1),
    "radix_argsort": (lambda x, b: glu_tpu_torch.radix_argsort(x["keys"], backend=b), 1),
    "radix_sort_f32": (lambda x, b: glu_tpu_torch.radix_sort_f32(x["f32"], x["vals"], backend=b), 1),
    "radix_sort_i32": (lambda x, b: glu_tpu_torch.radix_sort_i32(x["i32"], x["vals"], backend=b), 1),
    "radix_sort_u64_parts": (lambda x, b: glu_tpu_torch.radix_sort_u64_parts(x["hi"], x["keys"], x["vals"],
                                                                             backend=b), 2),
    "radix_sort_segmented 4": (lambda x, b: glu_tpu_torch.radix_sort_segmented(x["keys"], x["vals"], 4, backend=b),
                               2),
}


def _flat(out) -> list:
    return [t for o in out for t in (o if isinstance(o, (tuple, list)) else [o])]


@pytest.mark.parametrize("n", [300, 1500], ids=["k3", "multi-tile"])
@pytest.mark.parametrize("form", list(FORMS))
def test_every_public_sort_routes_once_and_reaches_the_engine(engine_calls, monkeypatch, form, n):
    monkeypatch.setattr(cs, "TILE", 256)
    monkeypatch.setattr(cs, "SINGLE_TILE_MAX", 512)
    call, sorts = FORMS[form]
    x = _inputs(n)
    before = timing.summary()["counters"]
    got = _flat(call(x, None))
    after = timing.summary()["counters"]
    routes = {k: after[k] - before.get(k, 0) for k in after if k.startswith("route.") and after[k] != before.get(k, 0)}
    assert list(routes.values()) == [1], routes
    assert len(engine_calls) == sorts and all(isinstance(p, tuple) and p for p in engine_calls), engine_calls
    want = _flat(call(x, "torch"))
    assert len(engine_calls) == sorts  # the torch backend does not reach the engine
    assert [(g.dtype, g.shape) for g in got] == [(w.dtype, w.shape) for w in want]
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("n", [300, 1500], ids=["k3", "multi-tile"])
def test_sort_streams_takes_uint32_words_and_keeps_each_streams_dtype(monkeypatch, n):
    monkeypatch.setattr(cs, "TILE", 256)
    monkeypatch.setattr(cs, "SINGLE_TILE_MAX", 512)
    x = _inputs(n)
    keys, pays = x["keys"], [x["vals"], x["i32"]]
    kept = [t.clone() for t in (keys, *pays)]
    got_k, got_p = cs.sort_streams(keys, pays, tuple(range(32)))
    want_k, want_p = cs.sort_streams(keys.view(torch.int32), [p.view(torch.int32) for p in pays], tuple(range(32)))
    assert [t.dtype for t in (got_k, *got_p)] == [torch.uint32, torch.uint32, torch.int32]
    for g, w in zip((got_k, *got_p), (want_k, *want_p)):
        assert torch.equal(g.view(torch.int32), w)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip((keys, *pays), kept))


STRIDED = {  # name -> call on (keys, values) of uint32, f32 and i32 keys
    "radix_sort": lambda x, k, v: glu_tpu_torch.radix_sort(k, v),
    "radix_sort_keys": lambda x, k, v: glu_tpu_torch.radix_sort_keys(k),
    "radix_sort_multi": lambda x, k, v: glu_tpu_torch.radix_sort_multi(k, [v, v]),
    "radix_sort_f32": lambda x, k, v: glu_tpu_torch.radix_sort_f32(x["f32"][: k.shape[0]], v),
    "radix_sort_i32": lambda x, k, v: glu_tpu_torch.radix_sort_i32(x["i32"][: k.shape[0]], v),
}


@pytest.mark.parametrize("form", list(STRIDED))
def test_public_sorts_of_strided_inputs_sort_as_their_contiguous_copies(form):
    x = _inputs(2000)
    keys, vals = x["keys"][::2], x["vals"][::2]
    assert not keys.is_contiguous()
    got = _flat(STRIDED[form](x, keys, vals))
    want = _flat(STRIDED[form](x, keys.contiguous(), vals.contiguous()))
    assert [g.dtype for g in got] == [w.dtype for w in want]
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
