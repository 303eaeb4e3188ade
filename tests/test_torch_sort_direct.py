"""radix_sort's direct path to K3 (ops/radix_sort.py::_k3_direct), on the
CPU: which calls the predicate picks and refuses, that a CPU call never
takes the path nor counts `sort.k3_direct` and sorts as before, that a call
the predicate picks but the route sends to "torch" is routed once, and that
summary() lists the counter. The path itself launches K3 on the card:
tests/test_torch_cuda.py holds it to backend="torch" there."""

import importlib

import numpy as np
import pytest
import torch

import glu_tpu_torch
from glu_tpu_torch.ops import _cuda_sort as cs
from glu_tpu_torch.ops.reference import ref_radix_sort
from glu_tpu_torch.utils import timing

rs = importlib.import_module("glu_tpu_torch.ops.radix_sort")  # the module; the package re-exports a function of its name

DIRECT = "sort.k3_direct"


@pytest.mark.parametrize("n", [2, 3, 1024, 6144, 6145, 53_000, cs.SINGLE_TILE_MAX])
def test_k3_direct_picks_an_ascending_contiguous_card_sort_in_k3s_range(n):
    assert rs._k3_direct(True, True, n, None, False)


@pytest.mark.parametrize("on_cuda, contiguous, n, bits, descending", [
    pytest.param(False, True, 1024, None, False, id="cpu"),
    pytest.param(True, False, 1024, None, False, id="non-contiguous"),
    pytest.param(True, True, 1, None, False, id="one-pair"),
    pytest.param(True, True, 0, None, False, id="empty"),
    pytest.param(True, True, cs.SINGLE_TILE_MAX + 1, None, False, id="past-k3"),
    pytest.param(True, True, 1024, tuple(range(12)), False, id="bits"),
    pytest.param(True, True, 1024, "auto", False, id="bits-auto"),
    pytest.param(True, True, 1024, (), False, id="bits-empty"),
    pytest.param(True, True, 1024, None, True, id="descending"),
])
def test_k3_direct_refuses_every_other_call(on_cuda, contiguous, n, bits, descending):
    assert not rs._k3_direct(on_cuda, contiguous, n, bits, descending)


def _pairs(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    return torch.from_numpy(keys.view(np.int32)).view(torch.uint32), torch.arange(n, dtype=torch.int32).view(
        torch.uint32)


def _assert_sorted_as_ref(out, keys, vals, num_steps=0) -> None:
    want = ref_radix_sort(keys, vals, num_steps)
    for got, w in zip(out, want):
        assert got.dtype == torch.uint32
        assert torch.equal(got.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("kw", [
    pytest.param({}, id="default"),
    pytest.param({"num_steps": 3}, id="num_steps-3"),
    pytest.param({"backend": "cuda"}, id="cuda"),
    pytest.param({"backend": "torch"}, id="torch"),
])
@pytest.mark.parametrize("n", [2, 1000, 4097])
def test_cpu_calls_never_take_the_direct_path(n, kw):
    keys, vals = _pairs(n)
    before = timing.summary()["counters"][DIRECT]
    out = glu_tpu_torch.radix_sort(keys, vals, **kw)
    assert timing.summary()["counters"][DIRECT] == before
    _assert_sorted_as_ref(out, keys, vals, kw.get("num_steps", 0))


@pytest.mark.parametrize("route", ["cuda", "torch"])
def test_a_picked_call_is_routed_once(monkeypatch, route):
    # the predicate made to pick a CPU call: routed to "cuda", it takes the
    # direct path (stubbed: a CPU tensor cannot launch K3) with the key bits
    # of its num_steps; routed elsewhere, today's path with the route taken
    monkeypatch.setattr(rs, "_k3_direct", lambda *args: True)
    monkeypatch.setattr(cs, "sort_pairs_single_tile", lambda k, v, positions: ("direct", positions))
    keys, vals = _pairs(1000)
    before = timing.summary()["counters"]
    if route == "cuda":
        assert glu_tpu_torch.radix_sort(keys, vals, backend="cuda") == ("direct", tuple(range(32)))
        assert glu_tpu_torch.radix_sort(keys, vals, 3, backend="cuda") == ("direct", tuple(range(12)))
        calls, direct = 2, 2
    else:
        _assert_sorted_as_ref(glu_tpu_torch.radix_sort(keys, vals, backend="torch"), keys, vals)
        calls, direct = 1, 0
    after = timing.summary()["counters"]
    assert after.get(f"route.sort.{route}", 0) - before.get(f"route.sort.{route}", 0) == calls
    assert after[DIRECT] - before[DIRECT] == direct


def test_a_picked_call_checks_num_steps_as_before(monkeypatch):
    monkeypatch.setattr(rs, "_k3_direct", lambda *args: True)
    keys, vals = _pairs(100)
    with pytest.raises(glu_tpu_torch.GluError, match="num_steps must be in 1..8"):
        glu_tpu_torch.radix_sort(keys, vals, 9)


def test_summary_lists_the_direct_path_counter():
    timing.reset()
    assert timing.summary()["counters"][DIRECT] == 0
    glu_tpu_torch.radix_sort(*_pairs(100))
    assert timing.summary()["counters"][DIRECT] == 0
