"""The port's tracing (glu_tpu_torch/utils/timing.py): spans, their nesting,
self time and call ids; nothing recorded while tracing is off; the spans
in a profiler's Chrome trace on its clock; the host-sync and route
counters of public calls; the kernel modules' launch counts as summary()
reports them; trace()'s summary.json; the cap on raw records. CPU only:
the kernels' plain versions run, and nothing is launched."""

import json
import time

import numpy as np
import pytest
import torch

import glu_tpu_torch as glu
from glu_tpu_torch.ops import _cuda_reduce, _cuda_scan, _cuda_sort
from glu_tpu_torch.utils import timing


@pytest.fixture(autouse=True)
def store():
    timing.reset()
    yield
    timing.disable()
    timing.reset()


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    return glu.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint32), "cpu")


def _syncs(counters):
    return sum(v for k, v in counters.items() if k.startswith("host_syncs."))


def test_spans_nest_with_self_time_and_one_call_id():
    timing.enable()
    with timing.span("outer"):
        time.sleep(0.002)
        for _ in range(2):  # the two forms of a span
            with timing.span("inner"):
                time.sleep(0.003)
            opened = timing.start("inner")
            try:
                time.sleep(0.003)
            finally:
                timing.stop(opened)
    with timing.span("outer"):
        pass
    timing.disable()
    assert timing.start("off") is None and timing.span("off").__enter__() is None
    rec = timing.records()
    assert [r.name for r in rec] == ["outer"] + ["inner"] * 4 + ["outer"]
    assert [r.parent for r in rec] == [-1, 0, 0, 0, 0, -1]
    assert len({r.call for r in rec[:5]}) == 1 and rec[0].call != rec[5].call
    assert all(r.start_ns <= r.end_ns for r in rec)
    assert rec[0].start_ns <= rec[1].start_ns and rec[4].end_ns <= rec[0].end_ns
    spans = timing.summary()["spans"]
    assert spans["outer"]["count"] == 2 and spans["inner"]["count"] == 4
    assert spans["inner"]["self_us"] == spans["inner"]["total_us"] >= 12000
    inner_us = sum(r.end_ns - r.start_ns for r in rec[1:5]) / 1e3
    assert spans["outer"]["self_us"] == pytest.approx(spans["outer"]["total_us"] - inner_us)
    assert spans["outer"]["self_us"] >= 2000


def test_a_public_call_opens_one_call_id_for_the_spans_under_it():
    timing.enable()
    glu.radix_argsort(_keys(3000))  # argsort calls radix_sort: one call, nested
    glu.radix_sort(_keys(100), _keys(100, 1))
    rec = timing.records()
    assert [r.name for r in rec] == ["glu.radix_argsort", "glu.radix_sort", "glu.route", "glu.engine.k3",
                                     "glu.radix_sort", "glu.route", "glu.engine.k3"]
    assert [r.parent for r in rec] == [-1, 0, 1, 1, -1, 4, 4]
    assert len({r.call for r in rec[:4]}) == 1 and len({r.call for r in rec[4:]}) == 1
    assert rec[0].call != rec[4].call
    spans = timing.summary()["spans"]
    total = spans["glu.radix_sort"]["total_us"]
    parts = spans["glu.radix_sort"]["self_us"] + spans["glu.route"]["total_us"] + spans["glu.engine.k3"]["total_us"]
    assert parts == pytest.approx(total)


def test_nothing_is_recorded_while_tracing_is_off():
    k = _keys(5000)
    glu.radix_sort(k, k, bits="auto")
    glu.exclusive_scan(k)
    glu.reduce(k)
    out = timing.summary()
    assert timing.records() == [] and out["spans"] == {}
    # counters are always on
    assert out["counters"]["route.sort.cuda"] == 1 and out["counters"]["route.reduce.cuda"] == 1
    assert out["counters"]["host_syncs.bits_auto"] == 1


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_profiled_spans_stand_in_the_chrome_trace_on_its_clock(tmp_path):
    k, v = _keys(2000), _keys(2000, 1)
    _profiled(lambda: glu.radix_sort(k, v))  # the profiler's first run in this process sets itself up
    timing.reset()

    def calls():
        glu.radix_sort(k, v)
        glu.exclusive_scan(k)
        glu.radix_sort_keys(k)

    prof = _profiled(calls)
    rec = timing.records()
    assert [r.name for r in rec] == ["glu.radix_sort", "glu.route", "glu.engine.k3", "glu.exclusive_scan",
                                     "glu.engine.k4", "glu.radix_sort_keys", "glu.route", "glu.engine.k3"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = sorted((e for e in trace["traceEvents"] if e.get("name", "").startswith("glu.") and e.get("ph") == "X"),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in events] == [r.name for r in rec]
    assert all(e["cat"] == "cpu_op" for e in events)
    for e, r in zip(events, rec):
        start_ns = trace["baseTimeNanoseconds"] + 1000 * e["ts"]
        assert abs(start_ns - r.start_ns) < 100_000, (r.name, start_ns - r.start_ns)
    # a call that raises under the profiler closes its span; off again once
    # the profiler has stopped
    with pytest.raises(glu.GluError):
        _profiled(lambda: glu.radix_sort(k, v.view(torch.int32)))
    assert [r.name for r in timing.records()[len(rec):]] == ["glu.radix_sort"]
    assert timing.records()[-1].end_ns is not None
    glu.radix_sort(k, v)
    assert len(timing.records()) == len(rec) + 1


@pytest.mark.parametrize("call, syncs", [
    pytest.param(lambda k: glu.radix_sort(k, k), 0, id="radix_sort"),
    pytest.param(lambda k: glu.radix_sort(k[:100], k[:100]), 0, id="radix_sort_k3"),
    pytest.param(lambda k: glu.radix_sort(k, k, bits="auto"), 1, id="radix_sort_bits_auto"),
    pytest.param(lambda k: glu.radix_sort_keys(k, bits="auto"), 1, id="radix_sort_keys_bits_auto"),
    pytest.param(lambda k: glu.radix_sort_u64_parts(k, k, k, bits="auto"), 2, id="u64_parts_bits_auto"),
    pytest.param(lambda k: glu.varying_key_bits(k), 1, id="varying_key_bits"),
    # boundaries and keys on the host: nothing crosses to a card
    pytest.param(lambda k: glu.radix_sort_segmented(k, k, offsets=[0, 10, 10, k.shape[0]]), 0, id="segmented"),
    # two boolean masks' selections
    pytest.param(lambda k: glu.exclusive_scan(k, offsets=torch.tensor([0, 7, k.shape[0]])), 2, id="scan_offsets"),
    pytest.param(lambda k: glu.exclusive_scan(k, op=glu.ReduceOperator.MAX, offsets=[0, 7, k.shape[0]]), 1,
                 id="scan_offsets_max"),
    pytest.param(lambda k: glu.segmented_reduce(k, [0, 7, k.shape[0]], glu.ReduceOperator.MIN), 1,
                 id="segmented_reduce_min"),
    pytest.param(lambda k: glu.reduce(k), 0, id="reduce"),
])
def test_host_syncs_of_a_public_call(call, syncs):
    call(_keys(70000))
    assert _syncs(timing.summary()["counters"]) == syncs


def test_route_counters_and_spans_of_every_router():
    k = _keys(1000)
    timing.enable()
    glu.radix_sort(k, k)
    glu.radix_sort_u64_parts(k, k, k, backend="torch")
    glu.radix_sort_segmented(k, k, 4)
    glu.reduce(k)
    out = timing.summary()
    assert {name: n for name, n in out["counters"].items() if name.startswith("route.")} == {
        "route.sort.cuda": 1, "route.u64.torch": 1, "route.segmented.cuda": 1, "route.reduce.cuda": 1}
    assert out["spans"]["glu.route"]["count"] == 4
    assert out["spans"]["glu.engine.k5"]["count"] == 1


def test_launch_counts_read_as_they_were_and_in_summary(monkeypatch):
    assert list(_cuda_sort.launch_counts()) == ["digit_histograms", "onesweep_pass", "sort_single_tile"]
    assert list(_cuda_scan.launch_counts()) == ["exclusive_scan"]
    assert list(_cuda_reduce.launch_counts()) == ["reduce"]
    monkeypatch.setattr(_cuda_sort, "sort_single_tile_launches", 7)
    monkeypatch.setattr(_cuda_reduce, "reduce_launches", 3)
    counters = timing.summary()["counters"]
    assert counters["launches.sort_single_tile"] == 7 == _cuda_sort.launch_counts()["sort_single_tile"]
    assert counters["launches.reduce"] == 3 and counters["launches.exclusive_scan"] == 0
    timing.reset()  # the store's reset clears the launch counts too
    assert _cuda_sort.launch_counts()["sort_single_tile"] == 0 == _cuda_reduce.launch_counts()["reduce"]


def test_the_3cta_pass_counter_is_listed_from_0_and_stays_there_on_the_cpu():
    assert timing.summary()["counters"]["sort.onesweep_passes_3cta"] == 0
    k = _keys(2 * _cuda_sort.TILE + 5).view(torch.int32)
    out, _ = _cuda_sort.onesweep_sort(k, [k], tuple(range(32)))  # the plain versions: nothing launched
    assert torch.equal(out, k[torch.sort(k.view(torch.uint32).to(torch.int64), stable=True).indices])
    counters = timing.summary()["counters"]
    assert counters["sort.onesweep_passes_3cta"] == 0 and counters["launches.onesweep_pass"] == 0


def test_trace_writes_the_spans_gained_inside_to_summary_json(tmp_path):
    k = _keys(4000)
    glu.radix_sort(k, k)  # outside: counted, not traced
    with timing.trace(str(tmp_path)):
        glu.radix_sort(k, k)
        glu.radix_sort(k, k, bits="auto")
    gained = json.loads((tmp_path / "summary.json").read_text())
    assert gained["spans"]["glu.radix_sort"]["count"] == 2 and gained["spans"]["glu.bits_auto"]["count"] == 1
    assert gained["counters"] == {"host_syncs.bits_auto": 1, "route.sort.cuda": 2}
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert sum(e.get("name") == "glu.radix_sort" for e in events) == 2


def test_records_past_the_cap_are_dropped_and_still_counted(monkeypatch):
    monkeypatch.setattr(timing, "MAX_RECORDS", 4)
    k = _keys(500)
    timing.enable()
    for _ in range(3):
        glu.radix_sort(k, k)
    out = timing.summary()
    assert len(timing.records()) == 4 and out["dropped"] == 5
    assert out["spans"]["glu.radix_sort"]["count"] == 3 and out["spans"]["glu.route"]["count"] == 3
