"""The readers of what the program records of itself (metrics/_program.py):
the small sort's four host times a call from the program's spans, on a CPU
rehearsal of its cell; the idle share under the program's spans on that
rehearsal, on the four-card cell's rehearsal and on hand-made traces; and
nothing, without raising, from a program whose timing module keeps no
store."""

import pytest

from benchmark import devtrace, harness
from benchmark.tests import cells

SMALL, DIST = "u32_small_1card.sort_closed", "u32_2p30_4card.dist_sort_skew"
HOST_US = ("small_sort.router_us", "small_sort.api_self_us", "small_sort.engine_host_us", "small_sort.launch_us")


@pytest.fixture
def timing():
    from glu_tpu_torch.utils import timing

    timing.reset()
    yield timing
    timing.reset()


def test_the_small_sorts_host_times_add_up_to_the_call(timing):
    result = cells.run(SMALL, trace=True)
    assert result["correct"]
    got = {m: result["metrics"][m]["value"] for m in HOST_US}
    spans = timing.summary()["spans"]
    calls = spans["glu.radix_sort"]["count"]
    assert calls == cells.OVERRIDES[SMALL]["traffic"]["trace_steps"]  # the profiled steps alone
    assert got["small_sort.launch_us"] == 0.0  # nothing is launched on the CPU
    assert min(got["small_sort.router_us"], got["small_sort.api_self_us"], got["small_sort.engine_host_us"]) > 0
    assert sum(got.values()) == pytest.approx(spans["glu.radix_sort"]["total_us"] / calls)
    # the CPU's trace holds no device operation: no idle share
    assert "small_sort.program_idle_pct" not in result["metrics"]


def test_the_four_card_rehearsal_reads_no_idle_share_without_a_device():
    result = cells.run(DIST, trace=True)
    assert result["correct"] and "dist_sort.program_idle_pct" not in result["metrics"]


def _trace(window, gaps, ops=(("k", "kernel", 0.0, 10.0),)):
    return devtrace.TraceData(window, list(ops), gaps=gaps)


def test_idle_under_the_programs_spans_the_highest_over_the_ranks(timing):
    a = _trace(1000.0, [("host: glu.radix_sort", 100.0), ("host: bench.call (python)", 300.0),
                        ("host: glu.engine.k3", 50.0), ("host: aten::empty", 20.0)])
    b = _trace(500.0, [("host: glu.dist.counts", 100.0), ("host: between ops", 100.0)])
    for metric in ("small_sort.program_idle_pct", "dist_sort.program_idle_pct"):
        read = harness.reader(metric).read
        assert read(harness.Run({}, {}, traces=[a])) == pytest.approx(15.0)
        assert read(harness.Run({}, {}, traces=[a, b])) == pytest.approx(20.0)
        assert read(harness.Run({}, {}, traces=[_trace(1000.0, [("host: glu.route", 5.0)], ops=())])) is None


def test_a_program_without_a_store_reads_nothing(timing, monkeypatch):
    monkeypatch.delattr(timing, "summary")
    run = harness.Run({}, {}, traces=[_trace(1000.0, [("host: glu.radix_sort", 100.0)])])
    for metric in HOST_US + ("small_sort.program_idle_pct", "dist_sort.program_idle_pct"):
        assert harness.reader(metric).read(run) is None, metric


def test_no_radix_sort_call_recorded_reads_nothing(timing):
    run = harness.Run({}, {}, traces=[])
    for metric in HOST_US:
        assert harness.reader(metric).read(run) is None, metric
