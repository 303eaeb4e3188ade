"""The metric arithmetic on synthetic profiler events and runs: the idle
share, the roofline shares, counts and the p95 over all samples."""

import numpy as np
import pytest

from benchmark import devtrace, harness, roofline


def _events():
    """A 1,000 us window: a kernel 100-400, a memset 350-450 (overlapping),
    a kernel 600-900, an NCCL kernel 900-950; two calls; host ops."""
    base = 5000.0

    def x(name, cat, start, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": base + start, "dur": dur}

    return [
        x(devtrace.WINDOW, "user_annotation", 0, 1000),
        x(devtrace.WINDOW, "gpu_user_annotation", 0, 1000),
        x(devtrace.CALL, "user_annotation", 10, 80),
        x(devtrace.CALL, "user_annotation", 460, 120),
        x("cudaLaunchKernel", "cuda_runtime", 20, 5),
        x("aten::empty", "cpu_op", 470, 90),
        x("void onesweep_pass_kernel<1>(int*)", "kernel", 100, 300),
        x("Memset (Device)", "gpu_memset", 350, 100),
        x("void scan_onepass_kernel<0, unsigned int, 4>(x)", "kernel", 600, 300),
        x("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", "kernel", 900, 50),
        x("kernel outside the window", "kernel", 1200, 100),
    ]


def test_busy_idle_and_gaps():
    t = devtrace.from_events(_events())
    assert t.window_us == 1000
    assert t.busy_us == pytest.approx(350 + 350)  # 100-450 and 600-950
    assert t.idle_pct() == pytest.approx(30.0)
    assert t.count() == 3 and t.calls_us == [80, 120]
    assert t.device_us(("kernel",), "nccl") == 50
    gaps = dict((label, d) for label, d in t.gaps)
    assert sum(d for _, d in t.gaps) == pytest.approx(300)
    assert gaps["host: aten::empty"] == pytest.approx(150)  # 450-600, middle 525
    assert t.gaps[0] == ("host: bench.call (python)", 100)  # 0-100, middle 50


def test_no_device_operation_reads_nothing():
    events = [e for e in _events() if e["cat"] not in devtrace.DEVICE_CATS]
    run = harness.Run({}, {}, traces=[devtrace.from_events(events)], work_per_step=1 << 28)
    for metric in ("sort.kernels_roofline", "sort.kernels_per_sort", "sort.device_idle_pct",
                   "small_sort.kernel_us", "scan_reduce.kernels_roofline", "dist_sort.exchange_share_pct",
                   "dist_sort.gather_wait_pct"):
        assert harness.reader(metric).read(run) is None, metric


def test_roofline_shares_and_counts():
    trace = devtrace.from_events(_events())
    run = harness.Run({}, {}, traces=[trace], work_per_step=1000)
    per_call_s = 700e-6 / 2
    assert harness.reader("sort.kernels_roofline").read(run) == pytest.approx(
        100 * 16 * 1000 / roofline.HBM_BYTES_PER_S / per_call_s)
    assert harness.reader("scan_reduce.kernels_roofline").read(run) == pytest.approx(
        100 * 12 * 1000 / roofline.HBM_BYTES_PER_S / per_call_s)
    assert harness.reader("sort.kernels_per_sort").read(run) == 1.5
    assert harness.reader("small_sort.kernel_us").read(run) == pytest.approx(650 / 2)
    assert harness.reader("sort.device_idle_pct").read(run) == pytest.approx(30.0)


def test_highest_idle_exchange_share_of_the_slowest_rank_and_gather_wait():
    a = devtrace.TraceData(1000.0, [("k", "kernel", 0, 600), ("ncclDevKernel_SendRecv", "kernel", 600, 100),
                                    ("ncclDevKernel_AllGather_RING_LL", "kernel", 700, 20)])
    b = devtrace.TraceData(1000.0, [("k", "kernel", 0, 300), ("ncclDevKernel_SendRecv", "kernel", 300, 500),
                                    ("ncclDevKernel_AllGather_RING_LL", "kernel", 800, 150)])
    run = harness.Run({}, {}, traces=[a, b])
    assert harness.reader("dist_sort.device_idle_pct").read(run) == pytest.approx(28.0)  # a: 720 us busy
    assert harness.reader("dist_sort.exchange_share_pct").read(run) == pytest.approx(10.0)  # a: 600 us of other work
    assert harness.reader("dist_sort.gather_wait_pct").read(run) == pytest.approx(15.0)  # b waited longest


def test_p95_over_every_call_and_rates():
    lat = [0.001] * 94 + [0.002] * 5 + [0.010]
    run = harness.Run({}, {}, latencies_s=lat, host_s=[1e-5, 3e-5], work=3 << 28, window_s=2.0, setup_s=7.5)
    assert harness.reader("small_sort_p95_ms").read(run) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert 1.0 < harness.reader("small_sort_p95_ms").read(run) < 2.0 + 1e-9
    assert harness.reader("small_sort.host_us").read(run) == pytest.approx(20.0)
    for rate in ("sort_pairs_per_s", "scan_reduce_elems_per_s", "dist_sort_pairs_per_s"):
        assert harness.reader(rate).read(run) == (3 << 28) / 2.0
    assert harness.reader("setup_s").read(run) == 7.5


def test_short_kernel_names():
    assert devtrace.short_name("void onesweep_pass_kernel<1>(int*)") == "onesweep_pass_kernel<1>"
    assert devtrace.short_name("void at::native::(anonymous namespace)::f<int>(int)") == "at::native::f<int>"
    assert devtrace.short_name("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)") == "ncclDevKernel_SendRecv"


def test_breakdown_lists_at_most_ten_in_seconds_a_rank():
    ops = [(f"k{i}", "kernel", 10.0 * i, 5.0 + i) for i in range(12)]
    t = devtrace.TraceData(200.0, ops, gaps=[("host: a", 2.0), ("host: b", 4.0), ("host: a", 2.0)])
    out = devtrace.breakdown([t, t])
    assert len(out["device_ops"]) == 10 and out["device_ops"][0] == ["k11", pytest.approx(16e-6)]
    assert out["idle_gaps"] == [["host: a", pytest.approx(4e-6)], ["host: b", pytest.approx(4e-6)]]
