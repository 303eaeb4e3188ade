"""dist_sort.gather_wait_pct: NCCL's AllGather kernels' device time as a
share of the traced window, the largest over the ranks. The distributed
sort's gathers move a few KiB (the samples, each chunk's counts), so their
time is almost all a rank's wait for the slowest: the ranks' imbalance."""

GATHER = "AllGather"


def read(run):
    traces = [t for t in run.traces if t.device_ops]
    if not traces:
        return None
    return max(100.0 * t.device_us(("kernel",), GATHER) / t.window_us for t in traces)
