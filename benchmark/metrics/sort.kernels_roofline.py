"""sort.kernels_roofline: a sort's bound (16 bytes a pair over the peak
bandwidth) over the device's busy time a sort in the traced window."""

from benchmark import roofline


def read(run):
    trace = run.traces[0]
    if not trace.device_ops:
        return None
    per_sort_s = trace.busy_us / 1e6 / len(trace.calls_us)
    return 100.0 * roofline.bound_s(roofline.SORT_PAIR_BYTES * run.work_per_step) / per_sort_s
