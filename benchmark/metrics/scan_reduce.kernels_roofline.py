"""scan_reduce.kernels_roofline: a step's bound (12 bytes an element over
the peak bandwidth) over the device's busy time a step in the traced
window."""

from benchmark import roofline


def read(run):
    trace = run.traces[0]
    if not trace.device_ops:
        return None
    per_step_s = trace.busy_us / 1e6 / len(trace.calls_us)
    return 100.0 * roofline.bound_s(roofline.SCAN_REDUCE_BYTES * run.work_per_step) / per_step_s
