"""small_sort.kernel_us: device kernel time a call in the traced window."""


def read(run):
    trace = run.traces[0]
    if not trace.device_ops:
        return None
    return trace.device_us(("kernel",)) / len(trace.calls_us)
