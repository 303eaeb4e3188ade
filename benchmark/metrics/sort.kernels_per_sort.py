"""sort.kernels_per_sort: device kernels launched in the traced window over
the sorts in it (memcpys and memsets are not kernels)."""


def read(run):
    trace = run.traces[0]
    if not trace.device_ops:
        return None
    return trace.count(("kernel",)) / len(trace.calls_us)
