"""small_sort.host_us: the mean host time of a radix_sort call, from the
call until it returns (before the synchronize), host clock, over the calls
of the traced run's window outside the profiled sub-window (the profiler
slows the host several times over)."""


def read(run):
    return 1e6 * sum(run.host_s) / len(run.host_s) if run.host_s else None
