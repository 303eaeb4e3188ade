"""small_sort.engine_host_us: K3's wrapper on the host a radix_sort call
(the self time of glu.engine.k3: its checks, plan and allocations, without
the launch), the mean over the profiled steps, from the program's own
store. On the CPU it holds K3's plain version too."""

from benchmark import plugins


def read(run):
    return plugins.load("metrics", "_program").per_call("glu.engine.k3", "self_us")
