"""small_sort.launch_us: the launch's host time a radix_sort call (the
glu.launch spans: the stream's handle and the ctypes call into the kernel
library), the mean over the profiled steps, from the program's own store;
0 on the CPU, where nothing is launched."""

from benchmark import plugins


def read(run):
    return plugins.load("metrics", "_program").per_call("glu.launch", "total_us")
