"""small_sort.api_self_us: the self time of radix_sort's own span a call
(glu.radix_sort less the router's and the engine's spans inside it: the
public API's checks, views and dispatch), the mean over the profiled steps,
from the program's own store."""

from benchmark import plugins


def read(run):
    return plugins.load("metrics", "_program").per_call("glu.radix_sort", "self_us")
