"""small_sort.router_us: the router's host time a radix_sort call (its
glu.route spans: the cost model's estimate and the decision), the mean over
the profiled steps, from the program's own store."""

from benchmark import plugins


def read(run):
    return plugins.load("metrics", "_program").per_call("glu.route", "total_us")
