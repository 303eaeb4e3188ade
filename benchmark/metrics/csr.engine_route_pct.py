"""csr.engine_route_pct: the share of the u64 sorts that the router sent to
the engine, from the program's counters route.u64.cuda and route.u64.torch
(every build of the process; a counter the program does not list counts
0); nothing where neither counted."""

from benchmark import plugins


def read(run):
    timing = plugins.load("metrics", "_program")._timing()
    if timing is None:
        return None
    counters = timing.summary()["counters"]
    cuda, torch_ = counters.get("route.u64.cuda", 0), counters.get("route.u64.torch", 0)
    if not cuda + torch_:
        return None
    return 100.0 * cuda / (cuda + torch_)
