"""csr.passes_per_build: the engine's 8-bit passes a two-word sort, from the
program's counters sort.two_word_passes over sort.two_word (every build of
the process); nothing where the program does not list them or chained no
two-word sort on the engine."""

from benchmark import plugins


def read(run):
    timing = plugins.load("metrics", "_program")._timing()
    if timing is None:
        return None
    counters = timing.summary()["counters"]
    if not counters.get("sort.two_word"):
        return None
    return counters["sort.two_word_passes"] / counters["sort.two_word"]
