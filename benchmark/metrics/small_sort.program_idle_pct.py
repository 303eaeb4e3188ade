"""small_sort.program_idle_pct: the share of the traced window in which the
card idled while the innermost host event was one of the program's own
spans (glu.*): the idle that the library's host code leaves, by stage."""

from benchmark import plugins


def read(run):
    return plugins.load("metrics", "_program").idle_pct(run)
