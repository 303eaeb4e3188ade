"""dist_sort_pairs_per_s: global pairs sorted over the slowest rank's
window, host clock; every rank runs the same steps."""


def read(run):
    return run.work / run.window_s
