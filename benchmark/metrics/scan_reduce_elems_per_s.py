"""scan_reduce_elems_per_s: elements through one exclusive_scan and one
reduce each step, over the window's seconds, host clock."""


def read(run):
    return run.work / run.window_s
