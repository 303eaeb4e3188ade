"""sort_pairs_per_s: pairs sorted in the window over the window's seconds
(the window closed by a synchronize, so the drain counts), host clock."""


def read(run):
    return run.work / run.window_s
