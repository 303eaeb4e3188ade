"""small_sort_p95_ms: the 95th percentile over every call of the window,
each timed on the host clock from the call until its synchronize returns."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3
