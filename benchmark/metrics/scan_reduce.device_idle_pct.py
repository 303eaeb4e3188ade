"""The share of the traced window in which no device kernel, memcpy or
memset ran: the highest over the ranks."""

from benchmark.metrics_common import idle_pct


def read(run):
    return idle_pct(run)
