"""dist_sort.exchange_share_pct: the all-to-all exchange's device time (NCCL's
SendRecv kernels, which all_to_all_single runs) as a share of the traced
window, on the slowest rank (the one whose device work outside NCCL takes
longest). The small gathers (samples, counts) are left out: their kernels
spin while a peer is late, and dist_sort.gather_wait_pct reads them."""

EXCHANGE, NCCL = "SendRecv", "nccl"


def read(run):
    traces = [t for t in run.traces if t.device_ops]
    if not traces:
        return None
    slowest = max(traces, key=lambda t: t.busy_us - t.device_us(("kernel",), NCCL))
    return 100.0 * slowest.device_us(("kernel",), EXCHANGE) / slowest.window_us
