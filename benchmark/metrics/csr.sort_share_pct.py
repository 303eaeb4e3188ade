"""csr.sort_share_pct: the device time of the sort engine's kernels (the
onesweep passes and the digit histograms) over the device's busy time in
the traced window."""

ENGINE = r"onesweep_pass_kernel|digit_histograms_kernel"


def read(run):
    trace = run.traces[0]
    if not trace.device_ops:
        return None
    return 100.0 * trace.device_us(("kernel",), ENGINE) / trace.busy_us
