"""Arithmetic that several metric readers share."""


def idle_pct(run):
    """The highest idle share of the traced window over the ranks; None
    where no rank's trace holds a device operation."""
    shares = [t.idle_pct() for t in run.traces]
    shares = [s for s in shares if s is not None]
    return max(shares) if shares else None
