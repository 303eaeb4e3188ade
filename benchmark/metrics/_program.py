"""What the program records of itself, for the readers of its spans: the
span totals of its own store (glu_tpu_torch.utils.timing.summary()) and the
idle gaps of a trace that fall under its spans. In a `--trace 1` run the
program records spans only inside the profiled steps (a public call under
a profiler turns them on), so its store holds those steps alone. A program
whose timing module keeps no store reads nothing."""

PREFIX = "host: glu."  # devtrace's label of a gap whose innermost host event is one of the program's spans
CALL = "glu.radix_sort"


def _timing():
    from glu_tpu_torch.utils import timing

    return timing if hasattr(timing, "summary") else None


def per_call(name: str, field: str):
    """The span `name`'s `field` ("total_us" or "self_us") over its calls,
    divided by the radix_sort calls recorded; 0 for a span that never
    opened, None where no radix_sort call was recorded."""
    timing = _timing()
    if timing is None:
        return None
    spans = timing.summary()["spans"]
    calls = spans.get(CALL, {}).get("count", 0)
    if not calls:
        return None
    return spans.get(name, {}).get(field, 0.0) / calls


def idle_pct(run):
    """The share of the traced window in which the card idled while the
    innermost host event was one of the program's spans, the highest over
    the ranks; None where no trace holds a device operation."""
    if _timing() is None:
        return None
    traces = [t for t in run.traces or [] if t.device_ops]
    if not traces:
        return None
    return max(100.0 * sum(us for label, us in t.gaps if label.startswith(PREFIX)) / t.window_us for t in traces)
