"""The table of peaks and the bytes each primitive needs, whatever
implements it: every input byte read once and every output byte written
once."""

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA's data sheet), at a 700 W limit

# bytes an element
SORT_PAIR_BYTES = 16  # a u32 key and a u32 value read, and both written
SCAN_REDUCE_BYTES = 12  # the scan's u32 read and written, and the reduce's u32 read


def bound_s(nbytes: float) -> float:
    """The least time the card can move nbytes in."""
    return nbytes / HBM_BYTES_PER_S
