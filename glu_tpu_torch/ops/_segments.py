"""Validation of CUB-style segment boundary arrays (counterpart of
glu_tpu/ops/_segments.py:18-36).

The ragged (offsets=) forms of the scan and the reduce take S+1
nondecreasing integer boundaries with offsets[0] == 0 and offsets[-1] == n,
empty segments allowed. Eager torch always has the boundaries' values, so
the contract is always checked, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.errors import check_argument
from ..utils.timing import count


def validate_offsets(offsets, n: int, device) -> tuple[torch.Tensor, int]:
    """Returns (the boundaries as an int64 tensor on `device`, S).
    `offsets` may be a tensor on any device, a numpy array or a list. Each
    crossing between the card and the host waits for the card's stream:
    the boundaries' fetch from a card and their copy onto one."""
    offs = offsets if isinstance(offsets, torch.Tensor) else torch.from_numpy(np.asarray(offsets))
    check_argument(offs.ndim == 1, "offsets must be 1-D")
    check_argument(
        not (offs.dtype.is_floating_point or offs.dtype.is_complex or offs.dtype == torch.bool),
        "offsets must be integers, got %s", offs.dtype,
    )
    num_segments = offs.shape[0] - 1
    check_argument(num_segments >= 1, "offsets needs at least 2 entries")
    h = offs.cpu().to(torch.int64)
    check_argument(int(h[0]) == 0, "offsets[0] must be 0, got %d", int(h[0]))
    check_argument(int(h[-1]) == n, "offsets[-1] (%d) must equal the array length (%d)", int(h[-1]), n)
    check_argument(bool((h[1:] >= h[:-1]).all()), "offsets must be nondecreasing")
    out = h.to(device)
    count("host_syncs.offsets", int(offs.is_cuda) + int(out.is_cuda))
    return out, num_segments
