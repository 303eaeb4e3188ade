"""Golden reference of the sort in plain torch (counterpart of
glu_tpu/ops/reference.py): the simplest correct expression of the contract,
independent of the engine's code."""

from __future__ import annotations

import torch


def ref_radix_sort(keys: torch.Tensor, values: torch.Tensor, num_steps: int = 0):
    """Stable sort of u32 (key, value) pairs by the low 4*num_steps key bits.

    num_steps=0 means a full 8-pass sort (reference glu/RadixSort.hpp:289,332).
    A partial sort's observable state equals a stable sort by the masked low
    bits: LSD passes never look at higher bits. The sort key is widened to
    int64, where u32 order is plain integer order.
    """
    steps = 8 if num_steps in (0, None) else min(int(num_steps), 8)
    if steps == 0:
        return keys, values
    k, v = keys.view(torch.int32), values.view(torch.int32)
    wide = k.to(torch.int64) & ((1 << (4 * steps)) - 1)
    order = torch.sort(wide, stable=True).indices
    return k[order].view(torch.uint32), v[order].view(torch.uint32)
