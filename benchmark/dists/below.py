"""u32 values uniform below `high`."""

import torch


def make(spec, n, start, gen, device):
    return torch.randint(0, spec["high"], (n,), dtype=torch.int32, generator=gen, device=device).view(torch.uint32)
