"""u32 values: each element's global input position, `start` + i."""

import torch


def make(spec, n, start, gen, device):
    return torch.arange(start, start + n, dtype=torch.int32, device=device).view(torch.uint32)
