"""u32 words, each of the 2^32 values alike."""

import torch

from benchmark import workload


def make(spec, n, start, gen, device):
    return workload.words(n, gen, device).view(torch.uint32)
