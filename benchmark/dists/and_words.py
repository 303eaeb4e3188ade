"""u32 keys, each the AND of `words` uniform words: CUB's entropy reduction
(a bit is set one time in 2^words; 5 words give entropy 0.201)."""

import torch

from benchmark import workload


def make(spec, n, start, gen, device):
    w = workload.words(n, gen, device)
    for _ in range(spec["words"] - 1):
        w &= workload.words(n, gen, device)
    return w.view(torch.uint32)
