"""Edges of the Graph 500 Kronecker generator (the specification's
kronecker_generator.m): n = edgefactor * 2^scale edges, each drawn alone,
one bit of src and one of dst a level for `scale` levels, the pair of bits
(0, 0) with probability a, (0, 1) b, (1, 0) c and (1, 1) 1 - a - b - c;
then the vertex labels permuted and the edges shuffled, both from the
generator. `make` returns a (2, n) u32 tensor: row 0 the sources, row 1 the
destinations, each row contiguous."""

import torch

CHUNK = 1 << 26  # edges drawn at a time, so that a level's draws stay small beside the edge list


def scale_of(spec: dict, n: int) -> int:
    """The scale of n edges: n / edgefactor vertices, a power of 2."""
    v = n // spec["edgefactor"]
    if v * spec["edgefactor"] != n or v < 2 or v & (v - 1):
        raise ValueError(f"{n} edges are not edgefactor {spec['edgefactor']} times a power of 2 vertices")
    return v.bit_length() - 1


def quadrants(spec: dict, n: int, scale: int, gen, device) -> torch.Tensor:
    """(2, n) int32 (src, dst) before the labels are permuted: level l sets
    bit l of src where a draw exceeds a + b, and bit l of dst where a second
    draw exceeds c / (c + d) after a set src bit, a / (a + b) after a clear
    one."""
    ab = spec["a"] + spec["b"]
    c_norm, a_norm = spec["c"] / (1.0 - ab), spec["a"] / ab
    ij = torch.zeros((2, n), dtype=torch.int32, device=device)
    for lo in range(0, n, CHUNK):
        src, dst = ij[0, lo : lo + CHUNK], ij[1, lo : lo + CHUNK]
        for level in range(scale):
            ii = torch.rand(src.shape[0], generator=gen, device=device) > ab
            jj = torch.rand(src.shape[0], generator=gen, device=device) > torch.where(ii, c_norm, a_norm)
            src |= ii.to(torch.int32) << level
            dst |= jj.to(torch.int32) << level
    return ij


def make(spec, n, start, gen, device):
    scale = scale_of(spec, n)
    ij = quadrants(spec, n, scale, gen, device)
    label = torch.randperm(1 << scale, generator=gen, device=device).to(torch.int32)
    for row in ij:
        for lo in range(0, n, CHUNK):
            part = row[lo : lo + CHUNK]
            part.copy_(torch.index_select(label, 0, part))
    del label
    order = torch.randperm(n, generator=gen, device=device, dtype=torch.int32)  # half an int64 one's memory
    return torch.index_select(ij, 1, order).view(torch.uint32)
