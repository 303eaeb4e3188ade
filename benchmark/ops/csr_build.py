"""One step: Graph 500's kernel 1 on the port, the compressed sparse rows
of a weighted edge list as GPU graph loaders build them: one stable sort of
(src, dst) carrying the weight through `glu_tpu_torch.radix_sort_u64_parts`
on the id bits of both words (default routing), the degrees by
`torch.bincount` of the sources, and the row starts by
`glu_tpu_torch.exclusive_scan` of the degrees. The sorted sources are
dropped at once. Returns (row starts, int32; columns, u32; weights, u32);
the last row ends at the edge count.

The edges come from the traffic's `edges` distribution (the Kronecker
generator: n edges, n / edgefactor vertices), the weights uniform in
[0, 1) as float32 words. The check: all three outputs, bit for bit,
against benchmark/reference/graph500.py."""

import torch

from benchmark import workload
from benchmark.reference import graph500, plain


class Op:
    limits = {"col_mismatches": 0, "weight_mismatches": 0, "offset_mismatches": 0}

    def __init__(self, traffic: dict, rank: int, world: int):
        self.traffic = traffic
        self.edgefactor = traffic["edges"]["edgefactor"]

    def make(self, seed: int, entry: int, n: int, device) -> tuple:
        gen = workload.generator(device, seed, 0, entry)
        edges = workload.make(self.traffic["edges"], n, gen, device)
        weights = torch.rand(n, generator=gen, device=device).view(torch.uint32)
        return edges[0], edges[1], weights

    def call(self, inputs: tuple) -> tuple:
        import glu_tpu_torch as glu

        src, dst, weights = inputs
        vertices = src.shape[0] // self.edgefactor
        ids = tuple(range(vertices.bit_length() - 1))
        columns, weights = glu.radix_sort_u64_parts(src, dst, weights, bits=(ids, ids))[1:]
        degrees = torch.bincount(src.view(torch.int32), minlength=vertices).to(torch.int32)
        return glu.exclusive_scan(degrees), columns, weights

    def reference(self, seed: int, entry: int, inputs: tuple) -> tuple:
        return graph500.csr(*inputs, inputs[0].shape[0] // self.edgefactor)

    def control(self, seed: int, entry: int, inputs: tuple) -> tuple:
        """Rows by the source alone: each row's neighbours in input order."""
        return graph500.csr(*inputs, inputs[0].shape[0] // self.edgefactor, by_dst=False)

    def check(self, outputs: tuple, ref: tuple) -> dict:
        return {"offset_mismatches": plain.mismatches(outputs[0], ref[0]),
                "col_mismatches": plain.mismatches(outputs[1], ref[1]),
                "weight_mismatches": plain.mismatches(outputs[2], ref[2])}
