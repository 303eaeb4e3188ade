"""Operator layer of the port (counterpart of glu_tpu/ops).

Ported so far: the stable LSD radix sort and its variants (`radix_sort`,
`RadixSort`, `radix_sort_keys`, `radix_sort_multi`, `radix_argsort`,
`radix_sort_f32`, `radix_sort_i32`, `radix_sort_u64`,
`radix_sort_u64_parts`, `radix_sort_segmented`, `varying_key_bits`), the
reduce (`reduce`, `segmented_reduce`, `Reduce`) and the scan
(`exclusive_scan`, `inclusive_scan`, `BlellochScan`), each with two
backends: "cuda" (the hand-written Hopper kernels; their plain torch
versions on a CPU tensor) and "torch" (torch's own sort, scans and
reductions), and the router (router.py), which picks one of them for a
sort or reduce of a CUDA tensor given backend=None.
"""

from .radix_sort import (
    RadixSort,
    radix_argsort,
    radix_sort,
    radix_sort_f32,
    radix_sort_i32,
    radix_sort_keys,
    radix_sort_multi,
    radix_sort_segmented,
    radix_sort_u64,
    radix_sort_u64_parts,
    varying_key_bits,
)
from .reduce import Reduce, ReduceOperator, reduce, segmented_reduce
from .scan import BlellochScan, exclusive_scan, inclusive_scan
