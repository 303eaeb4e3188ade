"""Operator layer of the port (counterpart of glu_tpu/ops).

Ported so far: the u32 key/value radix sort (`radix_sort`, `RadixSort`),
the reduce (`reduce`, `segmented_reduce`, `Reduce`) and the scan
(`exclusive_scan`, `inclusive_scan`, `BlellochScan`), each with two
backends: "cuda" (the hand-written Hopper kernels; their plain torch
versions on a CPU tensor) and "torch" (torch's own sort, scans and
reductions).
"""

from .radix_sort import RadixSort, radix_sort
from .reduce import Reduce, ReduceOperator, reduce, segmented_reduce
from .scan import BlellochScan, exclusive_scan, inclusive_scan
