"""Operator layer of the port (counterpart of glu_tpu/ops).

Ported so far: the u32 key/value radix sort, as a function (`radix_sort`)
and as the reference-shaped class (`RadixSort`), with two backends: "cuda"
(the hand-written Hopper kernels; their plain torch versions on a CPU
tensor) and "torch" (one stable torch.sort).
"""

from .radix_sort import RadixSort, radix_sort
