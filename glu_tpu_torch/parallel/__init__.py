"""Multi-process layer of the port (counterpart of glu_tpu/parallel).

The sort, reduce and scans over a torch.distributed process group in place
of the JAX mesh: each rank passes its own equal-length shard. The sort is
the sampled-splitter pipeline of dist_sort.py (splitters from gathered
samples, a stable bucket partition on the radix engine, one
all_to_all_single a stream with uneven split sizes, the stable local
sort); reduce and scan fold the D local results (dist_primitives.py). A
group serves the device type of its backend: NCCL serves CUDA tensors,
gloo CPU tensors.
"""

from .dist_primitives import (
    distributed_exclusive_scan,
    distributed_inclusive_scan,
    distributed_reduce,
)
from .dist_sort import (
    distributed_radix_sort,
    distributed_radix_sort_f32,
    distributed_radix_sort_i32,
    distributed_radix_sort_u64,
    distributed_radix_sort_u64_parts,
    make_sort_mesh,
)

__all__ = [
    "distributed_exclusive_scan",
    "distributed_inclusive_scan",
    "distributed_reduce",
    "distributed_radix_sort",
    "distributed_radix_sort_f32",
    "distributed_radix_sort_i32",
    "distributed_radix_sort_u64",
    "distributed_radix_sort_u64_parts",
    "make_sort_mesh",
]
