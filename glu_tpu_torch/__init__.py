"""glu_tpu_torch — the port of glu_tpu to PyTorch and hand-written CUDA kernels
for NVIDIA Hopper (H100).

It mirrors glu_tpu's layout and public names. Ported so far: the utility
layer; the stable LSD radix sort of u32 key/value pairs (`radix_sort`,
`RadixSort`), whose engine runs three CUDA kernels (ops/_cuda_sort.py,
csrc/radix_sort.cu), and its variants on the same engine (keys-only,
multi-payload, argsort, f32/i32/u64 keys, `descending=`, `bits=`,
segmented); the reduce (`reduce`, `segmented_reduce`, `Reduce`,
kernel K5 in csrc/reduce.cu) and the scan (`exclusive_scan`,
`inclusive_scan`, `BlellochScan`, kernel K4 in csrc/scan.cu), and the
router that picks the kernels or torch's call for a sort or reduce given
`backend=None`, by a cost model measured per card (ops/router.py); and the
subpackage `glu_tpu_torch.parallel` (not imported here): the distributed
sort, reduce and scans over a torch.distributed process group; the module
`glu_tpu_torch.entry` (not imported here): the entry points, the
main path's sort and a dry run of the distributed layer; and
`python -m glu_tpu_torch.amalgamate`, which writes the whole package as one
file, dist/glu_tpu_torch_single.py. A function
given a tensor works on the tensor's device; a function that makes a tensor
(`from_numpy`, `DeviceBuffer`, `RadixSort.prepare_internal_buffers`) puts
it on the card unless given `device=`. The package imports torch and never
jax.
"""

from .utils.dtypes import DataType, dtype_info, to_torch_dtype, to_type_str
from .utils.errors import GluError, check_argument, check_state, fail
from .utils.math import (
    div_ceil,
    is_power_of_2,
    log2_ceil,
    log2_floor,
    log32_ceil,
    log32_floor,
    next_power_of_2,
)
from .utils.buffers import DeviceBuffer, copy_buffer, default_device, from_numpy, to_numpy
from .utils.timing import measure_elapsed_time
from .ops.radix_sort import (
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
from .ops.reduce import Reduce, ReduceOperator, reduce, segmented_reduce
from .ops.scan import BlellochScan, exclusive_scan, inclusive_scan

__version__ = "0.1.0"

__all__ = [
    "DataType",
    "dtype_info",
    "to_torch_dtype",
    "to_type_str",
    "GluError",
    "check_argument",
    "check_state",
    "fail",
    "div_ceil",
    "is_power_of_2",
    "log2_ceil",
    "log2_floor",
    "log32_ceil",
    "log32_floor",
    "next_power_of_2",
    "DeviceBuffer",
    "copy_buffer",
    "default_device",
    "from_numpy",
    "to_numpy",
    "measure_elapsed_time",
    "RadixSort",
    "radix_sort",
    "radix_sort_f32",
    "radix_sort_i32",
    "radix_sort_keys",
    "radix_sort_multi",
    "radix_sort_segmented",
    "radix_sort_u64",
    "radix_sort_u64_parts",
    "radix_argsort",
    "varying_key_bits",
    "Reduce",
    "ReduceOperator",
    "reduce",
    "segmented_reduce",
    "BlellochScan",
    "exclusive_scan",
    "inclusive_scan",
]
