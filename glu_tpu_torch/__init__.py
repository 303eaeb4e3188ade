"""glu_tpu_torch — the port of glu_tpu to PyTorch and hand-written CUDA kernels
for NVIDIA Hopper (H100).

It mirrors glu_tpu's layout and public names. Ported so far: the utility
layer; the stable LSD radix sort of u32 key/value pairs (`radix_sort`,
`RadixSort`), whose engine runs three CUDA kernels (ops/_cuda_sort.py,
csrc/radix_sort.cu); the reduce (`reduce`, `segmented_reduce`, `Reduce`,
kernel K5 in csrc/reduce.cu) and the scan (`exclusive_scan`,
`inclusive_scan`, `BlellochScan`, kernel K4 in csrc/scan.cu). A function
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
from .ops.radix_sort import RadixSort, radix_sort
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
    "Reduce",
    "ReduceOperator",
    "reduce",
    "segmented_reduce",
    "BlellochScan",
    "exclusive_scan",
    "inclusive_scan",
]
