"""glu_tpu_torch — the port of glu_tpu to PyTorch and hand-written CUDA kernels
for NVIDIA Hopper (H100).

It mirrors glu_tpu's layout and public names. Ported so far: the utility
layer and the stable LSD radix sort of u32 key/value pairs (`radix_sort`,
`RadixSort`), whose engine runs three CUDA kernels (ops/_cuda_sort.py,
csrc/radix_sort.cu). Tensors are the caller's: the device of the input is
the device of the work. The package imports torch and never jax.
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
from .utils.buffers import DeviceBuffer, copy_buffer, from_numpy, to_numpy
from .utils.timing import measure_elapsed_time
from .ops.radix_sort import RadixSort, radix_sort

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
    "from_numpy",
    "to_numpy",
    "measure_elapsed_time",
    "RadixSort",
    "radix_sort",
]
