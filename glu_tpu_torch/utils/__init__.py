"""Runtime utility layer of the port (counterpart of glu_tpu/utils)."""

from .errors import GluError, check_argument, check_state, fail
from .dtypes import DataType, check_dtype_supported, dtype_info, to_torch_dtype, to_type_str
from .math import (
    div_ceil,
    is_power_of_2,
    log2_ceil,
    log2_floor,
    log32_ceil,
    log32_floor,
    next_power_of_2,
)
from .buffers import DeviceBuffer, copy_buffer, default_device, from_numpy, to_numpy
from .timing import measure_elapsed_time
from .debug import print_buffer, print_buffer_hex, print_container
