"""Element type registry (counterpart of glu_tpu/utils/dtypes.py).

The same 12 logical element types as the reference (glu/data_types.hpp:8-44),
each mapped to a torch dtype plus a number of components. Vector types are
tensors with a trailing component axis of size 2 or 4, the layout of the JAX
package. Unlike the TPU, the GPU has f64 ALUs, so DOUBLE and DVEC* need no
special mode.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from .errors import check_argument


class DataType(enum.Enum):
    """The 12 GLU element types (reference glu/data_types.hpp:8-22)."""

    FLOAT = 0
    DOUBLE = 1
    INT = 2
    UINT = 3
    VEC2 = 4
    VEC4 = 5
    DVEC2 = 6
    DVEC4 = 7
    UVEC2 = 8
    UVEC4 = 9
    IVEC2 = 10
    IVEC4 = 11


@dataclass(frozen=True)
class DTypeInfo:
    """Resolved layout of a DataType: base torch dtype + component count."""

    data_type: DataType
    dtype: torch.dtype
    components: int  # 1 for scalars; trailing axis size for vec2/vec4
    name: str

    @property
    def is_vector(self) -> bool:
        return self.components > 1

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize * self.components

    def element_shape(self) -> tuple:
        """Trailing shape of one element: () for scalars, (2,)/(4,) for vectors."""
        return () if self.components == 1 else (self.components,)


_REGISTRY = {
    DataType.FLOAT: ("float", torch.float32, 1),
    DataType.DOUBLE: ("double", torch.float64, 1),
    DataType.INT: ("int", torch.int32, 1),
    DataType.UINT: ("uint", torch.uint32, 1),
    DataType.VEC2: ("vec2", torch.float32, 2),
    DataType.VEC4: ("vec4", torch.float32, 4),
    DataType.DVEC2: ("dvec2", torch.float64, 2),
    DataType.DVEC4: ("dvec4", torch.float64, 4),
    DataType.UVEC2: ("uvec2", torch.uint32, 2),
    DataType.UVEC4: ("uvec4", torch.uint32, 4),
    DataType.IVEC2: ("ivec2", torch.int32, 2),
    DataType.IVEC4: ("ivec4", torch.int32, 4),
}


def dtype_info(data_type: DataType) -> DTypeInfo:
    """Resolve a DataType to its layout info."""
    check_argument(data_type in _REGISTRY, "Invalid data type: %s", data_type)
    name, dt, comps = _REGISTRY[data_type]
    return DTypeInfo(data_type=data_type, dtype=dt, components=comps, name=name)


def to_torch_dtype(data_type: DataType) -> torch.dtype:
    """Base torch dtype for a DataType."""
    return dtype_info(data_type).dtype


def to_type_str(data_type: DataType) -> str:
    """Human name for a DataType (analog of to_glsl_type_str, data_types.hpp:24-44)."""
    return dtype_info(data_type).name


def check_dtype_supported(data_type: DataType) -> DTypeInfo:
    """Resolve a DataType (counterpart of glu_tpu/utils/dtypes.py:107-116).
    The JAX package rejects the f64 types where x64 is off; the GPU has f64
    ALUs, so every DataType is supported here."""
    return dtype_info(data_type)
