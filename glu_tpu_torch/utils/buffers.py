"""Device buffers and the numpy bridge (counterpart of glu_tpu/utils/buffers.py).

`from_numpy` / `to_numpy` carry arrays between the host and the port: a u32
numpy array (what `np.asarray(jax_array)` gives) becomes a `torch.uint32`
tensor on the requested device and comes back as u32. The tests feed the JAX
package and the port identical inputs through them.

Where a function makes a tensor and is given no device, the tensor goes to
the card (`default_device()`); without one it raises rather than falling
back to the CPU. Work on the CPU is asked for with `device="cpu"`.

torch implements little arithmetic for `uint32`, so every copy and fill here
works on the tensor's int32 view (`_words`): the bits are the same.

`DeviceBuffer` is the reference's ShaderStorageBuffer (gl_utils.hpp:146-246)
over a torch tensor. Unlike the JAX handle, which swaps immutable arrays, it
writes into its tensor in place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .errors import check_argument, check_state


def default_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the card, torch.device("cuda").
    Raises when None is given and no CUDA device is available."""
    if device is not None:
        return torch.device(device)
    check_state(
        torch.cuda.is_available(),
        "no CUDA device is available: pass device='cpu' to work on the CPU",
    )
    return torch.device("cuda")


def _words(t: torch.Tensor) -> torch.Tensor:
    """The same storage, viewed as int32 when it holds u32 words."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """Copy a numpy array to a new tensor on `device`, by default the card
    (u32 stays u32)."""
    device = default_device(device)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device, copy=True).view(torch.uint32)
    return torch.from_numpy(a).to(device, copy=True)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Copy a tensor to a new host numpy array (u32 stays u32)."""
    host = _words(t.detach()).cpu().numpy().copy()
    return host.view(np.uint32) if t.dtype == torch.uint32 else host


def _zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    _words(out).zero_()
    return out


def _resized(data: torch.Tensor, size: int) -> torch.Tensor:
    if size <= data.shape[0]:
        return data[:size]
    out = _zeros((size,) + tuple(data.shape[1:]), data.dtype, data.device)
    _words(out[: data.shape[0]]).copy_(_words(data))
    return out


def copy_buffer(src: torch.Tensor, dst_size: Optional[int] = None) -> torch.Tensor:
    """Device-device copy (reference gl_utils.hpp:13-22). Optionally resizes,
    padding with zeros."""
    out = _words(src).clone().view(src.dtype)
    if dst_size is not None and dst_size != src.shape[0]:
        out = _resized(out, dst_size)
    return out


class DeviceBuffer:
    """A growable device tensor handle (reference ShaderStorageBuffer,
    gl_utils.hpp:146-246).

    size/resize/clear/write_data/get_data mirror the SSBO surface; `data`
    exposes the current tensor for use with the functional ops. `init` may be
    a numpy array (copied to `device`, by default the card) or a tensor (kept
    as it is, unless `device` is given); `size=` makes zeros on `device`, by
    default the card.
    """

    def __init__(self, init=None, *, size: int = 0, dtype=torch.uint32, device=None):
        if init is None:
            self._data = _zeros((size,), dtype, default_device(device))
        elif isinstance(init, torch.Tensor):
            self._data = init if device is None else init.to(device)
        else:
            self._data = from_numpy(np.asarray(init), device)

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @data.setter
    def data(self, value: torch.Tensor) -> None:
        self._data = value

    @property
    def size(self) -> int:
        """Element count (the reference tracks bytes; elements are the natural
        unit for typed tensors)."""
        return int(self._data.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def device(self) -> torch.device:
        return self._data.device

    def resize(self, size: int, keep_data: bool = False) -> None:
        """Grow/shrink, optionally preserving contents
        (reference gl_utils.hpp:194-212)."""
        check_argument(size >= 0, "Invalid size: %d", size)
        if size == self.size:
            return
        if keep_data:
            self._data = _resized(self._data, size)
        else:
            self._data = _zeros((size,) + tuple(self._data.shape[1:]), self.dtype, self.device)

    def clear(self, value=0) -> None:
        """Fill with a constant (reference gl_utils.hpp:215-219, which clears
        via GL_R32UI fill)."""
        if self.dtype == torch.uint32:
            value = int(np.uint32(value).view(np.int32))
        _words(self._data).fill_(value)

    def write_data(self, host_data) -> None:
        """Upload host data starting at offset 0 (reference gl_utils.hpp:222-227)."""
        arr = np.asarray(host_data).astype(_numpy_dtype(self.dtype), copy=False)
        check_argument(
            arr.shape[0] <= self.size,
            "write of %d elements exceeds buffer size %d",
            arr.shape[0],
            self.size,
        )
        _words(self._data[: arr.shape[0]]).copy_(_words(from_numpy(arr, self.device)))

    def get_data(self, count: Optional[int] = None) -> np.ndarray:
        """Read back to host (reference gl_utils.hpp:230-238)."""
        return to_numpy(self._data if count is None else self._data[:count])
