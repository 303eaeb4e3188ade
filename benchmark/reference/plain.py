"""The plain reference that decides `correct`: plain torch, no kernel and
nothing of the program under test.

u32 tensors are read through int32 views (torch's uint32 supports few
operations). A stable sort is a sort of unique int64 words, the key's u32
value above the input position, so no sort's stability is relied on. Sums
are taken in int64 and wrapped to 32 bits.

The controls stand in the program's place and break one guarantee that the
configurations state: `sort_pairs(..., drop_bits=8)` orders by the top 24
key bits only (one 8-bit pass of four left out), and the float32 scan and
sum give up exact u32 sums.
"""

from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF
_POS_BITS = 31  # input positions below 2^31: sorts of up to 2^31 elements


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint32)


def stable_order(keys: torch.Tensor, drop_bits: int = 0) -> torch.Tensor:
    """int64 positions that sort `keys` (u32) stably by key >> drop_bits."""
    n = keys.shape[0]
    if n >= 1 << _POS_BITS:
        raise ValueError(f"{n} keys: the reference sorts fewer than 2^{_POS_BITS}")
    wide = keys.view(torch.int32).to(torch.int64) & _LOW32
    if drop_bits:
        wide >>= drop_bits
    wide <<= _POS_BITS
    wide |= torch.arange(n, dtype=torch.int64, device=keys.device)
    words = torch.sort(wide).values
    del wide
    words &= (1 << _POS_BITS) - 1
    return words


def sort_pairs(keys: torch.Tensor, values: torch.Tensor, drop_bits: int = 0):
    """(keys, values) stably sorted by key (u32 in, u32 out)."""
    order = stable_order(keys, drop_bits)
    return _u32(keys.view(torch.int32)[order]), _u32(values.view(torch.int32)[order])


def exclusive_sum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of u32 x, wrapped modulo 2^32."""
    inc = torch.cumsum(x.view(torch.int32).to(torch.int64) & _LOW32, 0)
    exc = (inc - (x.view(torch.int32).to(torch.int64) & _LOW32)) & _LOW32
    return _u32(exc.to(torch.int32))


def total(x: torch.Tensor) -> torch.Tensor:
    """Sum of u32 x wrapped modulo 2^32, a 0-d u32 tensor."""
    s = int(torch.sum(x.view(torch.int32).to(torch.int64) & _LOW32)) & _LOW32
    return _u32(torch.tensor(s - (1 << 32) if s >= 1 << 31 else s, dtype=torch.int32, device=x.device))


def exclusive_sum_float32(x: torch.Tensor) -> torch.Tensor:
    """The control of exclusive_sum: accumulated in float32."""
    f = x.view(torch.int32).to(torch.int64).to(torch.float32)
    exc = torch.cumsum(f, 0) - f
    return _u32((exc.to(torch.int64) & _LOW32).to(torch.int32))


def total_float32(x: torch.Tensor) -> torch.Tensor:
    """The control of total: accumulated in float32."""
    s = int(torch.sum(x.view(torch.int32).to(torch.float32)).to(torch.int64)) & _LOW32
    return _u32(torch.tensor(s - (1 << 32) if s >= 1 << 31 else s, dtype=torch.int32, device=x.device))


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of `got` that differ from `want`, bit for bit; a length
    difference counts each missing or extra element."""
    g, w = got.reshape(-1).view(torch.int32), want.reshape(-1).view(torch.int32)
    m = min(g.shape[0], w.shape[0])
    return abs(g.shape[0] - w.shape[0]) + int((g[:m] != w[:m]).sum())
