"""Golden references in plain torch (counterpart of glu_tpu/ops/reference.py):
the simplest correct expression of each op's contract, independent of the
kernels' code. u32 travels as int32 words, where torch's sums wrap mod 2^32
and its order is u32 order after the sign-bit flip."""

from __future__ import annotations

import torch

_SIGN = -(1 << 31)


def ref_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """Reduce along axis 0 with `op` in {sum, mul, min, max} (reference
    glu/Reduce.hpp:42-48): a scalar for (N,), the per-component (C,) for
    (N, C)."""
    u32 = x.dtype == torch.uint32
    w = x.view(torch.int32) if u32 else x
    if op in ("min", "max"):
        w = w ^ _SIGN if u32 else w
        r = torch.amin(w, 0) if op == "min" else torch.amax(w, 0)
        r = r ^ _SIGN if u32 else r
    else:
        r = (torch.sum if op == "sum" else torch.prod)(w, 0, dtype=w.dtype)
    return r.view(torch.uint32) if u32 else r


def ref_exclusive_scan(x: torch.Tensor, num_partitions: int = 1) -> torch.Tensor:
    """Exclusive prefix sum over `num_partitions` adjacent equal partitions
    (reference glu/BlellochScan.hpp:125-138); sums wrap in the dtype."""
    u32 = x.dtype == torch.uint32
    w = x.view(torch.int32) if u32 else x
    seg = w.reshape(num_partitions, -1)
    exc = (torch.cumsum(seg, 1, dtype=w.dtype) - seg).reshape(-1)
    return exc.view(torch.uint32) if u32 else exc


def ref_radix_sort(keys: torch.Tensor, values: torch.Tensor, num_steps: int = 0):
    """Stable sort of u32 (key, value) pairs by the low 4*num_steps key bits.

    num_steps=0 means a full 8-pass sort (reference glu/RadixSort.hpp:289,332).
    A partial sort's observable state equals a stable sort by the masked low
    bits: LSD passes never look at higher bits. The sort key is widened to
    int64, where u32 order is plain integer order.
    """
    steps = 8 if num_steps in (0, None) else min(int(num_steps), 8)
    if steps == 0:
        return keys, values
    k, v = keys.view(torch.int32), values.view(torch.int32)
    wide = k.to(torch.int64) & ((1 << (4 * steps)) - 1)
    order = torch.sort(wide, stable=True).indices
    return k[order].view(torch.uint32), v[order].view(torch.uint32)


def ref_csr(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor, num_vertices: int):
    """The compressed sparse rows of a weighted edge list (u32 src, dst and
    weight words, vertex ids below num_vertices <= 2^31): (row starts, int32
    of num_vertices; the columns, u32; the weights, u32). Each row holds its
    edges ascending by dst, edges of equal
    (src, dst) in input order, and the weights travel with their edges; row
    v spans [starts[v], starts[v + 1]), the last row ending at the edge
    count. The key (src, dst) is widened to int64, where u32 order is plain
    integer order."""
    s, d = src.view(torch.int32).to(torch.int64) & 0xFFFFFFFF, dst.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    order = torch.sort((s << 32) | d, stable=True).indices
    counts = torch.bincount(s, minlength=num_vertices)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    return starts, dst.view(torch.int32)[order].view(torch.uint32), weights.view(torch.int32)[order].view(torch.uint32)
