"""The plain reference of Graph 500's kernel 1, the compressed sparse rows
of a weighted edge list: plain torch, no kernel and nothing of the program
under test, and no sort's stability relied on.

u32 words are read through int32 views and widened to int64. Each edge is
first ranked by the unique word (dst above its input position), then the
edges are ordered by the unique word (src above that rank): rows ascending,
each row's neighbours ascending by dst, edges of equal (src, dst) in input
order. The row starts are found apart from any count: for each vertex, the
first place in the sorted sources that is not below it.

The sources' range is cut into `parts` pieces of equal width and each piece
ordered alone, which gives the same order (the rows come first) in a
fraction of the memory: a sort of 2^30 int64 words holds several times
their 8 GiB.

The control stands in the program's place and breaks one guarantee that
the configuration states: `by_dst=False` orders by the source alone, so
the rows are right and each row's neighbours stay in input order.
"""

from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF
_POS_BITS = 31  # input positions below 2^31
PART_EDGES = 1 << 28  # about this many edges a piece, for sources spread evenly


def _wide(words: torch.Tensor) -> torch.Tensor:
    return words.view(torch.int32).to(torch.int64) & _LOW32


def _unique_order(high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """The `low` values (int64, distinct, below 2^31) in the order of the
    pairs (high, low), by one sort of unique words."""
    words = (high << _POS_BITS) | low
    words = torch.sort(words).values
    words &= (1 << _POS_BITS) - 1
    return words


def _order_of_piece(src: torch.Tensor, dst: torch.Tensor, members: torch.Tensor, by_dst: bool) -> torch.Tensor:
    """The CSR order of the edges at `members` (int64 positions, ascending),
    as int64 positions into the whole list."""
    position = torch.arange(members.shape[0], dtype=torch.int64, device=members.device)
    if not by_dst:
        return members[_unique_order(_wide(src.view(torch.int32)[members]), position)]
    ranked = _unique_order(_wide(dst.view(torch.int32)[members]), position)  # the piece's positions by (dst, position)
    rank = torch.empty_like(ranked)
    rank[ranked] = position
    del position
    order = _unique_order(_wide(src.view(torch.int32)[members]), rank)  # ranks by (src, rank)
    del rank
    return members[ranked[order]]


def csr(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor, num_vertices: int, *, by_dst: bool = True,
        parts: int | None = None) -> tuple:
    """(row starts, int32 of num_vertices; columns, u32; weights, u32) of
    the edges (src, dst, weight), u32 each, vertex ids below num_vertices
    <= 2^31 (an edge whose source is not is left out); row v spans
    [starts[v], starts[v + 1]), the last row ending at the edge count."""
    m = src.shape[0]
    if m >= 1 << _POS_BITS:
        raise ValueError(f"{m} edges: the reference orders fewer than 2^{_POS_BITS}")
    if parts is None:
        parts = max(1, -(-m // PART_EDGES))
    s32 = src.view(torch.int32)
    width = -(-num_vertices // parts)
    order = []
    for lo in range(0, num_vertices, width):
        members = ((s32 >= lo) & (s32 < lo + width)).nonzero().squeeze(1)
        order.append(_order_of_piece(src, dst, members, by_dst).to(torch.int32))
        del members
    order = torch.cat(order)
    sorted_src = torch.index_select(s32, 0, order)
    vertices = torch.arange(num_vertices, dtype=torch.int32, device=src.device)
    starts = torch.searchsorted(sorted_src, vertices).to(torch.int32)
    del sorted_src, vertices
    columns = torch.index_select(dst.view(torch.int32), 0, order).view(torch.uint32)
    return starts, columns, torch.index_select(weights.view(torch.int32), 0, order).view(torch.uint32)
