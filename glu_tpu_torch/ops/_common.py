"""Shared integer helpers of the kernel wrappers (counterpart of
glu_tpu/ops/_pallas_common.py; the GPU has no interpret mode, so only the
arithmetic carries over)."""

from __future__ import annotations


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
