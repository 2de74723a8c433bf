"""Alignment math (reference: include/bof_utils.h:12-20, src/utils.cpp)."""
from __future__ import annotations

from ..config import SECTOR_LEN


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def round_down(x: int, m: int) -> int:
    return (x // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def is_aligned(x: int, m: int = SECTOR_LEN) -> bool:
    return x % m == 0


def is_sector_aligned(x: int) -> bool:
    return x % SECTOR_LEN == 0


def fnv64a(data: bytes) -> int:
    """FNV-1a 64-bit hash (reference: src/utils.cpp:22-45), used to key the
    tile cache."""
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h
