"""Order-preserving composite keys for multi-field (lexicographic) sort.

The reference's `flash::sort<T, Comparator>` accepts an arbitrary
comparator (reference: include/sort.tpp:13, include/tasks/sort_task.h:8).
Our sample sort instead takes a vectorized order-embedding `key=` — which
covers single-field comparators but not the most common multi-field kind
("sort by a, ties by b").  `lex_composite` closes that gap: it maps a
tuple of per-element key columns to ONE numpy bytes (`|S{n}`) column whose
byte-wise lexicographic order equals the lexicographic order of the
tuples.  numpy sorts, argsorts, and searchsorteds `S` dtypes natively, so
the whole sample-sort pipeline (block argsort, pivot selection, bucket
binary search) runs on composites with no new machinery.

Per-column transform to big-endian order-preserving bytes:

- unsigned ints: big-endian bytes as-is;
- signed ints: flip the sign bit (two's-complement order == unsigned
  order after `x ^ MIN`);
- floats: the IEEE-754 total-order trick — view as signed int `i`, then
  negatives map to `~i` and non-negatives to `i | SIGN`, giving an
  unsigned integer that increases with the float value.  Value-equal
  floats must map to ONE key (a later column breaks the tie, and
  distinct keys would break lexicographic order on every subsequent
  column), so the column is canonicalized first: `-0.0 -> +0.0`, and
  every NaN (any sign/payload) -> the positive quiet NaN, which lands
  above +inf — numpy's own NaN-last placement;
- bool: one byte.

Non-native byte orders are converted to native before the transforms
(viewing big-endian storage as native integers would apply the sign-bit
flip to the wrong lane).

Descending on an individual column: pass the bitwise/arithmetic
complement of that column (`-x` for signed/float without extrema,
`~x` for ints, `np.logical_not` for bool).
"""
from __future__ import annotations

import numpy as np


def _column_bytes(col: np.ndarray) -> np.ndarray:
    """(n,) column -> (n, itemsize) uint8 whose row-wise lexicographic
    order equals the column's value order."""
    col = np.ascontiguousarray(col)
    if col.ndim != 1:
        raise ValueError(f"key columns must be 1-D, got shape {col.shape}")
    if not col.dtype.isnative and col.dtype != np.bool_:
        col = col.astype(col.dtype.newbyteorder("="))
    dt = col.dtype
    if dt == np.bool_:
        u = col.astype(np.uint8)
    elif np.issubdtype(dt, np.unsignedinteger):
        u = col
    elif np.issubdtype(dt, np.signedinteger):
        bits = dt.itemsize * 8
        u = col.view(f"u{dt.itemsize}") ^ np.array(1 << (bits - 1),
                                                   f"u{dt.itemsize}")
    elif np.issubdtype(dt, np.floating):
        if dt.itemsize == 2:
            idt, udt, sign = np.int16, np.uint16, np.uint16(1 << 15)
        elif dt.itemsize == 4:
            idt, udt, sign = np.int32, np.uint32, np.uint32(1 << 31)
        elif dt.itemsize == 8:
            idt, udt, sign = np.int64, np.uint64, np.uint64(1 << 63)
        else:
            raise TypeError(f"unsupported float itemsize {dt.itemsize}")
        # canonicalize value-equal bit patterns: -0.0 == +0.0 and all
        # NaNs must share one key, or a "tie" poisons every later column
        col = col + dt.type(0.0)  # -0.0 + 0.0 -> +0.0, others unchanged
        nan = np.isnan(col)
        if nan.any():
            col = col.copy()
            col[nan] = dt.type(np.nan)  # one positive quiet NaN pattern
        i = col.view(idt)
        u = np.where(i < 0, ~i, i | idt(sign)).view(udt)
    else:
        raise TypeError(
            f"lex_composite supports bool/int/float columns, got {dt}")
    be = u.astype(u.dtype.newbyteorder(">"), copy=False)
    return np.ascontiguousarray(be).view(np.uint8).reshape(len(col), -1)


def lex_composite(cols) -> np.ndarray:
    """Tuple/list of equal-length 1-D arrays -> one `|S{n}` key column
    sorting lexicographically by position (first column is the primary
    key).  Usable directly as a `bof_sort` key return value — `bof_sort`
    calls this automatically when `key=` returns a tuple."""
    cols = list(cols)
    if not cols:
        raise ValueError("lex_composite needs at least one column")
    n = len(cols[0])
    for c in cols:
        if len(c) != n:
            raise ValueError("key columns must have equal length")
    parts = [_column_bytes(np.asarray(c)) for c in cols]
    packed = np.ascontiguousarray(np.hstack(parts))
    width = packed.shape[1]
    return packed.reshape(n * width).view(f"S{width}")
