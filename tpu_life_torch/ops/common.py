"""Shared helpers for the op executors."""

from __future__ import annotations


def contiguous_ranges(values) -> list[tuple[int, int]]:
    """Collapse a set of ints into sorted inclusive ranges.

    ``{2, 3, 5, 6, 7}`` -> ``[(2, 3), (5, 7)]``.  Rule masks compile to one
    ``(lo <= c) & (c <= hi)`` pair per range — Larger-than-Life interval rules
    (e.g. ``S34..58``) cost exactly two vector compares.
    """
    vs = sorted(values)
    if not vs:
        return []
    out = []
    lo = prev = vs[0]
    for v in vs[1:]:
        if v == prev + 1:
            prev = v
            continue
        out.append((lo, prev))
        lo = prev = v
    out.append((lo, prev))
    return out
