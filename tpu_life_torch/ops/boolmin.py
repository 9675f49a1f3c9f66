"""Two-level boolean minimization (Quine-McCluskey) for rule synthesis.

The bit-sliced step applies a life-like rule to the count bitplanes as a
5-input boolean function ``alive'(b0, b1, b2, b3, x)`` (4 total-count bits
plus the center's state).  The naive form — an OR of 4-bit equality masks,
one per birth/survive count (``bitlife.make_packed_step``'s original
formulation) — costs ~7 VPU bit-ops per count value, which for count-rich
rules like Day & Night (B3678/S34678: 9 values) dominates the whole step.

This module instead minimizes the function once per rule at trace time:
classic Quine-McCluskey prime-implicant generation plus a greedy set cover,
with two families of don't-cares that make life-like rules minimize
unusually well:

- totals 10..15 cannot occur (center + 8 neighbors <= 9);
- total == 0 with the center alive cannot occur (the total includes it).

The result is a small sum-of-products over the 5 literals; an exhaustive
32-row truth-table check (``verify``) guards every synthesized rule, so a
minimizer bug cannot silently corrupt the step (the cross-executor
bit-identity tests then cover the integration).  The reference's analogue
of all of this is the branchy if/else chain at Parallel_Life_MPI.cpp:37-54.
"""

from __future__ import annotations

from functools import lru_cache

# An implicant is (mask, value): the product term covering exactly the
# inputs i with i & mask == value; bits outside mask are free.


def _combine(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int] | None:
    """Merge two implicants differing in one cared bit, else None."""
    if a[0] != b[0]:
        return None
    diff = a[1] ^ b[1]
    if diff and not (diff & (diff - 1)):  # exactly one bit differs
        return a[0] & ~diff, a[1] & ~diff
    return None


def prime_implicants(
    minterms: frozenset[int], dontcares: frozenset[int], nbits: int
) -> list[tuple[int, int]]:
    """All prime implicants of the (minterms + dontcares) on-set."""
    full = (1 << nbits) - 1
    current = {(full, m) for m in minterms | dontcares}
    primes: set[tuple[int, int]] = set()
    while current:
        merged: set[tuple[int, int]] = set()
        used: set[tuple[int, int]] = set()
        items = sorted(current)
        for i, a in enumerate(items):
            for b in items[i + 1 :]:
                c = _combine(a, b)
                if c is not None:
                    merged.add(c)
                    used.add(a)
                    used.add(b)
        primes |= current - used
        current = merged
    return sorted(primes)


def _covers(imp: tuple[int, int], m: int) -> bool:
    return (m & imp[0]) == imp[1]


def minimize(
    minterms: set[int] | frozenset[int],
    dontcares: set[int] | frozenset[int] = frozenset(),
    nbits: int = 5,
) -> list[tuple[int, int]]:
    """Minimal-ish SOP cover of ``minterms`` (don't-cares free to use).

    Exact prime-implicant generation + the standard essential-prime step,
    then greedy set cover for the remainder (optimal for the tiny tables
    here in practice; correctness is guaranteed by construction and
    re-checked by :func:`verify`).  Returns implicants as (mask, value).
    """
    minterms = frozenset(minterms)
    dontcares = frozenset(dontcares)
    if not minterms:
        return []
    if minterms | dontcares == frozenset(range(1 << nbits)):
        return [(0, 0)]  # constant true
    primes = prime_implicants(minterms, dontcares, nbits)
    remaining = set(minterms)
    chosen: list[tuple[int, int]] = []
    # essential primes: a minterm covered by exactly one prime
    for m in sorted(minterms):
        cover = [p for p in primes if _covers(p, m)]
        if len(cover) == 1 and cover[0] not in chosen:
            chosen.append(cover[0])
    for p in chosen:
        remaining -= {m for m in remaining if _covers(p, m)}
    while remaining:
        best = max(
            primes,
            key=lambda p: (
                len({m for m in remaining if _covers(p, m)}),
                -bin(p[0]).count("1"),  # prefer wider implicants
            ),
        )
        got = {m for m in remaining if _covers(best, m)}
        if not got:  # cannot happen for a valid prime set; guard anyway
            raise AssertionError("QM cover failed to progress")
        chosen.append(best)
        remaining -= got
    return chosen


def verify(
    implicants: list[tuple[int, int]],
    minterms: set[int] | frozenset[int],
    dontcares: set[int] | frozenset[int],
    nbits: int = 5,
) -> None:
    """Exhaustive truth-table check: the SOP must equal the spec on every
    cared input (don't-cares may fall either way)."""
    for i in range(1 << nbits):
        got = any(_covers(p, i) for p in implicants)
        if i in dontcares:
            continue
        want = i in minterms
        if got != want:
            raise AssertionError(
                f"synthesized SOP wrong at input {i:0{nbits}b}: "
                f"got {got}, want {want}"
            )


@lru_cache(maxsize=None)
def membership_rule_sop(
    birth: frozenset, survive: frozenset, count_max: int
) -> tuple[int, tuple[tuple[int, int], ...]]:
    """(n_count_bits, SOP) for ``alive'(count_b0.., x)`` over RAW counts.

    Unlike :func:`rule_sop` (life-like totals including the center), the
    count here is exactly what the rule's membership sets test — the
    neighborhood sum as ``stencil._counts`` produces it, center excluded
    unless the rule includes it — so this serves any 2-state neighborhood
    whose maximum count fits the planes (the bit-sliced von Neumann
    diamond: ``count_max = 2r(r+1)``).  Input bit layout: bits
    0..n-1 = count planes, bit n = the center cell.  Don't-cares: counts
    above ``count_max``.
    """
    nplanes = max(1, count_max.bit_length())
    nbits = nplanes + 1
    minterms, dontcares = set(), set()
    for x_bit in (0, 1):
        for count in range(1 << nplanes):
            idx = count | (x_bit << nplanes)
            if count > count_max:
                dontcares.add(idx)
            elif (count in birth) if x_bit == 0 else (count in survive):
                minterms.add(idx)
    sop = minimize(minterms, dontcares, nbits=nbits)
    verify(sop, minterms, dontcares, nbits=nbits)
    return nplanes, tuple(sop)


@lru_cache(maxsize=None)
def rule_sop(
    birth: frozenset, survive: frozenset
) -> tuple[tuple[int, int], ...]:
    """Minimal SOP for ``alive'(total_b0..b3, x)`` of a life-like rule.

    Input bit layout: bits 0..3 = the total-count bitplanes (center + 8
    neighbors, 0..9), bit 4 = the center cell.  Don't-cares: totals > 9;
    total == 0 while alive (the total includes the center); and total == 9
    while dead (9 needs all eight neighbors plus the center).
    """
    minterms, dontcares = set(), set()
    for x_bit in (0, 1):
        for total in range(16):
            idx = total | (x_bit << 4)
            if (
                total > 9
                or (x_bit == 1 and total == 0)
                or (x_bit == 0 and total == 9)
            ):
                dontcares.add(idx)
            elif (total in birth) if x_bit == 0 else ((total - 1) in survive):
                minterms.add(idx)
    sop = minimize(minterms, dontcares, nbits=5)
    verify(sop, minterms, dontcares, nbits=5)
    return tuple(sop)
