"""Exact ksort.h introsort and hash_64.

bwa's sorts are ks_introsort (ksort.h), which is NOT
stable; the permutation of compare-equal elements is determined by the
algorithm (quicksort with median-of-3, combsort fallback, final insertion
sort) and is visible in the output (e.g. mem_sort_dedup_patch sorts by end
position only). This module reimplements the same algorithm so tie
permutations match the reference bit-for-bit.
"""

from __future__ import annotations

from typing import Callable, List

U64 = (1 << 64) - 1


def hash_64(key: int) -> int:
    """Thomas Wang 64-bit mix (utils.h:98-109)."""
    key &= U64
    key = (key + (~(key << 32) & U64)) & U64
    key ^= key >> 22
    key = (key + (~(key << 13) & U64)) & U64
    key ^= key >> 8
    key = (key + (key << 3)) & U64
    key ^= key >> 15
    key = (key + (~(key << 27) & U64)) & U64
    key ^= key >> 31
    return key


def _insertsort(a: List, lo: int, hi: int, lt: Callable) -> None:
    for i in range(lo + 1, hi):
        j = i
        while j > lo and lt(a[j], a[j - 1]):
            a[j], a[j - 1] = a[j - 1], a[j]
            j -= 1


def _combsort(a: List, lo: int, n: int, lt: Callable) -> None:
    shrink = 1.2473309501039786540366528676643
    gap = n
    do_swap = True
    while do_swap or gap > 2:
        if gap > 2:
            gap = int(gap / shrink)
            if gap in (9, 10):
                gap = 11
        do_swap = False
        for i in range(lo, lo + n - gap):
            j = i + gap
            if lt(a[j], a[i]):
                a[i], a[j] = a[j], a[i]
                do_swap = True
    if gap != 1:
        _insertsort(a, lo, lo + n, lt)


def ks_introsort(a: List, lt: Callable) -> None:
    """In-place sort of list ``a`` with the exact ksort.h permutation."""
    n = len(a)
    if n < 1:
        return
    if n == 2:
        if lt(a[1], a[0]):
            a[0], a[1] = a[1], a[0]
        return
    d = 2
    while (1 << d) < n:
        d += 1
    stack = []
    s, t = 0, n - 1
    d <<= 1
    while True:
        if s < t:
            d -= 1
            if d == 0:
                _combsort(a, s, t - s + 1, lt)
                t = s
                continue
            i, j = s, t
            k = i + ((j - i) >> 1) + 1
            if lt(a[k], a[i]):
                if lt(a[k], a[j]):
                    k = j
            else:
                k = i if lt(a[j], a[i]) else j
            rp = a[k]
            if k != t:
                a[k], a[t] = a[t], a[k]
            while True:
                i += 1
                while lt(a[i], rp):
                    i += 1
                j -= 1
                while i <= j and lt(rp, a[j]):
                    j -= 1
                if j <= i:
                    break
                a[i], a[j] = a[j], a[i]
            a[i], a[t] = a[t], a[i]
            if i - s > t - i:
                if i - s > 16:
                    stack.append((s, i - 1, d))
                s = i + 1 if t - i > 16 else t
            else:
                if t - i > 16:
                    stack.append((i + 1, t, d))
                t = i - 1 if i - s > 16 else s
        else:
            if not stack:
                _insertsort(a, 0, n, lt)
                return
            s, t, d = stack.pop()


def introsort_64(a: List[int]) -> None:
    """ks_introsort_64: plain uint64 ascending."""
    ks_introsort(a, lambda x, y: x < y)


def introsort_128(a: List) -> None:
    """ks_introsort_128 over (x, y) pairs (pair64_lt, utils.c:45)."""
    ks_introsort(a, lambda p, q: p[0] < q[0] or (p[0] == q[0] and p[1] < q[1]))
