"""Exact port of klib's B-tree (kbtree.h) as used for chain lookup.

mem_chain keys its chains by position in a kbtree (bwamem.c:184-187, 256) and
merges each new seed into the chain returned by kb_intervalp's *lower*. With
duplicate positions, WHICH duplicate is returned depends on the B-tree's node
structure (splits), so a sorted list is not equivalent — this module mirrors
kbtree.h's search/insert/split algorithm exactly.

mem_chain_t is 40 bytes on LP64, so with KB_DEFAULT_SIZE=512:
t = ((512 - 4 - 8) / (8 + 40) + 1) >> 1 = 5 (kbtree.h:61).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple


class _Node:
    __slots__ = ("keys", "ptrs", "is_internal")

    def __init__(self, is_internal: bool):
        self.keys: List = []
        self.ptrs: List["_Node"] = []
        self.is_internal = is_internal

    @property
    def n(self) -> int:
        return len(self.keys)


class KBTree:
    def __init__(self, cmp: Callable, t: int = 5):
        self.cmp = cmp
        self.t = t
        self.root = _Node(False)
        self.n_keys = 0

    # __kb_getp_aux (kbtree.h:117-131): lower_bound-style search
    def _getp_aux(self, x: _Node, k) -> Tuple[int, int]:
        n = x.n
        if n == 0:
            return -1, 1
        begin, end = 0, n
        while begin < end:
            mid = (begin + end) >> 1
            if self.cmp(x.keys[mid], k) < 0:
                begin = mid + 1
            else:
                end = mid
        if begin == n:
            return n - 1, 1
        r = self.cmp(k, x.keys[begin])
        if r < 0:
            begin -= 1
        return begin, r

    # kb_intervalp (kbtree.h:151-168)
    def interval(self, k) -> Tuple[Optional[object], Optional[object]]:
        lower = upper = None
        x = self.root
        while x is not None:
            i, r = self._getp_aux(x, k)
            if i >= 0 and r == 0:
                return x.keys[i], x.keys[i]
            if i >= 0:
                lower = x.keys[i]
            if i < x.n - 1:
                upper = x.keys[i + 1]
            if not x.is_internal:
                return lower, upper
            x = x.ptrs[i + 1]
        return lower, upper

    # __kb_split (kbtree.h:176-191): split full child y = x.ptrs[i]
    def _split(self, x: _Node, i: int, y: _Node):
        t = self.t
        z = _Node(y.is_internal)
        z.keys = y.keys[t:]
        if y.is_internal:
            z.ptrs = y.ptrs[t:]
            y.ptrs = y.ptrs[:t]
        median = y.keys[t - 1]
        y.keys = y.keys[: t - 1]
        x.ptrs.insert(i + 1, z)
        x.keys.insert(i, median)

    # __kb_putp_aux (kbtree.h:193-209)
    def _putp_aux(self, x: _Node, k):
        if not x.is_internal:
            i, _ = self._getp_aux(x, k)
            x.keys.insert(i + 1, k)
        else:
            i, _ = self._getp_aux(x, k)
            i += 1
            if x.ptrs[i].n == 2 * self.t - 1:
                self._split(x, i, x.ptrs[i])
                if self.cmp(k, x.keys[i]) > 0:
                    i += 1
            self._putp_aux(x.ptrs[i], k)

    # kb_putp (kbtree.h:210-224): preemptive root split
    def put(self, k):
        self.n_keys += 1
        r = self.root
        if r.n == 2 * self.t - 1:
            s = _Node(True)
            s.ptrs = [r]
            self.root = s
            self._split(s, 0, r)
            r = s
        self._putp_aux(r, k)

    @property
    def size(self) -> int:
        return self.n_keys

    # __kb_traverse: in-order
    def traverse(self) -> List:
        out: List = []

        def rec(x: _Node):
            if x.is_internal:
                for i in range(x.n):
                    rec(x.ptrs[i])
                    out.append(x.keys[i])
                rec(x.ptrs[x.n])
            else:
                out.extend(x.keys)

        rec(self.root)
        return out
