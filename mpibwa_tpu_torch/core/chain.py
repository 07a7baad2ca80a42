"""Seeding and chaining (bwamem.c:114-385, 560-615 semantics)."""

from __future__ import annotations

import copy
import dataclasses
import math
from .kbtree import KBTree
from typing import List

import numpy as np

from .extend import KSW_XSTART, ksw_align2
from .sortutil import ks_introsort

MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
# C float literals (1.1f/0.05f) used in double context: float32-rounded
MEM_HSP_COEF = float(np.float32(1.1))
MEM_MINSC_COEF = 5.5
MEM_SEEDSW_COEF = float(np.float32(0.05))


def _f32(x):
    return np.float32(x)


@dataclasses.dataclass
class Seed:
    rbeg: int
    qbeg: int
    len: int
    score: int


@dataclasses.dataclass
class Chain:
    pos: int
    rid: int
    is_alt: int
    seeds: List[Seed]
    w: int = 0
    kept: int = 0
    first: int = -1
    frac_rep: float = 0.0

    @property
    def n(self):
        return len(self.seeds)


def collect_intv(opt, fm, q) -> List[tuple]:
    """mem_collect_intv (bwamem.c:114-162): 3-pass seed interval collection."""
    mem: List[tuple] = []
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    n = len(q)
    x = 0
    while x < n:
        if q[x] < 4:
            x, m1 = fm.smem1(q, x, 1)
            for iv in m1:
                slen = (iv[3] & 0xFFFFFFFF) - (iv[3] >> 32)
                if slen >= opt.min_seed_len:
                    mem.append(iv)
        else:
            x += 1
    old_n = len(mem)
    for k in range(old_n):
        iv = mem[k]
        start, end = iv[3] >> 32, iv[3] & 0xFFFFFFFF
        if end - start < split_len or iv[2] > opt.split_width:
            continue
        _, m1 = fm.smem1(q, (start + end) >> 1, iv[2] + 1)
        for jv in m1:
            if (jv[3] & 0xFFFFFFFF) - (jv[3] >> 32) >= opt.min_seed_len:
                mem.append(jv)
    if opt.max_mem_intv > 0:
        x = 0
        while x < n:
            if q[x] < 4:
                x, m = fm.seed_strategy1(q, x, opt.min_seed_len, opt.max_mem_intv)
                if m is not None and m[2] > 0:
                    mem.append(m)
            else:
                x += 1
    ks_introsort(mem, lambda a, b: a[3] < b[3])
    return mem


def chain_weight(c: Chain) -> int:
    """mem_chain_weight (bwamem.c:213-232)."""
    w = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w += s.len
        elif s.qbeg + s.len > end:
            w += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    tmp, w, end = w, 0, 0
    for s in c.seeds:
        if s.rbeg >= end:
            w += s.len
        elif s.rbeg + s.len > end:
            w += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    w = min(w, tmp)
    return w if w < (1 << 30) else (1 << 30) - 1


def _test_and_merge(opt, l_pac: int, c: Chain, p: Seed, seed_rid: int) -> bool:
    """test_and_merge (bwamem.c:190-211)."""
    last = c.seeds[-1]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if seed_rid != c.rid:
        return False
    if (p.qbeg >= c.seeds[0].qbeg and p.qbeg + p.len <= qend
            and p.rbeg >= c.seeds[0].rbeg and p.rbeg + p.len <= rend):
        return True  # contained
    if (last.rbeg < l_pac or c.seeds[0].rbeg < l_pac) and p.rbeg >= l_pac:
        return False  # different strand
    x = p.qbeg - last.qbeg
    y = p.rbeg - last.rbeg
    if (y >= 0 and x - y <= opt.w and y - x <= opt.w
            and x - last.len < opt.max_chain_gap and y - last.len < opt.max_chain_gap):
        c.seeds.append(copy.copy(p))  # ~10x dataclasses.replace
        return True
    return False


def mem_chain(opt, fm, refs, q, l_seq: int, mem=None, sa=None) -> List[Chain]:
    """mem_chain (bwamem.c:251-315). Returns chains in B-tree traversal order
    (pos-ascending, insertion order after equals).

    mem: precomputed collect_intv output (device seeding); sa: k -> position
    resolver (device SA batch); both default to the scalar engine."""
    if l_seq < opt.min_seed_len:
        return []
    l_pac = refs.l_pac
    if mem is None:
        mem = collect_intv(opt, fm, q)
    if sa is None:
        sa = fm.sa_lookup
    # frac_rep (bwamem.c:265-272)
    b = e = l_rep = 0
    for iv in mem:
        sb, se = iv[3] >> 32, iv[3] & 0xFFFFFFFF
        if iv[2] <= opt.max_occ:
            continue
        if sb > e:
            l_rep += e - b
            b, e = sb, se
        else:
            e = max(e, se)
    l_rep += e - b

    # chain_cmp compares pos only (bwamem.c:186); duplicate positions are real
    # and WHICH duplicate kb_intervalp returns depends on the exact B-tree
    # node structure, so an exact kbtree port is required (core/kbtree.py).
    tree = KBTree(cmp=lambda x, y: (y.pos < x.pos) - (x.pos < y.pos))
    key = Chain(pos=0, rid=0, is_alt=0, seeds=[])
    for iv in mem:
        slen = (iv[3] & 0xFFFFFFFF) - (iv[3] >> 32)
        step = iv[2] // opt.max_occ if iv[2] > opt.max_occ else 1
        k, count = 0, 0
        while k < iv[2] and count < opt.max_occ:
            rbeg = sa(iv[0] + k)
            s = Seed(rbeg=rbeg, qbeg=iv[3] >> 32, len=slen, score=slen)
            rid = refs.intv2rid(s.rbeg, s.rbeg + s.len)
            if rid >= 0:
                to_add = False
                if tree.size:
                    key.pos = rbeg
                    lower, _upper = tree.interval(key)
                    if lower is None or not _test_and_merge(opt, l_pac, lower, s, rid):
                        to_add = True
                else:
                    to_add = True
                if to_add:
                    c = Chain(pos=s.rbeg, rid=rid,
                              is_alt=1 if refs.anns[rid].is_alt else 0,
                              seeds=[s])
                    tree.put(c)
            k += step
            count += 1
    chains = tree.traverse()
    # frac_rep is a C float field computed by float division (bwamem.c:310)
    frac_rep = float(np.float32(np.float32(l_rep) / np.float32(l_seq)))
    for c in chains:
        c.frac_rep = frac_rep
    return chains


def mem_chain_flt(opt, chains: List[Chain]) -> List[Chain]:
    """mem_chain_flt (bwamem.c:327-385)."""
    if not chains:
        return []
    a = []
    for c in chains:
        c.first = -1
        c.kept = 0
        c.w = chain_weight(c)
        if c.w >= opt.min_chain_weight:
            a.append(c)
    if not a:
        return []
    ks_introsort(a, lambda x, y: x.w > y.w)
    kept_idx = [0]
    a[0].kept = 3
    # hoisted float32 constants: this nested loop runs ~chains^2 per read
    # and the _f32 helper was ~1.7M calls per 10K-read batch
    f32 = np.float32
    mask32 = f32(opt.mask_level)
    drop32 = f32(opt.drop_ratio)
    for i in range(1, len(a)):
        large_ovlp = False
        brk = False
        for j in kept_idx:
            b_max = max(a[j].seeds[0].qbeg, a[i].seeds[0].qbeg)
            e_min = min(a[j].seeds[-1].qbeg + a[j].seeds[-1].len,
                        a[i].seeds[-1].qbeg + a[i].seeds[-1].len)
            if e_min > b_max and (not a[j].is_alt or a[i].is_alt):
                li = a[i].seeds[-1].qbeg + a[i].seeds[-1].len - a[i].seeds[0].qbeg
                lj = a[j].seeds[-1].qbeg + a[j].seeds[-1].len - a[j].seeds[0].qbeg
                min_l = min(li, lj)
                # C: `e_min - b_max >= min_l * opt->mask_level` in float32
                if (f32(e_min - b_max) >= f32(min_l) * mask32
                        and min_l < opt.max_chain_gap):
                    large_ovlp = True
                    if a[j].first < 0:
                        a[j].first = i
                    if (f32(a[i].w) < f32(a[j].w) * drop32
                            and a[j].w - a[i].w >= opt.min_seed_len << 1):
                        brk = True
                        break
        if not brk:
            kept_idx.append(i)
            a[i].kept = 2 if large_ovlp else 3
    for j in kept_idx:
        if a[j].first >= 0:
            a[a[j].first].kept = 1
    # cap number of kept=1/2 chains to extend (bwamem.c:373-378)
    k = 0
    i = 0
    n = len(a)
    while i < n:
        if a[i].kept == 0 or a[i].kept == 3:
            i += 1
            continue
        k += 1
        if k >= opt.max_chain_extend:
            break
        i += 1
    while i < n:
        if a[i].kept < 3:
            a[i].kept = 0
        i += 1
    return [c for c in a if c.kept != 0]


def mem_seed_sw(opt, refs, l_query: int, query, s: Seed) -> int:
    """mem_seed_sw (bwamem.c:571-596)."""
    l_pac = refs.l_pac
    if s.len >= MEM_SHORT_LEN:
        return -1
    qb, qe = s.qbeg, s.qbeg + s.len
    rb, re = s.rbeg, s.rbeg + s.len
    mid = (rb + re) >> 1
    qb = max(qb - MEM_SHORT_EXT, 0)
    qe = min(qe + MEM_SHORT_EXT, l_query)
    rb = max(rb - MEM_SHORT_EXT, 0)
    re = min(re + MEM_SHORT_EXT, l_pac << 1)
    if rb < l_pac < re:
        if mid < l_pac:
            re = l_pac
        else:
            rb = l_pac
    if qe - qb >= MEM_SHORT_LEN or re - rb >= MEM_SHORT_LEN:
        return -1
    rseq, rid, rb, re = refs.fetch_seq(rb, mid, re)
    x = ksw_align2(np.asarray(query[qb:qe], dtype=np.uint8), rseq, opt.mat,
                   opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, KSW_XSTART)
    return x.score


def mem_flt_chained_seeds(opt, refs, l_query: int, query, chains: List[Chain]):
    """mem_flt_chained_seeds (bwamem.c:598-615)."""
    min_l = (MEM_HSP_COEF * opt.min_chain_weight if opt.min_chain_weight
             else MEM_MINSC_COEF * math.log(l_query))
    min_hsp_score = int(opt.a * min_l + 0.499)
    if min_l > MEM_SEEDSW_COEF * l_query:
        return
    for c in chains:
        kept = []
        for s in c.seeds:
            s.score = mem_seed_sw(opt, refs, l_query, query, s)
            if s.score < 0 or s.score >= min_hsp_score:
                s.score = s.len * opt.a if s.score < 0 else s.score
                kept.append(s)
        c.seeds = kept
