"""Alignment regions: chain extension, dedup/patch, primary marking, mapQ.

Semantics of bwamem.c:403-558 and 621-786, plus mem_approx_mapq_se
(bwamem.c:952-976) and mem_reorder_primary5 (bwamem.c:978-1000).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from .chain import Chain
from .extend import ksw_extend2
from .sortutil import hash_64, ks_introsort

MAX_BAND_TRY = 2
# C float literals (0.05f/0.90f) promote to double in comparisons: use the
# float32-rounded values (bwamem.c:403-404)
PATCH_MAX_R_BW = float(np.float32(0.05))
PATCH_MIN_SC_RATIO = float(np.float32(0.90))
MEM_MAPQ_COEF = 30.0
INT_MAX = 2**31 - 1


def _f32(x):
    return np.float32(x)


def _fcmp_gt(lhs: int, coef: float, rhs: int) -> bool:
    """C expression `lhs > coef * rhs` where coef is float and lhs/rhs are
    integers: evaluated entirely in float32 (usual arithmetic conversions)."""
    return _f32(lhs) > _f32(_f32(coef) * _f32(rhs))


def _fcmp_ge(lhs: int, coef: float, rhs: int) -> bool:
    return _f32(lhs) >= _f32(_f32(coef) * _f32(rhs))


def _fcmp_lt(lhs: int, coef: float, rhs: int) -> bool:
    return _f32(lhs) < _f32(_f32(coef) * _f32(rhs))


@dataclasses.dataclass
class AlnReg:
    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    rid: int = 0
    score: int = 0
    truesc: int = 0
    sub: int = 0
    alt_sc: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = 0
    seedlen0: int = 0
    n_comp: int = 0
    is_alt: int = 0
    frac_rep: float = 0.0
    hash: int = 0


def cal_max_gap(opt, qlen: int) -> int:
    """cal_max_gap (bwamem.c:621-628)."""
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = max(l_del, l_ins, 1)
    return min(l, opt.w << 1)


def mem_chain2aln(opt, refs, l_query: int, query, c: Chain, av: List[AlnReg],
                  extender=None):
    """mem_chain2aln (bwamem.c:632-786): extend a chain's seeds into regions,
    appending to av. extender(qs, ts, w, end_bonus, zdrop, h0) may serve
    precomputed device results; defaults to the scalar kernel."""
    if c.n == 0:
        return
    if extender is None:
        def extender(qs, ts, w_, eb, zd, h0_):
            return ksw_extend2(qs, ts, opt.mat, opt.o_del, opt.e_del,
                               opt.o_ins, opt.e_ins, w_, eb, zd, h0_)
    l_pac = refs.l_pac
    # max possible span (bwamem.c:642-657)
    rmax0, rmax1 = l_pac << 1, 0
    for t in c.seeds:
        b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
        e = (t.rbeg + t.len
             + (l_query - t.qbeg - t.len)
             + cal_max_gap(opt, l_query - t.qbeg - t.len))
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, l_pac << 1)
    if rmax0 < l_pac < rmax1:
        if c.seeds[0].rbeg < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    rseq, rid, rmax0, rmax1 = refs.fetch_seq(rmax0, c.seeds[0].rbeg, rmax1)
    assert c.rid == rid

    srt = [(s.score << 32) | i for i, s in enumerate(c.seeds)]
    ks_introsort(srt, lambda a, b: a < b)

    for k in range(c.n - 1, -1, -1):
        s = c.seeds[srt[k] & 0xFFFFFFFF]
        # containment test vs existing regions (bwamem.c:671-706)
        hit = -1
        for i, p in enumerate(av):
            if (s.rbeg < p.rb or s.rbeg + s.len > p.re or s.qbeg < p.qb
                    or s.qbeg + s.len > p.qe):
                continue
            if s.len - p.seedlen0 > 0.1 * l_query:
                continue
            qd, rd = s.qbeg - p.qb, s.rbeg - p.rb
            max_gap = cal_max_gap(opt, min(qd, rd))
            w = min(max_gap, p.w)
            if qd - rd < w and rd - qd < w:
                hit = i
                break
            qd, rd = p.qe - (s.qbeg + s.len), p.re - (s.rbeg + s.len)
            max_gap = cal_max_gap(opt, min(qd, rd))
            w = min(max_gap, p.w)
            if qd - rd < w and rd - qd < w:
                hit = i
                break
        if hit >= 0:
            # check overlapping seeds in the same chain (bwamem.c:692-699)
            i = k + 1
            while i < c.n:
                if srt[i] == 0:
                    i += 1
                    continue
                t = c.seeds[srt[i] & 0xFFFFFFFF]
                if t.len < s.len * 0.95:
                    i += 1
                    continue
                if (s.qbeg <= t.qbeg and s.qbeg + s.len - t.qbeg >= s.len >> 2
                        and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                    break
                if (t.qbeg <= s.qbeg and t.qbeg + t.len - s.qbeg >= s.len >> 2
                        and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                    break
                i += 1
            if i == c.n:
                srt[k] = 0  # mark: extension not performed
                continue

        a = AlnReg()
        a.w = aw0 = aw1 = opt.w
        a.score = a.truesc = -1
        a.rid = c.rid
        qle = tle = gtle = gscore = 0

        if s.qbeg:  # left extension
            qs = np.ascontiguousarray(query[s.qbeg - 1 :: -1] if s.qbeg > 0 else query[:0])
            tmp = s.rbeg - rmax0
            rs = np.ascontiguousarray(rseq[tmp - 1 :: -1] if tmp > 0 else rseq[:0])
            for i in range(MAX_BAND_TRY):
                prev = a.score
                aw0 = opt.w << i
                (a.score, qle, tle, gtle, gscore, max_off0) = extender(
                    qs, rs, aw0, opt.pen_clip5, opt.zdrop, s.len * opt.a)
                if a.score == prev or max_off0 < (aw0 >> 1) + (aw0 >> 2):
                    break
            if gscore <= 0 or gscore <= a.score - opt.pen_clip5:  # local
                a.qb = s.qbeg - qle
                a.rb = s.rbeg - tle
                a.truesc = a.score
            else:  # to-end
                a.qb = 0
                a.rb = s.rbeg - gtle
                a.truesc = gscore
        else:
            a.score = a.truesc = s.len * opt.a
            a.qb = 0
            a.rb = s.rbeg

        if s.qbeg + s.len != l_query:  # right extension
            sc0 = a.score
            qe = s.qbeg + s.len
            re = s.rbeg + s.len - rmax0
            assert re >= 0
            for i in range(MAX_BAND_TRY):
                prev = a.score
                aw1 = opt.w << i
                (a.score, qle, tle, gtle, gscore, max_off1) = extender(
                    np.ascontiguousarray(query[qe:]),
                    np.ascontiguousarray(rseq[re:]),
                    aw1, opt.pen_clip3, opt.zdrop, sc0)
                if a.score == prev or max_off1 < (aw1 >> 1) + (aw1 >> 2):
                    break
            if gscore <= 0 or gscore <= a.score - opt.pen_clip3:  # local
                a.qe = qe + qle
                a.re = rmax0 + re + tle
                a.truesc += a.score - sc0
            else:  # to-end
                a.qe = l_query
                a.re = rmax0 + re + gtle
                a.truesc += gscore - sc0
        else:
            a.qe = l_query
            a.re = s.rbeg + s.len

        a.seedcov = 0
        for t in c.seeds:
            if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                    and t.rbeg >= a.rb and t.rbeg + t.len <= a.re):
                a.seedcov += t.len
        a.w = max(aw0, aw1)
        a.seedlen0 = s.len
        a.frac_rep = c.frac_rep
        av.append(a)


def mem_patch_reg(opt, refs, query, a: AlnReg, b: AlnReg):
    """mem_patch_reg (bwamem.c:406-435). Returns (score, w) or (0, None)."""
    from .cigar import gen_cigar

    if refs is None or query is None:
        return 0, None
    assert a.rid == b.rid and a.rb <= b.rb
    if a.rb < refs.l_pac <= b.rb:
        return 0, None
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return 0, None
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if a.re < b.rb or a.qe < b.qb:  # no overlap
        if w > opt.w << 1 or r >= PATCH_MAX_R_BW:
            return 0, None
    elif w > opt.w << 2 or r >= PATCH_MAX_R_BW * 2:
        return 0, None
    w += a.w + b.w
    w = min(w, opt.w << 2)
    score, _, _, _ = gen_cigar(opt, refs, query[a.qb : b.qe], a.rb, b.re,
                               want_cigar=False)
    if score is None:
        return 0, None
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb)) * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb)) * (b.score + a.score) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return 0, None
    return score, w


def mem_sort_dedup_patch(opt, refs, query, a: List[AlnReg]) -> List[AlnReg]:
    """mem_sort_dedup_patch (bwamem.c:437-489)."""
    n = len(a)
    if n <= 1:
        return a
    ks_introsort(a, lambda x, y: x.re < y.re)  # sort by END
    for p in a:
        p.n_comp = 1
    for i in range(1, n):
        p = a[i]
        if p.rid != a[i - 1].rid or p.rb >= a[i - 1].re + opt.max_chain_gap:
            continue
        j = i - 1
        while j >= 0 and p.rid == a[j].rid and p.rb < a[j].re + opt.max_chain_gap:
            q = a[j]
            if q.qe == q.qb:
                j -= 1
                continue
            o_r = q.re - p.rb
            oq = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            mr = min(q.re - q.rb, p.re - p.rb)
            mq = min(q.qe - q.qb, p.qe - p.qb)
            if (_fcmp_gt(o_r, opt.mask_level_redun, mr)
                    and _fcmp_gt(oq, opt.mask_level_redun, mq)):
                if p.score < q.score:
                    p.qe = p.qb
                    break
                else:
                    q.qe = q.qb
            elif q.rb < p.rb:
                score, w = mem_patch_reg(opt, refs, query, q, p)
                if score > 0:
                    p.n_comp += q.n_comp + 1
                    p.seedcov = max(p.seedcov, q.seedcov)
                    p.sub = max(p.sub, q.sub)
                    p.csub = max(p.csub, q.csub)
                    p.qb, p.rb = q.qb, q.rb
                    p.truesc = p.score = score
                    p.w = w
                    q.qb = q.qe
            j -= 1
    a = [p for p in a if p.qe > p.qb]
    ks_introsort(a, lambda x, y: x.score > y.score or (
        x.score == y.score and (x.rb < y.rb or (x.rb == y.rb and x.qb < y.qb))))
    for i in range(1, len(a)):
        if (a[i].score == a[i - 1].score and a[i].rb == a[i - 1].rb
                and a[i].qb == a[i - 1].qb):
            a[i].qe = a[i].qb
    out = a[:1] + [p for p in a[1:] if p.qe > p.qb]
    return out


def _mark_primary_core(opt, a: List[AlnReg], n: int):
    """mem_mark_primary_se_core (bwamem.c:493-519) over a[:n]."""
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z = [0]
    for i in range(1, n):
        found = -1
        for k_i, j in enumerate(z):
            b_max = max(a[j].qb, a[i].qb)
            e_min = min(a[j].qe, a[i].qe)
            if e_min > b_max:
                min_l = min(a[i].qe - a[i].qb, a[j].qe - a[j].qb)
                if _fcmp_ge(e_min - b_max, opt.mask_level, min_l):
                    if a[j].sub == 0:
                        a[j].sub = a[i].score
                    if a[j].score - a[i].score <= tmp and (a[j].is_alt or not a[i].is_alt):
                        a[j].sub_n += 1
                    found = j
                    break
        if found < 0:
            z.append(i)
        else:
            a[i].secondary = found


def mem_mark_primary_se(opt, a: List[AlnReg], id_: int) -> int:
    """mem_mark_primary_se (bwamem.c:521-558). Returns n_pri."""
    n = len(a)
    if n == 0:
        return 0
    n_pri = 0
    for i, p in enumerate(a):
        p.sub = p.alt_sc = 0
        p.secondary = p.secondary_all = -1
        p.hash = hash_64((id_ + i) & 0xFFFFFFFFFFFFFFFF)
        if not p.is_alt:
            n_pri += 1
    ks_introsort(a, lambda x, y: x.score > y.score or (
        x.score == y.score and (x.is_alt < y.is_alt or (
            x.is_alt == y.is_alt and x.hash < y.hash))))
    _mark_primary_core(opt, a, n)
    for i, p in enumerate(a):
        p.secondary_all = i
        if not p.is_alt and p.secondary >= 0 and a[p.secondary].is_alt:
            p.alt_sc = a[p.secondary].score
    if 0 <= n_pri < n:
        if n_pri > 0:
            ks_introsort(a, lambda x, y: x.is_alt < y.is_alt or (
                x.is_alt == y.is_alt and (x.score > y.score or (
                    x.score == y.score and x.hash < y.hash))))
        z = [0] * n
        for i in range(n):
            z[a[i].secondary_all] = i
        for i in range(n):
            if a[i].secondary >= 0:
                a[i].secondary_all = z[a[i].secondary]
                if a[i].is_alt:
                    a[i].secondary = INT_MAX
            else:
                a[i].secondary_all = -1
        if n_pri > 0:
            for i in range(n_pri):
                a[i].sub = 0
                a[i].secondary = -1
            _mark_primary_core(opt, a, n_pri)
    else:
        for p in a:
            p.secondary_all = p.secondary
    return n_pri


def mem_approx_mapq_se(opt, a: AlnReg) -> int:
    """mem_approx_mapq_se (bwamem.c:952-976)."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    l = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - (l * opt.a - a.score) / (opt.a + opt.b) / l
    if a.score == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1.0 if l < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    else:
        mapq = int(MEM_MAPQ_COEF * (1.0 - sub / a.score) * math.log(a.seedcov) + 0.499)
        mapq = int(mapq * identity * identity + 0.499) if identity < 0.95 else mapq
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    mapq = int(mapq * (1.0 - a.frac_rep) + 0.499)
    return mapq


def mem_reorder_primary5(T: int, a: List[AlnReg]):
    """mem_reorder_primary5 (bwamem.c:978-1000)."""
    n_pri = sum(1 for p in a if p.secondary < 0 and not p.is_alt and p.score >= T)
    if n_pri <= 1:
        return
    left_st, left_k = INT_MAX, -1
    for k, p in enumerate(a):
        if p.secondary >= 0 or p.is_alt or p.score < T:
            continue
        if p.qb < left_st:
            left_st, left_k = p.qb, k
    assert a[0].secondary < 0
    if left_k == 0:
        return
    a[0], a[left_k] = a[left_k], a[0]
    for k in range(1, len(a)):
        p = a[k]
        if p.secondary == 0:
            p.secondary = left_k
        elif p.secondary == left_k:
            p.secondary = 0
        if p.secondary_all == 0:
            p.secondary_all = left_k
        elif p.secondary_all == left_k:
            p.secondary_all = 0
