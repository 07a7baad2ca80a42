"""Paired-end machinery: insert-size stats, mate rescue, pairing, PE SAM.

Semantics of bwamem_pair.c.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from . import opts as O
from .extend import KSW_XBYTE, KSW_XSTART, KSW_XSTOP, KSW_XSUBO, ksw_align2
from .region import AlnReg, mem_approx_mapq_se, mem_mark_primary_se, \
    mem_reorder_primary5, mem_sort_dedup_patch
from .sam import Aln, mem_aln2sam, mem_gen_alt, mem_reg2aln, mem_reg2sam
from .sortutil import hash_64, introsort_128, introsort_64

# Optional batched mate-rescue cache (set by the device pipeline): maps
# (seq_bytes, ref_bytes, xtra) -> KswR-shaped tuple. Misses fall through to
# the scalar striped kernel.
import threading as _threading

_TLS = _threading.local()


def set_sw_cache(cache):
    _TLS.sw_cache = cache


MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0
INT_MAX = 2**31 - 1


@dataclasses.dataclass
class PEStat:
    """mem_pestat_t (bwamem.h:84-88)."""

    low: int = 0
    high: int = 0
    failed: int = 0
    avg: float = 0.0
    std: float = 0.0


def mem_infer_dir(l_pac: int, b1: int, b2: int) -> Tuple[int, int]:
    """mem_infer_dir (bwamem_pair.c:23-30): returns (dir, dist)."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


def _cal_sub(opt, r: List[AlnReg]) -> int:
    """cal_sub (bwamem_pair.c:32-44)."""
    for j in range(1, len(r)):
        b_max = max(r[j].qb, r[0].qb)
        e_min = min(r[j].qe, r[0].qe)
        if e_min > b_max:
            min_l = min(r[j].qe - r[j].qb, r[0].qe - r[0].qb)
            # float32 arithmetic as in C (int >= int * float)
            if np.float32(e_min - b_max) >= np.float32(
                    np.float32(min_l) * np.float32(opt.mask_level)):
                return r[j].score
    return opt.min_seed_len * opt.a


def mem_pestat(opt, l_pac: int, regs: List[List[AlnReg]], verbose=None
               ) -> List[PEStat]:
    """mem_pestat (bwamem_pair.c:46-109), incl. the verbose>=3 stderr
    analytics (percentiles/mean/std per orientation)."""
    import sys

    from . import opts as _O

    if verbose is None:
        verbose = _O.bwa_verbose >= 3
    pes = [PEStat() for _ in range(4)]
    isize: List[List[int]] = [[], [], [], []]
    n = len(regs)
    for i in range(n >> 1):
        r0, r1 = regs[i << 1], regs[(i << 1) | 1]
        if not r0 or not r1:
            continue
        if _cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if _cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        if r0[0].rid != r1[0].rid:
            continue
        d, dist = mem_infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if dist and dist <= opt.max_ins:
            isize[d].append(dist)
    return pestat_from_isize(isize, verbose)


def pestat_from_isize(isize, verbose=None) -> List[PEStat]:
    """Percentile/refinement half of mem_pestat over collected
    per-orientation insert sizes (bwamem_pair.c:58-100 analytics incl. the
    verbose>=3 stderr lines); also serves the native (C) collector."""
    import sys

    from . import opts as _O

    if verbose is None:
        verbose = _O.bwa_verbose >= 3
    pes = [PEStat() for _ in range(4)]
    if verbose:
        print("[M::mem_pestat] # candidate unique pairs for (FF, FR, RF, "
              "RR): (%d, %d, %d, %d)" % tuple(len(x) for x in isize),
              file=sys.stderr)

    def _dirname(d):
        return "FR"[(d >> 1) & 1] + "FR"[d & 1]

    for d in range(4):
        r = pes[d]
        q = isize[d]
        if len(q) < MIN_DIR_CNT:
            r.failed = 1
            if verbose:
                print(f"[M::mem_pestat] skip orientation {_dirname(d)} as "
                      "there are not enough pairs", file=sys.stderr)
            continue
        if verbose:
            print("[M::mem_pestat] analyzing insert size distribution for "
                  f"orientation {_dirname(d)}...", file=sys.stderr)
        introsort_64(q)
        p25 = q[int(0.25 * len(q) + 0.499)]
        p50 = q[int(0.50 * len(q) + 0.499)]
        p75 = q[int(0.75 * len(q) + 0.499)]
        if verbose:
            print("[M::mem_pestat] (25, 50, 75) percentile: "
                  f"({p25}, {p50}, {p75})", file=sys.stderr)
        r.low = int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499)
        if r.low < 1:
            r.low = 1
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        if verbose:
            print("[M::mem_pestat] low and high boundaries for computing "
                  f"mean and std.dev: ({r.low}, {r.high})", file=sys.stderr)
        x = 0
        s = 0.0
        for v in q:
            if r.low <= v <= r.high:
                s += v
                x += 1
        r.avg = s / x
        s = 0.0
        for v in q:
            if r.low <= v <= r.high:
                s += (v - r.avg) * (v - r.avg)
        r.std = math.sqrt(s / x)
        if verbose:
            print(f"[M::mem_pestat] mean and std.dev: ({r.avg:.2f}, "
                  f"{r.std:.2f})", file=sys.stderr)
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        if r.low > r.avg - MAX_STDDEV * r.std:
            r.low = int(r.avg - MAX_STDDEV * r.std + 0.499)
        if r.high < r.avg + MAX_STDDEV * r.std:
            r.high = int(r.avg + MAX_STDDEV * r.std + 0.499)
        if r.low < 1:
            r.low = 1
        if verbose:
            print("[M::mem_pestat] low and high boundaries for proper "
                  f"pairs: ({r.low}, {r.high})", file=sys.stderr)
    mx = max(len(x) for x in isize)
    for d in range(4):
        if pes[d].failed == 0 and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = 1
            if verbose:
                print(f"[M::mem_pestat] skip orientation {_dirname(d)}",
                      file=sys.stderr)
    return pes


class _SWHit:
    __slots__ = ("score", "te", "qe", "score2", "te2", "tb", "qb")

    def __init__(self, score, te, qe, score2, te2, tb, qb):
        self.score = score
        self.te = te
        self.qe = qe
        self.score2 = score2
        self.te2 = te2
        self.tb = tb
        self.qb = qb


def mem_matesw(opt, refs, pes: List[PEStat], a: AlnReg, l_ms: int,
               ms: np.ndarray, ma: List[AlnReg]) -> int:
    """mem_matesw (bwamem_pair.c:111-180). Mutates ma; returns #SW performed."""
    l_pac = refs.l_pac
    skip = [1 if pes[r].failed else 0 for r in range(4)]
    for p in ma:
        r, dist = mem_infer_dir(l_pac, a.rb, p.rb)
        if pes[r].low <= dist <= pes[r].high:
            skip[r] = 1
    if sum(skip) == 4:
        return 0
    n = 0
    seq_rev = None  # computed at most once per call
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if is_rev:
            if seq_rev is None:
                seq_rev = np.where(ms < 4, 3 - ms, 4)[::-1].astype(np.uint8)
            seq = seq_rev
        else:
            seq = ms
        if not is_rev:
            rb = a.rb + pes[r].low if is_larger else a.rb - pes[r].high
            re = (a.rb + pes[r].high if is_larger else a.rb - pes[r].low) + l_ms
        else:
            rb = (a.rb + pes[r].low if is_larger else a.rb - pes[r].high) - l_ms
            re = a.rb + pes[r].high if is_larger else a.rb - pes[r].low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        rid = -1
        ref = None
        if rb < re:
            ref, rid, rb, re = refs.fetch_seq(rb, (rb + re) >> 1, re)
        if a.rid == rid and re - rb >= opt.min_seed_len:
            xtra = (KSW_XSUBO | KSW_XSTART
                    | (KSW_XBYTE if l_ms * opt.a < 250 else 0)
                    | (opt.min_seed_len * opt.a))
            aln = None
            _sw_cache = getattr(_TLS, "sw_cache", None)
            if _sw_cache is not None:
                hit = _sw_cache.get((seq.tobytes(), ref.tobytes(), xtra))
                if hit is not None:
                    aln = _SWHit(*hit)
            if aln is None:
                aln = ksw_align2(seq, ref, opt.mat, opt.o_del, opt.e_del,
                                 opt.o_ins, opt.e_ins, xtra)
            if aln.score >= opt.min_seed_len and aln.qb >= 0:
                b = AlnReg()
                b.rid = a.rid
                b.is_alt = a.is_alt
                b.qb = l_ms - (aln.qe + 1) if is_rev else aln.qb
                b.qe = l_ms - aln.qb if is_rev else aln.qe + 1
                b.rb = ((l_pac << 1) - (rb + aln.te + 1)) if is_rev else rb + aln.tb
                b.re = ((l_pac << 1) - (rb + aln.tb)) if is_rev else rb + aln.te + 1
                b.score = aln.score
                b.csub = aln.score2
                b.secondary = -1
                b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
                # insertion sort into ma by score (bwamem_pair.c:165-171)
                ins = len(ma)
                for i in range(len(ma)):
                    if ma[i].score < b.score:
                        ins = i
                        break
                ma.insert(ins, b)
            n += 1
        if n:
            ma[:] = mem_sort_dedup_patch(opt, None, None, ma)
    return n


def mem_pair(opt, refs, pes: List[PEStat], a: List[List[AlnReg]], id_: int,
             n_pri: List[int]) -> Tuple[int, int, int, List[int]]:
    """mem_pair (bwamem_pair.c:182-243): returns (o, sub, n_sub, z)."""
    l_pac = refs.l_pac
    v: List[Tuple[int, int]] = []
    for r in range(2):
        for i in range(n_pri[r]):
            e = a[r][i]
            key_x = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            key_x = (e.rid << 32) | (key_x - refs.anns[e.rid].offset)
            key_y = (e.score << 32) | (i << 2) | ((1 if e.rb >= l_pac else 0) << 1) | r
            v.append((key_x, key_y))
    introsort_128(v)
    y = [-1, -1, -1, -1]
    u: List[Tuple[int, int]] = []
    z = [-1, -1]
    for i in range(len(v)):
        for r in range(2):
            dir_ = (r << 1) | ((v[i][1] >> 1) & 1)
            if pes[dir_].failed:
                continue
            which = (r << 1) | ((v[i][1] & 1) ^ 1)
            if y[which] < 0:
                continue
            for k in range(y[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[dir_].high:
                    break
                if dist < pes[dir_].low:
                    continue
                ns = (dist - pes[dir_].avg) / pes[dir_].std
                q = int((v[i][1] >> 32) + (v[k][1] >> 32)
                        + 0.721 * math.log(2.0 * math.erfc(abs(ns) * (2 ** -0.5)))
                        * opt.a + 0.499)
                if q < 0:
                    q = 0
                pair_y = (k << 32) | i
                pair_x = (q << 32) | (hash_64((pair_y ^ (id_ << 8)) & 0xFFFFFFFFFFFFFFFF)
                                      & 0xFFFFFFFF)
                u.append((pair_x, pair_y))
        y[v[i][1] & 3] = i
    if u:
        tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
        introsort_128(u)
        i = u[-1][1] >> 32
        k = u[-1][1] & 0xFFFFFFFF
        # C's v.a[i].y<<32>>34 extracts bits [2,32) of y: the region index
        z[v[i][1] & 1] = (v[i][1] & 0xFFFFFFFF) >> 2
        z[v[k][1] & 1] = (v[k][1] & 0xFFFFFFFF) >> 2
        o = u[-1][0] >> 32
        sub = (u[-2][0] >> 32) if len(u) > 1 else 0
        n_sub = 0
        for i in range(len(u) - 2, -1, -1):
            if sub - (u[i][0] >> 32) <= tmp:
                n_sub += 1
        return o, sub, n_sub, z
    return 0, 0, 0, z


def raw_mapq(diff: int, a: int) -> int:
    return int(6.02 * diff / a + 0.499)


def mem_sam_pe(opt, refs, pes: List[PEStat], id_: int, s: List, a: List[List[AlnReg]],
               rg_id: str = "") -> int:
    """mem_sam_pe (bwamem_pair.c:250-393): writes s[0].sam and s[1].sam."""
    n = 0
    if not (opt.flag & O.MEM_F_NO_RESCUE):
        b: List[List[AlnReg]] = [[], []]
        for i in range(2):
            for reg in a[i]:
                if reg.score >= a[i][0].score - opt.pen_unpaired:
                    b[i].append(reg)
        for i in range(2):
            for j in range(min(len(b[i]), opt.max_matesw)):
                n += mem_matesw(opt, refs, pes, b[i][j], s[1 - i].l_seq,
                                s[1 - i].seq, a[1 - i])
    n_pri = [mem_mark_primary_se(opt, a[0], ((id_ << 1) | 0) & 0xFFFFFFFFFFFFFFFF),
             mem_mark_primary_se(opt, a[1], ((id_ << 1) | 1) & 0xFFFFFFFFFFFFFFFF)]
    if opt.flag & O.MEM_F_PRIMARY5:
        mem_reorder_primary5(opt.T, a[0])
        mem_reorder_primary5(opt.T, a[1])
    if not (opt.flag & O.MEM_F_NOPAIRING):
        o = sub = n_sub = 0
        z = [-1, -1]
        if n_pri[0] and n_pri[1]:
            o, sub, n_sub, z = mem_pair(opt, refs, pes, a, id_, n_pri)
        if n_pri[0] and n_pri[1] and o > 0:
            # multiple-hit check
            is_multi = [False, False]
            for i in range(2):
                found = False
                for j in range(1, n_pri[i]):
                    if a[i][j].secondary < 0 and a[i][j].score >= opt.T:
                        found = True
                        break
                is_multi[i] = found
            if not (is_multi[0] or is_multi[1]):
                extra_flag = 1
                score_un = a[0][0].score + a[1][0].score - opt.pen_unpaired
                sub = max(sub, score_un)
                q_pe = raw_mapq(o - sub, opt.a)
                if n_sub > 0:
                    q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
                q_pe = max(0, min(60, q_pe))
                q_pe = int(q_pe * (1.0 - 0.5 * (a[0][0].frac_rep + a[1][0].frac_rep))
                           + 0.499)
                if o > score_un:  # paired alignment preferred
                    c = [a[0][z[0]], a[1][z[1]]]
                    q_se = [0, 0]
                    for i in range(2):
                        if c[i].secondary >= 0:
                            c[i].sub = a[i][c[i].secondary].score
                            c[i].secondary = -2
                        q_se[i] = mem_approx_mapq_se(opt, c[i])
                    for i in range(2):
                        if q_se[i] < q_pe:
                            q_se[i] = q_pe if q_pe < q_se[i] + 40 else q_se[i] + 40
                    extra_flag |= 2
                    q_se[0] = min(q_se[0], raw_mapq(c[0].score - c[0].csub, opt.a))
                    q_se[1] = min(q_se[1], raw_mapq(c[1].score - c[1].csub, opt.a))
                else:
                    z = [0, 0]
                    q_se = [mem_approx_mapq_se(opt, a[0][0]),
                            mem_approx_mapq_se(opt, a[1][0])]
                # switch secondary and primary if both non-ALT (pair.c:324-333)
                for i in range(2):
                    k = a[i][z[i]].secondary_all
                    if 0 <= k < n_pri[i]:
                        assert a[i][k].secondary_all < 0
                        for j in range(len(a[i])):
                            if a[i][j].secondary_all == k or j == k:
                                a[i][j].secondary_all = z[i]
                        a[i][z[i]].secondary_all = -1
                XA = [None, None]
                if not (opt.flag & O.MEM_F_ALL):
                    for i in range(2):
                        XA[i] = mem_gen_alt(opt, refs, a[i], s[i].l_seq, s[i].seq)
                h = [None, None]
                aa: List[List[Aln]] = [[], []]
                for i in range(2):
                    h[i] = mem_reg2aln(opt, refs, s[i].l_seq, s[i].seq, a[i][z[i]])
                    h[i].mapq = q_se[i]
                    h[i].flag |= (0x40 << i) | extra_flag
                    h[i].XA = XA[i][z[i]] if XA[i] else None
                    aa[i].append(h[i])
                    if n_pri[i] < len(a[i]):
                        p = a[i][n_pri[i]]
                        if p.score < opt.T or p.secondary >= 0 or not p.is_alt:
                            continue
                        g = mem_reg2aln(opt, refs, s[i].l_seq, s[i].seq, p)
                        g.flag |= 0x800 | (0x40 << i) | extra_flag
                        g.XA = XA[i][n_pri[i]] if XA[i] else None
                        aa[i].append(g)
                lines0 = [mem_aln2sam(opt, refs, s[0], len(aa[0]), aa[0], i, h[1], rg_id)
                          for i in range(len(aa[0]))]
                s[0].sam = "".join(lines0)
                lines1 = [mem_aln2sam(opt, refs, s[1], len(aa[1]), aa[1], i, h[0], rg_id)
                          for i in range(len(aa[1]))]
                s[1].sam = "".join(lines1)
                assert s[0].name == s[1].name
                return n
    # no_pairing (bwamem_pair.c:371-392)
    extra_flag = 1
    h = [None, None]
    for i in range(2):
        which = -1
        if a[i]:
            if a[i][0].score >= opt.T:
                which = 0
            elif n_pri[i] < len(a[i]) and a[i][n_pri[i]].score >= opt.T:
                which = n_pri[i]
        if which >= 0:
            h[i] = mem_reg2aln(opt, refs, s[i].l_seq, s[i].seq, a[i][which])
        else:
            h[i] = mem_reg2aln(opt, refs, s[i].l_seq, s[i].seq, None)
    if (not (opt.flag & O.MEM_F_NOPAIRING) and h[0].rid == h[1].rid >= 0):
        d, dist = mem_infer_dir(refs.l_pac, a[0][0].rb, a[1][0].rb)
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            extra_flag |= 2
    s[0].sam = mem_reg2sam(opt, refs, s[0], a[0], 0x41 | extra_flag, h[1], rg_id)
    s[1].sam = mem_reg2sam(opt, refs, s[1], a[1], 0x81 | extra_flag, h[0], rg_id)
    assert s[0].name == s[1].name
    return n
