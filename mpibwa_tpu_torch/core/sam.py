"""SAM record generation: mem_reg2aln / mem_aln2sam / mem_gen_alt / mem_reg2sam.

Semantics of bwamem.c:792-946, 1003-1049 and bwamem_extra.c:90-140.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional

import numpy as np

from . import opts as O
from .cigar import gen_cigar
from .region import AlnReg, mem_approx_mapq_se

INT_MAX = 2**31 - 1
CIGAR_OPS = "MIDSH"
CIGAR_OPS_XA = "MIDSHN"

_FWD_LUT = np.frombuffer(b"ACGTN", np.uint8)
_REV_LUT = np.frombuffer(b"TGCAN", np.uint8)


def _seq_str(s, qb: int, qe: int, rev: bool) -> str:
    """SEQ field text (forward or reverse-complement slice), via cached
    numpy byte translation — the per-base python join was the hottest part
    of SAM emission."""
    cache = getattr(s, "_sam_seq_cache", None)
    if cache is None:
        arr = np.minimum(s.seq, 4)
        cache = (_FWD_LUT[arr].tobytes().decode("ascii"),
                 _REV_LUT[arr[::-1]].tobytes().decode("ascii"))
        try:
            s._sam_seq_cache = cache
        except AttributeError:
            pass
    if not rev:
        return cache[0][qb:qe]
    L = len(cache[0])
    return cache[1][L - qe : L - qb]


@dataclasses.dataclass
class Aln:
    """mem_aln_t (bwamem.h:90-101)."""

    pos: int = 0
    rid: int = -1
    flag: int = 0
    is_rev: int = 0
    is_alt: int = 0
    mapq: int = 0
    NM: int = 0
    cigar: Optional[List] = None  # [(len, op)]
    md: Optional[str] = None
    XA: Optional[str] = None
    score: int = 0
    sub: int = 0
    alt_sc: int = 0

    @property
    def n_cigar(self):
        return len(self.cigar) if self.cigar else 0


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    """infer_bw (bwamem.c:792-799)."""
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def get_rlen(cigar) -> int:
    return sum(ln for ln, op in cigar or [] if op in (0, 2))


def mem_reg2aln(opt, refs, l_query: int, query: np.ndarray,
                ar: Optional[AlnReg]) -> Aln:
    """mem_reg2aln (bwamem.c:1089-1159)."""
    a = Aln()
    if ar is None or ar.rb < 0 or ar.re < 0:
        a.rid = -1
        a.pos = -1
        a.flag |= 0x4
        return a
    qb, qe = ar.qb, ar.qe
    rb, re = ar.rb, ar.re
    a.mapq = mem_approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    tmp = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del)
    w2 = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins)
    w2 = max(w2, tmp)
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    i = 0
    last_sc = -(1 << 30)
    while True:
        w2 = min(w2, opt.w << 2)
        score, cigar, md, NM = gen_cigar(opt, refs, query[qb:qe], rb, re, w2)
        if score == last_sc or w2 == opt.w << 2:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if not (i < 3 and score < ar.truesc - opt.a):
            break
    a.cigar = list(cigar) if cigar else []
    a.md = md
    a.NM = NM
    pos, is_rev = refs.depos(rb if rb < refs.l_pac else re - 1)
    a.is_rev = is_rev
    if a.cigar:  # squeeze leading/trailing deletions
        if a.cigar[0][1] == 2:
            pos += a.cigar[0][0]
            a.cigar = a.cigar[1:]
        elif a.cigar[-1][1] == 2:
            a.cigar = a.cigar[:-1]
    if qb != 0 or qe != l_query:  # soft clips
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            a.cigar = [(clip5, 3)] + a.cigar
        if clip3:
            a.cigar = a.cigar + [(clip3, 3)]
    a.rid = refs.pos2rid(pos)
    assert a.rid == ar.rid
    a.pos = pos - refs.anns[a.rid].offset
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    a.is_alt = ar.is_alt
    a.alt_sc = ar.alt_sc
    return a


def _add_cigar(opt, p: Aln, which: int, out: List[str]):
    """add_cigar (bwamem.c:812-823)."""
    if p.n_cigar:
        for ln, c in p.cigar:
            if not (opt.flag & O.MEM_F_SOFTCLIP) and not p.is_alt and c in (3, 4):
                c = 4 if which else 3
            out.append(f"{ln}{CIGAR_OPS[c]}")
    else:
        out.append("*")


def mem_aln2sam(opt, refs, s, n: int, alns: List[Aln], which: int,
                m_: Optional[Aln], rg_id: str = "") -> str:
    """mem_aln2sam (bwamem.c:825-946). Returns one SAM line (with newline)."""
    # shallow copies (copy.copy is ~10x cheaper than dataclasses.replace
    # and this runs 2-4x per SAM record)
    p = copy.copy(alns[which])
    p.cigar = list(alns[which].cigar) if alns[which].cigar else alns[which].cigar
    m = copy.copy(m_) if m_ is not None else None

    p.flag |= 0x1 if m else 0
    p.flag |= 0x4 if p.rid < 0 else 0
    p.flag |= 0x8 if (m and m.rid < 0) else 0
    if p.rid < 0 and m and m.rid >= 0:
        p.rid, p.pos, p.is_rev = m.rid, m.pos, m.is_rev
        p.cigar = []
    if m and m.rid < 0 and p.rid >= 0:
        m.rid, m.pos, m.is_rev = p.rid, p.pos, p.is_rev
        m.cigar = []
    p.flag |= 0x10 if p.is_rev else 0
    p.flag |= 0x20 if (m and m.is_rev) else 0

    out: List[str] = []
    out.append(s.name)
    out.append("\t")
    out.append(str((p.flag & 0xFFFF) | (0x100 if p.flag & 0x10000 else 0)))
    out.append("\t")
    if p.rid >= 0:
        out.append(refs.anns[p.rid].name)
        out.append("\t")
        out.append(str(p.pos + 1))
        out.append("\t")
        out.append(str(p.mapq))
        out.append("\t")
        _add_cigar(opt, p, which, out)
    else:
        out.append("*\t0\t0\t*")
    out.append("\t")

    if m and m.rid >= 0:
        out.append("=" if p.rid == m.rid else refs.anns[m.rid].name)
        out.append("\t")
        out.append(str(m.pos + 1))
        out.append("\t")
        if p.rid == m.rid:
            p0 = p.pos + (get_rlen(p.cigar) - 1 if p.is_rev else 0)
            p1 = m.pos + (get_rlen(m.cigar) - 1 if m.is_rev else 0)
            if m.n_cigar == 0 or p.n_cigar == 0:
                out.append("0")
            else:
                sign = 1 if p0 > p1 else (-1 if p0 < p1 else 0)
                out.append(str(-(p0 - p1 + sign)))
        else:
            out.append("0")
    else:
        out.append("*\t0\t0")
    out.append("\t")

    # SEQ and QUAL
    if p.flag & 0x100:
        out.append("*\t*")
    else:
        qb, qe = 0, s.l_seq
        if (p.n_cigar and which and not (opt.flag & O.MEM_F_SOFTCLIP)
                and not p.is_alt):
            if not p.is_rev:
                if p.cigar[0][1] in (3, 4):
                    qb += p.cigar[0][0]
                if p.cigar[-1][1] in (3, 4):
                    qe -= p.cigar[-1][0]
            else:
                if p.cigar[0][1] in (3, 4):
                    qe -= p.cigar[0][0]
                if p.cigar[-1][1] in (3, 4):
                    qb += p.cigar[-1][0]
        if not p.is_rev:
            out.append(_seq_str(s, qb, qe, False))
            out.append("\t")
            out.append(s.qual[qb:qe] if s.qual else "*")
        else:
            out.append(_seq_str(s, qb, qe, True))
            out.append("\t")
            out.append(s.qual[qb:qe][::-1] if s.qual else "*")

    if p.n_cigar:
        out.append("\tNM:i:")
        out.append(str(p.NM))
        out.append("\tMD:Z:")
        out.append(p.md)
    if m and m.n_cigar:
        out.append("\tMC:Z:")
        _add_cigar(opt, m, which, out)
    if p.score >= 0:
        out.append("\tAS:i:")
        out.append(str(p.score))
    if p.sub >= 0:
        out.append("\tXS:i:")
        out.append(str(p.sub))
    if rg_id:
        out.append("\tRG:Z:")
        out.append(rg_id)
    if not (p.flag & 0x100):
        has_other = any(i != which and not (alns[i].flag & 0x100) for i in range(n))
        if has_other:
            out.append("\tSA:Z:")
            for i in range(n):
                r = alns[i]
                if i == which or (r.flag & 0x100):
                    continue
                out.append(refs.anns[r.rid].name)
                out.append(",")
                out.append(str(r.pos + 1))
                out.append(",")
                out.append("+-"[r.is_rev])
                out.append(",")
                for ln, c in r.cigar:
                    out.append(f"{ln}{CIGAR_OPS[c]}")
                out.append(",")
                out.append(str(r.mapq))
                out.append(",")
                out.append(str(r.NM))
                out.append(";")
        if p.alt_sc > 0:
            out.append(f"\tpa:f:{p.score / p.alt_sc:.3f}")
    if p.XA:
        out.append("\tXA:Z:")
        out.append(p.XA)
    if s.comment:
        out.append("\t")
        out.append(s.comment)
    if (opt.flag & O.MEM_F_REF_HDR) and p.rid >= 0 and refs.anns[p.rid].anno:
        out.append("\tXR:Z:")
        out.append(refs.anns[p.rid].anno.replace("\t", " "))
    out.append("\n")
    return "".join(out)


def _get_pri_idx(xa_drop_ratio: float, a: List[AlnReg], i: int) -> int:
    k = a[i].secondary_all
    if k >= 0 and a[i].score >= a[k].score * xa_drop_ratio:
        return k
    return -1


def mem_gen_alt(opt, refs, a: List[AlnReg], l_query: int, query) -> Optional[List[str]]:
    """mem_gen_alt (bwamem_extra.c:98-140): XA strings keyed by primary index."""
    n = len(a)
    cnt = [0] * n
    has_alt = [False] * n
    tot = 0
    for i in range(n):
        r = _get_pri_idx(opt.XA_drop_ratio, a, i)
        if r >= 0:
            cnt[r] += 1
            tot += 1
            if a[i].is_alt:
                has_alt[r] = True
    if tot == 0:
        return None
    aln = [""] * n
    for i in range(n):
        r = _get_pri_idx(opt.XA_drop_ratio, a, i)
        if r < 0:
            continue
        if cnt[r] > opt.max_XA_hits_alt or (not has_alt[r] and cnt[r] > opt.max_XA_hits):
            continue
        t = mem_reg2aln(opt, refs, l_query, query, a[i])
        parts = [refs.anns[t.rid].name, ",", "+-"[t.is_rev], str(t.pos + 1), ","]
        for ln, c in t.cigar:
            parts.append(f"{ln}{CIGAR_OPS_XA[c]}")
        parts.append(",")
        parts.append(str(t.NM))
        parts.append(";")
        aln[r] += "".join(parts)
    return aln


def mem_reg2sam(opt, refs, s, a: List[AlnReg], extra_flag: int,
                m: Optional[Aln], rg_id: str = "") -> str:
    """mem_reg2sam (bwamem.c:1003-1049). Returns concatenated SAM lines."""
    XA = None
    if not (opt.flag & O.MEM_F_ALL):
        XA = mem_gen_alt(opt, refs, a, s.l_seq, s.seq)
    aa: List[Aln] = []
    lines = []
    ln_cnt = 0
    for k, p in enumerate(a):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt or not (opt.flag & O.MEM_F_ALL)):
            continue
        if (p.secondary >= 0 and p.secondary < INT_MAX
                and np.float32(p.score) < np.float32(
                    np.float32(a[p.secondary].score) * np.float32(opt.drop_ratio))):
            continue
        q = mem_reg2aln(opt, refs, s.l_seq, s.seq, p)
        assert q.rid >= 0
        q.XA = XA[k] if XA else None
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1
        if ln_cnt and p.secondary < 0:
            q.flag |= 0x10000 if (opt.flag & O.MEM_F_NO_MULTI) else 0x800
        if (not (opt.flag & O.MEM_F_KEEP_SUPP_MAPQ) and ln_cnt and not p.is_alt
                and q.mapq > aa[0].mapq):
            q.mapq = aa[0].mapq
        aa.append(q)
        ln_cnt += 1
    if not aa:
        t = mem_reg2aln(opt, refs, s.l_seq, s.seq, None)
        t.flag |= extra_flag
        lines.append(mem_aln2sam(opt, refs, s, 1, [t], 0, m, rg_id))
    else:
        for k in range(len(aa)):
            lines.append(mem_aln2sam(opt, refs, s, len(aa), aa, k, m, rg_id))
    return "".join(lines)
