"""Smith-Waterman kernels with exact ksw.c semantics (host spec engine).

Row-vectorized NumPy implementations of:
  - ksw_extend2  (ksw.c:380-479): banded affine-gap seed
    extension with z-drop, end-bonus, adaptive band trimming.
  - ksw_global2  (ksw.c:504-606): banded global alignment
    with traceback (CIGAR).
  - ksw_align2 + striped u8/i16 kernels (ksw.c:63-365):
    local SW with second-best tracking used for mate rescue.

Key structural fact exploited here and by the device kernels: in extend2 and
global2, E(i+1,j) and F(i,j+1) both derive from M(i,j) (the diagonal path),
which depends only on row i-1 — so a row is computable in parallel given the
previous row, with F obtained by a max-plus prefix scan over M of the same
row. In the striped kernels E/F derive from H, but the same scan stays exact
because o_ins >= 0 (an H=F cell re-opening a gap can never beat extending).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

MINUS_INF = -0x40000000

# xtra flag bits (ksw.h:6-9)
KSW_XBYTE = 0x10000
KSW_XSTOP = 0x20000
KSW_XSUBO = 0x40000
KSW_XSTART = 0x80000


def _maxscan_decay(t: np.ndarray, decay: int) -> np.ndarray:
    """out[j] = max_{k<=j} (t[k] - (j-k)*decay), vectorized O(n log n)."""
    out = t.astype(np.int64).copy()
    shift = 1
    n = len(out)
    while shift < n:
        cand = out[:-shift] - shift * decay
        out[shift:] = np.maximum(out[shift:], cand)
        shift <<= 1
    return out


def ksw_extend2(qseq: np.ndarray, tseq: np.ndarray, mat: np.ndarray,
                o_del: int, e_del: int, o_ins: int, e_ins: int,
                w: int, end_bonus: int, zdrop: int, h0: int
                ) -> Tuple[int, int, int, int, int, int]:
    """Returns (score, qle, tle, gtle, gscore, max_off)."""
    qlen, tlen = len(qseq), len(tseq)
    assert h0 > 0
    m5 = mat.reshape(5, 5)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    # query profile per target base: qp[c][j] = mat[c, q[j]]
    qp = m5[:, qseq].astype(np.int64)  # (5, qlen)

    # first row fill (ksw.c:395-397)
    eh_h = np.zeros(qlen + 1, dtype=np.int64)
    eh_e = np.zeros(qlen + 1, dtype=np.int64)
    eh_h[0] = h0
    if qlen >= 1:
        eh_h[1] = h0 - oe_ins if h0 > oe_ins else 0
        j = 2
        while j <= qlen and eh_h[j - 1] > e_ins:
            eh_h[j] = eh_h[j - 1] - e_ins
            j += 1

    # band clamp (ksw.c:399-407)
    mmax = int(m5.max())
    max_ins = int((qlen * mmax + end_bonus - o_ins) / e_ins + 1.0)
    max_ins = max(max_ins, 1)
    w = min(w, max_ins)
    max_del = int((qlen * mmax + end_bonus - o_del) / e_del + 1.0)
    max_del = max(max_del, 1)
    w = min(w, max_del)

    maxv, max_i, max_j, max_ie, gscore = h0, -1, -1, -1, -1
    max_off = 0
    beg, end = 0, qlen
    js = np.arange(qlen, dtype=np.int64)
    for i in range(tlen):
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        if beg >= end:
            # C loop body would execute with empty [beg,end): m stays 0 -> break
            break
        h1_first = max(h0 - (o_del + e_del * (i + 1)), 0) if beg == 0 else 0
        sl = slice(beg, end)
        q = qp[tseq[i]]
        M = eh_h[sl].copy()
        E = eh_e[sl].copy()
        M = np.where(M != 0, M + q[sl], 0)
        # F scan: F[beg] = 0; F[j+1] = max(F[j]-e_ins, max(M[j]-oe_ins,0))
        #   => F[j] = max_{k<j} (max(M[k]-oe_ins,0) - (j-1-k)*e_ins)
        T = np.maximum(M - oe_ins, 0)
        scan = _maxscan_decay(T, e_ins)
        F = np.empty(end - beg, dtype=np.int64)
        F[0] = 0
        if end - beg > 1:
            F[1:] = scan[:-1]
        H = np.maximum(np.maximum(M, E), F)
        # row max + last argmax (mj = last j with running max updated on >=)
        m = int(H.max()) if end > beg else 0
        if m > 0:
            mj = beg + int(np.nonzero(H == m)[0][-1])
        else:
            mj = end - 1  # matches C: zeros still update mj; unused unless m>0
        # E(i+1,j)
        newE = np.maximum(np.maximum(M - oe_del, 0), E - e_del)
        # writes: eh_h[j] = H(i, j-1) for j in [beg,end]; eh_e[end] = 0
        eh_h[beg] = h1_first
        eh_h[beg + 1 : end + 1] = H
        eh_e[sl] = newE
        eh_e[end] = 0
        h1_last = int(H[-1]) if end > beg else h1_first
        if end == qlen:
            if gscore <= h1_last:
                max_ie = i
                gscore = max(gscore, h1_last)
        if m == 0:
            break
        if m > maxv:
            maxv, max_i, max_j = m, i, mj
            max_off = max(max_off, abs(mj - i))
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if maxv - m - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if maxv - m - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        # band trimming (ksw.c:466-469) over the UPDATED eh arrays
        j = beg
        while j < end and eh_h[j] == 0 and eh_e[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and eh_h[j] == 0 and eh_e[j] == 0:
            j -= 1
        end = j + 2 if j + 2 < qlen else qlen
    return maxv, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off


def ksw_global2(qseq: np.ndarray, tseq: np.ndarray, mat: np.ndarray,
                o_del: int, e_del: int, o_ins: int, e_ins: int,
                w: int, want_cigar: bool = True
                ) -> Tuple[int, Optional[List[Tuple[int, int]]]]:
    """Returns (score, cigar) with cigar as [(length, op)] (op: 0=M,1=I,2=D),
    or (score, None) when want_cigar is False."""
    qlen, tlen = len(qseq), len(tseq)
    if qlen == 0:
        return 0, None
    m5 = mat.reshape(5, 5)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qp = m5[:, qseq].astype(np.int64)
    n_col = qlen if qlen < 2 * w + 1 else 2 * w + 1
    z = np.zeros((tlen, n_col), dtype=np.uint8) if want_cigar else None

    eh_h = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    eh_e = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    eh_h[0] = 0
    jmax = min(qlen, w)
    for j in range(1, jmax + 1):
        eh_h[j] = -(o_ins + e_ins * j)
    for i in range(tlen):
        beg = i - w if i > w else 0
        end = i + w + 1 if i + w + 1 < qlen else qlen
        h1_first = -(o_del + e_del * (i + 1)) if beg == 0 else MINUS_INF
        sl = slice(beg, end)
        q = qp[tseq[i]]
        M = eh_h[sl] + q[sl]
        E = eh_e[sl].copy()
        # F scan: F[beg]=-inf; F[j+1]=max(F[j]-e_ins, M[j]-oe_ins)
        #   => F[j] = max_{k<j} (M[k]-oe_ins - (j-1-k)*e_ins)
        n = end - beg
        scan = _maxscan_decay(M - oe_ins, e_ins)
        F = np.empty(n, dtype=np.int64)
        F[0] = MINUS_INF
        if n > 1:
            F[1:] = scan[:-1]
        if want_cigar:
            d = np.where(M >= E, 0, 1).astype(np.uint8)
            H = np.maximum(M, E)
            d = np.where(H >= F, d, 2).astype(np.uint8)
            H = np.maximum(H, F)
            # e dir (1<<2): old E - e_del > M - oe_del (strict)
            e_ext = (E - e_del) > (M - oe_del)
            # f dir (2<<4): F(i,j+1) from extension iff F[j] - e_ins > M[j] - oe_ins;
            # stored at cell j (the "next cell" convention, ksw.c:563-565)
            f_ext = (F - e_ins) > (M - oe_ins)
            d |= e_ext.astype(np.uint8) << 2
            d |= f_ext.astype(np.uint8) * 0x20
            z[i, :n] = d
        else:
            H = np.maximum(np.maximum(M, E), F)
        newE = np.maximum(M - oe_del, E - e_del)
        eh_h[beg] = h1_first
        eh_h[beg + 1 : end + 1] = H
        eh_e[sl] = newE
        eh_e[end] = MINUS_INF
    score = int(eh_h[qlen])
    if not want_cigar:
        return score, None
    # traceback (ksw.c:588-602)
    cigar: List[List[int]] = []  # [op, len]

    def push(op: int, ln: int):
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += ln
        else:
            cigar.append([op, ln])

    i = tlen - 1
    k = (i + w + 1 if i + w + 1 < qlen else qlen) - 1
    which = 0
    while i >= 0 and k >= 0:
        beg = i - w if i > w else 0
        d = int(z[i, k - beg])
        which = (d >> (which << 1)) & 3
        if which == 0:
            push(0, 1)
            i -= 1
            k -= 1
        elif which == 1:
            push(2, 1)
            i -= 1
        else:
            push(1, 1)
            k -= 1
    if i >= 0:
        push(2, i + 1)
    if k >= 0:
        push(1, k + 1)
    cigar.reverse()
    return score, [(ln, op) for op, ln in cigar]


# ---------------------------------------------------------------------------
# Striped local SW (mate rescue): exact semantics of ksw_u8 / ksw_i16 /
# ksw_align2 via the padded-query column recurrence.
# ---------------------------------------------------------------------------


class KswR:
    __slots__ = ("score", "te", "qe", "qb", "tb", "score2", "te2")

    def __init__(self):
        self.score = 0
        self.te = -1
        self.qe = -1
        self.qb = -1
        self.tb = -1
        self.score2 = -1
        self.te2 = -1


def _ksw_striped(qseq, tseq, mat, o_del, e_del, o_ins, e_ins, xtra, size):
    """Exact outputs of ksw_u8 (size=1) / ksw_i16 (size=2) (ksw.c:111-334).

    Simulates the padded-query SW the striped kernel computes: query padded to
    slen*p positions, padding scores 0, u8 with bias/saturation and 255 cap.
    """
    m5 = mat.reshape(5, 5)
    qlen = len(qseq)
    p = 8 * (3 - size)  # values per vector: 16 for u8, 8 for i16
    slen = (qlen + p - 1) // p
    nlen = slen * p
    minsc = (xtra & 0xFFFF) if (xtra & KSW_XSUBO) else 0x10000
    endsc = (xtra & 0xFFFF) if (xtra & KSW_XSTOP) else 0x10000

    mat_min = int(m5.min())
    mat_max = int(m5.max())
    shift = (256 - mat_min) & 0xFF  # uint8_t arithmetic (ksw.c:85)
    qmax = mat_max

    # scores per (target base c, padded query pos)
    prof = np.zeros((5, nlen), dtype=np.int64)
    prof[:, :qlen] = m5[:, qseq]

    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    H = np.zeros(nlen, dtype=np.int64)
    E = np.zeros(nlen, dtype=np.int64)
    Hmax = np.zeros(nlen, dtype=np.int64)
    r = KswR()
    tlen = len(tseq)
    gmax, te = 0, -1
    b: List[int] = []  # packed (score<<32|i) per C; store tuples
    b_list: List[Tuple[int, int]] = []

    cap255 = size == 1

    for i in range(tlen):
        S = prof[tseq[i]]
        Hdiag = np.empty(nlen, dtype=np.int64)
        Hdiag[0] = 0
        Hdiag[1:] = H[:-1]
        if cap255:
            # h = subs_epu8(adds_epu8(h, S+shift), shift)
            hm = np.minimum(Hdiag + (S + shift), 255)
            hm = np.maximum(hm - shift, 0)
        else:
            hm = Hdiag + S  # adds_epi16; no saturation in practice
        Hnf = np.maximum(hm, E)
        # F from H via scan (exact because o_ins >= 0)
        T = np.maximum(Hnf - oe_ins, 0)
        scan = _maxscan_decay(T, e_ins)
        F = np.zeros(nlen, dtype=np.int64)
        F[1:] = scan[:-1]
        Hrow = np.maximum(Hnf, F)
        # E update from final H: e = max(e - e_del, h - oe_del) clamped >= 0
        E = np.maximum(np.maximum(E - e_del, 0), np.maximum(Hrow - oe_del, 0))
        imax = int(Hrow.max())
        H = Hrow
        if imax >= minsc:
            if not b_list or b_list[-1][1] + 1 != i:
                b_list.append((imax, i))
            elif b_list[-1][0] < imax:
                b_list[-1] = (imax, i)
        if imax > gmax:
            gmax, te = imax, i
            Hmax[:] = Hrow
            if (cap255 and gmax + shift >= 255) or gmax >= endsc:
                break

    if cap255:
        r.score = gmax if gmax + shift < 255 else 255
    else:
        r.score = gmax
    r.te = te
    if not cap255 or r.score != 255:
        # qe = min query pos among argmax of Hmax (incl. padding positions)
        # C scans striped memory order taking first strictly-greater, then any
        # equal with smaller mapped position — net effect: min query position
        # among the argmax entries (padding included).
        if nlen:
            mx = int(Hmax.max())
            r.qe = int(np.nonzero(Hmax == mx)[0].min())
        if b_list:
            ii = (r.score + qmax - 1) // qmax
            low, high = te - ii, te + ii
            for sc, e in b_list:
                if (e < low or e > high) and sc > r.score2:
                    r.score2, r.te2 = sc, e
    return r


def ksw_align2(qseq: np.ndarray, tseq: np.ndarray, mat: np.ndarray,
               o_del: int, e_del: int, o_ins: int, e_ins: int, xtra: int
               ) -> KswR:
    """ksw_align2 (ksw.c:343-365): forward pass + reverse pass for start."""
    size = 1 if (xtra & KSW_XBYTE) else 2
    r = _ksw_striped(qseq, tseq, mat, o_del, e_del, o_ins, e_ins, xtra, size)
    if (xtra & KSW_XSTART) == 0 or ((xtra & KSW_XSUBO) and r.score < (xtra & 0xFFFF)):
        return r
    if r.score == 255:  # overflow: C would still attempt reverse; guard anyway
        return r
    q_rev = qseq[: r.qe + 1][::-1].copy()
    t_rev = tseq[: r.te + 1][::-1].copy()
    rr = _ksw_striped(q_rev, t_rev, mat, o_del, e_del, o_ins, e_ins,
                      KSW_XSTOP | r.score, size)
    if r.score == rr.score:
        r.tb = r.te - rr.te
        r.qb = r.qe - rr.qe
    return r
