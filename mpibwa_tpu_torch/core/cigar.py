"""CIGAR + NM/MD generation (bwa_gen_cigar2, bwa.c:120-208)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .extend import ksw_global2

INT2BASE_FWD = "ACGTN"
INT2BASE_REV = "TGCAN"

# Optional batched-DP cache (set by the device pipeline): maps
# (query_bytes, rseq_bytes, w) -> (score, cigar). Misses fall through to the
# scalar kernel, so exactness never depends on the cache. Thread-local so
# concurrent aligner workers each see their own batch's cache.
import threading as _threading

_TLS = _threading.local()


def set_cigar_cache(cache):
    _TLS.cache = cache


def gen_cigar(opt, refs, query: np.ndarray, rb: int, re: int,
              w_: int = 0, want_cigar: bool = True
              ) -> Tuple[Optional[int], Optional[List[Tuple[int, int]]],
                         Optional[str], Optional[int]]:
    """Returns (score, cigar, MD, NM); score None if rejected.

    query must already be sliced to the aligned region (nt4 coded). When
    want_cigar is False only the score is computed (mem_patch_reg use).
    """
    l_pac = refs.l_pac
    l_query = len(query)
    if l_query <= 0 or rb >= re or (rb < l_pac and re > l_pac):
        return None, None, None, None
    rseq = refs.get_seq(rb, re)
    rlen = len(rseq)
    if re - rb != rlen:
        return None, None, None, None
    if rb >= l_pac:  # reverse both to place indels leftmost
        query = query[::-1].copy()
        rseq = rseq[::-1].copy()
    if l_query == re - rb and w_ == 0:
        cigar = [(l_query, 0)] if want_cigar else None
        m5 = opt.mat.reshape(5, 5)
        score = int(m5[rseq, query].sum())
    else:
        max_ins = int((((l_query + 1) >> 1) * int(opt.mat[0]) - opt.o_ins) / opt.e_ins + 1.0)
        max_del = int((((l_query + 1) >> 1) * int(opt.mat[0]) - opt.o_del) / opt.e_del + 1.0)
        max_gap = max(max_ins, max_del, 1)
        w = (max_gap + abs(rlen - l_query) + 1) >> 1
        w = min(w, w_)
        min_w = abs(rlen - l_query) + 3
        w = max(w, min_w)
        hit = None
        _cache = getattr(_TLS, "cache", None)
        if want_cigar and _cache is not None:
            hit = _cache.get((query.tobytes(), rseq.tobytes(), w))
        if hit is not None:
            score, cigar = hit
        else:
            score, cigar = ksw_global2(query, rseq, opt.mat, opt.o_del,
                                       opt.e_del, opt.o_ins, opt.e_ins, w,
                                       want_cigar)
    if not want_cigar:
        return score, None, None, None
    # NM and MD (bwa.c:171-201)
    md_parts: List[str] = []
    int2base = INT2BASE_FWD if rb < l_pac else INT2BASE_REV
    x = y = u = 0
    n_mm = n_gap = 0
    n_cigar = len(cigar)
    for k, (ln, op) in enumerate(cigar):
        if op == 0:  # match
            for i in range(ln):
                if query[x + i] != rseq[y + i]:
                    md_parts.append(str(u))
                    md_parts.append(int2base[rseq[y + i]])
                    n_mm += 1
                    u = 0
                else:
                    u += 1
            x += ln
            y += ln
        elif op == 2:  # deletion
            if 0 < k < n_cigar - 1:
                md_parts.append(str(u))
                md_parts.append("^")
                for i in range(ln):
                    md_parts.append(int2base[rseq[y + i]])
                u = 0
                n_gap += ln
            y += ln
        elif op == 1:  # insertion
            x += ln
            n_gap += ln
    md_parts.append(str(u))
    return score, cigar, "".join(md_parts), n_mm + n_gap
