"""The plain reference that decides ``correct``.

It judges each sampled SAM record by what it says, against the reference
sequence and the simulator's record of where each read came from. It
works everything out again from those two, in plain NumPy, and imports
nothing of the program:

- ``bad_records``: a sampled read without exactly one primary record, or
  whose QNAME, pair flags, SEQ or QUAL are not the read's (SEQ and QUAL
  reversed and complemented on the reverse strand);
- ``bad_alignment``: a mapped primary record whose CIGAR does not consume
  the read, or whose NM or MD differs from what the CIGAR at POS says
  against the reference;
- ``bad_mate``: a sampled pair whose mate fields (RNEXT, PNEXT, the mate
  strand and mate-unmapped flags, proper-pair agreement) or TLEN (bwa's
  rule from both mates' POS, CIGAR and strand) disagree with the mates'
  own records;
- ``score_miss_pct``: the share of sampled reads whose record falls short
  of the best local alignment at the read's origin, as the reference
  computes it (Smith-Waterman with bwa-mem's scores and affine gaps over a
  window around the origin): placed at the origin with an AS other than
  that best, or placed elsewhere (or left unmapped) with an AS below it;
- ``proper_miss``: sampled pairs placed at their origin, with an insert
  within two standard deviations of the mix's mean, that are not flagged
  as a proper pair.

Those are check_pairs' numbers; checks/reads.py judges single reads by the
same rules (``lines``, ``aligned``, ``at_origin``, ``score_misses``).
"""

from __future__ import annotations

import re

import numpy as np

CIGAR_OP = re.compile(r"(\d+)([MIDSHNP=X])")
BASES = "ACGTN"
COMP = str.maketrans("ACGTN", "TGCAN")
ORIGIN_SLACK = 25  # bases an aligned end may sit from the read's origin
WINDOW_PAD = 40  # reference bases beside a read's origin in its window
NEG = -(1 << 20)


def local_best(reads: np.ndarray, wins: np.ndarray, a: int, b: int,
               o: int, e: int) -> np.ndarray:
    """Best local alignment score of each read against its window (both
    codes 0-3, 4 for N): match a, mismatch -b, N -1, a gap of k bases
    -(o + k e) in either sequence. Gotoh's recurrences, one read row at a
    time over all reads together."""
    m, L = reads.shape
    w = wins.shape[1]
    oe = o + e
    h_prev = np.zeros((m, w + 1), np.int32)
    f_prev = np.full((m, w + 1), NEG, np.int32)
    best = np.zeros(m, np.int32)
    win_n = wins == 4
    for i in range(L):
        r = reads[:, i: i + 1]
        s = np.where(win_n | (r == 4), -1,
                     np.where(r == wins, a, -b)).astype(np.int32)
        f = np.maximum(h_prev - oe, f_prev - e)
        hc = np.maximum(np.maximum(h_prev[:, :-1] + s, 0), f[:, 1:])
        h = np.zeros((m, w + 1), np.int32)
        ev = np.full(m, NEG, np.int32)
        for j in range(1, w + 1):
            ev = np.maximum(h[:, j - 1] - oe, ev - e)
            h[:, j] = np.maximum(hc[:, j - 1], ev)
        best = np.maximum(best, h.max(1))
        h_prev, f_prev = h, f
    return best


def origin_windows(genome: np.ndarray, start: np.ndarray, end: np.ndarray,
                   rev: np.ndarray, pad=WINDOW_PAD) -> np.ndarray:
    """Reference windows around each read's origin [start, end], pad bases
    (one for all, or one a read) on either side and all as wide as the
    widest, reverse complemented where the read is: the read aligns to it
    as sequenced."""
    width = int((end - start + 2 * pad).max()) + 1
    k = np.arange(width)
    lo = np.maximum(start - pad, 0)
    idx = np.minimum(lo[:, None] + k, len(genome) - 1)
    win = genome[idx]
    back = np.where(win[:, ::-1] < 4, 3 - win[:, ::-1], 4)
    return np.where(rev[:, None], back, win).astype(np.uint8)


def lines(text: str):
    """Each line's fields, or None if a line is no SAM record."""
    out = []
    for line in text.split("\n"):
        if not line:
            continue
        f = line.split("\t")
        if len(f) < 11 or not f[1].isdigit():
            return None
        out.append(f)
    return out


def primaries(fields) -> list:
    """The lines that are neither secondary (0x100) nor supplementary
    (0x800)."""
    return [f for f in fields if not int(f[1]) & 0x900]


def _primary(text: str):
    """The one primary record's fields, or None."""
    fields = lines(text)
    prim = primaries(fields) if fields is not None else []
    return prim[0] if len(prim) == 1 else None


def _tags(fields) -> dict:
    out = {}
    for t in fields[11:]:
        parts = t.split(":", 2)
        if len(parts) == 3:
            out[parts[0]] = parts[2]
    return out


def _cigar(c: str):
    ops = [(int(n), op) for n, op in CIGAR_OP.findall(c)]
    if "".join(f"{n}{op}" for n, op in ops) != c:
        return None
    return ops


def walk(ops, seq: str, genome: np.ndarray, pos0: int):
    """(read bases consumed, reference bases consumed, NM, MD) of an
    alignment of seq at pos0; None if an op leaves the reference."""
    q = r = nm = run = 0
    md = []
    for n, op in ops:
        if op in "M=X":
            if pos0 + r + n > len(genome):
                return None
            for k in range(n):
                rb = BASES[genome[pos0 + r + k]]
                if seq[q + k] == rb:
                    run += 1
                else:
                    md.append(f"{run}{rb}")
                    run = 0
                    nm += 1
            q += n
            r += n
        elif op == "I":
            q += n
            nm += n
        elif op == "D":
            md.append(f"{run}^" + "".join(
                BASES[c] for c in genome[pos0 + r: pos0 + r + n]))
            run = 0
            r += n
            nm += n
        elif op == "S":
            q += n
        else:
            return None
    md.append(str(run))
    return q, r, nm, "".join(md)


def aligned(f, n_read: int, genome: np.ndarray, contig: str):
    """walk's (read bases consumed, reference bases consumed, NM, MD) of a
    mapped line, if its CIGAR consumes the read's n_read bases (hard clips,
    which SEQ leaves out, counted), its NM and MD are what the CIGAR at POS
    gives and its AS is a number; else None."""
    ops = _cigar(f[5])
    if not ops or f[2] != contig or not f[3].isdigit() or int(f[3]) < 1:
        return None
    lo = int(ops[0][1] == "H")  # hard clips stand only at either end
    hi = len(ops) - int(len(ops) > lo and ops[-1][1] == "H")
    got = walk(ops[lo:hi], f[9], genome, int(f[3]) - 1)
    tags = _tags(f)
    clipped = sum(n for n, _ in ops[:lo] + ops[hi:])
    if (got is None or got[0] + clipped != n_read
            or tags.get("NM") != str(got[2]) or tags.get("MD") != got[3]
            or not tags.get("AS", "x").lstrip("-").isdigit()):
        return None
    return got


def at_origin(f, got, start: int, end: int, rev: bool,
              slack: int = ORIGIN_SLACK) -> bool:
    """Whether an aligned line sits on the read's strand with its 5' end
    within slack bases of the origin's."""
    p0 = int(f[3]) - 1
    return bool(int(f[1]) & 0x10) == rev and (
        abs(p0 + got[1] - 1 - end) <= slack if rev
        else abs(p0 - start) <= slack)


def score_misses(rows, genome: np.ndarray, scoring: dict,
                 pad=WINDOW_PAD) -> int:
    """Reads whose primary line falls short of the best local alignment at
    the origin (local_best over origin_windows): placed at the origin with
    an AS other than that best, or elsewhere (or unmapped, AS 0) with an AS
    below it. rows hold (read codes, rev, start, end, primary line or None,
    at origin); reads of other lengths are padded with N, which no local
    alignment ends on."""
    width = max(len(r[0]) for r in rows)
    reads = np.full((len(rows), width), 4, np.uint8)
    for i, r in enumerate(rows):
        reads[i, : len(r[0])] = r[0]
    rev = np.array([r[1] for r in rows])
    start = np.array([r[2] for r in rows], np.int64)
    end = np.array([r[3] for r in rows], np.int64)
    best = local_best(reads, origin_windows(genome, start, end, rev, pad),
                      scoring["a"], scoring["b"], scoring["o"], scoring["e"])
    miss = 0
    for (_, _, _, _, f, origin), s in zip(rows, best):
        sc = 0
        if f is not None and not int(f[1]) & 0x4:
            sc = int(_tags(f)["AS"])
        if (sc != s) if origin else (sc < s):
            miss += 1
    return miss


def _tlen(p, m) -> int:
    """bwa's TLEN of record p against its mate m (both mapped, one
    contig): the distance between their 5' ends (mem_aln2sam)."""
    def end5(f):
        pos = int(f[3]) - 1
        if int(f[1]) & 0x10:
            ops = _cigar(f[5]) or []
            pos += sum(n for n, op in ops if op in "MD=XN") - 1
        return pos
    d = end5(p) - end5(m)
    return -(d + (1 if d > 0 else -1 if d < 0 else 0))


def check_pairs(sample, pairs, genome: np.ndarray, scoring: dict,
                contig: str, insert_mean: float, insert_sd: float) -> dict:
    """Numbers of the sampled pairs: sample holds (pair index, R1's SAM
    text, R2's SAM text); pairs is the simulator's record (simulate.Pairs);
    genome the reference as codes."""
    bad_records = bad_alignment = bad_mate = 0
    rows = []  # (read codes, rev, start, end, fields or None)
    proper_miss = 0
    for pi, t1, t2 in sample:
        pos, isize = int(pairs.pos[pi]), int(pairs.isize[pi])
        rev1 = bool(pairs.r1_rev[pi])
        prims = []
        for mate, (text, codes, rev) in enumerate(
                ((t1, pairs.r1[pi], rev1), (t2, pairs.r2[pi], not rev1))):
            f = _primary(text)
            read = "".join(BASES[c] for c in codes)
            if rev:  # the reverse-strand read spans [pos + isize - len, ...]
                end = pos + isize - 1
                start = end - len(read) + 1
            else:
                start, end = pos, pos + len(read) - 1
            ok = f is not None and f[0] == f"p{pi:09d}"
            if ok:
                flag = int(f[1])
                ok = (flag & 0x1 and bool(flag & 0x40) == (mate == 0)
                      and bool(flag & 0x80) == (mate == 1))
                want = read.translate(COMP)[::-1] if flag & 0x10 else read
                ok = ok and f[9] == want and f[10] == "I" * len(read)
            if not ok:
                bad_records += 1
                f = None
            origin = False
            if f is not None and not int(f[1]) & 0x4:
                got = aligned(f, len(read), genome, contig)
                if got is None:
                    bad_alignment += 1
                    f = None
                else:
                    origin = at_origin(f, got, start, end, rev)
            prims.append(f)
            rows.append((codes, rev, start, end, f, origin))
        bad_mate += _mate_faults(prims)
        p, m = prims
        if (abs(isize - insert_mean) <= 2 * insert_sd and p is not None
                and m is not None and rows[-1][5] and rows[-2][5]):
            if not int(p[1]) & 0x2 or not int(m[1]) & 0x2:
                proper_miss += 1
    miss = score_misses(rows, genome, scoring)
    return {
        "bad_records": bad_records,
        "bad_alignment": bad_alignment,
        "bad_mate": bad_mate,
        "score_miss_pct": 100.0 * miss / max(len(rows), 1),
        "proper_miss": proper_miss,
    }


def _mate_faults(prims) -> int:
    """1 if a pair's mate fields disagree with the mates' records."""
    if any(f is None for f in prims):
        return 0  # already counted as a bad record or alignment
    for p, m in (prims, prims[::-1]):
        fp, fm = int(p[1]), int(m[1])
        if bool(fp & 0x2) != bool(fm & 0x2):
            return 1
        if fm & 0x4:
            if not fp & 0x8:
                return 1
            continue
        if fp & 0x8 or bool(fp & 0x20) != bool(fm & 0x10):
            return 1
        if p[7] != m[3] or p[6] not in ("=", m[2]):
            return 1
        if (p[6] == "=") != (p[2] == m[2]):
            return 1
    p, m = prims
    if int(p[8]) != -int(m[8]):
        return 1
    fp, fm = int(p[1]), int(m[1])
    if not (fp | fm) & 0x4 and p[2] == m[2] and int(p[8]) != _tlen(p, m):
        return 1
    return 0
