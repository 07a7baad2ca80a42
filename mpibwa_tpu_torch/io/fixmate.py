"""samtools-fixmate equivalent over SAM text (fixmate.c semantics).

Operates on a pair's SAM strings exactly like the reference: re-parse each
record (readParsing, fixmate.c:160-299), pair records by flag bits, sync
mate pos/flags/MQ/MC (sync_mate fixmate.c:357-366), add the ms:i mate score
(sum of quals >= MD_MIN_QUALITY=15, fixmate.c:270-273), and rewrite through
the five writers. The three output passes (both-unmapped pairs, both-mapped
primary pairs, then supplementary/secondary + mate-unmapped pairs in scan
order) reproduce the reference's record reordering.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

MD_MIN_QUALITY = 15

FPAIRED = 1
FPROPER = 2
FUNMAP = 4
FMUNMAP = 8
FREVERSE = 16
FMREVERSE = 32
FREAD1 = 64
FREAD2 = 128
FSECONDARY = 256
FSUPPLEMENTARY = 2048


@dataclasses.dataclass
class _Read:
    name: str
    flag: int = 0
    tid: int = -1
    pos: int = 0
    mapq: int = 0
    cigar: str = "*"
    mtid: int = -1
    mpos: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    aux: str = ""  # tags onward, including trailing newline
    score: int = 0
    mscore: int = 0
    mmapq: int = 0
    mcigar: Optional[str] = None


def _parse(line: str, name: str, rid_of: Dict[str, int]) -> _Read:
    """readParsing (fixmate.c:160-299); line includes the trailing newline."""
    f = line.split("\t", 11)
    r = _Read(name=name)
    r.flag = int(f[1])
    r.tid = rid_of.get(f[2], -1)
    r.pos = -1 if f[3] == "*" else int(f[3])
    r.mapq = int(f[4])
    r.cigar = f[5]
    r.mtid = r.tid if f[6] == "=" else rid_of.get(f[6], -1)
    r.mpos = -1 if f[7] == "*" else int(f[7])
    r.tlen = int(f[8])
    r.seq = f[9]
    r.qual = f[10]
    r.aux = f[11] if len(f) > 11 else "\n"
    r.score = sum(ord(c) - 33 for c in r.qual if ord(c) - 33 >= MD_MIN_QUALITY)
    return r


def _sync_unmapped_pos(src: _Read, dest: _Read):
    if (dest.flag & FUNMAP) and not (src.flag & FUNMAP):
        dest.tid = src.tid
        dest.pos = src.pos


def _sync_mate_inner(src: _Read, dest: _Read):
    dest.mtid = src.tid
    dest.mpos = src.pos
    if src.flag & FREVERSE:
        dest.flag |= FMREVERSE
    else:
        dest.flag &= ~FMREVERSE
    if src.flag & FUNMAP:
        dest.flag |= FMUNMAP


def _sync_mq_mc(src: _Read, dest: _Read):
    if not (src.flag & FUNMAP):
        dest.mmapq = src.mapq
        dest.mcigar = src.cigar


def _sync_mate(a: _Read, b: _Read):
    _sync_unmapped_pos(a, b)
    _sync_unmapped_pos(b, a)
    _sync_mate_inner(a, b)
    _sync_mate_inner(b, a)
    _sync_mq_mc(a, b)
    _sync_mq_mc(b, a)


def _w_unmapped_pair(r: _Read, names) -> str:
    """sam_write_unmapped_and_munmapped (fixmate.c:447-496)."""
    if r.tid == -1 and r.mtid == -1:
        chrn, mchr = "*", "*"
    else:
        chrn = names[r.tid]
        mchr = "*"
        if r.tid != -1 and r.tid == r.mtid:
            mchr = "="
        if r.mtid != -1:
            mchr = names[r.mtid]
    return (f"{r.name}\t{r.flag}\t{chrn}\t{r.pos}\t{r.mapq}\t{r.cigar}\t"
            f"{mchr}\t{r.mpos}\t{r.tlen}\t{r.seq}\t{r.qual}\tms:i:{r.mscore}\t{r.aux}")


def _w_discordant(r: _Read, names) -> str:
    """sam_write_discordant (fixmate.c:406-445)."""
    return (f"{r.name}\t{r.flag}\t{names[r.tid]}\t{r.pos}\t{r.mapq}\t{r.cigar}\t"
            f"{names[r.mtid]}\t{r.mpos}\t{r.tlen}\t{r.seq}\t{r.qual}\t"
            f"MQ:i:{r.mmapq}\tMC:Z:{r.mcigar}\tms:i:{r.mscore}\t{r.aux}")


def _w_normal(r: _Read, names) -> str:
    """sam_write (fixmate.c:549-598)."""
    mchr = "=" if r.tid == r.mtid else names[r.mtid]
    return (f"{r.name}\t{r.flag}\t{names[r.tid]}\t{r.pos}\t{r.mapq}\t{r.cigar}\t"
            f"{mchr}\t{r.mpos}\t{r.tlen}\t{r.seq}\t{r.qual}\t"
            f"MQ:i:{r.mmapq}\tms:i:{r.mscore}\t{r.aux}")


def _w_mate_unmapped(r: _Read, names) -> str:
    """sam_write_mate_unmapped (fixmate.c:497-547)."""
    mchr = "=" if r.tid == r.mtid else names[r.mtid]
    if r.flag & FUNMAP:
        return (f"{r.name}\t{r.flag}\t{names[r.tid]}\t{r.pos}\t{r.mapq}\t{r.cigar}\t"
                f"{mchr}\t{r.mpos}\t{r.tlen}\t{r.seq}\t{r.qual}\t"
                f"MQ:i:{r.mmapq}\tMC:Z:{r.mcigar}\tms:i:{r.mscore}\t{r.aux}")
    return (f"{r.name}\t{r.flag}\t{names[r.tid]}\t{r.pos}\t{r.mapq}\t{r.cigar}\t"
            f"{mchr}\t{r.mpos}\t{r.tlen}\t{r.seq}\t{r.qual}\t"
            f"MC:Z:*\tms:i:{r.mscore}\t{r.aux}")


def _w_supp(r: _Read, names) -> str:
    """sam_write_supp_and_secondary (fixmate.c:374-404)."""
    return (f"{r.name}\t{r.flag}\t{names[r.tid]}\t{r.pos}\t{r.mapq}\t{r.cigar}\t"
            f"{names[r.mtid]}\t{r.mpos}\t{r.tlen}\t{r.seq}\t{r.qual}\t{r.aux}")


def fixmate_pair(s1, s2, anns) -> None:
    """fixmate (fixmate.c:601-821): rewrite s1.sam / s2.sam in place."""
    names = [a.name for a in anns]
    rid_of = {a.name: j for j, a in enumerate(anns)}
    reads: List[Optional[_Read]] = []
    for line in s1.sam.splitlines(keepends=True):
        reads.append(_parse(line, s1.name, rid_of))
    n1 = len(reads)
    for line in s2.sam.splitlines(keepends=True):
        reads.append(_parse(line, s2.name, rid_of))
    out1: List[str] = []
    out2: List[str] = []

    # pass 1: both-unmapped pairs (fixmate.c:694-716)
    read1 = read2 = None
    have = 0
    i1 = i2 = 0
    for i, r in enumerate(reads):
        if r and (r.flag & FUNMAP) and (r.flag & FMUNMAP):
            if r.flag & FREAD1:
                read1, i1 = r, i
                have += 1
            if r.flag & FREAD2:
                read2, i2 = r, i
                have += 1
            if have == 2:
                read1.flag |= FPAIRED
                read2.flag |= FPAIRED
                read2.mscore = read1.score
                read1.mscore = read2.score
                out1.append(_w_unmapped_pair(read1, names))
                out2.append(_w_unmapped_pair(read2, names))
                reads[i1] = reads[i2] = None
                have = 0

    # pass 2: both-mapped primary pairs (fixmate.c:719-767)
    have = 0
    for i, r in enumerate(reads):
        if (r and (r.flag & FPAIRED) and not (r.flag & FSECONDARY)
                and not (r.flag & FSUPPLEMENTARY) and not (r.flag & FUNMAP)
                and not (r.flag & FMUNMAP)):
            if r.flag & FREAD1:
                read1, i1 = r, i
                have += 1
            if r.flag & FREAD2:
                read2, i2 = r, i
                have += 1
            if have == 2:
                read1.flag |= FPAIRED
                read2.flag |= FPAIRED
                discordant = (read1.tid != read1.mtid) and (read2.tid != read2.mtid)
                _sync_mate(read1, read2)
                read2.mscore = read1.score
                read1.mscore = read2.score
                w = _w_discordant if discordant else _w_normal
                out1.append(w(read1, names))
                out2.append(w(read2, names))
                reads[i1] = reads[i2] = None
                have = 0

    # pass 3: supplementary/secondary + remaining (mate-unmapped) pairs in
    # scan order (fixmate.c:769-806)
    have = 0
    for i, r in enumerate(reads):
        if r and ((r.flag & FSECONDARY) or (r.flag & FSUPPLEMENTARY)):
            if r.flag & FREAD1:
                out1.append(_w_supp(r, names))
            else:
                out2.append(_w_supp(r, names))
            reads[i] = None
            r = None
        if r and (r.flag & FPAIRED):
            if r.flag & FREAD1:
                read1, i1 = r, i
                have += 1
            if r.flag & FREAD2:
                read2, i2 = r, i
                have += 1
            if have == 2:
                read1.flag |= FPAIRED
                read2.flag |= FPAIRED
                _sync_mate(read1, read2)
                read2.mscore = read1.score
                read1.mscore = read2.score
                out1.append(_w_mate_unmapped(read1, names))
                out2.append(_w_mate_unmapped(read2, names))
                reads[i1] = reads[i2] = None
                have = 0

    s1.sam = "".join(out1)
    s2.sam = "".join(out2)


def apply_fixmate(seqs, anns) -> None:
    """call_fixmate equivalent: strided over interleaved pairs. Uses the
    native (C) implementation when available; the Python port is the
    fallback and the differential reference."""
    from mpibwa_tpu_torch.native import fixmate_pair_native, get_lib

    names = [a.name for a in anns]
    use_native = get_lib() is not None
    for i in range(0, len(seqs) - 1, 2):
        s1, s2 = seqs[i], seqs[i + 1]
        if use_native:
            res = fixmate_pair_native(s1.sam, s2.sam, names)
            if res is not None:
                s1.sam, s2.sam = res
                continue
        fixmate_pair(s1, s2, anns)
