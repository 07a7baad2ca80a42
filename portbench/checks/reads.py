"""The single-read mixes' check, by reference.py's rules less the mate
parts, over a sample of (read index, the read's SAM text):

- bad_records: not exactly one primary line (neither 0x100 nor 0x800), a
  line naming another read, a primary flag with 0x1, 0x40 or 0x80, or a
  primary SEQ or QUAL that is not the read's (reversed and complemented
  under 0x10);
- bad_alignment: a mapped line, supplementary ones included, whose CIGAR
  does not consume the read (hard clips counted) or whose NM or MD is not
  what the CIGAR at POS gives;
- score_miss_pct: reference.score_misses over the primary lines, with the
  origin window and slack scaled to each read's own length (as the pairs'
  at 101 bp).

score_miss_pct is computed only where the traffic's limits name it: its
Smith-Waterman steps through every cell in Python, which long reads make
slow.
"""

import numpy as np

from harness import reference as R
from harness.simulate import read_name


def check(sample, truth, codes, contig: str, scoring: dict,
          traffic: dict) -> dict:
    bad_records = bad_alignment = 0
    rows = []
    for ri, text in sample:
        read_codes = truth.read(ri)
        read = "".join(R.BASES[c] for c in read_codes)
        L = len(read)
        start, end = int(truth.start[ri]), int(truth.end[ri])
        rev = bool(truth.rev[ri])
        fields = R.lines(text)
        prim = R.primaries(fields) if fields else []
        f = prim[0] if len(prim) == 1 else None
        if f is not None:
            flag = int(f[1])
            seq = read.translate(R.COMP)[::-1] if flag & 0x10 else read
            name = read_name(ri).decode()
            if (any(g[0] != name for g in fields) or flag & 0xC1
                    or f[9] != seq or f[10] != "I" * L):
                f = None
        origin = False
        if f is None:
            bad_records += 1
        else:
            got = [(g, R.aligned(g, L, codes, contig)) for g in fields
                   if not int(g[1]) & 0x4]
            if any(a is None for _, a in got):
                bad_alignment += 1
                f = None
            elif not int(f[1]) & 0x4:
                a = next(a for g, a in got if g is f)
                origin = R.at_origin(f, a, start, end, rev,
                                     max(R.ORIGIN_SLACK, L // 4))
        rows.append((read_codes, rev, start, end, f, origin))
    out = {"bad_records": bad_records, "bad_alignment": bad_alignment}
    if "score_miss_pct" in traffic["limits"]:
        lengths = np.array([len(r[0]) for r in rows])
        pad = np.maximum(R.WINDOW_PAD, 2 * lengths // 5)
        miss = R.score_misses(rows, codes, scoring, pad)
        out["score_miss_pct"] = 100.0 * miss / max(len(rows), 1)
    return out
