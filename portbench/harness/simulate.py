"""Simulated reads from a seed, in bulk, and the pool a run cycles through.

Pairs: the model of ``tests/_torch_toy.simulate_pairs`` in vectorised
form, with wgsim's indel lengths: FR pairs with the insert drawn from
N(mean, sd) and clipped, R1 on either strand with equal odds, then on each
read indels (per source base, each at half the indel rate: a deletion of
it and the bases after it, or an insertion of random bases after it; a
length of 1 plus a geometric tail with the mix's extension probability,
at most INDEL_MAX) followed by substitutions (a random base, which may be
the same one).

Single reads: either strand with equal odds, a fixed length or one drawn
from the mix's length distribution, and either the same wgsim errors or
PBSIM's continuous long-read model (Ono, Asai and Hamada 2013,
Bioinformatics 29:119): a read's accuracy drawn from N(mean, sd), clipped
at its minimum, its errors split over substitutions, insertions and
deletions by a stated ratio, each read base an independent draw.

Reads are drawn uniformly over the stretches of the reference that hold
no N, where sequencers read. Plain NumPy; it imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BLOCK = 1 << 16  # reads mutated at once: fixes the order of the draws
STEP_BLOCK = 1 << 21  # PBSIM steps drawn at once (reads x steps)
NAME_DIGITS = 9
INDEL_MAX = 10  # bases an indel spans at most
SPARE = 64  # source bases past a read's end, for its deletions
LENGTH_STREAM = 1  # the length draws' own stream beside the seed


@dataclasses.dataclass
class Pairs:
    """n pairs: reads as codes 0-3 and where each came from."""

    r1: np.ndarray  # (n, L) uint8
    r2: np.ndarray  # (n, L) uint8
    pos: np.ndarray  # (n,) int64: first base of the fragment, 0-based
    isize: np.ndarray  # (n,) int64: fragment length
    r1_rev: np.ndarray  # (n,) bool: R1 is read off the reverse strand
    subs: np.ndarray  # (2n,) substitution draws a read (R1s, then R2s)
    indels: np.ndarray  # (2n,) indel events in a read's source bases

    def __len__(self) -> int:
        return len(self.pos)


@dataclasses.dataclass
class Reads:
    """n single reads: codes 0-3 end to end, and where each came from."""

    seq: np.ndarray  # every read's codes, end to end (uint8)
    offset: np.ndarray  # (n + 1,) int64: read i is seq[offset[i]:offset[i+1]]
    start: np.ndarray  # (n,) int64: first reference base of its origin
    end: np.ndarray  # (n,) int64: last reference base of its origin
    rev: np.ndarray  # (n,) bool: read off the reverse strand
    subs: np.ndarray  # (n,) substitution draws in the read
    ins: np.ndarray  # (n,) insertion events in the read
    dels: np.ndarray  # (n,) deletion events in the read

    def __len__(self) -> int:
        return len(self.start)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offset)

    def read(self, i: int) -> np.ndarray:
        return self.seq[self.offset[i]: self.offset[i + 1]]


@dataclasses.dataclass
class Pool:
    """What a run cycles through: the simulator's record, the FASTQ files,
    and the chunks as ``cli mem`` plans them, counted in units (a pair or a
    read)."""

    truth: object  # Pairs or Reads
    paths: list  # the FASTQ files: R1 and R2, or one
    first: np.ndarray  # (chunks,) each chunk's first unit
    units: np.ndarray  # (chunks,) units in each chunk
    per_unit: int  # reads a unit: 2 in a pair, else 1
    n_processed: list  # each chunk's, as Runtime._execute passes it
    name: object  # a unit's index -> its QNAME (bytes)

    @property
    def reads(self) -> np.ndarray:
        """Reads in each chunk."""
        return self.units * self.per_unit


def pairs_per_chunk(chunk_bases: int, read_len: int) -> int:
    """Pairs in one chunk of equal-size paired files: mpiBWA closes a chunk
    once both mates' bases pass half of -K (mainParallel.c:947)."""
    return (chunk_bases // 2) // (2 * read_len) + 1


def chunk_counts(sizes: np.ndarray, maxsiz: int) -> np.ndarray:
    """Units in each closed chunk, when a chunk closes at the unit whose
    bases take it past maxsiz (mainParallel.c; single reads: maxsiz is -K,
    :2773); a last chunk that did not close is left out."""
    cs = np.cumsum(sizes)
    counts = []
    i0, base = 0, 0
    while True:
        j = int(np.searchsorted(cs, base + maxsiz, side="right"))
        if j >= len(cs):
            return np.array(counts, np.int64)
        counts.append(j + 1 - i0)
        i0, base = j + 1, int(cs[j])


def read_lengths(seed: int, traffic: dict, chunk_bases: int,
                 n_chunks: int) -> np.ndarray:
    """Lengths of the single reads that fill n_chunks whole chunks of
    chunk_bases: the mix's read_len, or drawn from its length distribution
    (lognormal of the stated mean and sd, draws outside min-max drawn
    again), from the seed's length stream."""
    if "read_len" in traffic:
        L = int(traffic["read_len"])
        return np.full(n_chunks * (chunk_bases // L + 1), L, np.int64)
    d = traffic["length"]
    if d["dist"] != "lognormal":
        raise ValueError(f"no length distribution {d['dist']!r}")
    sigma2 = np.log1p((d["sd"] / d["mean"]) ** 2)
    mu = np.log(d["mean"]) - sigma2 / 2
    rng = np.random.default_rng([seed, LENGTH_STREAM])
    lengths = np.zeros(0, np.int64)
    while len(chunk_counts(lengths, chunk_bases)) < n_chunks:
        draw = np.rint(rng.lognormal(mu, np.sqrt(sigma2), 4096)).astype(
            np.int64)
        ok = (draw >= d["min"]) & (draw <= d["max"])
        lengths = np.concatenate([lengths, draw[ok]])
    return lengths[: chunk_counts(lengths, chunk_bases)[:n_chunks].sum()]


def _starts(rng, genome: np.ndarray, n: int, span) -> np.ndarray:
    """n starts whose next span bases (one span, or one a start) hold no
    N."""
    isn = np.concatenate([[False], genome == 4, [False]]).view(np.int8)
    edges = np.flatnonzero(np.diff(isn))
    n_lo, n_hi = edges[0::2], edges[1::2]  # the N runs, [lo, hi)
    pos = np.empty(n, np.int64)
    todo = np.arange(n)
    while todo.size:
        sp = span if np.ndim(span) == 0 else span[todo]
        p = rng.integers(0, len(genome) - sp, todo.size)
        k = np.searchsorted(n_hi, p, side="right")
        ok = k == len(n_lo)
        if len(n_lo):
            ok |= n_lo[np.minimum(k, len(n_lo) - 1)] >= p + sp
        pos[todo[ok]] = p[ok]
        todo = todo[~ok]
    return pos


def _lengths(rng, count: int, extend: float) -> np.ndarray:
    """Indel lengths: 1 plus a geometric tail, at most INDEL_MAX."""
    return np.minimum(rng.geometric(1.0 - extend, count), INDEL_MAX)


def _mutate(rng, src: np.ndarray, read_len: int, indel_rate: float,
            extend: float, sub_rate: float):
    """Indels over the source bases, the first read_len bases of the
    result, then substitutions: (reads, substitution draws, deletion
    events, insertion events)."""
    u = rng.random(src.shape)
    dele = u < indel_rate / 2
    ins = u > 1 - indel_rate / 2
    events = dele | ins
    reads = src[:, :read_len].copy()
    rows = np.flatnonzero(events.any(1))  # the reads with an indel
    if rows.size:
        m, s = len(rows), src.shape[1]
        ins_len = np.zeros((m, s), np.int64)
        ins_len[ins[rows]] = _lengths(rng, int(ins[rows].sum()), extend)
        gone = np.zeros((m, s), bool)
        r, c = np.nonzero(dele[rows])
        d_len = _lengths(rng, len(r), extend)
        for k in range(INDEL_MAX):
            on = d_len > k
            gone[r[on], np.minimum(c[on] + k, s - 1)] = True
        keep = np.where(gone, 0, 1 + ins_len).ravel()
        tot = keep.reshape(m, s).sum(1)
        if (tot < read_len).any():
            raise ValueError("a read lost more bases than its source spares")
        pool = rng.integers(0, 4, int(ins_len.sum()) + 1, dtype=np.uint8)
        site = np.repeat(np.arange(m * s), keep)
        first = np.zeros(m * s + 1, np.int64)
        np.cumsum(keep, out=first[1:])
        j = np.arange(len(site)) - first[site]
        ins_first = np.zeros(m * s + 1, np.int64)
        np.cumsum(ins_len.ravel(), out=ins_first[1:])
        flat = np.where(j == 0, src[rows].ravel()[site],
                        pool[np.maximum(ins_first[site] + j - 1, 0)])
        row0 = np.zeros(m, np.int64)
        np.cumsum(tot[:-1], out=row0[1:])
        reads[rows] = flat[row0[:, None] + np.arange(read_len)]
    hit = rng.random(reads.shape) < sub_rate
    reads[hit] = rng.integers(0, 4, int(hit.sum()), dtype=np.uint8)
    return reads, hit.sum(1), dele.sum(1), ins.sum(1)


def simulate_pairs(genome: np.ndarray, n_pairs: int, seed: int,
                   traffic: dict) -> Pairs:
    """n_pairs pairs over genome (codes 0-3, 4 for N) from seed."""
    rng = np.random.default_rng(seed)
    L = int(traffic["read_len"])
    lo, hi = int(traffic["insert_min"]), int(traffic["insert_max"])
    src_len = L + SPARE
    if lo < src_len:
        raise ValueError("insert_min must leave room for a read's source")
    pos = _starts(rng, genome, n_pairs, hi + 10)
    isize = np.clip(rng.normal(traffic["insert_mean"], traffic["insert_sd"],
                               n_pairs), lo, hi).astype(np.int64)
    r1_rev = rng.random(n_pairs) < 0.5
    r1 = np.empty((n_pairs, L), np.uint8)
    r2 = np.empty((n_pairs, L), np.uint8)
    subs = np.empty(2 * n_pairs, np.int64)
    indels = np.empty(2 * n_pairs, np.int64)
    k = np.arange(src_len)
    for b0 in range(0, n_pairs, BLOCK):
        sl = slice(b0, min(b0 + BLOCK, n_pairs))
        p, ins_, rev = pos[sl], isize[sl], r1_rev[sl]
        fwd = genome[p[:, None] + k]
        back = 3 - genome[(p + ins_ - 1)[:, None] - k]
        src = np.concatenate([np.where(rev[:, None], back, fwd),
                              np.where(rev[:, None], fwd, back)])
        reads, n_sub, n_del, n_ins = _mutate(rng, src, L,
                                             traffic["indel_rate"],
                                             traffic["indel_extend"],
                                             traffic["sub_rate"])
        n_indel = n_del + n_ins
        n = sl.stop - sl.start
        r1[sl], r2[sl] = reads[:n], reads[n:]
        subs[sl], subs[n_pairs + sl.start: n_pairs + sl.stop] = \
            n_sub[:n], n_sub[n:]
        indels[sl], indels[n_pairs + sl.start: n_pairs + sl.stop] = \
            n_indel[:n], n_indel[n:]
    return Pairs(r1, r2, pos, isize, r1_rev, subs, indels)


def _source(genome: np.ndarray, pos: np.ndarray, src_len: np.ndarray,
            rev: np.ndarray, width: int) -> np.ndarray:
    """Each read's source, width bases from its 5' end: forward from pos,
    or reverse-complemented from pos + src_len - 1 down. Bases past a
    read's own src_len are filler that no read may reach."""
    start = np.where(rev, pos + src_len - width, pos)
    if start.min() < 0 or start.max() > len(genome) - width:
        raise ValueError("a read's source row leaves the genome")
    src = np.lib.stride_tricks.sliding_window_view(genome, width)[start]
    src[rev] = 3 - src[rev, ::-1]
    return src & 3


def _pbsim(rng, src: np.ndarray, lengths: np.ndarray, err: np.ndarray,
           ratio: np.ndarray):
    """PBSIM's errors over source rows: each step a deletion (a source base
    skipped), an insertion (a random base put out), a substitution (another
    base) or a match, at the read's error rate split by ratio; a read is
    its first `length` bases put out. Returns (bases end to end, first and
    last source base each read spans, substitutions, insertions,
    deletions inside it)."""
    m, w = src.shape
    u = rng.random((m, w))
    cut = np.cumsum(err[:, None] * ratio[None, ::-1], 1)  # del, ins, sub
    dele = u < cut[:, :1]
    ins = ~dele & (u < cut[:, 1:2])
    sub = ~dele & ~ins & (u < cut[:, 2:3])
    rank = np.cumsum(~dele, 1)  # bases put out up to this step
    if (rank[:, -1] < lengths).any():
        raise ValueError("a read ran past its source")
    keep = ~dele & (rank <= lengths[:, None])
    used = np.cumsum(~ins, 1)  # source bases taken up to this step
    r, c = np.nonzero(keep)
    base = src[r, np.maximum(used[r, c] - 1, 0)]
    on = sub[r, c]
    base[on] = (base[on] + rng.integers(1, 4, int(on.sum()),
                                        dtype=np.uint8)) % 4
    on = ins[r, c]
    base[on] = rng.integers(0, 4, int(on.sum()), dtype=np.uint8)
    rows = np.arange(m)
    first_c = np.argmax(keep, 1)
    last_c = w - 1 - np.argmax(keep[:, ::-1], 1)
    lo = used[rows, first_c] - ~ins[rows, first_c]
    hi = used[rows, last_c] - 1
    steps = np.arange(w)
    inside = (steps > first_c[:, None]) & (steps < last_c[:, None])
    return (base, lo, hi, (sub & keep).sum(1), (ins & keep).sum(1),
            (dele & inside).sum(1))


def simulate_reads(genome: np.ndarray, lengths: np.ndarray, seed: int,
                   traffic: dict) -> Reads:
    """Single reads of the given lengths over genome (codes 0-3, 4 for N)
    from seed: PBSIM's errors where the mix states an accuracy, else
    wgsim's as in simulate_pairs."""
    rng = np.random.default_rng(seed)
    n = len(lengths)
    acc = traffic.get("accuracy")
    spare = SPARE
    if acc is not None:  # room for the most deletions a read may take
        e = 1.0 - acc["min"]
        spare = SPARE + np.ceil(lengths * e / (1.0 - e)).astype(np.int64)
    src_len = lengths + spare
    pos = _starts(rng, genome, n, src_len)
    rev = rng.random(n) < 0.5
    offset = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=offset[1:])
    seq = np.empty(int(offset[-1]), np.uint8)
    lo = np.zeros(n, np.int64)
    hi = lengths - 1
    subs, ins, dels = (np.zeros(n, np.int64) for _ in range(3))
    if acc is None:
        for L in np.unique(lengths):
            rows = np.flatnonzero(lengths == L)
            for b0 in range(0, len(rows), BLOCK):
                b = rows[b0: b0 + BLOCK]
                src = _source(genome, pos[b], src_len[b], rev[b], L + SPARE)
                reads, subs[b], dels[b], ins[b] = _mutate(
                    rng, src, int(L), traffic["indel_rate"],
                    traffic["indel_extend"], traffic["sub_rate"])
                seq[offset[b][:, None] + np.arange(L)] = reads
    else:
        err = 1.0 - np.clip(rng.normal(acc["mean"], acc["sd"], n),
                            acc["min"], 1.0)
        r = traffic["error_ratio"]
        ratio = np.array([r["sub"], r["ins"], r["del"]], float)
        ratio /= ratio.sum()
        b0 = 0
        while b0 < n:
            w = int(src_len[b0])
            b1 = b0 + 1
            while b1 < n and (b1 - b0 + 1) * max(w, src_len[b1]) <= STEP_BLOCK:
                w = max(w, int(src_len[b1]))
                b1 += 1
            b = np.arange(b0, b1)
            src = _source(genome, pos[b], src_len[b], rev[b], w)
            base, lo[b], hi[b], subs[b], ins[b], dels[b] = _pbsim(
                rng, src, lengths[b], err[b], ratio)
            if (hi[b] >= src_len[b]).any():
                raise ValueError("a read ran past its source")
            seq[offset[b0]: offset[b1]] = base
            b0 = b1
    start = np.where(rev, pos + src_len - 1 - hi, pos + lo)
    end = np.where(rev, pos + src_len - 1 - lo, pos + hi)
    return Reads(seq, offset, start, end, rev, subs, ins, dels)


def pair_name(i: int) -> bytes:
    return b"p%0*d" % (NAME_DIGITS, i)


def read_name(i: int) -> bytes:
    return b"r%0*d" % (NAME_DIGITS, i)


def _records(reads: np.ndarray, ids: np.ndarray, prefix: bytes
             ) -> np.ndarray:
    """FASTQ records of reads (m, L) named <prefix><id>, one a row."""
    n, L = reads.shape
    c = 1 + len(prefix)
    w = c + NAME_DIGITS + 1 + L + 3 + L + 1
    rec = np.empty((n, w), np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1:c] = np.frombuffer(prefix, np.uint8)
    scale = 10 ** np.arange(NAME_DIGITS - 1, -1, -1, dtype=np.int64)
    rec[:, c: c + NAME_DIGITS] = ids[:, None] // scale % 10 + ord("0")
    c += NAME_DIGITS
    rec[:, c] = ord("\n")
    rec[:, c + 1: c + 1 + L] = np.frombuffer(b"ACGT", np.uint8)[reads]
    c += 1 + L
    rec[:, c: c + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, c + 3: c + 3 + L] = ord("I")
    rec[:, -1] = ord("\n")
    return rec


def fastq_bytes(seq: np.ndarray, offset: np.ndarray, prefix: bytes = b"p"
                ) -> bytes:
    """FASTQ of the reads seq[offset[i]:offset[i + 1]] (codes, offset[0]
    0) named <prefix><i> in NAME_DIGITS digits, quality I throughout:
    reads of one length as one array, others a length at a time."""
    lengths = np.diff(offset)
    n = len(lengths)
    ids = np.arange(n, dtype=np.int64)
    if n == 0 or (lengths == lengths[0]).all():
        L = int(lengths[0]) if n else 0
        return _records(seq.reshape(n, L), ids, prefix).tobytes()
    out = [b""] * n
    for L in np.unique(lengths):
        rows = ids[lengths == L]
        block = _records(seq[offset[rows][:, None] + np.arange(L)], rows,
                         prefix)
        for i, rec in zip(rows, block):
            out[i] = rec.tobytes()
    return b"".join(out)
