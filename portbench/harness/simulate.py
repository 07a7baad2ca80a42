"""Illumina-like read pairs from a seed, in bulk.

The model of ``tests/_torch_toy.simulate_pairs`` in vectorised form, with
wgsim's indel lengths: FR pairs with the insert drawn from N(mean, sd)
and clipped, R1 on either strand with equal odds, then on each read
indels (per source base, each at half the indel rate: a deletion of it
and the bases after it, or an insertion of random bases after it; a
length of 1 plus a geometric tail with the mix's extension probability,
at most INDEL_MAX) followed by substitutions (a random base, which may be
the same one). Fragments are drawn uniformly over the stretches of the
reference that hold no N, where sequencers read. Plain NumPy; it imports
nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BLOCK = 1 << 16  # reads mutated at once: fixes the order of the draws
NAME_DIGITS = 9
INDEL_MAX = 10  # bases an indel spans at most
SPARE = 64  # source bases past a read's end, for its deletions


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


def pairs_per_chunk(chunk_bases: int, read_len: int) -> int:
    """Pairs in one chunk of equal-size paired files: mpiBWA closes a chunk
    once both mates' bases pass half of -K (mainParallel.c:947)."""
    return (chunk_bases // 2) // (2 * read_len) + 1


def _starts(rng, genome: np.ndarray, n: int, span: int) -> np.ndarray:
    """n fragment starts whose next span bases hold no N."""
    isn = np.concatenate([[False], genome == 4, [False]]).view(np.int8)
    edges = np.flatnonzero(np.diff(isn))
    n_lo, n_hi = edges[0::2], edges[1::2]  # the N runs, [lo, hi)
    pos = np.empty(n, np.int64)
    todo = np.arange(n)
    while todo.size:
        p = rng.integers(0, len(genome) - span, todo.size)
        k = np.searchsorted(n_hi, p, side="right")
        ok = k == len(n_lo)
        if len(n_lo):
            ok |= n_lo[np.minimum(k, len(n_lo) - 1)] >= p + span
        pos[todo[ok]] = p[ok]
        todo = todo[~ok]
    return pos


def _lengths(rng, count: int, extend: float) -> np.ndarray:
    """Indel lengths: 1 plus a geometric tail, at most INDEL_MAX."""
    return np.minimum(rng.geometric(1.0 - extend, count), INDEL_MAX)


def _mutate(rng, src: np.ndarray, read_len: int, indel_rate: float,
            extend: float, sub_rate: float
            ) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """Indels over the source bases, the first read_len bases of the
    result, then substitutions: (reads, substitution draws, indels)."""
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
    return reads, hit.sum(1), events.sum(1)


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
        reads, n_sub, n_indel = _mutate(rng, src, L,
                                        traffic["indel_rate"],
                                        traffic["indel_extend"],
                                        traffic["sub_rate"])
        n = sl.stop - sl.start
        r1[sl], r2[sl] = reads[:n], reads[n:]
        subs[sl], subs[n_pairs + sl.start: n_pairs + sl.stop] = \
            n_sub[:n], n_sub[n:]
        indels[sl], indels[n_pairs + sl.start: n_pairs + sl.stop] = \
            n_indel[:n], n_indel[n:]
    return Pairs(r1, r2, pos, isize, r1_rev, subs, indels)


def pair_name(i: int) -> bytes:
    return b"p%0*d" % (NAME_DIGITS, i)


def fastq_bytes(reads: np.ndarray, first: int) -> bytes:
    """FASTQ of reads (codes) named p<first + i>, quality I throughout:
    fixed-width records built as one array."""
    n, L = reads.shape
    w = 1 + 1 + NAME_DIGITS + 1 + L + 3 + L + 1
    rec = np.empty((n, w), np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1] = ord("p")
    ids = np.arange(first, first + n, dtype=np.int64)
    scale = 10 ** np.arange(NAME_DIGITS - 1, -1, -1, dtype=np.int64)
    rec[:, 2: 2 + NAME_DIGITS] = ids[:, None] // scale % 10 + ord("0")
    c = 2 + NAME_DIGITS
    rec[:, c] = ord("\n")
    rec[:, c + 1: c + 1 + L] = np.frombuffer(b"ACGT", np.uint8)[reads]
    c += 1 + L
    rec[:, c: c + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, c + 3: c + 3 + L] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()
