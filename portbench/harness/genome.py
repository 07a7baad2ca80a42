"""The synthetic reference of the hs249m configurations.

A chromosome of random bases into which repeat families and segmental
duplications are planted at the shares the configuration's ``genome``
group gives (taken from the published composition of the human genome),
with N holes as in an assembly. The FASTA writer is a frozen copy of
``chip_smoke.build_genome``'s. Plain NumPy: the benchmark's generator and
its reference both read this module, and it imports nothing of the
program.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

CHR1_LEN = 248_956_422  # GRCh38 chr1
CODES = np.full(256, 4, np.uint8)
CODES[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def spec_tag(spec: dict) -> str:
    """A short digest of a genome group: a cache made from another spec
    is never taken for this one."""
    text = json.dumps(spec, sort_keys=True).encode()
    return hashlib.sha256(text).hexdigest()[:12]


def _copy_lengths(rng, fam: dict, count: int) -> np.ndarray:
    """Copy lengths of a family: its whole unit, or with copy_mean below
    the unit, 5'-truncated copies of copy_min plus an exponential tail,
    at most the unit."""
    unit = int(fam["unit"])
    mean = int(fam.get("copy_mean", unit))
    if mean >= unit:
        return np.full(count, unit, np.int64)
    lo = int(fam.get("copy_min", 1))
    ln = lo + rng.exponential(mean - lo, count).astype(np.int64)
    return np.minimum(ln, unit)


def _mutate(rng, bases: np.ndarray, rate: np.ndarray) -> None:
    """Substitute each base, in place, with probability rate (per base):
    always by another base, so that rate is the divergence."""
    hit = rng.random(len(bases)) < rate
    bases[hit] = (bases[hit] + rng.integers(1, 4, int(hit.sum()),
                                            dtype=np.uint8)) % 4


def _segments(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flat positions start_i + j, j < length_i, for every segment."""
    first = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=first[1:])
    seg = np.repeat(np.arange(len(lengths)), lengths)
    return starts[seg] + (np.arange(first[-1]) - first[seg])


def _family_copies(rng, fam: dict, n: int):
    """(lengths, bases) of one family's copies, as many as reach its share
    of n bases: each copy the 3' end of one of the family's consensus
    units, diverged by its own rate in [div_min, div_max], on either
    strand."""
    unit = int(fam["unit"])
    nfam = int(fam.get("families", 1))
    mean = min(int(fam.get("copy_mean", unit)), unit)
    target = float(fam["share"]) * n
    drawn = _copy_lengths(rng, fam, int(2 * target / mean) + 2)
    count = int(np.searchsorted(np.cumsum(drawn), target)) + 1
    lengths = drawn[:count]  # the first copies that reach the share
    cons = rng.integers(0, 4, (nfam, unit), dtype=np.uint8)
    which = rng.integers(0, nfam, count)
    div = rng.uniform(float(fam["div_min"]), float(fam["div_max"]), count)
    rev = rng.random(count) < 0.5
    first = np.zeros(count + 1, np.int64)
    np.cumsum(lengths, out=first[1:])
    seg = np.repeat(np.arange(count), lengths)
    j = np.arange(first[-1]) - first[seg]
    ln = lengths[seg]
    col = np.where(rev[seg], unit - 1 - j, unit - ln + j)
    bases = cons[which[seg], col]
    bases = np.where(rev[seg], 3 - bases, bases).astype(np.uint8)
    _mutate(rng, bases, div[seg])
    return lengths, bases


def _place(rng, lengths: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Starts for segments of these lengths, in a random order and with
    random gaps, that do not overlap and all lie in [lo, hi)."""
    k = len(lengths)
    free = (hi - lo) - int(lengths.sum())
    if free < 0:
        raise ValueError("the repeat shares exceed the genome")
    order = rng.permutation(k)
    cuts = np.sort(rng.integers(0, free + 1, k))
    ln = lengths[order]
    before = np.zeros(k, np.int64)
    np.cumsum(ln[:-1], out=before[1:])
    starts = np.empty(k, np.int64)
    starts[order] = lo + cuts + before
    return starts


def make_chr1(spec: dict, n: int) -> np.ndarray:
    """ASCII bases of the configuration's chromosome, scaled to length n.

    spec is the configuration's ``genome`` group: ``seed``; ``families``,
    each with its ``share`` of the bases, consensus ``unit`` length,
    ``families`` (consensus units), copy lengths (``copy_mean``,
    ``copy_min``) and divergence (``div_min``, ``div_max``); the
    ``segdups`` (``share``, log-uniform ``len_min``-``len_max``, identity
    ``identity_min``-``identity_max``: copies of stretches elsewhere);
    ``n_holes`` (``end`` bases at both ends, ``count`` gaps per chr1
    length of ``len_min``-``len_max``). Interspersed copies do not
    overlap one another; duplications are laid over the result."""
    rng = np.random.default_rng(int(spec["seed"]))
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    holes = spec["n_holes"]
    edge = int(holes["end"])
    lens, parts = [], []
    for fam in spec["families"]:
        ln, bases = _family_copies(rng, fam, n)
        lens.append(ln)
        parts.append(bases)
    if lens:
        lengths = np.concatenate(lens)
        starts = _place(rng, lengths, edge, n - edge)
        codes[_segments(starts, lengths)] = np.concatenate(parts)
        del parts
    sd = spec.get("segdups")
    if sd:
        target = float(sd["share"]) * n
        lo, hi = np.log(float(sd["len_min"])), np.log(float(sd["len_max"]))
        done = 0
        while done < target:
            ln = int(np.exp(rng.uniform(lo, hi)))
            src = int(rng.integers(edge, n - edge - ln))
            dst = int(rng.integers(edge, n - edge - ln))
            c = codes[src: src + ln].copy()
            if rng.random() < 0.5:
                c = (3 - c[::-1]).astype(np.uint8)
            ident = rng.uniform(float(sd["identity_min"]),
                                float(sd["identity_max"]))
            _mutate(rng, c, np.full(ln, 1.0 - ident))
            codes[dst: dst + ln] = c
            done += ln
    ascii_ = np.frombuffer(b"ACGT", np.uint8)[codes]
    ascii_[:edge] = ord("N")
    ascii_[n - edge:] = ord("N")
    g_lo, g_hi = int(holes["len_min"]), int(holes["len_max"])
    count = max(1, int(int(holes["count"]) * n / CHR1_LEN))
    for pos in rng.integers(edge, n - edge - g_hi, count):
        ascii_[pos: pos + int(rng.integers(g_lo, g_hi))] = ord("N")
    return ascii_


def to_codes(ascii_: np.ndarray) -> np.ndarray:
    """ASCII bases -> codes 0-3, N (anything else) 4."""
    return CODES[ascii_]


def write_fasta(path: str, name: str, seq: np.ndarray) -> None:
    """One contig, 60 bases a line."""
    n = len(seq)
    with open(path, "wb") as fh:
        fh.write(b">" + name.encode() + b" synthetic\n")
        full = n // 60 * 60
        lines = np.empty((n // 60, 61), np.uint8)
        lines[:, :60] = seq[:full].reshape(-1, 60)
        lines[:, 60] = ord("\n")
        fh.write(lines.tobytes())
        if full < n:
            fh.write(seq[full:].tobytes() + b"\n")
