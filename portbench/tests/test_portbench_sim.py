"""The read simulator and the synthetic genome."""

import json
import os

import numpy as np
import pytest

from conftest import BENCH
from harness import genome as G
from harness.simulate import (INDEL_MAX, SPARE, _lengths, chunk_counts,
                              fastq_bytes, pair_name, pairs_per_chunk,
                              read_lengths, read_name, simulate_pairs,
                              simulate_reads)

TRAFFIC = json.load(open(os.path.join(BENCH, "traffic", "pe101.json")))
SE = json.load(open(os.path.join(BENCH, "traffic", "se101.json")))
# PBSIM's continuous long reads: its default accuracy and error ratio (Ono,
# Asai and Hamada 2013), lengths 500-3,000 bp
CLR = {"length": {"dist": "lognormal", "mean": 1500, "sd": 700, "min": 500,
                  "max": 3000},
       "accuracy": {"mean": 0.78, "sd": 0.02, "min": 0.75},
       "error_ratio": {"sub": 10, "ins": 60, "del": 30}}
SPEC = json.load(open(os.path.join(BENCH, "configs",
                                   "hs249m-int32.json")))["genome"]


def _genome():
    return G.to_codes(G.make_chr1(SPEC, 400_000))


def test_same_seed_same_pairs_other_seed_other():
    g = _genome()
    a = simulate_pairs(g, 3000, 2**31 + 77, TRAFFIC)
    b = simulate_pairs(g, 3000, 2**31 + 77, TRAFFIC)
    c = simulate_pairs(g, 3000, 2**31 + 78, TRAFFIC)
    for f in ("r1", "r2", "pos", "isize", "r1_rev"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.pos, c.pos)


def test_inserts_errors_and_strands_follow_the_model():
    g = _genome()
    p = simulate_pairs(g, 60_000, 5, TRAFFIC)
    assert p.isize.min() >= 250 and p.isize.max() <= 750
    assert abs(p.isize.mean() - 500) < 1.5
    assert abs(p.isize.std() - 50) < 1.5
    assert abs(p.r1_rev.mean() - 0.5) < 0.01
    assert abs(p.subs.mean() / 101 - 0.015) < 0.0005
    assert abs(p.indels.mean() / (101 + SPARE) - 0.002) < 0.0002
    # no fragment touches an N
    span = p.pos[:, None] + np.arange(760)
    assert not (g[span] == 4).any()
    assert p.r1.max() < 4 and p.r2.max() < 4


def test_indel_lengths_are_wgsims():
    d = _lengths(np.random.default_rng(3), 200_000, 0.3)
    assert d.min() == 1 and d.max() <= INDEL_MAX
    assert abs((d == 1).mean() - 0.7) < 0.005
    assert abs(d.mean() - 1 / 0.7) < 0.01

def test_error_free_reads_are_the_fragment_ends():
    g = _genome()
    t = dict(TRAFFIC, sub_rate=0.0, indel_rate=0.0)
    p = simulate_pairs(g, 500, 3, t)
    for i in range(500):
        fwd = g[p.pos[i]: p.pos[i] + 101]
        end = p.pos[i] + p.isize[i]
        back = 3 - g[end - 101: end][::-1]
        r_f, r_b = (p.r2[i], p.r1[i]) if p.r1_rev[i] else (p.r1[i], p.r2[i])
        assert np.array_equal(r_f, fwd) and np.array_equal(r_b, back)


def test_fastq_records_and_chunk_size():
    reads = np.array([0, 1, 2, 3, 3, 2, 1, 0], np.uint8)
    assert fastq_bytes(reads, np.array([0, 4, 8])) == (
        b"@p000000000\nACGT\n+\nIIII\n@p000000001\nTGCA\n+\nIIII\n")
    assert fastq_bytes(reads[:5], np.array([0, 3, 4, 5]), b"r") == (
        b"@r000000000\nACG\n+\nIII\n@r000000001\nT\n+\nI\n"
        b"@r000000002\nT\n+\nI\n")
    assert pair_name(12) == b"p000000012" and read_name(3) == b"r000000003"
    # equal-size paired files: a chunk closes once both mates' bases
    # pass half of -K
    assert pairs_per_chunk(10_000_000, 101) == 24_753
    assert 202 * 24_753 > 5_000_000 >= 202 * 24_752
    # single reads: a chunk closes at the read that passes -K
    lengths = read_lengths(9, SE, 10_000_000, 2)
    assert (lengths == 101).all() and len(lengths) == 2 * 99_010
    assert chunk_counts(lengths, 10_000_000).tolist() == [99_010, 99_010]
    assert 101 * 99_010 > 10_000_000 >= 101 * 99_009
    assert chunk_counts(np.array([5, 3, 4, 9, 1, 1]), 7).tolist() == [2, 2]


def test_single_reads_follow_the_model_and_their_origin():
    g = _genome()
    lengths = read_lengths(4, SE, 200_000, 3)
    r = simulate_reads(g, lengths, 2**40 + 3, SE)
    again = simulate_reads(g, lengths, 2**40 + 3, SE)
    assert np.array_equal(r.seq, again.seq)
    assert np.array_equal(r.start, again.start)
    assert abs(r.rev.mean() - 0.5) < 0.03
    assert abs(r.subs.mean() / 101 - 0.015) < 0.002
    assert abs((r.ins + r.dels).mean() / (101 + SPARE) - 0.002) < 0.001
    clean = simulate_reads(g, lengths, 5, dict(SE, sub_rate=0.0,
                                               indel_rate=0.0))
    for i in range(300):
        src = g[clean.start[i]: clean.end[i] + 1]
        want = 3 - src[::-1] if clean.rev[i] else src
        assert np.array_equal(clean.read(i), want)


def test_long_reads_keep_their_lengths_and_error_ratio():
    g = _genome()
    lengths = read_lengths(2**33 + 1, CLR, 400_000, 3)
    assert lengths.min() >= 500 and lengths.max() <= 3000
    assert chunk_counts(lengths, 400_000).size == 3
    assert abs(np.mean(lengths) - 1500) < 100
    r = simulate_reads(g, lengths, 2**33 + 1, CLR)
    assert np.array_equal(r.lengths, lengths)
    errs = np.array([r.subs.sum(), r.ins.sum(), r.dels.sum()], float)
    # the stated 10:60:30 within 2 points each, and 22% errors a base
    assert np.abs(errs / errs.sum() - [0.1, 0.6, 0.3]).max() < 0.02
    assert abs(errs.sum() / lengths.sum() - 0.22 / (1 - 0.066)) < 0.02
    # no read's origin touches an N; its span follows its indels
    span = r.end - r.start + 1
    assert np.abs(span - (lengths - r.ins + r.dels)).max() <= 2
    for i in range(len(r)):
        assert (g[r.start[i]: r.end[i] + 1] < 4).all()


def test_genome_is_deterministic_with_its_holes():
    s = G.make_chr1(SPEC, 300_000)
    assert len(s) == 300_000
    assert np.array_equal(s, G.make_chr1(SPEC, 300_000))
    assert (s[:10_000] == ord("N")).all() and (s[-10_000:] == ord("N")).all()
    assert set(np.unique(s).tobytes()) <= set(b"ACGTN")
    assert G.spec_tag(SPEC) != G.spec_tag(dict(SPEC, seed=2))


def test_interspersed_copies_fill_their_shares_without_overlap():
    rng = np.random.default_rng(0)
    lengths = rng.integers(50, 500, 1000)
    starts = G._place(rng, lengths, 100, 400_000)
    order = np.argsort(starts)
    ends = starts[order] + lengths[order]
    assert starts.min() >= 100 and ends.max() <= 400_000
    assert (starts[order][1:] >= ends[:-1]).all()
    n = 2_000_000
    for fam in SPEC["families"]:
        ln, bases = G._family_copies(rng, fam, n)
        assert len(bases) == ln.sum() and bases.max() < 4
        assert ln.sum() / n == pytest.approx(fam["share"], rel=0.1)


def test_copies_diverge_from_their_unit_at_the_stated_rate():
    fam = {"share": 0.05, "unit": 300, "div_min": 0.1, "div_max": 0.1}
    ln, bases = G._family_copies(np.random.default_rng(1), fam, 3_000_000)
    copies = bases.reshape(-1, 300)
    # the consensus is each column's commonest base on the forward copies
    # and its complement on the reverse ones; measure against copy 0
    ref = copies[0]
    fwd = (copies == ref).mean(1) > 0.5
    rev = (copies[:, ::-1] == 3 - ref).mean(1) > 0.5
    assert (fwd | rev).all() and 0.4 < fwd.mean() < 0.6
    cons = np.where(fwd[:, None], copies, 3 - copies[:, ::-1])
    top = np.array([np.bincount(c, minlength=4).argmax() for c in cons.T])
    assert (cons != top).mean() == pytest.approx(0.1, abs=0.01)
