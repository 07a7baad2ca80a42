"""The read simulator and the synthetic genome."""

import json
import os

import numpy as np
import pytest

from conftest import BENCH
from harness import genome as G
from harness.simulate import (INDEL_MAX, SPARE, _lengths, fastq_bytes,
                              pair_name, pairs_per_chunk, simulate_pairs)

TRAFFIC = json.load(open(os.path.join(BENCH, "traffic", "pe101.json")))
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
    reads = np.array([[0, 1, 2, 3]], np.uint8)
    assert fastq_bytes(reads, 12) == b"@p000000012\nACGT\n+\nIIII\n"
    assert pair_name(12) == b"p000000012"
    # equal-size paired files: a chunk closes once both mates' bases
    # pass half of -K
    assert pairs_per_chunk(10_000_000, 101) == 24_753
    assert 202 * 24_753 > 5_000_000 >= 202 * 24_752


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
