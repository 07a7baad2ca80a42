"""The mixes' pieces found by name: the options the program is given, the
paired pool that the existing cells read, and a long-read mix that no
file of the harness names."""

import dataclasses
import hashlib
import json
import os
import types

import numpy as np
import pytest

from harness import cell as C
from harness import genome as G
from harness import program
from harness.spec import BENCH, Cell, load_cell, mix_module


def _cli_opt(monkeypatch, tmp_path, argv, paired):
    """The mem_opt that `cli mem` hands to its Runtime for argv."""
    import mpibwa_tpu_torch.index.format as F
    import mpibwa_tpu_torch.parallel.runtime as RT
    from mpibwa_tpu_torch import cli

    class Built(Exception):
        pass

    def runtime(idx, opt, **kw):
        raise Built(opt)

    ref = str(tmp_path / "ref.fa")
    for ext in (".bwt", ".sa", ".ann", ".amb", ".pac"):
        open(ref + ext, "w").close()
    fqs = [str(tmp_path / f"r{m}.fq") for m in (1, 2)[: 1 + paired]]
    for fq in fqs:
        open(fq, "w").close()
    monkeypatch.setattr(F, "load_index", lambda path: types.SimpleNamespace(
        anns=[]))
    monkeypatch.setattr(RT, "Runtime", runtime)
    monkeypatch.setenv("MPIBWA_WORKERS", "1")
    monkeypatch.delenv("MPIBWA_DEVICES", raising=False)
    with pytest.raises(Built) as got:
        cli.main_mem(argv + ["-o", str(tmp_path / "out"), ref, *fqs])
    opt = got.value.args[0]
    if paired:  # Runtime.run's own addition for two files
        from mpibwa_tpu_torch.core import opts as O

        opt.flag |= O.MEM_F_PE
    return opt


CONFIG = json.load(open(os.path.join(BENCH, "configs",
                                     "hs249m-int32.json")))


@pytest.mark.parametrize("options", [
    CONFIG["mem_options"],
    dict(CONFIG["mem_options"], x="pacbio"),
    {"x": "ont2d"},
    {"x": "intractg", "t": 2},
    {"x": "pacbio", "B": 3},
    {"A": 2, "O": "5,7", "L": 3, "r": 1.2, "a": True, "h": "5,100",
     "Q": 40, "X": 0.4, "D": 0.4, "M": True, "k": 21}])
@pytest.mark.parametrize("paired", [True, False])
def test_make_opt_is_the_clis_opt(monkeypatch, tmp_path, options, paired):
    want = _cli_opt(monkeypatch, tmp_path, program.mem_argv(options), paired)
    got = program.make_opt(dict(options, K=10_000_000), paired)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (np.array_equal(a, b) if f.name == "mat" else a == b), f.name


def test_make_opt_refuses_what_sets_no_opt_field():
    with pytest.raises(ValueError):
        program.make_opt({"o": "out"}, True)


# Taken from the parent commit's harness (d55612c, its simulate_pairs,
# fastq_bytes, pairs_per_chunk and the program's scan_fastq + chunk_pe),
# 2 Mbp of hs249m's genome, seed 2**31 + 11 at the rehearsal's -K and
# 2**33 + 5 at the configurations' -K: sha256 of R1's then R2's bytes.
PARENT_POOLS = [
    (100_000, 6, 2**31 + 11,
     "8d6706760440b920fc30d4359fadb54a4dbc175c9ef8b13d1ccc83ed8a93ca17"),
    (10_000_000, 2, 2**33 + 5,
     "ad11fb683516d6da0474f4eac194ce0df9938f6ea36ffa3439ed622c075fcb43")]


@pytest.mark.parametrize("K,n_chunks,seed,digest", PARENT_POOLS)
def test_the_paired_pool_and_plan_are_the_parents(tmp_path, K, n_chunks, seed,
                                                  digest):
    codes = G.to_codes(G.make_chr1(CONFIG["genome"], 2_000_000))
    traffic = load_cell("int32.pe101").traffic
    gen = mix_module(traffic, "generator")
    pool = gen.pool(codes, C.seed_entropy(seed), traffic, K, n_chunks,
                    str(tmp_path))
    h = hashlib.sha256()
    for path in pool.paths:
        h.update(open(path, "rb").read())
    assert h.hexdigest() == digest
    per = K // 2 // 202 + 1
    opt = program.make_opt(CONFIG["mem_options"], gen.PAIRED)
    plan = program.plan(pool.paths, K, opt)
    assert plan.is_pe and plan.untrimmed
    assert [(c.start, c.count) for c in plan.chunks] == [
        (i * per, per) for i in range(n_chunks)]
    assert pool.n_processed == [0] * n_chunks
    assert pool.reads.tolist() == [2 * per] * n_chunks


def test_the_sink_keeps_the_parents_sample():
    """The same records give the same sampled pairs as the parent's Sink
    (d55612c: sha256 of repr of its sample(300))."""
    from harness.simulate import Pool, pair_name
    from harness.window import Sink

    first, n = np.arange(6) * 248, np.full(6, 248)
    sink = Sink(Pool(None, [], first, n, 2, [0] * 6, pair_name),
                (2**31 + 11) % (1 << 64), 75)
    for k in range(4, 12):
        ci = k % 6
        sink.put(k, ci, [pair_name(int(first[ci]) + (i >> 1)) + b"\t%d\n" % i
                         for i in range(2 * 248)])
    got = sink.sample(300)
    assert sink.missing == 0 and len(got) == 300
    assert hashlib.sha256(repr(got).encode()).hexdigest() == (
        "5ce654cf85a70e89baab068df1aba6c51dca09c7b66bb3a2432ae617843b47cf")


def test_a_limit_on_a_number_no_check_computes_is_an_error():
    with pytest.raises(KeyError):
        C.judge({"bad_records": 0}, {"bad_records": 0, "bad_mate": 0})


# PBSIM's continuous long reads (Ono, Asai and Hamada 2013): its default
# accuracy and sub:ins:del ratio, lengths 500-3,000 bp, under -x pacbio.
# No traffic file and no harness file names it.
LONG = {"generator": "reads", "check": "reads",
        "length": {"dist": "lognormal", "mean": 1500, "sd": 700, "min": 500,
                   "max": 3000},
        "accuracy": {"mean": 0.78, "sd": 0.02, "min": 0.75},
        "error_ratio": {"sub": 10, "ins": 60, "del": 30},
        "pool_chunks": 1, "sample_reads": 8,
        "limits": {"missing_records": 0, "bad_records": 0,
                   "bad_alignment": 0}}


def test_a_long_read_mix_runs_by_files_alone(monkeypatch):
    import torch

    monkeypatch.setenv("MPIBWA_TORCH_DEVICE", "cpu")
    # a few reads a chunk, one worker: the host engine takes each
    monkeypatch.setitem(C.REHEARSAL, "K", 4000)
    monkeypatch.setitem(C.REHEARSAL, "pool_chunks", 1)
    config = dict(CONFIG, mem_options={"t": 1, "x": "pacbio"})
    cell = Cell("long.clr", 1, "hs249m-int32", config, "clr", LONG, [], [])
    s = C.Setup(cell, torch.device("cpu"), True)
    try:
        assert s.opt.min_seed_len == 17 and s.opt.b == 1  # the preset's
        win, sink, pool, *_ = s.window(s.aligners, 2**32 + 9, 0.5,
                                       warm=False)
        nums = s.check(sink, pool)
    finally:
        s.close()
    assert pool.truth.lengths.min() >= 500 and len(pool.truth) >= 2
    assert win.chunks == 1 and win.attempted == len(pool.truth)
    correct, checks = C.judge(nums, LONG["limits"])
    assert correct, checks


def test_the_reads_check_holds_every_line_to_its_read():
    from harness.simulate import Reads

    reads_check = mix_module({"check": "reads"}, "check")
    g = np.random.default_rng(3).integers(0, 4, 600).astype(np.uint8)
    truth = Reads(g[100:200].copy(), np.array([0, 100]), np.array([100]),
                  np.array([199]), np.array([False]), *np.zeros((3, 1)))
    seq = "".join("ACGT"[c] for c in g[100:200])

    def line(flag, pos, cigar, s, md, nm=0, a=None):
        a = a if a is not None else len(s)
        return "\t".join(["r000000000", str(flag), "chr1", str(pos), "60",
                          cigar, "*", "0", "0", s, "I" * len(s),
                          f"NM:i:{nm}", f"MD:Z:{md}", f"AS:i:{a}"])

    primary = line(0, 101, "60M40S", seq, "60", a=60)
    supp = line(2048, 161, "60H40M", seq[60:], "40")
    traffic = {"limits": {"bad_records": 0, "bad_alignment": 0,
                          "score_miss_pct": 100}}

    def nums(text):
        got = reads_check.check([(0, text)], truth, g, "chr1",
                                CONFIG["scoring"], traffic)
        return got["bad_records"], got["bad_alignment"]

    assert nums(primary + "\n" + supp + "\n") == (0, 0)
    assert nums(primary + "\n" + supp.replace("MD:Z:40", "MD:Z:39A0")
                + "\n") == (0, 1)
    assert nums(primary.replace("\t0\t", "\t1\t", 1) + "\n") == (1, 0)
    assert nums(primary + "\n" + primary + "\n") == (1, 0)
    assert nums(primary.replace("r000000000", "r000000001") + "\n") == (1, 0)
    assert nums("") == (1, 0)
    assert set(reads_check.check([(0, primary)], truth, g, "chr1",
                                 CONFIG["scoring"], {"limits": {}})) == {
        "bad_records", "bad_alignment"}
