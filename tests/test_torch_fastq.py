"""The FASTQ chunk parser and the steps that slice its columns.

``io/fastq.py`` ``load_columns`` (``native/fastq.c``, one C call a chunk)
against the per-read loader it stands beside (``FastqIndex.load``, and
``ChunkPlan.get_batch`` without the C runtime) and the JAX package's
loader, field for field, on edge-case files: CRLF, no trailing newline, a
trailing blank line, ``/1``, ``/2`` and ``/x`` names, space, tab and
tab-then-space headers with and without ``-C``, a quality line starting
with ``@``, a zero-length read, trimmed mates, smart pairing and a
70,000-bp read. Then the consumers: ``NativeFinalizer._pack_blobs`` and
``device_seed._pad_batch`` on a batch's columns against their per-read
loops, byte for byte (whole chunk, the C ranges of ``_cuts``, a padded
microbatch tail), and the counters of ``DeviceAligner.stats`` on the
chunk path and on a plain list of reads.
"""

import types

import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401

torch.set_num_threads(1)  # test workers run in parallel on few cores


LONG_BP = 70_000

# (header, sequence, quality) of the edge-case reads
RECORDS = [
    ("@r1/1", "ACGTNacgtn", "IIIIIIIIII"),
    ("@r1/2 BC:Z:ACGT extra words", "TTGCA", "@@III"),  # quality from '@'
    ("@r2/x\tBC:Z:1", "GATTACA", "#######"),
    ("@r3\ttab comment then space", "CCCC", "ABCD"),
    ("@r4 ", "G", "I"),  # a space and an empty comment
    ("@r5", "", ""),  # zero-length read
    ("@r6/3 c\td", "NNNNACGT", "!!!!IIII"),
    ("@", "AC", "II"),  # empty name
]


def _text(records, eol="\n", tail="\n"):
    lines = []
    for h, s, q in records:
        lines += [h, s, "+", q]
    return eol.join(lines) + (tail.replace("\n", eol) if tail else "")


def _long_records(rng):
    seq = "".join(rng.choice(list("ACGT"), LONG_BP))
    return RECORDS[:3] + [("@long/1 wide", seq, "I" * LONG_BP)] + RECORDS[3:]


def _write(path, text):
    with open(path, "wb") as f:
        f.write(text.encode())
    return str(path)


FILES = {  # name: (records, eol, tail)
    "lf": (RECORDS, "\n", "\n"),
    "crlf": (RECORDS, "\r\n", "\n"),
    "no_trailing_newline": (RECORDS, "\n", ""),
    "crlf_no_trailing_newline": (RECORDS, "\r\n", ""),
    "trailing_blank_line": (RECORDS, "\n", "\n\n"),
    "long": (None, "\n", "\n"),
}


def _file(tmp_path, name):
    records, eol, tail = FILES[name]
    if records is None:
        records = _long_records(np.random.default_rng(7))
    return _write(tmp_path / f"{name}.fq", _text(records, eol, tail))


def _fields(reads):
    return [(r.name, r.seq.tobytes(), r.qual, r.comment) for r in reads]


@pytest.mark.parametrize("copy_comment", [False, True], ids=["", "C"])
@pytest.mark.parametrize("name", list(FILES))
def test_chunk_parse_matches_loaders(tmp_path, name, copy_comment):
    """load_columns over whole files and sub-ranges equals
    FastqIndex.load and the JAX package's loader, field for field."""
    from mpibwa_tpu.io import fastq as jax_fastq
    from mpibwa_tpu_torch.io.columns import ReadBatch
    from mpibwa_tpu_torch.io.fastq import load_columns, scan_fastq

    path = _file(tmp_path, name)
    idx = scan_fastq(path)
    jidx = jax_fastq.scan_fastq(path)
    n = len(idx)
    assert n == len(RECORDS) + (name == "long")
    for lo, hi in ((0, n), (1, n - 1), (2, 3), (n - 1, n)):
        got = load_columns([(idx, lo, hi)], copy_comment)
        assert isinstance(got, ReadBatch)
        want = idx.load(lo, hi, copy_comment)
        assert _fields(got) == _fields(want)
        assert _fields(got) == _fields(jidx.load(lo, hi, copy_comment))
    comments = {r.name: r.comment
                for r in load_columns([(idx, 0, n)], copy_comment)}
    want = {"r1": "BC:Z:ACGT extra words", "r2/x": "BC:Z:1",
            "r3\ttab": "comment then space", "r4": "", "r5": None,
            "r6": "c\td", "": None}
    for k, c in want.items():
        assert comments[k] == (c if copy_comment else None), k


def _plan(paths, smart=False, copy_comment=False):
    from mpibwa_tpu_torch.io.fastq import scan_fastq
    from mpibwa_tpu_torch.parallel.chunker import chunk_pe, chunk_se
    from mpibwa_tpu_torch.parallel.runtime import ChunkPlan

    idx1 = scan_fastq(paths[0])
    if smart:
        chunks = chunk_pe(idx1.l_seq[0::2], idx1.l_seq[1::2], 20_000, True)
        return ChunkPlan(chunks, True, False, idx1, None, True, copy_comment)
    if len(paths) == 1:
        return ChunkPlan(chunk_se(idx1.l_seq, 20_000), False, False, idx1,
                         None, False, copy_comment)
    idx2 = scan_fastq(paths[1])
    chunks = chunk_pe(idx1.l_seq, idx2.l_seq, 20_000, True)
    return ChunkPlan(chunks, True, False, idx1, idx2, False, copy_comment)


@pytest.fixture(scope="module")
def toy_paths(tmp_path_factory):
    return toy.build_toy(str(tmp_path_factory.mktemp("toy")), n_pairs=600)


@pytest.fixture(scope="module")
def trimmed(toy_paths, tmp_path_factory):
    """R2 with each read cut to 40-101 bp (trimmed PE)."""
    rng = np.random.default_rng(3)
    lines = open(toy_paths["r2"]).read().splitlines()
    out = []
    for i in range(0, len(lines), 4):
        k = int(rng.integers(40, 102))
        out += [lines[i] + " trimmed", lines[i + 1][:k], "+",
                lines[i + 3][:k]]
    return _write(tmp_path_factory.mktemp("trim") / "t2.fq",
                  "\r\n".join(out) + "\r\n")


@pytest.mark.parametrize("copy_comment", [False, True], ids=["", "C"])
@pytest.mark.parametrize("route", ["se", "pe", "trimmed_pe", "smart"])
def test_get_batch_matches_per_read_route(toy_paths, trimmed, monkeypatch,
                                          route, copy_comment):
    """Every chunk of ChunkPlan.get_batch, columns against the per-read
    route it takes without the C runtime (MPIBWA_NATIVE=0)."""
    from mpibwa_tpu_torch.io.columns import ReadBatch

    paths = {"se": [toy_paths["r1"]], "pe": [toy_paths["r1"],
                                               toy_paths["r2"]],
             "trimmed_pe": [toy_paths["r1"], trimmed],
             "smart": [toy_paths["r1"]]}[route]
    plan = _plan(paths, smart=route == "smart", copy_comment=copy_comment)
    assert len(plan.chunks) >= 3
    got = [plan.get_batch(ci) for ci in range(len(plan.chunks))]
    monkeypatch.setenv("MPIBWA_NATIVE", "0")
    want = [plan.get_batch(ci) for ci in range(len(plan.chunks))]
    for g, w in zip(got, want):
        assert isinstance(g, ReadBatch) and not isinstance(w, ReadBatch)
        assert _fields(g) == _fields(w)
        assert len(g) == len(g.cols)
    if route == "trimmed_pe":
        assert got[0][1].comment == ("trimmed" if copy_comment else None)


def test_non_ascii_header_takes_per_read_loader(tmp_path):
    """A header the loader decodes as UTF-8 sends the chunk back to it."""
    from mpibwa_tpu_torch.io.fastq import load_columns, scan_fastq

    recs = RECORDS[:2] + [("@ré/1 café", "ACGT", "IIII")]
    idx = scan_fastq(_write(tmp_path / "u.fq", _text(recs)))
    assert load_columns([(idx, 0, 3)]) is None
    assert load_columns([(idx, 0, 2)]) is not None
    plan = _plan([idx.path])
    assert _fields(plan.get_batch(0)) == _fields(idx.load(0, 3))
    assert plan.get_batch(0)[2].name == "ré"


# -- the consumers: column slices against the per-read loops ----------------


def _blobs_equal(got, want):
    """_pack_blobs outputs equal byte for byte: the offsets, and the
    blobs up to their last offset (the loop ends each text blob with a
    NUL that C never reads: it takes lengths)."""
    for k in range(0, 8, 2):
        g, w, off = got[k], want[k], want[k + 1]
        np.testing.assert_array_equal(got[k + 1], off)
        assert g.dtype == w.dtype == np.uint8
        assert g[: off[-1]].tobytes() == w[: off[-1]].tobytes()


@pytest.fixture(scope="module")
def chunk(toy_paths, trimmed):
    """(batch with columns, the same reads as a plain list of BSeq):
    trimmed PE with comments, so lengths and comments vary."""
    from mpibwa_tpu_torch.io.fastq import scan_fastq

    plan = _plan([toy_paths["r1"], trimmed], copy_comment=True)
    plan.chunks = [types.SimpleNamespace(start=0, count=len(plan.idx1))]
    batch = plan.get_batch(0)
    r1 = scan_fastq(toy_paths["r1"]).load(0, len(plan.idx1), True)
    r2 = scan_fastq(trimmed).load(0, len(plan.idx1), True)
    return batch, [x for p in zip(r1, r2) for x in p]


@pytest.mark.parametrize("part", ["whole", "cuts", "padded_tail"])
def test_pack_blobs_and_pad_batch_slices_match_loops(chunk, part):
    from mpibwa_tpu_torch.io.columns import ReadBatch, seq_source
    from mpibwa_tpu_torch.pipeline.device_align import DeviceAligner
    from mpibwa_tpu_torch.pipeline.device_seed import _pad_batch
    from mpibwa_tpu_torch.pipeline.native_final import (NativeFinalizer,
                                                        _cuts)

    batch, plain = chunk
    n = len(batch)
    if part == "whole":
        pairs = [(batch, plain)]
    elif part == "cuts":
        pairs = [(batch[lo:hi], plain[lo:hi])
                 for T in (3, 7) for pe in (False, True)
                 for lo, hi in zip(_cuts(n, T, pe)[:-1], _cuts(n, T, pe)[1:])]
    else:  # a tail of 1000 - 512 reads padded to 512 with dummy reads
        sub_b, sub_p = batch[:1000], plain[:1000]
        mb = types.SimpleNamespace(MICROBATCH=512)
        (_, pb0), (tb, pb) = DeviceAligner._microbatches(mb, sub_b)
        (_, pp0), (tp, pp) = DeviceAligner._microbatches(mb, sub_p)
        assert len(pb) == len(pp) == 512 and len(tb) == 488
        assert isinstance(pb, ReadBatch) and isinstance(pb0, ReadBatch)
        assert _fields(pb) == _fields(pp)
        pairs = [(pb0, pp0), (pb, pp), (tb, tp)]
    for got, want in pairs:
        assert isinstance(got, ReadBatch) and type(want) is list
        _blobs_equal(NativeFinalizer._pack_blobs(got),
                     NativeFinalizer._pack_blobs(want))
        q, lens = _pad_batch(seq_source(got))
        q0, lens0 = _pad_batch([s.seq for s in want])
        np.testing.assert_array_equal(lens, lens0)
        np.testing.assert_array_equal(q, q0)
        assert lens.dtype == lens0.dtype and q.dtype == q0.dtype


@pytest.mark.parametrize("shape", ["equal", "long_among_short", "empty"])
def test_pad_batch_columns_match_loop(shape):
    from mpibwa_tpu_torch.core.pipeline import BSeq
    from mpibwa_tpu_torch.io.columns import ReadColumns
    from mpibwa_tpu_torch.pipeline.device_seed import _pad_batch

    rng = np.random.default_rng(11)
    lens = {"equal": [101] * 64, "long_among_short": [3, 0, 150, LONG_BP, 5],
            "empty": []}[shape]
    reads = [BSeq(name=f"q{i}", seq=rng.integers(0, 5, k).astype(np.uint8),
                  qual="I" * k) for i, k in enumerate(lens)]
    cols = ReadColumns.concat([ReadColumns.of_copies(r, 1) for r in reads]
                              or [ReadColumns.of_copies(BSeq("x", np.zeros(
                                  0, np.uint8)), 0)])
    q, ln = _pad_batch(cols)
    q0, ln0 = _pad_batch([r.seq for r in reads])
    np.testing.assert_array_equal(q, q0)
    np.testing.assert_array_equal(ln, ln0)


@pytest.fixture(scope="module")
def runtime(toy_paths):
    from mpibwa_tpu_torch.core.opts import mem_opt_init
    from mpibwa_tpu_torch.index.format import load_index
    from mpibwa_tpu_torch.parallel.runtime import Runtime

    opt = mem_opt_init()
    opt.chunk_size = 20_000  # several chunks of the 600 pairs
    return Runtime(load_index(toy_paths["ref"]), opt,
                   devices=[torch.device("cpu")], verbose=False)


def test_counters_on_the_chunk_path_and_a_plain_list(runtime, toy_paths,
                                                     tmp_path):
    """Runtime.run: every read's blobs come from the columns
    (packed_reads), none from the loop; a plain list of the same reads
    takes the loop (looped_reads) and gives the same SAM text."""
    from mpibwa_tpu_torch.io.fastq import scan_fastq

    al = runtime.aligners[0]
    al.stats["packed_reads"] = al.stats["looped_reads"] = 0
    out = runtime.run(toy_paths["r1"], toy_paths["r2"], str(tmp_path / "o"))
    n = 2 * len(scan_fastq(toy_paths["r1"]))
    assert len(runtime.last_manifest) >= 2
    assert al.stats["packed_reads"] == n and al.stats["looped_reads"] == 0

    plan = runtime.plan(toy_paths["r1"], toy_paths["r2"])
    batch = plan.get_batch(0)
    al.process_seqs(batch)
    plain = list(batch)  # the same PackedRead objects, no columns
    sams = [s.sam for s in batch]
    for s in plain:
        s.sam = None
    al.process_seqs(plain)
    assert [s.sam for s in plain] == sams
    assert al.stats["looped_reads"] == len(batch)
    assert al.stats["packed_reads"] == n + len(batch)
    text = open(out).read()
    assert all(s in text for s in sams)
