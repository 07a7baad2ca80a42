"""Long and wide reads: `mpibwa_tpu_torch.cli mem` writes the same bytes as
`mpibwa_tpu.cli mem` on the toy genome for ONT-like reads of 700-2,500 bp
under -x ont2d (both MPIBWA_EXT values) and -x pacbio, for FR pairs of
400-700 bp reads with bwa's defaults, and (marked slow) for a batch whose
last read is 66,000 bp long, which switches the seeder's call words to
their int64 form. The port's host spec engine meets the JAX package's on
the same long reads, and the call words' packing and unpacking meet the
JAX package's formulas at the limits of their fields. Such reads overflow
the device seeder's caps and are aligned by the host engine; the
comparisons hold that route and the microbatch around it. Exact bytes
throughout (tolerance 0)."""

import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401
from test_torch_cli import _head, _run_both

torch.set_num_threads(1)  # test workers run in parallel on few cores


ONT_LENGTHS = [700, 1500, 2500, 1100]
PE_LENGTHS = [400, 550, 700, 480, 620, 410]
WIDE = (1000, 67000)  # the wide read: chrA[1000:67000], 66,000 bp


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The toy index, its forward reference codes and FASTQ files of the
    long reads: ONT-like SE reads (as tests/test_long_reads.py makes them)
    and long FR pairs with an insert of N(1,500, 150)."""
    from mpibwa_tpu_torch.core.refseq import RefSeq
    from mpibwa_tpu_torch.index.format import load_index

    d = tmp_path_factory.mktemp("long")
    paths = toy.build_toy(str(d))
    ref = RefSeq(load_index(paths["ref"])).ref
    out = {"ref": paths["ref"], "codes": ref, "r1": paths["r1"], "dir": d}
    ont = toy.long_reads(ref, np.random.default_rng(42), ONT_LENGTHS)
    r1, r2 = toy.long_pairs(ref, np.random.default_rng(7), PE_LENGTHS)
    for key, reads in (("ont", ont), ("pe1", r1), ("pe2", r2)):
        out[key] = str(d / f"{key}.fq")
        toy.write_fastq(out[key], [(f"long{i}", toy.to_bases(s))
                                   for i, s in enumerate(reads)])
    return out


def _same(tmp_path, monkeypatch, args):
    want, got = _run_both(tmp_path, monkeypatch, args, "out.sam")
    assert got == want
    return got["out.sam"]


def test_long_reads_are_the_jax_tests_reads(data):
    """toy.long_reads draws what tests/test_long_reads.py draws."""
    from mpibwa_tpu.core.refseq import RefSeq as JaxRefSeq
    from mpibwa_tpu.index.format import load_index
    from test_long_reads import _make_long_reads

    want = _make_long_reads(JaxRefSeq(load_index(data["ref"])),
                            np.random.default_rng(42), ONT_LENGTHS)
    got = toy.long_reads(data["codes"], np.random.default_rng(42),
                         ONT_LENGTHS)
    assert [w.seq.tobytes() for w in want] == [g.tobytes() for g in got]


@pytest.mark.parametrize("ext", ["device", "native"])
def test_ont2d_se_identical(data, tmp_path, monkeypatch, ext):
    monkeypatch.setenv("MPIBWA_EXT", ext)
    sam = _same(tmp_path, monkeypatch, ["-x", "ont2d", "-t", "1",
                                        data["ref"], data["ont"]])
    body = [ln for ln in sam.splitlines() if not ln.startswith(b"@")]
    assert len(body) >= len(ONT_LENGTHS)


def test_pacbio_se_identical(data, tmp_path, monkeypatch):
    monkeypatch.setenv("MPIBWA_EXT", "native")
    _same(tmp_path, monkeypatch, ["-x", "pacbio", "-t", "1", data["ref"],
                                  data["ont"]])


def test_long_pe_identical(data, tmp_path, monkeypatch):
    """FR pairs of 400-700 bp reads with bwa's defaults: the pairing and
    the i16 mate rescue (l_ms * a >= 250) beside the host engine's
    records."""
    monkeypatch.delenv("MPIBWA_EXT", raising=False)
    sam = _same(tmp_path, monkeypatch, ["-t", "1", data["ref"], data["pe1"],
                                        data["pe2"]])
    body = [ln.split(b"\t") for ln in sam.splitlines()
            if not ln.startswith(b"@")]
    assert len(body) >= len(PE_LENGTHS)
    assert sum(int(f[1]) & 4 == 0 for f in body) >= len(PE_LENGTHS) - 1


@pytest.mark.parametrize("preset", ["ont2d", None], ids=["ont2d", "pe"])
def test_host_engine_long_reads(data, preset):
    """The port's host spec engine (core/pipeline.process_seqs) == the JAX
    package's on the ONT-like reads under -x ont2d and on the long pairs
    with bwa's defaults, read by read."""
    from mpibwa_tpu.core import fm as JF
    from mpibwa_tpu.core import opts as JO
    from mpibwa_tpu.core import pipeline as JP
    from mpibwa_tpu.core import refseq as JR
    from mpibwa_tpu.index.format import load_index as jax_load
    from mpibwa_tpu_torch.core import fm as TF
    from mpibwa_tpu_torch.core import opts as TO
    from mpibwa_tpu_torch.core import pipeline as TP
    from mpibwa_tpu_torch.core import refseq as TR
    from mpibwa_tpu_torch.index.format import load_index as torch_load
    from mpibwa_tpu_torch.io.fastq import read_fastq

    if preset:
        reads = read_fastq(data["ont"])
    else:
        pairs = zip(read_fastq(data["pe1"]), read_fastq(data["pe2"]))
        reads = [s for pair in pairs for s in pair]
    sams = []
    for O, F, P, R, load in ((JO, JF, JP, JR, jax_load),
                             (TO, TF, TP, TR, torch_load)):
        idx = load(data["ref"])
        opt = O.mem_opt_init()
        if preset:
            O.apply_preset(opt, preset, set())
        else:
            opt.flag |= O.MEM_F_PE
        seqs = [P.BSeq(name=s.name, seq=s.seq.copy(), qual=s.qual)
                for s in reads]
        P.process_seqs(opt, F.FMIndex.from_index(idx), R.RefSeq(idx), seqs)
        sams.append([s.sam for s in seqs])
    assert sams[1] == sams[0]
    assert all(sams[1])


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
def test_call_words_match_jax(wide):
    """pack_call_words == the JAX package's formula
    (mpibwa_tpu/pipeline/device_seed.py, _fused_p1_p3) byte for byte, on
    fields up to the limits of each form (start and len past 255 are
    clamped in the int32 form), and unpack_call_words == the JAX
    package's _pull_p1p3 on those words."""
    import jax.numpy as jnp

    from mpibwa_tpu.pipeline import device_seed as JDS
    from mpibwa_tpu_torch.pipeline import device_seed as DS

    B, C = 8, 48
    rng = np.random.default_rng(1)
    L = (1 << 21) - 1 if wide else (1 << 16) - 1
    top_x, top_sl = (L, L) if wide else (L, 300)
    x = rng.integers(0, top_x + 1, (B, C))
    start = rng.integers(0, top_sl + 1, (B, C))
    ln = rng.integers(0, top_sl + 1, (B, C))
    x[0, :3], start[0, :3], ln[0, :3] = top_x, top_sl, top_sl
    x[1, :3] = start[1, :3] = ln[1, :3] = 0
    x[2, :2], start[2, :2], ln[2, :2] = 255, 255, 255
    fields = [a.astype(np.int32) for a in (x, start, ln)]

    got = DS.pack_call_words(*(torch.from_numpy(a) for a in fields), L)
    cx, cs, cl = (jnp.asarray(a) for a in fields)
    if L < (1 << 16):  # mpibwa_tpu/pipeline/device_seed.py:116-127
        want = ((cx << 16) | (jnp.minimum(cs, 255) << 8)
                | jnp.minimum(cl, 255))
    else:
        want = ((cx.astype(jnp.int64) << 42) | (cs.astype(jnp.int64) << 21)
                | cl.astype(jnp.int64))
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    assert got.numpy().tobytes() == want.tobytes()

    words = want.reshape(-1)
    ctl = np.zeros(4 * B + B * C, words.dtype)
    ctl[1: 4 * B: 4] = C  # n_calls of every read
    ctl[4 * B:] = words
    jcalls = JDS._pull_p1p3(jnp.asarray(ctl), jnp.zeros(4, jnp.int64), B)[3]
    calls = DS.unpack_call_words(words)
    np.testing.assert_array_equal(calls, jcalls)
    if wide:
        np.testing.assert_array_equal(
            calls, np.stack([a.reshape(-1) for a in fields], axis=1))
    else:
        np.testing.assert_array_equal(calls[:, 0], fields[0].reshape(-1))
        np.testing.assert_array_equal(
            calls[:, 1:], np.minimum(np.stack(
                [a.reshape(-1) for a in fields[1:]], axis=1), 255))


@pytest.mark.slow
def test_wide_batch_identical(data, tmp_path, monkeypatch):
    """64 toy reads and, last, a 66,000-bp read off chrA (0.1%
    substitutions): the whole microbatch takes the int64 call words. Both
    CLIs write the same bytes, under MPIBWA_EXT=device, and every short
    read's lines equal a run on the 64 reads alone."""
    short = str(tmp_path / "short.fq")
    _head(data["r1"], short, 64)
    wide = toy.substituted(np.random.default_rng(3),
                           data["codes"][WIDE[0]: WIDE[1]], 0.001)
    both = str(tmp_path / "wide.fq")
    with open(both, "w") as g:
        g.write(open(short).read())
    with open(both, "a") as g:
        g.write(f"@wide\n{toy.to_bases(wide)}\n+\n{'I' * len(wide)}\n")
    monkeypatch.setenv("MPIBWA_EXT", "device")
    for name, fq in (("wide", both), ("short", short)):
        (tmp_path / name).mkdir()
        sam = _same(tmp_path / name, monkeypatch,
                    ["-t", "1", data["ref"], fq])
        lines = [ln for ln in sam.splitlines() if not ln.startswith(b"@")]
        if name == "wide":
            wide_lines = lines
    assert [ln for ln in wide_lines if not ln.startswith(b"wide\t")] == lines
    assert any(ln.startswith(b"wide\t") for ln in wide_lines)
