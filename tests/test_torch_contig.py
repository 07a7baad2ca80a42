"""The port's contig backward engine (mpibwa_tpu_torch/ops/seeding_flat.py,
MPIBWA_BWD=contig) vs the JAX package's, in the int32 and the forced
int64 position paths: ``extend_back1``, the rank step of contig,
against ``extend`` and the JAX package's; ``assemble_cols`` and
``run_backward_contig`` on
the same lanes of the toy index (straight to the finishing rounds, and
through the ladder of segments and shrinks), a lane that emits more than
M_CAP mems (a read whose every 24-bp window occurs once in a mosaic
genome, so that 24 mems cover each call's start), and `cli mem` SE and
PE under contig against the JAX package's contig run and the port's
default. Integers throughout: every comparison is exact (tolerance 0)."""

import os

import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401
from mpibwa_tpu.index.format import load_index

torch.set_num_threads(1)  # test workers run in parallel on few cores


CPU = torch.device("cpu")
N_READS = 64
WINDOW = 24  # bp of each window of the mosaic read planted in its genome


@pytest.fixture(scope="module")
def toy_paths(tmp_path_factory):
    return toy.build_toy(str(tmp_path_factory.mktemp("toy")), n_pairs=200)


@pytest.fixture(scope="module")
def reads(toy_paths):
    half = N_READS // 2
    return [s.seq for s in toy.load_reads(toy_paths["r1"], limit=half)
            + toy.load_reads(toy_paths["r2"], limit=half)]


def _fms(index, wide):
    """(JAX DeviceFMIndex, torch DeviceFMIndex) for one position dtype."""
    from mpibwa_tpu.ops.fmd import DeviceFMIndex as JaxFM
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    return (JaxFM(index, force_wide=wide),
            DeviceFMIndex(index, CPU, force_wide=wide))


@pytest.fixture(scope="module")
def mosaic(tmp_path_factory):
    """(index, read): a 101-bp random read R and a genome of random
    background holding every 24-bp window of R once, each flanked by bases
    that R does not have there. Then every window is a mem, and the
    backward lane of a call at x emits the 24 mems that cover x, one a
    round: more than M_CAP."""
    from mpibwa_tpu_torch.index.build import build_index

    rng = np.random.default_rng(11)
    bases = "ACGT"

    def rand(n):
        return "".join(rng.choice(list(bases), n))

    def other(c):
        return str(rng.choice([b for b in bases if b != c]))

    R = rand(toy.READ_LEN)
    parts = [rand(5000)]
    for j in range(len(R) - WINDOW + 1):
        pre = other(R[j - 1]) if j else rand(1)
        post = other(R[j + WINDOW]) if j + WINDOW < len(R) else rand(1)
        parts.append(rand(8) + pre + R[j: j + WINDOW] + post)
    parts.append(rand(5000))
    ref = str(tmp_path_factory.mktemp("mosaic") / "mosaic.fa")
    toy.write_fasta(ref, {"mosaic": "".join(parts)})
    build_index(ref)
    q = np.frombuffer(R.encode(), np.uint8)
    codes = np.full(256, 4, np.uint8)
    codes[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    return load_index(ref), codes[q]


def _lanes(tfm, reads, seed=3):
    """A pass-1 backward's lanes as the seeder builds them for contig, with
    min_intv 1-3 a lane: (qrows (NL, L) uint8, ivals, infos, lane_row,
    lane_tbl, E, x0, minv)."""
    from mpibwa_tpu_torch.ops import seeding as TS
    from mpibwa_tpu_torch.ops import seeding_flat as TSF
    from mpibwa_tpu_torch.pipeline import device_seed as DS

    q, lens = DS._pad_batch(reads)
    B = len(q)
    fwd = TS.forward_pass(tfm, torch.from_numpy(q), torch.from_numpy(lens),
                          torch.ones(B, dtype=torch.int64))
    rng = np.random.default_rng(seed)
    arr = np.array([(b, int(fwd.call_start[b, c]), int(fwd.call_len[b, c]),
                     int(fwd.call_x[b, c]), int(rng.integers(1, 4)))
                    for b in range(B) for c in range(int(fwd.n_calls[b]))],
                   np.int64)
    NL = TSF._pad_cap(len(arr))
    lane_row, lane_tbl, x0, minv, e = DS._lane_tables(arr, NL)
    return (q[lane_row], fwd.ivals, fwd.infos, lane_row, lane_tbl,
            TSF._pad2(TSF._pad_cap(e)), x0, minv)


def _both_contig(jfm, tfm, lanes, stats):
    """The same lanes through both packages' assemble_cols and
    run_backward_contig: (jax (mems, overflow), port (mems, overflow))."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops import seeding_flat as JSF
    from mpibwa_tpu_torch.ops import seeding_flat as TSF

    qrows, ivals, infos, lane_row, lane_tbl, E, x0, minv = lanes
    jcols = JSF.assemble_cols(jnp.asarray(ivals.numpy()),
                              jnp.asarray(infos.numpy()),
                              jnp.asarray(lane_row), jnp.asarray(lane_tbl), E)
    tcols = TSF.assemble_cols(ivals, infos, torch.from_numpy(lane_row),
                              torch.from_numpy(lane_tbl), E)
    for j, t in zip(jcols, tcols):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    NL = len(lane_row)
    want = JSF.run_backward_contig(jfm, jnp.asarray(qrows), jcols, NL, x0,
                                   minv)
    got = TSF.run_backward_contig(tfm, torch.from_numpy(qrows), tcols, NL,
                                  x0, minv, stats=stats)
    return want, got


@pytest.mark.parametrize("wide", [False, True], ids=["i32", "i64"])
def test_extend_back1_matches_jax(toy_paths, wide):
    """extend_back1 == row c of extend(ik, 1) and == the JAX package's
    extend_back1 on the intervals of real lanes and the occ4 edge
    intervals, every base c."""
    import jax.numpy as jnp

    jfm, tfm = _fms(load_index(toy_paths["ref"]), wide)
    rng = np.random.default_rng(4)
    lanes = toy.forward_lanes(tfm, toy.ref_reads(tfm, rng, 16,
                                                 toy.READ_LEN))
    ik = np.concatenate([ln["ik"] for ln in lanes]
                        + list(toy.occ4_edge_intervals(tfm, 5).values()))
    ik = ik.astype(tfm.np_idt)
    c = rng.integers(0, 4, len(ik))
    got = tfm.extend_back1(*(torch.from_numpy(ik[:, j]) for j in range(3)),
                           torch.from_numpy(c))
    row = tfm.extend(torch.from_numpy(ik), 1)[torch.arange(len(c)),
                                              torch.from_numpy(c)]
    want = jfm.extend_back1(*(jnp.asarray(ik[:, j]) for j in range(3)),
                            jnp.asarray(c))
    for j, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), row[:, j].numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[j]))
    assert len(ik) > 500


@pytest.mark.parametrize("ladder", [False, True], ids=["finish", "ladder"])
@pytest.mark.parametrize("wide", [False, True], ids=["i32", "i64"])
def test_run_backward_contig_matches_jax(toy_paths, reads, monkeypatch,
                                         wide, ladder):
    """assemble_cols and run_backward_contig == the JAX package's on the
    pass-1 lanes of 64 toy reads: every column, every lane's mems and the
    overflow flags. ladder lowers the finish capacity in both packages to
    1,024, so the pass runs segments of the 1, 2, 4 ladder and shrinks
    before its finishing rounds."""
    from mpibwa_tpu_torch.ops import seeding_flat as TSF

    if ladder:
        monkeypatch.setenv("MPIBWA_FINISH_CAP", "1024")  # the JAX knob
        monkeypatch.setattr(TSF, "CONTIG_FINISH_CAP", 1024)
    jfm, tfm = _fms(load_index(toy_paths["ref"]), wide)
    lanes = _lanes(tfm, reads)
    assert lanes[5] > 1024
    stats = {}
    want, got = _both_contig(jfm, tfm, lanes, stats)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert not got[1].any()
    assert sum(len(m) for m in got[0]) > N_READS
    assert (stats["bwd_segments"] > 1) == ladder


@pytest.mark.parametrize("wide", [False, True], ids=["i32", "i64"])
def test_contig_overflow_matches_jax(mosaic, wide):
    """The mosaic read's lanes emit 24 mems each at the calls inside the
    read: both packages flag the same lanes, and keep the same first
    M_CAP mems of every lane."""
    from mpibwa_tpu_torch.ops import seeding_flat as TSF

    index, q = mosaic
    jfm, tfm = _fms(index, wide)
    lanes = _lanes(tfm, [q, q[::-1].copy(), q[:60].copy()])
    want, got = _both_contig(jfm, tfm, lanes, {})
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].sum() >= 2
    assert max(len(m) for m in got[0]) == TSF.M_CAP


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_cli_contig_identical(toy_paths, tmp_path, monkeypatch, pe):
    """`cli mem` under MPIBWA_BWD=contig: the port's SAM == the JAX
    package's under contig == the port's under its default engine."""
    from test_torch_cli import _head, _run_both

    d = tmp_path / "in"
    d.mkdir()
    fq = [_head(toy_paths[k], str(d / f"{k}.fq"), 150) for k in ("r1", "r2")]
    args = ["-t", "1", toy_paths["ref"]] + (fq if pe else fq[:1])
    monkeypatch.setenv("MPIBWA_EXT", "device")
    monkeypatch.setenv("MPIBWA_BWD", "contig")
    (tmp_path / "contig").mkdir()
    want, got = _run_both(tmp_path / "contig", monkeypatch, args, "out.sam")
    assert got == want
    monkeypatch.delenv("MPIBWA_BWD")
    from mpibwa_tpu_torch import cli

    (tmp_path / "default").mkdir()
    monkeypatch.chdir(tmp_path / "default")
    assert cli.main(["mem", "-o", "out"] + args) == 0
    assert open("out.sam", "rb").read() == got["out.sam"]
    assert got["out.sam"].count(b"\n") > 150
    assert os.environ.get("MPIBWA_TORCH_DEVICE") == "cpu"
