"""The port's record route, which runs without the C runtime: the banded
global DP with its device traceback (mpibwa_tpu_torch/ops/global_batch.py),
the striped u8 mate-rescue SW (ops/rescue.py), the caches the pipeline
builds from them (pipeline/device_align.precompute_cigars and
precompute_rescue) and the whole `cli mem` under MPIBWA_FINAL=python
MPIBWA_CHAIN=python and under MPIBWA_NATIVE=0, against the JAX package,
the scalar spec engine and the dp_global / dp_align goldens. Integer DPs:
exact equality throughout."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401
from mpibwa_tpu.index.format import NT4_TABLE, load_index
from mpibwa_tpu_torch.core import extend as X
from mpibwa_tpu_torch.core.opts import fill_scmat, mem_opt_init
from mpibwa_tpu_torch.ops import global_batch as TG
from mpibwa_tpu_torch.ops import rescue as TR

torch.set_num_threads(1)  # test workers run in parallel on few cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAT = fill_scmat(1, 4)
PEN = (6, 1, 6, 1)
CPU = torch.device("cpu")


class SeqRef:
    """A reference of arbitrary codes (N = 4 included) serving what the
    DPs read of an index: ``l_pac`` and ``ref_base`` (forward strand only)."""

    def __init__(self, codes):
        self.codes = codes  # a torch tensor or a JAX array
        self.l_pac = int(codes.shape[0])

    def ref_base(self, pos):
        return self.codes[pos.clip(0, self.l_pac - 1)]


jax.tree_util.register_pytree_node(
    SeqRef, lambda r: ((r.codes,), None), lambda _, ch: SeqRef(ch[0]))


def seq_refs(targets):
    """(torch SeqRef, JAX SeqRef, start offsets) over the concatenation of
    targets."""
    off = np.concatenate([[0], np.cumsum([len(t) for t in targets])])
    codes = (np.concatenate(targets).astype(np.uint8) if len(targets)
             else np.zeros(1, np.uint8))
    return (SeqRef(torch.from_numpy(codes)), SeqRef(jnp.asarray(codes)),
            off[:-1])


def pad_rows(rows, width=None):
    width = width or max(max((len(r) for r in rows), default=1), 8)
    out = np.full((len(rows), width), 4, np.uint8)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def nt4(s):
    return NT4_TABLE[np.frombuffer(s.encode(), dtype=np.uint8)]


def cigar_str(cig):
    return "".join(f"{ln}{'MIDSH'[op]}" for ln, op in cig)


def load_pairs(name):
    g = os.path.join(REPO, "tests", "golden")
    probs = open(os.path.join(g, name + ".txt")).read().splitlines()
    outs = open(os.path.join(g, name + ".out")).read().splitlines()
    assert len(probs) == len(outs)
    return list(zip(probs, outs))


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    return toy.build_toy(str(tmp_path_factory.mktemp("toy")))


@pytest.fixture(scope="module")
def fms(toy_dir):
    """(the toy index, the port's DeviceFMIndex on the CPU, JAX's)."""
    from mpibwa_tpu.ops.fmd import DeviceFMIndex as JaxFM
    from mpibwa_tpu_torch.index.format import load_index as torch_load
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    idx = torch_load(toy_dir["ref"])
    return idx, DeviceFMIndex(idx, CPU), JaxFM(load_index(toy_dir["ref"]))


# -- the global DP and its traceback ------------------------------------------

def _mutate(rng, s, sub=0.04, indel=0.02):
    out = []
    for c in s:
        r = rng.random()
        if r < indel / 2:
            continue
        out.append(c if rng.random() >= sub else (c + 1 + rng.integers(3)) % 4)
        if r > 1 - indel / 2:
            out.extend(rng.integers(0, 4, int(rng.integers(1, 3))))
    return np.array(out, np.uint8)


GLOBAL_CASES = ["forward_T64", "forward_T128", "forward_T192", "forward_T256",
                "reverse", "w3_qlen_eq_tlen", "band_edge", "band_covers_all"]
GLOBAL_B = 16  # problems a case: one JAX compile a (Q, T) window


def _global_case(name, fm, seed):
    """(qd rows, coords (B, 6) int64, ws, Q, T) of a case over fm: queries
    are mutated copies (substitutions, 1-2 bp indels) of the target window
    of each problem."""
    rng = np.random.default_rng(seed)
    QT = {"forward_T64": 64, "forward_T128": 128, "forward_T192": 192,
          "forward_T256": 256}.get(name, 128)
    rev = name == "reverse"
    rows, coords, ws = [], [], []
    for b in range(GLOBAL_B):
        tlen = int(rng.integers(QT // 2 + 1, QT - 2))
        r0 = int(rng.integers(QT, 2 * fm.l_pac - 2 * QT))
        t = fm.ref_base(torch.arange(r0, r0 + tlen)).numpy().astype(np.uint8)
        q = _mutate(rng, t)
        if name == "w3_qlen_eq_tlen":  # substitutions only: equal lengths
            q = t.copy()
            hit = rng.random(tlen) < 0.05
            q[hit] = (q[hit] + 1) % 4
        q = q[:QT]
        diff = abs(len(t) - len(q))
        w = {"w3_qlen_eq_tlen": 3, "band_edge": diff + 3,
             "band_covers_all": QT}.get(name, diff + int(rng.integers(3, 30)))
        rows.append(q)
        coords.append((b, 0, len(q), int(rev), r0 + tlen if rev else r0,
                       tlen))
        ws.append(w)
    return (pad_rows(rows, QT), np.array(coords, np.int64),
            np.array(ws, np.int32), QT, QT)


@pytest.mark.parametrize("name", GLOBAL_CASES)
def test_global_matches_jax(fms, name):
    """global_from_coords (score and the whole direction matrix),
    traceback_batch (op rows and remainders) and cigar_from_ops equal the
    JAX package's; the CIGARs and scores equal the scalar ksw_global2 and
    the host traceback of the same z."""
    from mpibwa_tpu.ops import global_batch as JG

    idx, tfm, jfm = fms
    qd, coords, ws, Q, T = _global_case(name, tfm,
                                        GLOBAL_CASES.index(name) + 40)
    tm = torch.from_numpy(MAT.reshape(5, 5).astype(np.int32))
    got = TG.global_from_coords(tfm, torch.from_numpy(qd),
                                torch.from_numpy(coords), Q, T,
                                torch.from_numpy(ws), *PEN, tm)
    want = JG.global_from_coords(jfm, jnp.asarray(qd), jnp.asarray(coords),
                                 Q, T, jnp.asarray(ws), *PEN, None,
                                 jnp.asarray(tm.numpy()))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(want.score))
    np.testing.assert_array_equal(got.z.numpy(), np.asarray(want.z))
    ql, tl = torch.from_numpy(coords[:, 2]), torch.from_numpy(coords[:, 5])
    ops, i_rem, k_rem = TG.traceback_batch(got.z, ql, tl,
                                           torch.from_numpy(ws))
    j_ops, j_i, j_k = JG.traceback_batch(want.z, jnp.asarray(coords[:, 2]),
                                         jnp.asarray(coords[:, 5]),
                                         jnp.asarray(ws))
    np.testing.assert_array_equal(ops.numpy(), np.asarray(j_ops))
    np.testing.assert_array_equal(i_rem.numpy(), np.asarray(j_i))
    np.testing.assert_array_equal(k_rem.numpy(), np.asarray(j_k))
    z = got.z.numpy()
    for b in range(len(coords)):
        _, _, qlen, rev, r0, tlen = (int(v) for v in coords[b])
        cig = TG.cigar_from_ops(ops[b].numpy(), int(i_rem[b]), int(k_rem[b]))
        assert cig == JG.cigar_from_ops(np.asarray(j_ops[b]), int(j_i[b]),
                                        int(j_k[b]))
        assert cig == TG.traceback(z[b], qlen, tlen, int(ws[b]))
        pos = torch.arange(r0 - tlen, r0).flip(0) if rev else \
            torch.arange(r0, r0 + tlen)
        t = tfm.ref_base(pos).numpy().astype(np.uint8)
        q = qd[b, :qlen][::-1] if rev else qd[b, :qlen]
        assert X.ksw_global2(np.ascontiguousarray(q), t, MAT, *PEN,
                             int(ws[b])) == (int(got.score[b]), cig)


def test_global_matches_dp_global_goldens():
    """The 400 dp_global oracle problems through global_from_coords over a
    reference made of their targets: scores and CIGARs equal the
    goldens."""
    pairs = load_pairs("dp_global")
    qs = [nt4(p.split()[1]) for p, _ in pairs]
    ts = [nt4(p.split()[2]) for p, _ in pairs]
    ws = np.array([int(p.split()[0]) for p, _ in pairs], np.int32)
    ref, _, off = seq_refs(ts)
    Q = T = 192
    coords = np.array([(i, 0, len(q), 0, off[i], len(t))
                       for i, (q, t) in enumerate(zip(qs, ts))], np.int64)
    tm = torch.from_numpy(MAT.reshape(5, 5).astype(np.int32))
    out = TG.global_from_coords(ref, torch.from_numpy(pad_rows(qs)),
                                torch.from_numpy(coords), Q, T,
                                torch.from_numpy(ws), *PEN, tm)
    ops, i_rem, k_rem = TG.traceback_batch(
        out.z, torch.from_numpy(coords[:, 2]), torch.from_numpy(coords[:, 5]),
        torch.from_numpy(ws))
    for i, (prob, want) in enumerate(pairs):
        want_score, _, want_cig = want.partition(" ")
        cig = TG.cigar_from_ops(ops[i].numpy(), int(i_rem[i]), int(k_rem[i]))
        assert int(out.score[i]) == int(want_score), prob
        assert cigar_str(cig) == want_cig.strip(), prob


# -- the striped SW of mate rescue --------------------------------------------

def _score2_sequential(cm, tlen, minsc, score, te, qmax):
    """ksw_u8's second best (ksw.c:192-199, 214-227), row by row."""
    if score == 255:
        return -1
    b = []
    for i in range(tlen):
        if cm[i] >= minsc:
            if not b or b[-1][1] + 1 != i:
                b.append((cm[i], i))
            elif b[-1][0] < cm[i]:
                b[-1] = (cm[i], i)
    win = (score + qmax - 1) // qmax
    out = -1
    for sc, e in b:
        if (e < te - win or e > te + win) and sc > out:
            out = sc
    return out


def test_score2_matches_the_sequential_rule():
    """The vectorised second best against the C kernel's row loop on
    column maxima full of plateaus (runs of equal rows inside a run above
    minsc, of every parity), with te anywhere."""
    rng = np.random.default_rng(7)
    B, T = 512, 96
    base = rng.integers(0, 40, (B, T))
    # long plateaus: hold each value for 1-6 rows
    rep = np.repeat(rng.integers(15, 60, (B, T)), rng.integers(1, 7, T),
                    axis=1)[:, :T]
    cm = np.where(rng.random((B, 1)) < 0.7, rep, base).astype(np.int32)
    tlen = rng.integers(0, T + 1, B).astype(np.int32)
    minsc = rng.choice([19, 30, 0x10000], B).astype(np.int32)
    score = rng.integers(0, 80, B).astype(np.int32)
    score[:8] = 255
    te = rng.integers(-1, T, B).astype(np.int32)
    got = TR._score2(*(torch.from_numpy(a) for a in
                       (cm, tlen, minsc, score, te)), 1).numpy()
    want = [_score2_sequential(cm[b], tlen[b], minsc[b], score[b], te[b], 1)
            for b in range(B)]
    np.testing.assert_array_equal(got, want)
    plateaus = (cm[:, 1:] == cm[:, :-1]) & (cm[:, 1:] >= 19)
    assert plateaus.sum() > 1000 and (np.array(want) >= 0).sum() > 50


RESCUE_CASES = ["toy_windows", "saturating", "colmax_plateau", "qe_tie",
                "tlen_0"]
N_CAP, T_CAP = 272, 512  # one JAX compile for every case


def _rescue_case(name, tfm, seed):
    """(qd rows, problems, torch ref, JAX ref or None for the toy index):
    problems as ksw_align2_batch takes them."""
    rng = np.random.default_rng(seed)
    if name == "toy_windows":
        rows, probs = [], []
        for b in range(14):
            p = int(rng.integers(300, 2 * tfm.l_pac - 700))
            ms = tfm.ref_base(torch.arange(p, p + 101)).numpy().astype(
                np.uint8)
            hit = rng.random(101) < 0.04
            ms[hit] = (ms[hit] + 1) % 4
            comp = b % 2
            if comp:  # the mate as sequenced: its reverse complement
                ms = np.where(ms < 4, 3 - ms, 4)[::-1]
            rows.append(ms)
            lo = p - int(rng.integers(0, 250))
            qc = (b, 100, -1, 1, 101) if comp else (b, 0, 1, 0, 101)
            probs.append({"qcoords": qc,
                          "tcoords": (lo, 1, int(rng.integers(120, 500)))})
        return pad_rows(rows), probs, None
    unit = rng.integers(0, 4, 60).astype(np.uint8)
    if name == "saturating":  # 260 matches: gmax + shift reaches 255
        q = rng.integers(0, 4, 260).astype(np.uint8)
        targets = [np.concatenate([rng.integers(0, 4, 30), q,
                                   rng.integers(0, 4, 20)]), q[:200]]
        queries = [q, q]
    elif name == "colmax_plateau":
        # a homopolymer tail, longer in the target: the row maximum holds
        # for several rows (plateaus of both parities), and a second,
        # weaker copy far away feeds score2
        targets, queries = [], []
        for k in range(1, 9):
            q = np.concatenate([unit, np.zeros(4 + k % 3, np.uint8)])
            q2 = q.copy()
            q2[rng.integers(0, 50, 2)] ^= 1
            targets.append(np.concatenate([
                rng.integers(0, 4, 20), q, np.zeros(k, np.uint8),
                rng.integers(0, 4, 100 + 7 * k), q2, np.zeros(2 * k, np.uint8),
                rng.integers(0, 4, 10)]))
            queries.append(q)
    elif name == "qe_tie":  # homopolymers: the best row ties across columns
        queries = [np.full(n, 2, np.uint8) for n in (20, 33, 48)]
        targets = [np.concatenate([rng.integers(0, 2, 10), np.full(m, 2),
                                   rng.integers(0, 2, 10)])
                   for m in (25, 30, 40)]
    else:  # tlen_0: empty windows beside a live one
        queries = [unit, unit, unit]
        targets = [np.zeros(0, np.uint8), unit, np.zeros(0, np.uint8)]
    targets = [np.asarray(t, np.uint8) for t in targets]
    tref, jref, off = seq_refs(targets)
    probs = [{"qcoords": (b, 0, 1, 0, len(q)),
              "tcoords": (int(off[b]), 1, len(t))}
             for b, (q, t) in enumerate(zip(queries, targets))]
    return pad_rows(queries), probs, (tref, jref)


def _materialize(fm, qd, p):
    """The (query, target) of problem p as the scalar kernel takes them."""
    row, start, step, comp, qlen = p["qcoords"]
    q = qd[row, start + step * np.arange(qlen)]
    if comp:
        q = np.where(q < 4, 3 - q, 4)
    t0, ts, tl = p["tcoords"]
    t = fm.ref_base(torch.arange(tl) * ts + t0).numpy()
    return q.astype(np.uint8), t.astype(np.uint8)


@pytest.mark.parametrize("name", RESCUE_CASES)
def test_rescue_matches_jax(fms, name, monkeypatch):
    """ksw_align2_batch (forward and reverse pass) equals the JAX
    package's, and the scalar ksw_align2 in u8 mode where the score does not
    saturate (te2, which nothing downstream reads, is -1 in both batched
    versions)."""
    from mpibwa_tpu.ops import rescue as JR

    idx, tfm, jfm = fms
    qd, probs, refs = _rescue_case(name, tfm, RESCUE_CASES.index(name) + 90)
    tref, jref = refs if refs else (tfm, jfm)
    seen = []
    real_score2 = TR._score2
    monkeypatch.setattr(TR, "_score2", lambda cm, *a: seen.append(
        cm.clone()) or real_score2(cm, *a))
    opt = mem_opt_init()
    got = TR.ksw_align2_batch(tref, torch.from_numpy(qd), probs, opt, N_CAP,
                              T_CAP)
    want = JR.ksw_align2_batch(jref, jnp.asarray(qd), probs, opt, N_CAP,
                               T_CAP)
    assert got == [tuple(int(v) for v in w) for w in want]
    xtra = X.KSW_XSUBO | X.KSW_XSTART | X.KSW_XBYTE | 19
    for p, g in zip(probs, got):
        if g[0] == 255:
            continue
        q, t = _materialize(tref, qd, p)
        r = X.ksw_align2(q, t, MAT, *PEN, xtra)
        assert g == (r.score, r.te, r.qe, r.score2, -1, r.tb, r.qb)
    cm = seen[0][: len(probs)]
    if name == "saturating":
        assert got[0][0] == 255 and got[0][2] == -1
    elif name == "colmax_plateau":
        flat = (cm[:, 1:] == cm[:, :-1]) & (cm[:, 1:] >= 19)
        assert int(flat.sum()) >= len(probs)
        assert all(g[3] >= 19 for g in got)
    elif name == "qe_tie":
        assert all(g[1] >= 0 and g[2] >= 0 for g in got)
    elif name == "tlen_0":
        assert got[0] == got[2] == (0, -1, 0, -1, -1, -1, -1)


def test_rescue_matches_dp_align_goldens():
    """The u8 problems of the dp_align goldens (xtra with KSW_XBYTE),
    their targets served by a reference made of them and their queries by
    a read batch: (score, te, qe, score2, tb, qb) equal the goldens."""
    cases = [(p.split(), o) for p, o in load_pairs("dp_align")
             if int(p.split()[0]) & X.KSW_XBYTE]
    assert len(cases) > 200
    qs = [nt4(p[1]) for p, _ in cases]
    ts = [nt4(p[2]) for p, _ in cases]
    assert all(int(p[0]) & 0xFFFF == 19 for p, _ in cases)  # = minsc
    ref, _, off = seq_refs(ts)
    probs = [{"qcoords": (i, 0, 1, 0, len(q)),
              "tcoords": (int(off[i]), 1, len(t))}
             for i, (q, t) in enumerate(zip(qs, ts))]
    got = TR.ksw_align2_batch(ref, torch.from_numpy(pad_rows(qs)), probs,
                              mem_opt_init(), 160, 512)
    for (prob, out), g in zip(cases, got):
        w = [int(v) for v in out.split()]
        assert g[:4] + g[5:] == tuple(w[:4] + w[5:]), prob


# -- the caches of one microbatch ---------------------------------------------

N_CACHE_PAIRS = 48


@pytest.fixture(scope="module")
def microbatch(toy_dir, fms):
    """The regions of the first pairs through the port's list route, with
    the PE insert stats."""
    from mpibwa_tpu_torch.core.opts import MEM_F_PE
    from mpibwa_tpu_torch.core.pair import mem_pestat
    from mpibwa_tpu_torch.pipeline.device_align import DeviceAligner

    idx, tfm, _ = fms
    r1 = toy.load_reads(toy_dir["r1"], limit=N_CACHE_PAIRS)
    r2 = toy.load_reads(toy_dir["r2"], limit=N_CACHE_PAIRS)
    seqs = [s for pair in zip(r1, r2) for s in pair]
    opt = mem_opt_init()
    opt.flag |= MEM_F_PE
    al = DeviceAligner(idx, opt, dfm=tfm)
    regs = al.align_regs(seqs)
    return idx, al, seqs, regs, mem_pestat(opt, al.refs.l_pac, regs)


def test_precompute_cigars_equals_jax(microbatch, fms):
    from mpibwa_tpu.pipeline import device_align as JD
    from mpibwa_tpu_torch.pipeline import device_align as TD
    from mpibwa_tpu_torch.pipeline.device_seed import _pad_batch

    idx, al, seqs, regs, _ = microbatch
    qs = [s.seq for s in seqs]
    qd = _pad_batch(qs)[0]
    got = TD.precompute_cigars(al.opt, al.refs, qs, regs, al.dfm,
                               torch.from_numpy(qd), al.mat55d)
    want = JD.precompute_cigars(al.opt, al.refs, qs, regs, fms[2],
                                jnp.asarray(qd),
                                jnp.asarray(al.mat55d.numpy()))
    assert len(got) > 10
    assert got == want


def test_precompute_rescue_equals_jax(microbatch, fms):
    from mpibwa_tpu.pipeline import device_align as JD
    from mpibwa_tpu_torch.pipeline import device_align as TD

    idx, al, seqs, regs, pes = microbatch
    got = TD.precompute_rescue(al.opt, al.refs, al.dfm, seqs, regs, pes)
    want = JD.precompute_rescue(al.opt, al.refs, fms[2], seqs, regs, pes)
    assert len(got) > 40
    assert got == {k: tuple(int(v) for v in w) for k, w in want.items()}


# -- the whole CLI ------------------------------------------------------------

N_CLI_PAIRS = 32
N_RESCUE_ONLY = 8
LONG = 450  # bp of each read of the long pair: l_ms * a >= 250 (i16 mode)


@pytest.fixture(scope="module")
def cli_data(toy_dir, tmp_path_factory):
    """R1/R2 files: the first toy pairs, pairs whose R2 has a substitution
    every 12 bp (no seed of 19 bp: only the rescue SW places it) and one
    pair of 450-bp reads 700 bp apart (its rescue runs the i16 scalar
    kernel)."""
    d = tmp_path_factory.mktemp("record_cli")
    contigs = toy.make_genome()
    r1 = toy.load_reads(toy_dir["r1"], limit=N_CLI_PAIRS)
    r2 = toy.load_reads(toy_dir["r2"], limit=N_CLI_PAIRS)
    a = [(s.name, "".join("ACGTN"[c] for c in s.seq)) for s in r1]
    b = [(s.name, "".join("ACGTN"[c] for c in s.seq)) for s in r2]
    rng = np.random.default_rng(31)
    comp = str.maketrans("ACGT", "TGCA")
    chrom = contigs["chrB"]
    for i in range(N_RESCUE_ONLY):
        pos = int(rng.integers(1000, len(chrom) - 1000))
        frag = chrom[pos: pos + 300]
        mate = list(frag[-101:].translate(comp)[::-1])
        for j in range(11, 101, 12):
            mate[j] = "ACGT"[("ACGT".index(mate[j]) + 1) % 4]
        a.append((f"r{i}", frag[:101]))
        b.append((f"r{i}", "".join(mate)))
    pos = 5000
    frag = chrom[pos: pos + 700]
    a.append(("long", frag[:LONG]))
    b.append(("long", frag[-LONG:].translate(comp)[::-1]))
    toy.write_fastq(str(d / "c1.fq"), a)
    toy.write_fastq(str(d / "c2.fq"), b)
    return {"ref": toy_dir["ref"], "r1": str(d / "c1.fq"),
            "r2": str(d / "c2.fq")}


RECORD_ENV = {"MPIBWA_FINAL": "python", "MPIBWA_CHAIN": "python"}


def _run_cli(cli, tmp, monkeypatch, tag, argv, env):
    d = tmp / tag
    d.mkdir()
    monkeypatch.chdir(d)
    for k in ("MPIBWA_FINAL", "MPIBWA_CHAIN", "MPIBWA_NATIVE", "MPIBWA_EXT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert cli(["-o", "out"] + argv) == 0, tag
    return (d / "out.sam").read_bytes()


@pytest.mark.parametrize("pe", [True, False], ids=["pe", "se"])
def test_record_route_sam_identical(cli_data, tmp_path, monkeypatch, pe):
    """`cli mem` without the C runtime's chain and finalization: the port's
    SAM equals mpibwa_tpu's under the same variables and the port's own
    native route's. PE: the rescue cache serves hits, the rescue-only mates
    are placed, and the long pair's rescue misses the cache (i16)."""
    from mpibwa_tpu import cli as jax_cli
    from mpibwa_tpu_torch import cli as torch_cli
    from mpibwa_tpu_torch.core import pair as P
    from mpibwa_tpu_torch.pipeline import device_align as TD

    monkeypatch.setenv("MPIBWA_TORCH_DEVICE", "cpu")
    argv = ["-t", "1", "-v", "1", cli_data["ref"], cli_data["r1"]] + (
        [cli_data["r2"]] if pe else [])
    calls = {"hits": 0, "i16_misses": 0, "cigars": 0}

    class Counting(dict):
        def get(self, key, default=None):
            got = super().get(key, default)
            if got is not None:
                calls["hits"] += 1
            elif not key[2] & X.KSW_XBYTE:
                calls["i16_misses"] += 1
            return got

    set_sw = P.set_sw_cache
    monkeypatch.setattr(P, "set_sw_cache", lambda c: set_sw(
        None if c is None else Counting(c)))
    pc = TD.precompute_cigars

    def count_cigars(*a, **k):
        out = pc(*a, **k)
        calls["cigars"] += len(out)
        return out

    monkeypatch.setattr(TD, "precompute_cigars", count_cigars)
    port = _run_cli(lambda a: torch_cli.main(["mem"] + a), tmp_path,
                    monkeypatch, "port", argv, RECORD_ENV)
    native = _run_cli(lambda a: torch_cli.main(["mem"] + a), tmp_path,
                      monkeypatch, "native", argv, {})
    jax_sam = _run_cli(jax_cli.main_mem, tmp_path, monkeypatch, "jax", argv,
                       RECORD_ENV)
    assert port == jax_sam
    assert port == native
    assert calls["cigars"] > 0
    if pe:
        assert calls["hits"] > 0 and calls["i16_misses"] > 0
        recs = [ln.split("\t") for ln in port.decode().splitlines()
                if ln.startswith("r")]
        r2_rescued = [r for r in recs
                      if int(r[1]) & 0x80 and not int(r[1]) & 0x904]
        assert len(r2_rescued) == N_RESCUE_ONLY


def test_record_route_without_the_c_library(cli_data, tmp_path, monkeypatch):
    """MPIBWA_NATIVE=0 in a fresh process (no C library for FASTQ parsing,
    chaining or finalization): the same SAM as the record route."""
    from mpibwa_tpu_torch import cli as torch_cli

    monkeypatch.setenv("MPIBWA_TORCH_DEVICE", "cpu")
    argv = ["-t", "1", "-v", "1", cli_data["ref"], cli_data["r1"],
            cli_data["r2"]]
    want = _run_cli(lambda a: torch_cli.main(["mem"] + a), tmp_path,
                    monkeypatch, "record", argv, RECORD_ENV)
    env = dict(os.environ, MPIBWA_NATIVE="0", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    for k in ("MPIBWA_FINAL", "MPIBWA_CHAIN", "MPIBWA_EXT", "MPIBWA_BWD"):
        env.pop(k, None)
    d = tmp_path / "no_c"
    d.mkdir()
    res = subprocess.run([sys.executable, "-m", "mpibwa_tpu_torch.cli", "mem",
                          "-o", "out"] + argv, cwd=d, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert (d / "out.sam").read_bytes() == want
    assert want.count(b"\n") > 2 * N_CLI_PAIRS
