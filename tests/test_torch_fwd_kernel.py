"""The forward automata and the SA walk in one launch each
(mpibwa_tpu_torch/csrc/fwd_automata.cu and sa_walk.cu, wrappers
ops/fwd_cuda.py and ops/sa_cuda.py) against the JAX package's device loops
(mpibwa_tpu/ops/seeding.py ``forward_p3``, ``forward_pass``; ops/fmd.py
``sa_lookup``) on the toy genome, at both position dtypes:

(a) a scalar model of one CUDA thread, written here: one lane (one read,
    one SA index) at a time, the control flow and the O2 sector reads the
    kernels follow (csrc/o2.cuh), equal to the JAX loops on every output
    field, with lanes that hold N bases, reads shorter than the batch
    width, starts past 0 with min_intv > 1, lanes that overflow F_CAP,
    C_CAP and S3_CAP, and the SA walk's edge indices;
(b) the wrappers on CPU tensors (their plain versions) equal to the JAX
    loops, and the seeder's call sites going through the wrappers;
(c) on a card (marked ``gpu``, skipped without one) each kernel equal to
    its plain version, launched once a call.
Equality is exact throughout."""

import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401
from mpibwa_tpu.core.opts import mem_opt_init
from mpibwa_tpu.index.format import load_index

torch.set_num_threads(1)  # test workers run in parallel on few cores

CPU = torch.device("cpu")
SEEK, EXT, DONE = 0, 1, 2
# long reads off the reference (bp, substitution rate): about 30 and 60
# mismatches, so calls of about ten pushes overflow F_CAP alone, then
# C_CAP too; both overflow S3_CAP
LONG_READS = ((1000, 0.03), (1000, 0.03), (2000, 0.04), (2000, 0.04))


# -- (a) the scalar model of one CUDA thread ----------------------------------

class O2Model:
    """The O2 table and the position arithmetic of csrc/o2.cuh for one
    position type (sums wrap to its width)."""

    def __init__(self, tfm):
        self.rows = tfm.o2_tables().numpy().tolist()
        self.n_rows = len(self.rows)
        self.l2 = [int(v) for v in tfm.L2.numpy()]
        self.primary = tfm.primary
        self.seq_len = tfm.seq_len
        self.sa = tfm.sa.numpy().tolist()
        self.sa_intv = tfm.sa_intv
        self.bits = 64 if tfm.idt == torch.int64 else 32

    def wrap(self, v: int) -> int:
        m = 1 << self.bits
        v &= m - 1
        return v - m if v >= m >> 1 else v

    def group(self, sb: int) -> list:
        """The four rows of sub-block sb (one 32-byte sector), or the rows
        at the clamped indices past either end of the table."""
        base = sb << 2
        if 0 <= base and base + 3 < self.n_rows:
            return self.rows[base: base + 4]
        return [self.rows[min(max(base + j, 0), self.n_rows - 1)]
                for j in range(4)]

    @staticmethod
    def count_prefix(word: int, c: int, within: int) -> int:
        keep = ~((1 << (30 - 2 * within)) - 1) & 0xFFFFFFFF
        w = word & 0xFFFFFFFF & keep
        nw = ~w & 0xFFFFFFFF
        a = (w if c & 2 else nw) >> 1
        b = w if c & 1 else nw
        return bin(a & b & 0x55555555).count("1") - (15 - within if c == 0
                                                      else 0)

    def at(self, pos: int) -> "tuple[bool, int, int]":
        """(sentinel, stored offset, sub-block) of a rank position."""
        sent = pos < 0
        k = 0 if sent else pos
        k -= 1 if k >= self.primary else 0
        return sent, k, k >> 4

    def rank_in(self, g, at, c: int) -> int:
        sent, k, _ = at
        if sent:
            return 0
        occ, word = g[c]
        return occ + self.count_prefix(word, c, k & 15)

    def set_intv(self, c: int) -> "tuple[int, int, int]":
        w, l2 = self.wrap, self.l2
        return w(l2[c] + 1), w(l2[3 - c] + 1), w(l2[c + 1] - l2[c])

    def extend1_fwd(self, ik0, ik1, ik2, cb):
        """One forward extension: the sectors at ik1 - 1 and ik1 - 1 + ik2
        (one when they share a sub-block), the ranks of cb and of the extra
        base, then bwt_extend's row cb."""
        w = self.wrap
        kq = w(ik1 - 1)
        ak, al = self.at(kq), self.at(w(kq + ik2))
        gk = self.group(ak[2])
        gl = gk if al[2] == ak[2] else self.group(al[2])
        eb = 0 if cb == 1 else 3
        tkc, tlc = self.rank_in(gk, ak, cb), self.rank_in(gl, al, cb)
        ek, el = self.rank_in(gk, ak, eb), self.rank_in(gl, al, eb)
        totk = 0 if ak[0] else w(ak[1] + 1)
        totl = 0 if al[0] else w(al[1] + 1)

        def g_term(tot, oc, oe):
            return (w(tot - oc) if cb == 0 else w(tot - oe - oc) if cb == 1
                    else oe if cb == 2 else 0)

        s2 = w(tlc - tkc)
        k1n = w(self.l2[cb] + 1 + tkc)
        add = int(ik1 <= self.primary and w(ik1 + ik2 - 1) >= self.primary)
        k0n = w(ik0 + add + w(g_term(totl, tlc, el) - g_term(totk, tkc, ek)))
        return k0n, k1n, s2

    def inv_psi(self, k: int) -> int:
        x = k - (1 if k > self.primary else 0)
        g = self.group(x >> 4)
        c = (g[0][1] & 0xFFFFFFFF) >> (((~x) & 15) << 1) & 3
        at = self.at(k)
        if at[0]:
            occ = 0
        elif at[2] == x >> 4:
            occ = self.rank_in(g, at, c)
        else:
            row = self.rows[min(max((at[2] << 2) + c, 0), self.n_rows - 1)]
            occ = row[0] + self.count_prefix(row[1], c, at[1] & 15)
        if k == self.seq_len:
            occ = self.l2[c + 1] - self.l2[c]
        return 0 if k == self.primary else self.wrap(self.l2[c] + occ)

    def sa_walk(self, k: int) -> int:
        """One thread of csrc/sa_walk.cu."""
        mask = self.sa_intv - 1
        steps = 0
        while k & mask and steps < self.seq_len + 2:
            k = self.inv_psi(k)
            steps += 1
        row = min(max(k // self.sa_intv, 0), len(self.sa) - 1)
        return self.wrap(steps + self.sa[row])


class FwdLane:
    """The pass-1/pass-2 automaton of one thread (csrc/fwd_automata.cu
    ``Fwd``), writing into one lane's rows of the output arrays."""

    def __init__(self, m: O2Model, out: dict, b: int, x0: int):
        self.m, self.out, self.b = m, out, b
        self.x, self.kind, self.info, self.i = x0, SEEK, 0, 0
        self.n_pushed = self.n_calls = self.cur_start = 0
        self.ik = (0, 0, 0)
        self.overflow = False

    def seek(self, q, L, length, chain, c_cap):
        if self.kind != SEEK:
            return
        x, o, b = self.x, self.out, self.b
        qx = int(q[x]) if 0 <= x < L else 4
        if x >= length:
            self.kind = DONE
        elif qx > 3:
            if chain:
                self.x += 1
            else:
                self.kind = DONE
        elif self.n_calls >= c_cap:
            self.overflow, self.kind = True, DONE
        else:
            if self.n_calls:
                o["call_len"][b, self.n_calls - 1] = (self.n_pushed
                                                      - self.cur_start)
            o["call_x"][b, self.n_calls] = x
            o["call_start"][b, self.n_calls] = self.n_pushed
            self.cur_start = self.n_pushed
            self.n_calls += 1
            self.ik = self.m.set_intv(qx)
            self.info = self.i = x + 1
            self.kind = EXT

    def step(self, qi, length, minv, chain, f_cap):
        if self.kind != EXT:
            return
        o, b = self.out, self.b
        at_end = self.i >= length
        amb = not at_end and qi > 3
        do_ext = not at_end and not amb
        nk = self.m.extend1_fwd(*self.ik, 3 - qi) if do_ext else (0, 0, 0)
        changed = nk[2] != self.ik[2]
        if at_end or amb or (do_ext and changed):
            if self.n_pushed < f_cap:
                o["ivals"][b, self.n_pushed] = self.ik
                o["infos"][b, self.n_pushed] = self.info
            else:
                self.overflow = True
            self.n_pushed += 1
        if at_end or amb or (do_ext and changed and nk[2] < minv):
            if chain:
                self.x, self.kind = self.info, SEEK
            else:
                self.kind = DONE
        else:
            self.ik = nk
            self.info = self.i = self.i + 1

    def finish(self):
        o, b = self.out, self.b
        if self.n_calls:
            o["call_len"][b, self.n_calls - 1] = self.n_pushed - self.cur_start
        o["n_pushed"][b] = self.n_pushed
        o["n_calls"][b] = self.n_calls
        o["overflow"][b] = self.overflow


def _fwd_arrays(B, idt):
    from mpibwa_tpu_torch.ops.seeding import C_CAP, F_CAP

    return {"ivals": np.zeros((B, F_CAP, 3), idt),
            "infos": np.zeros((B, F_CAP), np.int32),
            "n_pushed": np.zeros(B, np.int32),
            "call_x": np.zeros((B, C_CAP), np.int32),
            "call_start": np.zeros((B, C_CAP), np.int32),
            "call_len": np.zeros((B, C_CAP), np.int32),
            "n_calls": np.zeros(B, np.int32),
            "overflow": np.zeros(B, bool)}


def model_forward_pass(m, q, lens, minv, chain=True, starts=None):
    """forward_pass_kernel, one thread (read) after another."""
    from mpibwa_tpu_torch.ops.seeding import C_CAP, F_CAP

    B, L = q.shape
    out = _fwd_arrays(B, np.int64 if m.bits == 64 else np.int32)
    for b in range(B):
        s = FwdLane(m, out, b, 0 if starts is None else int(starts[b]))
        while s.kind != DONE:
            s.seek(q[b], L, int(lens[b]), chain, C_CAP)
            qi = int(q[b, s.i]) if 0 <= s.i < L else 4
            s.step(qi, int(lens[b]), int(minv[b]), chain, F_CAP)
        s.finish()
    return out


def model_forward_p3(m, q, lens, minv, min_seed_len, max_intv):
    """forward_p3_kernel, one thread (read) after another: each round the
    pass-1 automaton and the pass-3 sweep both seek, then both extend."""
    from mpibwa_tpu_torch.ops.seeding import C_CAP, F_CAP, S3_CAP

    B, L = q.shape
    idt = np.int64 if m.bits == 64 else np.int32
    out = _fwd_arrays(B, idt)
    p3 = {"seeds": np.zeros((B, S3_CAP, 3), idt),
          "infos": np.zeros((B, S3_CAP), np.int64),
          "n_seeds": np.zeros(B, np.int32), "overflow": np.zeros(B, bool)}
    for b in range(B):
        row, n = q[b], int(lens[b])

        def base(pos):
            return int(row[pos]) if 0 <= pos < L else 4

        s = FwdLane(m, out, b, 0)
        px = pi = pn = 0
        pkind, pk, pov = SEEK, (0, 0, 0), False
        while s.kind != DONE or pkind != DONE:
            s.seek(row, L, n, True, C_CAP)
            if pkind == SEEK:
                pqx = base(px)
                if px >= n:
                    pkind = DONE
                elif pqx > 3:
                    px += 1
                else:
                    pk, pi, pkind = m.set_intv(pqx), px + 1, EXT
            s.step(base(s.i), n, int(minv[b]), True, F_CAP)
            if pkind != EXT:
                continue
            pqi = base(pi)
            p_end = pi >= n
            pamb = not p_end and pqi > 3
            pdo = not p_end and not pamb
            qk = m.extend1_fwd(*pk, 3 - pqi) if pdo else (0, 0, 0)
            hit = pdo and qk[2] < max_intv and pi - px >= min_seed_len
            if hit and qk[2] > 0:
                if pn < S3_CAP:
                    p3["seeds"][b, pn] = qk
                    p3["infos"][b, pn] = (px << 32) | (pi + 1)
                else:
                    pov = True
                pn += 1
            if p_end:
                pkind = DONE
            elif pamb or hit:
                px, pkind = pi + 1, SEEK
            else:
                pk, pi = qk, pi + 1
        s.finish()
        p3["n_seeds"][b], p3["overflow"][b] = pn, pov
    return out, p3


# -- fixtures -----------------------------------------------------------------

@pytest.fixture(scope="module")
def index(tmp_path_factory):
    paths = toy.build_toy(str(tmp_path_factory.mktemp("toy")))
    return {"idx": load_index(paths["ref"]), "paths": paths}


@pytest.fixture(scope="module")
def batch(index):
    """(q (B, L) uint8, lens (B,) int32, starts, min_intv): toy reads, one
    with an N run mid-read, one starting with N, one cut short, and the
    LONG_READS off the reference (the batch is as wide as the longest);
    starts and min_intv (1-4) for the single-call mode, one start on an N
    and some past the read end."""
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.pipeline.device_seed import _pad_batch

    rng = np.random.default_rng(8)
    reads = [s.seq.copy() for s in toy.load_reads(index["paths"]["r1"],
                                                  limit=40)]
    reads[3][30:34] = 4
    reads[4][:2] = 4
    reads[5] = reads[5][:45]
    fm = DeviceFMIndex(index["idx"], CPU)
    for n, rate in LONG_READS:
        reads.append(toy.ref_reads(fm, rng, 1, n, rate)[0])
    q, lens = _pad_batch(reads)
    B, L = q.shape
    starts = rng.integers(0, 101, B).astype(np.int32)
    starts[3] = 31
    starts[-len(LONG_READS):] = rng.integers(0, 900, len(LONG_READS))
    starts[:2] = (lens[0] + 1, L + 3)
    minv = rng.integers(1, 5, B).astype(np.int64)
    return q, lens, starts, minv


@pytest.fixture(scope="module", params=[False, True], ids=["i32", "i64"])
def fms(request, index):
    """(JAX DeviceFMIndex, torch DeviceFMIndex on the CPU, model)."""
    from mpibwa_tpu.ops.fmd import DeviceFMIndex as JaxFM
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    tfm = DeviceFMIndex(index["idx"], CPU, force_wide=request.param)
    return JaxFM(index["idx"], force_wide=request.param), tfm, O2Model(tfm)


@pytest.fixture(scope="module")
def jax_out(fms, batch):
    """The JAX loops' outputs on the batch, as numpy: forward_p3, the
    chained and the single-call forward_pass, and the SA walk of
    sa_indices."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops import seeding as JS

    jfm, tfm, _ = fms
    q, lens, starts, minv = batch
    B = len(q)
    opt = mem_opt_init()
    ones = jnp.ones(B, jnp.int64)
    out = {"p3": JS.forward_p3(jfm, jnp.asarray(q), jnp.asarray(lens), ones,
                               opt.min_seed_len, opt.max_mem_intv),
           "chain": JS.forward_pass(jfm, jnp.asarray(q), jnp.asarray(lens),
                                    ones, True),
           "single": JS.forward_pass(jfm, jnp.asarray(q), jnp.asarray(lens),
                                     jnp.asarray(minv), False,
                                     jnp.asarray(starts))}
    ks = sa_indices(tfm)
    out["sa"] = (ks, np.asarray(jfm.sa_lookup(jnp.asarray(ks))))

    def to_np(t):
        return {n: np.asarray(v) for n, v in zip(t._fields, t)}

    return {k: ((to_np(v[0]), to_np(v[1])) if k == "p3" else
                v if k == "sa" else to_np(v)) for k, v in out.items()}


def sa_indices(tfm) -> np.ndarray:
    """SA indices of the walk: random ones, 0, primary and its neighbours,
    seq_len - 1, seq_len, and multiples of sa_intv (no step)."""
    rng = np.random.default_rng(9)
    p, n = tfm.primary, tfm.seq_len
    mult = np.arange(0, n + 1, tfm.sa_intv)
    ks = np.concatenate([rng.integers(0, n + 1, 600), [0, p - 1, p, p + 1,
                                                       n - 1, n],
                         mult[:40], mult[-3:]])
    return ks.astype(tfm.np_idt)


def _assert_fields(got: dict, want: dict, tag: str):
    assert set(got) == set(want), tag
    for name in want:
        g, w = np.asarray(got[name]), want[name]
        assert g.shape == w.shape and g.dtype == w.dtype, (tag, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} {name}")


def _np(t) -> dict:
    return {n: v.numpy() for n, v in zip(t._fields, t)}


# -- (a) the model against the JAX loops --------------------------------------

def test_model_forward_p3(fms, batch, jax_out):
    """forward_p3: every field of both automata, with lanes overflowing
    F_CAP alone, C_CAP and S3_CAP among them."""
    from mpibwa_tpu_torch.ops.seeding import C_CAP, F_CAP, S3_CAP

    _, _, m = fms
    q, lens, _, _ = batch
    opt = mem_opt_init()
    fwd, p3 = model_forward_p3(m, q, lens, np.ones(len(q), np.int64),
                               opt.min_seed_len, opt.max_mem_intv)
    want_f, want_p = jax_out["p3"]
    _assert_fields(fwd, want_f, "pass 1")
    _assert_fields(p3, want_p, "pass 3")
    ov, calls, pushed = want_f["overflow"], want_f["n_calls"], \
        want_f["n_pushed"]
    assert (ov & (calls < C_CAP) & (pushed > F_CAP)).any()  # F_CAP alone
    assert (ov & (calls == C_CAP)).any()  # C_CAP ended the lane
    assert (want_p["overflow"] & (want_p["n_seeds"] > S3_CAP)).any()
    assert (~ov).sum() >= 40 and want_p["n_seeds"].sum() > 0


@pytest.mark.parametrize("mode", ["chain", "single"])
def test_model_forward_pass(fms, batch, jax_out, mode):
    """forward_pass chained from 0 (pass 1) and one call a lane from
    starts with min_intv 1-4 (pass 2): every field."""
    _, _, m = fms
    q, lens, starts, minv = batch
    if mode == "chain":
        got = model_forward_pass(m, q, lens, np.ones(len(q), np.int64))
    else:
        got = model_forward_pass(m, q, lens, minv, False, starts)
        assert (got["n_calls"] == 0).sum() >= 3  # past the end, on an N
    _assert_fields(got, jax_out[mode], mode)


def test_model_sa_walk(fms, jax_out):
    _, _, m = fms
    ks, want = jax_out["sa"]
    got = np.array([m.sa_walk(int(k)) for k in ks], dtype=want.dtype)
    np.testing.assert_array_equal(got, want)
    assert int(want[ks == m.primary][0]) == 0


# -- (b) the wrappers on CPU tensors ------------------------------------------

def test_wrappers_on_cpu_equal_jax(fms, batch, jax_out):
    """On CPU tensors each wrapper runs its plain version (no launch is
    counted) and equals the JAX loop."""
    from mpibwa_tpu_torch.ops import fwd_cuda, sa_cuda

    _, tfm, _ = fms
    q, lens, starts, minv = batch
    qt, lt = torch.from_numpy(q), torch.from_numpy(lens)
    ones = torch.ones(len(q), dtype=torch.int64)
    n0 = (fwd_cuda.forward_p3_kernel.launches,
          fwd_cuda.forward_pass_kernel.launches,
          sa_cuda.sa_walk_kernel.launches)
    opt = mem_opt_init()
    fwd, p3 = fwd_cuda.forward_p3_kernel(tfm, qt, lt, ones, opt.min_seed_len,
                                         opt.max_mem_intv)
    _assert_fields(_np(fwd), jax_out["p3"][0], "pass 1")
    _assert_fields(_np(p3), jax_out["p3"][1], "pass 3")
    got = fwd_cuda.forward_pass_kernel(tfm, qt, lt, ones, True)
    _assert_fields(_np(got), jax_out["chain"], "chain")
    got = fwd_cuda.forward_pass_kernel(tfm, qt, lt, torch.from_numpy(minv),
                                       False, torch.from_numpy(starts))
    _assert_fields(_np(got), jax_out["single"], "single")
    ks, want = jax_out["sa"]
    np.testing.assert_array_equal(
        sa_cuda.sa_walk_kernel(tfm, torch.from_numpy(ks)).numpy(), want)
    np.testing.assert_array_equal(tfm.sa_lookup(torch.from_numpy(ks)).numpy(),
                                  want)
    assert (fwd_cuda.forward_p3_kernel.launches,
            fwd_cuda.forward_pass_kernel.launches,
            sa_cuda.sa_walk_kernel.launches) == n0


@pytest.mark.parametrize("y", [None, "0"], ids=["p3", "no_p3"])
def test_seeder_calls_the_wrappers(index, tmp_path, monkeypatch, y):
    """`cli mem` (PE, on the CPU) reaches the forward automata and the SA
    walk only through the wrappers: forward_p3 for pass 1 by default,
    forward_pass chained under -y 0, and forward_pass for pass 2."""
    from mpibwa_tpu_torch import cli
    from mpibwa_tpu_torch.ops import fwd_cuda, sa_cuda

    calls = {"p3": 0, "chain": 0, "single": 0, "sa": 0}
    real = (fwd_cuda.forward_p3_kernel, fwd_cuda.forward_pass_kernel,
            sa_cuda.sa_walk_kernel)

    def p3(*a):
        calls["p3"] += 1
        return real[0](*a)

    def fp(fm, q, lens, minv, chain=True, starts=None):
        calls["chain" if chain else "single"] += 1
        return real[1](fm, q, lens, minv, chain, starts)

    def sa(*a):
        calls["sa"] += 1
        return real[2](*a)

    monkeypatch.setattr(fwd_cuda, "forward_p3_kernel", p3)
    monkeypatch.setattr(fwd_cuda, "forward_pass_kernel", fp)
    monkeypatch.setattr(sa_cuda, "sa_walk_kernel", sa)
    monkeypatch.setenv("MPIBWA_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    paths = index["paths"]
    fq = []
    for key in ("r1", "r2"):
        lines = open(paths[key]).read().splitlines()[: 4 * 24]
        fq.append(str(tmp_path / f"{key}.fq"))
        open(fq[-1], "w").write("\n".join(lines) + "\n")
    argv = ["mem", "-t", "1", "-o", "out"] + (["-y", y] if y else [])
    assert cli.main(argv + [paths["ref"]] + fq) == 0
    assert (tmp_path / "out.sam").read_bytes().count(b"\n") > 48
    assert calls["single"] > 0 and calls["sa"] > 0
    if y is None:
        assert calls["p3"] > 0 and calls["chain"] == 0
    else:
        assert calls["chain"] > 0 and calls["p3"] == 0


# -- (c) on the card ----------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True], ids=["i32", "i64"])
def test_kernels_match_plain_on_gpu(index, batch, wide):
    """Each kernel equals its plain version on the card, on every output
    field, in exactly one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from mpibwa_tpu_torch.ops import fwd_cuda, sa_cuda, seeding
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex, _sa_lookup16

    dev = torch.device("cuda")
    fm = DeviceFMIndex(index["idx"], dev, force_wide=wide)
    q, lens, starts, minv = (torch.from_numpy(a).to(dev) for a in batch)
    ones = torch.ones(len(q), dtype=torch.int64, device=dev)
    opt = mem_opt_init()

    def once(wrapper, *a):
        n0 = wrapper.launches
        out = wrapper(*a)
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1
        return out

    got = once(fwd_cuda.forward_p3_kernel, fm, q, lens, ones,
               opt.min_seed_len, opt.max_mem_intv)
    want = seeding.forward_p3(fm, q, lens, ones, opt.min_seed_len,
                              opt.max_mem_intv)
    for g, w in zip(got, want):
        _assert_fields(_np(g.__class__(*(t.cpu() for t in g))),
                       _np(w.__class__(*(t.cpu() for t in w))), "p3")
    for args in ((ones, True), (minv, False, starts)):
        got = once(fwd_cuda.forward_pass_kernel, fm, q, lens, *args)
        want = seeding.forward_pass(fm, q, lens, *args)
        _assert_fields(_np(got.__class__(*(t.cpu() for t in got))),
                       _np(want.__class__(*(t.cpu() for t in want))),
                       "forward_pass")
    ks = torch.from_numpy(sa_indices(fm)).to(dev)
    got = once(sa_cuda.sa_walk_kernel, fm, ks)
    want = _sa_lookup16(fm._o2, fm.L2, fm.primary, fm.seq_len, fm.sa,
                        fm.sa_intv, ks)
    assert torch.equal(got, want)
