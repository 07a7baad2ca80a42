"""The forward automata and the SA walk in one launch each
(mpibwa_tpu_torch/csrc/fwd_automata.cu and sa_walk.cu, wrappers
ops/fwd_cuda.py and ops/sa_cuda.py) against the JAX package's device loops
(mpibwa_tpu/ops/seeding.py ``forward_p3``, ``forward_pass``; ops/fmd.py
``sa_lookup``) on the toy genome, at both position dtypes:

(a) a model of the kernels' threads, written here: the forward kernels
    block by block (each block's reads staged in shared memory where they
    fit, else read in place), forward_p3's warps split into a pass-1 and a
    pass-3 role, each automaton held in lockstep by a group of G threads
    that share out the step's four O2 rows and exchange the ranks by
    shuffles (G = 1, 2 and 4, the kernels' own among them); the SA walk one
    index a thread, one O2 sector a step. Equal to the JAX loops on every
    output field, with lanes that hold N bases, reads shorter than the
    batch width, starts past 0 with min_intv > 1, lanes that overflow
    F_CAP, C_CAP and S3_CAP, the SA walk's edge indices, and every SA
    index of two small indices;
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


# -- (a) the model of the kernels' threads ----------------------------------

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

    def set_intv(self, c: int) -> "tuple[int, int, int]":
        w, l2 = self.wrap, self.l2
        return w(l2[c] + 1), w(l2[3 - c] + 1), w(l2[c + 1] - l2[c])

    def rank_at(self, at, c: int) -> "tuple[int, int]":
        """(rank, row index) of base c at `at` from its one row, the index
        clamped into the table (csrc/o2.cuh rank_at); no row (-1) at the
        sentinel."""
        sent, k, sb = at
        if sent:
            return 0, -1
        r = min(max(sb * 4 + c, 0), self.n_rows - 1)
        occ, word = self.rows[r]
        return occ + self.count_prefix(word, c, k & 15), r

    def fwd_ranks(self, ak, al, cb: int, G: int) -> list:
        """The four ranks of a forward extension by a group of G threads
        (csrc/o2.cuh fwd_ranks): item j = 2 * pos + base of (k, cb), (k,
        eb), (l, cb), (l, eb); thread t loads and ranks items t * n .. t *
        n + n - 1 (n = 4 / G), one row each, and the group's rows lie in at
        most two sectors; __shfl_sync(mask, mine[j % n], j // n, G) then
        hands every thread item j from thread j // n."""
        n = 4 // G
        eb = 0 if cb == 1 else 3
        mine = [[self.rank_at(al if j & 2 else ak, eb if j & 1 else cb)
                 for j in range(t * n, t * n + n)] for t in range(G)]
        rows = {r for own in mine for _, r in own if r >= 0}
        assert len({r >> 2 for r in rows}) <= 2
        held = [[mine[j // n][j % n][0] for j in range(4)] for _ in range(G)]
        assert all(h == held[0] for h in held)
        return held[0]

    def extend1_fwd(self, ik0, ik1, ik2, cb, G: int = 1):
        """One forward extension by a group of G threads: the ranks of cb
        and of the extra base at ik1 - 1 and ik1 - 1 + ik2 (fwd_ranks),
        then bwt_extend's row cb, the same in every thread."""
        w = self.wrap
        kq = w(ik1 - 1)
        ak, al = self.at(kq), self.at(w(kq + ik2))
        tkc, ek, tlc, el = self.fwd_ranks(ak, al, cb, G)
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
        """One step of the SA walk as csrc/o2.cuh inv_psi takes it, from
        one sector, x's: the base and its count in the prefix from row 0's
        word (an XOR with the base in every 2-bit field, one masked
        popcount), the count at the sub-block's start from row c; primary,
        seq_len, the sentinel and sectors past the table take the plain
        step (inv_psi_edge)."""
        x = k - (1 if k > self.primary else 0)
        sb = x >> 4
        if not 0 <= sb < self.n_rows >> 2 or k in (self.primary,
                                                    self.seq_len):
            return self.inv_psi_edge(k, x)
        g = self.rows[sb * 4: sb * 4 + 4]
        sh = (15 - (x & 15)) << 1
        w = g[0][1] & 0xFFFFFFFF
        c = w >> sh & 3
        m = ~(w ^ 0x55555555 * c) & 0xFFFFFFFF
        keep = (0xFFFFFFFF << sh) & 0x55555555
        return self.wrap(self.l2[c] + g[c][0]
                         + bin(m & m >> 1 & keep).count("1"))

    def inv_psi_edge(self, k: int, x: int) -> int:
        """The plain step (csrc/o2.cuh inv_psi_edge): the base from row 0
        of x's sub-block, its rank at k from its own row (rank_at), both
        clamped into the table."""
        r0 = self.rows[min(max((x >> 4) * 4, 0), self.n_rows - 1)]
        c = (r0[1] & 0xFFFFFFFF) >> (((~x) & 15) << 1) & 3
        occ, _ = self.rank_at(self.at(k), c)
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


# the kernels' block shape, read from their source: threads a block,
# threads an automaton (the group), bytes of a block's staged reads
CU = "mpibwa_tpu_torch/csrc/fwd_automata.cu"


def cu_shape() -> dict:
    import os
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(root, CU)).read()
    out = {}
    for name in ("THREADS", "G", "STAGE_MAX"):
        expr = re.search(rf"constexpr int {name} = ([0-9 *]+);", src).group(1)
        out[name] = int(np.prod([int(v) for v in expr.split("*")]))
    return out


def launch_shape(B: int, L: int, reads: int, stage_max: int):
    """(grid, Lp) of a launch of blocks of `reads` reads (csrc shape()):
    Lp = L where the block's rows fit in stage_max bytes of shared memory,
    0 where they are read in place."""
    nbytes = (reads * L + 31) // 16 * 16
    return -(-B // reads), (L if nbytes <= stage_max else 0)


def block_threads(p3: bool, G: int, threads: int) -> list:
    """(role, read within the block, thread within the group) of each thread
    of a block (lane_of): forward_p3's first half of warps run pass 1, the
    second half pass 3, of the same reads; every warp has one role and
    every read of a role G threads."""
    out = []
    for tid in range(threads):
        role = "p3" if p3 and tid >= threads // 2 else "fwd"
        r = tid - (threads // 2 if role == "p3" else 0)
        out.append((role, r // G, r % G))
    for w in range(0, threads, 32):
        assert len({role for role, _, _ in out[w: w + 32]}) == 1
    per = {}
    for role, read, t in out:
        per.setdefault((role, read), []).append(t)
    assert all(ts == list(range(G)) for ts in per.values())
    return out


def stage_rows(q: np.ndarray, b0: int, n: int) -> "tuple[np.ndarray, int]":
    """A block's staged reads (stage_reads): the whole aligned 16-byte words
    around rows b0 .. b0 + n - 1 of q, bytes outside q unset (255); and the
    offset of read b0's first byte in them."""
    L = q.shape[1]
    flat = q.reshape(-1)
    start = b0 * L
    off = (q.ctypes.data + start) % 16
    words = -(-(off + n * L) // 16)
    smem = np.full(16 * words, 255, np.uint8)
    lo, hi = start - off, min(start - off + 16 * words, flat.size)
    smem[max(0, -lo): hi - lo] = flat[max(lo, 0): hi]
    return smem, off


class FwdLane:
    """The pass-1/pass-2 automaton of one lane, as the G threads of its
    group hold it in lockstep (csrc/fwd_automata.cu ``Fwd``): one state,
    the step's four ranks shared out (O2Model.extend1_fwd), each item of a
    write by thread j % G (``writes``, counted in ``wrote``)."""

    def __init__(self, m: O2Model, out: dict, b: int, x0: int, G: int = 1):
        self.m, self.out, self.b, self.G = m, out, b, G
        self.x, self.kind, self.info, self.i = x0, SEEK, 0, 0
        self.n_pushed = self.n_calls = self.cur_start = 0
        self.ik = (0, 0, 0)
        self.overflow = False
        self.wrote = [0] * G

    def put(self, name, idx, value, j):
        """item j of a group's write, by the one thread with j % G == t"""
        (t,) = [t for t in range(self.G) if j % self.G == t]
        self.wrote[t] += 1
        self.out[name][idx] = value

    def seek(self, q, L, length, chain, c_cap):
        if self.kind != SEEK:
            return
        x, b = self.x, self.b
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
            c = self.n_calls
            if c:
                self.put("call_len", (b, c - 1),
                         self.n_pushed - self.cur_start, 0)
            self.put("call_x", (b, c), x, 1)
            self.put("call_start", (b, c), self.n_pushed, 2)
            self.cur_start = self.n_pushed
            self.n_calls += 1
            self.ik = self.m.set_intv(qx)
            self.info = self.i = x + 1
            self.kind = EXT

    def step(self, qi, length, minv, chain, f_cap):
        if self.kind != EXT:
            return
        b = self.b
        at_end = self.i >= length
        amb = not at_end and qi > 3
        do_ext = not at_end and not amb
        nk = (self.m.extend1_fwd(*self.ik, 3 - qi, self.G) if do_ext
              else (0, 0, 0))
        changed = nk[2] != self.ik[2]
        if at_end or amb or (do_ext and changed):
            if self.n_pushed < f_cap:
                for j in range(3):
                    self.put("ivals", (b, self.n_pushed, j), self.ik[j], j)
                self.put("infos", (b, self.n_pushed), self.info, 3)
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
        b = self.b
        if self.n_calls:
            self.put("call_len", (b, self.n_calls - 1),
                     self.n_pushed - self.cur_start, 0)
        self.put("n_pushed", b, self.n_pushed, 1)
        self.put("n_calls", b, self.n_calls, 2)
        self.put("overflow", b, self.overflow, 3)

    def run(self, row, L, length, minv, chain):
        """run_fwd: the lane to its end"""
        from mpibwa_tpu_torch.ops.seeding import C_CAP, F_CAP

        while self.kind != DONE:
            self.seek(row, L, length, chain, C_CAP)
            self.step(int(row[self.i]) if 0 <= self.i < L else 4, length,
                      minv, chain, F_CAP)
        self.finish()


def run_p3(m, row, L, n, G, p3, b, min_seed_len, max_intv) -> list:
    """run_p3: the pass-3 sweep of one lane to its end, as its group holds
    it; returns the writes of each thread of the group."""
    from mpibwa_tpu_torch.ops.seeding import S3_CAP

    def base(pos):
        return int(row[pos]) if 0 <= pos < L else 4

    wrote = [0] * G

    def put(name, idx, value, j):
        wrote[j % G] += 1
        p3[name][idx] = value

    x = i = pn = 0
    kind, k, ov = SEEK, (0, 0, 0), False
    while kind != DONE:
        if kind == SEEK:
            qx = base(x)
            if x >= n:
                kind = DONE
            elif qx > 3:
                x += 1
            else:
                k, i, kind = m.set_intv(qx), x + 1, EXT
        if kind != EXT:
            continue
        qi = base(i)
        at_end = i >= n
        amb = not at_end and qi > 3
        do_ext = not at_end and not amb
        nk = m.extend1_fwd(*k, 3 - qi, G) if do_ext else (0, 0, 0)
        hit = do_ext and nk[2] < max_intv and i - x >= min_seed_len
        if hit and nk[2] > 0:
            if pn < S3_CAP:
                for j in range(3):
                    put("seeds", (b, pn, j), nk[j], j)
                put("infos", (b, pn), (x << 32) | (i + 1), 3)
            else:
                ov = True
            pn += 1
        if at_end:
            kind = DONE
        elif amb or hit:
            x, kind = i + 1, SEEK
        else:
            k, i = nk, i + 1
    put("n_seeds", b, pn, 0)
    put("overflow", b, ov, 1)
    return wrote


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


def _blocks(q, reads, G, p3, shape):
    """Each read of each block as the launch holds it: (b, row, staged), its
    row from the block's staged reads where the block's rows fit in shared
    memory, else q's row in place."""
    B, L = q.shape
    grid, Lp = launch_shape(B, L, reads, shape["STAGE_MAX"])
    block_threads(p3, G, shape["THREADS"])
    for blk in range(grid):
        b0 = blk * reads
        n = min(reads, B - b0)
        smem, off = stage_rows(q, b0, n) if Lp else (None, 0)
        for j in range(n):
            row = (smem[off + j * Lp: off + (j + 1) * Lp] if Lp
                   else q[b0 + j])
            yield b0 + j, row, Lp > 0


def model_forward_pass(m, q, lens, minv, chain=True, starts=None, G=None,
                       writes=None):
    """forward_pass_kernel block by block: a group of G threads a read
    (the kernel's G by default), its row staged or in place."""
    shape = cu_shape()
    G = G or shape["G"]
    B, L = q.shape
    out = _fwd_arrays(B, np.int64 if m.bits == 64 else np.int32)
    for b, row, staged in _blocks(q, shape["THREADS"] // G, G, False, shape):
        s = FwdLane(m, out, b, 0 if starts is None else int(starts[b]), G)
        s.run(row, L, int(lens[b]), int(minv[b]), chain)
        if writes is not None:
            writes.append((staged, s.wrote))
    return out


def model_forward_p3(m, q, lens, minv, min_seed_len, max_intv, G=None,
                     writes=None):
    """forward_p3_kernel block by block: for each read a pass-1 group and a
    pass-3 group, each run to its own end."""
    from mpibwa_tpu_torch.ops.seeding import S3_CAP

    shape = cu_shape()
    G = G or shape["G"]
    B, L = q.shape
    idt = np.int64 if m.bits == 64 else np.int32
    out = _fwd_arrays(B, idt)
    p3 = {"seeds": np.zeros((B, S3_CAP, 3), idt),
          "infos": np.zeros((B, S3_CAP), np.int64),
          "n_seeds": np.zeros(B, np.int32), "overflow": np.zeros(B, bool)}
    reads = shape["THREADS"] // 2 // G
    for b, row, staged in _blocks(q, reads, G, True, shape):
        s = FwdLane(m, out, b, 0, G)
        s.run(row, L, int(lens[b]), int(minv[b]), True)
        w3 = run_p3(m, row, L, int(lens[b]), G, p3, b, min_seed_len,
                    max_intv)
        if writes is not None:
            writes.append((staged, [a + c for a, c in zip(s.wrote, w3)]))
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

GROUPS = (1, 2, 4)  # threads an automaton the model runs at
ROWS = ("short", "wide")


def rows_case(batch, jax_want, rows):
    """The batch and the JAX outputs of a case: "wide", the whole batch (as
    wide as its longest read: every block reads its rows in place);
    "short", the toy reads alone, cut to their own width (their blocks
    stage their rows). A lane's outputs do not depend on the batch width
    or on the other lanes."""
    q, lens, starts, minv = batch
    if rows == "wide":
        return batch, jax_want
    n = len(q) - len(LONG_READS)
    cut = {k: v[:n] for k, v in jax_want.items()}
    return (np.ascontiguousarray(q[:n, : int(lens[:n].max())]), lens[:n],
            starts[:n], minv[:n]), cut


def check_writes(writes, rows, G):
    """Every thread of a group writes its share; short rows staged at the
    kernels' own G, wide rows never."""
    assert all(sum(w[t] for _, w in writes) > 0 for t in range(G))
    staged = {s for s, _ in writes}
    if rows == "wide":
        assert staged == {False}
    elif G == cu_shape()["G"]:
        assert staged == {True}


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("G", GROUPS)
def test_model_forward_p3(fms, batch, jax_out, G, rows):
    """forward_p3: every field of both automata, with lanes overflowing
    F_CAP alone, C_CAP and S3_CAP among them (wide rows)."""
    from mpibwa_tpu_torch.ops.seeding import C_CAP, F_CAP, S3_CAP

    _, _, m = fms
    (q, lens, _, _), want_f = rows_case(batch, jax_out["p3"][0], rows)
    _, want_p = rows_case(batch, jax_out["p3"][1], rows)
    opt = mem_opt_init()
    writes = []
    fwd, p3 = model_forward_p3(m, q, lens, np.ones(len(q), np.int64),
                               opt.min_seed_len, opt.max_mem_intv, G, writes)
    _assert_fields(fwd, want_f, "pass 1")
    _assert_fields(p3, want_p, "pass 3")
    check_writes(writes, rows, G)
    ov, calls, pushed = want_f["overflow"], want_f["n_calls"], \
        want_f["n_pushed"]
    assert (~ov).sum() >= 40 and want_p["n_seeds"].sum() > 0
    if rows == "wide":
        assert (ov & (calls < C_CAP) & (pushed > F_CAP)).any()  # F_CAP alone
        assert (ov & (calls == C_CAP)).any()  # C_CAP ended the lane
        assert (want_p["overflow"] & (want_p["n_seeds"] > S3_CAP)).any()


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("mode", ["chain", "single"])
def test_model_forward_pass(fms, batch, jax_out, mode, G, rows):
    """forward_pass chained from 0 (pass 1) and one call a lane from
    starts with min_intv 1-4 (pass 2): every field."""
    _, _, m = fms
    (q, lens, starts, minv), want = rows_case(batch, jax_out[mode], rows)
    writes = []
    if mode == "chain":
        got = model_forward_pass(m, q, lens, np.ones(len(q), np.int64),
                                 G=G, writes=writes)
    else:
        got = model_forward_pass(m, q, lens, minv, False, starts, G, writes)
        assert (got["n_calls"] == 0).sum() >= 3  # past the end, on an N
    _assert_fields(got, want, mode)
    check_writes(writes, rows, G)


def test_model_sa_walk(fms, jax_out):
    _, _, m = fms
    ks, want = jax_out["sa"]
    got = np.array([m.sa_walk(int(k)) for k in ks], dtype=want.dtype)
    np.testing.assert_array_equal(got, want)
    assert int(want[ks == m.primary][0]) == 0


# two small indices of a uniform random genome, (seed, bp, whether primary
# starts a sub-block): seed 35's has primary % 16 == 0, so stored(primary)
# = primary - 1 lies in another sub-block than primary; in both, primary
# is no multiple of sa_intv, so the walk from primary takes its step
SMALL = ((35, 3000, True), (0, 2999, False))


@pytest.fixture(scope="module", params=SMALL, ids=lambda p: f"seed{p[0]}")
def small_index(request, tmp_path_factory):
    """(index, whether primary starts a sub-block) of a SMALL genome."""
    from mpibwa_tpu_torch.index.build import build_index

    seed, bp, on_start = request.param
    rng = np.random.default_rng(seed)
    ref = str(tmp_path_factory.mktemp(f"small{seed}") / "g.fa")
    toy.write_fasta(ref, {"g": "".join("ACGT"[i]
                                       for i in rng.integers(0, 4, bp))})
    build_index(ref)
    return load_index(ref), on_start


@pytest.mark.parametrize("wide", [False, True], ids=["i32", "i64"])
def test_sa_walk_every_index(small_index, wide):
    """Every SA index 0..seq_len of a small index (0, primary, seq_len and
    every multiple of sa_intv among them): the model of the kernel's
    thread (one sector a step) and the port's plain _sa_lookup16 equal the
    JAX walk exactly, on one index whose primary starts a sub-block and
    one whose primary does not."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops.fmd import DeviceFMIndex as JaxFM
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex, _sa_lookup16

    idx, on_start = small_index
    tfm = DeviceFMIndex(idx, CPU, force_wide=wide)
    m = O2Model(tfm)
    assert (m.primary % 16 == 0) == on_start and m.primary % m.sa_intv
    ks = np.arange(m.seq_len + 1, dtype=tfm.np_idt)
    want = np.asarray(JaxFM(idx, force_wide=wide).sa_lookup(jnp.asarray(ks)))
    st = {}
    got = _sa_lookup16(tfm._o2, tfm.L2, tfm.primary, tfm.seq_len, tfm.sa,
                       tfm.sa_intv, torch.from_numpy(ks), stats=st)
    np.testing.assert_array_equal(got.numpy(), want)
    steps = st["walk_steps"].numpy()
    assert steps.max() == st["rounds"] and steps.sum() == st["steps"]
    assert (steps[ks % m.sa_intv == 0] == 0).all()
    np.testing.assert_array_equal(
        np.array([m.sa_walk(int(k)) for k in ks], dtype=want.dtype), want)
    assert want[m.primary] == 0


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
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("wide", [False, True], ids=["i32", "i64"])
def test_kernels_match_plain_on_gpu(index, batch, wide, rows):
    """Each kernel equals its plain version on the card, on every output
    field, in exactly one launch a call: on the short reads (each block's
    rows staged in shared memory) and on the whole batch (rows read in
    place)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from mpibwa_tpu_torch.ops import fwd_cuda, sa_cuda, seeding
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex, _sa_lookup16

    dev = torch.device("cuda")
    fm = DeviceFMIndex(index["idx"], dev, force_wide=wide)
    case, _ = rows_case(batch, {}, rows)
    q, lens, starts, minv = (torch.from_numpy(a).to(dev) for a in case)
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
    # the edge indices 0, primary and seq_len once more, then every index
    ks = torch.from_numpy(np.concatenate([
        sa_indices(fm), np.array([0, fm.primary, fm.seq_len], fm.np_idt),
        np.arange(fm.seq_len + 1, dtype=fm.np_idt)])).to(dev)
    got = once(sa_cuda.sa_walk_kernel, fm, ks)
    want = _sa_lookup16(fm._o2, fm.L2, fm.primary, fm.seq_len, fm.sa,
                        fm.sa_intv, ks)
    assert torch.equal(got, want)
