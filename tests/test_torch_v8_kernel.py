"""Kernel 7, the v8 backward pass in one launch (mpibwa_tpu_torch/csrc/
bwd_v8.cu, wrapper ops/v8_cuda.py), on the CPU: a numpy model of the
kernel's persistent warps (warp_model: lanes in index order, one entry a
thread, several lanes to a warp, compaction of dead entries, lanes past
32 entries walked whole; every rank through the O2
table as csrc/o2.cuh takes it), run through the wrapper's own route
(inputs, per-entry outputs, the rows' compaction and pull), held exactly
to the port's torch v8 (ops/backward8.run_backward8, raw rows) and to the
JAX package's run_backward8, all six columns (both keep x[1] at its
forward value), at int32 and force_wide int64, on lanes that corner the
kernel and on real passes that the plain version compacts, and entry by
entry to the v8 rule run lane by lane (lane_reference); the placement of
the lanes; the wrapper on CPU tensors; the seeder's three v8
call sites with the model standing in for the kernel. Integers
throughout: every comparison is exact (tolerance 0). The kernel's rows
come lane after lane, the plain version's interleaved by its compactions:
the plain rows are compared sorted stably by lane (v8_cuda.lane_order).
Tests marked gpu hold the kernel itself to the plain version and to the
model on the card."""

import ctypes
import os
import re
import types

import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401
from mpibwa_tpu.core.opts import mem_opt_init
from mpibwa_tpu.index.format import load_index

torch.set_num_threads(1)  # test workers run in parallel on few cores

CPU = torch.device("cpu")
N_READS = 48
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mpibwa_tpu_torch", "csrc", "bwd_v8.cu")
U32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def toy_paths(tmp_path_factory):
    return toy.build_toy(str(tmp_path_factory.mktemp("toy")), n_pairs=100)


@pytest.fixture(scope="module")
def index(toy_paths):
    return load_index(toy_paths["ref"])


@pytest.fixture(scope="module")
def reads(toy_paths):
    half = N_READS // 2
    return [s.seq for s in toy.load_reads(toy_paths["r1"], limit=half)
            + toy.load_reads(toy_paths["r2"], limit=half)]


@pytest.fixture(scope="module", params=[False, True], ids=["i32", "i64"])
def fms(request, index):
    """(JAX DeviceFMIndex, torch DeviceFMIndex) for one position dtype."""
    from mpibwa_tpu.ops.fmd import DeviceFMIndex as JaxFM
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    return (JaxFM(index, force_wide=request.param),
            DeviceFMIndex(index, CPU, force_wide=request.param))


# -- the model of the kernel --------------------------------------------------

def _i32(x):
    """int64 values wrapped to int32 (two's complement)."""
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def _popc(m):
    m = m - ((m >> 1) & 0x55555555)
    m = (m & 0x33333333) + ((m >> 2) & 0x33333333)
    m = (m + (m >> 4)) & 0x0F0F0F0F
    return ((m * 0x01010101) & U32) >> 24


def _rank(fm, o2, pos, c):
    """o2.cuh rank_at(at(fm, pos), c) on int64 arrays: 0 at the sentinel
    (pos < 0); else row c of the sub-block of the stored offset (clamped
    into the table), its count plus the bases c in the packed word up to
    the offset, less the pad correction of base 0; int32."""
    sent = pos < 0
    k = np.where(sent, 0, pos)
    k = k - (k >= fm.primary)
    row = np.clip((k >> 4) * 4 + c, 0, len(o2) - 1)
    within = k & 15
    word = o2[row, 1].astype(np.int64) & U32
    w = word & (~((np.int64(1) << (30 - 2 * within)) - 1) & U32)
    nw = ~w & U32
    a = np.where(c & 2, w, nw) >> 1
    b = np.where(c & 1, w, nw)
    cnt = _popc(a & b & 0x55555555) - np.where(c == 0, 15 - within, 0)
    return np.where(sent, 0, _i32(o2[row, 0].astype(np.int64) + cnt))


def _extend(fm, o2, l2, wrap, qi, minv, k0, s):
    """The backward extension of entries at (k0, s) by bases qi: (k0, s)
    after it and whether each keeps (qi a base, the size at min_intv)."""
    c = np.minimum(qi, 3)
    kq = wrap(k0 - 1)
    tk = _rank(fm, o2, kq, c)
    s2 = _i32(_rank(fm, o2, wrap(kq + s), c) - tk)
    return wrap(l2[c] + 1 + tk), s2, (qi < 4) & (s2 >= minv)


def _setup(fm, inp):
    """The pass's arrays as numpy, int64 where they hold numbers."""
    q = inp.q.numpy()
    d = {"q": q, "L": q.shape[1],
         "off": inp.lane_off.numpy().astype(np.int64),
         "ik": inp.ik.numpy().astype(np.int64),
         "live": inp.live.numpy(),
         "x0": inp.x0.numpy().astype(np.int64),
         "minv": inp.minv.numpy().astype(np.int64),
         "o2": fm.o2_tables().numpy(),
         "l2": np.asarray(fm.l2_host[:4], np.int64),
         "wrap": _i32 if fm.np_idt == np.int32 else (lambda x: x)}
    d["base"] = lambda ln, i: np.where((i >= 0) & (i < d["L"]), q[
        ln, np.clip(i, 0, d["L"] - 1)], 4)
    d["ext"] = lambda qi, mv, k0, s: _extend(fm, d["o2"], d["l2"], d["wrap"],
                                             qi, mv, k0, s)
    return d


def lane_reference(fm, inp):
    """The v8 rule over every entry in a lane, all lanes in lockstep
    (one warp a lane, as the slotted kernel ran them): each round, from
    the state before it, an entry is first when it is live and it starts
    its lane or the entry before it is dead; live entries with a query
    base rank c at k0 - 1 and k0 - 1 + s; keepers take the extension and
    move to i - 1; a first live entry that is no keeper emits. Returns
    (k0, s, i, flags) of the entries in lanes and the most rounds a lane
    ran (a round of a lane that starts with a live entry)."""
    d = _setup(fm, inp)
    off = d["off"]
    n = off[1:] - off[:-1]
    U = int(off[-1])
    lane = np.repeat(np.arange(len(n)), n)
    bound = np.zeros(U, bool)
    bound[off[:-1][n > 0]] = True
    k0, s = d["ik"][:U, 0], _i32(d["ik"][:U, 2])
    i = _i32(d["x0"][lane] - 1)
    live, em = d["live"][:U].copy(), np.zeros(U, bool)
    rounds = np.zeros(len(n), np.int64)
    while live.any():
        rounds[np.unique(lane[live])] += 1
        first = live & (bound | ~np.r_[False, live[:-1]])
        qi = np.where(live, d["base"](lane, i), 4)
        k2, s2, keep = d["ext"](qi, d["minv"][lane], k0, s)
        keep &= live
        em |= first & ~keep
        k0, s = np.where(keep, k2, k0), np.where(keep, s2, s)
        i = np.where(keep, i - 1, i)
        live = keep
    return ({"k0": k0, "s": s, "i": i, "flags": live * 1 + em * 2},
            int(rounds.max(initial=0)))


_FIELDS = ("k0", "s", "i", "e", "ln", "mv", "born", "qi", "held", "live",
           "emitted", "head")


class _Warp:
    """A persistent warp of the kernel: its 32 threads' slots as arrays."""

    def __init__(self, wid):
        self.wid = wid
        for f in _FIELDS:
            setattr(self, f, np.zeros(32, bool if f in ("held", "live",
                                                        "emitted", "head")
                                      else np.int64))
        self.qi[:] = 4
        self.n_held = self.R = self.rmax = self.wr = 0
        self.pend = None


def warp_model(fm, inp, n_warps: int = 3):
    """The kernel's output for inputs inp (v8_cuda.V8Inputs), its warps'
    threads in lockstep, n_warps persistent warps taking turns (lanes are
    independent, so the turns change no output): (k0, s, i, flags, rounds,
    warp_rounds, placed) as numpy. Each warp takes the next lane in
    index order, up to the first lane that starts at the end of the last
    entry, into threads held .. held + n - 1 while they fit,
    after a compaction where that frees enough: the dead entries are
    written, a live entry whose entry below was dead becomes a head, and
    the live entries move down in order. A lane of more than 32 entries
    waits for an empty warp and runs there whole to its end, counting its
    chunks of 32 a round. A round of a warp: first =
    live and (head or the thread below dead); the next base at i - 1
    loaded; live entries with a base extend; keepers move to i - 1 and take
    that base; a first live non-keeper emits; a dying entry's lane ran
    round - born + 1 rounds. A warp ends when it holds nothing live and
    no lane is left, writing what it holds. placed lists (warp, lane,
    first thread, entries) of every lane a warp took, a whole warp (first
    thread 0) for a long lane; a lane with no entry is taken and placed
    nowhere."""
    d = _setup(fm, inp)
    off, ik, x0, minv = d["off"], d["ik"], d["x0"], d["minv"]
    base, ext = d["base"], d["ext"]
    E = len(ik)
    out = {k: np.zeros(E, np.int64) for k in ("k0", "s", "i", "flags")}
    placed, nxt = [], [0]

    def pop():
        nxt[0] += 1
        ln = nxt[0] - 1
        return ln if ln < len(x0) and off[ln] < off[-1] else None

    def write(e, k0, s, i, flags):
        for k, v in (("k0", k0), ("s", s), ("i", i), ("flags", flags)):
            out[k][e] = v

    def write_slot(w, t):
        write(w.e[t], w.k0[t], w.s[t], w.i[t], w.live[t] + 2 * w.emitted[t])

    def long_lane(w, ln):
        """Lane ln whole in the empty warp w, to its end."""
        es = np.arange(off[ln], off[ln + 1])
        k0, s = ik[es, 0], _i32(ik[es, 2])
        i = np.full(len(es), _i32(x0[ln] - 1))
        live, em = d["live"][es].copy(), np.zeros(len(es), bool)
        placed.append((w.wid, ln, 0, len(es)))
        r = 0
        while True:
            first = live & ~np.r_[False, live[:-1]]
            qi = np.where(live, base(ln, i), 4)
            k2, s2, keep = ext(qi, minv[ln], k0, s)
            keep &= live
            em |= first & ~keep
            k0, s = np.where(keep, k2, k0), np.where(keep, s2, s)
            i = np.where(keep, i - 1, i)
            live = keep
            r += 1
            w.wr += -(-len(es) // 32)
            write(es, k0, s, i, live + 2 * em)
            if not live.any():
                w.rmax = max(w.rmax, r)
                return

    def compact(w, live_below):
        for t in np.nonzero(w.held & ~w.live)[0]:
            write_slot(w, t)
        w.head |= w.live & ~live_below
        idx = np.nonzero(w.live)[0]
        for f in _FIELDS:
            v = getattr(w, f)
            v[: len(idx)] = v[idx].copy()
        for f in ("held", "live", "emitted", "head"):
            getattr(w, f)[len(idx):] = False
        w.n_held = len(idx)

    def step(w):
        """One turn: take lanes while they fit, then one round; False once
        the warp is done."""
        while w.pend is not None:
            ln = w.pend
            e0, n = off[ln], off[ln + 1] - off[ln]
            if w.n_held + n > 32:
                if w.live.sum() + min(n, 32) > 32:
                    break
                compact(w, np.r_[False, w.live[:-1]] | w.head)
            if n > 32:
                long_lane(w, ln)
            else:
                t = w.n_held + np.arange(n)
                e = e0 + np.arange(n)
                w.e[t], w.ln[t], w.mv[t], w.born[t] = e, ln, minv[ln], w.R
                w.k0[t], w.s[t] = ik[e, 0], _i32(ik[e, 2])
                w.i[t] = _i32(x0[ln] - 1)
                lv = d["live"][e]
                w.held[t], w.live[t], w.emitted[t] = True, lv, False
                w.head[t] = np.arange(n) == 0
                w.qi[t] = np.where(lv, base(ln, w.i[t]), 4)
                if n:
                    placed.append((w.wid, ln, w.n_held, n))
                w.n_held += n
            w.pend = pop()
        if not w.live.any():
            for t in np.nonzero(w.held)[0]:
                write_slot(w, t)
            return False
        live = w.live.copy()
        first = live & (w.head | ~np.r_[live[0], live[:-1]])
        qn = base(w.ln, w.i - 1)
        k2, s2, keep = ext(np.where(live, w.qi, 4), w.mv, w.k0, w.s)
        keep &= live
        die = live & ~keep
        w.k0, w.s = np.where(keep, k2, w.k0), np.where(keep, s2, w.s)
        w.i, w.qi = np.where(keep, w.i - 1, w.i), np.where(keep, qn, w.qi)
        w.live = keep
        w.emitted |= die & first
        if die.any():
            w.rmax = max(w.rmax, int((w.R - w.born[die] + 1).max()))
        w.R += 1
        return True

    warps = [_Warp(k) for k in range(n_warps)]
    for w in warps:
        w.pend = pop()
    active = list(warps)
    while active:
        active = [w for w in active if step(w)]
    out["rounds"] = max(w.rmax for w in warps)
    out["warp_rounds"] = sum(w.R + w.wr for w in warps)
    out["placed"] = placed
    return out


def model_launch(fm, inp, out):
    """A launch function for v8_cuda.v8_rows: the model fills out."""
    got = warp_model(fm, inp)
    for name in ("k0", "s", "i", "flags"):
        t = getattr(out, name)
        t.copy_(torch.from_numpy(got[name]).to(t.dtype))
    out.ctl.copy_(torch.tensor([got["rounds"], 0, 0, got["warp_rounds"]],
                               dtype=torch.int32))


# -- inputs -------------------------------------------------------------------

def _entries(packed, tfm):
    """pack_bwd_lanes' arrays as run_backward8's entries (torch)."""
    return (torch.from_numpy(packed["ik"].astype(tfm.np_idt)),
            torch.from_numpy(packed["info"]),
            torch.from_numpy(packed["lane"].astype(np.int64)),
            torch.from_numpy(packed["live"]))


def _edge_pass(tfm):
    """tests/_torch_toy.bwd_edge_lanes plus a lane whose entries all fail
    in round 1 (min_intv past any size), E a multiple of 8 (the JAX
    engine's layout)."""
    return toy.pack_bwd_lanes(_edge_lanes(tfm), multiple=8)


def _edge_lanes(tfm):
    lanes = toy.bwd_edge_lanes(tfm, 7)
    real = next(ln for ln in lanes if ln["name"] == "real_0")
    lanes.append(dict(real, name="all_fail_round_1", minv=2**30))
    return lanes


def _corner_pass(tfm):
    """The edge lanes and lanes that corner the packed layout: 40 lanes of
    one entry each (a warp of lanes), lanes of 31, 32, 33, 128, 129 and 193
    entries, 31 entries with every other one dead, runs of four equal
    intervals over a whole warp, calls from the last base of the row and
    from past it (row ends), zero-length lanes among them, and zero-length
    lanes padding the lane count to a power of two (as the seeder pads
    it); E a multiple of 8."""
    lanes = _edge_lanes(tfm)
    base = next(ln for ln in lanes if ln["name"] == "real_0")
    wide = next(ln for ln in lanes if ln["name"].startswith(
        f"real_{toy.BWD_LONG_READ}bp"))

    def take(lane, idx, name, **kw):
        d = {k: lane[k][np.asarray(idx, np.int64)] for k in ("ik", "info",
                                                             "live")}
        return dict(lane, **d, name=name, **kw)

    m = len(base["ik"])
    out = list(lanes)
    out += [take(base, [j % m], f"one_entry_{j}") for j in range(40)]
    for n in (31, 32, 33, 128, 129, 193):
        out.append(take(wide, np.arange(n) % len(wide["ik"]), f"len_{n}"))
        out.append(take(base, [], "zero_length"))
    alt = take(base, np.arange(31) % m, "len_31_every_other_dead")
    alt["live"] = np.arange(31) % 2 == 0
    out.append(alt)
    out.append(take(base, np.repeat(np.arange(8) % m, 4), "runs_of_four"))
    L = max(len(ln["q"]) for ln in out)
    for x0 in (L, L + 1):
        out.append(take(wide, np.arange(len(wide["ik"])), f"x0_{x0}",
                        x0=x0))
    nl = 1 << (len(out) - 1).bit_length()
    out += [take(base, [], "padding", x0=0)] * (nl - len(out))
    return toy.pack_bwd_lanes(out, multiple=8)


def _real_pass(tfm, reads, starts=None, seed=3):
    """A v8 pass as the seeder builds it: pass 1's chained calls (or one
    call from each of starts, with min_intv 1-3 a lane) of reads."""
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.ops import seeding as TS
    from mpibwa_tpu_torch.ops import seeding_flat as TSF
    from mpibwa_tpu_torch.pipeline import device_seed as DS

    q, lens = DS._pad_batch(reads)
    B = len(q)
    fwd = TS.forward_pass(
        tfm, torch.from_numpy(q), torch.from_numpy(lens),
        torch.ones(B, dtype=torch.int64), chain=starts is None,
        starts=None if starts is None else torch.from_numpy(starts))
    rng = np.random.default_rng(seed)
    arr = np.array([(b, int(fwd.call_start[b, c]), int(fwd.call_len[b, c]),
                     int(fwd.call_x[b, c]),
                     1 if starts is None else int(rng.integers(1, 4)))
                    for b in range(B) for c in range(int(fwd.n_calls[b]))
                    if not fwd.overflow[b]], np.int64)
    NL = DS._v8_lanes(len(arr))
    lane_row, lane_tbl, x0, minv, e = DS._lane_tables(arr, NL)
    entries = TSF.assemble_entries(fwd.ivals, fwd.infos,
                                   torch.from_numpy(lane_row),
                                   torch.from_numpy(lane_tbl),
                                   TB8.cap_bucket(e, 1024))
    return torch.from_numpy(q[lane_row]), entries, NL, x0, minv


def _model_rows(tfm, qrows, entries, NL, x0, minv, min_len, est,
                stats=None, raw=True):
    from mpibwa_tpu_torch.ops import v8_cuda as V

    return V.v8_rows(tfm, qrows, entries, NL, x0, minv, min_len, raw, est,
                     None, stats, model_launch)


def _held_to_lanes(tfm, qrows, entries, NL, x0, minv):
    """The model's per-entry outputs on a pass == lane_reference's on
    every entry in a lane (all four arrays), and its rounds the most any
    lane ran."""
    from mpibwa_tpu_torch.ops import v8_cuda as V

    inp = V.v8_inputs(tfm, qrows, entries, NL, x0, minv)
    got = warp_model(tfm, inp)
    want, rounds = lane_reference(tfm, inp)
    U = int(inp.lane_off[-1])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k][:U], v, err_msg=k)
    assert got["rounds"] == rounds
    return got


# -- the model against both v8 engines ---------------------------------------

def _against_both(fms, p, min_len, est=1024):
    """The model's rows on packed lanes p == the port's run_backward8 ==
    the JAX run_backward8 (all six columns, the index dtype), and its
    per-entry outputs == lane_reference's; returns (rows, stats)."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops import backward8 as JB8
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.ops import v8_cuda as V

    jfm, tfm = fms
    entries = _entries(p, tfm)
    q = torch.from_numpy(p["q"])
    stats = {}
    got, ov = _model_rows(tfm, q, entries, p["NL"], p["x0"], p["minv"],
                          min_len, est, stats)
    plain, pov = TB8.run_backward8(tfm, q, entries, p["NL"], p["x0"],
                                   p["minv"], min_len=min_len, raw=True,
                                   est_rows=est)
    want, jov = JB8.run_backward8(
        jfm, jnp.asarray(p["q"]), tuple(jnp.asarray(t.numpy())
                                        for t in entries),
        p["NL"], p["x0"], p["minv"], min_len=min_len, raw=True,
        est_rows=est, _force_adaptive=True)
    assert ov is pov is jov is False
    assert got.dtype == plain.dtype == tfm.np_idt
    np.testing.assert_array_equal(got, V.lane_order(plain))
    np.testing.assert_array_equal(got, V.lane_order(np.asarray(want)))
    _held_to_lanes(tfm, q, entries, p["NL"], p["x0"], p["minv"])
    return got, stats


@pytest.mark.parametrize("min_len", [0, 19])
def test_model_matches_plain_and_jax_on_edge_lanes(fms, min_len):
    """The edge lanes (zero-length lanes, lanes of 300 entries, walked in
    chunks, a dead head, every entry failing in round 1, calls at i = 0
    and -1, N at the next base, intervals around primary, random live
    masks, min_intv > 1): the model's rows == the port's run_backward8 ==
    the JAX run_backward8 (all six columns, the index dtype), its
    per-entry outputs == lane_reference's."""
    _, tfm = fms
    p = _edge_pass(tfm)
    n = np.diff(p["lane_off"])
    assert n.max() > 256 and (n == 0).any()
    got, stats = _against_both(fms, p, min_len)
    assert len(got) > 20
    assert stats["bwd_segments"] == 1
    assert stats["bwd_rounds"] > toy.BWD_LONG_READ // 2  # the long lanes


@pytest.mark.parametrize("min_len", [0, 19])
def test_model_matches_plain_and_jax_on_corner_lanes(fms, min_len):
    """The corner lanes of the packed layout (_corner_pass: a warp of
    one-entry lanes, lanes of 31-33, 128, 129 and 193 entries, dead
    entries among live ones, runs of equal intervals, row ends, empty and
    padding lanes): the model's rows == both packages' v8, per-entry
    outputs == lane_reference's; its warps took every lane of more than
    32 entries whole and held several lanes at once."""
    from mpibwa_tpu_torch.ops import v8_cuda as V

    _, tfm = fms
    p = _corner_pass(tfm)
    n = np.diff(p["lane_off"])
    for m in (1, 31, 32, 33, 128, 129, 193):
        assert (n == m).any()
    assert n[-1] == 0 and p["NL"] & (p["NL"] - 1) == 0
    got, stats = _against_both(fms, p, min_len)
    assert len(got) > 40
    inp = V.v8_inputs(tfm, torch.from_numpy(p["q"]), _entries(p, tfm),
                      p["NL"], p["x0"], p["minv"])
    placed = warp_model(tfm, inp)["placed"]
    assert {ln for _, ln, t0, m in placed if m > 32 and t0 == 0} == set(
        np.nonzero(n > 32)[0].tolist())
    per_warp = {}
    for w, ln, t0, m in placed:
        per_warp.setdefault((w, t0), []).append(ln)
    assert max(t0 for _, t0 in per_warp) > 16  # lanes side by side


def test_packing_covers_every_entry_once(fms, reads):
    """The model's placement of the lanes (the offsets from v8_inputs,
    torch on the CPU): each lane with an entry is placed once and no empty
    lane (the padding lanes start at the end of the last entry, where the
    warps stop taking lanes); every lane placed lies whole in one warp's
    threads (a run of consecutive threads, or a whole warp past 32
    entries), and every entry of a lane with entries is covered once, on
    the corner lanes and a real pass."""
    from mpibwa_tpu_torch.ops import v8_cuda as V

    _, tfm = fms
    p = _corner_pass(tfm)
    cases = [(torch.from_numpy(p["q"]), _entries(p, tfm), p["NL"], p["x0"],
              p["minv"]), _real_pass(tfm, reads)]
    for qrows, entries, NL, x0, minv in cases:
        inp = V.v8_inputs(tfm, qrows, entries, NL, x0, minv)
        off = inp.lane_off.numpy().astype(np.int64)
        n = off[1:] - off[:-1]
        last = int(np.nonzero(n)[0][-1])
        assert (off[last + 1:] == off[-1]).all() and last + 1 < NL
        placed = warp_model(tfm, inp)["placed"]
        assert sorted(ln for _, ln, _, _ in placed) == np.nonzero(
            n)[0].tolist()
        covered = np.zeros(int(off[-1]), np.int64)
        for _, ln, t0, m in placed:
            assert m == n[ln] > 0
            assert (t0 == 0 if m > 32 else t0 + m <= 32)
            covered[off[ln]: off[ln] + m] += 1
        assert (covered == 1).all()


def test_model_matches_plain_after_compactions(fms, reads, monkeypatch):
    """Real passes (pass 1's chained calls; one call a lane from random
    starts with min_intv 1-3, as pass 2 has them) with MIN_CAP 64, so the
    plain version compacts several times: the model's rows == the plain
    rows at min_len 0 and 19, in one pull or two; its per-entry outputs ==
    lane_reference's."""
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.ops import v8_cuda as V

    _, tfm = fms
    monkeypatch.setattr(TB8, "MIN_CAP", 64)
    rng = np.random.default_rng(11)
    starts = rng.integers(20, 90, len(reads)).astype(np.int32)
    for st in (None, starts):
        qrows, entries, NL, x0, minv = _real_pass(tfm, reads, st)
        _held_to_lanes(tfm, qrows, entries, NL, x0, minv)
        for min_len in (0, 19):
            stats = {}
            plain, _ = TB8.run_backward8(tfm, qrows, entries, NL, x0, minv,
                                         min_len=min_len, raw=True,
                                         est_rows=NL, stats=stats)
            assert stats["bwd_segments"] > 2  # segments and compactions
            E = len(entries[0])
            for est in (E, 1):
                mstats = {}
                got, ov = _model_rows(tfm, qrows, entries, NL, x0, minv,
                                      min_len, est, mstats)
                assert ov is False
                np.testing.assert_array_equal(got, V.lane_order(plain))
                assert mstats["bwd_segments"] == (1 if est == E else 2)
            assert len(plain) > (N_READS // 4 if min_len else N_READS)


def test_model_lists_and_extra_overflow(fms, reads):
    """The route's list mode gives the plain version's per-lane lists; a
    raised extra_ov gives no rows and every lane flagged, as the plain
    version reports it."""
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.ops import v8_cuda as V

    _, tfm = fms
    qrows, entries, NL, x0, minv = _real_pass(tfm, reads)
    got = _model_rows(tfm, qrows, entries, NL, x0, minv, 19, 64, raw=False)
    want = TB8.run_backward8(tfm, qrows, entries, NL, x0, minv, min_len=19)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    ov = torch.ones((), dtype=torch.bool)
    for raw in (True, False):
        got = V.v8_rows(tfm, qrows, entries, NL, x0, minv, 19, raw, 64, ov,
                        None, model_launch)
        want = TB8.run_backward8(tfm, qrows, entries, NL, x0, minv,
                                 min_len=19, raw=raw, est_rows=64,
                                 extra_ov=ov)
        if raw:
            assert got[1] is want[1] is True and len(got[0]) == 0
        else:
            assert got[0] == want[0] and got[1].all() and want[1].all()


# -- the wrapper ------------------------------------------------------------

def test_wrapper_on_cpu_is_the_plain_version(fms, reads):
    """On CPU tensors v8_pass_kernel is run_backward8 itself (same rows in
    the same order, same lists) and launches nothing."""
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.ops import v8_cuda as V

    _, tfm = fms
    qrows, entries, NL, x0, minv = _real_pass(tfm, reads)
    n0 = V.v8_pass_kernel.launches
    for raw in (True, False):
        got = V.v8_pass_kernel(tfm, qrows, entries, NL, x0, minv,
                               min_len=19, raw=raw, est_rows=64,
                               max_len=128)
        want = TB8.run_backward8(tfm, qrows, entries, NL, x0, minv,
                                 min_len=19, raw=raw, est_rows=64)
        if raw:
            np.testing.assert_array_equal(got[0], want[0])
        else:
            assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    assert V.v8_pass_kernel.launches == n0


def test_inputs_are_checked(index, reads):
    """v8_inputs refuses what the kernel does not take: entries on another
    device than the index, a live mask that is not bool, qrows of another
    lane count; its offsets end at the pass's last live entry, so the
    lanes that pad the pass start there."""
    from mpibwa_tpu_torch.ops import v8_cuda as V
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    tfm = DeviceFMIndex(index, CPU, force_wide=True)
    qrows, entries, NL, x0, minv = _real_pass(tfm, reads)
    inp = V.v8_inputs(tfm, qrows, entries, NL, x0, minv)
    assert inp.ik.dtype == torch.int64 and inp.lane_off.dtype == torch.int32
    last = int(np.nonzero(entries[3].numpy())[0][-1])
    assert inp.lane_off[0] == 0 and inp.lane_off[-1] == last + 1
    assert last + 1 < len(entries[0])  # the padding is not walked
    n = inp.lane_off[1:] - inp.lane_off[:-1]
    pad = int(entries[2][last]) + 1  # the lanes after the last entry's
    assert pad < NL and not n[pad:].any()
    assert (inp.lane_off[pad:] == last + 1).all()
    with pytest.raises(TypeError):
        V.v8_inputs(tfm, qrows, entries[:3] + (entries[3].to(torch.uint8),),
                    NL, x0, minv)
    with pytest.raises(TypeError):
        V.v8_inputs(tfm, qrows[:-1], entries, NL, x0, minv)
    with pytest.raises(ValueError):
        V.v8_inputs(tfm, qrows.to("meta"), tuple(t.to("meta")
                                                 for t in entries),
                    NL, x0, minv)


def test_entry_point_matches_the_source():
    """The wrapper's ctypes argument list is the C entry point's, argument
    for argument (int, long long or a pointer), with the stream last, and
    the source's control words are the four the wrapper allocates."""
    from mpibwa_tpu_torch.ops import v8_cuda as V

    with open(SRC) as fh:
        src = fh.read()
    sig = re.search(r'extern "C" int mpibwa_bwd_v8\(([^)]*)\)', src).group(1)
    kinds = [ctypes.c_void_p if "*" in arg else ctypes.c_longlong
             if "long long" in arg else ctypes.c_int
             for arg in sig.split(",")]
    assert kinds == V.ENTRY[2]
    assert "int* ctl" in sig
    out = V.v8_outputs(types.SimpleNamespace(idt=torch.int32), 8, CPU)
    assert out.ctl.shape == (4,) and not out.ctl.any()


# -- the seeder's call sites, the model standing in ---------------------------

def test_seeder_v8_call_sites_through_the_kernel_route(index, reads,
                                                       monkeypatch):
    """Under MPIBWA_BWD=v8 every backward pass of collect_batch, of
    collect_flat's synchronous route and of its speculative pass 2 goes
    through v8_cuda.v8_pass_kernel; with the model standing in for the
    kernel (the kernel's route on CPU tensors) each gives the plain
    version's results exactly, and the speculative pass 2 the synchronous
    route's rows."""
    from mpibwa_tpu_torch.ops import v8_cuda as V
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    tfm = DeviceFMIndex(index, CPU, force_wide=True)
    monkeypatch.setenv("MPIBWA_BWD", "v8")
    opt = mem_opt_init()
    plain = DeviceSeeder(tfm, opt)
    want_b = plain.collect_batch(reads)
    want_f = plain.collect_flat(reads)
    calls = []

    def stand_in(fm, qrows, entry, n_lanes, x0, minv, min_len=0, raw=False,
                 est_rows=0, extra_ov=None, stats=None, max_len=None):
        calls.append((raw, extra_ov is not None))
        return V.v8_rows(fm, qrows, entry, n_lanes, x0, minv, min_len, raw,
                         est_rows, extra_ov, stats, model_launch)

    monkeypatch.setattr(V, "v8_pass_kernel", stand_in)
    seeder = DeviceSeeder(tfm, opt)
    got_b = seeder.collect_batch(reads)
    assert calls == [(False, False)] * 2  # pass 1 and pass 2
    assert got_b[0] == want_b[0]
    np.testing.assert_array_equal(got_b[1], want_b[1])
    calls.clear()
    sync = seeder.collect_flat(reads)
    spec = seeder.collect_flat(reads)
    assert calls == [(True, False)] * 3 + [(True, True)]
    assert seeder.times["p2_spec"] == 1 and "p2_redo" not in seeder.times
    for g, s_, w in zip(spec, sync, want_f):
        np.testing.assert_array_equal(s_, w)
        np.testing.assert_array_equal(g, w)
    assert seeder.times["bwd_rounds"] > 0
    assert len(want_f[0]) > N_READS


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True], ids=["i32", "i64"])
def test_kernel_on_gpu_matches_plain(index, reads, wide):
    """The kernel on the card == the plain version on the card (rows in
    lane order) on the edge lanes, the corner lanes and a real pass,
    min_len 0 and 19, one launch each; its per-entry outputs == the
    model's on every entry in a lane."""
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.ops import v8_cuda as V
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    dev = _card()
    cpu_fm = DeviceFMIndex(index, CPU, force_wide=wide)
    fm = DeviceFMIndex(index, dev, force_wide=wide)
    cases = [(torch.from_numpy(p["q"]), _entries(p, cpu_fm), p["NL"],
              p["x0"], p["minv"])
             for p in (_edge_pass(cpu_fm), _corner_pass(cpu_fm))]
    cases.append(_real_pass(cpu_fm, reads))
    for qrows, entries, NL, x0, minv in cases:
        qd, ed = qrows.to(dev), tuple(t.to(dev) for t in entries)
        for min_len in (0, 19):
            n0 = V.v8_pass_kernel.launches
            got, ov = V.v8_pass_kernel(fm, qd, ed, NL, x0, minv,
                                       min_len=min_len, raw=True,
                                       est_rows=64)
            assert V.v8_pass_kernel.launches == n0 + 1
            want, pov = TB8.run_backward8(fm, qd, ed, NL, x0, minv,
                                          min_len=min_len, raw=True,
                                          est_rows=64)
            assert ov is pov is False
            np.testing.assert_array_equal(got, V.lane_order(want))
        inp = V.v8_inputs(fm, qd, ed, NL, x0, minv)
        out = V.v8_outputs(fm, ed[0].shape[0], dev)
        for _ in range(2):  # the lane counters are 0 again after each
            assert V.v8_launch(fm, inp, out) == 0
            torch.cuda.synchronize()
            assert out.ctl[1] == out.ctl[2] == 0
            want = warp_model(cpu_fm, V.v8_inputs(cpu_fm, qrows, entries, NL,
                                                  x0, minv))
            U = int(inp.lane_off[-1])
            for k in ("k0", "s", "i", "flags"):
                np.testing.assert_array_equal(
                    getattr(out, k)[:U].cpu().numpy().astype(np.int64),
                    want[k][:U], err_msg=k)
            assert int(out.ctl[0]) == want["rounds"]
