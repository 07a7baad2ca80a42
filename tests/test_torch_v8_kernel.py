"""Kernel 7, the v8 backward pass in one launch (mpibwa_tpu_torch/csrc/
bwd_v8.cu, wrapper ops/v8_cuda.py), on the CPU: a numpy model of the
kernel's warps (one warp a lane; entry j in thread j % 32, slot j / 32; the
first live entry from the thread below or the slot carry; every rank
through the O2 table as csrc/o2.cuh takes it), run through the wrapper's
own route (inputs, per-entry outputs, the rows' compaction and pull),
held exactly to the port's torch v8 (ops/backward8.run_backward8, raw
rows) and to the JAX package's run_backward8, all six columns (both keep
x[1] at its forward value), at int32 and force_wide int64, on lanes that
corner the kernel and on real passes that the plain version compacts; the
wrapper on CPU tensors; the seeder's three v8 call sites with the model
standing in for the kernel. Integers throughout: every comparison is
exact (tolerance 0). The kernel's rows come lane after lane, the plain
version's interleaved by its compactions: the plain rows are compared
sorted stably by lane (v8_cuda.lane_order). Tests marked gpu hold the
kernel itself to the plain version on the card."""

import ctypes
import os
import re

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


def warp_model(fm, inp):
    """The kernel's output for inputs inp (v8_cuda.V8Inputs), every warp
    in lockstep (a warp with no live entry changes nothing, so lockstep
    changes no output): (k0, s, i, flags, rounds) as numpy. Warp ln holds
    lane ln's entry j in thread j % 32 of slot j // 32 (registers or a
    chunk: the carry between slots is the same); per round, from the state
    before it, an entry is first when it is live and the entry before it
    (the thread below, or thread 31 of the slot before; none at the lane's
    first entry) is not; live entries with a query base rank c at k0 - 1
    and k0 - 1 + s; keepers take the extension and move to i - 1; a first
    live entry that is no keeper emits; a warp stops when none of its
    entries is live, or after L + 2 rounds."""
    wrap = _i32 if fm.np_idt == np.int32 else (lambda x: x)
    q = inp.q.numpy()
    NL, L = q.shape
    off = inp.lane_off.numpy().astype(np.int64)
    ik = inp.ik.numpy().astype(np.int64)
    E = len(ik)
    o2 = fm.o2_tables().numpy()
    l2 = np.asarray(fm.l2_host[:4], np.int64)
    n = off[1:] - off[:-1]
    NS = max(1, -(-int(n.max(initial=0)) // 32))
    j = np.arange(NS * 32)
    has = j[None, :] < n[:, None]
    e = np.where(has, off[:-1, None] + j[None, :], 0)
    k0 = np.where(has, ik[e, 0], 0)
    s = np.where(has, _i32(ik[e, 2]), 0)
    i = np.broadcast_to(_i32(inp.x0.numpy().astype(np.int64) - 1)[:, None],
                        has.shape).copy()
    live = has & inp.live.numpy()[e]
    emitted = np.zeros_like(live)
    minv = inp.minv.numpy().astype(np.int64)[:, None]
    rows = np.arange(NL)[:, None]
    rounds = np.zeros(NL, np.int64)
    act = live.any(axis=1)
    while act.any():
        lv = live.reshape(NL, NS, 32)
        before = np.zeros_like(lv)
        before[:, :, 1:] = lv[:, :, :-1]  # __shfl_up_sync
        before[:, 1:, 0] = lv[:, :-1, 31]  # the carry of the slot before
        first = (lv & ~before).reshape(NL, NS * 32)
        qi = np.where((i >= 0) & (i < L), q[rows, np.clip(i, 0, L - 1)], 4)
        c = np.minimum(qi, 3)
        kq = wrap(k0 - 1)
        tk = _rank(fm, o2, kq, c)
        tl = _rank(fm, o2, wrap(kq + s), c)
        s2 = _i32(tl - tk)
        keeper = act[:, None] & live & (qi < 4) & (s2 >= minv)
        emitted |= act[:, None] & live & first & ~keeper
        k0 = np.where(keeper, wrap(l2[c] + 1 + tk), k0)
        s = np.where(keeper, s2, s)
        i = np.where(keeper, _i32(i - 1), i)
        live = np.where(act[:, None], keeper, live)
        rounds += act
        act = act & live.any(axis=1) & (rounds < L + 2)
    out = {}
    for name, v in (("k0", k0), ("s", s), ("i", i),
                    ("flags", live * 1 + emitted * 2)):
        flat = np.zeros(E, np.int64)
        flat[e[has]] = v[has]
        out[name] = flat
    out["rounds"] = int(rounds.max(initial=0))
    return out


def model_launch(fm, inp, out):
    """A launch function for v8_cuda.v8_rows: the model fills out."""
    got = warp_model(fm, inp)
    for name in ("k0", "s", "i", "flags"):
        t = getattr(out, name)
        t.copy_(torch.from_numpy(got[name]).to(t.dtype))
    out.rounds.fill_(got["rounds"])


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
    lanes = toy.bwd_edge_lanes(tfm, 7)
    real = next(ln for ln in lanes if ln["name"] == "real_0")
    lanes.append(dict(real, name="all_fail_round_1", minv=2**30))
    return toy.pack_bwd_lanes(lanes, multiple=8)


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
    return (torch.from_numpy(q[lane_row]), entries, NL, x0, minv,
            int(arr[:, 2].max()))


def _model_rows(tfm, qrows, entries, NL, x0, minv, min_len, est, max_len,
                stats=None, raw=True):
    from mpibwa_tpu_torch.ops import v8_cuda as V

    return V.v8_rows(tfm, qrows, entries, NL, x0, minv, min_len, raw, est,
                     None, stats, max_len, model_launch)


# -- the model against both v8 engines ---------------------------------------

@pytest.mark.parametrize("min_len", [0, 19])
def test_model_matches_plain_and_jax_on_edge_lanes(fms, min_len):
    """The edge lanes (zero-length lanes, lanes of 300 entries past the
    register instances, a dead head, every entry failing in round 1, calls
    at i = 0 and -1, N at the next base, intervals around primary, random
    live masks, min_intv > 1): the model's rows == the port's run_backward8
    == the JAX run_backward8 (all six columns, the index dtype)."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops import backward8 as JB8
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.ops import v8_cuda as V

    jfm, tfm = fms
    p = _edge_pass(tfm)
    entries = _entries(p, tfm)
    q = torch.from_numpy(p["q"])
    n = np.diff(p["lane_off"])
    assert n.max() > 32 * V.SLOTS[-1] and (n == 0).any()
    stats = {}
    got, ov = _model_rows(tfm, q, entries, p["NL"], p["x0"], p["minv"],
                          min_len, 1024, int(n.max()), stats)
    plain, pov = TB8.run_backward8(tfm, q, entries, p["NL"], p["x0"],
                                   p["minv"], min_len=min_len, raw=True,
                                   est_rows=1024)
    want, jov = JB8.run_backward8(
        jfm, jnp.asarray(p["q"]), tuple(jnp.asarray(t.numpy())
                                        for t in entries),
        p["NL"], p["x0"], p["minv"], min_len=min_len, raw=True,
        est_rows=1024, _force_adaptive=True)
    assert ov is pov is jov is False
    assert got.dtype == plain.dtype == tfm.np_idt
    np.testing.assert_array_equal(got, V.lane_order(plain))
    np.testing.assert_array_equal(got, V.lane_order(np.asarray(want)))
    assert len(got) > 20
    assert stats["bwd_segments"] == 1
    assert stats["bwd_rounds"] > toy.BWD_LONG_READ // 2  # the long lanes


def test_model_matches_plain_after_compactions(fms, reads, monkeypatch):
    """Real passes (pass 1's chained calls; one call a lane from random
    starts with min_intv 1-3, as pass 2 has them) with MIN_CAP 64, so the
    plain version compacts several times: the model's rows == the plain
    rows at min_len 0 and 19, in one pull or two."""
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.ops import v8_cuda as V

    _, tfm = fms
    monkeypatch.setattr(TB8, "MIN_CAP", 64)
    rng = np.random.default_rng(11)
    starts = rng.integers(20, 90, len(reads)).astype(np.int32)
    for st in (None, starts):
        qrows, entries, NL, x0, minv, max_len = _real_pass(tfm, reads, st)
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
                                      min_len, est, max_len, mstats)
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
    qrows, entries, NL, x0, minv, max_len = _real_pass(tfm, reads)
    got = _model_rows(tfm, qrows, entries, NL, x0, minv, 19, 64, max_len,
                      raw=False)
    want = TB8.run_backward8(tfm, qrows, entries, NL, x0, minv, min_len=19)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    ov = torch.ones((), dtype=torch.bool)
    for raw in (True, False):
        got = V.v8_rows(tfm, qrows, entries, NL, x0, minv, 19, raw, 64, ov,
                        None, max_len, model_launch)
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
    qrows, entries, NL, x0, minv, max_len = _real_pass(tfm, reads)
    n0 = V.v8_pass_kernel.launches
    for raw in (True, False):
        got = V.v8_pass_kernel(tfm, qrows, entries, NL, x0, minv,
                               min_len=19, raw=raw, est_rows=64,
                               max_len=max_len)
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
    lane count; it picks the fewest slots of 32 of its instances
    (SLOTS) that hold max_len."""
    from mpibwa_tpu_torch.ops import v8_cuda as V
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    tfm = DeviceFMIndex(index, CPU, force_wide=True)
    qrows, entries, NL, x0, minv, _ = _real_pass(tfm, reads)
    inp = V.v8_inputs(tfm, qrows, entries, NL, x0, minv, 70)
    assert inp.slots == 4 and inp.ik.dtype == torch.int64
    last = int(np.nonzero(entries[3].numpy())[0][-1])
    assert inp.lane_off[0] == 0 and inp.lane_off[-1] == last + 1
    assert last + 1 < len(entries[0])  # the padding is not walked
    assert [V.slot_count(m, V.SLOTS) for m in (0, 128, 129, 10**6)] == \
        [4, 4, 8, 8]
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
    the register instances are the source's."""
    from mpibwa_tpu_torch.ops import v8_cuda as V

    with open(SRC) as fh:
        src = fh.read()
    sig = re.search(r'extern "C" int mpibwa_bwd_v8\(([^)]*)\)', src).group(1)
    kinds = [ctypes.c_void_p if "*" in arg else ctypes.c_longlong
             if "long long" in arg else ctypes.c_int
             for arg in sig.split(",")]
    assert kinds == V.ENTRY[2]
    cases = sorted(int(c) for c in re.findall(r"case (\d+): return launch<",
                                              src))
    assert tuple(cases) == V.SLOTS


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
                         est_rows, extra_ov, stats, max_len, model_launch)

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
    lane order) on the edge lanes and a real pass, min_len 0 and 19, one
    launch each."""
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.ops import v8_cuda as V
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    dev = _card()
    cpu_fm = DeviceFMIndex(index, CPU, force_wide=wide)
    fm = DeviceFMIndex(index, dev, force_wide=wide)
    p = _edge_pass(cpu_fm)
    cases = [(torch.from_numpy(p["q"]), _entries(p, cpu_fm), p["NL"],
              p["x0"], p["minv"], int(np.diff(p["lane_off"]).max())),
             _real_pass(cpu_fm, reads)]
    for qrows, entries, NL, x0, minv, max_len in cases:
        qd, ed = qrows.to(dev), tuple(t.to(dev) for t in entries)
        for min_len in (0, 19):
            n0 = V.v8_pass_kernel.launches
            got, ov = V.v8_pass_kernel(fm, qd, ed, NL, x0, minv,
                                       min_len=min_len, raw=True,
                                       est_rows=64, max_len=max_len)
            assert V.v8_pass_kernel.launches == n0 + 1
            want, pov = TB8.run_backward8(fm, qd, ed, NL, x0, minv,
                                          min_len=min_len, raw=True,
                                          est_rows=64)
            assert ov is pov is False
            np.testing.assert_array_equal(got, V.lane_order(want))
