"""The port's backward pass in one launch (mpibwa_tpu_torch/ops/bwd_cuda.py)
vs the JAX package on reads simulated from the toy genome: the plain round
``bwd_round`` against the Pallas kernel ``pallas_bwd._round_call`` in
interpret mode, round by round; the plain pass ``bwd_pass`` against
``pallas_bwd.run_backward_pallas`` in interpret mode on the toy entries and
on the edge lanes of ``tests/_torch_toy.bwd_edge_lanes``; a numpy model of
the kernel's warp (csrc/bwd_pass.cu) against ``bwd_pass`` on every edge
lane at every slot count; seeds under MPIBWA_BWD=pallas against
mpibwa_tpu's pallas_interp, the port's flat engine and the scalar engine;
the engine MPIBWA_BWD=auto picks; and `cli mem` under each engine.
Integers throughout: every comparison is exact (tolerance 0). The CUDA
kernel itself runs only on a card (the test marked ``gpu``)."""

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
N_READS = 64


@pytest.fixture(scope="module")
def toy_paths(tmp_path_factory):
    return toy.build_toy(str(tmp_path_factory.mktemp("toy")), n_pairs=200)


@pytest.fixture(scope="module")
def index(toy_paths):
    return load_index(toy_paths["ref"])


@pytest.fixture(scope="module")
def fms(index):
    from mpibwa_tpu.ops.fmd import DeviceFMIndex as JaxFM
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    jfm = JaxFM(index)
    # lazy tables: touched on the host before any jitted call
    jfm.occ, jfm.data
    return jfm, DeviceFMIndex(index, CPU)


@pytest.fixture(scope="module")
def reads(toy_paths):
    return [s.seq for s in toy.load_reads(toy_paths["r1"], limit=N_READS)]


@pytest.fixture(scope="module")
def entry(fms, reads):
    """The entry state of a pass-1 backward over the reads, as the seeder
    assembles it, with one zero-length pad lane that takes the entry count
    to a multiple of 8 (the Pallas layout is (8, W)): a dict of numpy
    arrays."""
    from mpibwa_tpu_torch.ops import seeding as TS
    from mpibwa_tpu_torch.ops import seeding_flat as TSF
    from mpibwa_tpu_torch.pipeline.device_seed import _pad_batch

    _, tfm = fms
    q, lens = _pad_batch(reads)
    B = len(q)
    fwd = TS.forward_pass(tfm, torch.from_numpy(q), torch.from_numpy(lens),
                          torch.ones(B, dtype=torch.int64))
    rows = [(b, int(fwd.call_start[b, c]), int(fwd.call_len[b, c]),
             int(fwd.call_x[b, c]))
            for b in range(B) for c in range(int(fwd.n_calls[b]))]
    arr = np.array(rows + [(0, 0, 0, 0)], np.int64)  # last = the pad lane
    e = int(arr[:, 2].sum())
    E = -(-e // 8) * 8
    lane_off = np.concatenate([[0], np.cumsum(arr[:, 2])]).astype(np.int32)
    lane_off[-1] = E
    lane_tbl = np.stack([arr[:, 1], arr[:, 2], lane_off[:-1]],
                        axis=1).astype(np.int32)
    ik, info, lane, live = TSF.assemble_entries(
        fwd.ivals, fwd.infos, torch.from_numpy(arr[:, 0].astype(np.int32)),
        torch.from_numpy(lane_tbl), E)
    rng = np.random.default_rng(9)
    minv = rng.integers(1, 3, len(arr)).astype(np.int32)
    assert int(live.sum()) == e and e > 500
    return {"q": q[arr[:, 0]], "x0": arr[:, 3].astype(np.int32),
            "minv": minv, "lane_off": lane_off, "ik": ik.numpy(),
            "info": info.numpy(), "lane": lane.numpy(), "live": live.numpy(),
            "E": E, "NL": len(arr)}


@pytest.fixture(scope="module")
def edge(fms):
    """The edge lanes of the backward pass over the toy index, packed: all
    of them ("all"), and those of 101-bp reads with a pad lane that takes
    the entry count to a multiple of 8 ("short", for the Pallas layout)."""
    _, tfm = fms
    lanes = toy.bwd_edge_lanes(tfm, 11)
    return {"lanes": lanes, "all": toy.pack_bwd_lanes(lanes),
            "short": toy.pack_bwd_lanes(
                [ln for ln in lanes if len(ln["q"]) == toy.READ_LEN], 8)}


@pytest.fixture(scope="module")
def edge_pass(fms, edge):
    """(lanes, entry state, state after ``bwd_pass``, its rounds) of all
    edge lanes."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    _, tfm = fms
    lanes, state = _port_state(edge["all"])
    rounds = torch.zeros(1, dtype=torch.int32)
    out = BC.bwd_pass(tfm, lanes, state, rounds)
    return lanes, state, out, int(rounds[0])


def _port_state(entry):
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    lanes = BC.make_lanes(torch.from_numpy(entry["q"]),
                          torch.from_numpy(entry["lane_off"]),
                          torch.from_numpy(entry["minv"]), entry["E"])
    state = BC.init_state(torch.from_numpy(entry["ik"]),
                          torch.from_numpy(entry["live"]),
                          torch.from_numpy(entry["x0"]), lanes.lane_e)
    return lanes, state


def _entries(entry):
    return tuple(torch.from_numpy(entry[k].copy())
                 for k in ("ik", "info", "lane", "live"))


def test_lanes_and_entry_state(entry):
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    lanes, state = _port_state(entry)
    np.testing.assert_array_equal(lanes.lane_e.numpy(), entry["lane"])
    assert lanes.max_len == int(np.diff(entry["lane_off"]).max())
    assert state.shape == (7, entry["E"]) and state.dtype == torch.int32
    assert int(state[BC.LAST].min()) == BC.BIG
    assert not bool(state[BC.EMITTED].any())
    np.testing.assert_array_equal(state[BC.I].numpy(),
                                  entry["x0"][entry["lane"]] - 1)


def test_bwd_round_equals_pallas_kernel_interpret_round_by_round(fms, entry):
    """The same entry state through ``bwd_round`` and through the Pallas
    round kernel in interpret mode, with the gathers its caller does ahead
    of it: all seven state arrays equal after every round, until no entry
    is live, and the emitted mems at the end."""
    import jax
    import jax.numpy as jnp

    from mpibwa_tpu.ops import pallas_bwd as PB
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    jfm, tfm = fms
    E, NL = entry["E"], entry["NL"]
    L = entry["q"].shape[1]
    S, W = 8, E // 8
    blocks = jfm.fused_blocks()
    n_blocks = blocks.shape[0]
    l2p = jnp.asarray(np.concatenate(
        [np.asarray(jfm.L2)[:4], [jfm.primary, jfm.seq_len, 0, 0]]
    ).astype(np.int32))
    primary = l2p[4]
    qflat = jnp.asarray(entry["q"].reshape(-1).astype(np.int32))
    lane_e = jnp.asarray(entry["lane"].astype(np.int32))
    lane_start = np.zeros(E, np.int32)
    lane_start[0] = 1
    lane_start[1:] = entry["lane"][1:] != entry["lane"][:-1]
    lane_start = jnp.asarray(lane_start.reshape(S, W))
    minv_e = jnp.asarray(entry["minv"][entry["lane"]].reshape(S, W))

    def gather_pos(pos):  # pallas_bwd.backward_full's gather
        sent = pos < 0
        p = jnp.where(sent, 0, pos)
        p = p - (p >= primary).astype(jnp.int32)
        rt = blocks[jnp.clip(p >> 7, 0, n_blocks - 1)].T
        return (rt[:4].reshape(4, S, W), rt[4:].reshape(8, S, W),
                (p & 127).reshape(S, W), sent.astype(jnp.int32).reshape(S, W))

    @jax.jit
    def jax_round(st):
        ik0, ik1, ik2, live, i_e, last_e, emitted = st
        i_flat = i_e.reshape(E)
        valid = (i_flat >= 0) & (i_flat < L)
        qi = jnp.where(valid, qflat[lane_e * L + jnp.clip(i_flat, 0, L - 1)],
                       4).reshape(S, W)
        kq = ik0.reshape(E) - 1
        return PB._round_call(l2p, *gather_pos(kq),
                              *gather_pos(kq + ik2.reshape(E)), qi,
                              lane_start, ik0, ik1, ik2, live, i_e, minv_e,
                              last_e, emitted, interpret=True)

    lanes, state = _port_state(entry)
    jst = tuple(jnp.asarray(row.numpy().reshape(S, W)) for row in state)
    names = ("ik0", "ik1", "ik2", "live", "i", "last", "emitted")
    rounds = 0
    while bool(state[BC.LIVE].any()):
        state = BC.bwd_round(tfm, lanes, state)
        jst = jax_round(jst)
        rounds += 1
        for name, row, want in zip(names, state, jst):
            np.testing.assert_array_equal(
                row.numpy(), np.asarray(want).reshape(E),
                err_msg=f"{name} after round {rounds}")
        assert rounds <= L + 2
    assert rounds > 5
    info = torch.from_numpy(entry["info"])
    got = BC.pull_rows(BC.pack_emitted(state, info, lanes.lane_e), E)[0]
    cols, n = PB.pack_emitted(jst, jnp.asarray(entry["info"].astype(np.int32)),
                              lane_e, E)
    np.testing.assert_array_equal(got, np.asarray(cols[: int(n)]))
    assert len(got) >= NL - 1  # every real lane emits its longest match


def test_round_wrapper_on_cpu_is_the_plain_round_in_place(fms, entry):
    """The pass wrapper on CPU tensors runs the plain pass, in place: the
    state of ``bwd_pass`` (``bwd_round`` until no entry is live), its round
    count in ``rounds``, and no kernel launch counted."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    _, tfm = fms
    lanes, state = _port_state(entry)
    want = state
    rounds = 0
    while bool(want[BC.LIVE].any()):
        want = BC.bwd_round(tfm, lanes, want)
        rounds += 1
    before = BC.bwd_pass_kernel.launches
    got_rounds = torch.full((1,), 2, dtype=torch.int32)
    out = BC.bwd_pass_kernel(tfm, lanes, state, got_rounds)
    assert out is state  # in place
    assert torch.equal(state, want)
    assert int(got_rounds[0]) == rounds > 5
    assert BC.bwd_pass_kernel.launches == before  # no kernel on the CPU
    assert int(want[BC.EMITTED].sum()) >= entry["NL"] - 1


def test_round_without_live_entries_changes_nothing(fms, entry):
    """A round, and a whole pass, over a state with no live entry change
    nothing (so a warp whose lane has none may leave at once), and such a
    pass counts no round."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    _, tfm = fms
    lanes, state = _port_state(entry)
    for _ in range(entry["q"].shape[1] + 2):
        state = BC.bwd_round(tfm, lanes, state)
    assert not bool(state[BC.LIVE].any())
    assert torch.equal(BC.bwd_round(tfm, lanes, state), state)
    rounds = torch.zeros(1, dtype=torch.int32)
    assert torch.equal(BC.bwd_pass(tfm, lanes, state, rounds), state)
    assert int(rounds[0]) == 0


def test_wrapper_checks_its_arguments(fms, entry):
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    _, tfm = fms
    lanes, state = _port_state(entry)
    with pytest.raises(TypeError):
        BC.bwd_pass_kernel(tfm, lanes, state.long())
    with pytest.raises(TypeError):
        BC.bwd_pass_kernel(tfm, lanes._replace(minv=lanes.minv.long()),
                           state)
    with pytest.raises(TypeError):
        BC.bwd_pass_kernel(tfm, lanes, state,
                           torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError):
        BC.bwd_pass_kernel(tfm, lanes, state[:6])
    with pytest.raises(ValueError):
        BC.bwd_pass_kernel(tfm, lanes._replace(lane_off=lanes.lane_off[:-1]),
                           state)
    with pytest.raises(ValueError):
        BC.bwd_pass_kernel(tfm, lanes, state.t().contiguous().t())
    with pytest.raises(ValueError):
        BC.bwd_pass_kernel(tfm, lanes, state,
                           torch.zeros(2, dtype=torch.int32))


def test_run_backward_fused_equals_flat_engine(fms, entry):
    """run_backward_fused against run_backward_flat on the same entries:
    the same per-lane mem lists, no overflow, and in stats the pass's
    round count and one host round trip."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC
    from mpibwa_tpu_torch.ops import seeding_flat as TSF

    _, tfm = fms
    NL = entry["NL"]
    q = torch.from_numpy(entry["q"])
    want, _ = TSF.run_backward_flat(tfm, q, _entries(entry), NL, entry["x0"],
                                    entry["minv"].astype(np.int64))
    lanes, state = _port_state(entry)
    rounds = torch.zeros(1, dtype=torch.int32)
    BC.bwd_pass(tfm, lanes, state, rounds)
    for interpret in (False, True):
        stats = {}
        got, ov = BC.run_backward_fused(
            tfm, q, _entries(entry), NL, entry["x0"], entry["minv"],
            entry["lane_off"], interpret=interpret, stats=stats)
        assert got == want
        assert ov.shape == (NL,) and not ov.any()
        assert stats == {"bwd_rounds": int(rounds[0]), "bwd_segments": 1}
    assert sum(map(len, want)) >= NL - 1


@pytest.mark.parametrize("min_len", [0, 19])
def test_run_backward_fused_raw_rows(fms, entry, min_len, monkeypatch):
    """raw=True: the (n, 6) int32 rows [x0, x1, x2, start, end, lane] of
    the mems at least min_len long, lane after lane in emission order,
    i.e. the per-lane lists flattened and filtered; one host read when
    est_rows covers them, two when it does not. The lists themselves
    (min_len 0, every mem kept) are pulled with room for every entry."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    _, tfm = fms
    NL = entry["NL"]
    q = torch.from_numpy(entry["q"])
    ests = []
    real_pull = BC.pull_rows
    monkeypatch.setattr(BC, "pull_rows",
                        lambda p, est: ests.append(est) or real_pull(p, est))
    mems, _ = BC.run_backward_fused(tfm, q, _entries(entry), NL, entry["x0"],
                                    entry["minv"], entry["lane_off"])
    assert ests == [entry["E"]]
    want = np.array([(x0, x1, x2, info >> 32, info & 0xFFFFFFFF, ln)
                     for ln, m in enumerate(mems) for x0, x1, x2, info in m
                     if (info & 0xFFFFFFFF) - (info >> 32) >= min_len],
                    np.int32).reshape(-1, 6)
    assert 0 < len(want) < sum(map(len, mems)) or not min_len
    for est, reads in ((len(want), 1), (len(want) - 1, 2)):
        stats = {}
        rows, ov = BC.run_backward_fused(
            tfm, q, _entries(entry), NL, entry["x0"], entry["minv"],
            entry["lane_off"], stats=stats, raw=True, min_len=min_len,
            est_rows=est)
        assert ov is False and rows.dtype == np.int32
        np.testing.assert_array_equal(rows, want)
        assert stats["bwd_segments"] == reads


def test_edge_lanes_cover_their_cases(edge, edge_pass):
    """The edge lanes hold what they are for: lengths 0, 1, 32, 33, 64, 65
    and past 8 slots of 32, a lane that runs for hundreds of rounds, dead
    entries, min_intv > 1 and intervals that span ``primary``."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    allp = edge["all"]
    n = np.diff(allp["lane_off"])
    assert {0, 1, 32, 33, 64, 65} <= set(n.tolist())
    assert n.max() > 32 * BC.SLOTS[-1]
    assert allp["q"].shape[1] >= toy.BWD_LONG_READ
    assert edge_pass[3] > 200
    assert (~allp["live"]).any() and (allp["minv"] > 1).any()
    names = set(allp["names"])
    assert {"all_dead", "n_at_next_position", "starts_at_i_0",
            "dedup_chains", "spans_primary", "random_live"} <= names
    short = edge["short"]
    assert short["E"] % 8 == 0 and short["q"].shape[1] == toy.READ_LEN


@pytest.mark.parametrize("which", ["toy_entries", "edge_lanes"])
def test_bwd_pass_equals_pallas_interpret(fms, entry, edge, which):
    """The plain pass (through run_backward_fused's interpret route) and
    mpibwa_tpu's run_backward_pallas with the Pallas round kernel in
    interpret mode emit the same mems, lane by lane."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops import pallas_bwd as PB
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    jfm, tfm = fms
    e = entry if which == "toy_entries" else edge["short"]
    NL = e["NL"]
    got, _ = BC.run_backward_fused(
        tfm, torch.from_numpy(e["q"]), _entries(e), NL, e["x0"], e["minv"],
        e["lane_off"], interpret=True)
    want, _ = PB.run_backward_pallas(
        jfm, jnp.asarray(e["q"]),
        (jnp.asarray(e["ik"]), jnp.asarray(e["info"].astype(np.int32)),
         jnp.asarray(e["lane"]), jnp.asarray(e["live"])),
        NL, e["x0"], e["minv"], e["lane"].astype(np.int64), interpret=True)
    assert got == want
    assert sum(map(len, got)) >= 20


# -- a numpy model of the kernel's warp (csrc/bwd_pass.cu) --------------------

_LT = [(1 << t) - 1 for t in range(32)]  # lane mask of the threads below t


def _ballot(pred) -> int:
    return sum(1 << int(t) for t in np.flatnonzero(pred))


def _model_extend(fm, q, L, minv, x):
    """extend_entry of the kernel over the entries x (7, m): (ok (m, 3),
    keeper (m,)); zeros where the entry does not extend."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC
    from mpibwa_tpu_torch.ops.occ4_cuda import extend_blocks

    i = x[BC.I]
    qi = np.where((i >= 0) & (i < L), q[np.clip(i, 0, L - 1)], 4)
    ext = (x[BC.LIVE] != 0) & (i >= 0) & (qi < 4)
    ok4 = extend_blocks(fm, torch.from_numpy(np.ascontiguousarray(
        x[BC.IK0:BC.IK2 + 1].T)), 1).numpy()
    ok = np.where(ext[:, None], ok4[np.arange(len(i)), np.clip(qi, 0, 3)],
                  0).astype(np.int32)
    return ok, ext & (ok[:, 2] >= minv)


def _model_step(x, ok, keeper, c):
    """step() of the kernel: one slot's carries over the 32 threads. x (7,
    32) int32 (zeros past the lane's end) is updated in place; returns
    whether each entry is live after the round."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    live = x[BC.LIVE] != 0
    lm = _ballot(live)
    first = np.zeros(32, bool)
    if not c["live_above"] and lm:
        first[(lm & -lm).bit_length() - 1] = True  # __ffs(lm) - 1
    c["live_above"] = c["live_above"] or lm != 0
    start = x[BC.I] + np.int32(1)  # int32 wraps
    emit = first & ~keeper & (start < x[BC.LAST])
    em = _ballot(emit)
    seen = np.array([c["seen"] or em & (_LT[t] | 1 << t) != 0
                     for t in range(32)])
    c["seen"] = c["seen"] or em != 0
    km = _ballot(keeper)
    below = np.array([km & _LT[t] for t in range(32)])
    src = [int(b).bit_length() - 1 if b else 0 for b in below]  # 31 - clz
    prev_s = ok[src, 2]  # __shfl_sync
    has_prev = (below != 0) | c["have_keeper"]
    prev = np.where(below != 0, prev_s, c["keeper_s"])
    append = keeper & (~has_prev | (ok[:, 2] != prev))
    if km:
        c["keeper_s"] = ok[km.bit_length() - 1, 2]
        c["have_keeper"] = True
    x[BC.LAST] = np.where(seen, start, x[BC.LAST])
    x[BC.EMITTED] = np.where(emit, 1, x[BC.EMITTED])
    x[BC.IK0:BC.IK2 + 1] = np.where(append, ok.T, x[BC.IK0:BC.IK2 + 1])
    x[BC.I] = np.where(append, x[BC.I] - np.int32(1), x[BC.I])
    x[BC.LIVE] = append
    return append


def _warp_model(fm, q, L, minv, mem, S):
    """One warp of csrc/bwd_pass.cu over one lane: mem (7, n) int32, the
    lane's state in device memory, updated in place; returns the rounds
    the warp ran. A lane of at most 32 * S entries lives in S register
    slots of 32 threads (entry j in thread j % 32, slot j / 32), loaded
    once and stored once; a longer one is walked in chunks of 32 from
    memory every round."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    n = mem.shape[1]

    def load(j0):
        x = np.zeros((7, 32), np.int32)
        m = max(min(32, n - j0), 0)
        x[:, :m] = mem[:, j0:j0 + m]
        return x

    def pad(ok, kp, m):
        return (np.concatenate([ok, np.zeros((m - len(ok), 3), np.int32)]),
                np.concatenate([kp, np.zeros(m - len(kp), bool)]))

    in_regs = n <= 32 * S
    regs = [load(32 * s) for s in range(S)] if in_regs else None
    live = (np.concatenate(regs, 1) if in_regs else mem)[BC.LIVE] != 0
    if not live.any():  # __any_sync: the warp leaves
        return 0
    r = 0
    any_live = True
    while any_live and r < L + 2:
        c = {"live_above": False, "seen": False, "have_keeper": False,
             "keeper_s": 0}
        nxt = False
        if in_regs:
            # every slot extends before any warp operation
            ok, kp = _model_extend(fm, q, L, minv, np.concatenate(regs, 1))
            for s in range(S):
                if 32 * s < n:
                    nxt |= _model_step(regs[s], ok[32 * s: 32 * s + 32],
                                       kp[32 * s: 32 * s + 32], c).any()
        else:
            # a chunk's extension reads only its own entries, which no
            # earlier chunk of the round has written: one call for all
            ok, kp = pad(*_model_extend(fm, q, L, minv, mem),
                         -(-n // 32) * 32)
            for j0 in range(0, n, 32):
                x = load(j0)
                nxt |= _model_step(x, ok[j0: j0 + 32], kp[j0: j0 + 32],
                                   c).any()
                m = min(32, n - j0)
                mem[:, j0:j0 + m] = x[:, :m]
        r += 1
        any_live = nxt
    if in_regs:
        for s in range(S):
            m = max(min(32, n - 32 * s), 0)
            mem[:, 32 * s: 32 * s + m] = regs[s][:, :m]
    return r


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_warp_model_equals_bwd_pass_on_edge_lanes(fms, edge, edge_pass, S):
    """The numpy model of the kernel's warp, lane by lane, at S register
    slots (lanes longer than 32 * S through the chunked path), against the
    plain pass over all edge lanes at once: all 7 state arrays equal, and
    the most rounds of any lane equal the pass's rounds."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    _, tfm = fms
    e = edge["all"]
    lanes, state0, want, want_rounds = edge_pass
    L = e["q"].shape[1]
    got = state0.numpy().copy()
    rounds = []
    chunked = 0
    for ln in range(e["NL"]):
        a, b = e["lane_off"][ln], e["lane_off"][ln + 1]
        mem = got[:, a:b].copy()
        rounds.append(_warp_model(tfm, e["q"][ln], L, int(e["minv"][ln]),
                                  mem, S))
        got[:, a:b] = mem
        chunked += int(b - a > 32 * S)
    np.testing.assert_array_equal(got, want.numpy())
    assert max(rounds) == want_rounds
    assert chunked >= 1  # the lanes of 300 entries
    assert S > 1 or chunked >= 5


@pytest.mark.parametrize("mode,device,idt,want", [
    ("auto", "cuda", torch.int32, "pallas"),
    ("auto", "cpu", torch.int32, "flat"),
    ("auto", "cuda", torch.int64, "v8"),
    ("auto", "cpu", torch.int64, "flat"),
    ("flat", "cuda", torch.int32, "flat"),
    ("pallas", "cpu", torch.int32, "pallas"),
    ("pallas_interp", "cuda", torch.int32, "pallas_interp"),
    ("v8", "cuda", torch.int64, "v8"),
    ("v8", "cpu", torch.int32, "v8"),
])
def test_backward_engine_choice(monkeypatch, mode, device, idt, want):
    """MPIBWA_BWD=auto takes the pass kernel on a CUDA int32 index, v8 on a
    CUDA int64 index and the flat engine on the CPU; the other modes mean
    what they say, on any device and position dtype (a stub index stands
    for a card)."""
    from mpibwa_tpu_torch.pipeline.device_seed import _backward_engine

    monkeypatch.setenv("MPIBWA_BWD", mode)
    fm = types.SimpleNamespace(device=torch.device(device), idt=idt)
    assert _backward_engine(fm) == want


def _collect(seeder_cls, fm, reads, mode, monkeypatch):
    monkeypatch.setenv("MPIBWA_BWD", mode)
    got, fallback = seeder_cls(fm, mem_opt_init()).collect_batch(reads)
    assert not fallback.any()
    return got


def test_collect_batch_pallas_equals_every_engine(fms, index, reads,
                                                  monkeypatch):
    """Seeds of the port under MPIBWA_BWD=pallas (the plain round, on the
    CPU) against mpibwa_tpu under pallas_interp, the port under flat and
    pallas_interp, and the scalar engine core.fm."""
    from mpibwa_tpu.pipeline.device_seed import DeviceSeeder as JaxSeeder
    from mpibwa_tpu_torch.core.chain import collect_intv
    from mpibwa_tpu_torch.core.fm import FMIndex
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    jfm, tfm = fms
    got = _collect(DeviceSeeder, tfm, reads, "pallas", monkeypatch)
    assert got == _collect(JaxSeeder, jfm, reads, "pallas_interp",
                           monkeypatch)
    assert got == _collect(DeviceSeeder, tfm, reads, "flat", monkeypatch)
    assert got == _collect(DeviceSeeder, tfm, reads, "pallas_interp",
                           monkeypatch)
    fm = FMIndex.from_index(index)
    opt = mem_opt_init()
    for seq, ivs in zip(reads, got):
        assert ivs == collect_intv(opt, fm, seq)
    assert sum(map(len, got)) > N_READS


def test_collect_flat_pallas_equals_flat(fms, reads, monkeypatch):
    """The arrays route (collect_flat) under the fused rounds: the rows of
    the mems come from run_backward_fused(raw=True), filtered and
    compacted on the device, and no per-lane list is built."""
    from mpibwa_tpu_torch.ops import bwd_cuda
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    _, tfm = fms
    out = {}
    calls, lists = [], []
    for mode in ("flat", "pallas"):
        if mode == "pallas":
            real = bwd_cuda.run_backward_fused
            monkeypatch.setattr(
                bwd_cuda, "run_backward_fused",
                lambda *a, **k: calls.append(k) or real(*a, **k))
            monkeypatch.setattr(DeviceSeeder, "_run_backward_for_calls",
                                lambda *a: lists.append(a))
        monkeypatch.setenv("MPIBWA_BWD", mode)
        seeder = DeviceSeeder(tfm, mem_opt_init())
        out[mode] = seeder.collect_flat(reads)
        assert ("bwd_rounds" in seeder.times) == (mode == "pallas")
    assert len(calls) >= 2 and all(k["raw"] for k in calls)
    assert not lists
    for a, b in zip(out["pallas"], out["flat"]):
        np.testing.assert_array_equal(a, b)
    assert len(out["flat"][0]) > N_READS


@pytest.mark.parametrize("mode,exc", [("fastest", ValueError)])
def test_unported_engines_go_on_raising(fms, reads, monkeypatch, mode, exc):
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    _, tfm = fms
    monkeypatch.setenv("MPIBWA_BWD", mode)
    with pytest.raises(exc):
        DeviceSeeder(tfm, mem_opt_init()).collect_batch(reads[:4])


def test_pallas_needs_the_int32_path(index, reads, monkeypatch):
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    wide = DeviceFMIndex(index, CPU, force_wide=True)
    monkeypatch.setenv("MPIBWA_BWD", "pallas")
    with pytest.raises((TypeError, ValueError), match="int32"):
        DeviceSeeder(wide, mem_opt_init()).collect_batch(reads[:4])


@pytest.mark.parametrize("pe", [True, False], ids=["pe", "se"])
def test_cli_mem_identical_under_the_knob(toy_paths, tmp_path, monkeypatch,
                                          pe):
    """`cli mem` writes the same bytes under MPIBWA_BWD=auto (on the CPU:
    the flat engine), flat, pallas (the pass wrapper, here its plain
    pass) and v8; only pallas goes through run_backward_fused."""
    from mpibwa_tpu_torch import cli
    from mpibwa_tpu_torch.ops import bwd_cuda

    monkeypatch.setenv("MPIBWA_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("MPIBWA_PALLAS", raising=False)
    calls = []
    real = bwd_cuda.run_backward_fused
    monkeypatch.setattr(bwd_cuda, "run_backward_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    args = ["-t", "1", "-o", "out", toy_paths["ref"], toy_paths["r1"]] \
        + ([toy_paths["r2"]] if pe else [])
    sams = {}
    for mode in ("auto", "flat", "pallas", "v8"):
        monkeypatch.setenv("MPIBWA_BWD", mode)
        d = tmp_path / mode
        d.mkdir()
        monkeypatch.chdir(d)
        n0 = len(calls)
        assert cli.main(["mem"] + args) == 0
        assert (len(calls) > n0) == (mode == "pallas")
        sams[mode] = (d / "out.sam").read_bytes()
    assert len(set(sams.values())) == 1
    assert sams["auto"].count(b"\n") > 200


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu(index, entry, edge):
    """The CUDA pass kernel equals the plain pass on the card, in place, in
    exactly one launch a pass: on the toy entries and on every edge lane,
    at each register instance (the slot count forced through max_len; the
    lanes longer than 32 slots take the chunked path), with the round
    count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from mpibwa_tpu_torch.ops import bwd_cuda as BC
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    dev = torch.device("cuda")
    fm = DeviceFMIndex(index, dev)
    for e in (entry, edge["all"]):
        lanes, state0 = _port_state(e)
        lanes = lanes._replace(**{k: getattr(lanes, k).to(dev) for k in
                                  ("qrows", "lane_off", "minv", "lane_e")})
        state0 = state0.to(dev)
        want_rounds = torch.zeros(1, dtype=torch.int32, device=dev)
        want = BC.bwd_pass(fm, lanes, state0.clone(), want_rounds)
        for max_len in (1, 33, 65, 129, lanes.max_len):
            state = state0.clone()
            rounds = torch.zeros(1, dtype=torch.int32, device=dev)
            before = BC.bwd_pass_kernel.launches
            out = BC.bwd_pass_kernel(fm, lanes._replace(max_len=max_len),
                                     state, rounds)
            torch.cuda.synchronize()
            assert out is state
            assert BC.bwd_pass_kernel.launches == before + 1
            assert torch.equal(state, want), max_len
            assert torch.equal(rounds, want_rounds), max_len
        assert int(want_rounds[0]) > 5
