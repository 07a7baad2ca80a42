"""The port's fused backward rounds (mpibwa_tpu_torch/ops/bwd_cuda.py) vs
the JAX package on reads simulated from the toy genome: the plain round
``bwd_round`` against the Pallas kernel ``pallas_bwd._round_call`` in
interpret mode, round by round; seeds under MPIBWA_BWD=pallas against
mpibwa_tpu's pallas_interp, the port's flat engine and the scalar engine;
and `cli mem` under the knob. Integers throughout: every comparison is
exact (tolerance 0). The CUDA kernel itself runs only on a card (the test
marked ``gpu``)."""

import numpy as np
import pytest
import torch

import _torch_toy as toy
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


def _port_state(entry):
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    lanes = BC.make_lanes(torch.from_numpy(entry["q"]),
                          torch.from_numpy(entry["lane_off"]),
                          torch.from_numpy(entry["minv"]), entry["E"])
    state = BC.init_state(torch.from_numpy(entry["ik"]),
                          torch.from_numpy(entry["live"]),
                          torch.from_numpy(entry["x0"]), lanes.lane_e)
    return lanes, state


def test_lanes_and_entry_state(entry):
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    lanes, state = _port_state(entry)
    np.testing.assert_array_equal(lanes.lane_e.numpy(), entry["lane"])
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
    got = BC.pack_emitted(state, info, lanes.lane_e)
    cols, n = PB.pack_emitted(jst, jnp.asarray(entry["info"].astype(np.int32)),
                              lane_e, E)
    np.testing.assert_array_equal(got, np.asarray(cols[: int(n)]))
    assert len(got) >= NL - 1  # every real lane emits its longest match


def test_round_wrapper_on_cpu_is_the_plain_round_in_place(fms, entry):
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    _, tfm = fms
    lanes, state = _port_state(entry)
    want = state
    before = BC.bwd_round_kernel.launches
    for _ in range(3):
        want = BC.bwd_round(tfm, lanes, want)
        out = BC.bwd_round_kernel(tfm, lanes, state)
        assert out is state  # in place
        assert torch.equal(state, want)
    assert BC.bwd_round_kernel.launches == before  # no kernel on the CPU
    assert int(want[BC.LIVE].sum()) < int(entry["live"].sum())


def test_round_without_live_entries_changes_nothing(fms, entry):
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    _, tfm = fms
    lanes, state = _port_state(entry)
    for _ in range(entry["q"].shape[1] + 2):
        state = BC.bwd_round(tfm, lanes, state)
    assert not bool(state[BC.LIVE].any())
    assert torch.equal(BC.bwd_round(tfm, lanes, state), state)


def test_wrapper_checks_its_arguments(fms, entry):
    from mpibwa_tpu_torch.ops import bwd_cuda as BC

    _, tfm = fms
    lanes, state = _port_state(entry)
    with pytest.raises(TypeError):
        BC.bwd_round_kernel(tfm, lanes, state.long())
    with pytest.raises(TypeError):
        BC.bwd_round_kernel(tfm, lanes._replace(minv=lanes.minv.long()),
                            state)
    with pytest.raises(ValueError):
        BC.bwd_round_kernel(tfm, lanes, state[:6])
    with pytest.raises(ValueError):
        BC.bwd_round_kernel(tfm, lanes._replace(lane_off=lanes.lane_off[:-1]),
                            state)
    with pytest.raises(ValueError):
        BC.bwd_round_kernel(tfm, lanes, state.t().contiguous().t())


def test_run_backward_fused_equals_flat_engine(fms, entry):
    """run_backward_fused against run_backward_flat on the same entries:
    the same per-lane mem lists, no overflow, and round and sync counts in stats."""
    from mpibwa_tpu_torch.ops import bwd_cuda as BC
    from mpibwa_tpu_torch.ops import seeding_flat as TSF

    _, tfm = fms
    NL = entry["NL"]
    q = torch.from_numpy(entry["q"])

    def entries():
        return tuple(torch.from_numpy(entry[k].copy())
                     for k in ("ik", "info", "lane", "live"))

    want, _ = TSF.run_backward_flat(tfm, q, entries(), NL, entry["x0"],
                                    entry["minv"].astype(np.int64))
    for interpret in (False, True):
        stats = {}
        got, ov = BC.run_backward_fused(
            tfm, q, entries(), NL, entry["x0"], entry["minv"],
            entry["lane_off"], interpret=interpret, stats=stats)
        assert got == want
        assert ov.shape == (NL,) and not ov.any()
        assert stats["bwd_rounds"] == \
            stats["bwd_segments"] * BC.ROUNDS_PER_SYNC
    assert sum(map(len, want)) >= NL - 1


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
    """The arrays route (collect_flat) under the fused rounds."""
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    _, tfm = fms
    out = {}
    for mode in ("flat", "pallas"):
        monkeypatch.setenv("MPIBWA_BWD", mode)
        seeder = DeviceSeeder(tfm, mem_opt_init())
        out[mode] = seeder.collect_flat(reads)
        assert ("bwd_rounds" in seeder.times) == (mode == "pallas")
    for a, b in zip(out["pallas"], out["flat"]):
        np.testing.assert_array_equal(a, b)
    assert len(out["flat"][0]) > N_READS


@pytest.mark.parametrize("mode,exc", [("v8", NotImplementedError),
                                      ("contig", NotImplementedError),
                                      ("fastest", ValueError)])
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
    """`cli mem` with MPIBWA_BWD=pallas writes the default run's bytes."""
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
    for mode in ("auto", "pallas"):
        monkeypatch.setenv("MPIBWA_BWD", mode)
        d = tmp_path / mode
        d.mkdir()
        monkeypatch.chdir(d)
        n0 = len(calls)
        assert cli.main(["mem"] + args) == 0
        assert (len(calls) > n0) == (mode == "pallas")
        sams[mode] = (d / "out.sam").read_bytes()
    assert sams["pallas"] == sams["auto"]
    assert sams["auto"].count(b"\n") > 200


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu(index, entry):
    """The CUDA round kernel equals the plain round on the card, round by
    round from the entry state, in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from mpibwa_tpu_torch.ops import bwd_cuda as BC
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    dev = torch.device("cuda")
    fm = DeviceFMIndex(index, dev)
    lanes, state = _port_state(entry)
    lanes = BC.BwdLanes(*(t.to(dev) for t in lanes))
    state = state.to(dev)
    want = state.clone()
    rounds = 0
    while bool(want[BC.LIVE].any()):
        before = BC.bwd_round_kernel.launches
        want = BC.bwd_round(fm, lanes, want)
        BC.bwd_round_kernel(fm, lanes, state)
        torch.cuda.synchronize()
        assert BC.bwd_round_kernel.launches == before + 1
        rounds += 1
        assert torch.equal(state, want), rounds
    assert rounds > 5
