"""The port's v8 backward engine (mpibwa_tpu_torch/ops/backward8.py) and
the routes of the seeder that use it (pipeline/device_seed.py) vs the JAX
package on reads simulated from the toy genome, in the int32 and the
forced int64 position paths: ``run_backward8`` row for row in list and
raw modes with several segments and compactions, ``collect_batch`` and
``collect_flat`` under v8, the speculative pass-2 route, and the
overflows that send work to the exact flat engine. Integers
throughout: every comparison is exact (tolerance 0). v8 keeps x[1] at its
forward value, so it meets the other engines on (x0, x2, info) only."""

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


def _pass1(tfm, reads, seed=3):
    """A pass-1 backward's inputs as the seeder builds them for v8, with
    min_intv 1-3 a lane: (qrows (NL, L) uint8, the entries, NL, x0,
    minv)."""
    from mpibwa_tpu_torch.ops import backward8 as TB8
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
    NL = DS._v8_lanes(len(arr))
    lane_row, lane_tbl, x0, minv, e = DS._lane_tables(arr, NL)
    entries = TSF.assemble_entries(fwd.ivals, fwd.infos,
                                   torch.from_numpy(lane_row),
                                   torch.from_numpy(lane_tbl),
                                   TB8.cap_bucket(e, 1024))
    return q[lane_row], entries, NL, x0, minv


@pytest.fixture
def small_caps(monkeypatch):
    """MIN_CAP 64 in both packages, so toy passes run several segments
    and compactions (JAX's cap_bucket takes its floor from MIN_CAP when
    its module is imported, so it is rebound too)."""
    from mpibwa_tpu.ops import backward8 as JB8
    from mpibwa_tpu_torch.ops import backward8 as TB8

    real = JB8.cap_bucket
    monkeypatch.setattr(JB8, "MIN_CAP", 64)
    monkeypatch.setattr(JB8, "cap_bucket", lambda n, floor=64: real(n, floor))
    monkeypatch.setattr(TB8, "MIN_CAP", 64)
    shrinks = []
    real_shrink = TB8.shrink8
    monkeypatch.setattr(TB8, "shrink8", lambda *a: shrinks.append(a[3])
                        or real_shrink(*a))
    yield shrinks
    JB8.SCHED_CACHE.clear()


@pytest.mark.parametrize("min_len", [0, 19])
@pytest.mark.parametrize("raw", [False, True], ids=["lists", "raw"])
def test_run_backward8_matches_jax(fms, reads, small_caps, raw, min_len):
    """run_backward8 == the JAX run_backward8 (its adaptive run) on the same
    entries: every row or every lane's mems, all six columns, and the
    overflow flags; raw rows the same with one pull or two."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops import backward8 as JB8
    from mpibwa_tpu_torch.ops import backward8 as TB8

    jfm, tfm = fms
    qrows, entries, NL, x0, minv = _pass1(tfm, reads)
    est = NL // 8 + 1024
    want = JB8.run_backward8(
        jfm, jnp.asarray(qrows), tuple(jnp.asarray(t.numpy())
                                       for t in entries),
        NL, x0, minv, min_len=min_len, raw=raw, est_rows=est,
        _force_adaptive=True)
    stats = {}
    got = TB8.run_backward8(tfm, torch.from_numpy(qrows), entries, NL, x0,
                            minv, min_len=min_len, raw=raw, est_rows=est,
                            stats=stats)
    assert len(small_caps) >= 2  # several segments, each compacted
    assert stats["bwd_segments"] > len(small_caps)
    if raw:
        assert got[1] is want[1] is False
        assert got[0].dtype == want[0].dtype == tfm.np_idt
        np.testing.assert_array_equal(got[0], want[0])
        assert len(got[0]) > N_READS // 2
        few = TB8.run_backward8(tfm, torch.from_numpy(qrows), entries, NL,
                                x0, minv, min_len=min_len, raw=True,
                                est_rows=1)
        np.testing.assert_array_equal(few[0], want[0])
    else:
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert not got[1].any()
        if min_len:
            assert all(iv[3] - (iv[3] >> 32 << 32) - (iv[3] >> 32) >= min_len
                       for m in got[0] for iv in m)


def test_v8_overflow_is_redone_on_the_flat_engine(fms, reads, small_caps,
                                                  monkeypatch):
    """A v8 accumulator that fills reports overflow (raw: no rows; lists:
    every lane); the list route then redoes the pass on the flat engine
    exactly and the arrays route gives up (collect_flat -> None)."""
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    _, tfm = fms
    monkeypatch.setattr(TB8, "_acc_rows", lambda E, min_len: 2)
    qrows, entries, NL, x0, minv = _pass1(tfm, reads)
    rows, ov = TB8.run_backward8(tfm, torch.from_numpy(qrows), entries, NL,
                                 x0, minv, raw=True, est_rows=64)
    assert ov is True and rows.shape == (0, 6)
    mems, overflow = TB8.run_backward8(tfm, torch.from_numpy(qrows),
                                       entries, NL, x0, minv)
    assert overflow.all() and not any(mems)

    opt = mem_opt_init()
    monkeypatch.setenv("MPIBWA_BWD", "flat")
    want, wfb = DeviceSeeder(tfm, opt).collect_batch(reads)
    monkeypatch.setenv("MPIBWA_BWD", "v8")
    seeder = DeviceSeeder(tfm, opt)
    assert seeder.collect_flat(reads) is None
    got, gfb = seeder.collect_batch(reads)
    assert seeder.times["v8_redo"] >= 1
    np.testing.assert_array_equal(gfb, wfb)
    assert got == want


def _seeds(seeder_cls, fm, reads, mode, monkeypatch, flat):
    monkeypatch.setenv("MPIBWA_BWD", mode)
    seeder = seeder_cls(fm, mem_opt_init())
    out = seeder.collect_flat(reads) if flat else seeder.collect_batch(reads)
    return out, seeder


def _cols(ivs, cols=(0, 2, 3)):
    return None if ivs is None else [tuple(iv[c] for c in cols) for iv in ivs]


def test_collect_batch_matches_jax_and_flat(fms, index, reads, monkeypatch):
    """collect_batch under v8 == the JAX package's under v8 (every field),
    == the port's flat engine and the scalar engine core.fm on (x0, x2,
    info)."""
    from mpibwa_tpu.pipeline.device_seed import DeviceSeeder as JaxSeeder
    from mpibwa_tpu_torch.core.chain import collect_intv
    from mpibwa_tpu_torch.core.fm import FMIndex
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    jfm, tfm = fms
    (got, gfb), seeder = _seeds(DeviceSeeder, tfm, reads, "v8", monkeypatch,
                                False)
    (want, wfb), _ = _seeds(JaxSeeder, jfm, reads, "v8", monkeypatch, False)
    assert got == want
    np.testing.assert_array_equal(gfb, wfb)
    (flat, ffb), _ = _seeds(DeviceSeeder, tfm, reads, "flat", monkeypatch,
                            False)
    np.testing.assert_array_equal(gfb, ffb)
    assert [_cols(a) for a in got] == [_cols(b) for b in flat]
    fm = FMIndex.from_index(index)
    opt = mem_opt_init()
    for seq, ivs in zip(reads, got):
        if ivs is not None:
            assert _cols(ivs) == _cols(collect_intv(opt, fm, seq))
    assert sum(len(a) for a in got if a) > N_READS
    assert seeder.times["bwd_segments"] > 0


def test_collect_flat_matches_jax_and_flat(fms, reads, monkeypatch):
    """collect_flat under v8 == the JAX package's under v8 in every array,
    and == the port's flat engine on (x0, x2, info), the offsets and the
    fallback flags."""
    from mpibwa_tpu.pipeline.device_seed import DeviceSeeder as JaxSeeder
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    jfm, tfm = fms
    got, _ = _seeds(DeviceSeeder, tfm, reads, "v8", monkeypatch, True)
    want, _ = _seeds(JaxSeeder, jfm, reads, "v8", monkeypatch, True)
    flat, _ = _seeds(DeviceSeeder, tfm, reads, "flat", monkeypatch, True)
    for name, g, w in zip(("flat", "mem_off", "fallback"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got[0][:, [0, 2, 3]], flat[0][:, [0, 2, 3]])
    np.testing.assert_array_equal(got[1], flat[1])
    np.testing.assert_array_equal(got[2], flat[2])
    assert len(got[0]) > N_READS


def test_v8_int64_rows_equal_int32(index, reads, monkeypatch):
    """collect_flat under v8 gives the same three arrays on the int64
    position path as on the int32 one."""
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    outs = [_seeds(DeviceSeeder, DeviceFMIndex(index, CPU, force_wide=w),
                   reads, "v8", monkeypatch, True)[0] for w in (False, True)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _p2_spy(monkeypatch):
    """Records the cap of every _p2_tables call (the speculative route)."""
    from mpibwa_tpu_torch.pipeline import device_seed as DS

    caps = []
    real = DS._p2_tables
    monkeypatch.setattr(DS, "_p2_tables",
                        lambda fwd2, cap: caps.append(cap) or real(fwd2, cap))
    return caps


def test_p2_speculative_route_matches_sync(fms, reads, monkeypatch):
    """Under v8 the second collect_flat of a seeder takes the speculative
    pass-2 route (device-built lane tables) and returns exactly the first
    call's arrays (the synchronous route); a speculative capacity poisoned
    too small raises the overflow flag and the synchronous route redoes
    pass 2, with no rows lost."""
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    _, tfm = fms
    caps = _p2_spy(monkeypatch)
    monkeypatch.setenv("MPIBWA_BWD", "v8")
    seeder = DeviceSeeder(tfm, mem_opt_init())
    want = seeder.collect_flat(reads)
    assert want is not None and not caps and "p2_spec" not in seeder.times
    real_e = seeder._p2_est["e"]
    assert real_e > 8
    got = seeder.collect_flat(reads)
    assert caps == [TB8.cap_bucket(max(real_e * 5 // 4, 1024), 1024)]
    assert seeder.times["p2_spec"] == 1 and "p2_redo" not in seeder.times
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    spec_n = max(real_e * 5 // 4, 1024)
    real_bucket = TB8.cap_bucket
    poisoned = []

    def tiny_bucket(n, floor=TB8.MIN_CAP):
        if floor == 1024 and n == spec_n and not poisoned:
            poisoned.append(n)
            return 8
        return real_bucket(n, floor)

    monkeypatch.setattr(TB8, "cap_bucket", tiny_bucket)
    got = seeder.collect_flat(reads)
    assert poisoned and caps[-1] == 8
    assert seeder.times["p2_redo"] == 1 and seeder.times["p2_spec"] == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_p2_overflowed_lane_is_zero_length_on_both_routes(fms, reads,
                                                          monkeypatch):
    """A pass-2 lane whose forward overflowed, with a call length far past
    any capacity: both routes send its read to the host engine, give equal
    arrays, and the speculative route needs no redo (its length does not
    count)."""
    from mpibwa_tpu_torch.ops import seeding as TS
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    _, tfm = fms
    monkeypatch.setenv("MPIBWA_BWD", "v8")
    clean = DeviceSeeder(tfm, mem_opt_init()).collect_flat(reads)
    real = TS.forward_pass

    def overflow_lane0(fm, q, lens, minv, chained=True, starts=None):
        out = real(fm, q, lens, minv, chained, starts)
        if starts is None:
            return out
        out.overflow[0] = True
        out.call_len[0, 0] = 50_000
        return out

    monkeypatch.setattr(TS, "forward_pass", overflow_lane0)
    seeder = DeviceSeeder(tfm, mem_opt_init())
    want = seeder.collect_flat(reads)
    got = seeder.collect_flat(reads)
    assert seeder.times["p2_spec"] == 1 and "p2_redo" not in seeder.times
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    gone = want[2] & ~clean[2]
    assert gone.sum() == 1
    keep = ~gone[np.repeat(np.arange(len(reads)), np.diff(clean[1]))]
    np.testing.assert_array_equal(want[0], clean[0][keep])


def test_v8_schedule_changes_no_output(fms, reads, monkeypatch):
    """Other segment lengths and capacity floors give the same seeds: the
    schedule decides only when v8 compacts and reads the live count."""
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.pipeline.device_seed import DeviceSeeder

    _, tfm = fms
    out = []
    for seg_rounds, min_cap in ((4, 8192), (1, 64), (3, 256)):
        monkeypatch.setattr(TB8, "SEG_ROUNDS", seg_rounds)
        monkeypatch.setattr(TB8, "MIN_CAP", min_cap)
        (got, _), _ = _seeds(DeviceSeeder, tfm, reads, "v8", monkeypatch,
                             False)
        out.append(got)
    assert all(o == out[0] for o in out)


@pytest.mark.gpu
def test_v8_on_gpu_matches_cpu(index, reads):
    """run_backward8 on the card == on the CPU (raw rows, both position
    dtypes, several compactions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from mpibwa_tpu_torch.ops import backward8 as TB8
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    dev = torch.device("cuda")
    for wide in (False, True):
        cpu_fm = DeviceFMIndex(index, CPU, force_wide=wide)
        gpu_fm = DeviceFMIndex(index, dev, force_wide=wide)
        qrows, entries, NL, x0, minv = _pass1(cpu_fm, reads)
        for min_len in (0, 19):
            want = TB8.run_backward8(cpu_fm, torch.from_numpy(qrows),
                                     entries, NL, x0, minv, min_len=min_len,
                                     raw=True, est_rows=64)
            got = TB8.run_backward8(gpu_fm, torch.from_numpy(qrows).to(dev),
                                    tuple(t.to(dev) for t in entries), NL,
                                    x0, minv, min_len=min_len, raw=True,
                                    est_rows=64)
            assert got[1] is want[1] is False
            np.testing.assert_array_equal(got[0], want[0])
