"""The port's seeding automata and flat backward engine
(mpibwa_tpu_torch/ops/seeding.py, seeding_flat.py) vs their JAX originals
on reads simulated from the toy genome, in the int32 and the forced int64
position paths. Every output field must be equal."""

import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401
from mpibwa_tpu.core.opts import mem_opt_init
from mpibwa_tpu.index.format import load_index

torch.set_num_threads(1)  # test workers run in parallel on few cores


CPU = torch.device("cpu")
N_READS = 96


@pytest.fixture(scope="module")
def toy_paths(tmp_path_factory):
    return toy.build_toy(str(tmp_path_factory.mktemp("toy")))


@pytest.fixture(scope="module")
def batch(toy_paths):
    """(q (B, L) uint8, lens (B,) int32) padded like the device seeder."""
    from mpibwa_tpu_torch.pipeline.device_seed import _pad_batch

    reads = toy.load_reads(toy_paths["r1"], limit=N_READS)
    return _pad_batch([s.seq for s in reads])


@pytest.fixture(scope="module", params=[False, True], ids=["i32", "i64"])
def fms(request, toy_paths):
    from mpibwa_tpu.ops.fmd import DeviceFMIndex as JaxFM
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    idx = load_index(toy_paths["ref"])
    return (JaxFM(idx, force_wide=request.param),
            DeviceFMIndex(idx, CPU, force_wide=request.param))


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_tuple_equal(got, want):
    assert type(got)._fields == type(want)._fields
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape, name
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_forward_pass_chained(fms, batch):
    import jax.numpy as jnp

    from mpibwa_tpu.ops import seeding as JS
    from mpibwa_tpu_torch.ops import seeding as TS

    jfm, tfm = fms
    q, lens = batch
    B = len(q)
    got = TS.forward_pass(tfm, _t(q), _t(lens), torch.ones(B, dtype=torch.int64))
    want = JS.forward_pass(jfm, jnp.asarray(q), jnp.asarray(lens),
                           jnp.ones(B, jnp.int64), True)
    _assert_tuple_equal(got, want)


def test_forward_pass_single_call_with_starts(fms, batch):
    """Pass-2 mode: one call per lane from a given start, with per-lane
    min_intv (some starts on ambiguous bases or past the read end)."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops import seeding as JS
    from mpibwa_tpu_torch.ops import seeding as TS

    jfm, tfm = fms
    q, lens = batch
    q = q.copy()
    q[5, 20:23] = 4
    rng = np.random.default_rng(6)
    B = len(q)
    starts = rng.integers(0, q.shape[1] + 2, B).astype(np.int32)
    starts[5] = 21
    minv = rng.integers(1, 4, B).astype(np.int64)
    got = TS.forward_pass(tfm, _t(q), _t(lens), _t(minv), False, _t(starts))
    want = JS.forward_pass(jfm, jnp.asarray(q), jnp.asarray(lens),
                           jnp.asarray(minv), False, jnp.asarray(starts))
    _assert_tuple_equal(got, want)


def test_forward_p3(fms, batch):
    import jax.numpy as jnp

    from mpibwa_tpu.ops import seeding as JS
    from mpibwa_tpu_torch.ops import seeding as TS

    jfm, tfm = fms
    q, lens = batch
    B = len(q)
    opt = mem_opt_init()
    gf, gp = TS.forward_p3(tfm, _t(q), _t(lens),
                           torch.ones(B, dtype=torch.int64),
                           opt.min_seed_len, opt.max_mem_intv)
    wf, wp = JS.forward_p3(jfm, jnp.asarray(q), jnp.asarray(lens),
                           jnp.ones(B, jnp.int64), opt.min_seed_len,
                           opt.max_mem_intv)
    _assert_tuple_equal(gf, wf)
    _assert_tuple_equal(gp, wp)
    assert int(gp.n_seeds.sum()) > 0  # pass 3 emitted seeds


def _lane_tables(fwd_np, B):
    """Pass-1 backward lane tables as DeviceSeeder builds them:
    (lane_row, lane_tbl, x0, minv, E, n_lanes)."""
    n_calls = np.minimum(fwd_np["n_calls"], 48)
    rows = [(b, fwd_np["call_start"][b, c], fwd_np["call_len"][b, c],
             fwd_np["call_x"][b, c]) for b in range(B)
            for c in range(n_calls[b])]
    arr = np.array(rows, np.int64)
    N = len(arr)
    NLp = 256
    while NLp < N:
        NLp <<= 2
    lane_row = np.zeros(NLp, np.int32)
    lane_tbl = np.zeros((NLp, 3), np.int32)
    x0 = np.zeros(NLp, np.int32)
    lane_row[:N], lane_tbl[:N, 0], lane_tbl[:N, 1] = arr[:, 0], arr[:, 1], \
        arr[:, 2]
    lane_tbl[1:N, 2] = np.cumsum(arr[:-1, 2])
    lane_tbl[N:, 2] = arr[:, 2].sum()
    x0[:N] = arr[:, 3]
    E = 256
    while E < arr[:, 2].sum():
        E <<= 2
    return lane_row, lane_tbl, x0, np.ones(NLp, np.int64), E, NLp


@pytest.mark.parametrize("m_cap", [16, 2], ids=["mcap16", "mcap2"])
def test_assemble_and_run_backward_flat(fms, batch, m_cap, monkeypatch):
    """Flat entries assembled on the device, then the backward engine with
    compaction forced in the port (small finish capacity): same entries,
    same per-lane mems and overflow flags; M_CAP=2 drives lanes into
    overflow in both packages."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops import seeding as JS
    from mpibwa_tpu.ops import seeding_flat as JSF
    from mpibwa_tpu_torch.ops import seeding_flat as TSF

    monkeypatch.setattr(JSF, "M_CAP", m_cap)
    monkeypatch.setattr(TSF, "M_CAP", m_cap)
    monkeypatch.setattr(TSF, "FINISH_CAP", 256)
    jfm, tfm = fms
    q, lens = batch
    B = len(q)
    fwd = JS.forward_pass(jfm, jnp.asarray(q), jnp.asarray(lens),
                          jnp.ones(B, jnp.int64), True)
    fwd_np = {k: np.asarray(v) for k, v in fwd._asdict().items()}
    lane_row, lane_tbl, x0, minv, E, NL = _lane_tables(fwd_np, B)
    want = JSF.assemble_entries(fwd.ivals, fwd.infos, jnp.asarray(lane_row),
                                jnp.asarray(lane_tbl), E)
    got = TSF.assemble_entries(_t(fwd_np["ivals"]), _t(fwd_np["infos"]),
                               _t(lane_row), _t(lane_tbl), E)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert E > 256  # the port compacts at least once
    qrows = q[lane_row]
    jm, jov = JSF.run_backward_flat(jfm, jnp.asarray(qrows), want, NL, x0,
                                    minv)
    stats = {}
    tm, tov = TSF.run_backward_flat(tfm, _t(qrows), got, NL, x0, minv,
                                    stats=stats)
    assert tm == jm
    np.testing.assert_array_equal(tov, jov)
    assert stats["bwd_segments"] >= 2
    assert sum(map(len, tm)) > 0
    if m_cap == 2:
        assert tov.any()
