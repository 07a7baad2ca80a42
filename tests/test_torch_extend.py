"""The port's extension DP (mpibwa_tpu_torch/ops/extend_batch.py and the
kernel wrapper ops/extend_cuda.py) vs the JAX extend_batch, the JAX Pallas
kernel run in interpret mode, the scalar spec and the dp_extend goldens.
Integer outputs: exact equality.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
checked against the plain version by the test marked ``gpu`` (skipped
without a card) and by chip_smoke.py."""

import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401
from mpibwa_tpu.core import extend as X
from mpibwa_tpu.core.opts import fill_scmat
from mpibwa_tpu.index.format import NT4_TABLE, load_index
from mpibwa_tpu_torch.ops import extend_batch as TE
from mpibwa_tpu_torch.ops.extend_cuda import extend_batch_kernel

torch.set_num_threads(1)  # test workers run in parallel on few cores


MAT = fill_scmat(1, 4).reshape(5, 5).astype(np.int32)
PEN = (6, 1, 6, 1)
# every Q bucket and every T bucket of DeviceAligner at least once
BUCKETS = [(64, 128), (128, 256), (192, 384), (256, 512), (512, 768),
           (512, 1024)]


def _problems(rng, B, Q, T):
    """Random problems in one (Q, T) window: targets share a prefix with
    the query (5% substitutions, some N) so the DP runs long bands."""
    q = rng.integers(0, 4, (B, Q)).astype(np.uint8)
    t = rng.integers(0, 4, (B, T)).astype(np.uint8)
    n = min(Q, T)
    t[:, :n] = q[:, :n]
    mut = rng.random((B, T)) < 0.05
    t[mut] = rng.integers(0, 5, int(mut.sum()))
    ql = rng.integers(1, Q + 1, B).astype(np.int32)
    tl = rng.integers(0, T + 1, B).astype(np.int32)
    ql[:2], tl[:2] = Q, T  # full windows
    tl[2] = 0  # an empty target
    for b in range(B):
        q[b, ql[b]:] = 4
        t[b, tl[b]:] = 4
    par = np.stack([rng.integers(1, 120, B), rng.choice([0, 5], B),
                    rng.choice([0, 100], B), rng.integers(1, 80, B)],
                   axis=1).astype(np.int32)
    return q, t, ql, tl, par


def _torch_out(out):
    return np.stack([o.numpy() for o in out], axis=1)


def _jax_out(out):
    return np.stack([np.asarray(o) for o in out], axis=1)


@pytest.mark.parametrize("Q,T", BUCKETS)
def test_plain_matches_jax_extend_batch(Q, T):
    import jax.numpy as jnp

    from mpibwa_tpu.ops.extend_batch import extend_batch as jax_extend

    q, t, ql, tl, par = _problems(np.random.default_rng(Q * 7 + T), 24, Q, T)
    got = _torch_out(TE.extend_batch(*map(torch.from_numpy, (q, t, ql, tl,
                                                              par)),
                                     torch.from_numpy(MAT), *PEN))
    want = _jax_out(jax_extend(*map(jnp.asarray, (q, t, ql, tl, par, MAT)),
                               *PEN))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("Q,T", [(64, 128), (128, 256)])
def test_plain_matches_pallas_interpret(Q, T):
    """Against the TPU kernel itself, run the way the JAX tests run it on
    the CPU (interpret mode)."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops.pallas_extend import extend_batch_via_pallas

    q, t, ql, tl, par = _problems(np.random.default_rng(Q + T), 40, Q, T)
    got = _torch_out(TE.extend_batch(*map(torch.from_numpy, (q, t, ql, tl,
                                                              par)),
                                     torch.from_numpy(MAT), *PEN))
    want = _jax_out(extend_batch_via_pallas(
        *map(jnp.asarray, (q, t, ql, tl, par)), MAT, *PEN, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_wrapper_on_cpu_matches_goldens_without_launching(golden_dir):
    """The wrapper on CPU tensors runs the plain version (no kernel
    launch) and reproduces the bwa oracle's ksw_extend2 outputs."""
    nt4 = lambda s: NT4_TABLE[np.frombuffer(s.encode(), np.uint8)]  # noqa
    probs = (golden_dir / "dp_extend.txt").read_text().splitlines()
    want = np.array([[int(v) for v in ln.split()] for ln in
                     (golden_dir / "dp_extend.out").read_text().splitlines()])
    rows = [p.split() for p in probs]
    qs = [nt4(r[4]) for r in rows]
    ts = [nt4(r[5]) for r in rows]
    B, Q, T = len(rows), max(map(len, qs)), max(map(len, ts))
    q = np.full((B, Q), 4, np.uint8)
    t = np.full((B, T), 4, np.uint8)
    for i in range(B):
        q[i, : len(qs[i])] = qs[i]
        t[i, : len(ts[i])] = ts[i]
    ql = np.array([len(s) for s in qs], np.int32)
    tl = np.array([len(s) for s in ts], np.int32)
    par = np.array([[int(v) for v in r[:4]] for r in rows], np.int32)
    before = extend_batch_kernel.launches
    got = _torch_out(extend_batch_kernel(
        *map(torch.from_numpy, (q, t, ql, tl, par)), torch.from_numpy(MAT),
        *PEN))
    assert extend_batch_kernel.launches == before
    np.testing.assert_array_equal(got, want)


def test_nonstandard_matrix_matches_scalar():
    """Any 5x5 matrix goes through the same code (no standard-matrix
    shortcut): check an asymmetric one against the scalar spec."""
    rng = np.random.default_rng(9)
    mat = rng.integers(-5, 4, (5, 5)).astype(np.int32)
    mat[np.arange(4), np.arange(4)] = rng.integers(1, 4, 4)
    q, t, ql, tl, par = _problems(rng, 32, 64, 128)
    got = _torch_out(extend_batch_kernel(
        *map(torch.from_numpy, (q, t, ql, tl, par)), torch.from_numpy(mat),
        5, 2, 4, 1))
    for b in range(32):
        want = X.ksw_extend2(q[b, : ql[b]], t[b, : tl[b]], mat.ravel(), 5,
                             2, 4, 1, *[int(v) for v in par[b]])
        assert tuple(got[b]) == want, b


def test_band_limit_trunc_equals_float_cast():
    """ksw.c's (int)((n) / e + 1.) (the JAX float64 formulation) and the
    port's truncating integer division agree once clamped to 1, negative
    numerators included."""
    n = torch.arange(-40, 41, dtype=torch.int32)
    for e in (1, 2, 3, 7):
        got = TE.band_limit(n, 1, torch.zeros_like(n), 0, e)
        want = np.maximum((n.numpy().astype(np.float64) / e + 1.0)
                          .astype(np.int32), 1)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (torch.div(n, e, rounding_mode="trunc").numpy()
                == np.trunc(n.numpy() / e)).all()


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((4, 64), dtype=torch.uint8)
    t = torch.zeros((4, 128), dtype=torch.uint8)
    lens = torch.ones(4, dtype=torch.int32)
    par = torch.ones((4, 4), dtype=torch.int32)
    mat = torch.from_numpy(MAT)
    with pytest.raises(TypeError):
        extend_batch_kernel(q.int(), t, lens, lens, par, mat, *PEN)
    with pytest.raises(TypeError):
        extend_batch_kernel(q, t, lens.long(), lens, par, mat, *PEN)
    with pytest.raises(ValueError):
        extend_batch_kernel(torch.zeros((4, 576), dtype=torch.uint8), t,
                            lens, lens, par, mat, *PEN)
    with pytest.raises(ValueError):
        extend_batch_kernel(q, t, lens, lens, par.t().contiguous().t(), mat,
                            *PEN)


@pytest.fixture(scope="module")
def toy_index(tmp_path_factory):
    paths = toy.build_toy(str(tmp_path_factory.mktemp("toy")))
    return load_index(paths["ref"])


def test_extend_from_coords_matches_jax(toy_index):
    """Windows built on the device from read rows and the packed
    reference (both strands, left and right extensions) give JAX's
    results."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops.extend_batch import extend_from_coords as jax_efc
    from mpibwa_tpu.ops.fmd import DeviceFMIndex as JaxFM
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    rng = np.random.default_rng(11)
    NR, L, B, Q, T = 8, 101, 48, 128, 256
    qd = rng.integers(0, 4, (NR, L)).astype(np.uint8)
    qd[3, 40:45] = 4
    n2 = 2 * toy_index.l_pac
    coords = np.stack([rng.integers(0, NR, B), rng.integers(0, 40, B),
                       rng.integers(1, 61, B), rng.integers(0, 2, B),
                       rng.integers(T, n2 - T, B), rng.integers(0, T + 1, B)],
                      axis=1).astype(np.int64)
    coords[:4, 4] = [toy_index.l_pac - 5, toy_index.l_pac + 5, 3, n2 - 3]
    par = np.stack([np.full(B, 100), np.full(B, 5), np.full(B, 100),
                    rng.integers(1, 60, B)], axis=1).astype(np.int32)
    got = _torch_out(TE.extend_from_coords(
        DeviceFMIndex(toy_index, torch.device("cpu")), torch.from_numpy(qd),
        torch.from_numpy(coords), Q, T, torch.from_numpy(par), *PEN,
        torch.from_numpy(MAT)))
    want = _jax_out(jax_efc(JaxFM(toy_index), jnp.asarray(qd),
                            jnp.asarray(coords), Q, T, jnp.asarray(par),
                            *PEN, None, jnp.asarray(MAT)))
    np.testing.assert_array_equal(got, want)


def _edge_case(name):
    return next(c for c in toy.extend_edge_cases(5) if c["name"] == name)


def _edge_args(c):
    return [torch.from_numpy(c[k]) for k in ("q", "t", "qlens", "tlens",
                                            "params", "mat")]


@pytest.mark.parametrize("name", toy.EXT_CASES)
def test_plain_matches_jax_on_edge_cases(name):
    """The plain version on the edge cases: against the Pallas kernel in
    interpret mode where the matrix is bwa's standard one, else against the
    scalar spec problem by problem."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops.pallas_extend import (extend_batch_via_pallas,
                                              standard_mat_ab)

    c = _edge_case(name)
    got = _torch_out(TE.extend_batch(*_edge_args(c), *c["pen"]))
    if standard_mat_ab(c["mat"]) is not None:
        want = _jax_out(extend_batch_via_pallas(
            *map(jnp.asarray, (c["q"], c["t"], c["qlens"], c["tlens"],
                               c["params"])), c["mat"], *c["pen"],
            interpret=True))
    else:
        want = np.array([X.ksw_extend2(
            c["q"][b, : c["qlens"][b]], c["t"][b, : c["tlens"][b]],
            c["mat"].ravel(), *c["pen"], *[int(v) for v in c["params"][b]])
            for b in range(len(c["qlens"]))])
    np.testing.assert_array_equal(got, want)


# -- a model of the kernel's warp -------------------------------------------

LADDER = (1, 2, 3, 4, 5, 7, 9, 13, 17)  # columns a lane, csrc/extend.cu


def _shfl_up(x, d):
    """__shfl_up_sync over the 32 lanes: lanes below d keep their value."""
    return np.concatenate([x[:d], x[:-d]])


def _warp_model(q, t, qlen, tlen, par, mat, pen, C):
    """numpy model of one warp of csrc/extend.cu with C columns a lane:
    slots in a (32, C) layout, lane L holding columns L*C .. L*C+C-1; per
    row the masked cell update, the in-lane decayed max scan and its 5-step
    shuffle scan over the lane aggregates, the row maximum with ties to the
    highest column (warp max, ballot of the lanes at it, highest lane), the
    shift of H by one column, and the band trims as warp min/max over each
    lane's first and last nonzero slot. Returns ksw_extend2's six
    outputs."""
    o_del, e_del, o_ins, e_ins = pen
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    w, end_bonus, zdrop, h0 = (int(v) for v in par)
    mat = np.asarray(mat, np.int64).reshape(25)
    lane = np.arange(32)
    j = lane[:, None] * C + np.arange(C)[None, :]
    qpad = np.full(32 * C, 4, np.int64)
    qpad[:qlen] = q[:qlen]
    qb = qpad[j]
    v1 = h0 - oe_ins if h0 > oe_ins else 0
    vprev = v1 - (j - 2) * e_ins
    vmin = vprev if e_ins > 0 else np.full_like(j, v1)
    H = np.where(j == 0, h0, np.where(
        j == 1, v1 if qlen >= 1 else 0,
        np.where((j <= qlen) & (vmin > e_ins), vprev - e_ins, 0)))
    E = np.zeros_like(H)
    mmax = int(mat.max())
    w = min(w, max(int((qlen * mmax + end_bonus - o_ins) / e_ins + 1.0), 1))
    w = min(w, max(int((qlen * mmax + end_bonus - o_del) / e_del + 1.0), 1))
    maxv, max_i, max_j, max_ie, gscore, max_off = h0, -1, -1, -1, -1, 0
    beg, end = 0, qlen
    for i in range(tlen):
        beg = max(beg, i - w)
        end = min(end, i + w + 1, qlen)
        if beg >= end:
            break
        row = mat[5 * int(t[i]): 5 * int(t[i]) + 5]
        h1_first = max(h0 - (o_del + e_del * (i + 1)), 0) if beg == 0 else 0
        band = (j >= beg) & (j < end)
        m = np.where(H != 0, H + row[qb], 0)
        tv = np.where(band, np.maximum(m - oe_ins, 0), 0)
        E_old = E
        H = np.where(band, np.maximum(m, E_old), H)
        E = np.where(band, np.maximum(np.maximum(m - oe_del, 0),
                                      E_old - e_del), E_old)
        g = np.empty_like(tv)
        g[:, 0] = tv[:, 0]
        for c in range(1, C):
            g[:, c] = np.maximum(tv[:, c], g[:, c - 1] - e_ins)
        s = g[:, -1].copy()
        for d in (1, 2, 4, 8, 16):
            s = np.where(lane >= d, np.maximum(s, _shfl_up(s, d)
                                               - d * C * e_ins), s)
        pre = _shfl_up(s, 1)
        pre[0] = 0
        F = np.concatenate(
            [pre[:, None], np.maximum(g[:, :-1], pre[:, None]
                                      - np.arange(1, C)[None, :] * e_ins)],
            axis=1)
        H = np.where(band, np.maximum(H, F), H)
        hb = np.where(band, H, -1)
        best = hb.max(axis=1)
        bj = np.array([j[L, np.nonzero(hb[L] == best[L])[0][-1]]
                       for L in range(32)])
        mrun = int(best.max())
        owner = int(np.nonzero(best == mrun)[0][-1])
        mj = int(bj[owner])
        h1_last = int(H[(end - 1) // C, (end - 1) % C])
        left = _shfl_up(H[:, C - 1], 1)
        prev = np.concatenate([left[:, None], H[:, :-1]], axis=1)
        H = np.where(j == beg, h1_first,
                     np.where((j > beg) & (j <= end), prev, H))
        E = np.where(j == end, 0, E)
        if end == qlen and gscore <= h1_last:
            max_ie = i
            gscore = max(gscore, h1_last)
        if mrun == 0:
            break
        if mrun > maxv:
            maxv, max_i, max_j = mrun, i, mj
            max_off = max(max_off, abs(mj - i))
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if maxv - mrun - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            elif maxv - mrun - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                break
        nz = (H | E) != 0
        lo = np.where(nz & (j >= beg) & (j < end), j, np.iinfo(np.int32).max
                      ).min(axis=1).min()
        hi = np.where(nz & (j >= beg) & (j <= end), j, -1).max(axis=1).max()
        beg = min(int(lo), end)
        last = int(hi) if hi >= beg else beg - 1
        end = min(last + 2, qlen)
    return maxv, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off


def _model_cases():
    rng = np.random.default_rng(21)
    yield from ((c["name"], c) for c in toy.extend_edge_cases(5))
    for Q, T in BUCKETS:
        q, t, ql, tl, par = _problems(rng, 6, Q, T)
        yield f"random_{Q}x{T}", {"q": q, "t": t, "qlens": ql, "tlens": tl,
                                  "params": par, "mat": MAT, "pen": PEN}


@pytest.mark.parametrize("name", [n for n, _ in _model_cases()])
def test_warp_model_matches_ksw_extend2(name):
    """The kernel's design, as a numpy model of its warp, equals the scalar
    spec on the edge cases and on random problems of every bucket, at the
    problem's own C and at the largest (17 columns a lane)."""
    c = dict(_model_cases())[name]
    for b in range(len(c["qlens"])):
        qlen, tlen = int(c["qlens"][b]), int(c["tlens"][b])
        want = X.ksw_extend2(c["q"][b, :qlen], c["t"][b, :tlen],
                             c["mat"].ravel(), *c["pen"],
                             *[int(v) for v in c["params"][b]])
        own = next(C for C in LADDER if C >= qlen // 32 + 1)
        for C in sorted({own, 17}):
            got = _warp_model(c["q"][b], c["t"][b], qlen, tlen,
                              c["params"][b], c["mat"], c["pen"], C)
            assert got == want, (b, C)


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu():
    """The CUDA kernel equals the plain version on the card, at every
    window bucket and on the edge cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    dev = torch.device("cuda")
    mat = torch.from_numpy(MAT).to(dev)
    cases = [([torch.from_numpy(a).to(dev) for a in
               _problems(np.random.default_rng(Q + T), 512, Q, T)] + [mat],
              PEN, (Q, T)) for Q, T in BUCKETS]
    cases += [([a.to(dev) for a in _edge_args(c)], c["pen"], c["name"])
              for c in toy.extend_edge_cases(5)]
    for args, pen, tag in cases:
        before = extend_batch_kernel.launches
        got = torch.stack(list(extend_batch_kernel(*args, *pen)))
        torch.cuda.synchronize()
        assert extend_batch_kernel.launches == before + 1
        want = torch.stack(list(TE.extend_batch(*args, *pen)))
        assert torch.equal(got, want), tag
