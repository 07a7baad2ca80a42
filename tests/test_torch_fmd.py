"""Torch DeviceFMIndex (mpibwa_tpu_torch/ops/fmd.py) vs the JAX
DeviceFMIndex and the scalar core FMIndex, on the synthetic toy genome, in
the int32 and the forced int64 position paths. Integer outputs: exact
equality."""

import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401
from mpibwa_tpu.core.fm import FMIndex
from mpibwa_tpu.index.format import load_index

torch.set_num_threads(1)  # test workers run in parallel on few cores

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    paths = toy.build_toy(str(tmp_path_factory.mktemp("toy")))
    return load_index(paths["ref"])


@pytest.fixture(scope="module")
def fm(index):
    return FMIndex.from_index(index)


@pytest.fixture(scope="module", params=[False, True], ids=["i32", "i64"])
def pair(request, index):
    """(JAX DeviceFMIndex, torch DeviceFMIndex) for one position dtype."""
    from mpibwa_tpu.ops.fmd import DeviceFMIndex as JaxFM
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    wide = request.param
    return (JaxFM(index, force_wide=wide),
            DeviceFMIndex(index, CPU, force_wide=wide))


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


def test_position_dtype(pair):
    jfm, tfm = pair
    assert tfm.np_idt == jfm.np_idt
    assert tfm.L2.dtype == tfm.sa.dtype == tfm.idt


def test_o2_table_matches_jax(pair):
    jfm, tfm = pair
    np.testing.assert_array_equal(tfm.o2_tables().numpy(),
                                  np.asarray(jfm.o2_tables()))


def test_from_numpy_matches_constructor(pair):
    """The state carried across from the JAX index builds the same
    tensors as the port's own constructor."""
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    jfm, tfm = pair
    state = {"_o2": np.asarray(jfm._o2), "L2": np.asarray(jfm.L2),
             "sa": np.asarray(jfm.sa), "pac": np.asarray(jfm.pac),
             "primary": jfm.primary, "seq_len": jfm.seq_len,
             "sa_intv": jfm.sa_intv, "l_pac": jfm.l_pac, "idt": jfm.np_idt}
    got = DeviceFMIndex.from_numpy(state, CPU)
    for name in ("_o2", "L2", "sa", "pac"):
        a, b = getattr(got, name), getattr(tfm, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    for name in ("primary", "seq_len", "sa_intv", "l_pac", "idt"):
        assert getattr(got, name) == getattr(tfm, name), name


def test_occ4_16(pair, fm, index):
    import jax.numpy as jnp

    jfm, tfm = pair
    ks = np.arange(-1, index.seq_len + 1, 97, dtype=np.int64)
    ks = np.concatenate([ks, [index.primary - 1, index.primary,
                              index.primary + 1, index.seq_len]])
    got = tfm.occ4_16(_t(ks.astype(tfm.np_idt))).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jfm.occ4_16(jnp.asarray(ks.astype(jfm.np_idt)))))
    np.testing.assert_array_equal(got, fm.occ4_batch(ks))


def _random_intervals(rng, fm, n):
    """Valid bidirectional intervals: random 1- to 6-mers grown with the
    scalar engine (kept only while non-empty)."""
    iks = []
    while len(iks) < n:
        ik = fm.set_intv(int(rng.integers(4)))
        for _ in range(int(rng.integers(0, 6))):
            nxt = fm.extend(ik, int(rng.integers(2)))[int(rng.integers(4))]
            if nxt[2] <= 0:
                break
            ik = nxt
        iks.append(ik)
    return np.array(iks, np.int64)


def test_extend_both_directions(pair, fm):
    import jax.numpy as jnp

    jfm, tfm = pair
    iks = _random_intervals(np.random.default_rng(3), fm, 200)
    for is_back in (0, 1):
        got = tfm.extend(_t(iks.astype(tfm.np_idt)), is_back).numpy()
        want = np.asarray(jfm.extend(jnp.asarray(iks.astype(jfm.np_idt)),
                                     is_back))
        np.testing.assert_array_equal(got, want)
        for i in range(0, len(iks), 17):
            np.testing.assert_array_equal(got[i], fm.extend(iks[i], is_back))


def test_extend1_fwd_is_row_of_extend(pair, fm):
    import jax.numpy as jnp

    jfm, tfm = pair
    rng = np.random.default_rng(4)
    iks = _random_intervals(rng, fm, 256)
    cb = rng.integers(0, 4, len(iks)).astype(np.int32)
    cols = [iks[:, k].astype(tfm.np_idt) for k in range(3)]
    got = tfm.extend1_fwd(*[_t(c) for c in cols], _t(cb))
    want = jfm.extend1_fwd(*[jnp.asarray(c) for c in cols], jnp.asarray(cb))
    full = tfm.extend(_t(iks.astype(tfm.np_idt)), 0).numpy()
    for k in range(3):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[k].numpy(),
                                      full[np.arange(len(cb)), cb, k])


def test_set_intv(pair):
    import jax.numpy as jnp

    jfm, tfm = pair
    c = np.array([0, 1, 2, 3, 2, 0], np.int32)
    np.testing.assert_array_equal(tfm.set_intv(_t(c)).numpy(),
                                  np.asarray(jfm.set_intv(jnp.asarray(c))))


def test_ref_base(pair, index):
    import jax.numpy as jnp

    jfm, tfm = pair
    n = 2 * index.l_pac
    pos = np.concatenate([np.arange(-3, n + 3, 41),
                          [index.l_pac - 1, index.l_pac, n - 1]])
    got = tfm.ref_base(_t(pos.astype(np.int64))).numpy()
    want = np.asarray(jfm.ref_base(jnp.asarray(pos.astype(np.int64))))
    np.testing.assert_array_equal(got, want)


def test_sa_lookup(pair, fm, index):
    import jax.numpy as jnp

    jfm, tfm = pair
    ks = np.arange(0, index.seq_len + 1, 53, dtype=np.int64)
    got = tfm.sa_lookup(_t(ks)).numpy()
    assert got.dtype == tfm.np_idt
    np.testing.assert_array_equal(got, np.asarray(jfm.sa_lookup(
        jnp.asarray(ks))))
    want = np.array([np.uint64(fm.sa_lookup(int(k))) for k in ks[::7]],
                    np.uint64)
    np.testing.assert_array_equal(got[::7].astype(np.uint64), want)


def test_o2_helpers_match_jax(index):
    """build_o2, the rank arithmetic _count_prefix/_occ_c2 (uint32 SWAR
    held in int64) and cap_bucket against their JAX originals."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops import backward8 as JB
    from mpibwa_tpu_torch.ops import backward8 as TB

    o2 = TB.build_o2(index.bwt)
    np.testing.assert_array_equal(o2, np.asarray(JB.build_o2(index.bwt)))
    rng = np.random.default_rng(5)
    words = rng.integers(-2**31, 2**31, 512).astype(np.int32)
    words[:4] = [-1, 0, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    c = rng.integers(0, 4, 512).astype(np.int32)
    within = rng.integers(0, 16, 512).astype(np.int32)
    np.testing.assert_array_equal(
        TB._count_prefix(_t(words), _t(c), _t(within)).numpy(),
        np.asarray(JB._count_prefix(jnp.asarray(words), jnp.asarray(c),
                                    jnp.asarray(within))))
    ks = np.concatenate([[-1], rng.integers(0, index.seq_len + 1, 300)])
    np.testing.assert_array_equal(
        TB._occ_c2(_t(o2), index.primary, _t(ks.astype(np.int64)),
                   _t(c[: len(ks)])).numpy(),
        np.asarray(JB._occ_c2(jnp.asarray(o2), index.primary,
                              jnp.asarray(ks.astype(np.int64)),
                              jnp.asarray(c[: len(ks)]))))
    for n in (1, 8191, 8192, 8193, 12289, 20000, 1 << 20):
        assert TB.cap_bucket(n) == JB.cap_bucket(n)
        assert TB.cap_bucket(n, 1024) == JB.cap_bucket(n, 1024)
