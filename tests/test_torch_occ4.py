"""The port's block-layout FM path (mpibwa_tpu_torch/ops/fmd.py ``occ4``
and ``fused_blocks``, ops/occ4_cuda.py) vs the JAX package on the toy
index: the plain version ``extend_blocks`` against the Pallas kernel
``extend_pallas`` in interpret mode and against both packages'
``DeviceFMIndex.extend``, the MPIBWA_PALLAS=1 routing, and `cli mem` under
the knob. Integers throughout: every comparison is exact (tolerance 0).
The CUDA kernel itself runs only on a card (the test marked ``gpu``)."""


import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401
from mpibwa_tpu.index.format import load_index

torch.set_num_threads(1)  # test workers run in parallel on few cores


CPU = torch.device("cpu")
E = 2048  # two grid blocks of the Pallas kernel


@pytest.fixture(scope="module")
def toy_paths(tmp_path_factory):
    return toy.build_toy(str(tmp_path_factory.mktemp("toy")), n_pairs=200)


@pytest.fixture(scope="module")
def fms(toy_paths):
    from mpibwa_tpu.ops.fmd import DeviceFMIndex as JaxFM
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    idx = load_index(toy_paths["ref"])
    jfm = JaxFM(idx)
    # lazy tables: touched on the host before any jitted call
    jfm.occ, jfm.data
    return jfm, DeviceFMIndex(idx, CPU)


def intervals(fm, n: int, seed: int) -> np.ndarray:
    """(n, 3) int32 bi-intervals inside the BWT: x2 >= 1 and both ends in
    [0, seq_len]; with rows that hit the sentinel position (x = 0), rows
    that span ``primary``, rows that end on it and rows of size 1."""
    rng = np.random.default_rng(seed)
    x2 = rng.integers(1, 200, n)
    x2[: n // 8] = 1
    hi = fm.seq_len + 1 - x2
    x0 = rng.integers(0, hi + 1)
    x1 = rng.integers(0, hi + 1)
    x0[:4] = x1[4:8] = 0
    for j, d in enumerate(range(-3, 4)):  # around the sentinel's position
        x0[8 + j] = x1[16 + j] = fm.primary + d
        x2[8 + j] = x2[16 + j] = 3
    x0[24] = x1[25] = fm.primary
    x2[24] = x2[25] = 1
    x0[26] = x1[27] = fm.seq_len
    x2[26] = x2[27] = 1
    return np.stack([x0, x1, x2], axis=1).astype(np.int32)


@pytest.mark.parametrize("is_back", [1, 0], ids=["back", "fwd"])
def test_extend_blocks_equals_pallas_kernel_interpret(fms, is_back):
    import jax.numpy as jnp

    from mpibwa_tpu.ops.pallas_occ4 import extend_pallas
    from mpibwa_tpu_torch.ops.occ4_cuda import extend_blocks

    jfm, tfm = fms
    ik = intervals(tfm, E, 3)
    want = np.asarray(extend_pallas(jfm, jnp.asarray(ik), is_back, True))
    got = extend_blocks(tfm, torch.from_numpy(ik), is_back)
    assert got.dtype == torch.int32 and got.shape == (E, 4, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def _block(fm, pos):
    """The 128-bp block of the stored bases that BWT position pos counts
    in (the sentinel is not stored)."""
    return (pos - (pos >= fm.primary)) >> 7


@pytest.mark.parametrize("name", toy.OCC4_CASES)
def test_extend_blocks_equals_pallas_kernel_on_edge_cases(fms, name):
    """The plain version against the Pallas kernel in interpret mode on
    intervals that corner the kernel's block reads, both directions."""
    import jax.numpy as jnp

    from mpibwa_tpu.ops.pallas_occ4 import extend_pallas
    from mpibwa_tpu_torch.ops.occ4_cuda import extend_blocks

    jfm, tfm = fms
    ik = toy.occ4_edge_intervals(tfm, 9)[name]
    half = len(ik) // 2  # x0 carries the pattern, then x1
    k = np.concatenate([ik[:half, 0], ik[half:, 1]]).astype(np.int64) - 1
    ends = (_block(tfm, k), _block(tfm, k + ik[:, 2]))
    if name == "one_block":
        assert (ends[0] == ends[1]).all()
    if name == "adjacent_blocks":
        assert (ends[0] + 1 == ends[1]).all()
    for is_back in (1, 0):
        want = np.asarray(extend_pallas(jfm, jnp.asarray(ik), is_back, True))
        got = extend_blocks(tfm, torch.from_numpy(ik), is_back)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("is_back", [1, 0], ids=["back", "fwd"])
def test_extend_blocks_equals_extend_of_both_packages(fms, is_back,
                                                      monkeypatch):
    import jax.numpy as jnp

    from mpibwa_tpu_torch.ops.occ4_cuda import extend_blocks

    monkeypatch.delenv("MPIBWA_PALLAS", raising=False)
    jfm, tfm = fms
    ik = intervals(tfm, 1000, 4)  # no multiple of any block size
    got = extend_blocks(tfm, torch.from_numpy(ik), is_back).numpy()
    np.testing.assert_array_equal(
        got, tfm.extend(torch.from_numpy(ik), is_back).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jfm.extend(jnp.asarray(ik), is_back)))


def test_extend_blocks_equals_scalar_engine(fms, toy_paths):
    from mpibwa_tpu_torch.core.fm import FMIndex
    from mpibwa_tpu_torch.ops.occ4_cuda import extend_blocks

    _, tfm = fms
    fm = FMIndex.from_index(load_index(toy_paths["ref"]))
    ik = intervals(tfm, 64, 5)
    for is_back in (0, 1):
        got = extend_blocks(tfm, torch.from_numpy(ik), is_back).numpy()
        for row, g in zip(ik, got):
            np.testing.assert_array_equal(
                g, np.array(fm.extend(tuple(int(v) for v in row), is_back)))


def test_occ4_block_scan_equals_jax_and_o2(fms):
    import jax.numpy as jnp

    jfm, tfm = fms
    ks = np.concatenate([
        np.arange(-1, tfm.seq_len + 1, 97),
        np.arange(tfm.primary - 130, tfm.primary + 130),
        [tfm.seq_len]]).astype(np.int32)
    got = tfm.occ4(torch.from_numpy(ks))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfm.occ4(jnp.asarray(ks))))
    np.testing.assert_array_equal(got.numpy(),
                                  tfm.occ4_16(torch.from_numpy(ks)).numpy())
    # 2-D batches keep their shape
    k2 = torch.from_numpy(ks[:64].reshape(8, 8))
    assert torch.equal(tfm.occ4(k2), got[:64].reshape(8, 8, 4))


def test_from_numpy_carries_the_block_tables(fms):
    """The JAX index pulled to the host and loaded into the port: the fused
    table equals the JAX package's own, and extension agrees."""
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.ops.occ4_cuda import extend_blocks

    jfm, tfm = fms
    state = {"_o2": np.asarray(jfm.o2_tables()), "L2": np.asarray(jfm.L2),
             "sa": np.asarray(jfm.sa), "pac": np.asarray(jfm.pac),
             "occ": np.asarray(jfm.occ), "data": np.asarray(jfm.data),
             "primary": jfm.primary, "seq_len": jfm.seq_len,
             "sa_intv": jfm.sa_intv, "l_pac": jfm.l_pac, "idt": jfm.np_idt}
    loaded = DeviceFMIndex.from_numpy(state, CPU)
    fused = loaded.fused_blocks()
    assert fused.dtype == torch.int32 and fused.shape[1] == 12
    np.testing.assert_array_equal(fused.numpy(),
                                  np.asarray(jfm.fused_blocks()))
    assert torch.equal(fused, tfm.fused_blocks())
    assert loaded.fused_blocks() is fused  # uploaded once
    ik = torch.from_numpy(intervals(tfm, 256, 6))
    assert torch.equal(extend_blocks(loaded, ik, 1),
                       extend_blocks(tfm, ik, 1))


def test_block_tables_need_the_int32_path(toy_paths):
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.ops.occ4_cuda import extend_kernel

    idx = load_index(toy_paths["ref"])
    wide = DeviceFMIndex(idx, CPU, force_wide=True)
    with pytest.raises(ValueError, match="int32"):
        wide.fused_blocks()
    with pytest.raises(TypeError, match="int32"):
        extend_kernel(wide, torch.zeros((4, 3), dtype=torch.int64), 1)
    bare = DeviceFMIndex.from_numpy(
        {"_o2": np.zeros((4, 2), np.int32), "L2": np.zeros(5, np.int32),
         "sa": np.zeros(1, np.int32), "pac": np.zeros(1, np.uint8),
         "primary": 0, "seq_len": 0, "sa_intv": 1, "l_pac": 0,
         "idt": np.int32}, CPU)
    with pytest.raises(ValueError, match="block tables"):
        bare.fused_blocks()


def test_wrapper_checks_its_arguments(fms):
    from mpibwa_tpu_torch.ops.occ4_cuda import extend_blocks, extend_kernel

    _, tfm = fms
    ik = torch.from_numpy(intervals(tfm, 40, 7))
    # on a CPU tensor the wrapper is the plain version, and counts nothing
    before = extend_kernel.launches
    assert torch.equal(extend_kernel(tfm, ik, 0), extend_blocks(tfm, ik, 0))
    assert extend_kernel.launches == before
    assert extend_kernel(tfm, ik[:0], 1).shape == (0, 4, 3)
    with pytest.raises(TypeError):
        extend_kernel(tfm, ik.long(), 1)
    with pytest.raises(ValueError):
        extend_kernel(tfm, ik.reshape(4, 10, 3), 1)
    with pytest.raises(ValueError):
        extend_kernel(tfm, ik[:, :2], 1)


def test_knob_routes_extend(fms, toy_paths, monkeypatch):
    """MPIBWA_PALLAS=1: a 2-D int32 batch goes through the wrapper at any
    E; a batch of another rank and an int64 index take the O2 path."""
    from mpibwa_tpu_torch.ops import occ4_cuda
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex

    _, tfm = fms
    calls = []
    real = occ4_cuda.extend_kernel

    def spy(fm, ik, is_back):
        calls.append(tuple(ik.shape))
        return real(fm, ik, is_back)

    monkeypatch.setattr(occ4_cuda, "extend_kernel", spy)
    ik = torch.from_numpy(intervals(tfm, 999, 8))
    monkeypatch.setenv("MPIBWA_PALLAS", "0")
    want = tfm.extend(ik, 1)
    assert calls == []
    monkeypatch.setenv("MPIBWA_PALLAS", "1")
    assert torch.equal(tfm.extend(ik, 1), want)
    assert calls == [(999, 3)]
    got3 = tfm.extend(ik.reshape(27, 37, 3), 1)
    assert calls == [(999, 3)]
    assert torch.equal(got3.reshape(999, 4, 3), want)
    wide = DeviceFMIndex(load_index(toy_paths["ref"]), CPU, force_wide=True)
    assert torch.equal(wide.extend(ik.long(), 1), want.long())
    assert calls == [(999, 3)]


@pytest.mark.parametrize("pe", [True, False], ids=["pe", "se"])
def test_cli_mem_identical_under_the_knob(toy_paths, tmp_path, monkeypatch,
                                          pe):
    """`cli mem` with MPIBWA_PALLAS=1 (every flat-backward round extends
    through the block path) writes the default run's bytes."""
    from mpibwa_tpu_torch import cli
    from mpibwa_tpu_torch.ops import occ4_cuda

    monkeypatch.setenv("MPIBWA_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("MPIBWA_BWD", raising=False)
    calls = []
    real = occ4_cuda.extend_blocks
    monkeypatch.setattr(occ4_cuda, "extend_blocks",
                        lambda *a: calls.append(1) or real(*a))
    args = ["-t", "1", "-o", "out", toy_paths["ref"], toy_paths["r1"]] \
        + ([toy_paths["r2"]] if pe else [])
    sams = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("MPIBWA_PALLAS", knob)
        d = tmp_path / f"knob{knob}"
        d.mkdir()
        monkeypatch.chdir(d)
        n0 = len(calls)
        assert cli.main(["mem"] + args) == 0
        assert (len(calls) > n0) == (knob == "1")
        sams[knob] = (d / "out.sam").read_bytes()
    assert sams["1"] == sams["0"]
    assert sams["0"].count(b"\n") > 200


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu(toy_paths):
    """The CUDA kernel equals the plain version on the card, both
    directions, at entry counts that are no multiple of its block and on
    the edge cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.ops.occ4_cuda import extend_blocks, extend_kernel

    dev = torch.device("cuda")
    fm = DeviceFMIndex(load_index(toy_paths["ref"]), dev)
    cases = [intervals(fm, max(n, 32), n)[:n] for n in (1, 1000, 65_537)]
    cases += list(toy.occ4_edge_intervals(fm, 9).values())
    for case in cases:
        ik = torch.from_numpy(case).to(dev)
        n = len(case)
        for is_back in (1, 0):
            before = extend_kernel.launches
            got = extend_kernel(fm, ik, is_back)
            torch.cuda.synchronize()
            assert extend_kernel.launches == before + 1
            assert torch.equal(got, extend_blocks(fm, ik, is_back)), n
