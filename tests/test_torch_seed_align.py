"""The port's DeviceSeeder and DeviceAligner
(mpibwa_tpu_torch/pipeline/device_seed.py, device_align.py) vs the JAX
ones on reads simulated from the toy genome: seeding rows, offsets and
fallback flags, the list path's intervals, and the packed regions of the
native route, with the extension DP on the device and in C."""

import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401
from mpibwa_tpu.core.opts import mem_opt_init
from mpibwa_tpu.index.format import load_index

torch.set_num_threads(1)  # test workers run in parallel on few cores


N_READS = 200


@pytest.fixture(scope="module")
def toy_paths(tmp_path_factory):
    return toy.build_toy(str(tmp_path_factory.mktemp("toy")))


@pytest.fixture(scope="module")
def index(toy_paths):
    return load_index(toy_paths["ref"])


@pytest.fixture(scope="module")
def reads(toy_paths):
    half = N_READS // 2
    return (toy.load_reads(toy_paths["r1"], limit=half)
            + toy.load_reads(toy_paths["r2"], limit=half))


@pytest.fixture(scope="module")
def aligners(index):
    """(JAX DeviceAligner, port DeviceAligner) sharing the host engines."""
    from mpibwa_tpu.core.fm import FMIndex
    from mpibwa_tpu.core.refseq import RefSeq
    from mpibwa_tpu.pipeline.device_align import DeviceAligner as JaxAligner
    from mpibwa_tpu_torch.pipeline.device_align import DeviceAligner

    opt = mem_opt_init()
    fm, refs = FMIndex.from_index(index), RefSeq(index)
    return (JaxAligner(index, opt, fm=fm, refs=refs),
            DeviceAligner(index, opt, device=torch.device("cpu"), fm=fm,
                          refs=refs))


def test_collect_flat_matches_jax(aligners, reads):
    ja, ta = aligners
    qs = [s.seq for s in reads]
    want = ja.seeder.collect_flat(qs)
    got = ta.seeder.collect_flat(qs)
    assert want is not None and got is not None
    for name, g, w in zip(("flat", "mem_off", "fallback"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert len(got[0]) > len(reads)
    assert ta.seeder.times["bwd_segments"] >= 1


@pytest.mark.parametrize("sort", [True, False])
def test_collect_batch_matches_jax(aligners, reads, sort):
    ja, ta = aligners
    qs = [s.seq for s in reads]
    want, wfb = ja.seeder.collect_batch(qs, sort=sort)
    got, gfb = ta.seeder.collect_batch(qs, sort=sort)
    np.testing.assert_array_equal(gfb, wfb)
    assert got == want


def test_backward_overflow_sends_collect_flat_to_list_route(aligners, reads,
                                                            monkeypatch):
    """With a tiny mem capacity both seeders give up on the flat rows
    (collect_flat -> None) and the list path flags the same reads."""
    from mpibwa_tpu.ops import seeding_flat as JSF
    from mpibwa_tpu_torch.ops import seeding_flat as TSF

    monkeypatch.setattr(JSF, "M_CAP", 2)
    monkeypatch.setattr(TSF, "M_CAP", 2)
    ja, ta = aligners
    qs = [s.seq for s in reads[:64]]
    assert ja.seeder.collect_flat(qs) is None
    assert ta.seeder.collect_flat(qs) is None
    want, wfb = ja.seeder.collect_batch(qs)
    got, gfb = ta.seeder.collect_batch(qs)
    assert gfb.any()
    np.testing.assert_array_equal(gfb, wfb)
    assert got == want


@pytest.mark.parametrize("ext", ["device", "native"])
def test_align_arrays_regions_match_jax(aligners, reads, ext, monkeypatch):
    monkeypatch.setenv("MPIBWA_EXT", ext)
    ja, ta = aligners
    before = ta.stats["ext_problems"]
    want = ja.align_arrays(reads)
    got = ta.align_arrays(reads)
    assert want is not None and got is not None
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].tobytes() == want[0].tobytes()
    assert (ta.stats["ext_problems"] > before) == (ext == "device")


def test_split_chain_sessions_keep_device_extension_exact(aligners, reads,
                                                          monkeypatch):
    """With the microbatch chained as several concurrent C sessions (read
    ranges numbered from 0 each), the device extension still gives the
    regions of the all-C extension."""
    from mpibwa_tpu.pipeline import native_final

    monkeypatch.setattr(native_final, "_MIN_SPLIT", 32)
    monkeypatch.setattr(native_final, "_CPU", 4)
    _, ta = aligners
    got = {}
    for ext in ("device", "native"):
        monkeypatch.setenv("MPIBWA_EXT", ext)
        got[ext] = ta.align_arrays(reads)
    np.testing.assert_array_equal(got["device"][1], got["native"][1])
    assert got["device"][0].tobytes() == got["native"][0].tobytes()
