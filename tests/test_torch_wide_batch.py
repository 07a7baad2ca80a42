"""A forward microbatch that holds a wide read, the way chip_smoke.py's
phase 2g checks kernel 4 on it: the port's plain forward_p3 (ops/
seeding.py) over the whole batch against the JAX package's forward_p3 on
the same batch (every field, int32 positions), and against the plain loop
over the wide read alone (what phase 2g's side process computes) put back
at the wide read's lane (chip_smoke.wide_lane, splice_lane). The batch is
a short tail as DeviceAligner._microbatches pads it: the short reads, the
wide read, then dummy reads, so the wide read is not the last lane.
Integers throughout: every comparison is exact (tolerance 0)."""

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
WIDE_BP = 800  # the wide read, eight times the short ones
N_SHORT = 256  # a tail of at least 256 reads is padded to a power of two


@pytest.fixture(scope="module")
def toy_paths(tmp_path_factory):
    return toy.build_toy(str(tmp_path_factory.mktemp("toy")), n_pairs=300)


@pytest.fixture(scope="module")
def batch(toy_paths):
    """(q, lens, the wide read's codes) of the padded microbatch."""
    from mpibwa_tpu_torch.core.pipeline import BSeq
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.pipeline.device_align import DeviceAligner
    from mpibwa_tpu_torch.pipeline.device_seed import _pad_batch

    fm = DeviceFMIndex(load_index(toy_paths["ref"]), CPU)
    wide = toy.ref_reads(fm, np.random.default_rng(4), 1, WIDE_BP,
                         sub_rate=0.001)[0]
    seqs = toy.load_reads(toy_paths["r1"], limit=N_SHORT) + [
        BSeq(name="wide", seq=wide, qual="I" * WIDE_BP)]
    (_, padded), = DeviceAligner._microbatches(
        types.SimpleNamespace(MICROBATCH=16_384), seqs)
    q, lens = _pad_batch([s.seq for s in padded])
    return q, lens, wide


def test_forward_p3_batch_with_a_wide_read(toy_paths, batch):
    import jax.numpy as jnp

    import chip_smoke
    from mpibwa_tpu.ops import seeding as JS
    from mpibwa_tpu.ops.fmd import DeviceFMIndex as JaxFM
    from mpibwa_tpu_torch.ops import seeding as TS
    from mpibwa_tpu_torch.ops.fmd import DeviceFMIndex
    from mpibwa_tpu_torch.pipeline.device_seed import _pad_batch

    idx = load_index(toy_paths["ref"])
    jfm, tfm = JaxFM(idx), DeviceFMIndex(idx, CPU)
    q, lens, wide = batch
    B = len(q)
    opt = mem_opt_init()
    msl, mi = opt.min_seed_len, opt.max_mem_intv

    def port(q_, lens_):
        return TS.forward_p3(tfm, torch.from_numpy(q_),
                             torch.from_numpy(lens_),
                             torch.ones(len(q_), dtype=torch.int64), msl, mi)

    got = port(q, lens)
    want = JS.forward_p3(jfm, jnp.asarray(q), jnp.asarray(lens),
                         jnp.ones(B, jnp.int64), msl, mi)
    for part, jpart in zip(got, want):
        for name, g, w in zip(part._fields, part, jpart):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)

    k = chip_smoke.wide_lane(torch.from_numpy(lens))
    assert lens[k] == WIDE_BP and k == N_SHORT and k < B - 1
    others = np.r_[0:k, k + 1:B]
    q1, l1 = _pad_batch([wide])  # the side process's batch of one
    assert q1.shape[1] == q.shape[1]
    alone = port(q1, l1)
    rest = port(q[others], lens[others])
    for part, one, whole in zip(rest, alone, got):
        lane = {n: a.numpy() for n, a in zip(one._fields, one)}
        spliced = chip_smoke.splice_lane(part, lane, k)
        for name, g, w in zip(whole._fields, spliced, whole):
            assert torch.equal(g, w), name
    assert int(got[1].n_seeds[k]) > 0
