"""The port's library API (mpibwa_tpu_torch/api.py): ``Aligner.align1``
and ``Aligner.smem_iter`` (bwamem_extra.c's entry points) give what
mpibwa_tpu.api gives on the toy genome, region for region and SMEM for
SMEM."""

import dataclasses
import random

import numpy as np
import pytest
import torch

import _torch_toy as toy
from _torch_toy import release_memory_fixture  # noqa: F401

torch.set_num_threads(1)  # test workers run in parallel on few cores


@pytest.fixture(scope="module")
def aligners(tmp_path_factory):
    from mpibwa_tpu.api import Aligner as JaxAligner
    from mpibwa_tpu_torch.api import Aligner

    paths = toy.build_toy(str(tmp_path_factory.mktemp("toy")))
    reads = toy.load_reads(paths["r1"], limit=12)
    seqs = ["".join("ACGTN"[c] for c in s.seq) for s in reads]
    # a repeat unit's read (several equal hits), one with N, one too short
    # to seed and one off the genome
    contigs = toy.make_genome()
    seqs += [contigs["chrA"][10_100:10_201],
             contigs["chrB"][30_000:30_060] + "NNNN" + contigs["chrB"][
                 30_064:30_120],
             contigs["chrA"][500:515],
             "".join(np.random.default_rng(3).choice(list("ACGT"), 101))]
    return Aligner(paths["ref"]), JaxAligner(paths["ref"]), seqs


def _regs(aligner, seq):
    random.seed(17)  # the primary tie-break hash takes random bits
    return [dataclasses.asdict(r) for r in aligner.align1(seq)]


def test_align1_equals_the_jax_package(aligners):
    port, ref, seqs = aligners
    n_mapped = 0
    for seq in seqs:
        got = _regs(port, seq)
        assert got == _regs(ref, seq), seq
        n_mapped += bool(got)
        if got:
            assert got[0]["secondary"] == -1
    assert 10 <= n_mapped < len(seqs)


def test_smem_iter_equals_the_jax_package(aligners):
    port, ref, seqs = aligners
    total = 0
    for seq in seqs:
        for min_intv, max_intv in ((1, 0), (2, 20)):
            got = list(port.smem_iter(seq, min_intv, max_intv))
            assert got == list(ref.smem_iter(seq, min_intv, max_intv)), seq
            total += sum(len(m) for m in got)
    assert total > 50
