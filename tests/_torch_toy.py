"""Synthetic reference and reads for the torch port's parity tests.

A ~200 kbp genome of two contigs with an N hole and planted 600-bp
repeats (exact and diverged copies), indexed with the repo's own
index/build.py, and simulated 101-bp read pairs with substitutions, small
indels and an insert-size spread. Everything derives from numpy seeds, so
both packages see the same inputs.
"""

from __future__ import annotations

import os

import numpy as np

READ_LEN = 101
_COMP = str.maketrans("ACGTN", "TGCAN")


def _mutate(rng, s: str, rate: float) -> str:
    arr = np.array(list(s))
    hit = rng.random(len(arr)) < rate
    arr[hit] = rng.choice(list("ACGT"), int(hit.sum()))
    return "".join(arr)


def make_genome(seed: int = 1) -> "dict[str, str]":
    """Two contigs (120 kbp, 80 kbp); a 400-bp N hole in the first; a
    600-bp unit planted four times exactly and twice at 2% divergence."""
    rng = np.random.default_rng(seed)
    contigs = {name: list("".join(rng.choice(list("ACGT"), n)))
               for name, n in (("chrA", 120_000), ("chrB", 80_000))}
    unit = "".join(rng.choice(list("ACGT"), 600))
    for name, pos, rate in (("chrA", 10_000, 0.0), ("chrA", 50_000, 0.0),
                            ("chrA", 90_000, 0.02), ("chrB", 20_000, 0.0),
                            ("chrB", 45_000, 0.0), ("chrB", 60_000, 0.02)):
        contigs[name][pos: pos + 600] = list(_mutate(rng, unit, rate))
    contigs["chrA"][70_000:70_400] = ["N"] * 400
    return {k: "".join(v) for k, v in contigs.items()}


def write_fasta(path: str, contigs: "dict[str, str]") -> None:
    with open(path, "w") as fh:
        for name, seq in contigs.items():
            fh.write(f">{name} synthetic\n")
            for i in range(0, len(seq), 70):
                fh.write(seq[i: i + 70] + "\n")


def _indels(rng, s: str, rate: float) -> str:
    out = []
    for ch in s:
        r = rng.random()
        if r < rate / 2:
            continue  # 1-bp deletion
        out.append(ch)
        if r > 1 - rate / 2:
            out.append("".join(rng.choice(list("ACGT"),
                                          int(rng.integers(1, 4)))))
    return "".join(out)


def simulate_pairs(contigs: "dict[str, str]", n_pairs: int, seed: int = 2,
                   sub_rate: float = 0.01, indel_rate: float = 0.002):
    """n_pairs FR pairs: insert size ~ N(300, 30), R1 on either strand."""
    rng = np.random.default_rng(seed)
    names = list(contigs)
    lens = np.array([len(contigs[n]) for n in names], np.float64)
    r1, r2 = [], []
    for i in range(n_pairs):
        seq = contigs[names[rng.choice(len(names), p=lens / lens.sum())]]
        isize = int(np.clip(rng.normal(300, 30), READ_LEN + 20, 500))
        pos = int(rng.integers(0, len(seq) - isize - 10))
        frag = seq[pos: pos + isize + 10]
        a = frag[: READ_LEN + 5]
        b = frag[isize - READ_LEN - 5: isize].translate(_COMP)[::-1]
        if rng.random() < 0.5:
            a, b = b, a
        reads = []
        for s in (a, b):
            s = _mutate(rng, _indels(rng, s, indel_rate), sub_rate)
            reads.append(s[:READ_LEN])
        r1.append((f"p{i}", reads[0]))
        r2.append((f"p{i}", reads[1]))
    return r1, r2


def write_fastq(path: str, reads) -> None:
    with open(path, "w") as fh:
        for name, s in reads:
            fh.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")


def build_toy(directory: str, n_pairs: int = 1000) -> "dict[str, str]":
    """Write toy.fa (+ its bwa index), r1.fq and r2.fq under directory;
    returns their paths. Idempotent per directory."""
    from mpibwa_tpu_torch.index.build import build_index

    paths = {k: os.path.join(directory, f)
             for k, f in (("ref", "toy.fa"), ("r1", "r1.fq"),
                          ("r2", "r2.fq"))}
    if not os.path.exists(paths["r2"]):
        os.makedirs(directory, exist_ok=True)
        contigs = make_genome()
        write_fasta(paths["ref"], contigs)
        build_index(paths["ref"])
        r1, r2 = simulate_pairs(contigs, n_pairs)
        write_fastq(paths["r1"], r1)
        write_fastq(paths["r2"], r2)
    return paths


def load_reads(path: str, limit: "int | None" = None):
    from mpibwa_tpu_torch.io.fastq import read_fastq

    return read_fastq(path, limit=limit)
