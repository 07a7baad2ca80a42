#!/usr/bin/env python3
"""How repetitive a configuration's genome is, as the aligner's seeds see it.

    python3 portbench/repeat_stats.py --workload int32.pe101 --seed 7 \
        [--pairs 100000] [--k 19] [--rehearse]

Makes the configuration's genome and a seed's read pairs as a run does,
and counts, for every k-mer (bwa-mem's minimum seed length by default) of
the genome and of the reads, its occurrences on both strands of the
genome. Prints one JSON line: the share of genome positions and of read
k-mers that occur more than once, more than max_occ (bwa-mem's -c, 500)
times, or (reads) not at all, and the share of reads without a k-mer that
occurs exactly once. Runs on the card (torch), or with --rehearse on the
CPU at the rehearsal's genome. Imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MAX_OCC = 500


def kmers(codes, k: int):
    """(value, valid) of each k-mer of rows of codes 0-3 (4 for N), as
    2-bit integers; valid where the k-mer holds no N."""
    import torch

    n = codes.shape[-1] - k + 1
    val = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int64,
                      device=codes.device)
    bad = torch.zeros_like(val, dtype=torch.bool)
    for i in range(k):
        c = codes[..., i: i + n]
        val = val * 4 + (c & 3)
        bad |= c > 3
    return val, ~bad


def occurrences(table, vals):
    """Occurrences of each value in the sorted table."""
    import torch

    return (torch.searchsorted(table, vals, right=True)
            - torch.searchsorted(table, vals))


def both_strands(table, codes, k: int):
    """(occurrences on both strands, valid) of each k-mer of codes."""
    import torch

    fwd, ok = kmers(codes, k)
    rc, _ = kmers(torch.where(codes < 4, 3 - codes, codes).flip(-1), k)
    rc = rc.flip(-1)
    return occurrences(table, fwd) + occurrences(table, rc), ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=19)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]
    import numpy as np
    import torch

    from harness import cell as C
    from harness import genome as G
    from harness.simulate import simulate_pairs
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    if args.rehearse:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    else:
        print("[repeat_stats] no CUDA device", file=sys.stderr)
        return 2
    n = (C.REHEARSAL["genome_length"] if args.rehearse
         else int(cell.config["genome_length"]))
    codes = G.to_codes(G.make_chr1(cell.config["genome"], n))
    pairs = simulate_pairs(codes, args.pairs, C.seed_entropy(args.seed),
                           cell.traffic)
    g = torch.from_numpy(codes.astype(np.int64)).to(dev)
    fwd, ok = kmers(g, args.k)
    table = torch.sort(fwd[ok]).values
    del fwd
    g_occ, _ = both_strands(table, g, args.k)
    g_occ = g_occ[ok]
    del g, ok
    reads = torch.from_numpy(
        np.concatenate([pairs.r1, pairs.r2]).astype(np.int64)).to(dev)
    r_occ, _ = both_strands(table, reads, args.k)
    out = {
        "workload": args.workload, "genome_length": n, "k": args.k,
        "reads": int(reads.shape[0]),
        "genome_multi_share": float((g_occ > 1).double().mean()),
        "genome_over_max_occ_share": float((g_occ > MAX_OCC).double()
                                           .mean()),
        "read_kmer_absent_share": float((r_occ == 0).double().mean()),
        "read_kmer_multi_share": float((r_occ > 1).double().mean()),
        "read_kmer_over_max_occ_share": float((r_occ > MAX_OCC).double()
                                              .mean()),
        "reads_without_unique_kmer_share": float(
            (~(r_occ == 1).any(1)).double().mean()),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
