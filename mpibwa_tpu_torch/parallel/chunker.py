"""Deterministic base-count chunking.

Reproduces the chunk-boundary math of find_chunks_info /
find_chunks_info_trim (parallel_aux.c:861-1712) — reads accumulate into a
chunk until counter_bases > maxsiz — but computed with a prefix sum instead
of the reference's rank-to-rank relay. Boundaries depend only on the data
and -K, which is exactly what makes mpiBWA's output invariant to rank count
(CHANGELOG:144); the same invariance holds here for shard count.

maxsiz conventions (mainParallel.c):
  - paired, equal-size files ("untrimmed"): maxsiz = K/2, counting BOTH
    mates' bases (line 947); n_processed passed as 0 every chunk (:1314)
  - paired trimmed and single-end: maxsiz = K (lines 1874, 2773);
    n_processed accumulates across chunks (:2355-2357)
where K defaults to opt.chunk_size * n_threads (:635).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Chunk:
    start: int  # first read (pair) index
    count: int  # number of reads (pairs)
    bases: int


def chunk_bounds(sizes: np.ndarray, maxsiz: int) -> List[Chunk]:
    """Close a chunk whenever the running base count exceeds maxsiz
    (parallel_aux.c:1082-1103); the final partial chunk is kept."""
    out: List[Chunk] = []
    start = 0
    acc = 0
    for i, sz in enumerate(sizes):
        acc += int(sz)
        if acc > maxsiz:
            out.append(Chunk(start, i + 1 - start, acc))
            start = i + 1
            acc = 0
    if start < len(sizes):
        out.append(Chunk(start, len(sizes) - start, acc))
    return out


def chunk_pe(sizes1: np.ndarray, sizes2: np.ndarray, fixed_chunk_size: int,
             trimmed: bool) -> List[Chunk]:
    """Paired-end chunking over pairs; each pair contributes l1+l2 bases."""
    pair_sizes = np.asarray(sizes1, np.int64) + np.asarray(sizes2, np.int64)
    maxsiz = fixed_chunk_size if trimmed else fixed_chunk_size // 2
    return chunk_bounds(pair_sizes, maxsiz)


def chunk_se(sizes: np.ndarray, fixed_chunk_size: int) -> List[Chunk]:
    return chunk_bounds(np.asarray(sizes, np.int64), fixed_chunk_size)


def assign_round_robin(n_chunks: int, n_shards: int, shard: int) -> List[int]:
    """Deterministic chunk->shard assignment replacing the reference's RMA
    ticket counter (mainParallel.c:1109-1123). Output order is recovered by
    merging shard outputs in chunk order, which is stronger than the
    reference's nondeterministic shared-file-pointer interleaving."""
    return list(range(shard, n_chunks, n_shards))
